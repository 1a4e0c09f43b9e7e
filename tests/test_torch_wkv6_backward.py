"""K4's backward kernel's algorithm (``wkv6_bwd`` in ``csrc/wkv6.cu``),
emulated in torch on the CPU.

``emulate_wkv6_bwd`` computes what the kernel's launches compute, in their
order: chunks of C = 64 tokens, sub-chunks of 16; the decay as base-2
partial sums P of ``log2(max(w, 1e-12))`` within a chunk (P[t] exclusive,
P[t + 1] inclusive); every tensor-core product with its operands rounded
as ``cvt.rna.tf32.f32`` does, each operand that is not exact in TF32 split
3xTF32 (inputs from bf16 are exact, so their lo term is zero):

1. the state at each chunk's start, ``S <- 2^P[C] S + (k 2^(P[C] - P[s+1]))^T v``;
2. the state's cotangent at each chunk's end, walking back,
   ``dS <- 2^P[C] dS + (r 2^P[t])^T gy``, and the cross term
   ``X[i] = sum_j S_end[i][j] dS_end[i][j]``;
3. per chunk, with dA = gy v^T and A the forward's scores (factored about
   the query sub-chunk's first token, the diagonal 16 x 16 block
   elementwise, u on its diagonal):
   ``dv = A^T gy + (k 2^(P[C] - P[s+1])) dS``;
   ``dr~`` = the inter-chunk ``2^P[t] (S gy_t)`` and the keys before t,
   factored about the query sub-chunk's first token (diagonal block
   elementwise); ``dk~`` = the state's ``2^(P[C] - P[s+1]) (dS v_s)`` and
   the queries after s, factored about the key sub-chunk's end;
   ``dr = dr~ + u k diag(dA)``, ``dk = dk~ + u r diag(dA)``;
   ``dlog w_j = X + sum_{t > j} r_t dr~_t - sum_{s >= j} k_s dk~_s`` within
   the chunk; ``dw = dlog w / w``, 0 where w < 1e-12;
4. du, the chunks' partials ``sum_t r k diag(dA)`` summed over the batch.

Every exponent it takes is asserted to be <= 0 and every intermediate
finite. Held to: in fp32 without rounding, autograd of the per-step
``wkv6_ref`` and ``jax.vjp`` of the JAX reference within the JAX WKV6
tolerance 2e-4 (tests/test_kernels.py:116-117), also at the extreme decays;
with TF32 rounding, the port's plain rule (``wkv6_bwd_plain``) within the
card tests' limits.

The limits are the card tests' ``wkv6_grad_shares``: dw is held as the
log-decay's cotangent dw·w, since both chunked forms take it from sums
that cancel within a chunk and divide by w, so where w is tiny (the
model's decays reach 1.9e-24) their dw is that rounding magnified by 1/w;
the model's decay parameters receive dw·w times a factor of at most e^4
(w = exp(-exp(clip(x, -8, 4)))).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6_bwd_plain  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from test_torch_gpu import wkv6_grad_shares  # noqa: E402
from test_torch_wkv6_chunked import (C, DECAYS, KERNEL_RTOL,  # noqa: E402
                                     MIN_DECAY, SUB, _inputs, exp2_nonpos,
                                     mm3, tf32)


def _log_decays(lw_chunk):
    """P (B, H, C + 1, D): 0, then the inclusive sums along the chunk."""
    B, H, _, D = lw_chunk.shape
    P = torch.cat([torch.zeros((B, H, 1, D)), torch.cumsum(lw_chunk, dim=2)], dim=2)
    assert bool(torch.isfinite(P).all())
    return P


def _diag_decays(P, ta):
    """dec[t, s] = 2^(P[t] - P[s + 1]) for s < t in the sub-chunk at ta, else 0:
    (B, H, 16, 16, D)."""
    strict = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), diagonal=-1)
    diff = P[:, :, ta:ta + SUB, None, :] - P[:, :, None, ta + 1:ta + SUB + 1, :]
    dec = torch.zeros_like(diff)
    dec[:, :, strict] = exp2_nonpos(diff[:, :, strict])
    return dec


def emulate_wkv6_bwd(r, k, v, w, u, gy, rnd=tf32, cross_term=True):
    """The kernel's algorithm. r/k/v/w/gy (B, S, H, dh); u (H, dh) fp32.
    ``rnd`` rounds each tensor-core operand (identity: fp32 throughout);
    ``cross_term`` False leaves X out (a control). Returns (dr, dk, dv, dw)
    in r's dtype and du (H, dh) fp32."""
    B, S, H, D = r.shape
    pad = (-S) % C
    n_chunks = (S + pad) // C

    def heads(x):  # (B, H, S + pad, D) fp32; padded tokens are zero
        return F.pad(x.float().permute(0, 2, 1, 3), (0, 0, 0, pad))

    rh, kh, vh, gh = heads(r), heads(k), heads(v), heads(gy)
    lw = heads(torch.log2(torch.clamp_min(w.float(), MIN_DECAY)))  # padded: 0
    uf = u.float()[None, :, None, :]
    chunks = [slice(c * C, (c + 1) * C) for c in range(n_chunks)]
    Ps = [_log_decays(lw[:, :, sl]) for sl in chunks]

    # 1. the state at each chunk's start
    states, st = [], torch.zeros((B, H, D, D))
    for sl, P in zip(chunks, Ps):
        states.append(st)
        last = P[:, :, C:]
        kd = (kh[:, :, sl] * exp2_nonpos(last - P[:, :, 1:])).transpose(-1, -2)
        st = exp2_nonpos(last).transpose(-1, -2) * st + mm3(kd, vh[:, :, sl], rnd)
    # 2. the state's cotangent at each chunk's end, and the cross term
    dstates, cross = [None] * n_chunks, [None] * n_chunks
    ds = torch.zeros((B, H, D, D))
    for c in reversed(range(n_chunks)):
        sl, P = chunks[c], Ps[c]
        dstates[c] = ds
        cross[c] = ((states[c + 1] * ds).sum(-1) if c + 1 < n_chunks and cross_term
                    else torch.zeros((B, H, D)))
        rd = (rh[:, :, sl] * exp2_nonpos(P[:, :, :C])).transpose(-1, -2)
        ds = exp2_nonpos(P[:, :, C:]).transpose(-1, -2) * ds + mm3(rd, gh[:, :, sl], rnd)
        assert bool(torch.isfinite(ds).all() and torch.isfinite(cross[c]).all())

    # 3. every chunk
    lower = torch.tril(torch.ones(C, C, dtype=torch.bool))
    eye = torch.eye(SUB, dtype=torch.bool)
    out = {name: [] for name in ("dr", "dk", "dv", "dlw", "du")}
    for c, (sl, P) in enumerate(zip(chunks, Ps)):
        rc, kc, vc, gc = (x[:, :, sl] for x in (rh, kh, vh, gh))
        S0, dS1, last = states[c], dstates[c], P[:, :, C:]
        dA = mm3(gc, vc.transpose(-1, -2), rnd) * lower        # dA[t, s], s <= t
        A = torch.zeros((B, H, C, C))
        for ta in range(0, C, SUB):
            rows = slice(ta, ta + SUB)
            if ta:
                q = rc[:, :, rows] * exp2_nonpos(P[:, :, rows] - P[:, :, ta:ta + 1])
                kk = kc[:, :, :ta] * exp2_nonpos(P[:, :, ta:ta + 1] - P[:, :, 1:ta + 1])
                A[:, :, rows, :ta] = mm3(q, kk.transpose(-1, -2), rnd)
            prod = rc[:, :, rows, None, :] * kc[:, :, None, rows, :]
            A[:, :, rows, rows] = ((prod * _diag_decays(P, ta)).sum(-1)
                                   + eye * (prod * uf[:, :, :, None]).sum(-1))
        kdec = kc * exp2_nonpos(last - P[:, :, 1:])
        dv = mm3(A.transpose(-1, -2), gc, rnd) + mm3(kdec, dS1, rnd)
        drt, dkt = torch.zeros_like(rc), torch.zeros_like(kc)
        for ta in range(0, C, SUB):
            rows, e = slice(ta, ta + SUB), ta + SUB
            dec = _diag_decays(P, ta)                            # [t, s, i]
            base = P[:, :, ta:ta + 1]
            acc = mm3(gc[:, :, rows],
                      (S0 * exp2_nonpos(base).transpose(-1, -2)).transpose(-1, -2), rnd)
            if ta:
                kk = kc[:, :, :ta] * exp2_nonpos(base - P[:, :, 1:ta + 1])
                acc = acc + mm3(dA[:, :, rows, :ta], kk, rnd)
            acc = acc * exp2_nonpos(P[:, :, rows] - base)
            dA_blk = dA[:, :, rows, rows] * ~eye                 # [t, s], s < t
            drt[:, :, rows] = acc + torch.einsum("bhts,bhsi,bhtsi->bhti",
                                                 dA_blk, kc[:, :, rows], dec)
            end = P[:, :, e:e + 1]
            acc = mm3(vc[:, :, rows],
                      (dS1 * exp2_nonpos(last - end).transpose(-1, -2)).transpose(-1, -2),
                      rnd)
            if e < C:
                rr = rc[:, :, e:] * exp2_nonpos(P[:, :, e:C] - end)
                acc = acc + mm3(dA[:, :, e:, rows].transpose(-1, -2), rr, rnd)
            acc = acc * exp2_nonpos(end - P[:, :, ta + 1:e + 1])
            dkt[:, :, rows] = acc + torch.einsum("bhts,bhti,bhtsi->bhsi",
                                                 dA_blk, rc[:, :, rows], dec)
        dAd = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]   # (B, H, C, 1)
        a, b = rc * drt, kc * dkt
        ed = a - b
        after = ed.flip(2).cumsum(2).flip(2) - ed                # sum over t' > t
        out["dlw"].append(cross[c][:, :, None, :] + after - b)
        out["dr"].append(drt + uf * kc * dAd)
        out["dk"].append(dkt + uf * rc * dAd)
        out["dv"].append(dv)
        out["du"].append((rc * kc * dAd).sum(2))                # (B, H, D)
        for x in out.values():
            assert bool(torch.isfinite(x[-1]).all())

    def tokens(xs):
        return torch.cat(xs, dim=2)[:, :, :S].permute(0, 2, 1, 3)

    wf = w.float()
    dlw = tokens(out["dlw"])
    dw = torch.where(wf >= MIN_DECAY, dlw / torch.where(wf >= MIN_DECAY, wf, 1.0), 0.0)
    du = torch.stack(out["du"], dim=2).sum(dim=(0, 2))
    dr, dk, dv = (tokens(out[n]).to(r.dtype).contiguous() for n in ("dr", "dk", "dv"))
    return dr, dk, dv, dw.to(w.dtype).contiguous(), du


def _cotangent(shape, seed):
    return np.asarray(np.random.default_rng(seed).standard_normal(shape), np.float32)


def _autograd_per_step(r, k, v, w, u, g):
    ins = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    y, _ = wkv6_ref(*ins)
    return torch.autograd.grad(y, ins, g)


@pytest.mark.parametrize("kind", DECAYS)
@pytest.mark.parametrize("shape", [(2, 200, 3, 64), (2, 45, 3, 16)])
def test_fp32_emulation_matches_the_per_step_vjp(shape, kind):
    """No rounding: the chunked backward's factorisation alone against the
    per-step recurrence's vjp, in torch and in JAX, at 2e-4 (dw as dw·w,
    with the summands' scale in its absolute part; the per-step forms do
    not clamp w, so dw is held only where w >= 1e-12)."""
    r, k, v, w, u = _inputs(shape, kind, seed=11, scale=0.5)
    g = _cotangent(shape, 12)
    tr, tk, tv, tw, tu, tg = (torch.from_numpy(x) for x in (r, k, v, w, u, g))
    got = emulate_wkv6_bwd(tr, tk, tv, tw, tu, tg, rnd=lambda x: x)
    _, vjp = jax.vjp(lambda *a: jax_wkv6_ref(*a)[0], *map(jnp.asarray, (r, k, v, w, u)))
    jgrads = [torch.from_numpy(np.asarray(x)) for x in vjp(jnp.asarray(g))]
    open_w = tw >= MIN_DECAY
    for want in (jgrads, list(_autograd_per_step(tr, tk, tv, tw, tu, tg))):
        want[3] = torch.where(open_w, want[3], 0.0)
        shares = wkv6_grad_shares(got, want, tw, tr, tk, 2e-4, 2e-4)
        assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("shape,kind,dtype", [
    ((2, 200, 8, 64), "model", torch.bfloat16),
    ((2, 1024, 2, 64), "model", torch.bfloat16),  # the cell's length
    ((3, 45, 5, 64), "model", torch.bfloat16),    # fills no chunk
    ((1, 1, 1, 64), "model", torch.bfloat16),
    *[((2, S, 2, 64), "model", torch.bfloat16)    # sub-chunk and chunk edges
      for S in (15, 16, 17, 63, 64, 65, 129)],
    ((2, 129, 2, 64), "clamped", torch.bfloat16),
    ((2, 129, 2, 64), "nearly none", torch.bfloat16),
    ((2, 129, 2, 64), "clip edges", torch.bfloat16),
    ((2, 200, 4, 16), "model", torch.bfloat16),   # the smoke model's head_dim
    ((1, 200, 2, 64), "model", torch.float32),
    ((1, 200, 2, 64), "nearly none", torch.float32),
])
def test_tf32_emulation_stays_within_the_kernel_limits(shape, kind, dtype):
    """With TF32 operands (3xTF32 where the kernel splits them), against the
    plain rule on the same inputs, at the card tests' limits (2**-7 |plain|
    + 1e-2 RMS of the row)."""
    r, k, v, w, u = (torch.from_numpy(x) for x in _inputs(shape, kind, seed=5))
    g = torch.from_numpy(_cotangent(shape, 6))
    r, k, v, w, g = (x.to(dtype) for x in (r, k, v, w, g))
    got = emulate_wkv6_bwd(r, k, v, w, u, g)
    want = wkv6_bwd_plain(r, k, v, w, u, C, g)
    assert all(a.dtype == b.dtype for a, b in zip(got, want))
    shares = wkv6_grad_shares(got, want, w, r, k, KERNEL_RTOL, 1e-2)
    print(f"{shape} {kind} {dtype}: worst shares of the limits "
          + ", ".join(f"{n} {x:.3f}" for n, x in shares.items()))
    assert max(shares.values()) <= 1.0, shares


def test_dw_is_exactly_zero_below_the_clamp():
    """w below 1e-12 passes no gradient (clamp_min), in the emulation as in
    the plain rule; a decay at the clamp itself passes it."""
    shape = (1, 70, 2, 16)
    r, k, v, w, u = (torch.from_numpy(x) for x in _inputs(shape, "model", seed=9))
    w[0, ::3] = 1e-20
    w[0, 1::3] = MIN_DECAY
    g = torch.from_numpy(_cotangent(shape, 10))
    dw = emulate_wkv6_bwd(r, k, v, w, u, g)[3]
    plain = wkv6_bwd_plain(r, k, v, w, u, C, g)[3]
    assert bool((dw[0, ::3] == 0).all()) and bool((plain[0, ::3] == 0).all())
    assert bool(dw[0, 1::3].any())


def test_a_missing_cross_term_is_refused():
    """Negative control: without the cross term X (the pairs that straddle
    a chunk's end) the emulation misses dw at the card tests' limits, and
    nothing else."""
    shape = (1, 200, 2, 64)
    r, k, v, w, u = (torch.from_numpy(x) for x in _inputs(shape, "nearly none", seed=3))
    g = torch.from_numpy(_cotangent(shape, 4))
    want = wkv6_bwd_plain(r, k, v, w, u, C, g)
    got = emulate_wkv6_bwd(r, k, v, w, u, g, cross_term=False)
    shares = wkv6_grad_shares(got, want, w, r, k, KERNEL_RTOL, 1e-2)
    assert shares["dw"] > 1.0 and max(shares[n] for n in "dr dk dv du".split()) <= 1.0


def test_the_kernel_wrapper_refuses_before_any_launch():
    """``wkv6_bwd_kernel`` checks what it is given before it loads or
    launches anything: the refusals need no card."""
    from repro_torch.kernels.wkv6.ops import wkv6_bwd_kernel
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    u = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        wkv6_bwd_kernel(*(t.half() for t in (x, x, x, x)), u, x.half())
    with pytest.raises(ValueError, match="cotangent"):
        wkv6_bwd_kernel(x, x, x, x, u, x.float())
    with pytest.raises(ValueError, match="cotangent"):
        wkv6_bwd_kernel(x, x, x, x, u, x[:, :4])
    with pytest.raises(ValueError, match="u must be float32"):
        wkv6_bwd_kernel(x, x, x, x, u.bfloat16(), x)
    x8 = torch.zeros(1, 8, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        wkv6_bwd_kernel(x8, x8, x8, x8, torch.zeros(2, 8), x8)


def test_cpu_and_fake_tensors_take_the_plain_rule():
    """The kernel only for real CUDA tensors: CPU tensors and fake ones
    (the dry run's, on a fake card) differentiate the chunked form."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.wkv6.ops import takes_kernel, wkv6, wkv6_bwd
    x = torch.zeros(1, 8, 2, 16)
    assert not takes_kernel(x, x)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = mode.from_tensor(x)
        assert not takes_kernel(fake, fake)
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs((1, 20, 2, 16), "model", seed=1))
    g = torch.from_numpy(_cotangent((1, 20, 2, 16), 2))
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = wkv6(*ins, 8)
    grads = torch.autograd.grad(y, ins, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, wkv6_bwd(r, k, v, w, u, 8, g)))
    assert all(torch.equal(a, b) for a, b in zip(grads, wkv6_bwd_plain(r, k, v, w, u, 8, g)))
