"""The tensor-core WKV6 kernel's algorithm (``csrc/wkv6.cu``), emulated in
torch on the CPU.

``emulate_wkv6`` computes what the kernel computes, in its order: chunks of
C = 64 tokens, sub-chunks of 16; the decay as base-2 partial sums P of
``log2(max(w, 1e-12))`` within a chunk (P[t] the exclusive sum at token t,
P[t + 1] the inclusive one); four products that the kernel runs on the
tensor cores, each operand rounded to TF32 as ``cvt.rna.tf32.f32`` does:

- inter-chunk ``(r * 2^P[t]) @ S``, as a 3xTF32 split (hi x hi + hi x lo +
  lo x hi, each lo the rounded remainder): the rows of S span a wide range
  (channels that barely decay carry hundreds of tokens), and with one TF32
  rounding the worst y element of (4, 1000, 8, 64) reached 1.44x its limit;
- query sub-chunk a against key sub-chunk b < a, factored about a's first
  token: ``(r * 2^(P[t] - P[16a])) @ (k * 2^(P[16a] - P[s + 1]))^T``;
- ``A @ v`` with A those scores beside the diagonal 16 x 16 block, which is
  fp32 elementwise: ``sum_i r k 2^(P[t] - P[s + 1])`` for s < t and the
  ``u`` bonus for s = t; 3xTF32 as well: the diagonal block dominates y,
  and with one rounding of A the 2-layer rwkv6-3b logits on the card moved
  past chip_smoke.py's allclose limit against the plain path;
- the state, ``2^P[C] * S + (k * 2^(P[C] - P[s + 1]))^T @ v``, 3xTF32 as
  well: with one rounding its worst element sat at 0.70-0.88 of the 1e-3
  limit at S 200. (v from bf16 is exact in TF32, so its lo is zero there.)

Only the scores keep one TF32 rounding.

Every exponent it takes is asserted to be <= 0 and every intermediate
finite. Held to: in fp32 without rounding, the per-step recurrence (JAX's
``wkv6_ref`` and the port's) within the JAX WKV6 tolerance 2e-4
(tests/test_kernels.py:116-117), also at the extreme decays; with TF32
rounding, the port's plain ``wkv6_chunked`` within the card tests' limits
(y: 2**-7 |plain| + 1e-2 RMS; state: 1e-3 |plain| + 1e-3 RMS of its row).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_chunked, wkv6_ref  # noqa: E402

C, SUB = 64, 16           # the kernel's chunk and sub-chunk
MIN_DECAY = 1e-12         # w is clamped below, as log(max(w, 1e-12))
KERNEL_RTOL = 2.0 ** -7   # as tests/test_torch_gpu.py
WKV_STATE_TOL = 1e-3


def tf32(x):
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exp2_nonpos(x):
    """2**x for exponents that must not be positive."""
    assert bool((x <= 0).all()), f"positive exponent {float(x.max())}"
    out = torch.exp2(x)
    assert bool(torch.isfinite(out).all())
    return out


def mm3(a, b, rnd):
    """``a @ b`` as the 3xTF32 split: hi x hi + hi x lo + lo x hi, each
    operand's lo the rounded remainder ``rnd(x - rnd(x))``."""
    a_hi, b_hi = rnd(a), rnd(b)
    a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def emulate_wkv6(r, k, v, w, u, rnd=tf32):
    """The kernel's algorithm. r/k/v/w (B, S, H, dh); u (H, dh) fp32.
    ``rnd`` rounds each tensor-core operand (identity: fp32 throughout).
    Returns y (B, S, H, dh) in r's dtype and the state (B, H, dh, dh)."""
    B, S, H, D = r.shape
    pad = (-S) % C

    def heads(x):  # (B, H, S + pad, D) fp32; padded tokens are zero
        return F.pad(x.float().permute(0, 2, 1, 3), (0, 0, 0, pad))

    rh, kh, vh = heads(r), heads(k), heads(v)
    # padded tokens decay by 1: log2 w = 0, so they leave the state alone
    lw = heads(torch.log2(torch.clamp_min(w.float(), MIN_DECAY)))
    uf = u.float()[None, :, None, :]
    state = torch.zeros((B, H, D, D))
    strict = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), diagonal=-1)
    eye = torch.eye(SUB, dtype=torch.bool)
    ys = []
    for c0 in range(0, S + pad, C):
        rc, kc, vc = (x[:, :, c0:c0 + C] for x in (rh, kh, vh))
        P = torch.cat([torch.zeros((B, H, 1, D)),
                       torch.cumsum(lw[:, :, c0:c0 + C], dim=2)], dim=2)
        assert bool(torch.isfinite(P).all())
        ecw, cw, last = P[:, :, :C], P[:, :, 1:], P[:, :, C:]
        y = mm3(rc * exp2_nonpos(ecw), state, rnd)
        for a in range(C // SUB):
            ta = slice(a * SUB, (a + 1) * SUB)
            base = P[:, :, a * SUB:a * SUB + 1]
            q = rnd(rc[:, :, ta] * exp2_nonpos(ecw[:, :, ta] - base))
            kk = rnd(kc[:, :, :a * SUB] * exp2_nonpos(base - cw[:, :, :a * SUB]))
            scores = q @ kk.transpose(-1, -2)                    # (B, H, 16, 16a)
            diff = ecw[:, :, ta, None, :] - cw[:, :, None, ta, :]  # (B, H, t, s, D)
            dec = torch.zeros_like(diff)
            dec[:, :, strict] = exp2_nonpos(diff[:, :, strict])
            prod = rc[:, :, ta, None, :] * kc[:, :, None, ta, :]
            diag = (prod * dec).sum(-1) + eye * (prod * uf[:, :, :, None]).sum(-1)
            A = torch.cat([scores, diag], dim=-1)               # (B, H, 16, 16(a+1))
            y[:, :, ta] += mm3(A, vc[:, :, :(a + 1) * SUB], rnd)
        kd = (kc * exp2_nonpos(last - cw)).transpose(-1, -2)
        state = exp2_nonpos(last).transpose(-1, -2) * state + mm3(kd, vc, rnd)
        assert bool(torch.isfinite(y).all() and torch.isfinite(state).all())
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :S].permute(0, 2, 1, 3)
    return y.to(r.dtype).contiguous(), state


def _decay(rng, shape, kind):
    if kind == "model":     # the model's exp(-exp(clip(., -8, 4)))
        return np.exp(-np.exp(np.clip(rng.standard_normal(shape), -8.0, 4.0)))
    if kind == "sweep":     # tests/test_kernels.py's WKV6 sweep
        return np.exp(-np.exp(rng.standard_normal(shape) * 0.5))
    if kind == "clamped":   # every decay at the clamp
        return np.full(shape, MIN_DECAY)
    if kind == "nearly none":
        return np.full(shape, 1.0 - 2.0 ** -8)
    if kind == "clip edges":  # exp(-exp(4)) ~ 1.9e-24 and exp(-exp(-8)), mixed
        return np.where(rng.random(shape) < 0.5, np.exp(-np.exp(4.0)),
                        np.exp(-np.exp(-8.0)))
    raise ValueError(kind)


def _inputs(shape, kind, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape) * scale for _ in range(3))
    w = _decay(rng, shape, kind)
    u = rng.standard_normal(shape[2:]) * 0.3
    return [np.asarray(x, np.float32) for x in (r, k, v, w, u)]


def _worst_share(got, want, rtol, c):
    """The worst element's |got - want| as a share of rtol |want| + c RMS
    (RMS over the last axis)."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape and bool(torch.isfinite(g).all())
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = rtol * w.abs() + c * rms
    return float(((g - w).abs() / limit.clamp_min(1e-30)).max())


DECAYS = ["model", "sweep", "clamped", "nearly none", "clip edges"]


@pytest.mark.parametrize("kind", DECAYS)
@pytest.mark.parametrize("shape", [(2, 200, 3, 64), (2, 45, 3, 16)])
def test_fp32_emulation_matches_the_per_step_recurrence(shape, kind):
    """No rounding: the factorisation alone is exact to fp32 rounding, from
    the sweep's inputs (N(0, 0.25)) up to unit normals at every decay."""
    r, k, v, w, u = _inputs(shape, kind, seed=7, scale=0.5)
    tr, tk, tv, tw, tu = (torch.from_numpy(x) for x in (r, k, v, w, u))
    y, state = emulate_wkv6(tr, tk, tv, tw, tu, rnd=lambda x: x)
    jy, js = jax_wkv6_ref(*(jnp.asarray(x) for x in (r, k, v, w, u)))
    py, ps = wkv6_ref(tr, tk, tv, tw, tu)
    for want_y, want_s in ((np.asarray(jy), np.asarray(js)),
                           (py.numpy(), ps.numpy())):
        assert_allclose(y.numpy(), want_y, atol=2e-4, rtol=2e-4)
        assert_allclose(state.numpy(), want_s, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shape,kind,dtype", [
    ((2, 200, 8, 64), "model", torch.bfloat16),   # the card test's shape
    ((4, 1000, 8, 64), "model", torch.bfloat16),  # the serving length
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
    plain chunked version on the same inputs, at the limits the card tests
    hold the kernel to."""
    r, k, v, w, u = (torch.from_numpy(x) for x in _inputs(shape, kind, seed=3))
    r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
    y, state = emulate_wkv6(r, k, v, w, u)
    py, ps = wkv6_chunked(r, k, v, w, u, C)
    y_share = _worst_share(y, py, KERNEL_RTOL, 1e-2)
    s_share = _worst_share(state, ps, WKV_STATE_TOL, WKV_STATE_TOL)
    print(f"{shape} {kind} {dtype}: worst share of the limit y {y_share:.3f}, "
          f"state {s_share:.3f}")
    assert y_share <= 1.0 and s_share <= 1.0
