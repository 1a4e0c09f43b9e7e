"""The tensor-core form of the flash-decode kernel (``csrc/decode_attention.cu``
``decode_mma_kernel``, rep 8 and 16), emulated in torch on the CPU.

``emulate_decode_mma`` computes what the kernel computes, in its order: a
cluster of CTAs per (batch, kv head), CTA ``rank`` owning tiles
``[rank n / cluster, (rank + 1) n / cluster)`` of 32 keys; within a CTA,
warp ``w`` owning tiles ``w, w + 4, ...`` with its own online softmax
(raw row max ``m``, ``p = 2^(s scale log2e - m scale log2e)``, the row sum
``l`` of the fp32 ``p``); the scores as bf16 products summed in fp32 per
16-wide k-step (``mma.sync.m16n8k16``); ``P`` split into hi + lo bf16 parts
for ``P V`` (``hi = bf16(p)``, ``lo = bf16(p - hi)``; two products at rep
16, one at rep 8 with ``lo`` in the zero heads' rows, its result added),
summed per 16-key k-step, ``hi`` first; positions past ``n_valid`` read as zeros and
scored ``-inf``; then the warps' merge and the cluster's merge (weights
``2^(m - max m)`` in the log2 domain) with the partial form's
``lse = ln 2 (max m + log2 sum w l)``.

Held to: without the rounding of ``P`` and on fp32 inputs, the exact
softmax (the port's ``decode_attention_partial_ref``) within 2e-5; with it,
the port's plain ``decode_attention_ref`` and the JAX Pallas kernel
``decode_attention_fwd`` (interpret mode, as tests/test_kernels.py runs it)
within 0.9 of ``chip_smoke.py``'s unchanged K3 limit, 2**-7 |plain| + 1e-2
RMS of the head's output (``KERNEL_RTOL``, ``KERNEL_ATOL_OF_RMS``), and
the partial form, each piece's output rounded to bf16 before the combine,
within 0.9 of that limit at two ulps. ``P`` in bf16 alone held the whole
decode at 0.65-0.69 of the limit but put the partial form at llama3-405b's
decode shape past it (1.04 here at seed 1; 1.03 on the card); hi + lo
holds it at 0.67-0.76, the whole decode at 0.33-0.50. A control that drops
the newest key must be refused by the same check.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.decode_attention.ops import TILE, decode_plan  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    combine_partials, decode_attention_partial_ref, decode_attention_ref)

WARPS = 4                 # warps a CTA: each owns every 4th of its tiles
LOG2E = 1.4426950408889634
KERNEL_RTOL = 2.0 ** -7   # chip_smoke.py's K3 limit, unchanged
KERNEL_ATOL_OF_RMS = 1e-2
PASS_MARK = 0.9           # the emulation's worst element, as a share of it


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate_decode_mma(q, k_cache, v_cache, n_valid, cluster=None,
                       p_parts="hi+lo"):
    """(o (B, H, dh) fp32 before the output's rounding, lse (B, H) fp32)
    over positions ``[0, n_valid)``, as the tensor-core kernel computes
    them; ``cluster`` defaults to ``decode_plan``'s. ``p_parts`` is how P
    meets V: ``"hi+lo"`` as the kernel, ``"bf16"`` (one rounding, the form
    the partial form refuses) or ``None`` (unrounded)."""
    B, H, dh = q.shape
    G = k_cache.shape[2]
    rep = H // G
    sl = torch.tensor(LOG2E / math.sqrt(dh), dtype=torch.float32)
    n_tiles, planned = decode_plan(n_valid)
    cluster = planned if cluster is None else cluster
    qg = q.float().view(B, G, rep, dh)
    # the tensor map reads positions past n_valid as zeros
    kk = torch.zeros(B, G, n_tiles * TILE, dh)
    vv = torch.zeros(B, G, n_tiles * TILE, dh)
    kk[:, :, :n_valid] = k_cache[:, :n_valid].float().permute(0, 2, 1, 3)
    vv[:, :, :n_valid] = v_cache[:, :n_valid].float().permute(0, 2, 1, 3)
    ctas = []
    for rank in range(cluster):
        t_begin = rank * n_tiles // cluster
        my_tiles = (rank + 1) * n_tiles // cluster - t_begin
        warps = []
        for w in range(WARPS):
            m = torch.full((B, G, rep), -math.inf)
            l_run = torch.zeros(B, G, rep)
            o = torch.zeros(B, G, rep, dh)
            for i in range(w, my_tiles, WARPS):
                t = t_begin + i
                rows = min(TILE, n_valid - t * TILE)
                kt = kk[:, :, t * TILE:(t + 1) * TILE]
                vt = vv[:, :, t * TILE:(t + 1) * TILE]
                s = torch.zeros(B, G, rep, TILE)
                for c in range(0, dh, 16):  # fp32 sums per k16 step
                    s = s + qg[..., c:c + 16] @ kt[..., c:c + 16].transpose(-1, -2)
                s[..., rows:] = -math.inf
                mx = torch.maximum(m, s.amax(-1))
                base = mx * sl
                alpha = torch.exp2(m * sl - base)
                # one FFMA: s * scale_log2 - base, rounded once
                p = torch.exp2((s.double() * sl.double()
                                - base.double()[..., None]).float())
                l_run = l_run * alpha + p.sum(-1)
                o = o * alpha[..., None]
                hi = p if p_parts is None else _bf16(p)
                parts = [hi, _bf16(p - hi)] if p_parts == "hi+lo" else [hi]
                for c in range(0, TILE, 16):  # fp32 sums per k16 step
                    for part in parts:
                        o = o + part[..., c:c + 16] @ vt[..., c:c + 16, :]
                m = mx
            warps.append((m * sl, l_run, o))
        wm = torch.stack([x[0] for x in warps])
        wt = torch.exp2(wm - wm.amax(0))
        ctas.append((wm.amax(0),
                     (wt * torch.stack([x[1] for x in warps])).sum(0),
                     (wt[..., None] * torch.stack([x[2] for x in warps])).sum(0)))
    cm = torch.stack([c[0] for c in ctas])
    mx = cm.amax(0)
    w = torch.exp2(cm - mx)
    den = (w * torch.stack([c[1] for c in ctas])).sum(0)
    num = (w[..., None] * torch.stack([c[2] for c in ctas])).sum(0)
    return ((num / den[..., None]).view(B, H, dh),
            ((mx + torch.log2(den)) * math.log(2)).view(B, H))


def _worst_share(got, want):
    """The worst element's |got - want| as a share of chip_smoke's K3 limit."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = KERNEL_RTOL * w.abs() + KERNEL_ATOL_OF_RMS * rms
    return float(((g - w).abs() / limit).max())


def _inputs(seed, B, H, G, dh, T):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, dh), (B, T, G, dh), (B, T, G, dh))]


def _jax_decode(arrays, cur):
    """The JAX Pallas kernel in interpret mode on the same bf16 values, with
    the largest block of at most 256 keys that divides T."""
    T = arrays[1].shape[1]
    block_k = max(d for d in range(1, 257) if T % d == 0)
    q, kc, vc = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    out = decode_attention_fwd(q, kc, vc, cur, block_k=block_k, interpret=True)
    return torch.from_numpy(np.asarray(out.astype(jnp.float32)))


@pytest.mark.parametrize("name,B,H,G", [
    ("llama3-405b", 8, 128, 8),          # rep 16
    ("qwen3-moe-235b-a22b", 8, 64, 4),   # rep 16
    ("deepseek-67b, internvl2-76b", 8, 64, 8),  # rep 8
    ("qwen3-vl-30b-a3b", 8, 32, 4),      # rep 8
])
@pytest.mark.parametrize("cur", [1015, 1031])
def test_emulation_holds_at_the_config_decode_shapes(name, B, H, G, cur):
    """The serving decode (8 prompts, a 1032-position cache) of every config
    at rep 8 or 16, against the port's plain version and the JAX kernel."""
    arrays = _inputs(0, B, H, G, 128, 1032)
    q, kc, vc = (torch.from_numpy(a).bfloat16() for a in arrays)
    got = emulate_decode_mma(q, kc, vc, cur + 1)[0].bfloat16()
    assert _worst_share(got, decode_attention_ref(q, kc, vc, cur)) <= PASS_MARK
    assert _worst_share(got, _jax_decode(arrays, cur)) <= PASS_MARK


@pytest.mark.parametrize("rep", [8, 16])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("T,n_valid,cluster", [
    (1032, 1016, None),   # cur_index 1015: 8 CTAs of 4 tiles, one a warp
    (100, 71, None),      # a ragged tail: 3 CTAs, 3 warps idle in each
    (100, 1, None),       # one key: 1 CTA, 1 tile, 3 warps idle
    (1032, 1016, 1),      # one CTA: each warp walks 8 tiles
])
def test_emulation_holds_across_head_dims_tails_and_clusters(rep, dh, T,
                                                             n_valid, cluster):
    G = 2
    arrays = _inputs(1, 2, rep * G, G, dh, T)
    q, kc, vc = (torch.from_numpy(a).bfloat16() for a in arrays)
    got = emulate_decode_mma(q, kc, vc, n_valid, cluster)[0].bfloat16()
    assert _worst_share(got, decode_attention_ref(q, kc, vc, n_valid - 1)) <= PASS_MARK
    assert _worst_share(got, _jax_decode(arrays, n_valid - 1)) <= PASS_MARK


@pytest.mark.parametrize("rep,dh,n_valid,cluster", [
    (16, 128, 1016, None), (8, 112, 71, None), (16, 64, 1, None),
    (8, 128, 1016, 1)])
def test_emulation_without_rounding_is_the_exact_softmax(rep, dh, n_valid,
                                                         cluster):
    """The tiling, the warps' and the cluster's merges alone: fp32 inputs,
    P unrounded, against the plain partial form (o and lse) in fp32."""
    G, T = 2, 1032
    q, kc, vc = (torch.from_numpy(a) for a in _inputs(2, 2, rep * G, G, dh, T))
    o, lse = emulate_decode_mma(q, kc, vc, n_valid, cluster, p_parts=None)
    po, plse = decode_attention_partial_ref(q, kc, vc, n_valid)
    torch.testing.assert_close(o, po, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, plse, atol=2e-5, rtol=2e-5)


def _partial_share(seed, B, rep, G, dh, cuts, p_parts="hi+lo"):
    """The partial form over position pieces (an empty one is o = 0, lse =
    -inf, as the wrapper returns it without a launch), each piece's lse
    against the plain partial's, combined as the sharded decode combines
    them: the worst element against the plain whole-cache decode, as a
    share of the limit at two ulps (each piece's output is rounded before
    the combine, as chip_smoke holds it)."""
    T, cur = 1032, 1015
    arrays = _inputs(seed, B, rep * G, G, dh, T)
    q, kc, vc = (torch.from_numpy(a).bfloat16() for a in arrays)
    bounds = [0, *cuts, T]
    outs, lses = [], []
    for a, b in zip(bounds, bounds[1:]):
        n_valid = min(max(cur + 1 - a, 0), b - a)
        kp, vp = kc[:, a:b].contiguous(), vc[:, a:b].contiguous()
        if n_valid == 0:
            o, lse = torch.zeros_like(q), torch.full(q.shape[:2], -math.inf)
        else:
            o, lse = emulate_decode_mma(q, kp, vp, n_valid, p_parts=p_parts)
            o = o.bfloat16()
            _, plse = decode_attention_partial_ref(q, kp, vp, n_valid)
            torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
        outs.append(o)
        lses.append(lse)
    assert bool(torch.isneginf(lses[-1]).all()) == (cuts[-1] > cur)
    got = combine_partials(outs, lses)
    want = decode_attention_ref(q, kc, vc, cur)
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = 2 * KERNEL_RTOL * w.abs() + KERNEL_ATOL_OF_RMS * rms
    return float(((g - w).abs() / limit).max())


# chip_smoke's cut of the 1032-position cache: [0, T/4, T/2, cur + 5, T]
CHIP_CUTS = (258, 516, 1020)


@pytest.mark.parametrize("seed,B,rep,G,dh,cuts", [
    (3, 2, 16, 2, 128, CHIP_CUTS),     # the last piece past cur_index: empty
    (3, 2, 8, 2, 112, (1, 150, 700)),  # a one-key piece
    (0, 8, 16, 8, 128, CHIP_CUTS),     # llama3-405b's decode, as chip_smoke cuts it
    (1, 8, 16, 8, 128, CHIP_CUTS),
    (2, 8, 16, 8, 128, CHIP_CUTS),
])
def test_partial_form_combined_holds(seed, B, rep, G, dh, cuts):
    assert _partial_share(seed, B, rep, G, dh, cuts) <= PASS_MARK


def test_p_in_bf16_alone_breaks_the_partial_form():
    """Why P meets V as hi + lo: rounded to bf16 once, the partial form at
    llama3-405b's decode shape passes the limit the kernel's form holds."""
    assert _partial_share(1, 8, 16, 8, 128, CHIP_CUTS, p_parts="bf16") > 1.0


@pytest.mark.parametrize("name,B,H,G,dh", [
    ("llama3-405b", 8, 128, 8, 128), ("qwen3-vl-30b-a3b", 8, 32, 4, 128),
    ("rep 16 at dh 112", 2, 32, 2, 112)])
def test_the_check_refuses_a_dropped_key(name, B, H, G, dh):
    """The control: the emulation over one key fewer than the plain version
    attends must fail the check it passes above."""
    q, kc, vc = (torch.from_numpy(a).bfloat16()
                 for a in _inputs(4, B, H, G, dh, 1032))
    got = emulate_decode_mma(q, kc, vc, 1015)[0].bfloat16()
    assert _worst_share(got, decode_attention_ref(q, kc, vc, 1015)) > 1.0
