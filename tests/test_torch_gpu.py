"""The port's Hopper kernels on the card, each against its plain PyTorch
version, plus one small model run through the kernels.

Every test carries the ``gpu`` marker and skips where no CUDA card is
present. This file imports no JAX, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances. A kernel against its plain version, as chip_smoke.py checks
it: each element must hold |kernel - plain| <= 2**-7 |plain| + c RMS, one
bf16 ulp of the value plus a share c of the RMS of its output vector (the
last axis): c = 1e-2 for RMSNorm, decode attention and WKV6's y, which
compute in fp32 throughout, and 2e-2 for flash attention, which feeds P to
the tensor cores in bf16. A fixed 4e-2 would be as large as a
decode-attention output over 1000 keys. WKV6's fp32 state is held to
1e-3 |plain| + 1e-3 RMS of its row (see WKV_STATE_TOL). The
model on the card against the model on the CPU runs through different
weight products, so it keeps the end-to-end bf16 atol = rtol = 4e-2 of
tests/test_kernels.py.

Gradients. Each autograd Function's forward output is held to its plain
version at the kernel limits above. Its backward recomputes the plain version
from the saved inputs and differentiates it, which is what autograd through
the plain version does on the same inputs: the kernel's forward output never
enters the gradients, so the two are held bit-identical (tolerance zero).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    TILE, decode_attention, decode_attention_partial)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    combine_partials, decode_attention_partial_ref, decode_attention_ref)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_fwd  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_chunked  # noqa: E402
from repro_torch.configs.rwkv6_3b import SMOKE_CONFIG as RWKV_SMOKE  # noqa: E402
from repro_torch.models import (ModelConfig, decode_step,  # noqa: E402
                                init_decode_state, init_params, param_specs,
                                prefill)
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.engine import serving_params  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import: every xdist
    worker must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


KERNEL_RTOL = 2.0 ** -7


#: WKV6's fp32 state, kernel against plain (both chunked, 64 tokens): each
#: element within 1e-3 |plain| + 1e-3 RMS of its row. Both carry the decay
#: as exp of differences of fp32 cumulative log sums that reach ~-1800 over
#: a chunk (log w is clamped at log 1e-12 = -27.6), whose rounding is ~1e-4
#: of a decay factor; the kernel's state product is 3xTF32 (near fp32); the
#: rest is fp32 summation over at most 1000 steps.
WKV_STATE_TOL = 1e-3


def _worst_share(got, want, rtol, c):
    """The worst element's |got - want| as a share of rtol |want| + c RMS."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = rtol * w.abs() + c * rms
    return float((err / limit.clamp_min(1e-30)).max()), float(err.max())


def _assert_kernel_close(got, want, c, rtol=KERNEL_RTOL):
    worst, err = _worst_share(got, want, rtol, c)
    assert worst <= 1.0, (f"max |err| {err:.3e}, worst element "
                          f"at {worst:.2f}x its limit")


def _assert_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=4e-2, rtol=4e-2)


@pytest.mark.parametrize("shape", [
    (8000, 4096), (8, 4096), (1001, 4096),
    (8000, 2560), (8, 2560),  # rwkv6-3b's D
    (3, 7, 256), (2, 64), (1, 8),
    # the repo's widths up to 16384 (llama3_405b): 1 row and 7 rows spread
    # each row over up to 16 warps, 1001 rows over 1-4 warps with a ragged
    # last block
    *[(rows, dim) for dim in (8, 64, 2560, 4096, 5120, 8192, 16384)
      for rows in (1, 7, 1001)],
    (3, 70000),  # wider than 16 warps' registers: walked in slabs
])
def test_rmsnorm_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _randn(gen, shape, torch.bfloat16, cuda)
    w = _randn(gen, (shape[-1],), torch.float32, cuda)
    _assert_kernel_close(rmsnorm(x, w), rmsnorm_ref(x, w), c=1e-2)


@pytest.mark.parametrize("B,S,T,H,G,dh,causal", [
    (2, 1000, 1000, 32, 8, 128, True),
    (2, 45, 45, 4, 2, 128, True),
    (1, 45, 100, 6, 3, 64, False),
    (1, 1, 1, 2, 1, 64, True),
    (1, 130, 130, 8, 8, 64, True),
    # the 128-row q tile and its edges, rep 1 / 4 / 8
    (1, 1, 1, 8, 1, 128, True),
    (1, 127, 127, 4, 1, 128, True),
    (2, 128, 128, 8, 1, 128, True),
    (1, 129, 129, 2, 2, 64, True),
    # T > S without causality, T not a multiple of the 128-key tile
    (1, 200, 333, 4, 2, 128, False),
    (2, 1, 300, 4, 2, 64, False),
    # dh 64 over several q tiles
    (2, 300, 300, 4, 4, 64, True),
    # deepseek-moe-16b's serving prefill (rep 1) and qwen3-vl-30b-a3b's
    # training sequence, 1024 tokens after a 128-frame prefix (rep 8)
    (8, 1000, 1000, 16, 16, 128, True),
    (4, 1152, 1152, 32, 4, 128, True),
    # head_dim 112, zero-padded to 128 in the kernel: zamba2-7b's prefill
    # (rep 1), ragged S and T, rep 4 without causality, one row
    (8, 1000, 1000, 32, 32, 112, True),
    (2, 45, 45, 4, 4, 112, True),
    (1, 200, 333, 8, 2, 112, False),
    (1, 1, 1, 2, 2, 112, True),
    # head_dim 64 at rep 1, 24 heads: musicgen-medium's serving prefill (a
    # 128-frame prefix and 1000 frames, S not a multiple of the 128-row
    # tile), its training sequence, and a ragged one
    (8, 1128, 1128, 24, 24, 64, True),
    (4, 1152, 1152, 24, 24, 64, True),
    (2, 45, 45, 24, 24, 64, True),
    # rep 16: llama3-405b's serving prefill (128 heads over 8), and small
    # ragged ones at dh 64 and 112
    (8, 1000, 1000, 128, 8, 128, True),
    (2, 45, 45, 16, 1, 64, True),
    (1, 200, 333, 32, 2, 112, False),
    # rep 1 at zamba2-7b's and deepseek-moe-16b's widths over 2 prompts:
    # the work order's sections hold all 64 / 32 (batch, kv head) pairs
    (2, 1000, 1000, 32, 32, 112, True),
    (2, 1000, 1000, 16, 16, 128, True),
])
def test_flash_attention_kernel_matches_plain(cuda, B, S, T, H, G, dh, causal):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, (B, S, H, dh), torch.bfloat16, cuda)
    k = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    v = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    _assert_kernel_close(flash_attention(q, k, v, causal),
                         flash_attention_ref(q, k, v, causal), c=2e-2)


@pytest.mark.parametrize("B,S,H,G,dh,sections", [
    (2, 3000, 20, 20, 128, [14, 14, 12]),  # 40 pairs of 1.5 MB of K and V
    (3, 4000, 9, 9, 112, [14, 13]),
    (1, 2500, 13, 13, 64, [13]),           # fewer pairs than a section holds
    (2, 4000, 52, 13, 128, [9, 9, 8]),     # rep 4
])
def test_flash_attention_work_order_sections_match_plain(cuda, B, S, H, G, dh,
                                                         sections):
    """K1 with its (batch, kv head) pairs cut into sections of about half
    the card's 50 MB L2, a partial last one among them, and S not a
    multiple of the 128-row q tile."""
    from repro_torch.kernels.flash_attention.ops import _l2_bytes, l2_section
    sec = l2_section(B, G, S, dh, _l2_bytes(cuda))
    assert [min(sec, B * G - i) for i in range(0, B * G, sec)] == sections
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = _randn(gen, (B, S, H, dh), torch.bfloat16, cuda)
    k = _randn(gen, (B, S, G, dh), torch.bfloat16, cuda)
    v = _randn(gen, (B, S, G, dh), torch.bfloat16, cuda)
    _assert_kernel_close(flash_attention(q, k, v, True),
                         flash_attention_ref(q, k, v, True), c=2e-2)


@pytest.mark.parametrize("B,H,G,dh,T,cur", [
    (8, 32, 8, 128, 1032, 1015),
    (8, 32, 8, 128, 1032, 1031),
    (2, 8, 2, 64, 256, 0),
    (3, 6, 3, 64, 100, 70),
    (1, 8, 1, 128, 700, 699),
    # n_valid a whole number of tiles, and one key more; rep 1 / 2 / 4 / 8
    (2, 4, 4, 128, 300, 8 * TILE - 1),
    (2, 4, 2, 64, 400, 8 * TILE),
    (1, 16, 2, 128, 512, 3 * TILE - 1),
    (1, 8, 8, 64, 97, 3 * TILE),
    # long caches: each CTA of a cluster walks many tiles through its ring
    (1, 8, 1, 128, 8192, 8191),
    (2, 32, 8, 128, 8192, 5000),
    # deepseek-moe-16b's decode (rep 1) over the 1032-position cache
    (8, 16, 16, 128, 1032, 1015),
    (8, 16, 16, 128, 1032, 1031),
    # head_dim 112: zamba2-7b's decode (rep 1), its cache's last position,
    # a ragged tail, rep 8 over whole tiles, one key
    (8, 32, 32, 112, 1032, 1015),
    (8, 32, 32, 112, 1032, 1031),
    (3, 6, 3, 112, 100, 70),
    (2, 8, 1, 112, 300, 8 * TILE - 1),
    (1, 4, 4, 112, 5, 0),
    # head_dim 64 at rep 1, 24 heads: musicgen-medium's decode over its
    # 1160-position cache (prefix, prompt and 32 new frames), its first
    # step and its cache's last position, and a ragged tail
    (8, 24, 24, 64, 1160, 1127),
    (8, 24, 24, 64, 1160, 1128),
    (8, 24, 24, 64, 1160, 1159),
    (3, 24, 24, 64, 100, 70),
    # rep 16 on the tensor cores: llama3-405b's decode (128
    # heads over 8), qwen3-moe-235b-a22b's (64 over 4), at dh 64, 112 and
    # 128, ragged tails, one key, a long cache
    (8, 128, 8, 128, 1032, 1015),
    (8, 64, 4, 128, 1032, 1031),
    (2, 32, 2, 64, 300, 299),
    (3, 16, 1, 64, 100, 70),
    (2, 32, 2, 112, 300, 150),
    (1, 16, 1, 112, 5, 0),
    (1, 16, 1, 128, 8192, 8191),
])
def test_decode_attention_kernel_matches_plain(cuda, B, H, G, dh, T, cur):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (B, H, dh), torch.bfloat16, cuda)
    kc = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    vc = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    _assert_kernel_close(decode_attention(q, kc, vc, cur),
                         decode_attention_ref(q, kc, vc, cur), c=1e-2)


@pytest.mark.parametrize("rep", [8, 16])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("cur", [0, 30, 31, 32, 95, 127, 159, 191, 223, 299])
def test_decode_attention_tensor_core_form_matches_plain(cuda, rep, dh, cur):
    """Rep 8 and 16 on the tensor cores over a 300-position cache: one key,
    a tile's last key, one tile, one key past it, then 3 to 10 tiles, so
    clusters of 1 to 8 CTAs with 1 to 4 warps holding a tile."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    B, G, T = 2, 2, 300
    q = _randn(gen, (B, rep * G, dh), torch.bfloat16, cuda)
    kc = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    vc = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    _assert_kernel_close(decode_attention(q, kc, vc, cur),
                         decode_attention_ref(q, kc, vc, cur), c=1e-2)


@pytest.mark.parametrize("B,H,G,dh,T,cur,cuts", [
    (8, 128, 8, 128, 1032, 1015, (258, 516, 1020)),  # rep 16, one piece past cur
    (8, 32, 8, 128, 1032, 1015, (258, 516, 1020)),   # rep 4
    (2, 64, 4, 64, 300, 120, (100, 130, 200)),       # rep 16 at dh 64, two empty
    (2, 32, 2, 112, 300, 299, (1, 150)),             # dh 112, a one-key piece
    (2, 16, 2, 112, 300, 120, (100, 130, 200)),      # rep 8 at dh 112, two empty
])
def test_decode_attention_partial_pieces_combined_match_whole_and_plain(
        cuda, B, H, G, dh, T, cur, cuts):
    """K3's partial form over position pieces (an empty one launches
    nothing), combined, against K3 over the whole cache and the plain
    version; each piece's lse against the plain partial's."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = _randn(gen, (B, H, dh), torch.bfloat16, cuda)
    kc = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    vc = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    bounds = [0, *cuts, T]
    outs, lses, launched = [], [], 0
    kcommon.reset_launches()
    for a, b in zip(bounds, bounds[1:]):
        n_valid = min(max(cur + 1 - a, 0), b - a)
        kp, vp = kc[:, a:b].contiguous(), vc[:, a:b].contiguous()
        o, lse = decode_attention_partial(q, kp, vp, n_valid)
        po, plse = decode_attention_partial_ref(q, kp, vp, n_valid)
        launched += n_valid > 0
        if n_valid:
            _assert_kernel_close(o, po, c=1e-2)
            torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-5)
        else:
            assert bool((o == 0).all()) and bool(torch.isneginf(lse).all())
        outs.append(o)
        lses.append(lse)
    torch.cuda.synchronize()
    assert kcommon.launches["decode_attention"] == launched
    got = combine_partials(outs, lses)
    # each piece's output is rounded to bf16 before the combine: 2 ulps
    _assert_kernel_close(got, decode_attention(q, kc, vc, cur), c=1e-2,
                         rtol=2 * KERNEL_RTOL)
    _assert_kernel_close(got, decode_attention_ref(q, kc, vc, cur), c=1e-2,
                         rtol=2 * KERNEL_RTOL)


@pytest.mark.parametrize("shape", [(8000, 7168), (8, 16384), (1001, 448),
                                   (3, 70000)])
def test_rmsnorm_with_a_given_mean_square_matches_plain(cuda, shape):
    """K2 handed each row's own mean square (the sharded-row form) against
    K2 without it and the plain version; four times the mean square must
    be refused."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = _randn(gen, shape, torch.bfloat16, cuda)
    w = _randn(gen, (shape[-1],), torch.float32, cuda)
    ms = x.float().pow(2).mean(-1)
    got = rmsnorm_fwd(x, w, 1e-5, ms)
    _assert_kernel_close(got, rmsnorm_ref(x, w), c=1e-2)
    _assert_kernel_close(got, rmsnorm(x, w), c=1e-2)
    assert _worst_share(rmsnorm_fwd(x, w, 1e-5, 4 * ms), rmsnorm_ref(x, w),
                        KERNEL_RTOL, 1e-2)[0] > 1.0


def test_decode_attention_refuses_a_rep_outside_reps(cuda):
    for H, G in ((12, 1), (6, 2), (32, 1)):   # rep 12, 3, 32: no config has them
        q = torch.zeros(1, H, 64, dtype=torch.bfloat16, device=cuda)
        kc = torch.zeros(1, 64, G, 64, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="H/G"):
            decode_attention(q, kc, kc, 10)
        with pytest.raises(ValueError, match="H/G"):
            decode_attention_partial(q, kc, kc, 10)


def _wkv_inputs(gen, B, S, H, dh, dtype, device, decay="model"):
    """r, k, v unit normal; w from the model's exp(-exp(clip(N, -8, 4))), or
    every decay at the 1e-12 clamp, or all 1 - 2**-8 (nearly none); u ~ 0.3
    N; all but u rounded to ``dtype``."""
    r, k, v = (_randn(gen, (B, S, H, dh), dtype, device) for _ in range(3))
    n = torch.randn((B, S, H, dh), generator=gen, device=device)
    w = {"model": torch.exp(-torch.exp(n.clamp(-8.0, 4.0))),
         "clamped": torch.full_like(n, 1e-12),
         "nearly none": torch.full_like(n, 1.0 - 2.0 ** -8)}[decay].to(dtype)
    u = 0.3 * torch.randn((H, dh), generator=gen, device=device)
    return r, k, v, w, u


@pytest.mark.parametrize("B,S,H,dh,dtype,decay", [
    (2, 200, 8, 64, torch.bfloat16, "model"),
    (3, 45, 5, 64, torch.bfloat16, "model"),     # S fills no chunk
    (1, 1, 1, 64, torch.bfloat16, "model"),      # one token
    (2, 33, 4, 16, torch.bfloat16, "model"),     # the smoke model's head_dim
    (1, 70, 2, 64, torch.float32, "model"),
    # the 16-token sub-chunk's and the 64-token chunk's edges
    *[(2, S, 4, 64, torch.bfloat16, "model") for S in (15, 16, 17, 63, 64, 65, 129)],
    (2, 129, 4, 64, torch.bfloat16, "clamped"),  # every decay clamped
    (2, 129, 4, 64, torch.bfloat16, "nearly none"),
    (2, 200, 4, 16, torch.bfloat16, "model"),    # dh 16 over several chunks
    (2, 200, 4, 64, torch.float32, "model"),
    (8, 1000, 8, 64, torch.bfloat16, "model"),   # the serving length
])
def test_wkv6_kernel_matches_plain(cuda, B, S, H, dh, dtype, decay):
    gen = torch.Generator(device=cuda).manual_seed(3)
    r, k, v, w, u = _wkv_inputs(gen, B, S, H, dh, dtype, cuda, decay)
    y, state = wkv6(r, k, v, w, u, 64)
    py, pstate = wkv6_chunked(r, k, v, w, u, 64)
    _assert_kernel_close(y, py, c=1e-2)
    _assert_kernel_close(state, pstate, c=WKV_STATE_TOL, rtol=WKV_STATE_TOL)
    # negative controls: u zeroed changes y; the last token's k zeroed
    # changes the state
    y0, _ = wkv6(r, k, v, w, torch.zeros_like(u), 64)
    assert _worst_share(y0, py, KERNEL_RTOL, 1e-2)[0] > 1.0
    k_bad = k.clone()
    k_bad[:, -1] = 0
    _, s_bad = wkv6(r, k_bad, v, w, u, 64)
    assert _worst_share(s_bad, pstate, WKV_STATE_TOL, WKV_STATE_TOL)[0] > 1.0


def test_wkv6_refuses_inputs_it_does_not_take(cuda):
    r = torch.zeros(1, 4, 2, 64, dtype=torch.float16, device=cuda)
    u = torch.zeros(2, 64, device=cuda)
    with pytest.raises(ValueError):
        wkv6(r, r, r, r, u, 64)            # fp16
    r = r.float()
    with pytest.raises(ValueError):        # w in another dtype than r
        wkv6(r, r, r, r.to(torch.bfloat16), u, 64)
    with pytest.raises(ValueError):        # u not fp32
        wkv6(r, r, r, r, u.to(torch.bfloat16), 64)
    r = torch.zeros(1, 4, 2, 8, device=cuda)
    with pytest.raises(ValueError):        # head_dim 8
        wkv6(r, r, r, r, torch.zeros(2, 8, device=cuda), 64)


def test_kernels_refuse_inputs_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 2, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)           # fp16
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)           # head_dim 16
    with pytest.raises(ValueError):        # fp32 x
        rmsnorm(torch.zeros(2, 8, device=cuda), torch.ones(8, device=cuda))
    with pytest.raises(ValueError):        # D not a multiple of 8
        rmsnorm(torch.zeros(2, 6, dtype=torch.bfloat16, device=cuda),
                torch.ones(6, device=cuda))
    with pytest.raises(ValueError):        # scale not 16-byte aligned
        rmsnorm(torch.zeros(2, 8, dtype=torch.bfloat16, device=cuda),
                torch.ones(9, device=cuda)[1:])


def test_model_on_the_card_launches_the_kernels_and_matches_the_cpu(cuda):
    cfg = ModelConfig(name="gpu-smoke", family="dense", num_layers=2,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=512)  # head_dim 64
    cpu_params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                                 device="cpu"), torch.device("cpu"))
    gpu_params = serving_params(cfg, cpu_params, cuda)
    tokens = torch.arange(2 * 12).reshape(2, 12) * 7 % cfg.vocab_size
    kcommon.reset_launches()
    with torch.inference_mode():
        out = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            cache = init_decode_state(cfg, 2, 16, device=dev)
            logits, cache = prefill(cfg, params, {"tokens": tokens.to(dev)},
                                    cache=cache)
            steps = [logits]
            for i in range(3):
                logits, cache = decode_step(cfg, params, cache,
                                            tokens[:, i].to(dev), 12 + i)
                steps.append(logits)
            out[dev] = steps
    L = cfg.num_layers
    assert kcommon.launches == {"rmsnorm": (2 * L + 1) * 4,
                                "flash_attention": L,
                                "decode_attention": 3 * L,
                                "wkv6": 0}
    for a, b in zip(out["cuda"], out["cpu"]):
        _assert_close(a.cpu(), b)


#: deepseek-moe-16b's layout (rep 1, shared experts) and qwen3-vl-30b-a3b's
#: (rep 8, no shared experts, a vision prefix) at head_dim 64, the smallest
#: the kernels take
_DEEPSEEK_NARROW = ModelConfig(
    name="deepseek-moe-narrow", family="moe", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=512, moe_num_experts=8,
    moe_top_k=2, moe_num_shared=1, moe_d_ff=64)
_QWEN3_VL_NARROW = ModelConfig(
    name="qwen3-vl-narrow", family="moe", num_layers=2, d_model=256,
    num_heads=8, num_kv_heads=1, head_dim=64, d_ff=64, vocab_size=512,
    moe_num_experts=8, moe_top_k=2, moe_d_ff=64, frontend="vision",
    rope_theta=1e6)


@contextlib.contextmanager
def _routing_replay(first_run):
    """Record each call's top-k choices of ``moe._routing`` while
    ``first_run[0]`` is true, then replay them, in call order, in the runs
    after: a near-tied choice that the card's bf16 hidden states tip the
    other way would otherwise move a token's whole FFN output. Yields the
    list of (calls, choices that differed) of the later runs."""
    from repro_torch.models import moe

    recorded, flips, routing = [], [], moe._routing

    def wrapped(cfg, p, xt):
        if first_run[0]:
            out = routing(cfg, p, xt)
            recorded.append(out[2].cpu())
            return out
        probs = moe.router_probs(p, xt)
        want = recorded[len(flips)].to(probs.device)
        flips.append(int((moe.top_k(probs, cfg.moe_top_k)[1] != want).sum()))
        return moe.plan(cfg, probs, want)

    moe._routing = wrapped
    try:
        yield flips
    finally:
        moe._routing = routing


@pytest.mark.parametrize("cfg", [_DEEPSEEK_NARROW, _QWEN3_VL_NARROW],
                         ids=lambda c: c.name)
def test_moe_model_on_the_card_launches_the_kernels_and_matches_the_cpu(
        cuda, cfg):
    """A 2-layer MoE model at a narrow width: prefill (after an 8-frame
    prefix for the vision layout) and three decode steps on the card, launch
    counts as the dense model's, logits against the CPU port at 4e-2 under
    the card's routing choices."""
    cpu_params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                                 device="cpu"), torch.device("cpu"))
    gpu_params = serving_params(cfg, cpu_params, cuda)
    assert gpu_params["layers"]["router"].dtype == torch.float32
    tokens = torch.arange(2 * 12).reshape(2, 12) * 7 % cfg.vocab_size
    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = 0.5 * torch.randn(
            (2, 8, cfg.d_model), generator=torch.Generator().manual_seed(0))
    n0 = 12 + (8 if cfg.frontend == "vision" else 0)
    first, out, counts = [True], {}, {}
    with torch.inference_mode(), _routing_replay(first) as flips:
        for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            kcommon.reset_launches()
            cache = init_decode_state(cfg, 2, n0 + 4, device=dev)
            logits, cache = prefill(cfg, params,
                                    {k: v.to(dev) for k, v in batch.items()},
                                    cache=cache)
            steps = [logits]
            for i in range(3):
                logits, cache = decode_step(cfg, params, cache,
                                            tokens[:, i].to(dev), n0 + i)
                steps.append(logits)
            out[dev], counts[dev] = steps, dict(kcommon.launches)
            first[0] = False
    L = cfg.num_layers
    print(f"{cfg.name}: choices the CPU would have made otherwise, per "
          f"call: {flips}")
    assert len(flips) == 4 * L
    assert counts["cuda"] == {"rmsnorm": (2 * L + 1) * 4, "flash_attention": L,
                              "decode_attention": 3 * L, "wkv6": 0}
    assert counts["cpu"] == {name: 0 for name in kcommon.KERNELS}
    for a, b in zip(out["cuda"], out["cpu"]):
        _assert_close(a.cpu(), b)


def test_rwkv6_on_the_card_launches_the_kernels_and_matches_the_cpu(cuda):
    """The rwkv6-3b smoke model (2 layers, head_dim 16): prefill through K4
    and K2, then three recurrent decode steps through K2 only."""
    cfg = RWKV_SMOKE
    cpu_params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                                 device="cpu"), torch.device("cpu"))
    gpu_params = serving_params(cfg, cpu_params, cuda)
    tokens = torch.arange(2 * 12).reshape(2, 12) * 7 % cfg.vocab_size
    out, counts = {}, {}
    with torch.inference_mode():
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            kcommon.reset_launches()
            state = init_decode_state(cfg, 2, 16, device=dev)
            logits, state = prefill(cfg, params, {"tokens": tokens.to(dev)},
                                    cache=state)
            steps = [logits]
            for i in range(3):
                logits, state = decode_step(cfg, params, state,
                                            tokens[:, i].to(dev), 12 + i)
                steps.append(logits)
            out[dev] = steps + [state[k] for k in sorted(state)]
            counts[dev] = dict(kcommon.launches)
    L = cfg.num_layers
    assert counts["cpu"] == {name: 0 for name in kcommon.KERNELS}
    assert counts["cuda"] == {"rmsnorm": (3 * L + 1) * 4, "flash_attention": 0,
                              "decode_attention": 0, "wkv6": L}
    for a, b in zip(out["cuda"], out["cpu"]):
        _assert_close(a.cpu(), b)


#: zamba2-7b's layout at a narrow width: head_dim 112 (448 / 4, rep 1), one
#: group of two Mamba2 layers and the shared block, then a tail layer
_ZAMBA2_NARROW = ModelConfig(
    name="zamba2-narrow", family="hybrid", num_layers=3, d_model=448,
    num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512, ssm_state=16,
    ssm_head_dim=64, ssm_expand=2, attn_every=2, rope_theta=1e4)


def test_hybrid_on_the_card_launches_the_kernels_and_matches_the_cpu(cuda):
    """The narrow hybrid: prefill through K1 (head_dim 112) and K2, three
    decode steps through K3 and K2, the recurrent states and KV caches
    after them, all against the CPU port at 4e-2."""
    cfg = _ZAMBA2_NARROW
    assert cfg.head_dim == 112
    cpu_params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                                 device="cpu"), torch.device("cpu"))
    gpu_params = serving_params(cfg, cpu_params, cuda)
    tokens = torch.arange(2 * 12).reshape(2, 12) * 7 % cfg.vocab_size
    out, counts = {}, {}
    with torch.inference_mode():
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            kcommon.reset_launches()
            state = init_decode_state(cfg, 2, 16, device=dev)
            logits, state = prefill(cfg, params, {"tokens": tokens.to(dev)},
                                    cache=state)
            steps = [logits]
            for i in range(3):
                logits, state = decode_step(cfg, params, state,
                                            tokens[:, i].to(dev), 12 + i)
                steps.append(logits)
            out[dev] = steps + [state[k] for k in sorted(state)]
            counts[dev] = dict(kcommon.launches)
    norms = 2 * cfg.num_layers + 2 + 1  # Mamba2 layers, shared block, final
    assert counts["cpu"] == {name: 0 for name in kcommon.KERNELS}
    assert counts["cuda"] == {"rmsnorm": norms * 4, "flash_attention": 1,
                              "decode_attention": 3, "wkv6": 0}
    for a, b in zip(out["cuda"], out["cpu"]):
        _assert_close(a.cpu(), b)


#: musicgen-medium's layout at a narrow width: 4 codebooks, 4 heads of 64
#: over 4 KV heads (rep 1), a conditioning prefix
_MUSICGEN_NARROW = ModelConfig(
    name="musicgen-narrow", family="audio", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512, num_codebooks=4,
    frontend="audio")


def _audio_batch(cfg, n=12, prefix=8):
    gen = torch.Generator().manual_seed(0)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (2, n, cfg.num_codebooks), generator=gen),
            "frontend_embeds": 0.5 * torch.randn((2, prefix, cfg.d_model),
                                                 generator=gen)}


def test_audio_model_on_the_card_launches_the_kernels_and_matches_the_cpu(cuda):
    """The narrow audio model: prefill of 12 frames of 4 codebooks after an
    8-frame prefix through K1 and K2, then three decode steps of (B, 4)
    tokens through K3 and K2, each step's (B, 4, V) logits against the CPU
    port at 4e-2."""
    cfg = _MUSICGEN_NARROW
    assert cfg.head_dim == 64
    cpu_params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                                 device="cpu"), torch.device("cpu"))
    gpu_params = serving_params(cfg, cpu_params, cuda)
    batch = _audio_batch(cfg)
    n0 = 8 + 12
    out, counts = {}, {}
    with torch.inference_mode():
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            kcommon.reset_launches()
            cache = init_decode_state(cfg, 2, n0 + 4, device=dev)
            logits, cache = prefill(cfg, params,
                                    {k: v.to(dev) for k, v in batch.items()},
                                    cache=cache)
            steps = [logits]
            for i in range(3):
                logits, cache = decode_step(
                    cfg, params, cache, batch["tokens"][:, i].to(dev), n0 + i)
                steps.append(logits)
            out[dev], counts[dev] = steps, dict(kcommon.launches)
    L = cfg.num_layers
    assert counts["cpu"] == {name: 0 for name in kcommon.KERNELS}
    assert counts["cuda"] == {"rmsnorm": (2 * L + 1) * 4, "flash_attention": L,
                              "decode_attention": 3 * L, "wkv6": 0}
    assert out["cuda"][0].shape == (2, cfg.num_codebooks, cfg.vocab_size)
    for a, b in zip(out["cuda"], out["cpu"]):
        _assert_close(a.cpu(), b)


#: a gradient leaf's relative RMS error from the CPU's fp32 gradients, on
#: the card, as a multiple of the CPU's own bf16 error: the kernels are held
#: to be no less accurate than the plain path, not to round as the CPU does
GRAD_ERR_OF_CPU_ERR = 2.0


def _rel_rms(a, b):
    return float((a.float() - b.float()).pow(2).mean().sqrt()
                 / b.float().pow(2).mean().sqrt().clamp_min(1e-30))


@pytest.mark.parametrize("remat", [True, False])
def test_hybrid_train_path_launches_the_kernels_and_matches_the_cpu(cuda,
                                                                    remat):
    """Loss and grads of the narrow hybrid on the card and on the CPU. With
    remat a Mamba2 layer inside the group runs forward three times (the
    forward, the group's recompute, its own recompute), the shared block and
    the tail layer twice, the final norm once. The loss is held at 4e-2;
    each gradient leaf's error from the CPU's fp32 gradients to
    GRAD_ERR_OF_CPU_ERR times the CPU's own bf16 error."""
    cfg = _ZAMBA2_NARROW.replace(remat=remat)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    batch = {"tokens": torch.arange(2 * 24).reshape(2, 24) * 7 % cfg.vocab_size}
    out = {}
    for dev, dtype in (("cpu", "float32"), ("cpu", "bfloat16"),
                       ("cuda", "bfloat16")):
        kcommon.reset_launches()
        loss, _, grads = loss_and_grads(
            cfg.replace(compute_dtype=dtype), tree_map(lambda t: t.to(dev), params),
            {k: v.to(dev) for k, v in batch.items()})
        assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        out[dev, dtype] = (loss.cpu(), dict(kcommon.launches),
                           [g.cpu() for g in tree_leaves(grads)])
    grouped, shared, tail = (3, 2, 2) if remat else (1, 1, 1)
    want = {name: 0 for name in kcommon.KERNELS}
    want["rmsnorm"] = 2 * (grouped * 2 + shared + tail) + 1
    want["flash_attention"] = shared
    assert out["cpu", "bfloat16"][1] == {name: 0 for name in kcommon.KERNELS}
    assert out["cuda", "bfloat16"][1] == want
    _assert_close(out["cuda", "bfloat16"][0], out["cpu", "bfloat16"][0])
    for g, c, truth in zip(out["cuda", "bfloat16"][2], out["cpu", "bfloat16"][2],
                           out["cpu", "float32"][2]):
        card, cpu = _rel_rms(g, truth), _rel_rms(c, truth)
        assert card <= GRAD_ERR_OF_CPU_ERR * cpu, (card, cpu)


# ---------------------------------------------------------------------------
# Training: the autograd Functions' gradients and the train path's launches
# ---------------------------------------------------------------------------

def _function_vs_plain(fn, plain, inputs, gen, launches, tols):
    """``fn`` (the kernel's Function) against ``plain`` on the same inputs,
    both recording grads: each output within its (c, rtol) of ``tols``, as
    the kernel tests hold it; then the grads of one random cotangent of the
    first output, which must be bit-identical. Asserts the kernel launched
    ``launches`` times."""
    kin = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
    pin = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
    kcommon.reset_launches()
    kout = fn(*kin)
    kout = kout if isinstance(kout, tuple) else (kout,)
    pout = plain(*pin)
    pout = pout if isinstance(pout, tuple) else (pout,)
    assert sum(kcommon.launches.values()) == launches
    assert len(kout) == len(pout) == len(tols)
    for got, want, (c, rtol) in zip(kout, pout, tols):
        _assert_kernel_close(got.detach(), want.detach(), c=c, rtol=rtol)
    g = torch.randn(kout[0].shape, generator=gen,
                    device=kout[0].device).to(kout[0].dtype)
    kout[0].backward(g)
    pout[0].backward(g)
    assert sum(kcommon.launches.values()) == launches
    for a, b in zip(kin, pin):
        if a.requires_grad:
            assert a.grad.dtype == a.dtype and torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("shape", [(4096, 4096), (4096, 2560)])
def test_rmsnorm_function_grads_equal_plain_autograd(cuda, shape):
    """granite-8b's and rwkv6-3b's train-step rows (GB 4 x S 1024)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = _randn(gen, shape, torch.bfloat16, cuda)
    w = _randn(gen, (shape[-1],), torch.float32, cuda)
    _function_vs_plain(rmsnorm, rmsnorm_ref, [x, w], gen, launches=1,
                       tols=[(1e-2, KERNEL_RTOL)])


@pytest.mark.parametrize("B,S,H,G,dh", [
    (4, 1024, 32, 8, 128),   # granite-8b's train step, GQA rep 4
    (2, 1024, 16, 4, 64),
    (4, 1024, 32, 32, 112),  # zamba2-7b's train step, rep 1
])
def test_flash_attention_function_grads_equal_plain_autograd(cuda, B, S, H,
                                                             G, dh):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, (B, S, H, dh), torch.bfloat16, cuda)
    k = _randn(gen, (B, S, G, dh), torch.bfloat16, cuda)
    v = _randn(gen, (B, S, G, dh), torch.bfloat16, cuda)
    _function_vs_plain(lambda *a: flash_attention(*a, True),
                       lambda *a: flash_attention_ref(*a, True),
                       [q, k, v], gen, launches=1,
                       tols=[(2e-2, KERNEL_RTOL)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_function_grads_equal_plain_autograd(cuda, dtype):
    """rwkv6-3b's 40 heads of 64 over 1024 tokens."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    ins = _wkv_inputs(gen, 2, 1024, 40, 64, dtype, cuda)
    _function_vs_plain(lambda *a: wkv6(*a, 64),
                       lambda *a: wkv6_chunked(*a, 64), ins, gen, launches=1,
                       tols=[(1e-2, KERNEL_RTOL),
                             (WKV_STATE_TOL, WKV_STATE_TOL)])


def test_training_refuses_what_the_kernels_refuse(cuda):
    """A CUDA tensor the kernel does not take raises in training as in
    serving: no plain fallback."""
    x = torch.zeros(2, 8, device=cuda, requires_grad=True)
    with pytest.raises(ValueError):        # fp32 x
        rmsnorm(x, torch.ones(8, device=cuda, requires_grad=True))
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    with pytest.raises(ValueError):        # head_dim 16
        flash_attention(q, q, q)
    r = torch.zeros(1, 4, 2, 8, device=cuda, requires_grad=True)
    with pytest.raises(ValueError):        # head_dim 8
        wkv6(r, r, r, r, torch.zeros(2, 8, device=cuda), 64)


@pytest.mark.parametrize("family", ["dense", "rwkv", "moe", "audio"])
@pytest.mark.parametrize("remat", [True, False])
def test_train_path_launches_the_kernels_and_matches_the_cpu(cuda, family,
                                                             remat):
    """Loss and grads of a 2-layer model on the card: each forward kernel
    launches once per use, twice with remat (forward and recompute); the
    loss against the CPU at the bf16 atol = rtol = 4e-2. The MoE model is
    qwen3-vl-30b-a3b's layout at a narrow width (rep 8, no shared experts),
    trained on a frame-embedding prefix; the audio model is
    musicgen-medium's, on 4 codebooks after a conditioning prefix."""
    batch = {}
    if family == "dense":
        cfg = ModelConfig(name="gpu-smoke", family="dense", num_layers=2,
                          d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                          vocab_size=512)  # head_dim 64
        per_layer = {"rmsnorm": 2, "flash_attention": 1}
    elif family == "moe":
        cfg = _QWEN3_VL_NARROW
        per_layer = {"rmsnorm": 2, "flash_attention": 1}
        batch["frontend_embeds"] = 0.5 * torch.randn(
            (2, 8, cfg.d_model), generator=torch.Generator().manual_seed(0))
    elif family == "audio":
        cfg = _MUSICGEN_NARROW
        per_layer = {"rmsnorm": 2, "flash_attention": 1}
        batch = _audio_batch(cfg, n=24)
    else:
        cfg = RWKV_SMOKE
        per_layer = {"rmsnorm": 3, "wkv6": 1}
    cfg = cfg.replace(remat=remat)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    if family != "audio":
        batch["tokens"] = torch.arange(2 * 24).reshape(2, 24) * 7 % cfg.vocab_size
    out = {}
    for dev in ("cpu", "cuda"):
        kcommon.reset_launches()
        loss, _, grads = loss_and_grads(
            cfg, tree_map(lambda t: t.to(dev), params),
            {k: v.to(dev) for k, v in batch.items()})
        assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        out[dev] = (loss, dict(kcommon.launches))
    times = 2 if remat else 1
    want = {name: 0 for name in kcommon.KERNELS}
    for name, n in per_layer.items():
        want[name] = times * n * cfg.num_layers
    want["rmsnorm"] += 1  # the final norm, outside the layers
    assert out["cpu"][1] == {name: 0 for name in kcommon.KERNELS}
    assert out["cuda"][1] == want
    _assert_close(out["cuda"][0].cpu(), out["cpu"][0])


def test_train_step_device_spans_on_the_card(cuda):
    """Two remat train steps of qwen3-vl-30b-a3b's layout at a narrow width
    under the enabled tracer: every phase and MoE span has device time, the
    phases sum to no more than the step's, and each MoE span of the
    recompute, opened on the autograd engine's own thread, hangs under the
    trainer's ``train.backward`` inside its interval."""
    from repro_torch.obs.tracer import TRACER, disable_tracing, enable_tracing
    from repro_torch.train import (OptimizerConfig, StepConfig,
                                   init_opt_state, make_train_step)
    cfg = _QWEN3_VL_NARROW.replace(remat=True)
    params = init_params(param_specs(cfg), seed=0, device="cuda")
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptimizerConfig(), StepConfig(frontend_prefix=8))
    batch = {"tokens": (torch.arange(2 * 24, device=cuda).reshape(2, 24) * 7
                        % cfg.vocab_size).int(),
             "frontend_embeds": 0.5 * torch.randn((2, 8, cfg.d_model),
                                                  device=cuda)}
    step(params, opt, batch)                       # warm up
    TRACER.clear()
    enable_tracing()
    try:
        for _ in range(2):
            params, opt, _m = step(params, opt, batch)
    finally:
        disable_tracing()
    spans = TRACER.spans()
    TRACER.clear()
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "train.step"]
    assert len(steps) == 2
    for s in spans:
        assert s.device_s is not None and s.device_s > 0, s
    for st in steps:
        kids = [s for s in spans if s.parent == st.id]
        assert sorted(s.name for s in kids) == \
            ["train.backward", "train.forward", "train.optimizer"]
        assert sum(s.device_s for s in kids) <= st.device_s * 1.001
    dispatch = [s for s in spans if s.name == "moe.dispatch"]
    assert len(dispatch) == 2 * 2 * cfg.num_layers   # forward + recompute
    recompute = [s for s in dispatch if by_id[s.parent].name == "train.backward"]
    assert len(recompute) == 2 * cfg.num_layers
    for s in recompute:
        bwd = by_id[s.parent]
        assert s.tid != bwd.tid       # the engine's device thread
        assert bwd.t0 <= s.t0 and s.t0 + s.dur <= bwd.t0 + bwd.dur
    T = 2 * (24 + 8)
    for s in dispatch:
        assert s.args["choices"] == T * cfg.moe_top_k
        assert 0 < s.args["kept"] <= s.args["choices"]
        assert [x.name for x in spans if x.parent == s.id] == ["moe.experts"]


def _syncing_step(params, opt_state, batch):
    """One explicit host sync (``.item()``) before the loop's loss read."""
    total = batch["tokens"].long().sum()
    if total.item() < 0:
        raise AssertionError("token ids are never negative")
    return params, opt_state, {"loss": total % 1000003}


def test_fused_loop_counts_the_host_syncs_of_a_step(cuda):
    """With the tracer on, each ``pipeline.compute`` span carries
    ``host_syncs``: the step's ``.item()`` and the loop's loss read; the
    sync debug mode is back where it was after."""
    from repro_torch.obs.tracer import TRACER, disable_tracing, enable_tracing
    from repro_torch.train.pipeline import FusedTrainLoop
    mode = torch.cuda.get_sync_debug_mode()
    TRACER.clear()
    with FusedTrainLoop(_InstantSource((4, 256)), _syncing_step,
                        {"w": torch.zeros(4, device=cuda)}, {}, depth=2,
                        timeout_s=30.0) as loop:
        loop.run(2)
        enable_tracing()
        try:
            loop.run(3)
        finally:
            disable_tracing()
    counts = [s.args["host_syncs"] for s in TRACER.spans()
              if s.name == "pipeline.compute"]
    TRACER.clear()
    assert counts == [2, 2, 2]
    assert torch.cuda.get_sync_debug_mode() == mode


# ---------------------------------------------------------------------------
# The fused loop's staging on the card
# ---------------------------------------------------------------------------

class _InstantSource:
    """A token-grid source whose fetch is instant and whose every grid
    differs (no cursor: the loop keeps what it staged)."""

    topology = None

    def __init__(self, shape=(16, 2048)):
        self.shape = shape
        self.n = 0
        self.grids = []

    def next_tokens(self, timeout_s=None):
        g = ((np.arange(self.shape[0] * self.shape[1], dtype=np.int64)
              * (self.n + 3) + self.n) % 49152).astype(np.int32)
        self.n += 1
        return g.reshape(self.shape)

    def cursors(self):
        return None

    def restore(self, cursors):
        raise AssertionError("not restorable")

    def start_prefetch(self):
        pass

    def stop_prefetch(self):
        pass


def _checksum_step(params, opt_state, batch):
    """Sleeps on the trainer's stream, then reduces the device tokens: a
    copy still in flight, or a block handed back to the side stream too
    early, shows as a wrong checksum."""
    tokens = batch["tokens"]
    assert tokens.dtype == torch.int32 and tokens.is_cuda
    torch.cuda._sleep(2_000_000)
    w = torch.arange(1, tokens.shape[1] + 1, device=tokens.device)
    return params, opt_state, {"loss": (tokens.long() * w).sum() % 1000003}


@pytest.mark.parametrize("depth", [0, 2, 4])
def test_fused_loop_device_tokens_equal_host_grids(cuda, depth):
    """40 steps through the staging ring (depth 0: the synchronous path):
    every step's checksum of its device tokens equals its host grid's."""
    from repro_torch.train.pipeline import FusedTrainLoop
    params = {"w": torch.zeros(4, device=cuda)}
    host = []
    with FusedTrainLoop(_InstantSource(), _checksum_step, params, {},
                        depth=depth, timeout_s=30.0) as loop:
        rep = loop.run(40, on_batch=lambda s, t: host.append(t.copy()))
    w = np.arange(1, host[0].shape[1] + 1, dtype=np.int64)
    want = [float((g.astype(np.int64) * w).sum() % 1000003) for g in host]
    assert rep.losses == want
    assert len(set(want)) == 40
    if depth:
        assert all(t.h2d_s == 0.0 for t in rep.timings)


def test_fused_loop_refuses_params_off_its_device(cuda):
    from repro_torch.train.pipeline import FusedTrainLoop
    with pytest.raises(ValueError, match="parameter lies on cpu"):
        FusedTrainLoop(_InstantSource(), _checksum_step,
                       {"w": torch.zeros(4)}, {}, depth=2)


def test_checkpoint_of_cuda_tensors_restores_bit_identically(cuda):
    """A state of CUDA tensors (fp32, bf16, 0-d int32) through a
    MemoryObjectStore restores bit for bit onto its template leaves'
    devices: the card for tensor leaves, the host for a CPU leaf."""
    from repro_torch.core import MemoryObjectStore, Namespace
    from repro_torch.train.checkpoint import (load_model_state,
                                              upload_model_state)

    gen = torch.Generator(device=cuda).manual_seed(0)
    state = {"params": {"w": torch.randn(257, 64, generator=gen,
                                         device=cuda),
                        "b": _randn(gen, (3, 4096), torch.bfloat16, cuda)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32,
                                          device=cuda)}}
    ns = Namespace(MemoryObjectStore(), "runs/gpu_ckpt")
    key = upload_model_state(ns, 7, state)
    template = {"params": {"w": torch.zeros(1, device=cuda),
                           "b": torch.zeros(1)},
                "opt": {"step": torch.zeros(1, device=cuda)}}
    got, doc = load_model_state(ns, key, template)
    assert [(e["path"], e["dtype"]) for e in doc["leaves"]] == [
        ("opt/step", "int32"), ("params/b", "bfloat16"),
        ("params/w", "float32")]
    for (a, b, dev) in ((got["params"]["w"], state["params"]["w"], "cuda"),
                        (got["params"]["b"], state["params"]["b"], "cpu"),
                        (got["opt"]["step"], state["opt"]["step"], "cuda")):
        assert a.device.type == dev
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        int_dt = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                  torch.int32: torch.int32}[b.dtype]
        assert torch.equal(a.cpu().view(int_dt), b.cpu().view(int_dt))


# ---------------------------------------------------------------------------
# The fused loop over the baselines and a resilient tgb session, on the card
# ---------------------------------------------------------------------------

def _baseline_topology():
    from repro_torch.dataplane import Topology
    return Topology(dp=2, cp=2, global_batch=8, seq_len=1024)


def _stream_of(topo, n_batches):
    n = n_batches * topo.global_batch * topo.seq_len
    return ((np.arange(n) * 7 + 3) % 49152).astype(np.int32)


def _checksums(host):
    w = np.arange(1, host[0].shape[1] + 1, dtype=np.int64)
    return [float((g.astype(np.int64) * w).sum() % 1000003) for g in host]


@pytest.mark.parametrize("backend", ["mq", "colocated"])
def test_fused_loop_over_a_baseline_puts_the_hosts_tokens_on_the_card(cuda,
                                                                      backend):
    """Depth 2 over the mq broker (one reader per (d, c)) and over the
    colocated pool (``PackingTokenSource``): each step's checksum of its
    device tokens equals its host grid's, and the host grids are the
    packer's (mq) or the packer's over the delivered indices (colocated)."""
    from repro_torch.data import ColocatedConfig, KafkaSimBroker
    from repro_torch.data.packing import GlobalBatchPacker, assemble_grid
    from repro_torch.dataplane import open_dataplane
    from repro_torch.train.pipeline import (FusedTrainLoop, PackingTokenSource,
                                            ReaderFanInSource)
    topo = _baseline_topology()

    def packed(tokens):
        packer = GlobalBatchPacker(topo.global_batch, topo.seq_len, topo.dp,
                                   topo.cp)
        return [assemble_grid(b.slices, topo.global_batch, topo.seq_len,
                              topo.dp, topo.cp)
                for b in packer.add_tokens(tokens)]

    writer, pulled = None, []
    if backend == "mq":
        sess = open_dataplane(KafkaSimBroker(), topo, backend="mq")
        with sess.writer("w0") as w:
            w.write_tokens(_stream_of(topo, 12))
        src = ReaderFanInSource([sess.reader(dp_rank=d, cp_rank=c)
                                 for d in range(2) for c in range(2)], topo)
    else:
        sess = open_dataplane(None, topo, backend="colocated",
                              config=ColocatedConfig(),
                              preprocess_cost_s=lambda i: 0.0002,
                              batch_cpu_items=topo.global_batch)
        reader = sess.reader()

        def slices_of(indices):
            offs = indices.astype(np.int64)[:, None] * topo.seq_len \
                + np.arange(topo.seq_len)[None, :]
            return ((offs.ravel() * 7 + 3) % 49152).astype(np.int32)

        def pull(timeout_s):
            ix = np.frombuffer(reader.next_batch(timeout_s=timeout_s).payload,
                               dtype=np.int32)
            pulled.append(ix.copy())
            return slices_of(ix)

        writer = sess.writer().__enter__()
        src = PackingTokenSource(pull, topo)
    host = []
    try:
        with FusedTrainLoop(src, _checksum_step, {"w": torch.zeros(
                4, device=cuda)}, {}, topology=topo, depth=2,
                timeout_s=30.0) as loop:
            rep = loop.run(10, on_batch=lambda s, t: host.append(t.copy()))
    finally:
        if writer is not None:
            writer.__exit__(None, None, None)
        sess.close()
    assert rep.losses == _checksums(host)
    if backend == "mq":
        want = packed(_stream_of(topo, 12))[:10]
    else:
        want = [packed(slices_of(ix))[0] for ix in pulled[:10]]
    assert all(np.array_equal(a, b) for a, b in zip(host, want))


def test_resilient_tgb_session_rides_out_a_throttle_with_the_same_grids(cuda):
    """A resilient tgb session behind a scripted SlowDown storm delivers the
    grids of a fault-free session to the card, and the storm bit."""
    from repro_torch.core import (BrownoutPhase, FaultPolicy,
                                  FaultyObjectStore, MemoryObjectStore,
                                  ResilienceConfig)
    from repro_torch.dataplane import open_dataplane
    from repro_torch.train.pipeline import FusedTrainLoop, ReaderFanInSource
    topo = _baseline_topology()

    def run(store, **opts):
        sess = open_dataplane(store, topo, namespace="runs/gpu", **opts)
        with sess.writer("w0") as w:
            w.write_tokens(_stream_of(topo, 12))
        if isinstance(store, FaultyObjectStore):
            store.script_brownout([BrownoutPhase(
                0.0, 0.5, target_rate=40.0, retry_after_s=0.05)])
        src = ReaderFanInSource([sess.reader(dp_rank=d, cp_rank=c)
                                 for d in range(2) for c in range(2)], topo)
        host = []
        with FusedTrainLoop(src, _checksum_step, {"w": torch.zeros(
                4, device=cuda)}, {}, topology=topo, depth=2,
                timeout_s=30.0) as loop:
            rep = loop.run(10, on_batch=lambda s, t: host.append(t.copy()))
        throttled = getattr(sess.store, "resilience", None)
        sess.close()
        assert rep.losses == _checksums(host)
        return host, throttled.throttled if throttled is not None else 0

    clean, _ = run(MemoryObjectStore())
    faulty = FaultyObjectStore(MemoryObjectStore(), FaultPolicy(seed=0))
    stormy, throttled = run(faulty, resilience=ResilienceConfig(seed=0))
    assert throttled > 0
    assert all(np.array_equal(a, b) for a, b in zip(clean, stormy))
    assert len(clean) == len(stormy) == 10


def test_fused_loop_over_a_mix_puts_the_hosts_tokens_on_the_card(cuda):
    """Depth 2 over a weighted mix of a raw stream, a 2-shard stream and a
    stream derived from the raw one (``MixedReader`` per (d, c)): each step's
    host grid is the grid the schedule names (the packer's, or the host's
    own derivation), and its checksum of the device tokens equals the host
    grid's. CP is 1: the derive worker decodes a source TGB as its DP slices
    joined, which is the row-major grid only when each slice holds whole
    rows (as in the reference)."""
    from repro_torch.core import MemoryObjectStore, open_manifest_store
    from repro_torch.data.packing import GlobalBatchPacker, assemble_grid
    from repro_torch.dataplane import Topology, open_dataplane
    from repro_torch.graph import FilterOp, OpGraph, PackOp
    from repro_torch.streams import MixPlan
    from repro_torch.train.pipeline import FusedTrainLoop, ReaderFanInSource
    topo = Topology(dp=2, cp=1, global_batch=8, seq_len=1024)
    gb, sl = topo.global_batch, topo.seq_len
    weights, steps = {"web": 0.5, "code": 0.3, "filtered": 0.2}, 10
    need = MixPlan(weights, seed=11).stream_counts(steps)

    def packed(tokens):
        packer = GlobalBatchPacker(gb, sl, topo.dp, topo.cp)
        return [assemble_grid(b.slices, gb, sl, topo.dp, topo.cp)
                for b in packer.add_tokens(tokens)]

    store = MemoryObjectStore()
    sess = open_dataplane(store, topo, namespace="runs/gpu-mix",
                          streams=weights, mix_seed=11)
    open_manifest_store(sess.streams["code"].ns, shards=2)
    rng = np.random.default_rng(0)
    n_web = need["web"] + 2 * need["filtered"] + 2
    tokens = {"web": rng.integers(0, 49152, n_web * gb * sl).astype(np.int32),
              "code": _stream_of(topo, need["code"])}
    for name, toks in tokens.items():
        with sess.writer("w0", stream=name) as w:
            w.write_tokens(toks)
    graph = OpGraph("even-first")
    graph.add(FilterOp("even", lambda rows: rows[:, 0] % 2 == 0),
              source="web", output="rows")
    graph.add(PackOp("pack", global_batch=gb, seq_len=sl, dp=topo.dp,
                     cp=topo.cp), source="rows", output="filtered")
    sess.derive_worker(graph, window_steps=2).run(max_source_steps=n_web,
                                                  timeout_s=5)
    # the host's own derivation: each window's even-first rows, packed and
    # its remainder zero-padded
    web_grids = [g.reshape(gb, sl) for g in tokens["web"].reshape(n_web, -1)]
    derived = []
    for w0 in range(0, n_web, 2):
        rows = np.concatenate([g[g[:, 0] % 2 == 0]
                               for g in web_grids[w0:w0 + 2]])
        pad = (-len(rows)) % gb
        rows = np.concatenate([rows, np.zeros((pad, sl), np.int32)])
        derived += packed(rows.ravel())
    host_of = {"web": packed(tokens["web"]), "code": packed(tokens["code"]),
               "filtered": derived}
    want = [host_of[name][k] for name, k in sess.plan.schedule(steps)]
    src = ReaderFanInSource([sess.reader(dp_rank=d) for d in range(2)], topo)
    host = []
    with FusedTrainLoop(src, _checksum_step, {"w": torch.zeros(
            4, device=cuda)}, {}, topology=topo, depth=2,
            timeout_s=30.0) as loop:
        rep = loop.run(steps, on_batch=lambda s, t: host.append(t.copy()))
    sess.close()
    assert rep.losses == _checksums(host)
    assert all(np.array_equal(a, b) for a, b in zip(host, want))
    assert len(host) == steps


# ---------------------------------------------------------------------------
# The kernel forwards as torch.library operators
# ---------------------------------------------------------------------------

def _op_cases(gen, cuda):
    """(operator, its arguments, expected FLOPs) at a granite-8b decode
    step's and prefill's shapes and rwkv6-3b's prefill's."""
    x = _randn(gen, (8, 4096), torch.bfloat16, cuda)
    w = _randn(gen, (4096,), torch.float32, cuda)
    q = _randn(gen, (2, 256, 32, 128), torch.bfloat16, cuda)
    k = _randn(gen, (2, 256, 8, 128), torch.bfloat16, cuda)
    qd = _randn(gen, (8, 32, 128), torch.bfloat16, cuda)
    kc = _randn(gen, (8, 1032, 8, 128), torch.bfloat16, cuda)
    r, kk, v, wd, u = _wkv_inputs(gen, 2, 128, 40, 64, torch.bfloat16, cuda)
    ops = torch.ops.repro_torch
    return [
        ("rmsnorm", ops.rmsnorm_fwd.default, (x, w, 1e-5), 0),
        ("flash_attention", ops.flash_attention_fwd.default, (q, k, k, True),
         4 * 2 * 32 * 256 * 256 * 128),
        ("decode_attention", ops.decode_attention.default, (qd, kc, kc, 1015),
         4 * 8 * 32 * 1032 * 128),
        ("decode_attention", ops.decode_attention_partial.default,
         (qd, kc[:, :500].contiguous(), kc[:, :500].contiguous(), 300),
         4 * 8 * 32 * 500 * 128),
        ("rmsnorm", ops.rmsnorm_fwd.default,
         (x, w, 1e-5, x.float().pow(2).mean(-1)), 0),
        ("wkv6", ops.wkv6_fwd.default, (r, kk, v, wd, u, 64),
         4 * 2 * 128 * 40 * 64 * 64),
    ]


def test_each_operator_launches_its_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    for name, op, args, _flops in _op_cases(gen, cuda):
        kcommon.reset_launches()
        op(*args)
        torch.cuda.synchronize()
        assert kcommon.launches == {k: int(k == name) for k in kcommon.KERNELS}


def test_each_operators_fake_and_flops_agree_with_its_launch(cuda):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    gen = torch.Generator(device=cuda).manual_seed(8)
    for name, op, args, flops in _op_cases(gen, cuda):
        with FlopCounterMode(display=False) as fc:
            real = op(*args)
        assert fc.get_total_flops() == flops, name
        with FakeTensorMode() as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                        else a for a in args))
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        assert [(t.shape, t.dtype, t.device) for t in fake] == \
            [(t.shape, t.dtype, t.device) for t in real], name
