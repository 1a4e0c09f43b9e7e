"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX Pallas kernels in interpret mode and the JAX ``ref.py``
oracles, on the sweep shapes of tests/test_kernels.py, plus ragged shapes the
Pallas kernels cannot take (held against the JAX refs only).

Tolerances as in tests/test_kernels.py: fp32 2e-5, bf16 4e-2 (atol = rtol).
Inputs are drawn once with numpy and handed to both packages.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages imported up front)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.decode_attention import decode_attention_fwd  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_fwd  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rms_ref  # noqa: E402
from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.kernels.adamw import ops as adamw_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    MAX_CLUSTER, TILE, decode_attention, decode_plan)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    BLOCK_Q, flash_attention, l2_section, work_item)
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(atol=4e-2, rtol=4e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a CPU tensor (fp32 -> dtype rounds
    identically in both)."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,G,dh,causal", [
    (2, 128, 4, 2, 64, True),
    (1, 256, 8, 8, 32, True),
    (2, 64, 4, 1, 128, True),
    (1, 128, 6, 3, 64, False),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_plain_matches_pallas_and_ref(B, S, H, G, dh, causal,
                                                      dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (B, S, H, dh), dtype)
    jk, tk = _pair(rng, (B, S, G, dh), dtype)
    jv, tv = _pair(rng, (B, S, G, dh), dtype)
    out = flash_attention(tq, tk, tv, causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    pallas = flash_attention_fwd(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64, interpret=True)
    ref = jax_flash_ref(jq, jk, jv, causal=causal)
    assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("B,S,T,H,G,dh,causal", [
    (2, 45, 45, 4, 2, 16, True),     # S, T divide no tile
    (1, 45, 100, 6, 3, 32, False),   # S != T, full attention
    (1, 1, 1, 2, 1, 8, True),        # one token
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_ragged_matches_ref(B, S, T, H, G, dh, causal, dtype):
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng, (B, S, H, dh), dtype)
    jk, tk = _pair(rng, (B, T, G, dh), dtype)
    jv, tv = _pair(rng, (B, T, G, dh), dtype)
    out = flash_attention(tq, tk, tv, causal)
    ref = jax_flash_ref(jq, jk, jv, causal=causal)
    assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("B,H,G,dh,T,cur", [
    (2, 8, 2, 64, 256, 0),
    (2, 8, 2, 64, 256, 100),
    (1, 4, 4, 128, 512, 511),
    (3, 6, 3, 32, 128, 64),
    (2, 16, 1, 64, 256, 200),    # rep 16 (llama3-405b, qwen3-moe-235b-a22b)
    (1, 32, 2, 128, 256, 255),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_plain_matches_pallas_and_ref(B, H, G, dh, T, cur,
                                                       dtype):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (B, H, dh), dtype)
    jk, tk = _pair(rng, (B, T, G, dh), dtype)
    jv, tv = _pair(rng, (B, T, G, dh), dtype)
    out = decode_attention(tq, tk, tv, cur)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    pallas = decode_attention_fwd(jq, jk, jv, cur, block_k=64, interpret=True)
    ref = jax_decode_ref(jq, jk, jv, cur)
    assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("B,H,G,dh,T,cur", [
    (2, 8, 2, 64, 100, 99),    # cur_index at the ragged tail
    (3, 6, 3, 32, 100, 57),
    (1, 8, 1, 16, 5, 4),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_ragged_matches_ref(B, H, G, dh, T, cur, dtype):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (B, H, dh), dtype)
    jk, tk = _pair(rng, (B, T, G, dh), dtype)
    jv, tv = _pair(rng, (B, T, G, dh), dtype)
    out = decode_attention(tq, tk, tv, cur)
    ref = jax_decode_ref(jq, jk, jv, cur)
    assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 256), (2, 37, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, shape, dtype)
    jw, tw = _pair(rng, (shape[-1],), "float32")
    out = rmsnorm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    pallas = rmsnorm_fwd(jx, jw, interpret=True)
    ref = jax_rms_ref(jx, jw)
    assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    assert_allclose(_np(out), _np(ref), **_tol(dtype))


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(5)
    kcommon.reset_launches()
    _, x = _pair(rng, (3, 64), "bfloat16")
    _, w = _pair(rng, (64,), "float32")
    _, q = _pair(rng, (1, 9, 4, 16), "bfloat16")
    _, k = _pair(rng, (1, 9, 2, 16), "bfloat16")
    rmsnorm(x, w)
    flash_attention(q, k, k, True)
    decode_attention(q[:, 0], k, k, 8)
    assert kcommon.launches == {name: 0 for name in kcommon.LAUNCHES}


@pytest.mark.parametrize("device", ["meta"])
def test_wrappers_refuse_devices_other_than_cpu_or_cuda(device):
    x = torch.zeros(2, 64, device=device)
    w = torch.ones(64, device=device)
    with pytest.raises(ValueError):
        rmsnorm(x, w)
    with pytest.raises(ValueError):  # a mix of devices is refused too
        rmsnorm(torch.zeros(2, 64), w)


@pytest.mark.parametrize("name", kcommon.KERNELS)
def test_each_kernel_source_exports_its_launcher(name):
    """Each wrapper binds ``<name>_fwd`` from ``csrc/<name>.cu``; the build
    output is keyed by a hash of that source and the nvcc flags."""
    src = (kcommon.CSRC_DIR / f"{name}.cu").read_text()
    assert re.search(rf'extern "C" int {name}_fwd\(', src)
    assert "sm_90a" in " ".join(kcommon.NVCC_FLAGS)
    path = kcommon.library_path(name)
    assert path.parent == kcommon.BUILD_DIR
    assert re.fullmatch(rf"{name}-[0-9a-f]{{16}}\.so", path.name)


def test_decode_plan_constants_match_the_kernel_source():
    src = (kcommon.CSRC_DIR / "decode_attention.cu").read_text()
    assert re.search(rf"constexpr int kTile = {TILE};", src)
    assert re.search(rf"constexpr int kMaxCluster = {MAX_CLUSTER};", src)


@pytest.mark.parametrize("n_valid", [1, TILE - 1, TILE, TILE + 1, 8 * TILE,
                                     8 * TILE + 1, 1016, 8192])
def test_decode_plan_gives_every_cta_of_a_cluster_a_tile(n_valid):
    """The tiles cover exactly the valid positions, and the kernel's split
    (CTA r of ``cluster`` takes tiles [r n / cluster, (r + 1) n / cluster))
    leaves no CTA without a tile: none is launched past ``cur_index``."""
    n_tiles, cluster = decode_plan(n_valid)
    assert (n_tiles - 1) * TILE < n_valid <= n_tiles * TILE
    assert 1 <= cluster <= min(MAX_CLUSTER, n_tiles)
    spans = [(r * n_tiles // cluster, (r + 1) * n_tiles // cluster)
             for r in range(cluster)]
    assert spans[0][0] == 0 and spans[-1][1] == n_tiles
    assert all(end > start for start, end in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_k1_block_q_matches_the_kernel_source():
    src = (kcommon.CSRC_DIR / "flash_attention.cu").read_text()
    assert re.search(rf"constexpr int kBlockQ = {BLOCK_Q};", src)


H100_L2 = 50 * 2**20


@pytest.mark.parametrize("B,S,H,G,dh,l2", [
    (8, 1000, 16, 16, 128, H100_L2),   # deepseek-moe-16b: 128 pairs, 43 a section
    (8, 1000, 32, 32, 112, H100_L2),   # zamba2-7b: 256 pairs, 52 a section
    (8, 1000, 128, 8, 128, H100_L2),   # llama3-405b, rep 16: 2 sections of 32
    (2, 3000, 20, 20, 128, H100_L2),   # a partial last section: 14, 14, 12
    (3, 130, 6, 2, 64, 4 * 130 * 64 * 2 * 2),  # 2 pairs a section, 3 sections
    (1, 45, 4, 4, 128, H100_L2),       # B G below one section, one q tile
    (2, 257, 8, 4, 112, 4 * 257 * 112 * 3 * 2),  # S = 2 tiles + 1 row, sections of 3, 3, 2
])
def test_k1_work_order_is_a_bijection_heaviest_first_within_a_section(
        B, S, H, G, dh, l2):
    """``work_item`` (the kernel's ``item_of``) maps the items onto every
    (q tile, head, batch) once; a section holds at most the pairs whose K
    and V fit half the L2, and runs its q tiles heaviest first, its pairs
    next and the rep query heads of a kv head innermost."""
    rep, n_qt = H // G, -(-S // BLOCK_Q)
    sec = l2_section(B, G, S, dh, l2)
    assert 1 <= sec <= B * G
    assert sec == 1 or sec * 4 * S * dh <= l2 // 2
    n_sec = -(-B * G // sec)
    assert (n_sec - 1) * sec < B * G  # sections even: none is empty
    items = [work_item(i, B, S, H, G, sec) for i in range(n_qt * H * B)]
    assert sorted(items) == sorted((qt * BLOCK_Q, h, b) for qt in range(n_qt)
                                   for h in range(H) for b in range(B))
    i = 0
    for first in range(0, B * G, sec):
        pairs = min(sec, B * G - first)
        block = items[i:i + pairs * rep * n_qt]
        i += len(block)
        # the section's own pairs only
        assert {b * G + h // rep for _, h, b in block} == set(range(first, first + pairs))
        q0s = [q0 for q0, _, _ in block]
        assert q0s == sorted(q0s, reverse=True)  # heaviest q tile first
        for j in range(0, len(block), rep):  # a kv head's rep heads together
            group = block[j:j + rep]
            assert len({(q0, h // rep, b) for q0, h, b in group}) == 1
            assert [h % rep for _, h, _ in group] == list(range(rep))
    assert i == len(items)


def test_adamw_plan_constants_match_the_kernel_source():
    src = (kcommon.CSRC_DIR / "adamw.cu").read_text()
    assert re.search(rf"constexpr int kMaxLeaves = {adamw_ops.MAX_LEAVES};", src)
    assert adamw_ops.CHUNK == 1 << 16
    assert re.search(r"constexpr int64_t kChunk = 1 << 16;", src)
    assert re.search(rf"constexpr int kVec = {adamw_ops.VEC};", src)
    assert re.search(rf"constexpr int kDecay = {adamw_ops.DECAY}, "
                     rf"kAligned = {adamw_ops.ALIGNED};", src)
    for fn in ("adamw_sumsq", "adamw_scale", "adamw_fwd"):
        assert re.search(rf'extern "C" int {fn}\(', src)


CHUNK = adamw_ops.CHUNK


@pytest.mark.parametrize("numels", [
    [0],                                        # an empty leaf: no launch
    [1, 3, 5],                                  # tiny, no vector
    [CHUNK - 1, CHUNK, CHUNK + 1, 0, 4096],     # around a chunk, an empty one
    [2**31 + 5, 7, 2**31 - 1],                  # over and under 2^31 elements
    [(i * 7919) % (3 * CHUNK) for i in range(101)],  # 3 launches of <= 48
    [0] * 60 + [9] * 48,                        # empties don't take slots
])
def test_adamw_chunk_plan_covers_every_element_once(numels):
    """``chunk_plan``'s launches hold every non-empty leaf once, in order,
    at most ``MAX_LEAVES`` a launch; the kernel's walk (``chunk_span`` of
    every chunk, taken by block ``c % grid``) covers each leaf's elements
    ``[0, n)`` exactly once, in chunks of at most ``CHUNK``."""
    plan = adamw_ops.chunk_plan(numels)
    assert [i for slots, _ in plan for i in slots] == \
        [i for i, n in enumerate(numels) if n > 0]
    grid = 4 * 132
    for slots, first in plan:
        assert 1 <= len(slots) <= adamw_ops.MAX_LEAVES
        assert len(first) == len(slots) + 1 and first[0] == 0
        n = [numels[i] for i in slots]
        covered = [0] * len(slots)
        by_block = [[] for _ in range(grid)]
        for c in range(first[-1]):
            by_block[c % grid].append(c)
        for chunks in by_block:
            assert chunks == sorted(chunks)     # a block walks them upwards
        for c in range(first[-1]):
            slot, start, stop = adamw_ops.chunk_span(first, n, c)
            assert start == covered[slot] and 0 < stop - start <= CHUNK
            covered[slot] = stop
        assert covered == n
    assert adamw_ops.launch_count([numels]) == 2 * len(plan) + 1
