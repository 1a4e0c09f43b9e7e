"""Decode over a position-sharded cache as the reference's flash-decode, and
the two other layouts the reference's program keeps without a gather.

- K3 at rep 16 is a case of ``tests/test_torch_kernels.py``; here, K3's
  partial form (``decode_attention_partial``, plain version on the CPU):
  the cache cut into 1-4 position pieces (an empty one, and one past
  ``cur_index``), combined by ``combine_partials``, against the port's
  whole-cache decode and JAX ``repro.models.common.decode_attention``
  (fp32 2e-5, bf16 4e-2, as tests/test_kernels.py);
- K2 with a given per-row mean square against K2 without it;
- on the fake (2, 2) mesh of tests/test_torch_dryrun.py, the dry run's
  decode cell at cache lengths T and 2T moves the same collective bytes,
  and no all-gather carries the cache (``sharding/dtensor.flash_decode``);
  a GQA K/V projection whose KV heads "model" does not divide gathers
  nothing (``whole_heads_product``); K2 on rows sharded by "mlp"
  all-reduces one fp32 value a row and gathers no row
  (``rms_norm_sharded_rows``);
- the smoke llama3-405b and qwen3-moe-235b-a22b decode over DTensors on a
  real 1x1 ``gloo`` mesh, and on a two-rank ``gloo`` group in subprocesses
  (the cache's positions split in two, one piece empty at the first
  step), equal the plain decode; so do the sharded norm and K/V projection.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.models.common import decode_attention as jax_decode  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.kernels.common import register_shardings  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_attention_partial)
from repro_torch.kernels.decode_attention.ref import \
    combine_partials  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_fwd  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402

register_shardings()
ROOT = Path(__file__).resolve().parents[1]


def _tol(dtype):
    return dict(atol=4e-2, rtol=4e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,H,G,dh,T,cur,cuts", [
    (2, 8, 2, 16, 64, 40, ()),              # one piece: the partial alone
    (2, 8, 2, 16, 64, 40, (20,)),           # two pieces
    (1, 16, 1, 32, 96, 50, (30, 30, 70)),   # an empty piece; one past cur
    (3, 32, 2, 16, 80, 79, (10, 45, 60)),   # rep 16, four pieces, the tail
    (2, 4, 4, 8, 40, 0, (1, 20)),           # only position 0 is valid
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_pieces_combined_equal_the_whole_decode_and_jax(
        B, H, G, dh, T, cur, cuts, dtype):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, H, dh), (B, T, G, dh), (B, T, G, dh)))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    bounds = [0, *cuts, T]
    outs, lses = [], []
    for a, b in zip(bounds, bounds[1:]):
        n_valid = min(max(cur + 1 - a, 0), b - a)
        o, lse = decode_attention_partial(tq, tk[:, a:b], tv[:, a:b], n_valid)
        assert o.dtype == tq.dtype and lse.dtype == torch.float32
        assert lse.shape == (B, H)
        if n_valid == 0:
            assert bool((o == 0).all()) and bool(torch.isinf(lse).all())
        outs.append(o)
        lses.append(lse)
    got = combine_partials(outs, lses)
    whole = decode_attention(tq, tk, tv, cur)
    jx = jax_decode(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)), cur)
    assert_allclose(got.float().numpy(), whole.float().numpy(), **_tol(dtype))
    assert_allclose(got.float().numpy(), np.asarray(jx, np.float32),
                    **_tol(dtype))


def test_partial_lse_is_the_log_sum_exp_of_the_scores():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 10, 2, 16)).astype(np.float32))
    _o, lse = decode_attention_partial(q, k, k, 7)
    s = torch.einsum("bhd,bthd->bht", q, k[:, :7].repeat_interleave(2, 2)) / 4.0
    assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_with_its_own_mean_square_equals_rmsnorm(dtype):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)
                         ).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    ms = x.float().pow(2).mean(-1)
    assert_allclose(rmsnorm_fwd(x, w, 1e-5, ms).float().numpy(),
                    rmsnorm(x, w).float().numpy(), rtol=1e-6, atol=1e-6)
    # a mean square that is not the row's own moves the output
    assert not torch.allclose(rmsnorm_fwd(x, w, 1e-5, 4 * ms), rmsnorm(x, w))


# ---------------------------------------------------------------------------
# The dispatched program on a fake mesh
# ---------------------------------------------------------------------------

class _Recording(hlo_analysis.CostMode):
    """The cost reader, also keeping each collective's (kind, output
    bytes)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = func._schema.name.split("::")[-1] if hasattr(func, "_schema") \
            else ""
        if out is not NotImplemented and not self.paused \
                and name in hlo_analysis._COLLECTIVES:
            outs = [t for t in torch.utils._pytree.tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            self.calls.append((hlo_analysis._COLLECTIVES[name],
                               sum(t.numel() * t.element_size()
                                   for t in outs)))
        return out


def _fake_mesh(shape):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=("data", "model"))


@pytest.fixture
def fake_mesh():
    import torch.distributed as dist
    yield _fake_mesh
    dist.destroy_process_group()


def _decode_cell(cfg, T, mesh):
    """The decode cell's collectives (kind, bytes) and the cache's local
    bytes a layer, one K or V."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, _meta = dryrun.build_cell(cfg, InputShape("t", T, 4, "decode"),
                                            mesh, device="cpu")
        cache = args[1]["attn_k" if cfg.family == "hybrid" else "k"]
        assert any(p.is_shard(2) for p in cache.placements)  # positions
        layer_bytes = cache.to_local()[0].numel() * cache.element_size()
        with _Recording() as mode:
            mode.ignore(hlo_analysis._locals(args, {}))
            fn(*args)
    return mode.calls, mode.costs, layer_bytes


@pytest.mark.parametrize("arch", ["llama3_405b", "granite_8b", "zamba2_7b"])
def test_decode_on_position_sharded_cache_moves_no_cache(fake_mesh, arch):
    """Every collective is the same at T and 2T: nothing that grows with
    the cache crosses a link. (The parent gathered the cache before K3 in
    every layer.)"""
    cfg = get_smoke_config(arch)
    if cfg.attn_every:   # one group of the shared block and a tail layer
        cfg = cfg.replace(attn_every=2, num_layers=3)
    mesh = fake_mesh((2, 2))
    calls1, costs1, layer1 = _decode_cell(cfg, 64, mesh)
    calls2, costs2, layer2 = _decode_cell(cfg, 128, mesh)
    assert layer2 == 2 * layer1
    # every collective, in order, of the same size: none carries the cache
    assert calls1 == calls2
    assert costs1.collective_bytes == costs2.collective_bytes
    # the combine: three all-reduces a layer (max, sum of w, sum of w·o)
    assert costs1.collective_count["all-reduce"] >= 3 * (
        cfg.num_layers if not cfg.attn_every else
        cfg.num_layers // cfg.attn_every)


def test_kv_projection_whose_heads_model_does_not_divide_gathers_nothing(
        fake_mesh):
    """KV heads 2 over "model" 4: the reference computes x @ wk whole on
    each device; the port did it sharded and gathered."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.transformer import _proj_heads
    from repro_torch.sharding.specs import make_rules, use_rules
    mesh = fake_mesh((1, 4))
    B, S, D, G, dh = 2, 8, 64, 2, 16
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = dryrun._fake_dtensor(mesh, (B, S, D), torch.float32,
                                 (Shard(0), Replicate()), "cpu")
        w = dryrun._fake_dtensor(mesh, (D, G, dh), torch.float32,
                                 (Replicate(), Replicate()), "cpu")
        with use_rules(make_rules(mesh, 8, G)), _Recording() as mode:
            mode.ignore(hlo_analysis._locals((x, w), {}))
            y = _proj_heads(x, w, kv=True)
    assert tuple(y.shape) == (B, S, G, dh)
    assert not any(kind == "all-gather" for kind, _b in mode.calls)
    assert mode.costs.flops == 2 * B * S * D * G * dh  # whole, on each device
    assert all(not p.is_shard(2) for p in y.placements)


def test_rmsnorm_on_rows_sharded_by_mlp_all_reduces_one_float_a_row(
        fake_mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.common import rms_norm
    mesh = fake_mesh((2, 2))
    B, S, D = 4, 6, 32
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = dryrun._fake_dtensor(mesh, (B, S, D), torch.bfloat16,
                                 (Shard(0), Shard(2)), "cpu")
        scale = dryrun._fake_dtensor(mesh, (D,), torch.float32,
                                     (Replicate(), Shard(0)), "cpu")
        with _Recording() as mode:
            mode.ignore(hlo_analysis._locals((x, scale), {}))
            y = rms_norm(x, scale, 1e-5)
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert mode.calls == [("all-reduce", (B // 2) * S * 4)]


def test_cost_reader_counts_dtensors_all_to_all(fake_mesh):
    """``_dtensor::shard_dim_alltoall``, DTensor's Shard(i) -> Shard(j) on a
    CUDA mesh, is an all-to-all of its output over the mesh dim's group
    (the card's dry run dispatches it; a CPU mesh gathers instead)."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = fake_mesh((2, 2))
    group = funcol._group_or_group_name(funcol._resolve_group((mesh, 1)))
    with FakeTensorMode():
        t = torch.empty(8, 6)
        with hlo_analysis.CostMode() as mode:
            out = torch.ops._dtensor.shard_dim_alltoall(t, 0, 1, group)
    assert tuple(out.shape) == (16, 3)
    assert mode.costs.collective_count == {"all-to-all": 1}
    assert mode.costs.collective_bytes == {"all-to-all": 16 * 3 * 4 * 1 / 2}


# ---------------------------------------------------------------------------
# Values on real gloo meshes
# ---------------------------------------------------------------------------

_SHARDED_DECODE = '''
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.common import register_shardings
from repro_torch.launch.dryrun import STATE_AXES
from repro_torch.models import decode_step, init_decode_state, init_params, \\
    param_specs, prefill
from repro_torch.models.common import rms_norm, tree_leaves, tree_unflatten
from repro_torch.models.transformer import _proj_heads
from repro_torch.sharding.specs import make_rules, param_shardings, use_rules

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
register_shardings()
mesh = DeviceMesh("cpu", torch.arange(world).reshape(1, world),
                  mesh_dim_names=("data", "model"))
worst = {}

def check(name, got, want, tol=1e-5):
    got = got.full_tensor() if hasattr(got, "placements") else got
    err = float((got.float() - want.float()).abs().max())
    worst[name] = err
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise SystemExit(f"rank {rank}: {name} max|err| {err}")

for arch in ("llama3_405b", "qwen3_moe_235b_a22b"):
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    B, P, T = 2, 11, 24
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32))
    with torch.no_grad():
        logits, cache = prefill(cfg, params, {"tokens": tokens},
                                cache=init_decode_state(cfg, B, T, "cpu"))
        rules = make_rules(mesh, cfg.num_heads, cfg.num_kv_heads)
        dparams = tree_unflatten(params, [
            distribute_tensor(p, mesh, pl) for p, pl in zip(
                tree_leaves(params),
                tree_leaves(param_shardings(rules, param_specs(cfg))))])
        dcache = {k: distribute_tensor(c.clone(), mesh, rules.sharding(
            STATE_AXES[k], c.shape)) for k, c in cache.items()}
        assert dcache["k"].placements[1] == Shard(2)  # positions over model
        tok = torch.argmax(logits, -1)
        for pos in (P, P + 1):   # T / world = 12: the second piece is empty first
            want, cache = decode_step(cfg, params, cache, tok, pos)
            with use_rules(rules), implicit_replication():
                got, dcache = decode_step(cfg, dparams, dcache,
                                          distribute_tensor(tok, mesh, [Replicate(), Replicate()]),
                                          pos)
            check(f"{arch} decode logits at {pos}", got, want)
            tok = torch.argmax(want, -1)

# K2 on rows sharded over "model", and a K/V projection of 3 heads
rng = np.random.default_rng(1)
x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
w = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
dx = distribute_tensor(x, mesh, [Replicate(), Shard(2)])
dw = distribute_tensor(w, mesh, [Replicate(), Shard(0)])
y = rms_norm(dx, dw, 1e-5)
assert y.placements[1] == Shard(2)
check("rms_norm on sharded rows", y, rms_norm(x, w, 1e-5))
wk = torch.from_numpy(rng.standard_normal((16, 3, 4)).astype(np.float32))
dxr = distribute_tensor(x, mesh, [Replicate(), Replicate()])
dwk = distribute_tensor(wk, mesh, [Replicate(), Replicate()])
check("K/V projection of 3 heads", _proj_heads(dxr, dwk, kv=True),
      _proj_heads(x, wk, kv=True))
if rank == 0:
    print("worst", worst)
dist.destroy_process_group()
'''


def _run_ranks(tmp_path, world, timeout):
    script = tmp_path / "sharded_decode.py"
    script.write_text(_SHARDED_DECODE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / "store")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)[-4000:]
    return outs[0]


def test_sharded_decode_on_a_1x1_gloo_mesh_equals_the_plain_decode(tmp_path):
    assert "worst" in _run_ranks(tmp_path, 1, timeout=120)


def test_sharded_decode_on_two_gloo_ranks_equals_the_plain_decode(tmp_path):
    """Two ranks: each holds half the cache's positions; the combine's
    all-reduces run for real."""
    out = _run_ranks(tmp_path, 2, timeout=120)
    assert "llama3_405b decode logits at 12" in out
