"""The dry-run half of the port's step module and MoE's ``local`` dispatch
against the JAX package, on the CPU.

- ``_local_tokens_ffn`` over each shard of E / E_loc experts equals the
  reference's shard for shard, and their sum equals the reference's sum and
  the port's ``scatter`` dispatch (fp32 1e-4, the MoE tolerance of
  ``tests/test_torch_moe.py``); ``_moe_ffn_local`` on a real (1, 1) mesh
  equals ``scatter`` in values and gradients;
- ``StepConfig(grad_accum_dtype="bfloat16")`` accumulates microbatch
  gradients in bf16 as the reference's step does: the same gradient norm
  and updated weights as JAX's step;
- ``make_prefill_step`` and ``make_decode_step`` return what the
  reference's return.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.optimizer import OptimizerConfig as JaxOptConfig  # noqa: E402
from repro.train.optimizer import init_opt_state as jax_init_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import (OptimizerConfig, StepConfig,  # noqa: E402
                               init_opt_state, make_decode_step,
                               make_prefill_step, make_train_step)

FP32 = dict(atol=1e-4, rtol=0)


def _pair(arch, seed=1, **kw):
    jcfg = jax_smoke(arch).replace(compute_dtype="float32", **kw)
    tcfg = get_smoke_config(arch).replace(compute_dtype="float32", **kw)
    jparams = jax_init_params(jax_param_specs(jcfg), seed=seed)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch,E_loc", [("deepseek_moe_16b", 2),
                                        ("qwen3_moe_235b_a22b", 4)])
def test_local_tokens_ffn_shards_sum_to_the_references_and_scatter(arch,
                                                                   E_loc):
    jcfg, tcfg, jparams, tparams = _pair(arch, num_layers=1)
    jp = {k: v[0] for k, v in jparams["layers"].items()}
    tp = {k: v[0] for k, v in tparams["layers"].items()}
    E = tcfg.moe_num_experts
    xt = np.random.default_rng(0).standard_normal(
        (24, tcfg.d_model)).astype(np.float32)
    jsum = tsum = 0
    for e0 in range(0, E, E_loc):
        sl = slice(e0, e0 + E_loc)
        jy, jaux = jax_moe._local_tokens_ffn(
            jcfg, jnp.asarray(xt), jp["router"], jp["w_gate"][sl],
            jp["w_up"][sl], jp["w_down"][sl], e0, E_loc)
        ty, taux = moe._local_tokens_ffn(
            tcfg, torch.from_numpy(xt), tp["router"], tp["w_gate"][sl],
            tp["w_up"][sl], tp["w_down"][sl], e0, E_loc)
        assert_allclose(_np(ty), _np(jy), **FP32)
        assert_allclose(float(taux), float(jaux), rtol=1e-5)
        jsum, tsum = jsum + _np(jy), tsum + _np(ty)
    assert_allclose(tsum, jsum, **FP32)
    # the routed part of the scatter dispatch, shared experts left out
    scfg = tcfg.replace(moe_dispatch="scatter", moe_num_shared=0)
    y, _aux = moe.moe_ffn(scfg, tp, torch.from_numpy(xt)[None])
    assert_allclose(tsum, _np(y[0]), **FP32)


@pytest.fixture
def mesh11(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def test_local_dispatch_on_a_1x1_mesh_equals_scatter(mesh11):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding.specs import make_rules, use_rules
    _j, tcfg, _jp, tparams = _pair("deepseek_moe_16b", num_layers=1)
    tp = {k: v[0].detach().requires_grad_() for k, v in
          tparams["layers"].items() if k in moe.moe_param_specs(tcfg, 1)}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, tcfg.d_model)).astype(np.float32)).requires_grad_()
    y, aux = moe.moe_ffn(tcfg.replace(moe_dispatch="scatter"), tp, x)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        y.shape).astype(np.float32))
    want = torch.autograd.grad((y * g).sum() + aux, [x, *tp.values()])
    rules = make_rules(mesh11, tcfg.num_heads, tcfg.num_kv_heads)
    R = (Replicate(), Replicate())
    dp = {k: distribute_tensor(v.detach(), mesh11, R).requires_grad_()
          for k, v in tp.items()}
    dx = distribute_tensor(x.detach(), mesh11, R).requires_grad_()
    with use_rules(rules), implicit_replication():
        dy, daux = moe.moe_ffn(tcfg, dp, dx)
        got = torch.autograd.grad(
            (dy * distribute_tensor(g, mesh11, R)).sum() + daux,
            [dx, *dp.values()])
    assert_allclose(dy.full_tensor().detach().numpy(), _np(y), **FP32)
    assert_allclose(float(daux.full_tensor().detach()), float(aux.detach()), rtol=1e-5)
    for a, b in zip(got, want):
        assert_allclose(a.full_tensor().numpy(), b.numpy(), rtol=1e-4,
                        atol=1e-5)


def test_bf16_grad_accumulation_step_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair("granite_8b")
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (4, 16)).astype(np.int32)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jnew, _jo, jm = jax.jit(jstep.make_train_step(
        jcfg, JaxOptConfig(**kw),
        jstep.StepConfig(microbatches=2, grad_accum_dtype="bfloat16")))(
        jparams, jax_init_opt(jparams), {"tokens": jnp.asarray(tokens)})
    step = make_train_step(tcfg, OptimizerConfig(**kw), StepConfig(
        microbatches=2, grad_accum_dtype="bfloat16"))
    tnew, _to, tm = step(tparams, init_opt_state(tparams),
                         {"tokens": torch.from_numpy(tokens)})
    assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                    rtol=1e-3)
    for got, want in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew)):
        assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-5)


def test_serving_steps_return_the_references():
    jcfg, tcfg, jparams, tparams = _pair("granite_8b")
    tokens = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jcache = jax.jit(jstep.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)})
    tl, tcache = make_prefill_step(tcfg)(tparams,
                                         {"tokens": torch.from_numpy(tokens)})
    assert_allclose(_np(tl), _np(jl), **FP32)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    # the reference decodes against its cache; the port's holds 9 positions
    cache = {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], 2)
             for k, v in tcache.items()}
    jcache = {k: jnp.concatenate([v, jnp.zeros_like(v[:, :, :1])], 2)
              for k, v in jcache.items()}
    jl2, _ = jax.jit(jstep.make_decode_step(jcfg))(
        jparams, jcache, jnp.asarray(nxt), jnp.int32(8))
    tl2, _ = make_decode_step(tcfg)(tparams, cache, torch.from_numpy(nxt), 8)
    assert_allclose(_np(tl2), _np(jl2), **FP32)
