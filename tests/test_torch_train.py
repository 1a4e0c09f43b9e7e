"""The port's training path against the JAX package, on the CPU: the backward
rules of K2, K1 and K4, AdamW, the loss and its gradients, the train step.

The same numpy inputs (and JAX-initialised weights, through
``repro_torch.convert``) go to both packages. On CPU tensors each kernel
wrapper's forward is its plain version, so these tests hold the autograd
Functions' wiring and backward rules to ``jax.vjp`` / ``jax.grad``.

Tolerances, as the reference's own tests set them: RMSNorm's backward 1e-5
(tests/test_kernels.py:92-97), attention's 1e-4 (:44-59), WKV6's 2e-4 (the
fp32 WKV6 tolerance, :116-117); the optimizer rtol 1e-6 (fp32 elementwise
arithmetic, one rounding apart at most); the model's loss rtol 1e-5 and each
gradient leaf rtol 1e-4 with atol 1e-4 of the leaf's largest element (2e-4
for RWKV6, whose decay products compound fp32 rounding over the sequence).
"""
import dataclasses

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_fa  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_fa_ref  # noqa: E402
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models.rwkv6 import wkv6_chunked as jax_wkv6_chunked  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_bwd  # noqa: E402
from repro_torch.models import init_params, param_specs  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.train import (OptimizerConfig, StepConfig,  # noqa: E402
                               adamw_update, init_opt_state, loss_and_grads,
                               lr_at, make_eval_step, make_train_step)

ARCHS = ["granite_8b", "rwkv6_3b"]
B, S = 2, 24  # as tests/test_models_smoke.py


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _grads_of(fn, *arrays):
    """Port: grads of ``fn(*tensors)`` (its first output) against a random
    cotangent; returns (cotangent, grads)."""
    ins = [_t(a).requires_grad_() for a in arrays]
    out = fn(*ins)
    out = out[0] if isinstance(out, tuple) else out
    g = np.random.default_rng(9).standard_normal(out.shape).astype(np.float32)
    out.backward(_t(g))
    return g, [t.grad for t in ins]


# ---------------------------------------------------------------------------
# Backward rules against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["ops", "ref"])
def test_rmsnorm_backward_matches_jax(which):
    """dx and dscale, with a random scale (not ones), at 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    g, (dx, dscale) = _grads_of(lambda a, b: rmsnorm(a, b, 1e-5), x, scale)
    jfn = jax_rmsnorm if which == "ops" else jax_rmsnorm_ref
    _, vjp = jax.vjp(lambda a, b: jfn(a, b, 1e-5), jnp.asarray(x),
                     jnp.asarray(scale))
    jdx, jdscale = vjp(jnp.asarray(g))
    assert dx.dtype == torch.float32 and dscale.dtype == torch.float32
    assert_allclose(_np(dx), np.asarray(jdx), atol=1e-5, rtol=1e-5)
    assert_allclose(_np(dscale), np.asarray(jdscale), atol=1e-5, rtol=1e-5)
    # the named rule gives the Function's gradients
    rdx, rdscale = rmsnorm_bwd(_t(x), _t(scale), 1e-5, _t(g))
    assert torch.equal(rdx, dx) and torch.equal(rdscale, dscale)


@pytest.mark.parametrize("which", ["ops", "ref"])
def test_flash_attention_backward_matches_jax(which):
    """The shapes of tests/test_kernels.py:44-59 (GQA rep 2, causal), loss
    sum(out^2): dq, dk, dv at 1e-4 against jax.grad through the Pallas op
    (interpret mode) and through its jnp oracle."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 64, 4, 32)).astype(np.float32)
    k = rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
    v = rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*ins, True) ** 2).sum().backward()
    jfn = jax_fa if which == "ops" else jax_fa_ref
    jg = jax.grad(lambda a, b, c: jnp.sum(jfn(a, b, c, True) ** 2),
                  argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    for t, want in zip(ins, jg):
        assert tuple(t.grad.shape) == want.shape  # dk, dv per KV head
        assert_allclose(_np(t.grad), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_flash_attention_backward_rule_is_the_functions():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 10, 4, 8), (2, 10, 1, 8), (2, 10, 1, 8)))
    g, grads = _grads_of(lambda a, b, c: flash_attention(a, b, c, False),
                         q, k, v)
    rule = flash_attention_bwd(_t(q), _t(k), _t(v), False, _t(g))
    assert all(torch.equal(a, b) for a, b in zip(rule, grads))


def _wkv_inputs(B_, S_, H, dh, seed=5):
    """As tests/test_kernels.py:100-117: r, k, v ~ 0.5 N; w = exp(-exp(0.5
    N)); u ~ 0.3 N; fp32."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B_, S_, H, dh)) for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((B_, S_, H, dh))))
    u = 0.3 * rng.standard_normal((H, dh))
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


@pytest.mark.parametrize("which", ["wkv6_ref", "wkv6_chunked"])
@pytest.mark.parametrize("B_,S_,H,dh,chunk", [
    (2, 45, 3, 16, 16),
    (1, 64, 2, 32, 32),
    (2, 17, 4, 8, 8),
])
def test_wkv6_backward_matches_jax(B_, S_, H, dh, chunk, which):
    """dr, dk, dv, dw, du at 2e-4 against jax.vjp of the per-step oracle
    (the reference's _bwd) and of the chunked form the JAX model
    differentiates."""
    ins = _wkv_inputs(B_, S_, H, dh)
    g, grads = _grads_of(lambda *a: wkv6(*a, chunk), *ins)
    if which == "wkv6_ref":
        jfn = lambda *a: jax_wkv6_ref(*a)[0]  # noqa: E731
    else:
        jfn = lambda *a: jax_wkv6_chunked(*a, chunk)[0]  # noqa: E731
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, ins))
    for name, got, want in zip("rkvwu", grads, vjp(jnp.asarray(g))):
        assert_allclose(_np(got), np.asarray(want), atol=2e-4, rtol=2e-4,
                        err_msg=f"d{name}")
    rule = wkv6_bwd(*map(_t, ins), chunk, _t(g))
    assert all(torch.equal(a, b) for a, b in zip(rule, grads))


def test_wkv6_final_state_is_not_differentiable():
    ins = [_t(a).requires_grad_() for a in _wkv_inputs(1, 9, 2, 8)]
    y, state = wkv6(*ins, 4)
    assert y.requires_grad and not state.requires_grad


# ---------------------------------------------------------------------------
# AdamW against the JAX optimizer (rtol 1e-6)
# ---------------------------------------------------------------------------

def _adamw_both(cfg, params, grads_per_step, state_dtype="float32"):
    """Run ``len(grads_per_step)`` AdamW updates in both packages from the
    same numpy trees; returns [(jax, port) per compared value]."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_opt.init_opt_state(jp, getattr(jnp, state_dtype))
    tp = convert.params_from_numpy(params, device="cpu")
    tstate = init_opt_state(tp, state_dtype)
    for grads in grads_per_step:
        jp, jstate, jm = jax_opt.adamw_update(
            cfg, jp, jax.tree_util.tree_map(jnp.asarray, grads), jstate)
        tp, tstate, tm = adamw_update(
            cfg, tp, convert.params_from_numpy(grads, device="cpu"), tstate)
    pairs = [(jm[k], tm[k]) for k in ("grad_norm", "lr")]
    pairs.append((jstate["step"], tstate["step"]))
    assert tstate["step"].dtype == torch.int32 and tstate["step"].dim() == 0
    for name in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[name]),
                        tree_leaves(tstate[name])):
            assert str(b.dtype).removeprefix("torch.") == a.dtype.name
            pairs.append((a, b))
    pairs += list(zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)))
    return pairs, tp


def _assert_pairs(pairs, rtol=1e-6):
    """Each value within ``rtol`` of JAX's, or ``rtol`` of its leaf's largest
    element: the global norm sums in another order (its last bit may
    differ), so the clip scale may too, and a moment summed over steps with
    cancellation carries that difference into its small elements."""
    for a, b in pairs:
        a = np.asarray(a, np.float32)
        assert_allclose(_np(b), a, rtol=rtol,
                        atol=rtol * float(np.abs(a).max(initial=0.0)))


def test_adamw_first_step_math():
    """Twin of tests/test_train.py::test_adamw_first_step_math."""
    cfg = OptimizerConfig(learning_rate=0.1, warmup_steps=1, total_steps=100,
                          weight_decay=0.0, clip_norm=0.0, schedule="constant")
    params = {"w": np.array([[1.0, 2.0]], np.float32)}
    grads = {"w": np.array([[0.5, -0.5]], np.float32)}
    pairs, tp = _adamw_both(cfg, params, [grads])
    _assert_pairs(pairs)
    # bias-corrected first step: mhat = g, vhat = g^2 -> delta = sign(g)
    assert_allclose(_np(tp["w"]), params["w"] - 0.1 * np.sign(grads["w"]),
                    atol=1e-5)


def test_grad_clip_bounds_update():
    """Twin of tests/test_train.py::test_grad_clip_bounds_update."""
    cfg = OptimizerConfig(learning_rate=0.1, clip_norm=1.0, warmup_steps=1,
                          weight_decay=0.0, schedule="constant")
    pairs, _ = _adamw_both(cfg, {"w": np.zeros(4, np.float32)},
                           [{"w": np.full(4, 100.0, np.float32)}])
    _assert_pairs(pairs)
    assert float(pairs[0][1]) == pytest.approx(200.0)


def test_lr_schedule_warmup_and_cosine():
    """Twin of tests/test_train.py::test_lr_schedule_warmup_and_cosine, and
    the schedule against JAX's at every step of it."""
    cfg = OptimizerConfig(learning_rate=1.0, warmup_steps=10, total_steps=110,
                          min_lr_frac=0.1)
    assert float(lr_at(cfg, 0)) == pytest.approx(0.1)
    assert float(lr_at(cfg, 9)) == pytest.approx(1.0)
    assert float(lr_at(cfg, 110)) == pytest.approx(0.1, abs=1e-2)
    for c in (cfg, OptimizerConfig(learning_rate=3e-4, warmup_steps=5,
                                   schedule="constant")):
        steps = np.arange(0, 130, dtype=np.int32)
        want = np.array([float(jax_opt.lr_at(c, jnp.int32(s))) for s in steps])
        got = _np(lr_at(c, torch.from_numpy(steps)))
        assert_allclose(got, want, rtol=1e-6, atol=0)


def test_decay_follows_the_stored_leafs_ndim():
    """Decay applies where the stored leaf has ndim >= 2: a stacked (L, D)
    norm scale is decayed, a (D,) one is not, as in JAX."""
    rng = np.random.default_rng(3)
    params = {"final_norm": 1.0 + rng.standard_normal(4).astype(np.float32),
              "layers": {"norm": 1.0 + rng.standard_normal((2, 4))
                         .astype(np.float32)}}
    grads = {"final_norm": rng.standard_normal(4).astype(np.float32),
             "layers": {"norm": rng.standard_normal((2, 4)).astype(np.float32)}}
    cfg = OptimizerConfig(learning_rate=0.05, warmup_steps=1, weight_decay=0.1,
                          clip_norm=0.0, schedule="constant")
    pairs, decayed = _adamw_both(cfg, params, [grads])
    _assert_pairs(pairs)
    _, plain = _adamw_both(dataclasses.replace(cfg, weight_decay=0.0),
                           params, [grads])
    # the decay term is lr * wd * p, only on the stacked leaf
    assert torch.equal(decayed["final_norm"], plain["final_norm"])
    assert_allclose(_np(plain["layers"]["norm"] - decayed["layers"]["norm"]),
                    0.05 * 0.1 * params["layers"]["norm"], rtol=1e-4)


@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_jax(state_dtype, clip_norm):
    """Three decayed steps over a mixed tree, clipped or not, moments stored
    in ``state_dtype`` (computed in fp32 either way). Unclipped, the update
    is the JAX one op for op: every value is bit-identical."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": (7,), "c": {"d": (2, 3, 4)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    params = draw(1.0)
    cfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                          clip_norm=clip_norm, state_dtype=state_dtype)
    pairs, _ = _adamw_both(cfg, params, [draw(0.5) for _ in range(3)],
                           state_dtype)
    _assert_pairs(pairs[:1])  # grad_norm: summed in another order
    _assert_pairs(pairs[1:], rtol=1e-6 if clip_norm else 0.0)


# ---------------------------------------------------------------------------
# Loss and gradients against jax.value_and_grad(loss_fn)
# ---------------------------------------------------------------------------

def _model(arch, dtype="float32", seed=1, **kw):
    """(jax cfg, port cfg, jax params, port params, numpy tokens)."""
    jcfg = jax_smoke_config(arch).replace(compute_dtype=dtype, **kw)
    tcfg = get_smoke_config(arch).replace(compute_dtype=dtype, **kw)
    jparams = jax_init_params(jax_param_specs(jcfg), seed=seed)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jparams, tparams, tokens = _model(arch)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    kcommon.reset_launches()
    loss, metrics, grads = loss_and_grads(tcfg, tparams,
                                          {"tokens": torch.from_numpy(tokens)})
    assert kcommon.launches == {name: 0 for name in kcommon.KERNELS}
    assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_allclose(float(metrics["ce_loss"]), float(jm["ce_loss"]), rtol=1e-5)
    assert float(metrics["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    rel = 2e-4 if arch == "rwkv6_3b" else 1e-4
    flat = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat) == len(tree_leaves(grads))
    for (path, want), got in zip(flat, tree_leaves(grads)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert_allclose(_np(got), want, rtol=1e-4,
                        atol=rel * float(np.abs(want).max()),
                        err_msg=jax.tree_util.keystr(path))
    # the eval step computes the same loss without a graph
    eloss, _ = make_eval_step(tcfg)(tparams, {"tokens": torch.from_numpy(tokens)})
    assert not eloss.requires_grad and torch.equal(eloss, loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_loss_and_grads(arch):
    """Recomputing a layer in the backward runs the same ops on the same
    inputs, so the results are identical."""
    out = {}
    for remat in (True, False):
        _, tcfg, _, tparams, tokens = _model(arch, remat=remat)
        out[remat] = loss_and_grads(tcfg, tparams,
                                    {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_one_train_step(arch):
    """Twin of tests/test_models_smoke.py::test_smoke_one_train_step for the
    ported families (the smoke config's bf16 compute, two microbatches)."""
    cfg = get_smoke_config(arch)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    opt = init_opt_state(params)
    step_fn = make_train_step(
        cfg, OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=10),
        StepConfig(microbatches=2))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    new_params, new_opt, metrics = step_fn(params, opt,
                                           {"tokens": torch.from_numpy(tokens)})
    assert set(metrics) == {"loss", "aux_loss", "grad_norm", "lr"}
    assert all(m.dim() == 0 for m in metrics.values())
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert int(new_opt["step"]) == 1
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(before, tree_leaves(new_params))]
    assert max(moved) > 0


def test_microbatch_accumulation_equivalent():
    """Twin of tests/test_train.py::test_microbatch_accumulation_equivalent:
    n_micro 1 vs 4 in fp32 (the same 5e-4 bound on the updated parameters,
    for accumulation-order differences through Adam's 1/sqrt(v)); the loss
    against JAX's at 1e-5."""
    jcfg, cfg, jparams, params, _ = _model("granite_8b", seed=0)
    tokens = (np.arange(4 * 16).reshape(4, 16) % cfg.vocab_size).astype(np.int32)
    opt_cfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=1,
                              schedule="constant", clip_norm=0.0,
                              weight_decay=0.0)
    outs = {}
    for n in (1, 4):
        p = convert.params_from_numpy(convert.params_to_numpy(params),
                                      device="cpu")
        p, _o, m = make_train_step(cfg, opt_cfg, StepConfig(microbatches=n))(
            p, init_opt_state(p), {"tokens": torch.from_numpy(tokens)})
        outs[n] = (p, float(m["loss"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-5)
    jloss, _ = jax_loss_fn(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    assert outs[1][1] == pytest.approx(float(jloss), rel=1e-5)
    diffs = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(outs[1][0]), tree_leaves(outs[4][0]))]
    assert max(diffs) < 5e-4


def test_loss_decreases_on_learnable_data():
    """Twin of tests/test_train.py::test_loss_decreases_on_learnable_data;
    the first loss against JAX's (bf16 compute: atol = rtol = 4e-2, as
    tests/test_kernels.py)."""
    jcfg, cfg, jparams, params, _ = _model("granite_8b", dtype="bfloat16",
                                           seed=0)
    base = np.arange(16)[None, :] + np.arange(4)[:, None] * 3
    tokens = (base % cfg.vocab_size).astype(np.int32)
    step = make_train_step(cfg, OptimizerConfig(learning_rate=3e-3,
                                                warmup_steps=5,
                                                total_steps=100),
                           StepConfig(microbatches=1))
    opt = init_opt_state(params)
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    jloss, _ = jax_loss_fn(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    assert_allclose(losses[0], float(jloss), atol=4e-2, rtol=4e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    """The label logit by gather against JAX's one-hot sum: the same mean
    (or masked mean) token CE, fp32 logsumexp, from bf16 logits."""
    from repro.models.common import softmax_cross_entropy as jax_ce
    from repro_torch.models.common import softmax_cross_entropy

    rng = np.random.default_rng(6)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    tl = _t(logits).to(torch.bfloat16)
    want = jax_ce(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
                  None if mask is None else jnp.asarray(mask))
    got = softmax_cross_entropy(tl, _t(labels),
                                None if mask is None else _t(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_are_summed_in_fp32_then_averaged(arch):
    """The step with two microbatches is, bit for bit, each half's grads
    summed into an fp32 accumulator, halved, and one AdamW update; its loss
    is the halves' mean."""
    _, cfg, _, params, _ = _model(arch, dtype="bfloat16")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)))
    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                              total_steps=10)
    copy = [convert.params_from_numpy(convert.params_to_numpy(params),
                                      device="cpu") for _ in range(2)]
    got, _o, m = make_train_step(cfg, opt_cfg, StepConfig(microbatches=2))(
        copy[0], init_opt_state(copy[0]), {"tokens": tokens})
    halves = [loss_and_grads(cfg, copy[1], {"tokens": tokens[i:i + 2]})
              for i in (0, 2)]
    acc = [torch.zeros(g.shape, dtype=torch.float32)
           for g in tree_leaves(halves[0][2])]
    for _l, _m, grads in halves:
        for a, g in zip(acc, tree_leaves(grads)):
            a.add_(g)
    for a in acc:
        a.div_(2)
    want, _o, wm = adamw_update(opt_cfg, copy[1],
                                tree_unflatten(copy[1], acc),
                                init_opt_state(copy[1]))
    assert torch.equal(m["loss"], (halves[0][0] + halves[1][0]) / 2)
    assert torch.equal(m["grad_norm"], wm["grad_norm"])
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_train_step_refuses_a_batch_that_does_not_split():
    cfg = get_smoke_config("granite_8b")
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    step = make_train_step(cfg, OptimizerConfig(), StepConfig(microbatches=3))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, init_opt_state(params),
             {"tokens": torch.zeros(4, 8, dtype=torch.int64)})


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_are_freed_without_the_cycle_collector(arch):
    """A step's gradients die with their last reference. With the cycle
    collector off, as between its runs, a reference cycle around the
    gradient tree (a self-calling closure in ``tree_unflatten`` once) kept
    all of them alive: 8 GiB on the card at granite-8b's 8-layer width."""
    import gc
    import weakref

    _jcfg, tcfg, _jparams, tparams, tokens = _model(arch)
    batch = {"tokens": torch.from_numpy(tokens)}
    # torch imports torch._dynamo at the first checkpointed layer, and that
    # import keeps the calling frames (and their locals) alive: warm it up
    loss_and_grads(tcfg, tparams, batch)
    gc.collect()
    gc.disable()
    try:
        _loss, _metrics, grads = loss_and_grads(tcfg, tparams, batch)
        refs = [weakref.ref(g) for g in tree_leaves(grads)]
        del grads
        assert [r() for r in refs] == [None] * len(refs)
        step = make_train_step(tcfg, OptimizerConfig(), StepConfig())
        opt = init_opt_state(tparams)
        def tensors():
            # type(), not isinstance(): the latter reads ``__class__``,
            # which some of torch's deprecated module attributes warn on
            return [t for t in gc.get_objects()
                    if issubclass(type(t), torch.Tensor)]

        before = {id(t) for t in tensors()}
        params, opt, _m = step(tparams, opt, batch)
        left = [t for t in tensors() if id(t) not in before and t.numel() > 1]
        assert left == [], [tuple(t.shape) for t in left]
    finally:
        gc.enable()
