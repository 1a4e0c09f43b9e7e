"""The port's MoE family and vision prefix against the JAX package, on the
CPU: ``models/moe.py`` alone, then the four configs that need them
(deepseek-moe-16b, qwen3-moe-235b-a22b, qwen3-vl-30b-a3b, internvl2-76b) as
whole models, and twins of tests/test_models_smoke.py's MoE and vision cases.

The same numpy inputs and JAX-initialised weights (through
``repro_torch.convert``) go to both packages. Tolerances: fp32 1e-4 (as
tests/test_models_smoke.py), bf16 atol = rtol = 4e-2 (as
tests/test_kernels.py); routing decisions (expert, position, kept) exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_decode_state as jax_init_decode_state  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (decode_step, forward, init_decode_state,  # noqa: E402
                                init_params, loss_fn, param_specs, prefill)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import (OptimizerConfig, StepConfig,  # noqa: E402
                               init_opt_state, loss_and_grads, make_train_step)

ARCHS = ["deepseek_moe_16b", "qwen3_moe_235b_a22b", "qwen3_vl_30b_a3b",
         "internvl2_76b"]
VISION = ["qwen3_vl_30b_a3b", "internvl2_76b"]
B, S, P = 2, 10, 4


def _tol(dtype):
    return dict(atol=4e-2, rtol=4e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch, dtype="float32", seed=1, **kw):
    """(jax cfg, port cfg, jax params, port params) of ``arch``'s smoke
    config with ``kw`` replaced."""
    jcfg = jax_smoke(arch).replace(compute_dtype=dtype, **kw)
    tcfg = get_smoke_config(arch).replace(compute_dtype=dtype, **kw)
    jparams = jax_init_params(jax_param_specs(jcfg), seed=seed)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batches(cfg, prefix, seed=0):
    """The same batch for both packages: tokens (B, S) and, with
    ``prefix``, seeded fp32 frame embeddings (B, P, d_model)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if prefix:
        fe = (0.5 * rng.standard_normal((B, P, cfg.d_model))).astype(np.float32)
        jb["frontend_embeds"] = jnp.asarray(fe)
        tb["frontend_embeds"] = torch.from_numpy(fe)
    return jb, tb


def _layer_pair(arch, dtype, seed=1, **kw):
    """One layer's MoE parameters in both packages."""
    jcfg, tcfg, jparams, tparams = _pair(arch, dtype, seed, num_layers=1, **kw)
    jp = {k: v[0] for k, v in jparams["layers"].items()}
    tp = {k: v[0] for k, v in tparams["layers"].items()}
    return jcfg, tcfg, jp, tp


def _x(cfg, seed=0, T=(3, 8)):
    return np.random.default_rng(seed).standard_normal(
        (*T, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# moe_ffn alone
# ---------------------------------------------------------------------------

LAYER_CASES = {
    # (arch, replaced fields)
    "deepseek (shared experts)": ("deepseek_moe_16b", {}),
    "qwen3-moe (no shared experts)": ("qwen3_moe_235b_a22b", {}),
    "drops (capacity factor 0.3)": ("deepseek_moe_16b",
                                    {"moe_capacity_factor": 0.3}),
}


@pytest.mark.parametrize("dispatch", ["scatter", "einsum", "local"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_ffn_matches_jax(case, dtype, dispatch):
    arch, kw = LAYER_CASES[case]
    jcfg, tcfg, jp, tp = _layer_pair(arch, dtype, moe_dispatch=dispatch, **kw)
    x = _x(jcfg)
    jy, jaux = jax_moe.moe_ffn(jcfg, jp, jnp.asarray(x).astype(jcfg.cdtype))
    ty, taux = moe.moe_ffn(tcfg, tp, torch.from_numpy(x).to(tcfg.cdtype))
    assert ty.dtype == tcfg.cdtype and tuple(ty.shape) == jy.shape
    assert_allclose(_np(ty), _np(jy), **_tol(dtype))
    assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if "drops" in case:  # the case really drops choices
        *_, keep, _cap = jax_moe._routing(
            jcfg, jp, jnp.asarray(x).reshape(-1, jcfg.d_model))
        assert 0 < int(jnp.sum(~keep)) < keep.size


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_routing_decisions_equal_jax_exactly(case):
    """Experts, position-in-expert (choice-major), kept choices and capacity
    are the reference's, element for element; gates and probs at fp32."""
    arch, kw = LAYER_CASES[case]
    jcfg, tcfg, jp, tp = _layer_pair(arch, "float32", **kw)
    x = _x(jcfg, seed=3).reshape(-1, jcfg.d_model)
    jr = jax_moe._routing(jcfg, jp, jnp.asarray(x))
    tr = moe._routing(tcfg, tp, torch.from_numpy(x))
    jprobs, jonehot, jidx, jgate, jpos, jkeep, jcap = jr
    tprobs, tonehot, tidx, tgate, tpos, tkeep, tcap = tr
    assert tcap == jcap
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tonehot.numpy(), np.asarray(jonehot))
    assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6)
    assert_allclose(tgate.numpy(), np.asarray(jgate), atol=1e-6)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_zero_router_ties_route_as_jax_and_torch_topk_would_not(
        dispatch, monkeypatch):
    """A zero router gives every token equal probabilities: JAX's top_k
    picks experts 0..K-1 for every token (the lower index first), so most
    choices overflow those experts' capacity. The port's stable sort does
    the same; ``torch.topk`` orders the tie otherwise, which moves tokens
    to other experts and changes the output."""
    jcfg, tcfg, jp, tp = _layer_pair("deepseek_moe_16b", "float32",
                                     moe_dispatch=dispatch)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(jcfg, seed=4)
    K = jcfg.moe_top_k
    _, _, jidx, _, _, jkeep, _ = jax_moe._routing(
        jcfg, jp, jnp.asarray(x).reshape(-1, jcfg.d_model))
    assert (np.asarray(jidx) == np.arange(K)).all()
    assert int(jnp.sum(~jkeep)) > jkeep.size // 2       # most overflow
    jy, jaux = jax_moe.moe_ffn(jcfg, jp, jnp.asarray(x))
    ty, taux = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=0)
    assert_allclose(float(taux), float(jaux), rtol=1e-6)

    probs = torch.full((4, jcfg.moe_num_experts), 1.0 / jcfg.moe_num_experts)
    assert torch.topk(probs, K).indices.tolist() != [list(range(K))] * 4
    monkeypatch.setattr(moe, "top_k", lambda p, k: tuple(torch.topk(p, k)))
    wrong, _ = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    assert not np.allclose(_np(wrong), _np(jy), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_ffn_grads_match_jax_vjp(case, dispatch):
    """Gradients of <y, g> + aux in x and every parameter against
    ``jax.vjp`` (fp32, 1e-4 of each leaf's largest element)."""
    arch, kw = LAYER_CASES[case]
    jcfg, tcfg, jp, tp = _layer_pair(arch, "float32", moe_dispatch=dispatch,
                                     **kw)
    names = moe.moe_param_specs(tcfg, 1)            # the MoE leaves only
    jp, tp = ({k: v for k, v in d.items() if k in names} for d in (jp, tp))
    x = _x(jcfg, seed=5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jfn(x_, p_):
        y, aux = jax_moe.moe_ffn(jcfg, p_, x_)
        return jnp.sum(y * g) + aux

    jgx, jgp = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    tpl = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, aux = moe.moe_ffn(tcfg, tpl, tx)
    (torch.sum(y * torch.from_numpy(g)) + aux).backward()
    for name, got, want in [("x", tx.grad, jgx)] + [
            (k, tpl[k].grad, jgp[k]) for k in sorted(jgp)]:
        want = np.asarray(want)
        assert_allclose(_np(got), want, rtol=1e-4,
                        atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                        err_msg=name)


@pytest.mark.parametrize("arch,T,cap", [
    ("deepseek_moe_16b", 8 * 1000, 940),    # its serving prefill
    ("deepseek_moe_16b", 8, 4),             # one decode step of 8 requests
    ("qwen3_vl_30b_a3b", 4 * 1152, 360),    # the training batch with its prefix
])
def test_capacity_is_the_references_at_full_size(arch, T, cap):
    """The full configs' E, K and capacity factor (a narrow D and a zero
    router keep it small): the reference's own capacity."""
    jcfg = jax_get_config(arch).replace(d_model=8)
    router = np.zeros((8, jcfg.moe_num_experts), np.float32)
    *_, jcap = jax_moe._routing(jcfg, {"router": jnp.asarray(router)},
                                jnp.zeros((T, 8), jnp.float32))
    assert moe.capacity(get_config(arch), T) == jcap == cap


def test_decode_drops_choices_at_capacity_4_in_both_packages():
    """A property of the reference that the port keeps: a decode step of B
    tokens routes with capacity max(4, ...) = 4, so 8 requests on the same
    6 of 64 experts drop half their choices, and a request's output depends
    on its batch mates. Both packages drop the same choices; the logits of
    8 equal requests differ from the same request served alone."""
    kw = dict(moe_num_experts=64, moe_top_k=6)
    jcfg, tcfg, jparams, tparams = _pair("deepseek_moe_16b", **kw)
    tok = np.full((8,), 7, np.int32)
    outs = {}
    for n in (8, 1):
        jst = jax_init_decode_state(jcfg, n, 4)
        jl, _ = jax_decode_step(jcfg, jparams, jst, jnp.asarray(tok[:n]),
                                jnp.int32(0))
        tst = init_decode_state(tcfg, n, 4, device="cpu")
        tl, _ = decode_step(tcfg, tparams, tst, torch.from_numpy(tok[:n]), 0)
        assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
        outs[n] = _np(tl)
    x = jnp.asarray(_x(jcfg, seed=7, T=(1,)))
    *_, keep, cap = jax_moe._routing(jcfg, jax.tree_util.tree_map(
        lambda a: a[0], jparams["layers"]), jnp.tile(x, (8, 1)))
    assert cap == 4 and int(jnp.sum(keep)) == 6 * 4   # 48 choices, 24 kept
    assert not np.allclose(outs[8][0], outs[1][0], atol=1e-4)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def _with_prefix(arch):
    return [False, True] if arch in VISION else [False]


def _record_jax_choices(monkeypatch):
    """Each call's top-k choices of the JAX package's routing, in call order
    (a ``jax.debug.callback`` from inside the traced layer scan)."""
    calls, routing = [], jax_moe._routing

    def recording(cfg, p, xt):
        out = routing(cfg, p, xt)
        jax.debug.callback(lambda idx: calls.append(np.asarray(idx)), out[2],
                           ordered=True)
        return out

    monkeypatch.setattr(jax_moe, "_routing", recording)
    return calls


def _replay_choices(monkeypatch, choices):
    """The port's routing with each call's top-k choices replaced by the
    next of ``choices`` (its own probabilities, gates and dispatch). Returns
    a list that gets, per call, (tokens whose own choices differ, each such
    token's smallest gap between neighbours of its K + 1 largest
    probabilities)."""
    it, report = iter(choices), []

    def replaying(cfg, p, xt):
        probs = moe.router_probs(p, xt)
        K = cfg.moe_top_k
        want = torch.from_numpy(np.array(next(it))).long()
        flipped = (moe.top_k(probs, K)[1] != want).any(-1)
        top = moe.top_k(probs, K + 1)[0]
        gaps = (top[:, :-1] - top[:, 1:]).min(-1).values
        report.append((int(flipped.sum()), gaps[flipped].tolist()))
        return moe.plan(cfg, probs, want)

    monkeypatch.setattr(moe, "_routing", replaying)
    return report


CASES = [(a, p) for a in ARCHS for p in _with_prefix(a)]
#: deepseek-moe-16b's smoke model in bf16 is held layer by layer
#: (test_bf16_layers_match_jax_on_the_same_inputs), not whole: the port
#: routes one layer-0 token otherwise (its 2nd and 3rd probabilities
#: 0.19483 / 0.19464), and under the reference's choices one logit of 5140
#: still sits at 1.10x the 4e-2 limit; JAX's own unrolled forward is 1.88x
#: off its scanned one, 12 logits over.
BF16_WHOLE = [c for c in CASES if c[0] != "deepseek_moe_16b"]


@pytest.mark.parametrize("arch,prefix,dtype",
                         [(*c, "float32") for c in CASES]
                         + [(*c, "bfloat16") for c in BF16_WHOLE])
def test_forward_matches_jax(arch, prefix, dtype, monkeypatch):
    """Logits and aux loss. In bf16 the two packages' hidden states differ
    by bf16 rounding, which can flip a near-tied routing choice, and one
    flipped choice moves a token's whole FFN output. So in bf16 the port
    replays the reference's choices: the logits are held at 4e-2 under the
    same routing, and every choice the port would have made otherwise must
    be a near tie (its gap printed)."""
    jcfg, tcfg, jparams, tparams = _pair(arch, dtype)
    jb, tb = _batches(jcfg, prefix)
    replay = dtype == "bfloat16" and jcfg.family == "moe"
    if replay:
        choices = _record_jax_choices(monkeypatch)
    jl, jaux = jax_forward(jcfg, jparams, jb)
    if replay:
        jax.effects_barrier()
        assert len(choices) == jcfg.num_layers
        report = _replay_choices(monkeypatch, choices)
    tl, taux = forward(tcfg, tparams, tb)
    n = S + (P if prefix else 0)
    assert tuple(tl.shape) == (B, n, tcfg.vocab_size) and tl.dtype == tcfg.cdtype
    assert_allclose(_np(tl), _np(jl), **_tol(dtype))
    assert_allclose(float(taux), float(jaux),
                    **(_tol(dtype) if dtype == "bfloat16" else
                       dict(rtol=1e-5, atol=1e-7)))
    assert (float(taux) > 0) == (tcfg.family == "moe")
    if replay:
        print(f"{arch} prefix={prefix}: tokens routed otherwise by the port, "
              f"per layer, with their gaps: {report}")
        assert len(report) == jcfg.num_layers
        assert all(gap < 5e-3 for _, gaps in report for gap in gaps), report


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_match_jax_on_the_same_inputs(arch, monkeypatch):
    """Each decoder layer of the bf16 smoke model, fed the reference's own
    hidden state (the prefix first for the vision configs), against the
    reference's layer: output at 4e-2, aux loss at 4e-2. The port's routing
    choices are printed against the reference's, and each that differs must
    be a near tie."""
    from repro.models import transformer as jax_tf
    from repro.models.common import rope_angles as jax_rope
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import layer_slices

    jcfg, tcfg, jparams, tparams = _pair(arch, "bfloat16")
    jb, _ = _batches(jcfg, arch in VISION)
    h = jax_tf._embed_tokens(jcfg, jparams, jb["tokens"])
    if "frontend_embeds" in jb:
        h = jnp.concatenate([jb["frontend_embeds"].astype(h.dtype), h], axis=1)
    n = h.shape[1]
    cos, sin = jax_rope(jnp.arange(n), jcfg.head_dim, jcfg.rope_theta)
    _, tcos, tsin = tf._embed_and_rope(tcfg, tparams, torch.zeros(
        (B, n), dtype=torch.int64))
    choices = _record_jax_choices(monkeypatch)
    jcfg = jcfg.replace(remat=False)
    reports = []
    for i, tlp in enumerate(layer_slices(tparams, tcfg.num_layers)):
        jlp = jax.tree_util.tree_map(lambda a: a[i], jparams["layers"])
        jh, jaux = jax_tf.decoder_layer(jcfg, jlp, h, cos[None], sin[None])
        jax.effects_barrier()
        th_in = torch.from_numpy(np.array(h.astype(jnp.float32))).to(tcfg.cdtype)
        with pytest.MonkeyPatch.context() as mp:
            report = _replay_choices(mp, choices[i:]) \
                if tcfg.family == "moe" else []
            th, taux = tf.decoder_layer(tcfg, tlp, th_in, tcos, tsin)
        reports += report
        assert_allclose(_np(th), _np(jh), atol=4e-2, rtol=4e-2,
                        err_msg=f"layer {i}")
        assert_allclose(float(taux), float(jaux), atol=4e-2, rtol=4e-2)
        h = jh
    print(f"{arch}: tokens routed otherwise by the port, per layer, with "
          f"their gaps: {reports}")
    assert all(gap < 5e-3 for _, gaps in reports for gap in gaps), reports


@pytest.mark.parametrize("arch,prefix", CASES)
def test_prefill_logits_and_cache_match_jax(arch, prefix):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    jb, tb = _batches(jcfg, prefix)
    jl, jcache = jax_prefill(jcfg, jparams, jb)
    tl, tcache = prefill(tcfg, tparams, tb)
    assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert_allclose(_np(tcache[k]), _np(jcache[k]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch,prefix", CASES)
def test_decode_steps_after_prefill_match_jax(arch, prefix):
    """Prefill (with the prefix's P positions first, if any), then three
    decode steps at positions P + S, ...: each step's logits and the cache."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    jb, tb = _batches(jcfg, prefix)
    n0 = S + (P if prefix else 0)
    jl, jcache = jax_prefill(jcfg, jparams, jb)
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
              for k, v in jcache.items()}
    tcache = init_decode_state(tcfg, B, n0 + 3, device="cpu")
    tl, tcache = prefill(tcfg, tparams, tb, cache=tcache)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(n0 + i))
        tl, tcache = decode_step(tcfg, tparams, tcache, torch.from_numpy(tok),
                                 n0 + i)
        assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0, err_msg=f"step {i}")
    for k in ("k", "v"):
        assert_allclose(_np(tcache[k]), _np(jcache[k]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch,prefix", CASES)
def test_loss_and_grads_match_jax(arch, prefix):
    """``loss_fn`` (the prefix left out of the loss) and its gradients
    against ``jax.value_and_grad``: loss rtol 1e-5, each leaf rtol 1e-4 with
    atol 1e-4 of its largest element (as tests/test_torch_train.py)."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    jb, tb = _batches(jcfg, prefix)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jb), has_aux=True)(jparams)
    loss, metrics, grads = loss_and_grads(tcfg, tparams, tb)
    assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_allclose(float(metrics["ce_loss"]), float(jm["ce_loss"]), rtol=1e-5)
    assert_allclose(float(metrics["aux_loss"]), float(jm["aux_loss"]),
                    rtol=1e-5, atol=1e-7)
    flat = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat) == len(tree_leaves(grads))
    for (path, want), got in zip(flat, tree_leaves(grads)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert_allclose(_np(got), want, rtol=1e-4,
                        atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                        err_msg=jax.tree_util.keystr(path))


def test_prefix_is_left_out_of_the_loss():
    """The loss of a prefixed batch reads only the token positions' logits:
    the same as the CE of ``logits[:, P:][:, :-1]`` computed by hand, and
    not that of the first S - 1 positions."""
    from repro_torch.models.common import softmax_cross_entropy

    _, tcfg, _, tparams = _pair("qwen3_vl_30b_a3b")
    _, tb = _batches(tcfg, prefix=True)
    with torch.no_grad():
        total, m = loss_fn(tcfg, tparams, tb)
        logits, aux = forward(tcfg, tparams, tb)
        tokens = tb["tokens"]
        want = softmax_cross_entropy(logits[:, P:-1], tokens[:, 1:])
        wrong = softmax_cross_entropy(logits[:, :S - 1], tokens[:, 1:])
    assert torch.equal(m["ce_loss"], want) and torch.equal(total, want + aux)
    assert not torch.allclose(want, wrong)


def test_prefill_cache_check_counts_the_prefix():
    _, tcfg, _, tparams = _pair("internvl2_76b")
    _, tb = _batches(tcfg, prefix=True)
    with pytest.raises(ValueError, match="prefix"):
        prefill(tcfg, tparams, tb,
                cache=init_decode_state(tcfg, B, S + P - 1, device="cpu"))
    _, cache = prefill(tcfg, tparams, tb,
                       cache=init_decode_state(tcfg, B, S + P, device="cpu"))
    assert bool((cache["k"][:, :, S + P - 1] != 0).any())


# ---------------------------------------------------------------------------
# Twins of tests/test_models_smoke.py (MoE and vision configs)
# ---------------------------------------------------------------------------

def _smoke_batch(cfg):
    """tests/test_models_smoke.py's ``_batch``: 24 tokens, and a constant
    (B, 4, d_model) prefix for the vision configs."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, 24)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(tokens)}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = torch.full((B, 4, cfg.d_model), 0.01)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_shapes_and_finite(arch):
    cfg = get_smoke_config(arch)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    logits, aux = forward(cfg, params, _smoke_batch(cfg))
    n = 24 + (4 if cfg.frontend != "none" else 0)
    assert tuple(logits.shape) == (B, n, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_one_train_step(arch):
    cfg = get_smoke_config(arch)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    opt = init_opt_state(params)
    step_fn = make_train_step(
        cfg, OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=10),
        StepConfig(microbatches=2))
    new_params, new_opt, metrics = step_fn(params, opt, _smoke_batch(cfg))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert (float(metrics["aux_loss"]) > 0) == (cfg.family == "moe")
    assert int(new_opt["step"]) == 1
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(before, tree_leaves(new_params))]
    assert max(moved) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step(arch):
    cfg = get_smoke_config(arch)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    st = init_decode_state(cfg, B, 16, device="cpu")
    logits, st2 = decode_step(cfg, params, st, torch.zeros(B, dtype=torch.int64), 0)
    assert bool(torch.isfinite(logits.float()).all())
    assert set(st2) == set(st)


def test_moe_decode_matches_forward_when_capacity_unbounded():
    """Twin of the reference's test: with capacity factor 8 neither the
    forward nor the single-token decode drops a choice, and the two agree
    (fp32, 1e-4)."""
    cfg = get_smoke_config("deepseek_moe_16b").replace(
        compute_dtype="float32", moe_capacity_factor=8.0)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    tokens = torch.arange(B * 10).reshape(B, 10) * 3 % cfg.vocab_size
    lf, _ = forward(cfg, params, {"tokens": tokens})
    st = init_decode_state(cfg, B, 10, device="cpu")
    errs = []
    for t in range(10):
        lg, st = decode_step(cfg, params, st, tokens[:, t], t)
        errs.append(float((lg - lf[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_asdict_and_param_counts_match_jax(arch, which):
    import importlib

    jcfg = getattr(importlib.import_module(f"repro.configs.{arch}"), which)
    tcfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"), which)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_full_configs_match_assignment():
    """The MoE and vision rows of the reference's
    ``test_full_configs_match_assignment``."""
    expect = {
        "deepseek_moe_16b": (28, 2048, 1408, 102400),
        "qwen3_moe_235b_a22b": (94, 4096, 1536, 151936),
        "internvl2_76b": (80, 8192, 28672, 128256),
    }
    for arch, (L, D, F, V) in expect.items():
        cfg = get_config(arch)
        assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (L, D, F, V)
    assert get_config("deepseek_moe_16b").moe_num_shared == 2
    assert get_config("deepseek_moe_16b").moe_top_k == 6
    assert get_config("qwen3_moe_235b_a22b").moe_num_experts == 128
    vl = get_config("qwen3-vl-30b-a3b")
    assert (vl.family, vl.frontend, vl.num_layers, vl.moe_num_experts) == \
        ("moe", "vision", 48, 128)


def test_param_counts_match_nominal_sizes():
    for arch, (lo, hi) in {"deepseek_moe_16b": (15e9, 18e9),
                           "qwen3_moe_235b_a22b": (225e9, 245e9)}.items():
        assert lo <= get_config(arch).param_count() <= hi, arch
    assert 20e9 <= get_config("qwen3_moe_235b_a22b").active_param_count() <= 24e9


def test_rwkv_takes_no_frontend_embeds():
    """The reference's RWKV forward ignores a prefix that its loss would
    still cut off the logits; the port refuses it instead."""
    cfg = get_smoke_config("rwkv6_3b")
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
             "frontend_embeds": torch.zeros((1, 2, cfg.d_model))}
    with pytest.raises(ValueError, match="frontend_embeds"):
        forward(cfg, params, batch)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "qwen3_vl_30b_a3b"])
def test_remat_on_and_off_give_the_same_loss_and_grads(arch):
    """A recomputed MoE layer routes its tokens as its forward did (the
    same ops on the same inputs), so remat changes no bit of the loss or
    the gradients, the prefix's included."""
    out = {}
    for remat in (True, False):
        _, tcfg, _, tparams = _pair(arch, "bfloat16", remat=remat)
        _, tb = _batches(tcfg, arch in VISION)
        out[remat] = loss_and_grads(tcfg, tparams, tb)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)
