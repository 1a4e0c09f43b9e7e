"""The port's audio family against the JAX package, on the musicgen-medium
smoke config, on the CPU: the codebook tables and heads (``param_specs``,
the summed embedding, the (B, S, K, V) logits), forward with and without a
conditioning prefix, prefill then decode, ``loss_fn``'s (S-1)·K layout and
its gradients, one train step over two microbatches, the serving casts and
the reference engine's audio fault, and twins of
tests/test_models_smoke.py's audio cases.

The same numpy inputs and weights (through ``repro_torch.convert``) go to
both packages, with the norm scales, which both packages initialise to
ones, drawn at random so that every path carries weight. Tolerances: fp32
1e-4 (as tests/test_models_smoke.py), bf16 atol = rtol = 4e-2 (as
tests/test_kernels.py).
"""
import dataclasses
import functools

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import musicgen_medium as jax_musicgen  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_decode_state as jax_init_decode_state  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.train.optimizer import init_opt_state as jax_init_opt_state  # noqa: E402
from repro.train.step import StepConfig as JaxStepConfig  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import musicgen_medium  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_decode_state, init_params, loss_fn,
                                param_specs, prefill)
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.engine import ServeEngine, serving_params  # noqa: E402
from repro_torch.train import (OptimizerConfig, StepConfig,  # noqa: E402
                               init_opt_state, loss_and_grads, make_train_step)

B, S, P = 2, 10, 4   # rows, frames, conditioning frames
DTYPES = ["float32", "bfloat16"]
PREFIXES = [0, P]
_NORMS = ("attn_norm", "mlp_norm")


def _tol(dtype):
    return dict(atol=4e-2, rtol=4e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _numpy_params(seed):
    """The smoke model's weights as a numpy tree, drawn by the port's
    ``init_params``, the norm scales at 1 + N(0, 0.2)."""
    tree = convert.params_to_numpy(init_params(
        param_specs(musicgen_medium.SMOKE_CONFIG), seed=seed, device="cpu"))
    rng = np.random.default_rng(seed)
    for name in _NORMS:
        shape = tree["layers"][name].shape
        tree["layers"][name] = (1.0 + 0.2 * rng.standard_normal(shape)
                                ).astype(np.float32)
    tree["final_norm"] = (1.0 + 0.2 * rng.standard_normal(
        tree["final_norm"].shape)).astype(np.float32)
    return tree


def _configs(dtype="float32", seed=1, **kw):
    """(jax cfg, port cfg, jax params, port params) for musicgen-medium
    smoke."""
    jcfg = jax_musicgen.SMOKE_CONFIG.replace(compute_dtype=dtype, **kw)
    tcfg = musicgen_medium.SMOKE_CONFIG.replace(compute_dtype=dtype, **kw)
    tree = _numpy_params(seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, device="cpu")


def _batch(cfg, prefix=0, n=S, seed=0):
    """numpy tokens (B, n, K) and, with ``prefix``, fp32 frame embeddings
    (B, prefix, d_model)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, n, cfg.num_codebooks)).astype(np.int32)}
    if prefix:
        batch["frontend_embeds"] = (0.5 * rng.standard_normal(
            (B, prefix, cfg.d_model))).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Config, registry, parameters, serving casts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_config_asdict_and_param_count_match_jax(which):
    jcfg, tcfg = getattr(jax_musicgen, which), getattr(musicgen_medium, which)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert str(tcfg.cdtype).removeprefix("torch.") == jcfg.cdtype.name
    assert tcfg.param_count() == jcfg.param_count()


def test_registry_lists_musicgen_medium_under_its_alias():
    cfg = get_config("musicgen-medium")
    assert cfg is musicgen_medium.CONFIG and cfg.family == "audio"
    assert get_smoke_config("musicgen_medium") is musicgen_medium.SMOKE_CONFIG
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.num_codebooks) == \
        (48, 1536, 24, 24, 64, 6144, 2048, 4)


def test_param_count_matches_nominal_size():
    """48 layers of 37.75 M (four 1536² attention matrices, three 1536 x 6144
    FFN matrices, two norms), the two (4, 2048, 1536) codebook tables and the
    final norm."""
    cfg = get_config("musicgen_medium")
    assert cfg.param_count() == 1_837_254_144
    assert cfg.param_count() == 48 * (4 * 1536**2 + 3 * 1536 * 6144 + 2 * 1536) \
        + 2 * 4 * 2048 * 1536 + 1536


def test_parameter_shapes_equal_param_specs():
    cfg = musicgen_medium.SMOKE_CONFIG
    K, V, D = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
    specs, jspecs = param_specs(cfg), jax_param_specs(jax_musicgen.SMOKE_CONFIG)
    params = init_params(specs, seed=0, device="cpu")
    assert specs["embed"].shape == jspecs["embed"].shape == (K, V, D)
    assert specs["unembed"].shape == jspecs["unembed"].shape == (K, D, V)
    assert specs["embed"].logical_axes == jspecs["embed"].logical_axes
    assert specs["unembed"].logical_axes == jspecs["unembed"].logical_axes
    assert sorted(params) == sorted(specs) == sorted(jspecs)
    for name, spec in specs["layers"].items():
        assert tuple(params["layers"][name].shape) == spec.shape \
            == jspecs["layers"][name].shape, name
    for name in ("embed", "unembed", "final_norm"):
        assert tuple(params[name].shape) == specs[name].shape, name
    # the tables' scales: embed N(0, 0.02), unembed fan-in K·D
    assert abs(float(params["embed"].std()) / 0.02 - 1.0) < 0.1
    assert abs(float(params["unembed"].std()) * np.sqrt(K * D) - 1.0) < 0.1


def test_convert_carries_the_codebook_tables_unchanged():
    tree = _numpy_params(1)
    tparams = convert.params_from_numpy(tree, device="cpu")
    assert tuple(tparams["embed"].shape) == tree["embed"].shape
    back = convert.params_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_serving_params_cast_what_jax_casts_on_use():
    """The matrices and the K heads are cast at load, as JAX casts them on
    use; the codebook tables stay fp32 (JAX sums the K rows in float32 and
    casts the sum), and so do the norm scales."""
    cfg = musicgen_medium.SMOKE_CONFIG
    params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                             device="cpu"), torch.device("cpu"))
    bf16 = {"unembed", "layers.wq", "layers.wk", "layers.wv", "layers.wo",
            "layers.w_gate", "layers.w_up", "layers.w_down"}
    seen = {}
    for group, sub in params.items():
        for k, v in (sub.items() if isinstance(sub, dict) else [(None, sub)]):
            seen[group if k is None else f"{group}.{k}"] = v.dtype
    assert {k for k, d in seen.items() if d == torch.bfloat16} == bf16
    assert all(d == torch.float32 for k, d in seen.items() if k not in bf16)


def test_reference_engine_fails_on_audio_and_the_port_refuses_it():
    """The JAX ``ServeEngine`` accepts the audio family, prefills, and then
    fails reading a step's (K,) tokens as one int
    (src/repro/serve/engine.py, ``t = int(tok_np[b])``; ROADMAP.md Queue 3).
    The port's engine refuses the family by name instead."""
    jcfg, tcfg, jparams, tparams = _configs()
    prompts = _batch(jcfg, n=4)["tokens"]
    engine = JaxServeEngine(jcfg, jparams, max_seq=16)
    reqs = [JaxRequest(rid=i, prompt=prompts[i], max_new_tokens=2)
            for i in range(B)]
    with pytest.raises(TypeError):
        engine.run_batch(reqs)
    assert engine.stats.prefills == 1 and engine.stats.tokens_out == 0
    with pytest.raises(NotImplementedError, match="audio.*Queue 3"):
        ServeEngine(tcfg, tparams, max_seq=16, device="cpu")


# ---------------------------------------------------------------------------
# The model against JAX
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_logits(dtype, prefix, seed=1):
    jcfg, _, jparams, _ = _configs(dtype, seed)
    batch = _jax(_batch(jcfg, prefix))
    return _np(jax.jit(lambda p: jax_forward(jcfg, p, batch)[0])(jparams))


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype, prefix):
    _, tcfg, _, tparams = _configs(dtype)
    kcommon.reset_launches()
    tl, taux = forward(tcfg, tparams, _torch(_batch(tcfg, prefix)))
    assert kcommon.launches == {name: 0 for name in kcommon.LAUNCHES}
    assert tl.shape == (B, prefix + S, tcfg.num_codebooks, tcfg.vocab_size)
    assert tl.dtype == tcfg.cdtype
    assert_allclose(_np(tl), _jax_logits(dtype, prefix), **_tol(dtype))
    assert float(taux) == 0.0


def test_embedding_is_the_sum_of_the_codebook_rows_and_unembedding_has_no_softcap():
    """A softcap in the config changes nothing on the audio branch, as in the
    reference; the first position's input is the sum of its K rows."""
    jcfg, tcfg, jparams, tparams = _configs(logits_softcap=0.5)
    batch = _batch(tcfg)
    tl, _ = forward(tcfg, tparams, _torch(batch))
    jl, _ = jax_forward(jcfg, jparams, _jax(batch))
    assert float(tl.abs().max()) > 0.5
    assert_allclose(_np(tl), _np(jl), **_tol("float32"))
    assert_allclose(_np(tl), _jax_logits("float32", 0), **_tol("float32"))
    h = transformer._embed_tokens(tcfg, tparams, torch.from_numpy(batch["tokens"]))
    tree = _numpy_params(1)
    want = sum(tree["embed"][k][batch["tokens"][..., k]]
               for k in range(tcfg.num_codebooks))
    assert_allclose(_np(h), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_then_decode_match_jax(dtype):
    """Prefill after a 4-frame prefix (the reference's KV cache padded along
    the sequence axis as its engine pads it), then three greedy decode steps
    of (B, K) tokens: each step's (B, K, V) logits and the caches."""
    jcfg, tcfg, jparams, tparams = _configs(dtype)
    batch = _batch(jcfg, P)
    n0 = P + S
    jl, jcache = jax_prefill(jcfg, jparams, _jax(batch))
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
              for k, v in jcache.items()}
    tcache = init_decode_state(tcfg, B, n0 + 3, device="cpu")
    tl, tcache = prefill(tcfg, tparams, _torch(batch), cache=tcache)
    assert tl.shape == (B, tcfg.num_codebooks, tcfg.vocab_size)
    assert_allclose(_np(tl), _np(jl), **_tol(dtype))
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)  # (B, K)
        assert tok.shape == (B, tcfg.num_codebooks)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(n0 + i))
        tl, tcache = decode_step(tcfg, tparams, tcache, torch.from_numpy(tok),
                                 n0 + i)
        assert_allclose(_np(tl), _np(jl), **_tol(dtype), err_msg=f"step {i}")
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert_allclose(_np(tcache[k]), _np(jcache[k]), **_tol(dtype))


def test_decode_matches_forward_fp32_in_both_packages():
    jcfg, tcfg, jparams, tparams = _configs()
    tokens = _batch(tcfg)["tokens"]
    lf_t, _ = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    lf_j, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    tcache = init_decode_state(tcfg, B, S, device="cpu")
    jcache = jax_init_decode_state(jcfg, B, S)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    errs_t, errs_j = [], []
    for t in range(S):
        lt, tcache = decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(tokens[:, t]), t)
        lj, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]),
                           jnp.int32(t))
        errs_t.append(float((lt - lf_t[:, t]).abs().max()))
        errs_j.append(float(jnp.max(jnp.abs(lj - lf_j[:, t]))))
    assert max(errs_t) < 1e-4, errs_t
    assert max(errs_j) < 1e-4, errs_j


def _jax_loss_and_grads(jcfg, jparams, batch):
    return jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, _jax(batch)), has_aux=True))(jparams)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_loss_and_grads_match_jax(prefix):
    """``loss_fn`` (remat on in both packages) and its gradients against
    ``jax.value_and_grad``: loss rtol 1e-5, each leaf rtol 1e-4 with atol
    1e-4 of its largest element (as tests/test_torch_train.py)."""
    jcfg, tcfg, jparams, tparams = _configs()
    assert jcfg.remat and tcfg.remat
    batch = _batch(jcfg, prefix)
    (jloss, jm), jgrads = _jax_loss_and_grads(jcfg, jparams, batch)
    loss, metrics, grads = loss_and_grads(tcfg, tparams, _torch(batch))
    assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_allclose(float(metrics["ce_loss"]), float(jm["ce_loss"]), rtol=1e-5)
    assert float(metrics["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    flat = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat) == len(tree_leaves(grads))
    for (path, want), got in zip(flat, tree_leaves(grads)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert_allclose(_np(got), want, rtol=1e-4,
                        atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                        err_msg=jax.tree_util.keystr(path))


def test_loss_is_one_mean_over_every_codebook_position():
    """The CE is one mean over the B·(S-1)·K token positions after the
    prefix, each position's logits against the next frame's token of its
    codebook, as the reference's reshape to (B, (S-1)·K, V) gives."""
    _, tcfg, _, tparams = _configs()
    batch = _batch(tcfg, P)
    with torch.no_grad():
        loss, metrics = loss_fn(tcfg, tparams, _torch(batch))
        logits, _ = forward(tcfg, tparams, _torch(batch))
    lg = _np(logits)[:, P:][:, :-1].astype(np.float64)  # (B, S-1, K, V)
    labels = batch["tokens"][:, 1:]                     # (B, S-1, K)
    m = lg.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(lg - m).sum(-1, keepdims=True)))[..., 0]
    nll = lse - np.take_along_axis(lg, labels[..., None], -1)[..., 0]
    assert nll.shape == (B, S - 1, tcfg.num_codebooks)
    assert_allclose(float(loss), nll.mean(), rtol=1e-6)
    assert float(metrics["ce_loss"]) == float(loss)


def test_train_step_matches_jax():
    """One AdamW step of ``make_train_step`` in each package, remat on, two
    microbatches cut from the leading axis of the (B, S, K) tokens and of
    the 4-frame prefix: the metrics at rtol 1e-5 and the moments at the
    gradients' tolerance (``m``) and twice it (``v``), as
    tests/test_torch_mamba2.py."""
    jcfg, tcfg, jparams, tparams = _configs()
    batch = _batch(jcfg, P)
    opt = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    _jnew, jopt, jm = jax.jit(jax_make_train_step(
        jcfg, JaxOptimizerConfig(**opt), JaxStepConfig(microbatches=2)))(
        jparams, jax_init_opt_state(jparams), _jax(batch))
    _tnew, topt, tm = make_train_step(
        tcfg, OptimizerConfig(**opt), StepConfig(microbatches=2))(
        tparams, init_opt_state(tparams), _torch(batch))
    assert int(topt["step"]) == int(jopt["step"]) == 1
    for k in ("loss", "grad_norm", "lr"):
        assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for moment, tol in (("m", 1e-4), ("v", 2e-4)):
        flat = jax.tree_util.tree_leaves_with_path(jopt[moment])
        assert len(flat) == len(tree_leaves(topt[moment]))
        for (path, want), got in zip(flat, tree_leaves(topt[moment])):
            want = np.asarray(want)
            assert_allclose(_np(got), want, rtol=tol,
                            atol=tol * max(float(np.abs(want).max()), 1e-30),
                            err_msg=moment + jax.tree_util.keystr(path))


def test_one_microbatch_step_takes_contiguous_gradients():
    """With one microbatch the step hands the gradients themselves to the
    in-place AdamW update, which takes contiguous tensors only: the K
    heads' (K, D, V) gradient among them. The step's loss equals two
    microbatches' mean on the same batch."""
    _, tcfg, _, tparams = _configs()
    batch = _torch(_batch(tcfg, P))
    _, _, grads = loss_and_grads(tcfg, tparams, batch)
    assert all(g.is_contiguous() for g in tree_leaves(grads))
    opt = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    losses = []
    for n in (1, 2):
        params = convert.params_from_numpy(_numpy_params(1), device="cpu")
        _, topt, tm = make_train_step(tcfg, OptimizerConfig(**opt),
                                      StepConfig(microbatches=n))(
            params, init_opt_state(params), batch)
        assert int(topt["step"]) == 1
        losses.append(float(tm["loss"]))
    assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_remat_on_and_off_give_the_same_loss_and_grads():
    out = {}
    for remat in (True, False):
        _, tcfg, _, tparams = _configs(remat=remat)
        out[remat] = loss_and_grads(tcfg, tparams, _torch(_batch(tcfg, P)))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Twins of tests/test_models_smoke.py's audio cases
# ---------------------------------------------------------------------------

def _smoke_batch(cfg, n=24):
    """tests/test_models_smoke.py's ``_batch``: seeded (B, 24, K) tokens
    and a 4-frame prefix of 0.01."""
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, n, cfg.num_codebooks)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens),
            "frontend_embeds": torch.full((B, 4, cfg.d_model), 0.01)}


def test_smoke_forward_shapes_and_finite():
    cfg = get_smoke_config("musicgen_medium")
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    logits, aux = forward(cfg, params, _smoke_batch(cfg))
    assert tuple(logits.shape) == (B, 24 + 4, cfg.num_codebooks, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(aux))


def test_smoke_one_train_step():
    cfg = get_smoke_config("musicgen_medium")
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
    assert int(new_opt["step"]) == 1
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(before, tree_leaves(new_params))]
    assert max(moved) > 0


def test_smoke_decode_step():
    cfg = get_smoke_config("musicgen_medium")
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    st = init_decode_state(cfg, B, 16, device="cpu")
    tok = torch.zeros((B, cfg.num_codebooks), dtype=torch.int64)
    logits, st2 = decode_step(cfg, params, st, tok, 0)
    assert tuple(logits.shape) == (B, cfg.num_codebooks, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert set(st2) == set(st) == {"k", "v"}
