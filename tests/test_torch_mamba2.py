"""The port's Mamba2 / Zamba2 hybrid family against the JAX package, on the
zamba2-7b smoke config, on the CPU: ``models/mamba2.py`` function by
function (the SSD scan, its single-token step, the causal conv, the Mamba2
block with and without decode states), then the whole model (forward,
prefill, decode after prefill, ``loss_fn`` and its gradients, one train
step), and twins of tests/test_models_smoke.py's zamba2 cases.

The same numpy inputs and weights (through ``repro_torch.convert``) go to
both packages, with the leaves the packages initialise to a constant (``A_log``, ``dt_bias``, ``D_skip``, ``conv_b``,
the norm scales) drawn at random so that every path carries weight.
Tolerances: fp32 1e-4 (as tests/test_models_smoke.py), bf16 atol = rtol =
4e-2 (as tests/test_kernels.py); the SSD states stay fp32 in both dtypes
and are held at 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import zamba2_7b as jax_zamba  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.train.optimizer import init_opt_state as jax_init_opt_state  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import StepConfig as JaxStepConfig  # noqa: E402
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import zamba2_7b  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.models import (decode_state_specs, decode_step,  # noqa: E402
                                forward, init_decode_state, init_params,
                                loss_fn, mamba2, param_specs, prefill)
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serve.engine import ServeEngine, serving_params  # noqa: E402
from repro_torch.train import (OptimizerConfig, StepConfig,  # noqa: E402
                               init_opt_state, loss_and_grads, make_train_step)

B, S = 2, 10
DTYPES = ["float32", "bfloat16"]
#: leaves initialised to a constant, drawn here as base + N(0, 1) * scale
_RANDOMISED = {"A_log": (0.0, 0.5), "dt_bias": (0.0, 0.5),
               "D_skip": (1.0, 0.5), "conv_b": (0.0, 0.1),
               "norm": (1.0, 0.2), "out_norm": (1.0, 0.2)}
_SHARED_RANDOMISED = {"attn_norm": (1.0, 0.2), "mlp_norm": (1.0, 0.2)}


def _tol(dtype):
    return dict(atol=4e-2, rtol=4e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=0)


STATE_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(x, dtype="float32"):
    """numpy fp32 -> (JAX array, CPU tensor), rounded alike to ``dtype``."""
    x = np.asarray(x, np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@functools.lru_cache(maxsize=None)
def _numpy_params(seed):
    """The smoke model's weights as a numpy tree, drawn by the port's
    ``init_params`` (the JAX package's draws leaf by leaf take seconds)."""
    tree = convert.params_to_numpy(init_params(
        param_specs(zamba2_7b.SMOKE_CONFIG), seed=seed, device="cpu"))
    rng = np.random.default_rng(seed)
    for group, names in (("mamba", _RANDOMISED),
                         ("shared_attn", _SHARED_RANDOMISED)):
        for name, (base, scale) in names.items():
            shape = tree[group][name].shape
            tree[group][name] = (base + scale * rng.standard_normal(shape)
                                 ).astype(np.float32)
    tree["final_norm"] = (1.0 + 0.2 * rng.standard_normal(
        tree["final_norm"].shape)).astype(np.float32)
    return tree


def _configs(dtype="float32", seed=1, **kw):
    """(jax cfg, port cfg, jax params, port params) for zamba2-7b smoke."""
    jcfg = jax_zamba.SMOKE_CONFIG.replace(compute_dtype=dtype, **kw)
    tcfg = zamba2_7b.SMOKE_CONFIG.replace(compute_dtype=dtype, **kw)
    tree = _numpy_params(seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, device="cpu")


def _tokens(vocab, n=S):
    return (np.arange(B * n).reshape(B, n) * 5 % vocab).astype(np.int32)


def _layer0(jparams, tparams):
    return ({k: v[0] for k, v in jparams["mamba"].items()},
            {k: v[0] for k, v in tparams["mamba"].items()})


def _ssd_inputs(rng, Sq, dtype, Hs=3, P=16, N=8):
    """The SSD scan's inputs as ``mamba_block`` makes them: x, B, C in the
    compute dtype, dt = softplus(.) and a_log = -dt A in fp32."""
    x = rng.standard_normal((B, Sq, Hs, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, Sq, Hs))))
    A = np.exp(0.5 * rng.standard_normal(Hs))
    Bc, Cc = (rng.standard_normal((B, Sq, N)) for _ in range(2))
    D_skip = 1.0 + 0.5 * rng.standard_normal(Hs)
    return (_both(x, dtype), _both(dt), _both(-dt * A), _both(Bc, dtype),
            _both(Cc, dtype), _both(D_skip))


# ---------------------------------------------------------------------------
# The SSD scan, its step, the conv, the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq", [16, 10, 3])   # two whole chunks; ragged; < 1
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_matches_jax(Sq, with_state, dtype):
    rng = np.random.default_rng(3)
    ins = _ssd_inputs(rng, Sq, dtype)
    s0 = (_both(rng.standard_normal((B, 3, 8, 16))) if with_state
          else (None, None))
    jy, js = jax_mamba2.ssd_chunked(*(j for j, _ in ins), 8, state0=s0[0])
    ty, ts = mamba2.ssd_chunked(*(t for _, t in ins), 8, state0=s0[1])
    assert ty.dtype == ins[0][1].dtype and ty.is_contiguous()
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (B, 3, 8, 16)
    assert_allclose(_np(ty), _np(jy), **_tol(dtype))
    assert_allclose(_np(ts), _np(js), **STATE_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_step_matches_jax_and_ssd_chunked_at_one_token(dtype):
    rng = np.random.default_rng(4)
    ins = _ssd_inputs(rng, 1, dtype)
    s0 = _both(rng.standard_normal((B, 3, 8, 16)))
    step_ins = [t[:, 0] for _, t in ins[:5]] + [ins[5][1]]
    ty, ts = mamba2.ssd_step(*step_ins, s0[1])
    jy, js = jax_mamba2.ssd_step(*([j[:, 0] for j, _ in ins[:5]] + [ins[5][0]]),
                                 s0[0])
    cy, cs = mamba2.ssd_chunked(*(t for _, t in ins), 8, state0=s0[1])
    assert_allclose(_np(ty), _np(jy), **_tol(dtype))
    assert_allclose(_np(ts), _np(js), **STATE_TOL)
    assert_allclose(_np(ty), _np(cy[:, 0]), **_tol(dtype))
    assert_allclose(_np(ts), _np(cs), **STATE_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(5)
    seq, w, b = (_both(rng.standard_normal(s), dtype)
                 for s in ((B, 9, 12), (4, 12), (12,)))
    got = mamba2._causal_conv(seq[1], w[1], b[1])
    assert_allclose(_np(got), _np(jax_mamba2._causal_conv(seq[0], w[0], b[0])),
                    **_tol(dtype))


@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("Sq", [S, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_matches_jax(with_states, Sq, dtype):
    """One layer on the same input, with the decode states it carries (the
    conv's last inputs, the SSD state) returned, and optionally given."""
    jcfg, tcfg, jparams, tparams = _configs(dtype)
    jlp, tlp = _layer0(jparams, tparams)
    rng = np.random.default_rng(6)
    h = _both(rng.standard_normal((B, Sq, jcfg.d_model)), dtype)
    kw_j, kw_t = {}, {}
    if with_states:
        conv = _both(rng.standard_normal((B, 3, mamba2.conv_dim(tcfg))), dtype)
        ssd = _both(rng.standard_normal((B, mamba2.n_ssm_heads(tcfg), 8, 16)))
        kw_j = dict(conv_state=conv[0], ssd_state=ssd[0])
        kw_t = dict(conv_state=conv[1], ssd_state=ssd[1])
    jout, (jconv, jssd) = jax_mamba2.mamba_block(jcfg, jlp, h[0],
                                                 return_state=True, **kw_j)
    tout, (tconv, tssd) = mamba2.mamba_block(tcfg, tlp, h[1],
                                             return_state=True, **kw_t)
    assert tout.dtype == tcfg.cdtype and tconv.dtype == tcfg.cdtype
    assert_allclose(_np(tout), _np(jout), **_tol(dtype))
    assert_allclose(_np(tssd), _np(jssd), **(STATE_TOL if dtype == "float32"
                                             else _tol(dtype)))
    if Sq >= 3 or with_states:  # the reference slices what there is
        assert_allclose(_np(tconv), _np(jconv), **_tol(dtype))
    else:                       # the port puts zeros before the sequence
        assert torch.equal(tconv[:, -Sq:],
                           torch.tensor(_np(jconv)).to(tconv.dtype))
        assert torch.all(tconv[:, :3 - Sq] == 0)
    assert torch.equal(mamba2.mamba_block(tcfg, tlp, h[1], **kw_t), tout)


def test_schedule_and_sizes_match_jax():
    for cfg in (jax_zamba.CONFIG, jax_zamba.SMOKE_CONFIG,
                jax_zamba.CONFIG.replace(num_layers=7),
                jax_zamba.CONFIG.replace(attn_every=0)):
        tcfg = zamba2_7b.CONFIG.replace(**{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
        assert mamba2._hybrid_schedule(tcfg) == jax_mamba2._hybrid_schedule(cfg)
        for fn in ("d_inner", "n_ssm_heads", "conv_dim"):
            assert getattr(mamba2, fn)(tcfg) == getattr(jax_mamba2, fn)(cfg)
    assert mamba2._hybrid_schedule(zamba2_7b.CONFIG) == (13, 6, 3)
    assert mamba2._hybrid_schedule(zamba2_7b.CONFIG.replace(num_layers=7)) \
        == (1, 6, 1)


# ---------------------------------------------------------------------------
# Parameters, config, registry, serving casts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_config_asdict_and_param_count_match_jax(which):
    jcfg, tcfg = getattr(jax_zamba, which), getattr(zamba2_7b, which)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert str(tcfg.cdtype).removeprefix("torch.") == jcfg.cdtype.name
    assert tcfg.param_count() == jcfg.param_count()


def test_registry_lists_zamba2_7b_under_its_alias():
    cfg = get_config("zamba2-7b")
    assert cfg is zamba2_7b.CONFIG and cfg.family == "hybrid"
    assert get_smoke_config("zamba2_7b") is zamba2_7b.SMOKE_CONFIG
    assert cfg.d_model // cfg.num_heads == cfg.head_dim == 112


def test_convert_carries_the_hybrid_tree_unchanged():
    """The JAX tree crosses as it is: ``mamba`` leaves stacked on a leading
    layer axis, ``shared_attn`` leaves without one, and back bit for bit."""
    tree = _numpy_params(1)
    tparams = convert.params_from_numpy(tree, device="cpu")
    specs = param_specs(zamba2_7b.SMOKE_CONFIG)
    jspecs = jax_param_specs(jax_zamba.SMOKE_CONFIG)
    assert sorted(tparams) == sorted(tree) == sorted(specs) == sorted(jspecs)
    L = zamba2_7b.SMOKE_CONFIG.num_layers
    for group in ("mamba", "shared_attn"):
        assert sorted(tparams[group]) == sorted(specs[group])
        for k, leaf in tparams[group].items():
            assert tuple(leaf.shape) == tree[group][k].shape \
                == specs[group][k].shape == jspecs[group][k].shape
            assert (leaf.shape[0] == L) == (group == "mamba"), (group, k)
    back = convert.params_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_serving_params_cast_what_jax_casts_on_use():
    cfg = zamba2_7b.SMOKE_CONFIG
    params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                             device="cpu"), torch.device("cpu"))
    bf16 = {"embed", "unembed", "mamba.in_proj", "mamba.conv_w",
            "mamba.conv_b", "mamba.out_proj", "shared_attn.wq",
            "shared_attn.wk", "shared_attn.wv", "shared_attn.wo",
            "shared_attn.w_gate", "shared_attn.w_up", "shared_attn.w_down"}
    seen = {}
    for group, sub in params.items():
        for k, v in (sub.items() if isinstance(sub, dict) else [(None, sub)]):
            seen[group if k is None else f"{group}.{k}"] = v.dtype
    assert {k for k, d in seen.items() if d == torch.bfloat16} == bf16
    assert all(d == torch.float32 for k, d in seen.items() if k not in bf16)
    with pytest.raises(ValueError, match="SSM/hybrid"):
        ServeEngine(cfg, params, max_seq=16, device="cpu")


def test_hybrid_takes_no_frontend_embeds():
    _, tcfg, _, tparams = _configs()
    batch = {"tokens": torch.from_numpy(_tokens(tcfg.vocab_size)),
             "frontend_embeds": torch.zeros(B, 2, tcfg.d_model)}
    with pytest.raises(ValueError, match="frontend_embeds"):
        forward(tcfg, tparams, batch)


# ---------------------------------------------------------------------------
# The model against JAX
# ---------------------------------------------------------------------------

def _jax_loss_and_grads(jcfg, jparams, tokens):
    return jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jparams)


@functools.lru_cache(maxsize=None)
def _jax_logits(dtype, seed=1):
    """The JAX forward's logits (fp32 numpy) of the smoke model."""
    jcfg, _, jparams, _ = _configs(dtype, seed)
    tokens = jnp.asarray(_tokens(jcfg.vocab_size))
    return _np(jax.jit(lambda p: jax_forward(jcfg, p, {"tokens": tokens})[0])(
        jparams))


def test_forward_matches_jax():
    _, tcfg, _, tparams = _configs()
    tokens = _tokens(tcfg.vocab_size)
    kcommon.reset_launches()
    tl, taux = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert kcommon.launches == {name: 0 for name in kcommon.LAUNCHES}
    assert tl.shape == (B, S, tcfg.vocab_size) and tl.dtype == tcfg.cdtype
    assert_allclose(_np(tl), _jax_logits("float32"), **_tol("float32"))
    assert float(taux) == 0.0


def test_bf16_layers_match_jax_on_the_same_inputs():
    """bf16, layer by layer: every Mamba2 block and every shared-block
    invocation of the smoke model, fed JAX's own residual stream at that
    point, against JAX's output at 4e-2. (The whole bf16 model is held in
    ``test_bf16_forward_is_as_close_to_fp32_as_jax_itself``: rounding at
    other places adds up over the 9 + 2 blocks to 3.74x and 4.19x that limit
    in the worst of 5140 logits at seeds 1 and 2, as that test prints.)"""
    jcfg, tcfg, jparams, tparams = _configs("bfloat16")
    tokens = _tokens(jcfg.vocab_size)
    jh = jnp.take(jparams["embed"], jnp.asarray(tokens), axis=0).astype(
        jcfg.cdtype)
    cos, sin = mamba2._rope(tcfg, torch.arange(S))
    jsp = jparams["shared_attn"]
    jblock = jax.jit(functools.partial(jax_mamba2.mamba_block, jcfg))
    jshared = jax.jit(functools.partial(jax_mamba2._shared_attn_block, jcfg))
    for i in range(tcfg.num_layers):
        th = torch.from_numpy(_np(jh)).to(torch.bfloat16)
        jlp = {k: v[i] for k, v in jparams["mamba"].items()}
        tlp = {k: v[i] for k, v in tparams["mamba"].items()}
        jout = jblock(jlp, jh)
        assert_allclose(_np(mamba2.mamba_block(tcfg, tlp, th)), _np(jout),
                        **_tol("bfloat16"), err_msg=f"mamba layer {i}")
        jh = jh + jout
        if mamba2._invocation(tcfg, i) is not None:
            th = torch.from_numpy(_np(jh)).to(torch.bfloat16)
            jh = jshared(jsp, jh)
            tout = mamba2._shared_attn_block(tcfg, tparams["shared_attn"], th,
                                             cos, sin)[0]
            assert_allclose(_np(tout), _np(jh), **_tol("bfloat16"),
                            err_msg=f"shared block after layer {i}")


def _rel_rms(a, b):
    a, b = _np(a), _np(b)
    return float(np.sqrt(((a - b) ** 2).mean()) / np.sqrt((b ** 2).mean()))


#: the port's bf16 logits' relative RMS error from the fp32 logits, as a
#: multiple of JAX's own bf16 error; 0.96x and 0.82x at seeds 1 and 2, as the
#: test prints
BF16_ERR_OF_JAX_ERR = 1.25


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_forward_is_as_close_to_fp32_as_jax_itself(seed):
    """The whole model in bf16: the port's logits are as close to the fp32
    logits as JAX's own bf16 logits are (about 3% relative RMS in both), up
    to BF16_ERR_OF_JAX_ERR. A wrong block or a dropped term shows as an
    error many times JAX's own."""
    _, tcfg, _, tparams = _configs("bfloat16", seed)
    tokens = _tokens(tcfg.vocab_size)
    truth, jl = _jax_logits("float32", seed), _jax_logits("bfloat16", seed)
    tl, _ = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert tl.dtype == torch.bfloat16 and torch.isfinite(tl.float()).all()
    jax_err, port_err = _rel_rms(jl, truth), _rel_rms(tl, truth)
    worst = float((np.abs(_np(tl) - jl) / (4e-2 + 4e-2 * np.abs(jl))).max())
    print(f"seed {seed}: relative RMS error from fp32, JAX {jax_err:.4f} port "
          f"{port_err:.4f} ({port_err / jax_err:.2f}x); worst logit from JAX's "
          f"bf16 at {worst:.2f}x atol = rtol = 4e-2")
    assert port_err <= BF16_ERR_OF_JAX_ERR * jax_err, (port_err, jax_err)


def test_prefill_logits_and_state_match_jax():
    jcfg, tcfg, jparams, tparams = _configs()
    tokens = _tokens(jcfg.vocab_size)
    jl, jstate = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    tl, tstate = prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert_allclose(_np(tl), _np(jl), **_tol("float32"))
    assert sorted(tstate) == sorted(jstate) == ["attn_k", "attn_v", "conv", "ssd"]
    for name in tstate:
        assert tuple(tstate[name].shape) == jstate[name].shape, name
        assert_allclose(_np(tstate[name]), _np(jstate[name]), **STATE_TOL,
                        err_msg=name)


def test_decode_steps_after_prefill_match_jax():
    """Prefill, the reference's caches padded along the sequence axis as its
    serving engine pads a KV cache, then three greedy decode steps: each
    step's logits and the final state."""
    jcfg, tcfg, jparams, tparams = _configs()
    tokens = _tokens(jcfg.vocab_size)
    jl, jstate = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    jstate = dict(jstate)
    for k in ("attn_k", "attn_v"):
        jstate[k] = jnp.pad(jstate[k], ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
    tstate = init_decode_state(tcfg, B, S + 3, device="cpu")
    tl, tstate = prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)},
                         cache=tstate)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jstate = jstep(jparams, jstate, jnp.asarray(tok), jnp.int32(S + i))
        tl, tstate = decode_step(tcfg, tparams, tstate, torch.from_numpy(tok),
                                 S + i)
        assert_allclose(_np(tl), _np(jl), **_tol("float32"), err_msg=f"step {i}")
    for k in tstate:
        assert_allclose(_np(tstate[k]), _np(jstate[k]), **STATE_TOL, err_msg=k)


def test_prefill_writes_into_a_given_state():
    _, tcfg, _, tparams = _configs()
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size))
    own_logits, own = prefill(tcfg, tparams, {"tokens": tokens})
    state = mamba2.init_state(tcfg, B, S + 6, device="cpu")
    assert all(torch.equal(state[k], v) for k, v in
               init_decode_state(tcfg, B, S + 6, device="cpu").items())
    logits, same = prefill(tcfg, tparams, {"tokens": tokens}, cache=state)
    assert same is state and torch.equal(logits, own_logits)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: shape for k, (shape, _dt) in decode_state_specs(tcfg, B, S + 6).items()}
    for k in ("conv", "ssd"):
        assert torch.equal(state[k], own[k])
    for k in ("attn_k", "attn_v"):
        assert torch.equal(state[k][:, :, :S], own[k])
        assert torch.all(state[k][:, :, S:] == 0)
    with pytest.raises(ValueError, match="positions"):
        prefill(tcfg, tparams, {"tokens": tokens},
                cache=init_decode_state(tcfg, B, S - 1, device="cpu"))




def test_loss_and_grads_match_jax():
    """``loss_fn`` (remat on in both packages, nested as the reference
    nests it) and its gradients against ``jax.value_and_grad``: loss rtol
    1e-5, each leaf rtol 1e-4 with atol 1e-4 of its largest element (as
    tests/test_torch_train.py)."""
    jcfg, tcfg, jparams, tparams = _configs()
    assert jcfg.remat and tcfg.remat
    tokens = _tokens(jcfg.vocab_size)
    (jloss, jm), jgrads = _jax_loss_and_grads(jcfg, jparams, tokens)
    loss, metrics, grads = loss_and_grads(tcfg, tparams,
                                          {"tokens": torch.from_numpy(tokens)})
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


def test_train_step_matches_jax():
    """One AdamW step of ``make_train_step`` in each package, remat on, two
    microbatches: the metrics at rtol 1e-5 and the moments it leaves, which
    are linear (``m``) and quadratic (``v``) in the clipped gradients, at
    the gradients' tolerance (rtol 1e-4, atol 1e-4 of each leaf's largest)
    and twice it. The parameters follow from the moments by the AdamW
    update, held bit for bit against the reference in
    tests/test_torch_train.py; compared here they would be ill-conditioned,
    since Adam's first step moves an element by about lr g / (|g| + eps)
    whatever its size."""
    jcfg, tcfg, jparams, tparams = _configs()
    tokens = _tokens(jcfg.vocab_size)
    opt = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    _jnew, jopt, jm = jax.jit(jax_make_train_step(
        jcfg, JaxOptimizerConfig(**opt), JaxStepConfig(microbatches=2)))(
        jparams, jax_init_opt_state(jparams), {"tokens": jnp.asarray(tokens)})
    _tnew, topt, tm = make_train_step(
        tcfg, OptimizerConfig(**opt), StepConfig(microbatches=2))(
        tparams, init_opt_state(tparams), {"tokens": torch.from_numpy(tokens)})
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


def test_remat_on_and_off_give_the_same_loss_and_grads():
    out = {}
    for remat in (True, False):
        _, tcfg, _, tparams = _configs(remat=remat)
        out[remat] = loss_and_grads(
            tcfg, tparams, {"tokens": torch.from_numpy(_tokens(tcfg.vocab_size))})
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, False])
def test_nested_remat_runs_each_norm_and_attention_as_counted(monkeypatch,
                                                              remat):
    """The launch counts a train step on the card must show, counted here as
    calls: with remat a Mamba2 layer inside a group runs forward three times
    (the forward, the group's recompute, its own recompute), the shared
    block and a tail layer twice, the final norm once."""
    _, tcfg, _, tparams = _configs(remat=remat)
    calls = {"rms_norm": 0, "attention": 0}
    for name in calls:
        def counting(*a, _fn=getattr(mamba2, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mamba2, name, counting)
    loss_and_grads(tcfg, tparams,
                   {"tokens": torch.from_numpy(_tokens(tcfg.vocab_size))})
    groups, per_group, tail = mamba2._hybrid_schedule(tcfg)
    assert (groups, per_group, tail) == (2, 4, 1)
    grouped, shared, tail_n = (3, 2, 2) if remat else (1, 1, 1)
    assert calls == {
        "rms_norm": 2 * (grouped * groups * per_group + shared * groups
                         + tail_n * tail) + 1,
        "attention": shared * groups}


# ---------------------------------------------------------------------------
# Twins of tests/test_models_smoke.py's zamba2 cases
# ---------------------------------------------------------------------------

def _smoke_tokens(cfg, n=24):
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32))


def test_smoke_forward_shapes_and_finite():
    cfg = get_smoke_config("zamba2_7b")
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    logits, aux = forward(cfg, params, {"tokens": _smoke_tokens(cfg)})
    assert tuple(logits.shape) == (B, 24, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(aux))


def test_smoke_one_train_step():
    cfg = get_smoke_config("zamba2_7b")
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    opt = init_opt_state(params)
    step_fn = make_train_step(
        cfg, OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=10),
        StepConfig(microbatches=2))
    new_params, new_opt, metrics = step_fn(params, opt,
                                           {"tokens": _smoke_tokens(cfg)})
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert float(metrics["aux_loss"]) == 0.0
    assert int(new_opt["step"]) == 1
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(before, tree_leaves(new_params))]
    assert max(moved) > 0


def test_smoke_decode_step():
    cfg = get_smoke_config("zamba2_7b")
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    st = init_decode_state(cfg, B, 16, device="cpu")
    logits, st2 = decode_step(cfg, params, st, torch.zeros(B, dtype=torch.int64), 0)
    assert bool(torch.isfinite(logits.float()).all())
    assert set(st2) == set(st) == {"conv", "ssd", "attn_k", "attn_v"}


def test_decode_matches_forward_fp32():
    cfg = get_smoke_config("zamba2_7b").replace(compute_dtype="float32")
    params = init_params(param_specs(cfg), seed=1, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg.vocab_size))
    lf, _ = forward(cfg, params, {"tokens": tokens})
    st = init_decode_state(cfg, B, S, device="cpu")
    errs = []
    for t in range(S):
        lg, st = decode_step(cfg, params, st, tokens[:, t], t)
        errs.append(float((lg - lf[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_full_config_matches_assignment():
    cfg = get_config("zamba2_7b")
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == \
        (81, 3584, 14336, 32000)
    assert cfg.ssm_state == 64 and cfg.attn_every == 6
    assert (cfg.num_heads, cfg.num_kv_heads) == (32, 32)


def test_param_count_matches_nominal_size():
    n = get_config("zamba2_7b").param_count()
    assert 6e9 <= n <= 8.5e9
    assert n == 6_751_130_832
    assert get_config("zamba2_7b").replace(num_layers=7).param_count() \
        == 980_754_096
