"""The port's RWKV6 family and its WKV6 plain version against the JAX
package, on the rwkv6-3b smoke config, on the CPU.

Inputs are drawn once with numpy and handed to both packages; the JAX
weights go over through ``repro_torch.convert``, with the leaves that JAX
initialises to zero or one (``u``, ``w0``, the token-shift mixes, the norm
scales) drawn at random so that every path carries weight. Tolerances as in
the reference's own tests: the WKV6 sweep of tests/test_kernels.py (y 2e-4
fp32 / 6e-2 bf16, state 2e-4), whole models fp32 1e-4
(tests/test_models_smoke.py) and bf16 atol = rtol = 4e-2.

In bf16 the whole model is not held to 4e-2 element by element, because
the JAX package is not within 4e-2 of itself: its scanned forward and the
same layers run op by op (XLA rounds fused elementwise chains, ``silu``'s
logistic among them, at other places) differ by up to 1.66x that tolerance
in the worst element of the smoke logits (seeds 1-8), and each bf16
evaluation is 2-3.5% of the logits' RMS from the fp32 logits. So the bf16
parity is held two ways:
``test_bf16_forward_is_as_close_to_fp32_as_jax_itself`` holds the port's
bf16 error against JAX's own bf16 errors, and the block-by-block tests feed
each block of both packages the same input (the JAX residual stream and
state) at 4e-2. The fp32 comparisons hold the whole model at 1e-4.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import granite_8b as jax_granite  # noqa: E402
from repro.configs import rwkv6_3b as jax_rwkv  # noqa: E402
from repro.kernels.wkv6 import wkv6_fwd  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.models import decode_state_specs as jax_decode_state_specs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_decode_state as jax_init_decode_state  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro.models.common import rms_norm as jax_rms_norm  # noqa: E402
from repro.models.rwkv6 import wkv6_chunked as jax_wkv6_chunked  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import granite_8b, rwkv6_3b  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.models import (decode_state_specs, decode_step,  # noqa: E402
                                forward, init_decode_state, prefill, rwkv6)
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.serve.engine import serving_params  # noqa: E402

B, S = 2, 10
DTYPES = ["float32", "bfloat16"]
#: leaves JAX initialises to a constant, drawn here as N(0, 1) * scale
_RANDOMISED = {"u": 0.5, "w0": 1.0, "mu_base": 0.5, "mu_rkvgw": 0.5,
               "cm_mu_k": 0.5, "cm_mu_r": 0.5, "tm_norm": 0.2, "ln_x": 0.2,
               "cm_norm": 0.2}


def _tol(dtype):
    return dict(atol=4e-2, rtol=4e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(x, dtype):
    """numpy fp32 -> (JAX array, CPU tensor), rounded alike to ``dtype``."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _numpy_params(seed):
    cfg = jax_rwkv.SMOKE_CONFIG
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax_param_specs(cfg), seed=seed))
    rng = np.random.default_rng(seed)
    for name, scale in _RANDOMISED.items():
        leaf = tree["layers"][name]
        base = 1.0 if name.endswith("norm") or name == "ln_x" else 0.0
        tree["layers"][name] = (base + scale * rng.standard_normal(leaf.shape)
                                ).astype(np.float32)
    return tree


def _configs(dtype, seed=1):
    """(jax cfg, port cfg, jax params, port params) for rwkv6-3b smoke."""
    jcfg = jax_rwkv.SMOKE_CONFIG.replace(compute_dtype=dtype)
    tcfg = rwkv6_3b.SMOKE_CONFIG.replace(compute_dtype=dtype)
    tree = _numpy_params(seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, device="cpu")


def _tokens(vocab):
    return (np.arange(B * S).reshape(B, S) * 5 % vocab).astype(np.int32)


def _wkv_inputs(rng, shape, dtype, w_dtype="float32"):
    """The sweep's inputs of tests/test_kernels.py, drawn with numpy."""
    Bq, Sq, H, dh = shape
    r, k, v = (rng.standard_normal(shape) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal(shape) * 0.5))
    u = rng.standard_normal((H, dh)) * 0.3
    return ([_pair(x, dtype) for x in (r, k, v)] + [_pair(w, w_dtype)]
            + [_pair(u, "float32")])


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bq,Sq,H,dh,chunk", [
    (2, 45, 3, 16, 16),
    (1, 64, 2, 32, 32),
    (2, 17, 4, 8, 8),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_plain_matches_pallas_and_ref(Bq, Sq, H, dh, chunk, dtype):
    rng = np.random.default_rng(5)
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu) = _wkv_inputs(
        rng, (Bq, Sq, H, dh), dtype)
    y, state = wkv6(tr, tk, tv, tw, tu, chunk)
    assert y.dtype == tr.dtype and y.shape == tr.shape and y.is_contiguous()
    assert state.dtype == torch.float32 and state.shape == (Bq, H, dh, dh)
    py, ps = wkv6_fwd(jr, jk, jv, jw, ju, chunk=chunk, interpret=True)
    ry, rs = jax_wkv6_ref(jr, jk, jv, jw, ju)
    ty, ts = wkv6_ref(tr, tk, tv, tw, tu)  # the port's per-step oracle
    ytol = dict(atol=6e-2, rtol=6e-2) if dtype == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)
    stol = dict(atol=2e-4, rtol=2e-4)
    for want_y, want_s in ((py, ps), (ry, rs)):
        assert_allclose(_np(y), _np(want_y), **ytol)
        assert_allclose(_np(state), _np(want_s), **stol)
    assert_allclose(_np(ty), _np(ry), **ytol)
    assert_allclose(_np(ts), _np(rs), **stol)


@pytest.mark.parametrize("Bq,Sq,H,dh,chunk", [
    (2, 45, 3, 16, 16),   # S fills no chunk
    (1, 1, 2, 16, 8),     # one token
    (2, 70, 2, 32, 64),   # more than one chunk, ragged tail
])
def test_wkv6_plain_matches_jax_wkv6_chunked_with_bf16_decay(Bq, Sq, H, dh,
                                                             chunk):
    """As prefill calls it: r, k, v, w all bf16, w drawn from the model's
    exp(-exp(clip(., -8, 4))) so that some w fall below the 1e-12 clamp."""
    rng = np.random.default_rng(6)
    shape = (Bq, Sq, H, dh)
    r, k, v = (_pair(rng.standard_normal(shape) * 0.5, "bfloat16")
               for _ in range(3))
    w = _pair(np.exp(-np.exp(np.clip(rng.standard_normal(shape) * 3, -8, 4))),
              "bfloat16")
    u = _pair(rng.standard_normal((H, dh)) * 0.3, "float32")
    assert float(w[1].float().min()) < 1e-12  # the clamp is exercised
    y, state = wkv6(r[1], k[1], v[1], w[1], u[1], chunk)
    jy, js = jax_wkv6_chunked(r[0], k[0], v[0], w[0], u[0], chunk)
    assert_allclose(_np(y), _np(jy), atol=6e-2, rtol=6e-2)
    assert_allclose(_np(state), _np(js), atol=2e-4, rtol=2e-4)


def test_wkv6_state_is_indexed_k_i_v_j():
    """state[b, h, i, j] accumulates k_i v_j: one step from a zero state is
    the outer product k v^T, not its transpose."""
    shape = (1, 1, 1, 16)
    r = torch.zeros(shape)
    k = torch.zeros(shape)
    v = torch.zeros(shape)
    k[..., 2] = 1.0
    v[..., 5] = 3.0
    w = torch.full(shape, 0.5)
    _, state = wkv6(r, k, v, w, torch.zeros(1, 16), 8)
    want = torch.zeros(1, 1, 16, 16)
    want[0, 0, 2, 5] = 3.0
    assert torch.equal(state, want)


def test_cpu_tensors_take_the_plain_wkv6_and_launch_nothing():
    rng = np.random.default_rng(7)
    kcommon.reset_launches()
    ins = [t for _, t in _wkv_inputs(rng, (1, 9, 2, 16), "bfloat16", "bfloat16")]
    wkv6(*ins, 8)
    assert "wkv6" in kcommon.KERNELS
    assert kcommon.launches == {name: 0 for name in kcommon.KERNELS}


def test_wkv6_spans_leave_the_values_alone():
    """With the tracer on, the WKV6 call and rule are device spans; y and
    every gradient are bit for bit those of a run with the tracer off."""
    from repro_torch.obs.tracer import TRACER, disable_tracing, enable_tracing
    rng = np.random.default_rng(11)
    base = [t for _, t in _wkv_inputs(rng, (2, 24, 2, 16), "bfloat16", "bfloat16")]
    g = torch.from_numpy(rng.standard_normal((2, 24, 2, 16))).to(torch.bfloat16)

    def run():
        ins = [t.clone().requires_grad_() for t in base]
        y, _ = wkv6(*ins, 8)
        return [y.detach()] + list(torch.autograd.grad(y, ins, g))

    off = run()
    TRACER.clear()
    enable_tracing()
    try:
        on = run()
        names = [s.name for s in TRACER.spans()]
    finally:
        disable_tracing()
        TRACER.clear()
    assert names == ["wkv6.forward", "wkv6.backward"]
    assert all(torch.equal(a, b) for a, b in zip(off, on))


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_config_asdict_matches_jax(which):
    jcfg, tcfg = getattr(jax_rwkv, which), getattr(rwkv6_3b, which)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert str(tcfg.cdtype).removeprefix("torch.") == jcfg.cdtype.name


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_param_count_matches_jax(which):
    jcfg, tcfg = getattr(jax_rwkv, which), getattr(rwkv6_3b, which)
    assert tcfg.param_count() == jcfg.param_count()
    if which == "CONFIG":
        assert 2.5e9 <= tcfg.param_count() <= 3.5e9


def test_registry_lists_rwkv6_3b_under_its_alias():
    cfg = get_config("rwkv6-3b")
    assert cfg is rwkv6_3b.CONFIG
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == \
        (32, 2560, 8960, 65536)
    assert cfg.d_model // cfg.rwkv_head_dim == 40


# ---------------------------------------------------------------------------
# The model against JAX
# ---------------------------------------------------------------------------

def test_forward_matches_jax():
    jcfg, tcfg, jparams, tparams = _configs("float32")
    tokens = _tokens(jcfg.vocab_size)
    jl, jaux = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    tl, taux = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (B, S, tcfg.vocab_size) and tl.dtype == tcfg.cdtype
    assert_allclose(_np(tl), _np(jl), **_tol("float32"))
    assert float(taux) == float(jaux) == 0.0


def test_prefill_logits_and_state_match_jax():
    jcfg, tcfg, jparams, tparams = _configs("float32")
    tokens = _tokens(jcfg.vocab_size)
    jl, jstate = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    tl, tstate = prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert_allclose(_np(tl), _np(jl), **_tol("float32"))
    assert sorted(tstate) == sorted(jstate) == ["cm_shift", "tm_shift", "wkv"]
    for name in tstate:
        assert tuple(tstate[name].shape) == jstate[name].shape, name
        assert_allclose(_np(tstate[name]), _np(jstate[name]),
                        **_tol("float32"), err_msg=name)


def test_decode_steps_match_jax():
    jcfg, tcfg, jparams, tparams = _configs("float32")
    tokens = _tokens(jcfg.vocab_size)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    jstate = jax_init_decode_state(jcfg, B, S)
    tstate = init_decode_state(tcfg, B, S, device="cpu")
    for t in range(S):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(tokens[:, t]),
                           jnp.int32(t))
        tl, tstate = decode_step(tcfg, tparams, tstate,
                                 torch.from_numpy(tokens[:, t]), t)
        assert_allclose(_np(tl), _np(jl), **_tol("float32"),
                        err_msg=f"step {t}")
    for name in tstate:
        assert_allclose(_np(tstate[name]), _np(jstate[name]),
                        **_tol("float32"), err_msg=name)


def _to_torch(x):
    return convert.params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"]


@pytest.mark.parametrize("layer", [0, 1])
def test_bf16_prefill_blocks_match_jax_from_the_same_input(layer):
    """Each block of prefill in bf16 from the JAX residual stream: the time
    mix's output, last normed input and WKV state, the channel mix's output
    and last normed input, and (after the last layer) the logits."""
    jcfg, tcfg, jparams, tparams = _configs("bfloat16")
    tokens = _tokens(jcfg.vocab_size)
    jh = jnp.take(jparams["embed"], jnp.asarray(tokens), axis=0
                  ).astype(jnp.bfloat16)
    for i in range(layer + 1):
        jlp = jax.tree_util.tree_map(lambda a: a[i], jparams["layers"])
        h_in = jh
        jout, (jtm, jwkv) = jax_rwkv6.time_mix(jcfg, jlp, h_in,
                                               return_state=True)
        jh = h_in + jout
        jout2, jcm = jax_rwkv6.channel_mix(jcfg, jlp, jh, return_state=True)
        jh_out = jh + jout2
        if i < layer:
            jh = jh_out
    tlp = {k: v[layer] for k, v in tparams["layers"].items()}
    tout, (ttm, twkv) = rwkv6.time_mix(tcfg, tlp, _to_torch(h_in),
                                       return_state=True)
    tout2, tcm = rwkv6.channel_mix(tcfg, tlp, _to_torch(jh),
                                   return_state=True)
    for name, got, want in (("time mix", tout, jout), ("tm_shift", ttm, jtm),
                            ("wkv", twkv, jwkv), ("channel mix", tout2, jout2),
                            ("cm_shift", tcm, jcm)):
        assert got.dtype == _to_torch(want).dtype, name
        assert_allclose(_np(got), _np(want), **_tol("bfloat16"), err_msg=name)
    if layer == jcfg.num_layers - 1:
        jl, _ = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
        th = rms_norm(_to_torch(jh_out)[:, -1:].contiguous(),
                      tparams["final_norm"], tcfg.norm_eps)
        tl = (th @ tparams["unembed"].to(torch.bfloat16))[:, 0]
        wl = jax_rms_norm(jh_out[:, -1:], jparams["final_norm"],
                          jcfg.norm_eps) @ jparams["unembed"].astype(jnp.bfloat16)
        assert_allclose(_np(tl), _np(wl[:, 0]), **_tol("bfloat16"))
        assert jl.shape == tuple(tl.shape)


def _jax_op_by_op_forward(cfg, params, tokens):
    """JAX ``forward`` with the layer scan unrolled and every op dispatched
    on its own (no jit), so XLA fuses nothing: the same function, rounded
    at other places."""
    h = jnp.take(params["embed"], tokens, axis=0).astype(cfg.cdtype)
    for i in range(cfg.num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
        h = h + jax_rwkv6.time_mix(cfg, lp, h)
        h = h + jax_rwkv6.channel_mix(cfg, lp, h)
    h = jax_rms_norm(h, params["final_norm"], cfg.norm_eps)
    return jnp.einsum("bsd,dv->bsv", h, params["unembed"].astype(cfg.cdtype))


def _rel_rms(got, want):
    """RMS of got - want over the RMS of want."""
    got, want = _np(got), _np(want)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


#: the port's bf16 logits against JAX's: over seeds 1-8 (this test's print)
#: the port's error from the fp32 logits is 0.81-1.02x the larger of JAX's
#: two bf16 evaluations' errors, and its distance from JAX's scanned
#: forward is 1.12-1.43x the distance between JAX's two evaluations
BF16_ERR_OF_JAX_ERR = 1.1
BF16_GAP_OF_JAX_GAP = 1.6


@pytest.mark.parametrize("seed", range(1, 9))
def test_bf16_forward_is_as_close_to_fp32_as_jax_itself(seed):
    """The whole model in bf16 against JAX: the port's bf16 logits are as
    close to the fp32 logits as JAX's own bf16 logits are, and as close to
    JAX's scanned bf16 forward as JAX's op-by-op evaluation of the same
    function is, each up to the stated factor. A wrong block or a dropped
    term shows as an error many times JAX's own."""
    jcfg, tcfg, jparams, tparams = _configs("bfloat16", seed)
    jcfg32, _, jparams32, _ = _configs("float32", seed)
    tokens = _tokens(jcfg.vocab_size)
    truth, _ = jax_forward(jcfg32, jparams32, {"tokens": jnp.asarray(tokens)})
    scanned, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    op_by_op = _jax_op_by_op_forward(jcfg, jparams, jnp.asarray(tokens))
    port, _ = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert port.dtype == torch.bfloat16 and torch.isfinite(port.float()).all()
    jax_err = max(_rel_rms(scanned, truth), _rel_rms(op_by_op, truth))
    port_err = _rel_rms(port, truth)
    jax_gap, port_gap = _rel_rms(op_by_op, scanned), _rel_rms(port, scanned)
    worst = [float((np.abs(_np(x) - _np(scanned)) / (4e-2 + 4e-2 * np.abs(
        _np(scanned)))).max()) for x in (op_by_op, port)]
    print(f"seed {seed}: relative RMS error from fp32, JAX {jax_err:.4f} port "
          f"{port_err:.4f} ({port_err / jax_err:.2f}x); from JAX scanned, "
          f"JAX op by op {jax_gap:.4f} port {port_gap:.4f} "
          f"({port_gap / jax_gap:.2f}x); worst element from JAX scanned at "
          f"{worst[0]:.2f}x (JAX op by op) and {worst[1]:.2f}x (port) of "
          f"atol = rtol = 4e-2")
    assert port_err <= BF16_ERR_OF_JAX_ERR * jax_err, (port_err, jax_err)
    assert port_gap <= BF16_GAP_OF_JAX_GAP * jax_gap, (port_gap, jax_gap)


@pytest.mark.parametrize("layer", [0, 1])
def test_bf16_decode_state_matches_jax_from_the_same_state(layer):
    """Ten bf16 decode steps of a one-layer cut (layer ``layer`` of the smoke
    weights), each step of both packages started from the JAX state: the
    three state leaves it leaves behind."""
    jcfg, tcfg, jparams, tparams = _configs("bfloat16")
    jcfg, tcfg = jcfg.replace(num_layers=1), tcfg.replace(num_layers=1)

    def cut(tree):
        return {**tree, "layers": {k: v[layer:layer + 1]
                                   for k, v in tree["layers"].items()}}

    jparams, tparams = cut(jparams), cut(tparams)
    tokens = _tokens(jcfg.vocab_size)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    jstate = jax_init_decode_state(jcfg, B, S)
    for t in range(S):
        tstate = {k: _to_torch(v) for k, v in jstate.items()}
        _, jstate = jstep(jparams, jstate, jnp.asarray(tokens[:, t]),
                          jnp.int32(t))
        tl, tstate = decode_step(tcfg, tparams, tstate,
                                 torch.from_numpy(tokens[:, t]), t)
        assert tl.dtype == torch.bfloat16 and torch.isfinite(tl.float()).all()
        for name in tstate:
            assert_allclose(_np(tstate[name]), _np(jstate[name]),
                            **_tol("bfloat16"), err_msg=f"{name}, step {t}")


def test_decode_matches_forward_fp32():
    _, tcfg, _, tparams = _configs("float32")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size))
    lf, _ = forward(tcfg, tparams, {"tokens": tokens})
    state = init_decode_state(tcfg, B, S, device="cpu")
    errs = []
    for t in range(S):
        lg, state = decode_step(tcfg, tparams, state, tokens[:, t], t)
        errs.append(float((lg - lf[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_prefill_then_decode_matches_forward_fp32():
    """The state prefill leaves is the state decode continues from."""
    _, tcfg, _, tparams = _configs("float32")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size))
    lf, _ = forward(tcfg, tparams, {"tokens": tokens})
    lp, state = prefill(tcfg, tparams, {"tokens": tokens[:, :6]})
    errs = [float((lp - lf[:, 5]).abs().max())]
    for t in range(6, S):
        lg, state = decode_step(tcfg, tparams, state, tokens[:, t], t)
        errs.append(float((lg - lf[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_prefill_writes_into_a_given_state():
    _, tcfg, _, tparams = _configs("float32")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size))
    _, own = prefill(tcfg, tparams, {"tokens": tokens})
    state = init_decode_state(tcfg, B, 64, device="cpu")
    _, same = prefill(tcfg, tparams, {"tokens": tokens}, cache=state)
    assert same is state
    for name in own:
        assert torch.equal(state[name], own[name]), name


@pytest.mark.parametrize("arch", ["granite", "rwkv"])
def test_decode_state_specs_match_jax(arch):
    jmod, tmod = {"granite": (jax_granite, granite_8b),
                  "rwkv": (jax_rwkv, rwkv6_3b)}[arch]
    tcfg = tmod.SMOKE_CONFIG
    jspecs = jax_decode_state_specs(jmod.SMOKE_CONFIG, 3, 12)
    tspecs = decode_state_specs(tcfg, 3, 12)
    assert sorted(tspecs) == sorted(jspecs)
    for name, (shape, dtype) in tspecs.items():
        assert shape == jspecs[name][0].shape, name
        assert str(dtype).removeprefix("torch.") == jspecs[name][0].dtype.name
    state = init_decode_state(tcfg, 3, 12, device="cpu")
    assert all(torch.all(t == 0) for t in state.values())


def test_serving_cast_gives_the_logits_of_cast_on_use():
    """Casting the leaves JAX casts on use once, at load, changes no bit."""
    _, tcfg, _, tparams = _configs("bfloat16")
    cast = serving_params(tcfg, tparams, torch.device("cpu"))
    layers = cast["layers"]
    for name in ("w_r", "w_o", "mix_w2", "mu_rkvgw", "decay_w1", "cm_k",
                 "cm_mu_r"):
        assert layers[name].dtype == torch.bfloat16, name
    for name in ("w0", "u", "tm_norm", "ln_x", "cm_norm"):
        assert layers[name].dtype == torch.float32, name
    assert cast["embed"].dtype == cast["unembed"].dtype == torch.bfloat16
    assert cast["final_norm"].dtype == torch.float32
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size))
    want, want_state = prefill(tcfg, tparams, {"tokens": tokens})
    got, got_state = prefill(tcfg, cast, {"tokens": tokens})
    assert torch.equal(got, want)
    tok = torch.argmax(got, -1)
    assert torch.equal(decode_step(tcfg, cast, got_state, tok, S)[0],
                       decode_step(tcfg, tparams, want_state, tok, S)[0])


def test_init_decode_state_defaults_to_cuda_and_raises_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (rwkv6_3b.SMOKE_CONFIG, granite_8b.SMOKE_CONFIG):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_decode_state(cfg, 1, 4)
