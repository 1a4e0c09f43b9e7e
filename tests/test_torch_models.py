"""The port's config, parameters and dense transformer against the JAX
package, on the granite-8b smoke config, on the CPU.

The same JAX-initialised weights go to both packages through numpy
(``repro_torch.convert``). Tolerances: fp32 < 1e-4 (as
tests/test_models_smoke.py), bf16 atol = rtol = 4e-2 (as tests/test_kernels.py).
"""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import granite_8b as jax_granite  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_decode_state as jax_init_decode_state  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import granite_8b  # noqa: E402
from repro_torch.models import (decode_step, forward, init_decode_state,  # noqa: E402
                                init_params, param_specs, prefill)
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 10
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(atol=4e-2, rtol=4e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=0)


def _configs(dtype, seed=1):
    """(jax cfg, port cfg, jax params, port params) for granite-8b smoke."""
    jcfg = jax_granite.SMOKE_CONFIG.replace(compute_dtype=dtype)
    tcfg = granite_8b.SMOKE_CONFIG.replace(compute_dtype=dtype)
    jparams = jax_init_params(jax_param_specs(jcfg), seed=seed)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(vocab):
    return (np.arange(B * S).reshape(B, S) * 5 % vocab).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_config_asdict_matches_jax(which):
    jcfg, tcfg = getattr(jax_granite, which), getattr(granite_8b, which)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # dtypes compared by name
    assert str(tcfg.pdtype).removeprefix("torch.") == jcfg.pdtype.name
    assert str(tcfg.cdtype).removeprefix("torch.") == jcfg.cdtype.name


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_param_count_matches_jax(which):
    jcfg, tcfg = getattr(jax_granite, which), getattr(granite_8b, which)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_port_init_uses_jax_shapes_and_fan_in_scale():
    cfg = granite_8b.SMOKE_CONFIG
    tparams = init_params(param_specs(cfg), seed=0, device="cpu")
    jparams = jax_init_params(jax_param_specs(cfg), seed=0)
    tl = {k: v for k, v in tparams["layers"].items()}
    for name, leaf in jparams["layers"].items():
        assert tuple(tl[name].shape) == leaf.shape
        assert tl[name].dtype == torch.float32
    assert torch.all(tl["attn_norm"] == 1)
    # the same fan-in scaled std as JAX (other random streams): within 10%
    for name in ("wq", "wo", "w_down"):
        ratio = float(tl[name].std()) / float(jnp.std(jparams["layers"][name]))
        assert abs(ratio - 1.0) < 0.1, (name, ratio)
    assert abs(float(tparams["embed"].std()) / 0.02 - 1.0) < 0.1


def test_convert_round_trip_keeps_paths_and_bits():
    jcfg = jax_granite.SMOKE_CONFIG
    jparams = jax_init_params(jax_param_specs(jcfg), seed=3)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["layers"]["wq"] = tree["layers"]["wq"].astype(ml_dtypes.bfloat16)
    tparams = convert.params_from_numpy(tree, device="cpu")
    assert tparams["layers"]["wq"].dtype == torch.bfloat16
    assert tparams["layers"]["attn_norm"].shape[0] == jcfg.num_layers
    back = convert.params_to_numpy(tparams)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype):
    jcfg, tcfg, jparams, tparams = _configs(dtype)
    tokens = _tokens(jcfg.vocab_size)
    jl, jaux = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    tl, taux = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (B, S, tcfg.vocab_size) and tl.dtype == tcfg.cdtype
    assert_allclose(_np(tl), _np(jl), **_tol(dtype))
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_and_cache_match_jax(dtype):
    jcfg, tcfg, jparams, tparams = _configs(dtype)
    tokens = _tokens(jcfg.vocab_size)
    jl, jcache = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    tl, tcache = prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert_allclose(_np(tl), _np(jl), **_tol(dtype))
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert_allclose(_np(tcache[k]), _np(jcache[k]), **_tol(dtype))


@pytest.mark.parametrize("mode", ["scan_carry", "readonly_fused"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_jax_in_each_cache_mode(mode, dtype):
    """The port writes K/V at pos and attends [0, pos] in place: the function
    both JAX decode_cache_modes compute."""
    jcfg, tcfg, jparams, tparams = _configs(dtype)
    jcfg, tcfg = (c.replace(decode_cache_mode=mode) for c in (jcfg, tcfg))
    tokens = _tokens(jcfg.vocab_size)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    jstate = jax_init_decode_state(jcfg, B, S)
    tcache = init_decode_state(tcfg, B, S, device="cpu")
    for t in range(S):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(tokens[:, t]),
                           jnp.int32(t))
        tl, tcache = decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(tokens[:, t]), t)
        assert_allclose(_np(tl), _np(jl), **_tol(dtype), err_msg=f"step {t}")
    for k in ("k", "v"):
        assert_allclose(_np(tcache[k]), _np(jstate[k]), **_tol(dtype))


def test_decode_matches_forward_fp32():
    _, tcfg, _, tparams = _configs("float32")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size))
    lf, _ = forward(tcfg, tparams, {"tokens": tokens})
    cache = init_decode_state(tcfg, B, S, device="cpu")
    errs = []
    for t in range(S):
        lg, cache = decode_step(tcfg, tparams, cache, tokens[:, t], t)
        errs.append(float((lg - lf[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_prefill_writes_into_a_preallocated_cache():
    _, tcfg, _, tparams = _configs("float32")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size))
    _, own = prefill(tcfg, tparams, {"tokens": tokens})
    cache = init_decode_state(tcfg, B, S + 6, device="cpu")
    _, same = prefill(tcfg, tparams, {"tokens": tokens}, cache=cache)
    assert same is cache
    assert torch.equal(cache["k"][:, :, :S], own["k"])
    assert torch.all(cache["k"][:, :, S:] == 0)
    with pytest.raises(ValueError):
        prefill(tcfg, tparams, {"tokens": tokens},
                cache=init_decode_state(tcfg, B, S - 1, device="cpu"))


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = granite_8b.SMOKE_CONFIG
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(param_specs(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_state(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, {}, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({"w": np.zeros(2, np.float32)})


@pytest.mark.parametrize("family", ["audio"])
def test_families_not_yet_ported_raise(family):
    cfg = granite_8b.SMOKE_CONFIG.replace(family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        param_specs(cfg)


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_frontend_embeds_are_refused_until_a_frontend_is_ported(entry):
    """The audio frontend's prefix waits for its codebooks (the vision
    prefix is ported: tests/test_torch_moe.py)."""
    _, tcfg, _, tparams = _configs("float32")
    tcfg = tcfg.replace(family="audio", frontend="audio")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg.vocab_size)),
             "frontend_embeds": torch.zeros(B, 2, tcfg.d_model)}
    fn = forward if entry == "forward" else prefill
    with pytest.raises(NotImplementedError, match="frontend_embeds.*ROADMAP"):
        fn(tcfg, tparams, batch)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module (``repro_torch.run``, ``repro_torch.ops``,
    ``repro_torch.train.checkpoint`` and ``repro_torch.data``'s sources and
    pipeline among them), ``chip_smoke.py`` and the port's examples import
    with ``jax``, ``repro``, ``msgpack`` and ``ml_dtypes`` made unimportable
    (the card's machine has none of them), and none is loaded
    afterwards."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, importlib.abc, json, sys\n"
        "BLOCKED = ('jax', 'repro', 'msgpack', 'ml_dtypes')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'examples')\n"
        "import train_fused_torch, train_e2e_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert len(modules) > 10
    assert {"repro_torch.run", "repro_torch.run.session", "repro_torch.ops",
            "repro_torch.ops.fsck", "repro_torch.train.checkpoint",
            "repro_torch.data.sources", "repro_torch.data.pipeline",
            "repro_torch.data.mq", "repro_torch.data.colocated",
            "repro_torch.dataplane.mq_backend",
            "repro_torch.dataplane.colocated_backend",
            "repro_torch.core.resilience", "repro_torch.obs.recorder",
            "repro_torch.launch.roofline", "repro_torch.ops.cli",
            "repro_torch.ops.obs", "repro_torch.ops.__main__",
            "repro_torch.chaos", "repro_torch.chaos.scenarios",
            "repro_torch.chaos.__main__", "repro_torch.models.moe",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.configs.qwen3_moe_235b_a22b",
            "repro_torch.configs.qwen3_vl_30b_a3b",
            "repro_torch.configs.internvl2_76b"} <= set(modules)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("argv,rc", [
    (["repro_torch.chaos", "--only", "producer_precommit_kill", "--json"], 0),
    (["repro_torch.ops", "--root", "<missing>", "-n", "x", "fsck"], 2),
])
def test_port_entry_points_run_with_the_jax_package_blocked(tmp_path, argv,
                                                            rc):
    """``python -m repro_torch.chaos`` and ``python -m repro_torch.ops`` run
    to their exit codes with ``jax``, ``repro``, ``msgpack`` and
    ``ml_dtypes`` made unimportable, and load none of them; being host
    code, they do not load torch either."""
    argv = [str(tmp_path / "missing") if a == "<missing>" else a
            for a in argv]
    code = (
        "import importlib.abc, json, runpy, sys\n"
        "BLOCKED = ('jax', 'repro', 'msgpack', 'ml_dtypes')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module(sys.argv[0], run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "print(json.dumps({'rc': rc, 'bad': bad,\n"
        "                  'torch': 'torch' in sys.modules}))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": f"{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc == {"rc": rc, "bad": [], "torch": False}
    if rc == 0:
        [result] = json.loads(out.stdout[:out.stdout.rindex("\n{")])
        assert result["name"] == "producer_precommit_kill"
        assert result["passed"] and result["fsck_clean_after"]
    else:
        assert "does not exist" in out.stderr
