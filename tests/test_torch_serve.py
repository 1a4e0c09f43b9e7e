"""The port's serving engine on the CPU: twins of tests/test_serve_engine.py,
plus greedy token-for-token equality with the JAX engine on the same weights
(fp32, where argmax is stable across the two packages)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import granite_8b as jax_granite  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import forward, init_params, param_specs  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402
from repro_torch.serve.engine import (EngineStats, Request,  # noqa: E402
                                      ServeEngine)


def _engine(cfg, init_seed, max_seq, **kw):
    params = init_params(param_specs(cfg), seed=init_seed, device="cpu")
    return ServeEngine(cfg, params, max_seq=max_seq, device="cpu", **kw), params


def test_engine_serves_batch_and_counts():
    cfg = get_smoke_config("granite_8b")
    eng, _ = _engine(cfg, 0, 24)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8,
                                               dtype=np.int32),
                    max_new_tokens=6) for i in range(3)]
    out = eng.run_batch(reqs)
    assert all(r.done for r in out)
    assert all(len(r.generated) == 6 for r in out)
    assert eng.stats.tokens_out == 18
    assert eng.stats.decode_steps == 5  # first token comes from prefill


def test_engine_greedy_matches_forward_argmax():
    cfg = get_smoke_config("granite_8b").replace(compute_dtype="float32")
    eng, params = _engine(cfg, 1, 16)
    prompt = (np.arange(10, dtype=np.int32) * 7) % cfg.vocab_size
    out = eng.run_batch([Request(rid=0, prompt=prompt, max_new_tokens=3)])
    logits, _ = forward(cfg, params, {"tokens": torch.from_numpy(prompt)[None]})
    assert out[0].generated[0] == int(torch.argmax(logits[0, -1]))


def test_engine_eos_stops_early():
    cfg = get_smoke_config("granite_8b")
    eng, _ = _engine(cfg, 0, 32)
    reqs = [Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=20)]
    first = eng.run_batch([Request(rid=1, prompt=np.zeros(4, np.int32),
                                   max_new_tokens=1)])[0].generated[0]
    out = eng.run_batch(reqs, eos_id=first)
    assert len(out[0].generated) < 20


def test_engine_rejects_ssm_families():
    cfg = get_smoke_config("granite_8b").replace(family="rwkv")
    with pytest.raises(ValueError):
        ServeEngine(cfg, {}, max_seq=8, device="cpu")


def test_engine_greedy_matches_jax_engine_token_for_token():
    cfg = jax_granite.SMOKE_CONFIG.replace(compute_dtype="float32")
    jparams = jax_init_params(jax_param_specs(cfg), seed=4)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (3, 8), dtype=np.int32)
    jout = JaxServeEngine(cfg, jparams, max_seq=20).run_batch(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(prompts)])
    port_cfg = get_smoke_config("granite_8b").replace(compute_dtype="float32")
    tout = ServeEngine(port_cfg, tparams, max_seq=20, device="cpu").run_batch(
        [Request(rid=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(prompts)])
    assert [r.generated for r in tout] == [r.generated for r in jout]


def test_engine_casts_matrices_once_and_keeps_norms_fp32():
    cfg = get_smoke_config("granite_8b")  # bf16 compute, fp32 params
    eng, _ = _engine(cfg, 0, 8)
    layers = eng.params["layers"]
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert layers[name].dtype == torch.bfloat16, name
    assert eng.params["embed"].dtype == eng.params["unembed"].dtype == torch.bfloat16
    assert layers["attn_norm"].dtype == torch.float32
    assert eng.params["final_norm"].dtype == torch.float32


def test_engine_temperature_sampling_is_seeded():
    cfg = get_smoke_config("granite_8b")
    prompt = np.arange(6, dtype=np.int32)
    runs = []
    for _ in range(2):
        eng, _ = _engine(cfg, 0, 16, temperature=1.0, seed=7)
        runs.append(eng.run_batch([Request(rid=0, prompt=prompt,
                                           max_new_tokens=5)])[0].generated)
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab_size for t in runs[0])


def test_engine_stats_keep_the_serve_metric_names():
    reg = MetricsRegistry()
    stats = EngineStats(registry=reg)
    stats.tokens_out += 3
    stats.wall_decode_s += 1.5
    assert reg.get("serve.0.tokens_out") == 3
    assert sorted(reg.snapshot()) == [
        "serve.0.decode_steps", "serve.0.prefills", "serve.0.tokens_out",
        "serve.0.wall_decode_s", "serve.0.wall_prefill_s"]
    assert stats.tokens_per_s == 2.0


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "internvl2_76b"])
def test_moe_and_vlm_engines_match_jax_engine_token_for_token(arch):
    """The MoE family (deepseek-moe-16b smoke: prefill routes 3 x 8 tokens
    at capacity 8, each decode step 3 tokens at capacity 4) and the vlm
    backbone, served greedily in fp32 by both engines."""
    from repro.configs.registry import get_smoke_config as jax_smoke

    cfg = jax_smoke(arch).replace(compute_dtype="float32")
    jparams = jax_init_params(jax_param_specs(cfg), seed=5)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (3, 8), dtype=np.int32)
    jout = JaxServeEngine(cfg, jparams, max_seq=20).run_batch(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(prompts)])
    port_cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    tout = ServeEngine(port_cfg, tparams, max_seq=20, device="cpu").run_batch(
        [Request(rid=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(prompts)])
    assert [r.generated for r in tout] == [r.generated for r in jout]


def test_moe_engine_casts_experts_and_keeps_router_and_norms_fp32():
    """The leaves JAX casts on use (the experts, the shared experts, the
    attention matrices, embed/unembed) are bf16 once at load; the router,
    which JAX routes in float32, and every norm scale stay fp32."""
    cfg = get_smoke_config("deepseek_moe_16b")  # bf16 compute, fp32 params
    eng, _ = _engine(cfg, 0, 8)
    layers = eng.params["layers"]
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "sh_gate", "sh_up", "sh_down"):
        assert layers[name].dtype == torch.bfloat16, name
    assert eng.params["embed"].dtype == eng.params["unembed"].dtype == torch.bfloat16
    for name in ("router", "attn_norm", "mlp_norm"):
        assert layers[name].dtype == torch.float32, name
    assert eng.params["final_norm"].dtype == torch.float32
    reqs = eng.run_batch([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                                  max_new_tokens=3)])
    assert len(reqs[0].generated) == 3
