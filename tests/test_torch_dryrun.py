"""The port's dry run (``repro_torch.launch.dryrun``), its step inputs and
its roofline on the CPU.

- ``input_specs`` and ``default_microbatches`` equal the reference's for
  every arch x shape;
- the depth extrapolation equals a trace of the whole depth;
- smoke-config cells of every family and kind trace on a fake (2, 2) mesh;
- ``roofline.analyze_record`` of a record is the reference's formulas with
  the H100's constants in place of the TPU's;
- on a 1x1 mesh (the plain program) a smoke train step's FLOPs equal the
  reference's ``hlo_analysis.analyze`` of its compiled step on one CPU
  device exactly: both count the same products (matrix products,
  attention as two, the rematerialized forward again in the backward);
- on a real 1x1 mesh (``gloo``) the model's loss and gradients over
  DTensors equal the plain ones: the vocab-parallel cross-entropy, the
  layout pins and the MoE ``local`` dispatch change no value.

Fake tensors on the CPU device: this CPU-only torch refuses a few fake
CUDA operators (``contiguous``, advanced indexing) that the card's build
traces, so the tests model the program on fake CPU tensors, which take the
same operators (attention goes through K1's operator on any DTensor).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import hlo_analysis as jH  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models.common import abstract_params  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.optimizer import OptimizerConfig as JaxOptConfig  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_smoke_config)
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.kernels.common import register_shardings  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.train.step import input_specs  # noqa: E402

register_shardings()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_microbatches_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert shape == InputShape(*[getattr(JAX_SHAPES[name], f) for f in
                                     ("name", "seq_len", "global_batch",
                                      "kind")])
        ours = input_specs(cfg, shape.global_batch, shape.seq_len, shape.kind)
        theirs = jstep.input_specs(jcfg, shape.global_batch, shape.seq_len,
                                   shape.kind)
        assert list(ours) == list(theirs)
        for k, (t, axes) in ours.items():
            s, jaxes = theirs[k]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(s.shape)
            assert str(t.dtype).split(".")[-1] == str(s.dtype)
            assert axes == jaxes
        for dp in (16, 32):
            assert dryrun.default_microbatches(cfg, shape.global_batch, dp) \
                == jdry.default_microbatches(jcfg, shape.global_batch, dp)


@pytest.fixture
def mesh22():
    """A (2, 2) ("data", "model") mesh over the "fake" process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


TINY = {"train": InputShape("tiny_train", 32, 8, "train"),
        "prefill": InputShape("tiny_prefill", 32, 4, "prefill"),
        "decode": InputShape("tiny_decode", 32, 4, "decode")}


@pytest.mark.parametrize("arch,kind", [("granite_8b", "train"),
                                       ("zamba2_7b", "prefill"),
                                       ("rwkv6_3b", "decode")])
def test_depth_extrapolation_equals_a_whole_trace(mesh22, arch, kind):
    cfg = get_smoke_config(arch)
    # the hybrid: groups of 2 Mamba2 layers and the shared block, 2 groups
    # and a tail layer
    cfg = cfg.replace(attn_every=2, num_layers=5) if cfg.attn_every else \
        cfg.replace(num_layers=4)
    est, _meta, traces = dryrun.trace_costs(cfg, TINY[kind], mesh22,
                                            device="cpu", microbatches=2)
    whole, _ = dryrun._trace(cfg, TINY[kind], mesh22, "cpu", 2)
    assert traces == (3 if cfg.attn_every else 2)
    assert est.flops == pytest.approx(whole.flops, rel=1e-9)
    assert est.dot_count == whole.dot_count
    assert est.bytes_accessed == pytest.approx(whole.bytes_accessed, rel=1e-9)
    assert est.collective_count == whole.collective_count
    for k, v in whole.collective_bytes.items():
        assert est.collective_bytes[k] == pytest.approx(v, rel=1e-9)


@pytest.mark.parametrize("arch", ["granite_8b", "deepseek_moe_16b",
                                  "qwen3_vl_30b_a3b", "musicgen_medium",
                                  "rwkv6_3b", "zamba2_7b"])
def test_smoke_cells_trace_on_a_fake_2x2_mesh(mesh22, arch):
    cfg = get_smoke_config(arch)
    if cfg.attn_every:   # one group of the shared block and a tail layer
        cfg = cfg.replace(attn_every=2, num_layers=3)
    for kind, shape in TINY.items():
        costs, meta, _n = dryrun.trace_costs(cfg, shape, mesh22,
                                             device="cpu", microbatches=2)
        assert costs.flops > 0 and costs.bytes_accessed > 0, kind
        assert costs.dot_count > 0 and costs.peak_live_bytes > 0, kind
        assert meta["argument_bytes"] > 0 and meta["dp"] == 2
    # the MoE's local dispatch sums its partial outputs over "model"
    if cfg.family == "moe":
        assert costs.collective_count.get("all-reduce", 0) > 0


def test_run_cell_records_the_references_keys(tmp_path, monkeypatch):
    rec = dryrun.run_cell("granite_8b", "long_500k", False, device="cpu",
                          verbose=False)
    assert rec["status"] == "skipped"
    assert rec["reason"].startswith("pure full-attention")
    # a failure is recorded, not raised, and main exits non-zero on it
    monkeypatch.setattr(dryrun, "trace_costs", _raise)
    rec = dryrun.run_cell("granite_8b", "decode_32k", False, device="cpu",
                          verbose=False)
    assert rec["status"] == "failed" and "boom" in rec["error"]
    with pytest.raises(SystemExit, match="1 dry-run cells FAILED"):
        dryrun.main(["--arch", "granite-8b", "--shape", "decode_32k",
                     "--mesh", "single", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert (tmp_path / "granite_8b__decode_32k__single__baseline.json").exists()


def _raise(*a, **k):
    raise RuntimeError("boom")


RECORD = {
    "arch": "granite_8b", "shape": "train_4k", "mesh": "16x16",
    "status": "ok", "kind": "train", "family": "dense",
    "seq_len": 4096, "global_batch": 256, "params": 8.255e9,
    "active_params": 8.255e9,
    "hlo": {"flops": 4.4e14, "bytes_accessed": 3.1e12,
            "total_collective_bytes": 3.0e11},
    "memory": {"peak_per_device_bytes": 7 * 2**30},
}


def test_roofline_row_is_the_references_with_the_h100s_constants():
    ours, theirs = roofline.analyze_record(RECORD), jroof.analyze_record(RECORD)
    assert ours.compute_s == pytest.approx(
        theirs.compute_s * jroof.PEAK_FLOPS / roofline.PEAK_FLOPS)
    assert ours.memory_s == pytest.approx(
        theirs.memory_s * jroof.HBM_BW / roofline.HBM_BW)
    assert ours.collective_s == pytest.approx(
        theirs.collective_s * jroof.ICI_BW / roofline.LINK_BW)
    for f in ("model_flops", "hlo_flops_total", "useful_ratio",
              "peak_mem_gib"):
        assert getattr(ours, f) == getattr(theirs, f)
    assert ours.step_time_s == max(ours.compute_s, ours.memory_s,
                                   ours.collective_s)
    assert ours.mfu == pytest.approx(
        ours.model_flops / (256 * roofline.PEAK_FLOPS) / ours.step_time_s)


def test_roofline_cli_reads_the_records(tmp_path, capsys):
    skipped = dict(RECORD, status="skipped", reason="no", shape="long_500k")
    for name, rec in (("a__train_4k__single__t.json", RECORD),
                      ("a__long_500k__single__t.json", skipped),
                      ("a__train_4k__single__u.json", RECORD)):
        (tmp_path / name).write_text(json.dumps(rec))
    rows = roofline.load_rows(str(tmp_path), tag="t")
    assert [r.status for r in rows] == ["skipped", "ok"]
    roofline.main(["--dir", str(tmp_path), "--tag", "t",
                   "--csv", str(tmp_path / "rows.csv")])
    out = capsys.readouterr().out
    assert "granite_8b" in out and "-- no" in out
    assert (tmp_path / "rows.csv").read_text().count("\n") == 3


@pytest.fixture
def mesh11(tmp_path):
    """A real (1, 1) mesh over a one-process gloo group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def test_train_flops_on_a_1x1_mesh_equal_the_references(mesh11):
    """granite-8b's smoke train step, one microbatch: the port's dry run
    against the reference's HLO reader on its compiled step."""
    jcfg = jax_smoke("granite_8b").replace(compute_dtype="float32")
    cfg = get_smoke_config("granite_8b").replace(compute_dtype="float32")
    B, S = 4, 32
    specs = jax_param_specs(jcfg)
    params = abstract_params(specs)
    opt = {"m": params, "v": params,
           "step": jax.ShapeDtypeStruct((), jnp.int32)}
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    step = jstep.make_train_step(jcfg, JaxOptConfig(),
                                 jstep.StepConfig(microbatches=1))
    text = jax.jit(step).lower(params, opt, batch).compile().as_text()
    want = jH.analyze(text).flops
    shape = InputShape("t", S, B, "train")
    got, _meta, _n = dryrun.trace_costs(cfg, shape, mesh11, device="cpu",
                                        microbatches=1)
    # on the CPU both take dense attention, differentiated as it stands; on
    # the card the port's is K1, whose backward rule (the reference's own
    # for its Pallas kernel) recomputes the forward's two products: one
    # more 4·B·H·S·T·dh a layer, which phase 18 holds to the card's count
    assert got.flops == want


def _numpy_params(cfg, seed=0):
    from repro_torch.models import init_params, param_specs
    return init_params(param_specs(cfg), seed=seed, device="cpu")


@pytest.mark.parametrize("arch", ["granite_8b", "deepseek_moe_16b"])
def test_dtensor_loss_and_grads_on_a_1x1_mesh_equal_the_plain_ones(mesh11,
                                                                    arch):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.sharding.specs import make_rules, use_rules
    from repro_torch.train.step import loss_and_grads

    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    params = _numpy_params(cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    loss, _m, grads = loss_and_grads(cfg, params, {"tokens": tokens})
    rules = make_rules(mesh11, cfg.num_heads, cfg.num_kv_heads)
    dparams = tree_map(lambda p: distribute_tensor(
        p, mesh11, rules.sharding(("layers",) * 0 + (None,) * p.ndim)),
        params)
    dtokens = distribute_tensor(tokens, mesh11, rules.sharding(("batch",)))
    with use_rules(rules), implicit_replication():
        dloss, _dm, dgrads = loss_and_grads(cfg, dparams, {"tokens": dtokens})
    assert float(dloss.full_tensor()) == pytest.approx(float(loss), rel=1e-5)
    for g, dg in zip(tree_leaves(grads), tree_leaves(dgrads)):
        np.testing.assert_allclose(dg.full_tensor().numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6)
