"""A configuration of another model family joins the benchmark as new files
and entries alone. A probe family, whose reference module the test
registers as ``wb.reference.probe_family`` and whose configuration file
names it, runs through ``run_cell`` and ``control_readings``, is credited
with its own module's step FLOPs and is sized by the CPU tests from its own
module; and the traced slice hands the calls of any ``repro_torch::``
operator to the metric readers."""
import json
import sys
import time
import types

import pytest

pytest.importorskip("torch")

from test_weavebench_faults import overrides  # noqa: E402
from test_weavebench_reference import small  # noqa: E402
from wb import check  # noqa: E402
from wb.control import control_readings  # noqa: E402
from wb.harness import OPS, run_cell  # noqa: E402
from wb.reference import common  # noqa: E402
from wb.spec import Spec, reference  # noqa: E402
from wb.trace import summarize  # noqa: E402

SPEC = Spec()
CELL = SPEC.data["workloads"][0]["name"]
PROBE = "probe_family"


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def probe_module(base):
    """A family's module with its own FLOP count and test sizes, its layout
    and loss those of ``base``, its readings ``common``'s loop over them;
    each call it gets is recorded."""
    mod = types.ModuleType(f"wb.reference.{PROBE}")
    mod.calls = {"step_model_flops": [], "train_readings": 0, "tiny": 0, "small": 0}
    mod.layout, mod.loss_fn, mod.Routes = base.layout, base.loss_fn, base.Routes

    def train_readings(m, opt, make_leaf, batches, frontend=None, numerics=None, rows=None,
                       routes=None):
        mod.calls["train_readings"] += 1
        return common.train_readings(mod.layout, mod.loss_fn, m, opt, make_leaf, batches,
                                     frontend, numerics, rows, routes)

    def step_model_flops(m, global_batch, seq_len, prefix=0):
        mod.calls["step_model_flops"].append((dict(m), global_batch, seq_len, prefix))
        return 1_000_003

    def tiny(m):
        mod.calls["tiny"] += 1
        return dict(base.tiny(m), num_layers=1)

    def small(m):
        mod.calls["small"] += 1
        return dict(base.small(m), num_layers=1)

    mod.train_readings, mod.step_model_flops = train_readings, step_model_flops
    mod.tiny, mod.small = tiny, small
    return mod


@pytest.fixture
def probe(tmp_path, monkeypatch):
    """(spec, module): a BENCHMARK.json under ``tmp_path`` whose one cell
    reuses the first cell's name, traffic and limits with a configuration
    file of its own that names the probe family."""
    w = SPEC.cell(CELL)
    cfg = SPEC.config(w)
    mod = probe_module(reference(cfg["reference"]))
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "probe.json").write_text(
        json.dumps(dict(cfg, name="probe-config", reference=PROBE)))
    data = dict(SPEC.data, configs=[{"name": "probe-config", "source": cfg["source"],
                                     "file": "configs/probe.json", "reduced": [],
                                     "why": "a family the harness does not name"}],
                workloads=[dict(w, config="probe-config")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return Spec(tmp_path / "BENCHMARK.json"), mod


def test_a_run_of_another_family_is_sized_counted_and_checked_by_its_module(probe):
    spec, mod = probe
    ov = overrides(CELL, spec)
    assert mod.calls["tiny"] == 1 and ov["model"]["num_layers"] == 1
    out = run_cell(spec, CELL, 2**31 + 4243, 0.5, False, time.perf_counter(), device="cpu",
                   overrides=ov)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and mod.calls["train_readings"] == 1
    cfg, traffic = spec.config(spec.cell(CELL)), spec.traffic(spec.cell(CELL))
    m = dict(cfg["model"], **ov["model"])
    traffic.update(ov["traffic"])
    assert mod.calls["step_model_flops"] == [
        (m, traffic["global_batch"], traffic["seq_len"], traffic["frontend_prefix"])]


def test_the_controls_of_another_family_use_its_module(probe):
    spec, mod = probe
    sizes = small(CELL, spec)
    assert mod.calls["small"] == 1 and sizes["model"]["num_layers"] == 1
    out = control_readings(spec, CELL, 2**31 + 79, "cpu", sizes, controls=("fp8",))
    assert mod.calls["train_readings"] == 2       # the control and the reference
    assert not check.judge(out["fp8"], spec.limits(spec.cell(CELL))), out["fp8"]


def test_the_traced_slice_gives_the_calls_of_any_program_operator():
    op = f"{OPS}an_operator_no_reader_names_yet"
    events = [
        {"cat": "kernel", "name": "spin_kernel", "ts": 1_000_000, "dur": 1},
        {"cat": "cpu_op", "name": op, "ts": 2_100_000, "dur": 100, "tid": 1,
         "args": {"Input Dims": [[2, 3], [3]]}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2_100_010, "dur": 5,
         "tid": 1, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "its_kernel", "ts": 2_100_050, "dur": 40,
         "args": {"correlation": 7}},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 2_200_000, "dur": 50, "tid": 1,
         "args": {"Input Dims": [[2, 3], [3, 4]]}},
    ]
    # the last marker kernel ran at host second 1.0; the slice is [2.0, 3.0]
    calls = summarize(events, 1.0, 2.0, 3.0, ops=OPS)["calls"]
    assert calls == {op: [([[2, 3], [3]], 40e-6)]}
    assert summarize(events, 1.0, 2.0, 3.0)["calls"] == {}
