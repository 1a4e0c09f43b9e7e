"""A whole run of each cell on the CPU at a small size, the look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath it comes out not correct, once for each fault the cell can
have (a step that returns its state unchanged, half of the batch left out,
a token altered where the data plane hands it over). One chip exchanges
nothing, so there is no exchange to leave out."""
import time

import pytest

pytest.importorskip("torch")

from wb.harness import run_cell  # noqa: E402
from wb.spec import Spec, reference  # noqa: E402

SPEC = Spec()


@pytest.fixture(autouse=True)
def one_thread():
    """These models are small: one CPU thread runs them fastest, and keeps
    them fast beside other processes."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
CELLS = [w["name"] for w in SPEC.data["workloads"]]


def overrides(cell, spec=SPEC):
    """A whole run's small size: the model as the cell's reference module
    sizes it for these tests (``tiny``), the traffic cut here."""
    w = spec.cell(cell)
    traffic, cfg = spec.traffic(w), spec.config(w)
    tr = {"seq_len": traffic["seq_len"] // 32, "backlog_steps": 10}
    if traffic["frontend_prefix"]:
        tr["frontend_prefix"] = 8
    if "producer" in traffic:
        tr["producer"] = dict(traffic["producer"], produce_delay_s=0.01)
    return {"model": reference(cfg["reference"]).tiny(cfg["model"]), "traffic": tr}


def run(cell, fault=None):
    return run_cell(SPEC, cell, 2**31 + 4242, 0.5, False, time.perf_counter(), device="cpu",
                    fault=fault, overrides=overrides(cell))


def faults(cell):
    gb = SPEC.traffic(SPEC.cell(cell))["global_batch"]
    return [f for f in ("state_unchanged", "half_batch", "token_altered")
            if f != "half_batch" or gb > 1]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert list(out)[-1] == "checks"
    assert {"tokens_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults(c)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = run(cell, fault)
    assert not out["correct"], out["checks"]
