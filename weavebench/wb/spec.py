"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file, and a traffic mix, ``traffic/<traffic>.json``.
Its limits are ``limits/<cell>.json``, each per-layer metric's reader is
``metrics/<metric>.py``, and a configuration's plain reference is
``wb/reference/<reference>.py``, named by the configuration file's
``reference``. Adding a cell, a mix, a configuration or a metric, also of
another model family, is adding files and entries; no file here changes.

A reference module holds everything that belongs to its family, and gives:
``layout(m)``, the parameter leaves the weights are drawn in;
``train_readings(m, opt, make_leaf, batches, frontend, numerics, rows,
routes)``, what the comparison reads (``common.train_readings`` over the
family's loss); ``step_model_flops(m, global_batch, seq_len, prefix)``, the
model FLOPs of a step that ``step.mfu`` credits; ``tiny(m)`` and
``small(m)``, the model overrides the CPU tests run it at; and, for an MoE
family, ``Routes``, so that the reference can follow the program's routing.
A metric reader gets the calls of every ``repro_torch::`` operator in the
second traced slice (``run.trace["calls"]``, by operator name).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.data = json.loads(Path(path).read_text())
        self.root = Path(path).resolve().parent

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads((BENCH_DIR / "limits" / f"{cell['name']}.json").read_text())

    def metrics(self, cell: dict, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]


def reference(name: str):
    """The plain reference module ``wb/reference/<name>.py``."""
    return importlib.import_module(f"wb.reference.{name}")


_readers: Dict[str, object] = {}


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    if name not in _readers:
        path = BENCH_DIR / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"weavebench_metric_{len(_readers)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[name] = mod.read
    return _readers[name]
