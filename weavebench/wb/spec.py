"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file, and a traffic mix, ``traffic/<traffic>.json``.
Its limits are ``limits/<cell>.json``, each per-layer metric's reader is
``metrics/<metric>.py``, and a configuration's plain reference is
``wb/reference/<reference>.py``. Adding a cell, a mix, a configuration or
a metric is adding files and entries; no file here changes.
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
