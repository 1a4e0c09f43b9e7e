"""What the harness loads: nothing of JAX or of the JAX package ``repro``
(top-level names compared whole, so ``repro_torch`` passes), also in every
reference module, each cell's found by its configuration's name; nothing of
the old ``benchmarks/`` folder, and no result without a card."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

BLOCKER = r"""
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "repro"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
"""

IMPORTS = r"""
import importlib, importlib.util, runpy
sys.path[:0] = [BENCH, ROOT + "/src"]
try:
    import repro
except ImportError:
    pass
else:
    raise SystemExit("the blocker let repro through")
import wb.harness, wb.trace, wb.control, wb.traffic, wb.check, wb.reference.common
from wb.spec import Spec, reference
spec = Spec()
for w in spec.data["workloads"]:
    reference(spec.config(w)["reference"])
for p in (importlib.import_module("pathlib").Path(BENCH) / "wb" / "reference").glob("*.py"):
    importlib.import_module("wb.reference." + p.stem)
import repro_torch.train.pipeline, repro_torch.dataplane, repro_torch.core
import repro_torch.train, repro_torch.models.config
from wb.spec import metric_reader
for p in (importlib.import_module("pathlib").Path(BENCH) / "metrics").glob("*.py"):
    metric_reader(p.stem)
runpy.run_path(BENCH + "/run.py", run_name="weavebench_run")
runpy.run_path(BENCH + "/control.py", run_name="weavebench_control")
from wb.harness import forbidden_modules
print(forbidden_modules())
"""


def test_the_harness_imports_with_jax_and_the_jax_package_blocked():
    code = BLOCKER + f"BENCH, ROOT = {str(BENCH)!r}, {str(ROOT)!r}\n" + IMPORTS
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_file_of_the_benchmark_names_the_old_folder():
    for path in BENCH.rglob("*.py"):
        if path.name.startswith("test_weavebench"):
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text, path


def _run(cwd):
    return subprocess.run([sys.executable, "weavebench/run.py", "--workload",
                           "granite-8b.pretrain-s1k", "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=240, env={"PATH": "/usr/bin:/bin", "HOME": str(cwd)})


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "weavebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["weavebench"]
