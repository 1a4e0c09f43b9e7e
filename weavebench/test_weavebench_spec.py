"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in DATA["workloads"]]
METRICS = DATA["end_to_end"] + DATA["per_layer"]


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["weavebench"]
    assert DATA["command"] == ["python3", "weavebench/run.py"]
    assert (ROOT / DATA["command"][1]).is_file()
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = DATA["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in DATA["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in DATA["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(p["layer"])
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert one_line(w["why"])
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names) and len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for cell in CELLS:
        has = {m["name"] for m in DATA["end_to_end"] if cell in m.get("workloads", CELLS)}
        assert "setup_s" in has and len(has) >= 2, cell
        layer = [p for p in DATA["per_layer"] if cell in p.get("workloads", CELLS)]
        assert layer, cell
        for p in layer:
            assert p["moves"] in has, (cell, p["name"])
    for p in DATA["per_layer"]:
        assert p["moves"] in e2e
        if p["name"].endswith("_roofline") or "mfu" in p["name"]:
            assert p["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_resolves_its_files_by_name(cell):
    from wb.spec import Spec, reference
    from repro_torch.models.config import ModelConfig

    spec = Spec()
    w = spec.cell(cell)
    cfg, traffic, limits = spec.config(w), spec.traffic(w), spec.limits(w)
    entry = next(c for c in DATA["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("weavebench/") and cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key, (published, run) in cfg["reduced"].items():
        assert cfg["published"][key] == published and cfg["model"][key] == run
    for key, value in cfg["published"].items():
        if key in cfg["model"] and key not in cfg["reduced"]:
            assert cfg["model"][key] == value, key
    ModelConfig(**cfg["model"])
    reference(cfg["reference"]).layout(cfg["model"])
    assert traffic["name"] == w["traffic"]
    from wb.check import NUMBERS
    assert set(limits) <= set(NUMBERS) and len(limits) >= 4
    assert limits["grids_wrong"] == limits["tokens_wrong"] == 0


def test_every_config_is_used_and_no_file_is_shared():
    used = {w["config"] for w in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}
    files = [c["file"] for c in DATA["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("name", [p["name"] for p in DATA["per_layer"]])
def test_each_per_layer_metric_has_a_reader_that_finds_nothing_in_an_empty_run(name):
    from types import SimpleNamespace

    from wb.spec import metric_reader

    empty = SimpleNamespace(timings=[], profiled=None, read_latencies=[], trace=None,
                            step_flops=1, peaks={"bf16_flops_per_s": 1.0,
                                                 "hbm_bytes_per_s": 1.0})
    assert metric_reader(name)(empty) is None
