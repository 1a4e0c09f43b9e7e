"""The port's data-plane examples tell the reference's story.

``examples/{quickstart,failover,sft_mixture}_torch.py`` run in process
beside ``examples/{quickstart,failover,sft_mixture}.py``; each prints the
same lines: the manifest versions and producer offsets, the cursors, the
steps and batches consumed, the TGBs and bytes reclaimed, the resume
offsets and steps. Each example checks its own story as it runs (its
asserts), so a twin that prints the lines but breaks a guarantee fails too.

The examples' writers commit on DAC's cadence, which follows the clock
(the gap after a commit is a multiple of the commit's measured duration),
so a story's manifest versions move with the machine's load. Both
packages' ``SystemClock.now`` are therefore one counter here, a
millisecond a call: a story is then a function of the code alone, and the
two packages' must be equal line for line.
"""
import itertools
import runpy
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("msgpack")

import repro.core.clock as jclock  # noqa: E402
import repro_torch.core.clock as tclock  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _story(path: Path, monkeypatch, capsys) -> str:
    tick = itertools.count()
    for clock in (jclock, tclock):
        monkeypatch.setattr(clock.SystemClock, "now",
                            lambda self: next(tick) * 1e-3)
    capsys.readouterr()
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart", "failover", "sft_mixture"])
def test_example_twin_tells_the_reference_story(name, monkeypatch, capsys):
    want = _story(EXAMPLES / f"{name}.py", monkeypatch, capsys)
    got = _story(EXAMPLES / f"{name}_torch.py", monkeypatch, capsys)
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) >= 4
