"""``repro_torch.chaos`` — the failure-isolation chaos harness (port of
``repro.chaos``; host code only: no scenario allocates a tensor or takes a
device).

Scripted kill/restart scenarios at named protocol points (pre-commit,
post-upload-pre-manifest, mid-step, mid-trim, conflict storm, flaky reads)
that assert BatchWeave's §5 guarantees hold through recovery: exactly-once
delivery, atomic all-rank visibility, and no unaccounted storage after an
``repro_torch.ops`` fsck/repair.

Usage::

    from repro_torch.chaos import run_all, run_scenario
    results = run_all()                      # every registered scenario
    r = run_scenario("producer_precommit_kill")
    assert r.passed

CLI::

    python -m repro_torch.chaos                    # run all, table output
    python -m repro_torch.chaos --only producer_precommit_kill   # CI smoke
"""
from repro_torch.chaos.harness import (SCENARIOS, ScenarioResult, run_all,
                                       run_scenario, scenario)
from repro_torch.chaos import scenarios as _scenarios  # noqa: F401 (registers)

__all__ = ["SCENARIOS", "ScenarioResult", "run_all", "run_scenario",
           "scenario"]
