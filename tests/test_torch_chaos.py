"""The port's chaos harness (``repro_torch.chaos``) on the CPU.

Twins of ``tests/test_chaos.py`` (every registered scenario at seeds 0 and
1, the registry check, a failed assertion becoming a failed result), then
across packages: each scenario's counts in the port equal the reference's
``run_scenario`` at the same seed.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.chaos import SCENARIOS, run_scenario  # noqa: E402

#: scenarios whose ``faults_injected`` depends on how threads interleave or
#: on timing, so it differs from run to run in either package, most under
#: load: in a SlowDown storm the count of throttled ops depends on when
#: each producer and the consumer reach the store; in the two conflict
#: storms, on which producer thread's conditional put meets each injected
#: 5xx; in the outage, on whether the breaker's 50 ms cooldown ends before
#: the outage does, so that a half-open probe meets it too
INTERLEAVED_FAULTS = {"brownout_throttle_storm", "cput_conflict_storm",
                      "shard_conflict_storm", "store_outage_resume"}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scenario(name, seed):
    r = run_scenario(name, seed=seed)
    assert r.passed, f"{name} (seed={seed}): {r.detail}"
    assert r.fsck_clean_after, f"{name} left the namespace dirty"
    assert r.steps_delivered > 0


def test_registry_covers_required_protocol_points():
    required = {
        "producer_precommit_kill", "producer_post_upload_kill",
        "consumer_midstep_kill", "mixed_reader_midstep_kill",
        "reclaimer_midtrim_kill", "cput_conflict_storm",
        "trainer_midcheckpoint_kill",
    }
    assert required <= set(SCENARIOS), \
        f"missing scenarios: {required - set(SCENARIOS)}"


def test_failed_assertion_becomes_failed_result():
    from repro_torch.chaos import scenario

    @scenario("_always_fails")
    def _always_fails(seed=0):
        raise AssertionError("intentional")

    try:
        r = run_scenario("_always_fails")
        assert not r.passed
        assert "intentional" in r.detail
    finally:
        del SCENARIOS["_always_fails"]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scenario_counts_equal_the_references(name, seed):
    """Steps delivered, orphans found and fsck's verdict after repair equal
    the reference's at the same seed, and so do the faults injected but in
    ``INTERLEAVED_FAULTS``. The reference's ``store_outage_resume`` can
    fail on its breaker's half-open probe (ROADMAP Queue 3; the port's
    breaker is fixed): such a run must fail exactly that way."""
    pytest.importorskip("msgpack")
    from repro.chaos import SCENARIOS as REF_SCENARIOS
    from repro.chaos import run_scenario as ref_run_scenario

    assert sorted(REF_SCENARIOS) == sorted(SCENARIOS)
    ours = run_scenario(name, seed=seed)
    ref = ref_run_scenario(name, seed=seed)
    assert ours.passed, ours.detail
    if name == "store_outage_resume" and not ref.passed:
        assert "finalize failed to drain 0 pending + 4 spilled" in ref.detail
        return
    assert ref.passed, ref.detail
    keys = ["steps_delivered", "orphans_detected", "fsck_clean_after"]
    if name not in INTERLEAVED_FAULTS:
        keys.append("faults_injected")
    assert {k: getattr(ours, k) for k in keys} == \
        {k: getattr(ref, k) for k in keys}
