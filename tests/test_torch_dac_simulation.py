"""Twin of ``tests/test_dac_simulation.py`` on the port: a discrete-event
simulation of N ``repro_torch`` DAC producers; the steady-state conflict
rate tracks the budget eps (paper §7.3), an eager fixed policy conflicts
far more, and the cold-start storm is transient. The simulation is the
reference test's own. Imports neither jax nor msgpack.
"""
import random

import pytest

pytest.importorskip("torch")

from repro_torch.core.dac import (DACConfig, DACPolicy,  # noqa: E402
                                  FixedCountPolicy)


def simulate(n_producers: int, tau: float, eps: float, cycles: int = 120,
             warmup_cycles: int = 20, seed: int = 0, policy_factory=None):
    rng = random.Random(seed)
    if policy_factory is None:
        policy_factory = lambda i: DACPolicy(
            DACConfig(eps=eps, delta=0.5, alpha=0.3, rho=0.2, seed=i))
    policies = [policy_factory(i) for i in range(n_producers)]
    next_t = [rng.uniform(0, tau * 4) for _ in range(n_producers)]
    n_attempts = [0] * n_producers
    commits = []
    attempts = conflicts = 0
    while min(n_attempts) < cycles:
        i = min(range(n_producers), key=lambda j: next_t[j])
        t = next_t[i]
        conflicted = any(t < c <= t + tau for c in commits[-2 * n_producers:])
        if not conflicted:
            commits.append(t + tau)
        n_attempts[i] += 1
        if n_attempts[i] > warmup_cycles:  # steady state only
            attempts += 1
            conflicts += int(conflicted)
        policies[i].on_outcome(not conflicted, tau, n_producers,
                               now=t + tau)
        # production-time variance between commit cycles
        noise = rng.expovariate(1.0 / (4 * tau))
        next_t[i] = t + tau + getattr(policies[i], "gap", 0.0) + noise
    return attempts, conflicts


@pytest.mark.parametrize("n,eps", [(4, 0.05), (8, 0.05), (16, 0.10),
                                   (32, 0.05)])
def test_dac_steady_state_conflict_rate_tracks_budget(n, eps):
    attempts, conflicts = simulate(n, tau=0.05, eps=eps)
    rate = conflicts / max(1, attempts)
    # the renewal approximation is not exact; allow 2x the budget
    assert rate <= 2 * eps, (rate, eps)
    assert attempts > 50 * n  # actually committing, not stalled


def test_dac_beats_eager_fixed_policy_on_conflicts():
    """An eager fixed policy (commit every TGB, no adaptive gap) conflicts far
    more than DAC under identical conditions."""
    n, eps, tau = 8, 0.05, 0.05
    a_dac, c_dac = simulate(n, tau, eps)
    a_fix, c_fix = simulate(
        n, tau, eps, policy_factory=lambda i: FixedCountPolicy(1))
    assert c_dac / max(1, a_dac) < 0.5 * (c_fix / max(1, a_fix))


def test_cold_start_storm_is_transient():
    """Documenting a real DAC property: the synchronized cold start produces a
    conflict storm which the jittered gap resolves within a few cycles."""
    n, eps, tau = 16, 0.05, 0.05
    a_cold, c_cold = simulate(n, tau, eps, cycles=10, warmup_cycles=0)
    a_warm, c_warm = simulate(n, tau, eps, cycles=120, warmup_cycles=20)
    assert c_cold / max(1, a_cold) > c_warm / max(1, a_warm)
