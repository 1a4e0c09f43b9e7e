"""Twin of ``tests/test_dac.py`` on the port: DAC (Algorithm 1) math and the
baseline commit policies of ``repro_torch.core.dac``. Imports neither jax
nor msgpack.
"""
import math

import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

from repro_torch.core import (AIMDPolicy, DACConfig, DACPolicy,  # noqa: E402
                              FixedCountPolicy, IncrPolicy, NaivePolicy,
                              make_policy)


def test_dac_closed_form_matches_eq7_eq8():
    cfg = DACConfig(delta=0.3, eps=0.05, alpha=1.0, rho=0.0)
    p = DACPolicy(cfg)
    tau, n = 0.2, 9
    p.on_outcome(True, tau, n, now=0.0)
    t_conf = max(0.0, (n - 1) * tau / (-math.log(1 - cfg.eps)) - tau)
    t_cost = (1 - cfg.delta) / cfg.delta * tau
    assert p.last_T_conf == pytest.approx(t_conf)
    assert p.last_T_cost == pytest.approx(t_cost)
    assert p.gap == pytest.approx(max(t_conf, t_cost))


@settings(max_examples=50, deadline=None)
@given(tau=st.floats(1e-4, 5.0), n=st.integers(1, 256),
       eps=st.floats(0.01, 0.5), delta=st.floats(0.05, 0.9),
       rho=st.floats(0.0, 0.5))
def test_dac_gap_respects_budgets(tau, n, eps, delta, rho):
    """Property: with gap >= T*, both budget constraints hold under the model."""
    p = DACPolicy(DACConfig(delta=delta, eps=eps, alpha=1.0, rho=rho, seed=1))
    p.on_outcome(True, tau, n, now=0.0)
    T = p.gap
    duty = tau / (T + tau)
    p_conflict = 1 - math.exp(-(n - 1) * tau / (T + tau))
    assert duty <= delta + 1e-9
    assert p_conflict <= eps + 1e-9
    # jitter only widens the gap
    assert T >= max(p.last_T_conf, p.last_T_cost) - 1e-12


def test_dac_ema_tracks_tau():
    p = DACPolicy(DACConfig(alpha=0.5, rho=0.0))
    p.on_outcome(True, 1.0, 2, now=0.0)
    assert p.tau_hat == pytest.approx(1.0)  # first sample seeds the EMA
    p.on_outcome(True, 3.0, 2, now=1.0)
    assert p.tau_hat == pytest.approx(2.0)


def test_dac_widens_gap_as_manifest_grows():
    """As tau_v grows (manifest I/O cost), the gap must widen."""
    p = DACPolicy(DACConfig(alpha=1.0, rho=0.0))
    gaps = []
    for i, tau in enumerate([0.05, 0.1, 0.2, 0.4, 0.8]):
        p.on_outcome(True, tau, 8, now=float(i))
        gaps.append(p.gap)
    assert gaps == sorted(gaps)


def test_naive_always_attempts():
    p = NaivePolicy()
    assert p.should_attempt(1, 0.0)
    assert not p.should_attempt(0, 0.0)


def test_fixed_count_threshold():
    p = FixedCountPolicy(10)
    assert not p.should_attempt(9, 0.0)
    assert p.should_attempt(10, 0.0)


def test_incr_backs_off_on_conflict():
    p = IncrPolicy(k0=10)
    p.on_outcome(False, 0.1, 4, 0.0)
    p.on_outcome(False, 0.1, 4, 0.0)
    assert p.k == 12
    p.on_outcome(True, 0.1, 4, 0.0)
    assert p.k == 12  # success does not shrink


def test_aimd_rate_dynamics():
    p = AIMDPolicy(a=1.0, T0=1.0)
    p.on_outcome(False, 0.1, 4, now=0.0)   # halve rate -> T doubles
    assert p.T == pytest.approx(2.0)
    p.on_outcome(True, 0.1, 4, now=2.0)    # rate 0.5 + 1 = 1.5 -> T = 1/1.5
    assert p.T == pytest.approx(1 / 1.5)


def test_make_policy_factory():
    assert isinstance(make_policy("dac", eps=0.2), DACPolicy)
    assert isinstance(make_policy("fixed100"), FixedCountPolicy)
    assert make_policy("fixed100").k == 100
    assert isinstance(make_policy("incr"), IncrPolicy)
    assert isinstance(make_policy("aimd"), AIMDPolicy)
    assert isinstance(make_policy("naive"), NaivePolicy)
    with pytest.raises(ValueError):
        make_policy("bogus")
