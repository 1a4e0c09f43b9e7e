"""The port's resilience layer (``repro_torch.core.resilience``) on the CPU.

Every test of ``tests/test_resilience.py`` runs against the port: backoff
and jitter, retry budgets, throttle honoring, the AIMD governor, the circuit
breaker, the hedging model and degraded-mode survival, all on
``VirtualClock`` so timing assertions are exact. Then across packages: a
store written through the port's ``ResilientStore`` (and a resilient tgb
session's clients) reads back in the JAX package.
"""
import random
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.core import (CircuitOpenError, Consumer,  # noqa: E402
                              FaultPolicy, FaultyObjectStore, ManifestStore,
                              MemoryObjectStore, MeshPosition, Namespace,
                              Producer, ResilienceConfig, ResilientStore,
                              RetryBudget, RetryBudgetExhausted,
                              ThrottledError, TransientStoreError,
                              VirtualClock, backoff_delays, retry_transient)
from repro_torch.core import _msgpack  # noqa: E402
from repro_torch.core.errors import FAIL_FAST_ERRORS  # noqa: E402
from repro_torch.core.resilience import (AIMDGovernor,  # noqa: E402
                                         BreakerState, CircuitBreaker,
                                         HedgePolicy, shared_governor,
                                         wrap_store)


class SleepRecorder(VirtualClock):
    """Virtual clock that remembers every sleep it was asked for."""

    def __init__(self):
        super().__init__()
        self.sleeps = []

    def sleep(self, seconds):
        self.sleeps.append(seconds)
        super().sleep(seconds)


# ---------------------------------------------------------------------------
# backoff + retry_transient
# ---------------------------------------------------------------------------

def test_backoff_decorrelated_jitter_bounds():
    base, cap = 0.01, 0.5
    rng = random.Random(42)
    delays = backoff_delays(base, cap_s=cap, rng=rng)
    prev = next(delays)
    assert prev == base  # first delay is exactly base
    for _ in range(200):
        d = next(delays)
        assert base <= d <= cap
        # decorrelated recurrence: uniform(base, 3*prev), then capped
        assert d <= max(base, 3.0 * prev) + 1e-12
        prev = d


def test_backoff_deterministic_under_seed():
    def seq(seed):
        g = backoff_delays(0.01, cap_s=1.0, rng=random.Random(seed))
        return [next(g) for _ in range(20)]

    assert seq(7) == seq(7)
    assert seq(7) != seq(8)


def test_retry_after_is_honored_exactly():
    clock = SleepRecorder()
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise ThrottledError(retry_after_s=0.37)
        return "ok"

    # base_delay_s is huge so a backoff draw (the bug) would be unmissable
    assert retry_transient(fn, clock, attempts=3, base_delay_s=5.0) == "ok"
    assert clock.sleeps == [0.37]


def test_retry_budget_exhaustion_fails_fast():
    clock = SleepRecorder()
    budget = RetryBudget(clock, capacity=1.0, refill_per_s=0.0)
    calls = []

    def fn():
        calls.append(1)
        raise TransientStoreError("always")

    with pytest.raises(RetryBudgetExhausted) as ei:
        retry_transient(fn, clock, attempts=10, base_delay_s=0.01,
                        budget=budget)
    # 1 initial attempt + the single budgeted retry; then the bucket is dry
    assert len(calls) == 2
    assert isinstance(ei.value.__cause__, TransientStoreError)


def test_fail_fast_errors_are_never_retried():
    clock = SleepRecorder()
    calls = []

    def fn():
        calls.append(1)
        raise CircuitOpenError("open")

    with pytest.raises(CircuitOpenError):
        retry_transient(fn, clock, attempts=5)
    assert len(calls) == 1 and clock.sleeps == []


def test_retry_budget_refills_over_virtual_time():
    clock = VirtualClock()
    budget = RetryBudget(clock, capacity=2.0, refill_per_s=1.0)
    assert budget.try_spend() and budget.try_spend()
    assert not budget.try_spend()        # dry
    clock.advance(1.5)
    assert budget.try_spend()            # 1.5 tokens refilled
    with pytest.raises(ValueError):
        RetryBudget(clock, capacity=0.0)


def test_error_taxonomy_contract():
    # broad storage handlers must still classify the fail-fast pair as
    # storage trouble; retry loops must re-raise them immediately
    assert set(FAIL_FAST_ERRORS) == {CircuitOpenError, RetryBudgetExhausted}
    for exc in (ThrottledError, CircuitOpenError, RetryBudgetExhausted):
        assert issubclass(exc, TransientStoreError)


# ---------------------------------------------------------------------------
# AIMD governor
# ---------------------------------------------------------------------------

def _governor(clock, **kw):
    kw.setdefault("md_factor", 0.5)
    kw.setdefault("ai_per_s", 2.0)
    kw.setdefault("min_rate", 1.0)
    kw.setdefault("observe_window_s", 10.0)
    kw.setdefault("idle_reset_s", 1000.0)
    kw.setdefault("cut_cooldown_s", 1.0)
    return AIMDGovernor(clock, **kw)


def test_governor_dormant_until_first_throttle():
    clock = VirtualClock()
    gov = _governor(clock)
    assert not gov.active and gov.rate == 0.0
    assert gov.admit() == 0.0  # zero-cost steady state


def test_governor_activates_from_observed_rate_and_pauses():
    clock = VirtualClock()
    gov = _governor(clock)
    for _ in range(21):          # ~20 ops/s observed demand
        gov.admit()
        clock.advance(0.05)
    gov.on_throttle(retry_after_s=2.0)
    assert gov.active
    assert gov.rate == pytest.approx(0.5 * 21 / 1.05, rel=0.1)
    # activation pauses ALL admissions for the server's Retry-After
    assert gov.admit() == pytest.approx(2.0)


def test_governor_one_cut_per_congestion_epoch():
    clock = VirtualClock()
    gov = _governor(clock, cut_cooldown_s=1.0)
    gov.on_throttle()
    r0 = gov.rate
    # a storm throttles many in-flight ops at once: only one cut may land
    gov.on_throttle()
    gov.on_throttle()
    assert gov.rate == r0
    assert gov.throttle_events == 3      # ...but every event is counted
    clock.advance(1.5)
    gov.on_throttle()                    # new epoch: the cut applies
    assert gov.rate == max(1.0, r0 * 0.5)


def test_governor_additive_increase_and_idle_dormancy():
    clock = VirtualClock()
    gov = _governor(clock, idle_reset_s=5.0)
    gov.on_throttle()
    r0 = gov.rate
    clock.advance(1.0)
    gov.on_success()
    assert gov.rate == pytest.approx(r0 + 2.0)   # ai_per_s * dt
    clock.advance(6.0)                           # no throttle for > idle_reset
    gov.on_success()
    assert not gov.active                        # back to zero-cost dormancy


def test_shared_governor_is_one_per_inner_store():
    inner = MemoryObjectStore(clock=VirtualClock())
    a = ResilientStore(inner, ResilienceConfig(seed=0))
    b = ResilientStore(inner, ResilienceConfig(seed=1))
    assert a.governor is b.governor
    assert shared_governor(inner) is a.governor


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_open_half_open_close_cycle():
    clock = VirtualClock()
    br = CircuitBreaker(clock, failure_threshold=3, cooldown_s=1.0)
    br.on_failure()
    br.on_failure()
    assert br.state == BreakerState.CLOSED
    br.on_failure()                       # third consecutive: trip
    assert br.state == BreakerState.OPEN and br.opens == 1
    assert not br.allow()                 # fail fast while cooling down
    clock.advance(1.0)
    assert br.allow()                     # exactly one half-open probe
    assert br.state == BreakerState.HALF_OPEN
    assert not br.allow()                 # second caller is NOT the probe
    br.on_success()
    assert br.state == BreakerState.CLOSED


def test_breaker_probe_failure_doubles_cooldown():
    clock = VirtualClock()
    br = CircuitBreaker(clock, failure_threshold=1, cooldown_s=1.0,
                        max_cooldown_s=30.0)
    br.on_failure()
    clock.advance(1.0)
    assert br.allow()                     # probe
    br.on_failure()                       # probe fails: re-open, 2x cooldown
    assert br.state == BreakerState.OPEN and br.opens == 2
    clock.advance(1.0)
    assert not br.allow()                 # old cooldown is no longer enough
    clock.advance(1.0)
    assert br.allow()
    br.on_success()                       # close resets to base cooldown
    br.on_failure()
    clock.advance(1.0)
    assert br.allow()


# ---------------------------------------------------------------------------
# ResilientStore wrapper
# ---------------------------------------------------------------------------

def test_wrap_store_coercion():
    store = MemoryObjectStore(clock=VirtualClock())
    assert wrap_store(store, None) is store
    assert wrap_store(store, False) is store
    wrapped = wrap_store(store, True)
    assert isinstance(wrapped, ResilientStore)
    assert wrap_store(wrapped, True) is wrapped   # never double-wrapped
    with pytest.raises(TypeError):
        ResilientStore(wrapped)


def test_resilient_store_retries_through_transients():
    clock = VirtualClock()
    inner = MemoryObjectStore(clock=clock)
    faulty = FaultyObjectStore(inner, FaultPolicy(get_error_rate=1.0,
                                                  max_faults=2))
    rs = ResilientStore(faulty, ResilienceConfig(seed=0, hedge=None,
                                                 base_delay_s=0.001))
    rs.put("k", b"payload")
    assert rs.get("k") == b"payload"      # 2 injected faults, then success
    assert rs.resilience.retries == 2
    assert rs.breaker.state == BreakerState.CLOSED


class _ThrottleOnceStore(MemoryObjectStore):
    def __init__(self, clock):
        super().__init__(clock=clock)
        self._fired = False

    def get(self, key):
        if not self._fired:
            self._fired = True
            raise ThrottledError(retry_after_s=0.2)
        return super().get(key)


def test_throttle_feeds_governor_not_breaker():
    clock = VirtualClock()
    inner = _ThrottleOnceStore(clock)
    # threshold 1 would open on the very first hard failure — proving a
    # SlowDown must not count as one
    rs = ResilientStore(inner, ResilienceConfig(
        seed=0, hedge=None, base_delay_s=5.0, breaker_failure_threshold=1))
    rs.put("k", b"v")
    clock.advance(1.0)   # space the ops so the observed-rate estimate is sane
    t0 = clock.now()
    assert rs.get("k") == b"v"
    # slept the server's Retry-After exactly, not the 5s backoff draw
    assert clock.now() - t0 == pytest.approx(0.2)
    assert rs.resilience.throttled == 1
    assert rs.resilience.throttle_pause_s == pytest.approx(0.2)
    assert rs.governor.active and rs.governor.throttle_events == 1
    assert rs.breaker.state == BreakerState.CLOSED


def test_put_if_absent_is_never_retried_by_the_store_layer():
    # conditional-put ambiguity belongs to the commit protocol: a blind
    # store-level retry would double-apply the lost-ack accounting
    clock = VirtualClock()
    inner = MemoryObjectStore(clock=clock)
    faulty = FaultyObjectStore(inner, FaultPolicy(
        cput_error_rate=1.0, cput_lost_ack_rate=0.0, max_faults=1))
    rs = ResilientStore(faulty, ResilienceConfig(seed=0, hedge=None))
    with pytest.raises(TransientStoreError):
        rs.put_if_absent("m/1", b"x")     # a retry would have succeeded
    assert rs.put_if_absent("m/1", b"x") is True


class _BlockingFirstGet(MemoryObjectStore):
    """First GET parks on an event (the slow primary); later GETs answer
    immediately (the hedge)."""

    def __init__(self):
        super().__init__()
        self.release = threading.Event()
        self._calls = 0
        self._call_lock = threading.Lock()

    def get(self, key):
        with self._call_lock:
            self._calls += 1
            first = self._calls == 1
        if first:
            self.release.wait(timeout=10.0)
        return super().get(key)


def test_hedged_read_second_request_wins():
    inner = _BlockingFirstGet()
    rs = ResilientStore(inner, ResilienceConfig(
        seed=0, hedge=HedgePolicy(quantile=0.5, min_samples=4,
                                  min_delay_s=0.001)))
    rs.put("k", b"v" * 32)
    for _ in range(8):                    # seed the latency model
        rs.resilience.hedge_wait_s.append(0.005)
    try:
        assert rs.get("k") == b"v" * 32   # primary is stuck; hedge answers
        assert rs.resilience.hedges_fired == 1
        assert rs.resilience.hedges_won == 1
        assert rs.resilience.hedge_win_rate == 1.0
    finally:
        inner.release.set()
        rs.close()


def test_hedge_threshold_needs_a_latency_model():
    inner = MemoryObjectStore(clock=VirtualClock())
    rs = ResilientStore(inner, ResilienceConfig(
        seed=0, hedge=HedgePolicy(quantile=0.9, min_samples=8,
                                  min_delay_s=0.002)))
    assert rs._hedge_threshold() is None          # no samples yet
    for _ in range(8):
        rs.resilience.hedge_wait_s.append(0.0001)
    assert rs._hedge_threshold() is None          # too fast to hedge
    for _ in range(8):
        rs.resilience.hedge_wait_s.append(0.05)
    assert rs._hedge_threshold() >= 0.002


# ---------------------------------------------------------------------------
# producer: flaky trim probe + spill/replay
# ---------------------------------------------------------------------------

def _producer_ns(clock=None):
    clock = clock or VirtualClock()
    inner = MemoryObjectStore(clock=clock)
    faulty = FaultyObjectStore(inner, FaultPolicy())
    return Namespace(faulty, "runs/resil"), faulty


def test_lag_exceeded_reuses_last_trim_on_flaky_probe():
    ns, faulty = _producer_ns()
    p = Producer(ns, "p0", dp=1, cp=1, manifests=ManifestStore(ns), max_lag=4)
    for _ in range(4):
        p.write_tgb(uniform_slice_bytes=64)
        p.maybe_commit(force=True)
    # no trim marker yet and no cached value: 4 steps ahead of 0 -> pause
    faulty.policy = FaultPolicy(get_error_rate=1.0, key_filter="trim")
    assert p.lag_exceeded() is True
    # healthy probe reads safe_step=3 (1 ahead) and caches it
    faulty.policy = FaultPolicy()
    ns.store.put(ns.trim_key(),
                 _msgpack.packb({"safe_step": 3, "safe_version": 1}))
    assert p.lag_exceeded() is False
    # flaky probe again: the cached value keeps the pool producing — the old
    # behavior (treat the failed read as step 0) stalled every producer here
    faulty.policy = FaultPolicy(get_error_rate=1.0, key_filter="trim")
    assert p.lag_exceeded() is False


def test_producer_spills_and_replays_in_seq_order():
    ns, faulty = _producer_ns()
    p = Producer(ns, "p0", dp=1, cp=1, manifests=ManifestStore(ns),
                 spill_limit=8)
    faulty.policy = FaultPolicy(put_error_rate=1.0, key_filter="/tgb/")
    for _ in range(3):
        p.write_tgb(uniform_slice_bytes=64)
    assert p.spilled == 3 and p.stats.tgbs_spilled == 3
    assert p.pending == []                       # nothing durable yet
    assert p.stats.store_degraded == 1.0
    faulty.policy = FaultPolicy()                # store recovers
    p.write_tgb(uniform_slice_bytes=64)          # triggers replay first
    assert p.spilled == 0 and p.stats.spill_replayed == 3
    assert [d.producer_seq for d in p.pending] == [0, 1, 2, 3]
    assert p.stats.store_degraded == 0.0
    assert p.maybe_commit(force=True)
    assert p.protocol.view.total_steps == 4      # exactly-once, in order


def test_spill_queue_full_is_backpressure_not_a_gap():
    ns, faulty = _producer_ns()
    p = Producer(ns, "p0", dp=1, cp=1, manifests=ManifestStore(ns),
                 spill_limit=2)
    faulty.policy = FaultPolicy(put_error_rate=1.0, key_filter="/tgb/")
    p.write_tgb(uniform_slice_bytes=64)
    p.write_tgb(uniform_slice_bytes=64)
    assert p.spill_full
    with pytest.raises(TransientStoreError):
        p.write_tgb(uniform_slice_bytes=64)
    # the failed offset was NOT consumed: no hole in the stream on retry
    assert p.next_offset == 2


def test_write_tgb_without_spilling_keeps_offset_reusable():
    ns, faulty = _producer_ns()
    p = Producer(ns, "p0", dp=1, cp=1, manifests=ManifestStore(ns))
    faulty.policy = FaultPolicy(put_error_rate=1.0, key_filter="/tgb/")
    with pytest.raises(TransientStoreError):
        p.write_tgb(uniform_slice_bytes=64)
    assert p.next_offset == 0
    faulty.policy = FaultPolicy()
    desc = p.write_tgb(uniform_slice_bytes=64)   # retry reuses offset 0
    assert desc.producer_seq == 0 and p.next_offset == 1


# ---------------------------------------------------------------------------
# consumer: degraded mode end to end
# ---------------------------------------------------------------------------

def test_consumer_rides_out_an_outage_behind_the_breaker():
    clock = VirtualClock()
    inner = MemoryObjectStore(clock=clock)
    faulty = FaultyObjectStore(inner, FaultPolicy())
    rs = ResilientStore(faulty, ResilienceConfig(
        seed=0, hedge=None, read_attempts=2, write_attempts=2,
        base_delay_s=0.001, backoff_cap_s=0.01,
        breaker_failure_threshold=2, breaker_cooldown_s=0.05,
        retry_budgets={"read": (64.0, 32.0), "write": (64.0, 32.0),
                       "control": (64.0, 32.0)}))
    ns = Namespace(rs, "runs/resil")
    p = Producer(ns, "p0", dp=1, cp=1, manifests=ManifestStore(ns))
    for _ in range(3):
        p.write_tgb(uniform_slice_bytes=128)
        p.maybe_commit(force=True)

    cons = Consumer(ns, MeshPosition(0, 0, 1, 1), prefetch_depth=0)
    assert len(cons.next_batch(timeout_s=5.0)) == 128   # healthy

    # TGB reads black out; the breaker opens and the consumer waits it out
    # inside the batch deadline instead of crashing or retry-storming
    faulty.policy = FaultPolicy(get_error_rate=1.0, key_filter="/tgb/",
                                max_faults=6)
    assert len(cons.next_batch(timeout_s=60.0)) == 128
    assert rs.resilience.breaker_opens >= 1
    assert rs.resilience.breaker_fastfail >= 1
    assert not rs.degraded                      # recovered via the probe
    assert cons.stats.store_degraded == 1.0     # gauge held through outage

    assert len(cons.next_batch(timeout_s=5.0)) == 128   # healthy again
    assert cons.stats.store_degraded == 0.0     # ...and the gauge cleared


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

TOPO_ARGS = dict(dp=2, cp=2, global_batch=4, seq_len=16)


def _stream(n_batches: int = 5):
    import numpy as np
    n = n_batches * TOPO_ARGS["global_batch"] * TOPO_ARGS["seq_len"]
    return ((np.arange(n) * 7 + 3) % 1000).astype(np.int32)


def _storm_run(core, dp, stream):
    """A resilient tgb session over a store that admits 40 ops/s for its
    first second of virtual time, with 503 SlowDown beyond that: one writer
    commits ``stream``, then every (d, c) reader drains it. Returns (inner
    store, [(d, c, step, tokens bytes)], throttles seen, injected)."""
    clock = core.VirtualClock()
    inner = core.MemoryObjectStore(clock=clock)
    faulty = core.FaultyObjectStore(inner, core.FaultPolicy(seed=0))
    faulty.script_brownout([core.BrownoutPhase(
        0.0, 1.0, target_rate=40.0, retry_after_s=0.05)])
    cfg = core.ResilienceConfig(seed=0, hedge=None)
    sess = dp.open_dataplane(faulty, dp.Topology(**TOPO_ARGS),
                             namespace="runs/storm", resilience=cfg)
    with sess.writer("w0", policy=core.NaivePolicy()) as w:
        w.write_tokens(stream)
    rows = []
    n = len(stream) // (TOPO_ARGS["global_batch"] * TOPO_ARGS["seq_len"])
    for d in range(TOPO_ARGS["dp"]):
        for c in range(TOPO_ARGS["cp"]):
            r = sess.reader(dp_rank=d, cp_rank=c, prefetch_depth=0)
            for _ in range(n):
                b = r.next_batch(timeout_s=60)
                rows.append((d, c, b.step, b.tokens.tobytes()))
    throttled = sess.store.resilience.throttled
    injected = faulty.fault_stats.counts.get("throttled", 0)
    sess.close()
    return inner, rows, throttled, injected


def test_a_resilient_storm_run_equals_the_references():
    """The same scripted SlowDown storm on a virtual clock: the port's
    resilient session delivers the reference's batches with the reference's
    throttle count, and each package reads the other's store back."""
    pytest.importorskip("jax")
    pytest.importorskip("msgpack")
    import repro.core as jcore
    import repro.dataplane as jdp
    import repro_torch.core as tcore
    import repro_torch.dataplane as tdp
    stream = _stream()
    t_inner, t_rows, t_thr, t_inj = _storm_run(tcore, tdp, stream)
    j_inner, j_rows, j_thr, j_inj = _storm_run(jcore, jdp, stream)
    assert t_thr > 0 and t_inj > 0           # the storm bit
    assert (t_rows, t_thr, t_inj) == (j_rows, j_thr, j_inj)
    # the port's resilient writes read back in the JAX package, and back
    for inner, pkg in ((t_inner, jdp), (j_inner, tdp)):
        core = jcore if pkg is jdp else tcore
        view = core.MemoryObjectStore()
        view._objects, view._lock = inner._objects, inner._lock
        sess = pkg.open_dataplane(view, pkg.Topology(**TOPO_ARGS),
                                  namespace="runs/storm")
        got = []
        for d in range(TOPO_ARGS["dp"]):
            for c in range(TOPO_ARGS["cp"]):
                r = sess.reader(dp_rank=d, cp_rank=c)
                got += [(d, c, b.step, b.tokens.tobytes()) for b in
                        (r.next_batch(timeout_s=5) for _ in range(5))]
        sess.close()
        assert got == t_rows


def test_resilient_session_shares_one_wrapper_and_publishes_store_snapshots():
    """``resilience=`` wraps the session's store once for every client it
    vends; with ``obs_snap_interval_s`` the wrapper's ``store.*`` counters
    land under ``<ns>/obs/`` through the inner store."""
    import repro_torch.dataplane as tdp
    from repro_torch.obs.recorder import latest_snapshot
    inner = MemoryObjectStore()
    sess = tdp.open_dataplane(inner, tdp.Topology(**TOPO_ARGS),
                              namespace="runs/obs", resilience=True,
                              obs_snap_interval_s=0.0)
    assert isinstance(sess.store, ResilientStore)
    with sess.writer("w0") as w:
        w.write_tokens(_stream(2))
    r = sess.reader(dp_rank=0, cp_rank=0)
    r.next_batch(timeout_s=5)
    assert r.consumer.store is sess.store
    scope = sess.store.resilience.metric_scope
    snap = latest_snapshot(Namespace(inner, "runs/obs"), scope)
    assert snap is not None and f"{scope}.retries" in snap["metrics"]
    sess.close()
