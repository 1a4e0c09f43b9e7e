"""Brownout-resilient storage client: the layer between every component and
the ``ObjectStore`` (port of ``repro.core.resilience``, copied as it is but
for its imports and one fix: a half-open probe that misses closes the
breaker, ``CircuitBreaker.on_miss``).

Real object stores do not fail in one flavor. They throttle (503 SlowDown
with Retry-After), they brown out (windows of heavily inflated tail latency),
and they go away entirely for seconds at a time. ``ResilientStore`` wraps any
backend behind the normal ``ObjectStore`` API and gives every client — the
producer, the consumer/prefetch path, the commit protocol, the reclaimer —
one shared survival kit:

  * **backoff + retry budgets** — every retryable op uses exponential backoff
    with decorrelated jitter (``repro_torch.core.errors.backoff_delays``) and draws
    re-attempts from a per-op-class token bucket (``RetryBudget``), so a
    brownout cannot amplify into a client-side retry storm;
  * **throttle awareness** — a ``ThrottledError`` pauses exactly
    ``retry_after_s`` and feeds the process-wide AIMD ``RateGovernor``:
    offered load is cut multiplicatively for *every* client of the store and
    recovers additively once the SlowDown storm passes;
  * **hedged reads** — data-path ranged GETs fire a second request once the
    first has been in flight past a configurable latency quantile; first
    result wins, the loser is cancelled/ignored (GetBatch: batch assembly is
    dominated by the slowest object's tail);
  * **circuit breaker** — consecutive hard failures flip the breaker open
    and every call fails fast with ``CircuitOpenError`` until a half-open
    probe succeeds. Fast failure is what lets components enter *degraded
    mode* (consumers serve prefetched TGBs, producers spill built TGBs)
    instead of hanging inside retry loops.

The wrapper is transparent: ``stats``/``clock``/``latency`` delegate to the
inner store, so existing accounting, fault injection, and fsck/ops tooling
keep working unchanged underneath it.
"""
from __future__ import annotations

import random
import threading
from concurrent.futures import FIRST_COMPLETED, wait
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.clock import Clock
from repro_torch.core.errors import (CircuitOpenError,
                                     RetryBudgetExhausted, ThrottledError,
                                     TransientStoreError, backoff_delays,
                                     retry_transient)
from repro_torch.core.objectstore import (DEFAULT_COALESCE_GAP, IOPool,
                                          ObjectStore)
from repro_torch.obs.registry import COUNTER, GAUGE, HISTOGRAM, StatsView

__all__ = ["AIMDGovernor", "BreakerState", "CircuitBreaker", "HedgePolicy",
           "ResilienceConfig", "ResilientStore", "RetryBudget",
           "StoreResilienceStats", "shared_governor", "wrap_store"]


# ---------------------------------------------------------------------------
# Retry budgets
# ---------------------------------------------------------------------------

class RetryBudget:
    """Token bucket bounding *re-attempts* per op class.

    First attempts are always free — the budget only meters retries, which is
    the traffic class that multiplies during brownouts. Tokens refill at
    ``refill_per_s`` up to ``capacity``; ``try_spend`` returns False when the
    bucket is dry, which ``retry_transient`` converts into a fail-fast
    ``RetryBudgetExhausted``.
    """

    def __init__(self, clock: Clock, capacity: float = 10.0,
                 refill_per_s: float = 2.0):
        if capacity <= 0:
            raise ValueError("retry budget capacity must be positive")
        self.clock = clock
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(capacity)
        self._last = clock.now()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self.clock.now()
        dt = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.capacity,
                           self._tokens + dt * self.refill_per_s)

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill()
            if self._tokens < n:
                return False
            self._tokens -= n
            return True

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill()
            return self._tokens


# ---------------------------------------------------------------------------
# AIMD rate governor (process-wide per store)
# ---------------------------------------------------------------------------

class AIMDGovernor:
    """Collective offered-load control during SlowDown storms.

    Dormant in steady state (zero cost, no admission delay). The first
    ``ThrottledError`` activates it: the admitted rate is set from the
    recently *observed* op rate cut by ``md_factor``, and all admissions
    pause once for the server-provided ``retry_after_s`` (the collective
    "whoa" — individual retries additionally honor their own Retry-After
    inside ``retry_transient``). Subsequent throttles cut multiplicatively,
    but at most once per ``cut_cooldown_s``: a storm throttles many in-flight
    ops at once, and counting one congestion signal N times would collapse
    the rate far below what the server is actually asking for. Successful
    ops recover the rate additively (``ai_per_s`` per second of success)
    until it exceeds the observed demand again — or the store simply stops
    throttling for ``idle_reset_s`` — at which point the governor returns to
    dormancy.

    One instance is shared by every ``ResilientStore`` wrapping the same
    inner store (see ``shared_governor``), which is what makes the backoff
    *collective*: producers, consumers, and the reclaimer all slow down
    together instead of taking turns being throttled.
    """

    def __init__(self, clock: Clock, md_factor: float = 0.5,
                 ai_per_s: float = 2.0, min_rate: float = 1.0,
                 observe_window_s: float = 2.0,
                 idle_reset_s: float = 30.0,
                 cut_cooldown_s: float = 0.25):
        self.clock = clock
        self.md_factor = md_factor
        self.ai_per_s = ai_per_s
        self.min_rate = min_rate
        self.observe_window_s = observe_window_s
        self.idle_reset_s = idle_reset_s
        self.cut_cooldown_s = cut_cooldown_s
        self._lock = threading.Lock()
        self._rate: Optional[float] = None   # None = dormant (ungoverned)
        self._pause_until = float("-inf")
        self._next_slot = float("-inf")
        self._last_increase = float("-inf")
        self._last_throttle = float("-inf")
        self._last_cut = float("-inf")
        # recent op timestamps, for estimating demand when activating
        self._recent: List[float] = []
        self.throttle_events = 0

    @property
    def rate(self) -> float:
        """Currently admitted ops/s (0.0 = dormant / unlimited)."""
        with self._lock:
            return self._rate or 0.0

    @property
    def active(self) -> bool:
        with self._lock:
            return self._rate is not None

    def _observe(self, now: float) -> None:
        self._recent.append(now)
        horizon = now - self.observe_window_s
        while self._recent and self._recent[0] < horizon:
            self._recent.pop(0)

    def _observed_rate(self, now: float) -> float:
        n = len(self._recent)
        if n < 2:
            return self.min_rate
        span = max(1e-6, now - self._recent[0])
        return n / span

    def admit(self) -> float:
        """Block (via ``clock.sleep``) until this op is admitted. Returns the
        seconds slept so callers can account governor delay."""
        slept = 0.0
        while True:
            with self._lock:
                now = self.clock.now()
                self._observe(now)
                if self._rate is None:
                    return slept
                wait_s = max(self._pause_until - now,
                             self._next_slot - now)
                if wait_s <= 0:
                    self._next_slot = max(self._next_slot, now) \
                        + 1.0 / self._rate
                    return slept
            self.clock.sleep(wait_s)
            slept += wait_s

    def on_throttle(self, retry_after_s: Optional[float] = None) -> None:
        with self._lock:
            now = self.clock.now()
            self.throttle_events += 1
            if self._rate is None:
                # activate: start from the observed demand, cut once, and
                # pause everyone for the server's Retry-After while the
                # paced rate takes effect
                self._rate = max(self.min_rate,
                                 self._observed_rate(now) * self.md_factor)
                if retry_after_s:
                    self._pause_until = max(self._pause_until,
                                            now + retry_after_s)
                self._last_cut = now
            elif now - self._last_cut >= self.cut_cooldown_s:
                # one multiplicative cut per congestion epoch
                self._rate = max(self.min_rate, self._rate * self.md_factor)
                self._last_cut = now
            self._last_increase = now
            self._last_throttle = now

    def on_success(self) -> None:
        with self._lock:
            if self._rate is None:
                return
            now = self.clock.now()
            dt = max(0.0, now - self._last_increase)
            if dt <= 0:
                return
            self._last_increase = now
            self._rate += self.ai_per_s * dt
            # return to dormancy (zero-cost steady state; the next storm
            # re-activates from observed rate) when either the admitted rate
            # has recovered well past demand, or the store has not throttled
            # for a full idle window — additive recovery alone would take
            # rate/ai_per_s seconds after a storm that is already over
            if (self._rate > 2.0 * self._observed_rate(now)
                    and self._rate > 4.0 * self.min_rate) \
                    or now - self._last_throttle >= self.idle_reset_s:
                self._rate = None


def wrap_store(store: ObjectStore, resilience) -> ObjectStore:
    """Coerce a session's ``resilience=`` option into a store.

    ``None``/``False`` return the store unwrapped; ``True`` wraps it with
    default ``ResilienceConfig``; a ``ResilienceConfig`` wraps with that
    config. An already-wrapped store passes through unchanged (sessions over
    the same backend share one wrapper's breaker/governor state).
    """
    if not resilience:
        return store
    if isinstance(store, ResilientStore):
        return store
    cfg = resilience if isinstance(resilience, ResilienceConfig) else None
    return ResilientStore(store, cfg)


_governor_lock = threading.Lock()


def shared_governor(inner: ObjectStore, **kw) -> AIMDGovernor:
    """The one process-wide governor for ``inner`` (stashed on the store
    object itself, so every ``ResilientStore`` wrapping it — across sessions,
    streams, and components — shares the same admitted rate)."""
    with _governor_lock:
        gov = getattr(inner, "_bw_governor", None)
        if gov is None:
            gov = AIMDGovernor(inner.clock, **kw)
            inner._bw_governor = gov
        return gov


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

class BreakerState:
    CLOSED = 0
    HALF_OPEN = 1
    OPEN = 2


class CircuitBreaker:
    """Per-store breaker with half-open probing.

    ``failure_threshold`` consecutive hard failures (transient 5xx — NOT
    throttles, which the governor owns) open the breaker. While open, every
    ``allow()`` answers False (callers fail fast with ``CircuitOpenError``)
    until ``cooldown_s`` elapses; then exactly one caller is admitted as the
    half-open probe. Probe success closes the breaker and resets the
    cooldown; failure re-opens it with the cooldown doubled (capped).
    """

    def __init__(self, clock: Clock, failure_threshold: int = 5,
                 cooldown_s: float = 1.0, max_cooldown_s: float = 30.0):
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.base_cooldown_s = cooldown_s
        self.max_cooldown_s = max_cooldown_s
        self._cooldown_s = cooldown_s
        self._state = BreakerState.CLOSED
        self._failures = 0
        self._opened_at = float("-inf")
        self._probe_inflight = False
        self._lock = threading.Lock()
        self.opens = 0          # total CLOSED/HALF_OPEN -> OPEN transitions
        self.transitions: List[Tuple[float, int]] = []  # (t, new_state)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _set_state(self, state: int) -> None:
        if state != self._state:
            self._state = state
            self.transitions.append((self.clock.now(), state))
            if len(self.transitions) > 256:
                del self.transitions[:-256]

    def allow(self) -> bool:
        """May a call proceed right now? (May admit one half-open probe.)"""
        with self._lock:
            if self._state == BreakerState.CLOSED:
                return True
            now = self.clock.now()
            if self._state == BreakerState.OPEN and \
                    now - self._opened_at >= self._cooldown_s:
                self._set_state(BreakerState.HALF_OPEN)
                self._probe_inflight = False
            if self._state == BreakerState.HALF_OPEN and \
                    not self._probe_inflight:
                self._probe_inflight = True   # this caller IS the probe
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != BreakerState.CLOSED:
                self._cooldown_s = self.base_cooldown_s
                self._set_state(BreakerState.CLOSED)

    def on_miss(self) -> None:
        """The store answered with a miss (no such key). A half-open probe
        has its answer and closes the breaker; otherwise nothing changes.
        The reference records nothing for a miss, so a probe that misses (a
        reader polling for the next manifest) holds the breaker half-open
        for good and every later call fails fast (ROADMAP Queue 3)."""
        with self._lock:
            if self._state == BreakerState.HALF_OPEN and self._probe_inflight:
                self._failures = 0
                self._probe_inflight = False
                self._cooldown_s = self.base_cooldown_s
                self._set_state(BreakerState.CLOSED)

    def on_failure(self) -> None:
        with self._lock:
            now = self.clock.now()
            if self._state == BreakerState.HALF_OPEN:
                # the probe failed: back to OPEN, cooldown doubled
                self._cooldown_s = min(self.max_cooldown_s,
                                       self._cooldown_s * 2.0)
                self._probe_inflight = False
                self._opened_at = now
                self.opens += 1
                self._set_state(BreakerState.OPEN)
                return
            self._failures += 1
            if self._state == BreakerState.CLOSED and \
                    self._failures >= self.failure_threshold:
                self._opened_at = now
                self.opens += 1
                self._set_state(BreakerState.OPEN)


# ---------------------------------------------------------------------------
# Config + stats
# ---------------------------------------------------------------------------

@dataclass
class HedgePolicy:
    """Hedged-read knobs. A hedge fires once the primary has been in flight
    longer than the ``quantile`` of recently observed read latencies; below
    ``min_samples`` observations no hedge ever fires (no model to hedge
    against)."""

    quantile: float = 0.95
    min_samples: int = 20
    #: never hedge before this many seconds in flight (guards against
    #: hedging microsecond-fast local stores into pure overhead)
    min_delay_s: float = 0.002
    #: hedge-pool workers (dedicated pool: hedged ops must not starve the
    #: shared prefetch IOPool, and vice versa)
    max_workers: int = 8


@dataclass
class ResilienceConfig:
    """All knobs of one ``ResilientStore``. The defaults are safe for the
    in-repo simulated stores; real deployments mostly tune the budgets."""

    #: attempts per op (1 initial + N-1 retries) for reads/control ops
    read_attempts: int = 4
    write_attempts: int = 4
    base_delay_s: float = 0.01
    backoff_cap_s: float = 1.0
    #: per-op-class retry token buckets: {op_class: (capacity, refill_per_s)}
    retry_budgets: Dict[str, Tuple[float, float]] = field(
        default_factory=lambda: {"read": (16.0, 4.0), "write": (16.0, 4.0),
                                 "control": (16.0, 4.0)})
    hedge: Optional[HedgePolicy] = field(default_factory=HedgePolicy)
    #: circuit breaker knobs (None disables the breaker)
    breaker_failure_threshold: int = 5
    breaker_cooldown_s: float = 0.5
    breaker_max_cooldown_s: float = 30.0
    #: AIMD governor knobs
    governor_md_factor: float = 0.5
    governor_ai_per_s: float = 4.0
    governor_min_rate: float = 2.0
    #: deactivate the governor after this long without a ThrottledError
    governor_idle_reset_s: float = 30.0
    #: at most one multiplicative cut per this window (congestion epoch)
    governor_cut_cooldown_s: float = 0.25
    #: seed for this store's backoff jitter (None = process RNG)
    seed: Optional[int] = None


class StoreResilienceStats(StatsView):
    """Registry-backed resilience counters (``store.<instance>.*``) — the
    numbers ``batchweave obs`` renders for brownout diagnosis."""

    _FAMILY = "store"
    _SPEC = {
        "retries": COUNTER,             # backoff re-attempts issued
        "throttled": COUNTER,           # ThrottledErrors observed
        "throttle_pause_s": GAUGE,      # total seconds honoring Retry-After
        "governor_delay_s": GAUGE,      # total seconds waiting for admission
        "governor_rate": GAUGE,         # admitted ops/s (0 = dormant)
        "retry_budget_exhausted": COUNTER,
        "hedges_fired": COUNTER,
        "hedges_won": COUNTER,          # hedge finished before the primary
        "hedge_wait_s": HISTOGRAM,      # observed primary latencies (hedge model)
        "breaker_state": GAUGE,         # 0 closed / 1 half-open / 2 open
        "breaker_opens": COUNTER,
        "breaker_fastfail": COUNTER,    # calls rejected while open
    }

    @property
    def hedge_win_rate(self) -> float:
        return self.hedges_won / max(1, self.hedges_fired)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

#: op -> (op class, retryable?) — conditional put is deliberately NOT retried
#: here: its ambiguity is the commit protocol's to resolve (re-read the
#: targeted version), and a blind store-level retry would double-apply the
#: lost-ack accounting.
_OP_CLASSES = {
    "get": ("read", True), "get_range": ("read", True),
    "get_ranges": ("read", True),
    "head": ("control", True), "list": ("control", True),
    "delete": ("control", True),
    "put": ("write", True), "put_if_absent": ("write", False),
}


class ResilientStore(ObjectStore):
    """Resilience layer over any ``ObjectStore`` backend.

    Every public op is wrapped with (in order): AIMD admission, circuit
    breaker check, budgeted backoff retries with throttle awareness; ranged
    data-path GETs additionally hedge. ``stats``/``clock``/``latency``/
    ``faults`` alias the inner store's, so latency modeling, fault injection,
    and byte accounting are charged exactly once, underneath this layer.
    """

    def __init__(self, inner: ObjectStore,
                 config: Optional[ResilienceConfig] = None,
                 governor: Optional[AIMDGovernor] = None,
                 stats_instance: Optional[str] = None):
        if isinstance(inner, ResilientStore):
            raise TypeError("refusing to stack ResilientStore on itself")
        # no super().__init__: all accounting lives in the inner store
        self.inner = inner
        self.config = config or ResilienceConfig()
        self.latency = inner.latency
        self.clock = inner.clock
        self.faults = inner.faults
        self.stats = inner.stats            # StoreStats pass-through
        self._stats_lock = getattr(inner, "_stats_lock", threading.Lock())
        cfg = self.config
        self.resilience = StoreResilienceStats(stats_instance or "s0")
        self.governor = governor if governor is not None else shared_governor(
            inner, md_factor=cfg.governor_md_factor,
            ai_per_s=cfg.governor_ai_per_s, min_rate=cfg.governor_min_rate,
            idle_reset_s=cfg.governor_idle_reset_s,
            cut_cooldown_s=cfg.governor_cut_cooldown_s)
        self.breaker = CircuitBreaker(
            inner.clock, failure_threshold=cfg.breaker_failure_threshold,
            cooldown_s=cfg.breaker_cooldown_s,
            max_cooldown_s=cfg.breaker_max_cooldown_s)
        self.budgets = {cls: RetryBudget(inner.clock, cap, refill)
                        for cls, (cap, refill) in cfg.retry_budgets.items()}
        self._rng = random.Random(cfg.seed) if cfg.seed is not None else None
        self._hedge_pool: Optional[IOPool] = None
        self._hedge_lock = threading.Lock()
        self._recorder = None

    def attach_recorder(self, ns, interval_s: float) -> None:
        """Publish this wrapper's ``store.*`` counters as flight-recorder
        snapshots under ``ns`` so ``batchweave obs`` renders hedge win rate
        and breaker state from storage alone. Snapshots go through the
        *inner* store: obs writes never recurse through the resilience layer
        (and never block on an open breaker — failed snaps are counted and
        dropped by the recorder)."""
        from repro_torch.core.objectstore import Namespace
        from repro_torch.obs.recorder import FlightRecorder
        self._recorder = FlightRecorder(Namespace(self.inner, ns.prefix),
                                        self.resilience.metric_scope,
                                        interval_s=interval_s)

    # -- degraded-mode probe (clients poll this to flip modes) -------------
    @property
    def degraded(self) -> bool:
        """True while the breaker is not closed — clients should serve from
        prefetched/spilled state and avoid new store round trips."""
        return self.breaker.state != BreakerState.CLOSED

    # -- plumbing ----------------------------------------------------------
    def _budget(self, op_class: str) -> Optional[RetryBudget]:
        return self.budgets.get(op_class)

    def _hedge_threshold(self) -> Optional[float]:
        cfg = self.config.hedge
        if cfg is None:
            return None
        lat = self.resilience.hedge_wait_s
        if len(lat) < cfg.min_samples:
            return None
        from repro_torch.core.stats import percentile
        thr = percentile(list(lat), cfg.quantile * 100.0)
        if thr != thr or thr < cfg.min_delay_s:  # NaN or too fast to hedge
            return None
        return thr

    def _hedge_executor(self) -> IOPool:
        with self._hedge_lock:
            if self._hedge_pool is None:
                workers = self.config.hedge.max_workers if self.config.hedge \
                    else 2
                self._hedge_pool = IOPool(max_workers=workers,
                                          name="bw-hedge")
            return self._hedge_pool

    def _record_outcome(self, ok: bool, throttled: bool = False) -> None:
        r = self.resilience
        if throttled:
            # throttling is load shedding, not unavailability: the governor
            # owns it; the breaker must not open on SlowDown storms
            return
        if ok:
            self.breaker.on_success()
            self.governor.on_success()
        else:
            self.breaker.on_failure()
        r.breaker_state = self.breaker.state
        r.breaker_opens = self.breaker.opens

    def _call(self, op: str, fn, *args, **kw):
        """The resilience wrapper every public op funnels through."""
        op_class, retryable = _OP_CLASSES[op]
        cfg = self.config
        r = self.resilience
        slept = self.governor.admit()
        if slept:
            r.governor_delay_s += slept
        r.governor_rate = self.governor.rate
        attempts = (cfg.read_attempts if op_class in ("read", "control")
                    else cfg.write_attempts)
        if not retryable:
            attempts = 1

        def once():
            if not self.breaker.allow():
                r.breaker_fastfail += 1
                r.breaker_state = self.breaker.state
                raise CircuitOpenError(
                    f"circuit open for {op} (cooldown in progress)")
            try:
                out = fn(*args, **kw)
            except ThrottledError as e:
                r.throttled += 1
                self.governor.on_throttle(e.retry_after_s)
                r.governor_rate = self.governor.rate
                if e.retry_after_s:
                    r.throttle_pause_s += e.retry_after_s
                self._record_outcome(False, throttled=True)
                raise
            except TransientStoreError:
                self._record_outcome(False)
                raise
            except KeyError:
                self.breaker.on_miss()
                r.breaker_state = self.breaker.state
                raise
            self._record_outcome(True)
            return out

        def count_retry(_attempt: int) -> None:
            r.retries += 1

        try:
            return retry_transient(
                once, self.clock, attempts=attempts,
                base_delay_s=cfg.base_delay_s, cap_s=cfg.backoff_cap_s,
                budget=self._budget(op_class) if retryable else None,
                on_retry=count_retry, rng=self._rng)
        except RetryBudgetExhausted:
            r.retry_budget_exhausted += 1
            raise
        finally:
            if self._recorder is not None:
                self._recorder.maybe_snap()

    def _hedged_read(self, op: str, fn, *args, **kw):
        """Ranged data-path GET with tail hedging: fire a second identical
        request once the primary exceeds the configured latency quantile;
        first completion wins, the loser is cancelled (or its result
        dropped — reads are idempotent, so a landed loser costs only
        bytes)."""
        threshold = self._hedge_threshold()
        r = self.resilience
        t0 = self.clock.now()
        if threshold is None:
            out = self._call(op, fn, *args, **kw)
            r.hedge_wait_s.append(self.clock.now() - t0)
            return out
        pool = self._hedge_executor()
        primary = pool.submit(self._call, op, fn, *args, **kw)
        done, _ = wait([primary], timeout=threshold)
        if done:
            r.hedge_wait_s.append(self.clock.now() - t0)
            return primary.result()
        r.hedges_fired += 1
        hedge = pool.submit(self._call, op, fn, *args, **kw)
        futures = {primary, hedge}
        winner_exc = None
        while futures:
            done, futures = wait(futures, return_when=FIRST_COMPLETED)
            for fut in done:
                exc = fut.exception()
                if exc is None:
                    if fut is hedge:
                        r.hedges_won += 1
                    for loser in futures:
                        loser.cancel()
                    r.hedge_wait_s.append(self.clock.now() - t0)
                    return fut.result()
                winner_exc = exc
        raise winner_exc  # both attempts failed: surface the last error

    # -- public API --------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        return self._call("put", self.inner.put, key, data)

    def put_if_absent(self, key: str, data: bytes) -> bool:
        return self._call("put_if_absent", self.inner.put_if_absent, key, data)

    def get(self, key: str) -> bytes:
        return self._hedged_read("get", self.inner.get, key)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        return self._hedged_read("get_range", self.inner.get_range,
                                 key, start, length)

    def get_ranges(self, key: str, ranges: Sequence[Tuple[int, int]],
                   gap_threshold: int = DEFAULT_COALESCE_GAP):
        return self._hedged_read("get_ranges", self.inner.get_ranges,
                                 key, ranges, gap_threshold)

    def head(self, key: str) -> int:
        return self._call("head", self.inner.head, key)

    def list(self, prefix: str) -> List[str]:
        return self._call("list", self.inner.list, prefix)

    def delete(self, key: str) -> None:
        return self._call("delete", self.inner.delete, key)

    def total_bytes(self) -> int:
        return self.inner.total_bytes()

    def close(self) -> None:
        with self._hedge_lock:
            if self._hedge_pool is not None:
                self._hedge_pool.shutdown(wait=False)
                self._hedge_pool = None
