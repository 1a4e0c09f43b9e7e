"""Deterministic fault injection behind the ``ObjectStore`` interface.

``FaultyObjectStore`` wraps any backend (memory, filesystem) and injects
seeded, reproducible faults at the storage-primitive layer, so every client —
producers, consumers, the IOPool prefetch path, the reclaimer, the ops CLI —
exercises them transparently through the normal ``ObjectStore`` API:

  * **conditional-put 5xx/timeouts** — the commit protocol's conditional put
    raises ``TransientStoreError``; a configurable fraction are *lost acks*
    (the put landed server-side before the error), which is the ambiguous
    outcome the commit protocol must resolve by re-reading (paper §5.1).
  * **lost-then-retried writes** — plain PUTs fail transiently; retrying the
    same immutable key/payload is safe and producers do so.
  * **slow / partial range-GETs** — reads stall for ``slow_get_s`` or return
    a truncated payload (caught by TGB CRC/length checks and retried).
  * **stale-read windows** — GET/HEAD do not observe the most recently
    created keys and LIST omits them, modeling read-after-write staleness.
    Conditional PUT stays strongly consistent (the paper's one hard
    requirement of the store, §6).

All randomness comes from one seeded ``random.Random`` consulted under a
lock in a fixed per-operation order, so a given (seed, operation sequence)
replays identical faults. ``max_faults`` bounds total injections so chaos
scenarios always converge.

**Phase-scripted brownouts** layer time-windowed failure regimes on top of
the per-op rates: a ``BrownoutPhase`` describes one window — SlowDown
throttling (``ThrottledError`` with Retry-After), inflated latency, or a
full outage — relative to ``script_brownout()``'s arm time. This is how
chaos scenarios and ``fig16_brownout`` script "healthy → throttle storm →
recovery" timelines against the store's own clock.
"""
from __future__ import annotations

import random
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.core.errors import ThrottledError, TransientStoreError
from repro_torch.core.objectstore import NoSuchKey, ObjectStore


@dataclass
class BrownoutPhase:
    """One scripted failure window, relative to ``script_brownout()`` arm time.

    During ``[start_s, end_s)`` on the store's clock:

      * ``outage=True`` — every operation raises ``TransientStoreError``
        (the store is gone; nothing is applied server-side);
      * ``target_rate`` (ops/s) — **load-dependent** throttling: a token
        bucket admits ``target_rate`` operations per second (with a
        ``burst_s``-second burst allowance) and every operation beyond it
        raises ``ThrottledError``. The served Retry-After *escalates* with
        the recent rejection rate (up to ``escalation_cap`` times the base),
        the way real stores penalize clients that keep hammering through
        SlowDown: a client pacing itself below the target barely sees a
        throttle, one that ignores them is told to go away for longer and
        longer;
      * otherwise ``throttle_rate`` of operations raise ``ThrottledError``
        carrying ``retry_after_s`` (503 SlowDown, rejected before being
        applied) and the rest succeed with ``extra_latency_s`` added
        (brownout tail inflation).

    Phases are evaluated in order; the first one covering *now* wins.
    """

    start_s: float
    end_s: float
    throttle_rate: float = 0.0
    retry_after_s: float = 0.05
    extra_latency_s: float = 0.0
    outage: bool = False
    target_rate: Optional[float] = None
    #: token-bucket burst allowance for ``target_rate`` phases, in seconds
    #: of target-rate traffic (small: a storm starts biting immediately)
    burst_s: float = 0.1
    #: max Retry-After escalation multiplier under sustained over-offering
    #: (1.0 disables escalation)
    escalation_cap: float = 8.0

    def label(self) -> str:
        if self.outage:
            return "outage"
        if self.target_rate is not None or self.throttle_rate > 0:
            return "throttle"
        return "slow"


@dataclass
class FaultPolicy:
    """Knobs for ``FaultyObjectStore``. All rates are probabilities in [0, 1]
    evaluated independently per operation (seeded, deterministic)."""

    seed: int = 0
    #: conditional put raises TransientStoreError...
    cput_error_rate: float = 0.0
    #: ...and this fraction of those errors are lost acks: the put was applied
    #: server-side before the "failure" (the ambiguous outcome).
    cput_lost_ack_rate: float = 0.5
    #: plain PUT raises TransientStoreError (never applied: the client retries
    #: the same immutable key, which is safe).
    put_error_rate: float = 0.0
    #: GET / ranged GET raises TransientStoreError.
    get_error_rate: float = 0.0
    #: ranged GET returns a truncated payload instead of failing.
    short_read_rate: float = 0.0
    #: GET / ranged GET stalls an extra ``slow_get_s`` first.
    slow_get_rate: float = 0.0
    slow_get_s: float = 0.05
    #: GET/HEAD of one of the ``stale_depth`` most recently created keys
    #: raises NoSuchKey, and LIST omits them (read-after-write staleness).
    stale_read_rate: float = 0.0
    stale_depth: int = 2
    #: only keys containing this substring are fault-eligible ("" = all).
    key_filter: str = ""
    #: stop injecting after this many total faults (None = unbounded).
    max_faults: Optional[int] = None
    #: scripted brownout windows (armed by ``script_brownout``; inert until
    #: then). These are deliberate, time-bounded regimes — they neither
    #: consume ``max_faults`` nor respect ``key_filter``.
    phases: List[BrownoutPhase] = field(default_factory=list)


@dataclass
class FaultStats:
    """Count of injected faults by kind (for assertions and reports)."""

    counts: Dict[str, int] = field(default_factory=dict)

    def bump(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1

    @property
    def total(self) -> int:
        return sum(self.counts.values())


class FaultyObjectStore(ObjectStore):
    """Wrap ``inner`` and inject ``FaultPolicy`` faults at the primitive layer.

    The wrapper owns latency/stats accounting (inherited from ``ObjectStore``)
    and delegates straight to the inner backend's ``_do_*`` primitives, so
    each logical operation is charged exactly once and the inner store's own
    public API stays untouched for out-of-band inspection.
    """

    def __init__(self, inner: ObjectStore, policy: Optional[FaultPolicy] = None,
                 **kw):
        kw.setdefault("latency", inner.latency)
        kw.setdefault("clock", inner.clock)
        kw.setdefault("faults", inner.faults)
        super().__init__(**kw)
        self.inner = inner
        self.policy = policy or FaultPolicy()
        self.fault_stats = FaultStats()
        self._rng = random.Random(self.policy.seed)
        self._rng_lock = threading.Lock()
        # creation order of keys, for the stale-read window
        self._recent: List[str] = []
        self._recent_lock = threading.Lock()
        # brownout script: armed at script_brownout() time
        self._brownout_t0: Optional[float] = None
        self._phases: List[BrownoutPhase] = list(self.policy.phases)
        # token bucket for load-dependent (target_rate) throttle phases
        self._bucket_phase: Optional[BrownoutPhase] = None
        self._bucket_level = 0.0
        self._bucket_t = 0.0
        self._rejects: Deque[float] = deque()  # trailing-1s rejections

    # -- brownout scripting ---------------------------------------------------
    def script_brownout(self, phases: Optional[Sequence[BrownoutPhase]] = None,
                        ) -> float:
        """Arm the brownout script at ``clock.now()``; phases' ``start_s`` /
        ``end_s`` are relative to this instant. Returns the arm time."""
        if phases is not None:
            self._phases = list(phases)
        self._brownout_t0 = self.clock.now()
        return self._brownout_t0

    def clear_brownout(self) -> None:
        """Disarm the script (ends any in-progress phase immediately)."""
        self._brownout_t0 = None

    def active_phase(self) -> Optional[BrownoutPhase]:
        if self._brownout_t0 is None:
            return None
        t = self.clock.now() - self._brownout_t0
        for ph in self._phases:
            if ph.start_s <= t < ph.end_s:
                return ph
        return None

    def _maybe_brownout(self, op: str, key: str) -> None:
        """Apply the active phase to one operation (raises or sleeps)."""
        ph = self.active_phase()
        if ph is None:
            return
        if ph.outage:
            self.fault_stats.bump("outage")
            raise TransientStoreError(f"injected outage: {op} {key}")
        if ph.target_rate is not None:
            retry_after = self._bucket_throttled(ph)
            if retry_after is not None:
                self.fault_stats.bump("throttled")
                raise ThrottledError(f"injected SlowDown: {op} {key}",
                                     retry_after_s=retry_after)
        elif ph.throttle_rate > 0 and self._flip(ph.throttle_rate):
            self.fault_stats.bump("throttled")
            raise ThrottledError(f"injected SlowDown: {op} {key}",
                                 retry_after_s=ph.retry_after_s)
        if ph.extra_latency_s > 0:
            self.fault_stats.bump("brownout_slow")
            self.clock.sleep(ph.extra_latency_s)

    def _bucket_throttled(self, ph: BrownoutPhase) -> Optional[float]:
        """Token-bucket admission for a ``target_rate`` phase.

        Returns None when the operation is admitted, else the Retry-After
        to serve — the base value escalated by the recent rejection rate
        (rejections in the trailing second beyond ~10% of the target grow
        the penalty, capped at ``escalation_cap``x)."""
        with self._rng_lock:
            now = self.clock.now()
            burst = max(1.0, ph.target_rate * ph.burst_s)
            if self._bucket_phase is not ph:
                self._bucket_phase = ph
                self._bucket_level = burst
                self._bucket_t = now
                self._rejects.clear()
            dt = max(0.0, now - self._bucket_t)
            self._bucket_t = now
            self._bucket_level = min(burst,
                                     self._bucket_level + dt * ph.target_rate)
            if self._bucket_level >= 1.0:
                self._bucket_level -= 1.0
                return None
            self._rejects.append(now)
            while self._rejects and self._rejects[0] < now - 1.0:
                self._rejects.popleft()
            factor = min(ph.escalation_cap,
                         1.0 + len(self._rejects) / (0.1 * ph.target_rate))
            return ph.retry_after_s * factor

    # -- fault machinery ------------------------------------------------------
    def _roll(self, rate: float, kind: str, key: str) -> bool:
        """One seeded coin flip; counts and honors the global fault budget."""
        if rate <= 0.0:
            return False
        p = self.policy
        if p.key_filter and p.key_filter not in key:
            return False
        with self._rng_lock:
            if p.max_faults is not None and \
                    self.fault_stats.total >= p.max_faults:
                return False
            if self._rng.random() >= rate:
                return False
            self.fault_stats.bump(kind)
            return True

    def _flip(self, rate: float) -> bool:
        with self._rng_lock:
            return self._rng.random() < rate

    def _note_created(self, key: str) -> None:
        if self.policy.stale_read_rate <= 0:
            return
        with self._recent_lock:
            if key in self._recent:
                self._recent.remove(key)
            self._recent.append(key)
            del self._recent[:-max(1, self.policy.stale_depth)]

    def _stale_window(self) -> List[str]:
        with self._recent_lock:
            return list(self._recent)

    def _maybe_stale(self, key: str, op: str) -> None:
        if key in self._stale_window() and \
                self._roll(self.policy.stale_read_rate, f"stale_{op}", key):
            raise NoSuchKey(key)

    def _maybe_slow_or_fail_get(self, key: str, op: str) -> None:
        if self._roll(self.policy.slow_get_rate, "slow_get", key):
            self.clock.sleep(self.policy.slow_get_s)
        if self._roll(self.policy.get_error_rate, "get_error", key):
            raise TransientStoreError(f"injected 5xx on {op} {key}")

    # -- primitives -----------------------------------------------------------
    def _do_put(self, key, data):
        self._maybe_brownout("put", key)
        if self._roll(self.policy.put_error_rate, "put_error", key):
            raise TransientStoreError(f"injected 5xx on put {key}")
        self.inner._do_put(key, data)
        self._note_created(key)

    def _do_put_if_absent(self, key, data):
        self._maybe_brownout("cput", key)
        if self._roll(self.policy.cput_error_rate, "cput_error", key):
            if self._flip(self.policy.cput_lost_ack_rate):
                # lost ack: the put reached the store, then the response was
                # "lost" — the genuinely ambiguous outcome
                applied = self.inner._do_put_if_absent(key, data)
                if applied:
                    self._note_created(key)
                self.fault_stats.bump("cput_lost_ack")
            raise TransientStoreError(f"injected timeout on cput {key}")
        ok = self.inner._do_put_if_absent(key, data)
        if ok:
            self._note_created(key)
        return ok

    def _do_get(self, key):
        self._maybe_brownout("get", key)
        self._maybe_stale(key, "get")
        self._maybe_slow_or_fail_get(key, "get")
        return self.inner._do_get(key)

    def _do_get_range(self, key, start, length):
        self._maybe_brownout("get_range", key)
        self._maybe_stale(key, "get")
        self._maybe_slow_or_fail_get(key, "get_range")
        data = self.inner._do_get_range(key, start, length)
        if len(data) > 1 and self._roll(self.policy.short_read_rate,
                                        "short_read", key):
            return data[:len(data) // 2]
        return data

    def _do_head(self, key):
        self._maybe_brownout("head", key)
        self._maybe_stale(key, "head")
        return self.inner._do_head(key)

    def _do_list(self, prefix):
        self._maybe_brownout("list", prefix)
        keys = self.inner._do_list(prefix)
        if self.policy.stale_read_rate > 0:
            window = set(self._stale_window())
            out = []
            for k in keys:
                if k in window and self._roll(self.policy.stale_read_rate,
                                              "stale_list", k):
                    continue
                out.append(k)
            return out
        return keys

    def _do_delete(self, key):
        self._maybe_brownout("delete", key)
        self.inner._do_delete(key)

    def total_bytes(self):
        return self.inner.total_bytes()
