"""Shared data-plane error types and the retry/backoff primitives.

``BatchTimeout`` is the single timeout contract all batch readers honor,
regardless of transport: the object-store ``Consumer``, the Kafka-sim
``KafkaTGBConsumer``, and the colocated pipeline all raise it when the next
global batch is not available within ``timeout_s``. It subclasses
``TimeoutError`` so callers written against the original per-client exceptions
keep working.

The storage error taxonomy (docs/ARCHITECTURE.md "Resilience layer") splits
the old one-flavor ``TransientStoreError`` into the regimes real S3/GCS
deployments present:

  ``TransientStoreError``   ambiguous 5xx/timeout; retry with backoff
  ``ThrottledError``        503 SlowDown; honor ``retry_after_s`` exactly and
                            collectively reduce offered load (AIMD governor)
  ``CircuitOpenError``      client-side fast-fail: the circuit breaker judged
                            the store down; do NOT burn retries — flip into
                            degraded mode instead
  ``RetryBudgetExhausted``  the op-class retry token bucket ran dry; also a
                            fail-fast signal (retry storms during brownouts
                            amplify the outage)

The latter two subclass ``TransientStoreError`` so existing broad handlers
still classify them as storage trouble, but ``retry_transient`` re-raises
them immediately instead of sleeping on them.
"""
from __future__ import annotations

import random
import threading


class BatchTimeout(TimeoutError):
    """The next batch was not available within the caller's deadline."""


class TransientStoreError(IOError):
    """A retryable object-store failure (5xx, timeout, dropped connection).

    Raised by fault-injecting stores (``repro.core.faults``) and expected from
    real backends. Clients treat it as *ambiguous*: the request may or may not
    have been applied server-side. Idempotent operations (immutable PUT of the
    same payload, ranged GET) are simply retried; the conditional manifest put
    is resolved by re-reading the version it targeted (see
    ``CommitProtocol._resolve_ambiguous_put``).
    """


class ThrottledError(TransientStoreError):
    """503 SlowDown: the store is shedding load and (optionally) told us when
    to come back. ``retry_after_s`` is honored *exactly* by the retry loop —
    no jitter, no exponential growth — and fed to the process-wide AIMD rate
    governor so every client backs off together, not just the one that got
    throttled."""

    def __init__(self, msg: str = "503 SlowDown",
                 retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class CircuitOpenError(TransientStoreError):
    """Fail-fast: the circuit breaker is open (the store is judged down).

    Subclasses ``TransientStoreError`` so storage-fault handlers classify it
    correctly, but retry loops re-raise it immediately — retrying against an
    open breaker only delays the caller's switch into degraded mode.
    """


class RetryBudgetExhausted(TransientStoreError):
    """The op-class retry token bucket ran dry. Fail fast for the same reason
    as ``CircuitOpenError``: unbounded retry storms during a brownout are how
    clients turn elevated latency into a full outage."""


#: fail-fast subset: ``retry_transient`` never sleeps on these
FAIL_FAST_ERRORS = (CircuitOpenError, RetryBudgetExhausted)

#: default ceiling for one backoff sleep
DEFAULT_BACKOFF_CAP_S = 1.0

# Module-level RNG for backoff jitter. Deterministic tests inject their own
# seeded Random via ``rng=``; decorrelation across threads matters more than
# reproducibility here (that is the entire point of jitter).
_jitter_rng = random.Random()
_jitter_lock = threading.Lock()


def backoff_delays(base_delay_s: float, cap_s: float = DEFAULT_BACKOFF_CAP_S,
                   rng: random.Random | None = None):
    """Generator of exponential-backoff sleeps with *decorrelated jitter*.

    The AWS-style recurrence: ``d_0 = base``, ``d_i = min(cap,
    uniform(base, 3 * d_{i-1}))``. Every delay is bounded below by ``base``
    and above by ``cap``, grows at most 3x per step, and never synchronizes
    two clients (each draw is uniform over the whole window, so retry storms
    de-phase instead of thundering together).
    """
    prev = base_delay_s
    yield prev
    while True:
        lo, hi = base_delay_s, max(base_delay_s, 3.0 * prev)
        if rng is not None:
            d = rng.uniform(lo, hi)
        else:
            with _jitter_lock:
                d = _jitter_rng.uniform(lo, hi)
        prev = min(cap_s, d)
        yield prev


def retry_transient(fn, clock, attempts: int = 4, base_delay_s: float = 0.01,
                    retry_on=(TransientStoreError,), on_retry=None,
                    cap_s: float = DEFAULT_BACKOFF_CAP_S, budget=None,
                    rng: random.Random | None = None):
    """Run an idempotent storage closure with bounded backoff retries.

    The single retry policy for every client that rides out transient store
    faults (commit-protocol reads, producer TGB uploads, consumer slice
    fetches). Semantics:

      * exponential backoff with decorrelated jitter (``backoff_delays``),
        capped at ``cap_s`` — replaces the original flat linear sleep;
      * a ``ThrottledError`` carrying ``retry_after_s`` sleeps exactly that
        long instead of the backoff draw (the store told us when to return);
      * fail-fast errors (``CircuitOpenError``, ``RetryBudgetExhausted``)
        re-raise immediately — no sleep, no extra attempts;
      * an optional ``budget`` (``repro_torch.core.resilience.RetryBudget``) is
        charged one token per re-attempt; when it runs dry the retry stops
        early with ``RetryBudgetExhausted`` chained to the last failure.

    ``retry_on`` widens the retryable set per call site (e.g. stale-read
    ``NoSuchKey``, CRC/short-read format errors); ``on_retry`` is invoked
    with the attempt number before each re-attempt (retry accounting). The
    final failure re-raises the last exception unchanged.
    """
    last = None
    delays = backoff_delays(base_delay_s, cap_s=cap_s, rng=rng)
    for attempt in range(attempts):
        if attempt:
            if budget is not None and not budget.try_spend():
                raise RetryBudgetExhausted(
                    f"retry budget exhausted after {attempt} attempts "
                    f"(last: {last!r})") from last
            if on_retry is not None:
                on_retry(attempt)
            retry_after = getattr(last, "retry_after_s", None)
            clock.sleep(next(delays) if retry_after is None else retry_after)
        try:
            return fn()
        except FAIL_FAST_ERRORS:
            raise
        except retry_on as e:
            last = e
    raise last
