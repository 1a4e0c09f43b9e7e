"""Chaos harness scaffolding: scenario registry, result type, shared helpers.

A *scenario* is a self-contained failure-isolation experiment: build a fresh
in-memory run, kill a component at a named protocol point (via
``FaultInjector`` crash rules or a ``FaultyObjectStore`` fault policy),
restart/replace it, then assert the paper's §5 guarantees survived:

  * **exactly-once delivery** — every global batch is delivered exactly once
    with byte-identical payloads (sources are deterministic by
    ``(producer_id, offset, d, c)``, so replays are comparable);
  * **atomic all-rank visibility** — every rank converges on the same
    published frontier, and no rank ever observes a torn batch;
  * **no orphaned objects after recovery** — ``repro_torch.ops.fsck``
    accounts for every byte: crash leftovers are detected as safe orphans,
    repaired, and the namespace then audits clean.

Scenarios register with :func:`scenario` and run via :func:`run_scenario` /
:func:`run_all` (or ``python -m repro_torch.chaos``).

Port of ``repro.chaos.harness``, copied as it is but for its imports.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import (Consumer, FaultInjector, ManifestStore,
                              MemoryObjectStore, MeshPosition, Namespace,
                              Producer, open_manifest_store)
from repro_torch.ops import fsck

__all__ = ["SCENARIOS", "ScenarioResult", "scenario", "run_scenario",
           "run_all", "deterministic_payload", "make_slices", "produce_range",
           "drain", "assert_exactly_once", "assert_all_ranks_converge",
           "audit_and_repair", "fresh_ns"]

CHAOS_PREFIX = "runs/chaos"


@dataclass
class ScenarioResult:
    """Outcome of one chaos scenario (all assertions already enforced)."""

    name: str
    passed: bool
    steps_delivered: int = 0
    recovery_latency_s: float = 0.0
    orphans_detected: int = 0
    faults_injected: int = 0
    fsck_clean_after: bool = False
    detail: str = ""

    def row(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        return (f"{status}  {self.name:<34} steps={self.steps_delivered:<4} "
                f"recovery={self.recovery_latency_s * 1e3:7.1f}ms "
                f"orphans={self.orphans_detected} "
                f"faults={self.faults_injected} "
                f"fsck={'clean' if self.fsck_clean_after else 'DIRTY'}"
                + (f"  [{self.detail}]" if self.detail else ""))


SCENARIOS: Dict[str, Callable[[int], ScenarioResult]] = {}


def scenario(name: str):
    """Register a chaos scenario under ``name`` (callable: seed -> result)."""
    def deco(fn: Callable[[int], ScenarioResult]):
        SCENARIOS[name] = fn
        return fn
    return deco


def run_scenario(name: str, seed: int = 0) -> ScenarioResult:
    """Run one scenario; assertion/infrastructure failures become a failed
    result carrying the traceback tail instead of propagating."""
    fn = SCENARIOS[name]
    try:
        return fn(seed)
    except Exception as e:
        tb = traceback.format_exc().strip().splitlines()[-1]
        return ScenarioResult(name=name, passed=False,
                              detail=f"{type(e).__name__}: {e} ({tb})")


def run_all(only: Optional[List[str]] = None,
            seed: int = 0) -> List[ScenarioResult]:
    names = only if only else sorted(SCENARIOS)
    for n in names:
        if n not in SCENARIOS:
            raise KeyError(f"unknown scenario {n!r}; known: "
                           f"{', '.join(sorted(SCENARIOS))}")
    return [run_scenario(n, seed=seed) for n in names]


# ---------------------------------------------------------------------------
# Shared scenario building blocks
# ---------------------------------------------------------------------------

def fresh_ns(store=None) -> Namespace:
    """A fresh zero-latency in-memory run namespace (crash hooks armed)."""
    if store is None:
        store = MemoryObjectStore(faults=FaultInjector())
    return Namespace(store, CHAOS_PREFIX)


def deterministic_payload(pid: str, offset: int, d: int = 0, c: int = 0,
                          nbytes: int = 64) -> bytes:
    """Pure function of identity — a replayed producer regenerates the exact
    bytes, which is what makes exactly-once *payload* equality checkable."""
    stamp = f"{pid}:{offset}:{d}:{c}|".encode()
    return (stamp * (nbytes // len(stamp) + 1))[:nbytes]


def make_slices(pid: str, offset: int, dp: int, cp: int,
                nbytes: int = 64) -> Dict[Tuple[int, int], bytes]:
    return {(d, c): deterministic_payload(pid, offset, d, c, nbytes)
            for d in range(dp) for c in range(cp)}


def produce_range(producer: Producer, upto_offset: int,
                  nbytes: int = 64) -> None:
    """Drive ``producer`` until ``next_offset == upto_offset``, committing
    eagerly (every write force-commits, the worst case for the protocol)."""
    while producer.next_offset < upto_offset:
        producer.write_tgb(slice_payloads=make_slices(
            producer.producer_id, producer.next_offset, producer.dp,
            producer.cp, nbytes))
        producer.maybe_commit(force=True)
    producer.finalize()


def drain(cons: Consumer, n: int, timeout_s: float = 10.0) -> List[bytes]:
    return [cons.next_batch(timeout_s=timeout_s) for _ in range(n)]


def assert_exactly_once(got: List[bytes], pid: str, d: int, c: int,
                        n: int, nbytes: int = 64) -> None:
    """The delivered sequence must be exactly payload(0..n-1): no gap, no
    duplicate, no corruption."""
    want = [deterministic_payload(pid, off, d, c, nbytes) for off in range(n)]
    if got != want:
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                raise AssertionError(
                    f"exactly-once violated at step {i}: got "
                    f"{bytes(g[:24])!r}... want {bytes(w[:24])!r}...")
        raise AssertionError(
            f"exactly-once violated: {len(got)} batches delivered, "
            f"{len(want)} expected")


def assert_all_ranks_converge(consumers: List[Consumer]) -> None:
    """Atomic all-rank visibility: after a poll, every rank's view agrees on
    the published frontier and the manifest version that defines it."""
    for cons in consumers:
        cons.poll()
    frontiers = {c.view.total_steps for c in consumers}
    versions = {c.view.version for c in consumers}
    if len(frontiers) != 1 or len(versions) != 1:
        raise AssertionError(
            f"ranks diverged: frontiers={sorted(frontiers)} "
            f"versions={sorted(versions)} — manifest visibility is not "
            f"atomic across ranks")


def audit_and_repair(ns: Namespace) -> Tuple[int, bool]:
    """Run fsck, repair safe orphans, re-audit. Returns
    ``(orphans_detected, clean_after_repair)``."""
    before = fsck(ns)
    orphans = len(before.orphans) + sum(len(r.orphans)
                                        for r in before.streams.values())
    if orphans:
        fsck(ns, repair=True)
    after = fsck(ns)
    return orphans, after.clean


def now() -> float:
    return time.monotonic()


def latest_view(ns: Namespace):
    m = open_manifest_store(ns)
    return m.load_view(m.latest_version())


def reader(ns: Namespace, d: int, c: int, dp: int, cp: int,
           **kw) -> Consumer:
    return Consumer(ns, MeshPosition(d, c, dp, cp), **kw)
