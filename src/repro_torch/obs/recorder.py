"""Flight recorder: periodic registry snapshots published to the object store
(port of ``repro.obs.recorder``, copied as it is but for its imports; the
snapshots are byte-compatible, so either package reads the other's).

Extends the paper's "recovery and retention live in the storage layer"
principle to telemetry: each component (producer, consumer, derive worker,
reclaimer, ...) periodically serializes its slice of the metrics registry to

    <run>/obs/<component>/<seq>.snap

via the same put-if-absent monotone-seq chain the derive cursor and
RunManifest use, so the operator CLI (``batchweave obs`` / ``top``) can
render throughput, lag, and conflict rates for every participant **from
storage alone** — including after the process died. Every chaos post-mortem
becomes a read of the victim's last snapshot.

Robustness contract (tested under ``FaultyObjectStore``):

  * snapshot writes NEVER propagate into the data path — any storage error
    is swallowed and counted (``dropped``); the next interval simply retries
    with a fresh snapshot at the next free sequence number;
  * a torn/unreadable snapshot object is skipped by readers, never breaking
    the chain (each .snap is self-contained — there are no deltas);
  * sequence numbers are claimed with conditional put, so two incarnations
    of the same component interleave without overwriting each other. Each
    payload carries an ``inc`` incarnation token + per-process monotonic
    ``t``; rate math only differences snapshots of one incarnation.

Payload schema (JSON; catalog in docs/OBSERVABILITY.md)::

    {"schema": 1, "component": "producer.p0", "seq": 7, "inc": "a1b2c3d4",
     "t": 12.345,          # per-process monotonic seconds
     "wall": 1754700000.0, # wall clock, for age-of-last-snapshot
     "metrics": {"producer.p0.commit_conflicts": 3,
                 "producer.p0.commit_latencies": {"count": ..., "p50": ...}}}
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.objectstore import Namespace, NoSuchKey
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["FlightRecorder", "OBS_DIR", "SNAP_SCHEMA", "component_dirs",
           "list_snaps", "latest_snapshot", "read_snapshots", "prune_snaps"]

#: wire-format schema tag; bump on incompatible changes
SNAP_SCHEMA = 1
#: directory component under the run namespace
OBS_DIR = "obs"
#: snapshots kept per component by reclamation (newest first)
DEFAULT_KEEP = 8


def _snap_key(ns: Namespace, component: str, seq: int) -> str:
    return ns.key(OBS_DIR, component, f"{seq:08d}.snap")


class FlightRecorder:
    """Publishes one component's registry slice as a snapshot chain.

    ``component`` doubles as the key directory and the registry prefix
    filter (``producer.p0`` publishes every metric under ``producer.p0.``).
    Call ``maybe_snap()`` from the component's natural heartbeat (commit
    attempt, batch poll, derive window); it no-ops until ``interval_s`` has
    elapsed, so the hot path pays one clock read.
    """

    def __init__(self, ns: Namespace, component: str, *,
                 interval_s: float = 5.0,
                 registry: Optional[MetricsRegistry] = None):
        if not component or "/" in component:
            raise ValueError(f"bad component name {component!r}")
        self.ns = ns
        self.component = component
        self.interval_s = interval_s
        self.registry = registry if registry is not None else default_registry()
        self.incarnation = os.urandom(4).hex()
        self.published = 0   # snapshots that landed
        self.dropped = 0     # snapshot attempts swallowed on storage errors
        self._next_seq: Optional[int] = None
        self._last_t: Optional[float] = None
        self._lock = threading.Lock()

    # -- publishing --------------------------------------------------------
    def maybe_snap(self) -> bool:
        """Publish iff the interval elapsed. Never raises."""
        now = time.monotonic()
        with self._lock:
            if self._last_t is not None and \
                    now - self._last_t < self.interval_s:
                return False
            self._last_t = now
        return self.snap()

    def snap(self) -> bool:
        """Publish one snapshot now. Never raises; False = dropped (storage
        error) — the chain stays intact and the next snap retries fresh."""
        try:
            doc = {
                "schema": SNAP_SCHEMA,
                "component": self.component,
                "seq": 0,  # patched per claim attempt below
                "inc": self.incarnation,
                "t": time.monotonic(),
                "wall": time.time(),
                "metrics": self.registry.snapshot(self.component + "."),
            }
            for _ in range(4):  # bounded: telemetry must not spin
                seq = self._claim_seq()
                doc["seq"] = seq
                raw = json.dumps(doc, sort_keys=True).encode()
                if self.ns.store.put_if_absent(
                        _snap_key(self.ns, self.component, seq), raw):
                    with self._lock:
                        self._next_seq = seq + 1
                        self.published += 1
                    return True
                with self._lock:  # lost the seq race; re-list and retry
                    self._next_seq = None
        except Exception:
            pass  # telemetry never takes down the data path
        with self._lock:
            self.dropped += 1
        return False

    def _claim_seq(self) -> int:
        with self._lock:
            if self._next_seq is not None:
                return self._next_seq
        seqs = list_snaps(self.ns, self.component)
        seq = (seqs[-1] + 1) if seqs else 0
        with self._lock:
            self._next_seq = seq
        return seq

    def close(self) -> bool:
        """Final forced snapshot (component shutdown)."""
        return self.snap()


# -- storage-side read surface (no client state needed) ---------------------

def component_dirs(ns: Namespace) -> List[str]:
    """Component names that have published at least one snapshot."""
    prefix = ns.key(OBS_DIR) + "/"
    seen = set()
    for key in ns.store.list(ns.key(OBS_DIR)):
        rest = key[len(prefix):]
        if "/" in rest:
            seen.add(rest.rsplit("/", 1)[0])
    return sorted(seen)


def list_snaps(ns: Namespace, component: str) -> List[int]:
    """Sorted snapshot sequence numbers of one component."""
    out = []
    for key in ns.store.list(ns.key(OBS_DIR, component)):
        fn = key.rsplit("/", 1)[-1]
        if not fn.endswith(".snap"):
            continue
        try:
            out.append(int(fn.split(".")[0]))
        except ValueError:
            pass
    return sorted(out)


def read_snapshots(ns: Namespace, component: str,
                   last: Optional[int] = None) -> List[Dict]:
    """Decode (up to the ``last``) snapshots of one component, oldest first.

    Torn/undecodable/missing snapshots are skipped — every .snap is
    self-contained, so a corrupt entry costs one sample, not the chain.
    """
    seqs = list_snaps(ns, component)
    if last is not None:
        seqs = seqs[-last:]
    out = []
    for seq in seqs:
        try:
            doc = json.loads(ns.store.get(_snap_key(ns, component, seq)))
        except (NoSuchKey, KeyError, ValueError):
            continue
        except Exception:
            continue
        if not isinstance(doc, dict) or doc.get("schema") != SNAP_SCHEMA:
            continue
        out.append(doc)
    return out


def latest_snapshot(ns: Namespace, component: str) -> Optional[Dict]:
    snaps = read_snapshots(ns, component, last=3)
    return snaps[-1] if snaps else None


def prune_snaps(ns: Namespace, keep: int = DEFAULT_KEEP) -> int:
    """Delete all but the newest ``keep`` snapshots of every component.

    Called by the Reclaimer's cycle: telemetry retention rides the same
    lifecycle as data retention. Returns the number of objects deleted.
    """
    deleted = 0
    for component in component_dirs(ns):
        seqs = list_snaps(ns, component)
        for seq in seqs[:-keep] if keep > 0 else seqs:
            try:
                ns.store.delete(_snap_key(ns, component, seq))
                deleted += 1
            except Exception:
                pass  # retention is best-effort; next cycle retries
    return deleted
