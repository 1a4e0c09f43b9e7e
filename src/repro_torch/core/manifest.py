"""Versioned manifest: BatchWeave's logical control structure (paper §4.2).

A manifest version ``M_v`` is an immutable object named by its version number
(``00000011.manifest``) containing:

  * the **TGB list** — the authoritative, globally ordered step sequence
    (entry ``s - base_step`` identifies global batch ``B_s``),
  * the **per-producer state map** — stream offset up to which each producer has
    committed (exactly-once producer recovery, and DAC's dynamic N),
  * ``base_step`` — number of logically trimmed leading TGBs (checkpoint-aligned
    lifecycle; step indices are global and never reused).

Publication is serialized by a conditional put on the next version name: this
single atomic write advances the version and makes new TGBs visible (§4.3).

Two codecs:

  * ``flat``  — paper-faithful: each manifest carries the full TGB list, so
    manifest I/O cost grows with history. This is what DAC adapts to.
  * ``delta`` — beyond-paper: each manifest carries only the TGBs added by this
    commit plus a pointer chain (with periodic full snapshots), making commit
    I/O O(delta) instead of O(history). See EXPERIMENTS.md §Perf.
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core import _msgpack as msgpack

from repro_torch.core.errors import TransientStoreError
from repro_torch.core.objectstore import Namespace, NoSuchKey, ObjectStore
from repro_torch.core.tgb import TGBDescriptor

MANIFEST_FORMAT_FLAT = "flat"
MANIFEST_FORMAT_DELTA = "delta"

#: key of the per-run shard-layout config (written once, conditionally, at
#: run creation; absence == the legacy single-chain layout)
SHARDS_CFG_SCHEMA = 1


class StepUnavailable(KeyError):
    """``tgb_at_step`` miss: the step is trimmed or not yet published.

    A *protocol* condition, not a programming error — subclassing ``KeyError``
    keeps legacy handlers working, while giving retry/poll loops a type to
    catch that can never swallow a genuine ``KeyError`` bug (the reason the
    consumer's broad except blocks were narrowed to this)."""


@dataclass(frozen=True)
class ProducerState:
    """Durable per-producer resumption state (paper §5.3): the stream offset up
    to which this producer's TGBs are visible in the committed manifest."""

    committed_offset: int  # highest producer_seq committed (-1 if none)
    last_commit_version: int
    epoch: int = 0  # producer incarnation (bumped on takeover/restart)

    def pack(self) -> list:
        return [self.committed_offset, self.last_commit_version, self.epoch]

    @staticmethod
    def unpack(row) -> "ProducerState":
        return ProducerState(*row)


@dataclass
class DatasetView:
    """A consumer/producer's reconstructed view of the dataset at some version.

    ``tgbs[i]`` corresponds to global step ``base_step + i``. ``total_steps`` is
    ``base_step + len(tgbs)``; the authoritative step sequence is append-only.

    ``commit_runs`` (sharded chains only) is a run-length encoding of the
    commit version each retained entry arrived in — ``[[version, count], ...]``
    parallel to ``tgbs`` — which is what makes the deterministic cross-shard
    merge order reconstructible from any single shard view. Empty on legacy
    single-chain manifests.
    """

    version: int = -1
    base_step: int = 0
    tgbs: List[TGBDescriptor] = field(default_factory=list)
    producers: Dict[str, ProducerState] = field(default_factory=dict)
    commit_runs: List[List[int]] = field(default_factory=list)

    @property
    def total_steps(self) -> int:
        return self.base_step + len(self.tgbs)

    def tgb_at_step(self, step: int) -> TGBDescriptor:
        idx = step - self.base_step
        if idx < 0:
            raise StepUnavailable(
                f"step {step} was trimmed (base_step={self.base_step})")
        if idx >= len(self.tgbs):
            raise StepUnavailable(
                f"step {step} not yet published (total={self.total_steps})")
        return self.tgbs[idx]

    def producer_offset(self, producer_id: str) -> int:
        st = self.producers.get(producer_id)
        return st.committed_offset if st is not None else -1

    def derived_tgbs(self) -> List[Tuple[int, TGBDescriptor]]:
        """(global step, descriptor) for every retained TGB carrying a
        provenance record — the manifest-level lineage index of a derived
        stream (empty on raw streams)."""
        return [(self.base_step + i, t) for i, t in enumerate(self.tgbs)
                if t.provenance is not None]

    def copy(self) -> "DatasetView":
        return DatasetView(self.version, self.base_step, list(self.tgbs),
                           dict(self.producers),
                           [list(r) for r in self.commit_runs])


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def _pack_producers(producers: Dict[str, ProducerState]) -> dict:
    return {pid: st.pack() for pid, st in producers.items()}


def _unpack_producers(raw: dict) -> Dict[str, ProducerState]:
    return {pid: ProducerState.unpack(row) for pid, row in raw.items()}


def _decode_flat_tgbs(rows, doc_base_step: int,
                      base: Optional[DatasetView]) -> List[TGBDescriptor]:
    """Incremental flat decode: reuse the base view's already-constructed
    ``TGBDescriptor`` objects for every row whose global step and ``tgb_id``
    align with the base (the TGB list is append-only and trim is monotone,
    so the overlap is a contiguous prefix). Advancing a view then costs
    O(new entries) Python object construction instead of O(history) —
    the dominant per-poll cost on long runs."""
    if base is None or not base.tgbs:
        return [TGBDescriptor.unpack(r) for r in rows]
    # row i sits at global step doc_base_step + i; the same step lives at
    # base.tgbs[i + shift] in the base view (if still in range)
    shift = doc_base_step - base.base_step
    base_tgbs = base.tgbs
    n_base = len(base_tgbs)
    out: List[TGBDescriptor] = []
    for i, row in enumerate(rows):
        j = i + shift
        if 0 <= j < n_base and base_tgbs[j].tgb_id == row[0]:
            out.append(base_tgbs[j])
        else:
            out.append(TGBDescriptor.unpack(row))
    return out


def append_run(runs: List[List[int]], version: int, count: int) -> None:
    """Extend a run-length commit-version encoding in place (no-op for
    empty commits, which is what makes heartbeat manifests entry-free)."""
    if count <= 0:
        return
    if runs and runs[-1][0] == version:
        runs[-1][1] += count
    else:
        runs.append([version, count])


def trim_runs(runs: List[List[int]], drop: int) -> List[List[int]]:
    """Drop the first ``drop`` entries from a run-length encoding."""
    out: List[List[int]] = []
    for v, c in runs:
        if drop >= c:
            drop -= c
            continue
        out.append([v, c - drop])
        drop = 0
    return out


def encode_flat_manifest(view: DatasetView) -> bytes:
    """Flat manifest: the complete dataset state (paper-faithful).

    ``commit_runs`` is only emitted when present (sharded chains), keeping
    single-chain manifests byte-identical to pre-sharding builds."""
    doc = {
        "format": MANIFEST_FORMAT_FLAT,
        "version": view.version,
        "base_step": view.base_step,
        "tgbs": [t.pack() for t in view.tgbs],
        "producers": _pack_producers(view.producers),
    }
    if view.commit_runs:
        doc["commit_runs"] = [list(r) for r in view.commit_runs]
    return msgpack.packb(doc, use_bin_type=True)


def decode_manifest(raw: bytes) -> dict:
    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


def encode_delta_manifest(version: int, parent_version: int,
                          new_tgbs: List[TGBDescriptor],
                          producers: Dict[str, ProducerState],
                          base_step: int,
                          snapshot_view: Optional[DatasetView] = None) -> bytes:
    """Delta manifest: only this commit's TGBs + full (small) producer map.

    If ``snapshot_view`` is given, the full TGB list is embedded (periodic
    snapshot so that cold readers bound their chain walk).
    """
    doc = {
        "format": MANIFEST_FORMAT_DELTA,
        "version": version,
        "parent_version": parent_version,
        "base_step": base_step,
        "delta_tgbs": [t.pack() for t in new_tgbs],
        "producers": _pack_producers(producers),
    }
    if snapshot_view is not None:
        doc["snapshot_tgbs"] = [t.pack() for t in snapshot_view.tgbs]
        doc["snapshot_base_step"] = snapshot_view.base_step
        if snapshot_view.commit_runs:
            doc["snapshot_commit_runs"] = [list(r)
                                           for r in snapshot_view.commit_runs]
    return msgpack.packb(doc, use_bin_type=True)


class ManifestStore:
    """Version-sequence access on top of the object store.

    Readers follow progress by probing for higher-numbered manifest objects
    (paper §4.2); a LIST fallback handles cold start and large jumps.
    """

    def __init__(self, ns: Namespace, fmt: str = MANIFEST_FORMAT_FLAT,
                 snapshot_every: int = 64, chain: str = "manifest",
                 track_runs: bool = False):
        self.ns = ns
        self.store: ObjectStore = ns.store
        self.format = fmt
        self.snapshot_every = snapshot_every
        #: directory of this version sequence under the run namespace —
        #: "manifest" for the legacy single chain, "manifest/shard-<k>" for
        #: one shard of a sharded layout
        self.chain = chain
        #: maintain per-entry commit-version runs in encoded candidates
        #: (sharded chains only; single-chain manifests stay byte-identical)
        self.track_runs = track_runs
        #: exists() probes issued by the most recent latest_version() call
        #: (instrumentation for the O(log n) discovery regression test)
        self.last_probe_count = 0
        self._cache_lock = threading.Lock()
        self._raw_cache: Dict[int, dict] = {}  # decoded manifest docs (immutable)
        # deque: O(1) popleft on eviction (list.pop(0) was O(n) per insert
        # once the cache reached capacity)
        self._raw_cache_order: "deque[int]" = deque()
        self._raw_cache_cap = 256

    def manifest_key(self, version: int) -> str:
        return self.ns.key(self.chain, f"{version:08d}.manifest")

    def list_versions(self) -> List[int]:
        """All retained versions of THIS chain, by direct-child listing.

        A plain prefix LIST on ``manifest/`` also matches shard subchains,
        compacted segments, and the shard config — everything that is not a
        ``<digits>.manifest`` direct child is skipped (and ``shard-1`` never
        aliases ``shard-10`` because the prefix ends with ``/``)."""
        prefix = self.ns.key(self.chain) + "/"
        out = []
        for k in self.store.list(prefix):
            rest = k[len(prefix):]
            if "/" in rest or not rest.endswith(".manifest"):
                continue
            stem = rest[: -len(".manifest")]
            if stem.isdigit():
                out.append(int(stem))
        return sorted(out)

    # -- raw access ---------------------------------------------------------
    def read_doc(self, version: int) -> dict:
        with self._cache_lock:
            doc = self._raw_cache.get(version)
        if doc is not None:
            return doc
        raw = self.store.get(self.manifest_key(version))
        doc = decode_manifest(raw)
        with self._cache_lock:
            if version not in self._raw_cache:
                self._raw_cache[version] = doc
                self._raw_cache_order.append(version)
                while len(self._raw_cache_order) > self._raw_cache_cap:
                    old = self._raw_cache_order.popleft()
                    self._raw_cache.pop(old, None)
        return doc

    def try_put_version(self, version: int, raw: bytes) -> bool:
        return self.store.put_if_absent(self.manifest_key(version), raw)

    def version_exists(self, version: int) -> bool:
        return self.store.exists(self.manifest_key(version))

    def latest_version(self, hint: int = -1) -> int:
        """Find the highest committed version in O(log gap) probes.

        Gallops forward from ``hint`` (probe hint+1, +2, +4, ... until the
        first miss), then binary-searches the bracketed (hit, miss) range.
        Versions are dense while retained, so the first miss bounds the
        frontier; a concurrent commit landing mid-search is picked up by the
        next poll, exactly as with the old linear probe. Falls back to LIST
        when cold (hint < 0).

        A miss on ``hint + 1`` is ambiguous: either the chain head really is
        ``hint``, or GC trimmed the chain past the hint while this reader was
        stale (retention deletes a dense prefix, so ``hint`` and ``hint + 1``
        vanish together). The head probe re-checks ``hint`` itself and falls
        back to LIST when it is gone — without this, a reader parked in a GC
        hole would conclude the chain is idle and stall at ``hint`` forever."""
        if hint < 0:
            self.last_probe_count = 0
            versions = self.list_versions()
            return versions[-1] if versions else -1
        probes = 1
        if not self.version_exists(hint + 1):
            probes += 1
            if self.version_exists(hint):
                self.last_probe_count = probes
                return hint
            # GC hole: the hint was reclaimed out from under us — re-sync.
            # GC never deletes the chain head, so a LIST result below the
            # hint can only be staleness: clamp instead of regressing.
            self.last_probe_count = probes
            versions = self.list_versions()
            return max(hint, versions[-1]) if versions else hint
        lo, span = hint + 1, 1  # invariant: lo exists
        while True:
            cand = lo + span
            probes += 1
            if self.version_exists(cand):
                lo, span = cand, span * 2
            else:
                hi = cand  # invariant: hi does not exist
                break
        while hi - lo > 1:
            mid = (lo + hi) // 2
            probes += 1
            if self.version_exists(mid):
                lo = mid
            else:
                hi = mid
        self.last_probe_count = probes
        return lo

    # -- view reconstruction --------------------------------------------------
    def load_view(self, version: int,
                  base: Optional[DatasetView] = None) -> DatasetView:
        """Reconstruct the DatasetView at ``version``.

        ``base``: a previously reconstructed older view; in delta format the
        chain walk then only covers (base.version, version].
        """
        if version < 0:
            return DatasetView()
        doc = self.read_doc(version)
        fmt = doc.get("format", MANIFEST_FORMAT_FLAT)
        if fmt == MANIFEST_FORMAT_FLAT:
            doc_base = doc.get("base_step", 0)
            return DatasetView(
                version=doc["version"], base_step=doc_base,
                tgbs=_decode_flat_tgbs(doc["tgbs"], doc_base, base),
                producers=_unpack_producers(doc["producers"]),
                commit_runs=[list(r) for r in doc.get("commit_runs", [])],
            )
        # delta format: walk the chain back to base / snapshot. Versions are
        # dense and snapshot positions deterministic (multiples of
        # snapshot_every), so the docs the walk will need are knowable up
        # front — prefetch them concurrently instead of paying one store
        # round trip per chain link.
        self._prefetch_chain(version, base)
        chain = [doc]
        while True:
            head = chain[-1]
            parent = head.get("parent_version", -1)
            if "snapshot_tgbs" in head or parent < 0:
                break
            if base is not None and base.version == parent:
                break
            chain.append(self.read_doc(parent))
        chain.reverse()
        first = chain[0]
        if "snapshot_tgbs" in first:
            view = DatasetView(
                version=first["version"],
                base_step=first.get("snapshot_base_step", 0),
                tgbs=[TGBDescriptor.unpack(r) for r in first["snapshot_tgbs"]],
                producers=_unpack_producers(first["producers"]),
                commit_runs=[list(r) for r in
                             first.get("snapshot_commit_runs", [])],
            )
            rest = chain[1:]
        elif base is not None and first.get("parent_version", -1) == base.version:
            view = base.copy()
            rest = chain
        else:  # genesis
            view = DatasetView()
            rest = chain
        for doc_i in rest:
            n_new = len(doc_i["delta_tgbs"])
            view.tgbs.extend(TGBDescriptor.unpack(r) for r in doc_i["delta_tgbs"])
            view.producers = _unpack_producers(doc_i["producers"])
            view.version = doc_i["version"]
            # delta docs need no stored runs: every entry they add was
            # committed at exactly this doc's version
            if view.commit_runs or self.track_runs:
                append_run(view.commit_runs, doc_i["version"], n_new)
            new_base = doc_i.get("base_step", 0)
            if new_base > view.base_step:
                drop = new_base - view.base_step
                view.tgbs = view.tgbs[drop:]
                view.base_step = new_base
                view.commit_runs = trim_runs(view.commit_runs, drop)
        return view

    #: never speculatively fetch more than this many chain docs at once
    PREFETCH_CAP = 512

    def _prefetch_chain(self, version: int, base: Optional[DatasetView]) -> None:
        """Warm the doc cache for a delta chain walk ending at ``version``.

        The walk descends until it hits ``base`` or a snapshot doc, whichever
        is nearer. The nearest snapshot can be computed without any reads
        (``snapshot_every`` is a write-side constant of the chain), so the
        exact range is known a priori; fetches happen on a transient pool and
        misbehavior (a missing or transient-failing doc) is left for the
        serial walk to surface. A wrong guess only costs extra cached reads —
        correctness always comes from the walk itself."""
        floor = base.version if base is not None else -1
        if self.snapshot_every > 0:
            boundary = (version // self.snapshot_every) * self.snapshot_every
            floor = max(floor, boundary - 1)
        lo = max(floor + 1, version - self.PREFETCH_CAP)
        with self._cache_lock:
            misses = [v for v in range(lo, version + 1)
                      if v not in self._raw_cache]
        if len(misses) <= 1:
            return

        def fetch(v: int) -> None:
            try:
                self.read_doc(v)
            except (KeyError, NoSuchKey, TransientStoreError):
                pass
        with ThreadPoolExecutor(max_workers=min(8, len(misses)),
                                thread_name_prefix="bw-chainpf") as pool:
            list(pool.map(fetch, misses))

    # -- candidate construction ----------------------------------------------
    def encode_candidate(self, parent: DatasetView, new_tgbs: List[TGBDescriptor],
                         producers: Dict[str, ProducerState],
                         trim_to_step: Optional[int] = None) -> Tuple[int, bytes]:
        """Build the next manifest object from ``parent`` + this commit's TGBs.

        Returns (version, raw_bytes). Applies logical trim up to
        ``trim_to_step`` (drop list entries below it and advance base_step).
        """
        version = parent.version + 1
        base_step = parent.base_step
        tgbs = parent.tgbs
        runs = [list(r) for r in parent.commit_runs] if self.track_runs else []
        if trim_to_step is not None and trim_to_step > base_step:
            keep_from = min(trim_to_step, parent.total_steps)
            tgbs = tgbs[keep_from - base_step:]
            if self.track_runs:
                runs = trim_runs(runs, keep_from - base_step)
            base_step = keep_from
        if self.track_runs:
            append_run(runs, version, len(new_tgbs))
        if self.format == MANIFEST_FORMAT_FLAT:
            view = DatasetView(version=version, base_step=base_step,
                               tgbs=list(tgbs) + list(new_tgbs),
                               producers=producers, commit_runs=runs)
            return version, encode_flat_manifest(view)
        snapshot = None
        if version % self.snapshot_every == 0:
            snapshot = DatasetView(version=version, base_step=base_step,
                                   tgbs=list(tgbs) + list(new_tgbs),
                                   producers=producers, commit_runs=runs)
        return version, encode_delta_manifest(
            version=version, parent_version=parent.version, new_tgbs=new_tgbs,
            producers=producers, base_step=base_step, snapshot_view=snapshot)


# ---------------------------------------------------------------------------
# Sharded manifest chains (beyond-paper: ROADMAP item 4)
# ---------------------------------------------------------------------------
#
# Layout under the run namespace:
#
#   manifest/shards.cfg            one-shot conditional config: shard count K
#   manifest/shard-<k>/<v>.manifest   K independent version chains
#   manifest/compact/<seq>.seg     compacted cold-prefix segments (merged order)
#
# Each shard chain is an ordinary ManifestStore (same codecs, same conditional
# put) whose ``base_step`` is reinterpreted as "entries trimmed from this
# shard" and which additionally tracks ``commit_runs``. The *global* step
# sequence is the deterministic merge of all shard entries ordered by
# ``(commit version, shard index)`` — reconstructible by any reader from
# storage alone, with no coordination. An entry is *stable* (consumable) once
# every shard's chain has advanced to at least its commit version: a shard
# still at version L could yet commit at L+1, which would sort before any
# unstable run committed at L+2 elsewhere. The frontier ``F = min_k L_k``
# therefore bounds visibility, and producers heartbeat lagging shards (empty
# commits) so an idle shard cannot stall the merge.

def shards_cfg_key(ns: Namespace) -> str:
    return ns.key("manifest", "shards.cfg")


def read_shard_layout(ns: Namespace) -> Optional[dict]:
    """The decoded ``shards.cfg`` doc, or None for the legacy single chain.

    Retries transient store failures (throttle storms, brownouts) with
    clock-paced backoff: the config is immutable once claimed, so retrying
    is always safe — and giving up would either kill a client at
    construction or, worse, misread a sharded run as a legacy single chain.
    """
    delay, raw = 0.01, None
    for attempt in range(12):
        try:
            raw = ns.store.get(shards_cfg_key(ns))
            break
        except (KeyError, NoSuchKey):
            return None
        except TransientStoreError:
            if attempt == 11:
                raise
            ns.store.clock.sleep(delay)
            delay = min(delay * 2, 0.5)
    doc = msgpack.unpackb(raw, raw=False)
    if not isinstance(doc, dict) or doc.get("schema") != SHARDS_CFG_SCHEMA:
        raise ValueError(f"unsupported shards.cfg schema in {ns.prefix}: "
                         f"{doc if not isinstance(doc, dict) else doc.get('schema')!r}")
    return doc


def read_shard_config(ns: Namespace) -> Optional[int]:
    """Shard count K of this run, or None for the legacy single chain."""
    doc = read_shard_layout(ns)
    return int(doc["n_shards"]) if doc is not None else None


def write_shard_config(ns: Namespace, n_shards: int,
                       fmt: str = MANIFEST_FORMAT_DELTA) -> int:
    """Claim the run's shard layout (first writer wins). Returns the
    *effective* K: on a lost race the already-committed layout is
    authoritative — shard count is immutable for the life of a run.

    The claim also pins the shard chains' encoding (``fmt``), so every
    client that discovers the layout encodes consistently. The default is
    DELTA: sharding exists to scale the commit rate, and flat re-encoding
    of the whole entry list per commit would put an O(history) CPU+bytes
    term right back on that path.

    Refuses to claim a layout over a run that already has committed legacy
    single-chain manifests: sharded readers only look at ``manifest/shard-*``
    and compact segments, so the claim would make the entire existing
    history invisible — consumers would see an empty dataset and producers
    would recover offset -1 and re-commit from scratch. Shard count is a
    run-creation decision; migrating an existing run is a separate
    (offline) operation."""
    if n_shards < 2:
        raise ValueError(f"sharded layout needs n_shards >= 2, got {n_shards}")
    # already claimed: adopt (first writer won; also skips the legacy LIST
    # on the common every-session-passes-manifest_shards path)
    existing = read_shard_config(ns)
    if existing is not None:
        return existing
    legacy = ManifestStore(ns).list_versions()
    if legacy:
        raise ValueError(
            f"run {ns.prefix} already has {len(legacy)} committed "
            f"single-chain manifest version(s) (head "
            f"{legacy[-1]}): claiming a sharded layout would hide that "
            f"history from every sharded reader. Create sharded runs "
            f"under a fresh namespace.")
    raw = msgpack.packb({"schema": SHARDS_CFG_SCHEMA, "n_shards": n_shards,
                         "fmt": fmt}, use_bin_type=True)
    if ns.store.put_if_absent(shards_cfg_key(ns), raw):
        return n_shards
    return read_shard_config(ns) or n_shards


# -- compacted segments (read path; the writer lives in core/compactor.py) ---

SEGMENT_SCHEMA = 1


@dataclass
class CompactSegment:
    """One fold of the cold merged-order prefix.

    ``base_step`` is the global step of ``tgbs[0]``; ``folds[k]`` is the
    CUMULATIVE number of shard-k entries covered by segments up to and
    including this one. Cumulative counts make recovery idempotent: a shard
    whose trim lags its fold count (compactor crashed between segment write
    and trim commits) is deduplicated by skipping its first
    ``folds[k] - base`` live entries.
    """

    seq: int
    base_step: int
    tgbs: List[TGBDescriptor]
    folds: List[int]

    @property
    def end_step(self) -> int:
        return self.base_step + len(self.tgbs)

    def pack(self) -> bytes:
        return msgpack.packb({
            "schema": SEGMENT_SCHEMA, "seq": self.seq,
            "base_step": self.base_step,
            "tgbs": [t.pack() for t in self.tgbs],
            "folds": list(self.folds),
        }, use_bin_type=True)

    @staticmethod
    def unpack(raw: bytes) -> "CompactSegment":
        d = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        if d.get("schema") != SEGMENT_SCHEMA:
            raise ValueError(f"unsupported segment schema {d.get('schema')!r}")
        return CompactSegment(
            seq=d["seq"], base_step=d["base_step"],
            tgbs=[TGBDescriptor.unpack(r) for r in d["tgbs"]],
            folds=list(d["folds"]))


class SegmentStore:
    """Sequence access to the compacted-segment chain (conditional put)."""

    def __init__(self, ns: Namespace):
        self.ns = ns
        self.store: ObjectStore = ns.store

    def seg_key(self, seq: int) -> str:
        return self.ns.key("manifest", "compact", f"{seq:08d}.seg")

    def seqs(self) -> List[int]:
        prefix = self.ns.key("manifest", "compact") + "/"
        out = []
        for k in self.store.list(prefix):
            rest = k[len(prefix):]
            if "/" in rest or not rest.endswith(".seg"):
                continue
            stem = rest[: -len(".seg")]
            if stem.isdigit():
                out.append(int(stem))
        return sorted(out)

    def latest(self) -> int:
        seqs = self.seqs()
        return seqs[-1] if seqs else -1

    def read(self, seq: int) -> CompactSegment:
        return CompactSegment.unpack(self.store.get(self.seg_key(seq)))

    def try_put(self, seg: CompactSegment) -> bool:
        return self.store.put_if_absent(self.seg_key(seg.seq), seg.pack())


# -- merged view --------------------------------------------------------------

@dataclass
class MergedDatasetView(DatasetView):
    """The global step sequence merged from K shard chains + segments.

    Duck-types ``DatasetView`` for every reader (consumer, reclaimer, fsck):
    ``tgbs[i]`` is global step ``base_step + i``, ``producers`` maps each
    producer to its max committed offset across shards, and ``version`` is the
    monotone merged scalar ``sum_k (L_k + 1)``. The merged list is strictly
    append-only between polls: every newly stable run's commit version exceeds
    the previous frontier, so new entries always sort after everything already
    merged — advancing a view is O(new entries), never a re-merge.
    """

    shard_latest: List[int] = field(default_factory=list)    # L_k per shard
    shard_views: List[DatasetView] = field(default_factory=list)
    merged_counts: List[int] = field(default_factory=list)   # entries merged,
    #                                                          absolute per shard
    folds: List[int] = field(default_factory=list)           # cumulative folds
    entry_shards: List[int] = field(default_factory=list)    # parallel to tgbs;
    #                                                          -1 == from segment
    seg_seq: int = -1                                        # newest applied seg
    frontier: int = -1                                       # min_k L_k

    def copy(self) -> "MergedDatasetView":
        return MergedDatasetView(
            self.version, self.base_step, list(self.tgbs),
            dict(self.producers), [list(r) for r in self.commit_runs],
            shard_latest=list(self.shard_latest),
            shard_views=[v.copy() for v in self.shard_views],
            merged_counts=list(self.merged_counts), folds=list(self.folds),
            entry_shards=list(self.entry_shards), seg_seq=self.seg_seq,
            frontier=self.frontier)


class ShardedManifestStore:
    """K shard chains + compacted segments behind the ManifestStore read API.

    ``latest_version(hint)`` probes every shard chain (fanned out on a small
    thread pool so poll latency stays flat in K) and returns the merged
    scalar; ``load_view`` then advances the cached merged view incrementally.
    The returned view object is shared and append-only-mutated across polls —
    exactly the invariant consumers already rely on for the step sequence.

    Writers do NOT go through this class's version API: each producer's
    ``ShardedCommitProtocol`` commits to one shard chain directly.
    """

    def __init__(self, ns: Namespace, n_shards: int,
                 fmt: str = MANIFEST_FORMAT_FLAT, snapshot_every: int = 64):
        if n_shards < 2:
            raise ValueError(f"ShardedManifestStore needs n_shards >= 2, "
                             f"got {n_shards}")
        self.ns = ns
        self.store: ObjectStore = ns.store
        self.format = fmt
        self.snapshot_every = snapshot_every
        self.n_shards = n_shards
        self.shards = [
            ManifestStore(ns, fmt, snapshot_every,
                          chain=f"manifest/shard-{k}", track_runs=True)
            for k in range(n_shards)
        ]
        self.segments = SegmentStore(ns)
        self.last_probe_count = 0
        self._lock = threading.RLock()
        self._view = MergedDatasetView()
        self._probed: List[int] = [-1] * n_shards
        self._probed_once = False
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- probing -----------------------------------------------------------
    def _pool_get(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=min(self.n_shards, 8),
                thread_name_prefix="bw-shardprobe")
        return self._pool

    def _probe_locked(self) -> None:
        hints = list(self._probed)
        if self.n_shards > 1:
            pool = self._pool_get()
            latests = list(pool.map(
                lambda k: self.shards[k].latest_version(hint=hints[k]),
                range(self.n_shards)))
        else:  # pragma: no cover - constructor enforces K >= 2
            latests = [self.shards[0].latest_version(hint=hints[0])]
        self._probed = latests
        self._probed_once = True
        self.last_probe_count = sum(s.last_probe_count for s in self.shards)

    def latest_version(self, hint: int = -1) -> int:
        """The merged scalar version ``sum_k (L_k + 1)`` — monotone under
        commits on any shard. ``hint`` is accepted for interface parity; the
        per-shard hints cached from previous probes are what bound cost."""
        with self._lock:
            self._probe_locked()
            return sum(l + 1 for l in self._probed)

    def version_exists(self, version: int) -> bool:
        return version <= self.latest_version()

    # -- view reconstruction ----------------------------------------------
    def load_view(self, version: Optional[int] = None,
                  base: Optional[DatasetView] = None) -> MergedDatasetView:
        """Advance and return the merged view.

        ``version`` is a *floor* on the merged scalar (the scalar does not
        name a unique store state, so exact-version loads are meaningless
        here): if the cached probes are behind it, re-probe once. ``base`` is
        accepted for interface parity; incrementality is internal.
        """
        with self._lock:
            if not self._probed_once:
                self._probe_locked()
            if version is not None and version >= 0 and \
                    sum(l + 1 for l in self._probed) < version:
                self._probe_locked()
            self._advance_locked()
            return self._view

    def _advance_locked(self) -> None:
        mv = self._view
        K = self.n_shards
        if not mv.shard_views:  # cold start: fold in retained segments first
            mv.shard_views = [DatasetView() for _ in range(K)]
            mv.shard_latest = [-1] * K
            mv.merged_counts = [0] * K
            mv.folds = [0] * K
            self._cold_segments_locked(mv)
        for k in range(K):
            if self._probed[k] > mv.shard_views[k].version:
                mv.shard_views[k] = self.shards[k].load_view(
                    self._probed[k], base=mv.shard_views[k])
            mv.shard_latest[k] = mv.shard_views[k].version
        # a shard trimmed past our live-merge position: the compactor folded
        # entries we had not merged yet — catch up from the segments
        if any(v.base_step > mv.merged_counts[k]
               for k, v in enumerate(mv.shard_views)):
            self._apply_new_segments_locked(mv)
        F = min(mv.shard_latest)
        candidates: List[Tuple[int, int, List[TGBDescriptor]]] = []
        for k, v in enumerate(mv.shard_views):
            start = mv.merged_counts[k] - v.base_step
            if start < 0:
                raise RuntimeError(
                    f"shard {k} of {self.ns.prefix}: trim base {v.base_step} "
                    f"overran merged position {mv.merged_counts[k]} with no "
                    f"covering segment (compaction orphan; run fsck)")
            idx, taken_end = 0, start
            for ver, count in v.commit_runs:
                lo, hi = idx, idx + count
                idx = hi
                if hi <= start:
                    continue
                if ver > F:
                    break  # runs are version-sorted: nothing stable beyond
                candidates.append((ver, k, v.tgbs[max(lo, start):hi]))
                taken_end = hi
            mv.merged_counts[k] = v.base_step + max(taken_end, start)
        candidates.sort(key=lambda t: (t[0], t[1]))
        for _ver, k, chunk in candidates:
            mv.tgbs.extend(chunk)
            mv.entry_shards.extend([k] * len(chunk))
        mv.frontier = F
        mv.version = sum(l + 1 for l in mv.shard_latest)
        producers: Dict[str, ProducerState] = {}
        for v in mv.shard_views:
            for pid, st in v.producers.items():
                cur = producers.get(pid)
                if cur is None or st.committed_offset > cur.committed_offset:
                    producers[pid] = st
        mv.producers = producers

    def _cold_segments_locked(self, mv: MergedDatasetView) -> None:
        seqs = self.segments.seqs()
        for i, seq in enumerate(seqs):
            seg = self.segments.read(seq)
            if i == 0:
                mv.base_step = seg.base_step
            elif seg.base_step != mv.base_step + len(mv.tgbs):
                raise RuntimeError(
                    f"segment {seq} of {self.ns.prefix} does not chain: "
                    f"base_step {seg.base_step} != previous end "
                    f"{mv.base_step + len(mv.tgbs)} (run fsck)")
            mv.tgbs.extend(seg.tgbs)
            mv.entry_shards.extend([-1] * len(seg.tgbs))
            mv.folds = list(seg.folds)
            mv.seg_seq = seq
        mv.merged_counts = list(mv.folds)

    def _apply_new_segments_locked(self, mv: MergedDatasetView) -> None:
        """Fold segments newer than ``mv.seg_seq`` into the merged view.

        Driven by the segment LIST rather than ``exists(seq + 1)`` probing:
        the reclaimer deletes cold segments (everything wholly below the
        consumer watermark except the newest), so a warm view that lags the
        fold horizon finds a HOLE after its last applied seq. That hole is
        trimmed history, not corruption — every step it covered is below the
        global watermark and its TGB objects are already deleted. The view
        restarts its merged prefix at the first retained segment boundary;
        a reader still asking for the dropped steps gets the legacy trim
        semantics (``StepUnavailable`` via ``base_step``) instead of a false
        'compaction orphan' crash."""
        for seq in self.segments.seqs():
            if seq <= mv.seg_seq:
                continue
            try:
                seg = self.segments.read(seq)
            except NoSuchKey:
                continue  # reclaimed between LIST and GET; successors cover it
            merged_end = mv.base_step + len(mv.tgbs)
            if seg.base_step > merged_end:
                # retention gap: steps [merged_end, seg.base_step) were
                # folded and reclaimed past this view — resync at the
                # boundary (entries we held are all below the watermark)
                mv.base_step = seg.base_step
                mv.tgbs = list(seg.tgbs)
                mv.entry_shards = [-1] * len(seg.tgbs)
            elif seg.end_step > merged_end:
                skip = merged_end - seg.base_step
                mv.tgbs.extend(seg.tgbs[skip:])
                mv.entry_shards.extend([-1] * (len(seg.tgbs) - skip))
            mv.folds = list(seg.folds)
            mv.seg_seq = seq
            for k in range(self.n_shards):
                mv.merged_counts[k] = max(mv.merged_counts[k], seg.folds[k])

    # -- producer-side helpers (used by ShardedCommitProtocol) --------------
    def shard_for(self, producer_id: str) -> int:
        """Deterministic default shard of a producer (hash-by-producer)."""
        import zlib
        return zlib.crc32(producer_id.encode("utf-8")) % self.n_shards

    def merged_producer_offset(self, producer_id: str) -> int:
        """Max committed offset of one producer across every shard chain —
        one latest-doc read per shard (delta and flat docs both carry the
        full producer map, so no chain walks are needed)."""
        best = -1
        for shard in self.shards:
            latest = shard.latest_version(hint=-1)
            if latest < 0:
                continue
            doc = shard.read_doc(latest)
            row = doc.get("producers", {}).get(producer_id)
            if row is not None:
                best = max(best, ProducerState.unpack(row).committed_offset)
        return best


def open_manifest_store(ns: Namespace, fmt: Optional[str] = None,
                        snapshot_every: int = 64,
                        shards: Optional[int] = None):
    """Open the manifest plane of a run, resolving its shard layout.

    ``shards=None`` discovers the layout from storage (``manifest/shards.cfg``)
    — readers, fsck, and reclaimers never need to be told. ``shards=K`` with
    K >= 2 claims a sharded layout at run creation (first writer wins; a
    lost race adopts the committed K, since shard count is immutable for the
    life of a run). ``shards=1`` (or an undiscovered config) yields a plain
    :class:`ManifestStore` — byte-for-byte the legacy single-chain behavior.

    ``fmt`` applies to the single-chain case (default flat, the paper-faithful
    encoding) and to a fresh shard-layout claim (default delta). On a sharded
    run the cfg's recorded format always wins — one run, one encoding.
    """
    if shards is not None and shards > 1:
        write_shard_config(ns, shards, fmt=fmt or MANIFEST_FORMAT_DELTA)
    doc = read_shard_layout(ns)
    if doc is None or int(doc["n_shards"]) <= 1:
        return ManifestStore(ns, fmt or MANIFEST_FORMAT_FLAT, snapshot_every)
    return ShardedManifestStore(ns, int(doc["n_shards"]),
                                doc.get("fmt", MANIFEST_FORMAT_DELTA),
                                snapshot_every)
