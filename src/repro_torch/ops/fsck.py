"""Storage-native integrity checking (the ``batchweave fsck`` engine; port
of ``repro.ops.fsck``).

Everything here operates purely through the ``ObjectStore`` interface — no
side channel, no producer/consumer state — per the paper's storage-native
recovery design: the object store *is* the system of record, so any operator
tool (or replacement process) can audit a run from the namespace alone.

Checks performed per namespace (and recursively per stream):

  * **manifest chain** — retained versions must be contiguous (the reclaimer
    deletes only a prefix); every doc must decode; a delta chain must resolve
    parent-by-parent back to a snapshot or genesis. Violations are "torn
    chain" errors.
  * **torn commits** — every TGB the latest view references must exist with
    exactly the byte size the manifest recorded.
  * **orphans** — objects under ``tgb/`` that no retained manifest reaches.
    Offsets at or below the producer's committed offset are superseded
    duplicates from crashed incarnations (or trim leftovers): safe to delete,
    and ``repair`` does. Offsets above it may belong to a *live* producer's
    uncommitted pending set, so they are reported but never touched.
  * **trim-vs-checkpoint skew** — the trim marker must never pass the lowest
    checkpoint watermark (else a restoring rank could find its steps
    reclaimed), the latest view's ``base_step`` must not exceed it either,
    and every watermark's manifest version must still be retained.
  * **derived streams** — on streams produced by ``repro.graph``: the
    derive-cursor chain must be contiguous, decodable, non-regressive, and
    never ahead of the manifest; derived TGBs whose provenance cites source
    TGBs the source manifest no longer resolves are flagged
    "provenance-dangling"; derived outputs above the committed cursor are
    reclassified as safe orphans (a restarted worker regenerates them
    content-addressed).
  * **RunManifest alignment** — on runs with a RunManifest: the entry chain
    must be contiguous and decodable; the latest entry's model checkpoint
    must exist intact (MANIFEST + every leaf at its recorded size); its data
    cursor must decode and still be restorable (manifest version retained,
    trim marker at or below the aligned step — per stream on multi-stream
    runs, where a sharded stream's retained range is its merged versions up
    to the head: the one place the port departs from the reference, which
    reads such a cursor against flat versions and calls it unreadable); and model uploads no entry ever named (a trainer killed between
    upload and commit) surface as safe orphans once a later entry
    supersedes them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core import _msgpack as msgpack
from repro_torch.core.lifecycle import read_trim_marker, read_watermarks
from repro_torch.core.manifest import (MANIFEST_FORMAT_FLAT, DatasetView,
                                       ManifestStore, ShardedManifestStore,
                                       read_shard_config)
from repro_torch.core.objectstore import Namespace, NoSuchKey
from repro_torch.dataplane.types import Checkpoint
from repro_torch.run.manifest import RunManifestError, RunManifestStore
from repro_torch.train.checkpoint import checkpoint_dir_step, dtype_itemsize

__all__ = ["FsckIssue", "FsckReport", "fsck", "list_streams"]


@dataclass(frozen=True)
class FsckIssue:
    severity: str  # "error" | "warn"
    kind: str      # e.g. "torn-manifest-chain", "missing-tgb", "orphan-tgb"
    key: str       # object key (or logical subject) the issue is about
    detail: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.kind}: {self.key} — {self.detail}"


@dataclass
class FsckReport:
    namespace: str
    issues: List[FsckIssue] = field(default_factory=list)
    checked_manifests: int = 0
    checked_tgbs: int = 0
    orphans: List[str] = field(default_factory=list)   # safe-to-delete keys
    pending: List[str] = field(default_factory=list)   # possibly-live keys
    repaired: List[str] = field(default_factory=list)  # deleted by repair
    streams: Dict[str, "FsckReport"] = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        """No errors and no reclaimable orphans, here or in any stream."""
        if any(i.severity == "error" for i in self.issues) or self.orphans:
            return False
        return all(r.clean for r in self.streams.values())

    def all_issues(self) -> List[FsckIssue]:
        out = list(self.issues)
        for r in self.streams.values():
            out.extend(r.all_issues())
        return out

    def summary(self) -> str:
        n_err = sum(1 for i in self.all_issues() if i.severity == "error")
        n_warn = sum(1 for i in self.all_issues() if i.severity == "warn")
        orphans = len(self.orphans) + sum(len(r.orphans)
                                          for r in self.streams.values())
        state = "clean" if self.clean else "NOT CLEAN"
        return (f"fsck {self.namespace}: {state} "
                f"({self.checked_manifests} manifests, "
                f"{self.checked_tgbs} tgbs, {n_err} errors, {n_warn} warnings, "
                f"{orphans} orphans, {len(self.repaired)} repaired)")


def list_streams(ns: Namespace) -> List[str]:
    """Names of child streams under ``<prefix>/streams/`` (storage-derived)."""
    prefix = ns.key("streams") + "/"
    names = set()
    for key in ns.store.list(prefix):
        rest = key[len(prefix):]
        if "/" in rest:
            names.add(rest.split("/", 1)[0])
    return sorted(names)


def _manifest_versions(ns: Namespace, chain: str = "manifest") -> List[int]:
    """Retained versions of ONE chain, by direct-child listing: a prefix list
    of ``manifest/`` on a sharded run also matches shard subchains, compacted
    segments, and ``shards.cfg`` — none of which are this chain's versions."""
    prefix = ns.key(chain) + "/"
    out = []
    for key in ns.store.list(prefix):
        rest = key[len(prefix):]
        if "/" in rest or not rest.endswith(".manifest"):
            continue
        stem = rest[: -len(".manifest")]
        if stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def _chain_key(ns: Namespace, chain: str, version: int) -> str:
    return ns.key(chain, f"{version:08d}.manifest")


def _parse_tgb_key(ns: Namespace, key: str) -> Optional[Tuple[str, int]]:
    """``<prefix>/tgb/<producer_id>/<offset>-<token>.tgb`` -> (pid, offset)."""
    prefix = ns.key("tgb") + "/"
    if not key.startswith(prefix):
        return None
    rest = key[len(prefix):]
    try:
        pid, fname = rest.rsplit("/", 1)
        offset = int(fname.split("-", 1)[0])
    except ValueError:
        return None
    return pid, offset


def _check_chain(ns: Namespace, versions: List[int], report: FsckReport,
                 chain: str = "manifest") -> Optional[DatasetView]:
    """Validate one manifest chain; return the latest view if loadable."""
    store = ns.store
    for prev, cur in zip(versions, versions[1:]):
        if cur != prev + 1:
            report.issues.append(FsckIssue(
                "error", "torn-manifest-chain", _chain_key(ns, chain, prev + 1),
                f"retained versions jump {prev} -> {cur}: intermediate "
                f"manifests are missing"))
    docs = {}
    for v in versions:
        try:
            docs[v] = msgpack.unpackb(store.get(_chain_key(ns, chain, v)),
                                      raw=False, strict_map_key=False)
            report.checked_manifests += 1
        except (KeyError, NoSuchKey):
            report.issues.append(FsckIssue(
                "error", "unreadable-manifest", _chain_key(ns, chain, v),
                "listed but not readable"))
        except Exception as e:  # undecodable payload = torn commit
            report.issues.append(FsckIssue(
                "error", "corrupt-manifest", _chain_key(ns, chain, v),
                f"cannot decode: {type(e).__name__}: {e}"))
    if not versions or versions[-1] not in docs:
        return None
    # delta chains must resolve back to a snapshot / genesis / retained parent
    head = docs[versions[-1]]
    seen = set()
    while head.get("format", MANIFEST_FORMAT_FLAT) != MANIFEST_FORMAT_FLAT \
            and "snapshot_tgbs" not in head:
        parent = head.get("parent_version", -1)
        if parent < 0:
            break
        if parent in seen:
            report.issues.append(FsckIssue(
                "error", "torn-manifest-chain", _chain_key(ns, chain, parent),
                "delta parent cycle"))
            return None
        seen.add(parent)
        if parent not in docs:
            report.issues.append(FsckIssue(
                "error", "torn-manifest-chain", _chain_key(ns, chain, parent),
                f"delta manifest v{head.get('version')} needs parent "
                f"v{parent}, which is missing"))
            return None
        head = docs[parent]
    try:
        return ManifestStore(ns, chain=chain).load_view(versions[-1])
    except Exception as e:
        report.issues.append(FsckIssue(
            "error", "torn-manifest-chain",
            _chain_key(ns, chain, versions[-1]),
            f"latest view does not reconstruct: {type(e).__name__}: {e}"))
        return None


def _check_sharded(ns: Namespace, n_shards: int,
                   report: FsckReport) -> Optional[DatasetView]:
    """Sharded-run audits: every shard chain (torn/corrupt/decodable), the
    compact-segment chain (sequence gaps, base/end continuity), compaction
    orphans (a shard base trimmed beyond the folded count is lost data; a
    base lagging the fold is a repairable compactor crash window), and the
    merged view's globally-ordered step sequence (duplicate TGBs, regressed
    per-producer sequences, committed offsets behind observed entries).
    Returns the merged view, or None if it does not reconstruct."""
    shard_views: List[Optional[DatasetView]] = []
    for k in range(n_shards):
        chain = f"manifest/shard-{k}"
        versions = _manifest_versions(ns, chain)
        shard_views.append(_check_chain(ns, versions, report, chain=chain))
    m = ShardedManifestStore(ns, n_shards)
    seqs = m.segments.seqs()
    for prev, cur in zip(seqs, seqs[1:]):
        if cur != prev + 1:
            report.issues.append(FsckIssue(
                "error", "torn-segment-chain", m.segments.seg_key(prev + 1),
                f"compact segment sequence jumps {prev} -> {cur}"))
    prev_end: Optional[int] = None
    latest_folds: Optional[List[int]] = None
    for seq in seqs:
        skey = m.segments.seg_key(seq)
        try:
            seg = m.segments.read(seq)
            report.checked_manifests += 1
        except Exception as e:
            report.issues.append(FsckIssue(
                "error", "corrupt-segment", skey,
                f"cannot decode: {type(e).__name__}: {e}"))
            prev_end = None
            continue
        if prev_end is not None and seg.base_step != prev_end:
            report.issues.append(FsckIssue(
                "error", "torn-segment-chain", skey,
                f"segment base_step {seg.base_step} != previous segment end "
                f"{prev_end}: folded history has a gap or overlap"))
        prev_end = seg.end_step
        latest_folds = list(seg.folds)
    if latest_folds is not None:
        for k, v in enumerate(shard_views):
            if v is None:
                continue
            if v.base_step > latest_folds[k]:
                report.issues.append(FsckIssue(
                    "error", "compaction-orphan",
                    _chain_key(ns, f"manifest/shard-{k}", v.version),
                    f"shard {k} trimmed its base to {v.base_step} but only "
                    f"{latest_folds[k]} of its entries are folded into "
                    f"segments: {v.base_step - latest_folds[k]} entries are "
                    f"unreachable"))
            elif v.base_step < latest_folds[k]:
                report.issues.append(FsckIssue(
                    "warn", "compaction-lagging-trim",
                    _chain_key(ns, f"manifest/shard-{k}", v.version),
                    f"shard {k} base {v.base_step} lags its folded count "
                    f"{latest_folds[k]} (compactor crash window; readers "
                    f"deduplicate, the next compactor cycle repairs)"))
    try:
        mv = m.load_view(m.latest_version())
    except Exception as e:
        report.issues.append(FsckIssue(
            "error", "merge-view-unreconstructable", ns.key("manifest"),
            f"merged shard view does not reconstruct: "
            f"{type(e).__name__}: {e}"))
        return None
    seen_ids: Dict[str, int] = {}
    last_seq: Dict[str, int] = {}
    for i, t in enumerate(mv.tgbs):
        step = mv.base_step + i
        if t.tgb_id in seen_ids:
            report.issues.append(FsckIssue(
                "error", "step-sequence-duplicate", t.object_key,
                f"TGB {t.tgb_id} appears at merged steps "
                f"{seen_ids[t.tgb_id]} and {step}: exactly-once is broken"))
        seen_ids[t.tgb_id] = step
        prev = last_seq.get(t.producer_id)
        if prev is not None and t.producer_seq <= prev:
            report.issues.append(FsckIssue(
                "error", "step-sequence-regression", t.object_key,
                f"producer {t.producer_id!r} sequence regresses "
                f"{prev} -> {t.producer_seq} at merged step {step}: the "
                f"global order is not a merge of per-producer streams"))
        last_seq[t.producer_id] = t.producer_seq
    for pid, last in last_seq.items():
        off = mv.producer_offset(pid)
        if off < last:
            report.issues.append(FsckIssue(
                "error", "step-sequence-unaccounted", ns.key("manifest"),
                f"producer {pid!r} has merged entries through seq {last} but "
                f"no shard map commits past offset {off}: a replacement "
                f"producer would re-emit committed work"))
    return mv


def _check_tgbs(ns: Namespace, view: Optional[DatasetView],
                report: FsckReport) -> None:
    store = ns.store
    trim = read_trim_marker(ns)
    safe_step = trim[0] if trim is not None else 0
    referenced = set()
    if view is not None:
        for i, t in enumerate(view.tgbs):
            referenced.add(t.object_key)
            report.checked_tgbs += 1
            step = view.base_step + i
            try:
                size = store.head(t.object_key)
            except (KeyError, NoSuchKey):
                if step < safe_step:
                    # legitimately reclaimed: physically deleted below the
                    # trim marker, still listed until producers' next
                    # logical trim advances base_step
                    continue
                report.issues.append(FsckIssue(
                    "error", "missing-tgb", t.object_key,
                    f"step {step} referenced by manifest v{view.version} "
                    f"(tgb_id={t.tgb_id}) but absent from the store"))
                continue
            if size != t.size_bytes:
                report.issues.append(FsckIssue(
                    "error", "tgb-size-mismatch", t.object_key,
                    f"manifest records {t.size_bytes} B, object is {size} B "
                    f"(torn commit)"))
    for key in store.list(ns.key("tgb")):
        if key in referenced:
            continue
        parsed = _parse_tgb_key(ns, key)
        if parsed is None:
            report.orphans.append(key)
            report.issues.append(FsckIssue(
                "warn", "orphan-tgb", key, "unparseable key, unreferenced"))
            continue
        pid, offset = parsed
        committed = view.producer_offset(pid) if view is not None else -1
        if offset <= committed:
            report.orphans.append(key)
            report.issues.append(FsckIssue(
                "warn", "orphan-tgb", key,
                f"producer {pid!r} committed through offset {committed} via "
                f"other objects; this one is superseded (safe to delete)"))
        else:
            report.pending.append(key)
            report.issues.append(FsckIssue(
                "warn", "pending-tgb", key,
                f"offset {offset} > committed {committed}: uncommitted — "
                f"either a live producer's pending TGB or a crashed "
                f"incarnation's leftover (not touched)"))


def _check_trim_skew(ns: Namespace, view: Optional[DatasetView],
                     versions: List[int], report: FsckReport) -> None:
    wms = read_watermarks(ns)
    trim = read_trim_marker(ns)
    if wms:
        min_step = min(w.step for w in wms.values())
        min_version = min(w.version for w in wms.values())
        if trim is not None:
            safe_step, safe_version = trim
            if safe_step > min_step:
                report.issues.append(FsckIssue(
                    "error", "trim-skew", ns.trim_key(),
                    f"trim marker safe_step={safe_step} passed the lowest "
                    f"checkpoint watermark step {min_step}: a restoring rank "
                    f"would find its batches reclaimed"))
            if safe_version > min_version:
                report.issues.append(FsckIssue(
                    "error", "trim-skew", ns.trim_key(),
                    f"trim marker safe_version={safe_version} passed the "
                    f"lowest watermark version {min_version}"))
        if view is not None and view.base_step > min_step:
            report.issues.append(FsckIssue(
                "error", "trim-skew", ns.manifest_key(view.version),
                f"latest manifest base_step={view.base_step} passed the "
                f"lowest watermark step {min_step}"))
        if versions:
            lowest_retained = versions[0]
            for rank, wm in sorted(wms.items()):
                if wm.version >= 0 and wm.version < lowest_retained:
                    report.issues.append(FsckIssue(
                        "error", "watermark-unreadable",
                        ns.watermark_key(rank),
                        f"rank {rank} checkpointed at manifest v{wm.version} "
                        f"but the oldest retained version is "
                        f"v{lowest_retained}: that checkpoint cannot "
                        f"restore"))
    elif trim is not None and trim[0] > 0:
        report.issues.append(FsckIssue(
            "warn", "trim-without-watermarks", ns.trim_key(),
            f"trim marker at safe_step={trim[0]} but no watermarks exist"))


def _stream_retained_versions(ns: Namespace, name: str) -> List[int]:
    """Retained versions of stream ``name``'s chain. On a sharded stream an
    aligned cursor's version is the merged scalar, restorable up to the
    current head, so the range is ``[0, head]`` as ``fsck`` gives a sharded
    run's own checks; the reference lists flat versions here, finds none on
    a sharded stream and reports every composite cursor over one
    unreadable."""
    sns = ns.stream(name)
    try:
        n_shards = read_shard_config(sns)
    except Exception:
        n_shards = None  # the stream's own fsck reports the corrupt config
    if n_shards is not None and n_shards > 1:
        latest = ShardedManifestStore(sns, n_shards).latest_version()
        return list(range(0, latest + 1, max(1, latest))) if latest >= 0 \
            else []
    return _manifest_versions(sns)


def _check_runmanifest(ns: Namespace, versions: List[int],
                       report: FsckReport) -> None:
    """RunManifest <-> manifest <-> trim-marker consistency (aligned
    recovery): the latest committed entry must actually be restorable."""
    runs = RunManifestStore(ns)
    seqs = runs.seqs()
    if not seqs:
        return  # bare data-plane namespace: nothing aligned to audit
    for prev, cur in zip(seqs, seqs[1:]):
        if cur != prev + 1:
            report.issues.append(FsckIssue(
                "error", "torn-runmanifest-chain", runs.key(prev + 1),
                f"RunManifest sequence jumps {prev} -> {cur}"))
    entries = {}
    for seq in seqs:
        try:
            entries[seq] = runs.read(seq)
        except RunManifestError as e:
            report.issues.append(FsckIssue(
                "error", "corrupt-runmanifest", runs.key(seq), str(e)))
    latest = entries.get(seqs[-1])
    if latest is not None:
        _check_aligned_entry(ns, latest, versions, report, runs)
    _check_model_orphans(ns, entries, report)


def _check_aligned_entry(ns: Namespace, rm, versions: List[int],
                         report: FsckReport, runs) -> None:
    # -- model pointer intact -------------------------------------------------
    if rm.model_key:
        try:
            doc = msgpack.unpackb(ns.store.get(rm.model_key), raw=False)
        except (KeyError, NoSuchKey):
            report.issues.append(FsckIssue(
                "error", "missing-model-checkpoint", rm.model_key,
                f"RunManifest seq={rm.seq} binds a model checkpoint that is "
                f"absent from the store"))
            doc = None
        except Exception as e:
            report.issues.append(FsckIssue(
                "error", "torn-model-checkpoint", rm.model_key,
                f"cannot decode: {type(e).__name__}: {e}"))
            doc = None
        for e in (doc or {}).get("leaves", []):
            try:
                size = ns.store.head(e["key"])
            except (KeyError, NoSuchKey):
                report.issues.append(FsckIssue(
                    "error", "torn-model-checkpoint", e["key"],
                    f"leaf listed by {rm.model_key} is missing"))
                continue
            try:
                want = 1
                for dim in e["shape"]:
                    want *= dim
                want *= dtype_itemsize(e["dtype"])
            except Exception:
                continue  # dtype unknown here: existence is enough
            if size != want:
                report.issues.append(FsckIssue(
                    "error", "torn-model-checkpoint", e["key"],
                    f"leaf is {size} B, MANIFEST records "
                    f"{e['shape']}/{e['dtype']} = {want} B"))
    # -- data cursor restorable ----------------------------------------------
    try:
        ck = Checkpoint.decode(rm.data_token)
    except ValueError as e:
        report.issues.append(FsckIssue(
            "error", "runmanifest-bad-cursor", runs.key(rm.seq), str(e)))
        return
    if ck.composite:
        for name, v, s in ck.streams:
            sns = ns.stream(name)
            retained = _stream_retained_versions(ns, name)
            if v >= 0 and (not retained or v < retained[0]
                           or v > retained[-1]):
                have = (f"retained versions are "
                        f"v{retained[0]}..v{retained[-1]}" if retained
                        else "no manifest versions are retained")
                report.issues.append(FsckIssue(
                    "error", "runmanifest-unreadable-cursor",
                    sns.manifest_key(v),
                    f"aligned cursor of stream {name!r} needs manifest v{v} "
                    f"but {have}: the aligned checkpoint cannot restore"))
            trim = read_trim_marker(sns)
            if trim is not None and trim[0] > s:
                report.issues.append(FsckIssue(
                    "error", "trim-skew", sns.trim_key(),
                    f"stream {name!r} trim marker safe_step={trim[0]} passed "
                    f"the aligned checkpoint's stream step {s}"))
    else:
        if ck.version >= 0 and (not versions or ck.version < versions[0]
                                or ck.version > versions[-1]):
            have = (f"retained versions are v{versions[0]}..v{versions[-1]}"
                    if versions else "no manifest versions are retained")
            report.issues.append(FsckIssue(
                "error", "runmanifest-unreadable-cursor",
                ns.manifest_key(ck.version),
                f"aligned cursor needs manifest v{ck.version} but {have}: "
                f"the aligned checkpoint cannot restore"))
        trim = read_trim_marker(ns)
        if trim is not None and trim[0] > rm.aligned_data_step():
            report.issues.append(FsckIssue(
                "error", "trim-skew", ns.trim_key(),
                f"trim marker safe_step={trim[0]} passed the aligned "
                f"checkpoint's data step {rm.aligned_data_step()}: an "
                f"aligned restore would find its batches reclaimed"))


def _check_model_orphans(ns: Namespace, entries: Dict[int, object],
                         report: FsckReport) -> None:
    """Model uploads never named by any RunManifest entry: a trainer killed
    between upload and commit. Superseded ones (below the latest bound
    position) are safe to delete; newer ones may be a live trainer
    mid-commit.

    Directory steps and entry positions are compared in *materialized*
    units — the unit TrainSession names directories in, invariant across
    elastic resizes — so a resized trainer's in-flight upload is never
    misjudged against a pre-resize entry's logical step.
    """
    if not entries:
        return
    referenced = {rm.model_key for rm in entries.values() if rm.model_key}
    # steps at which SOME entry bound a (possibly retry-tagged) directory: an
    # unbound sibling dir at such a step lost its commit race — a later
    # incarnation re-checkpointed the same cadence step — and is superseded
    # just as surely as one below the latest bound position
    bound_steps = set()
    for mkey in referenced:
        s = checkpoint_dir_step(mkey.split("/")[-2])
        if s is not None:
            bound_steps.add(s)
    latest_bound = -1
    for rm in entries.values():
        try:
            latest_bound = max(latest_bound, rm.aligned_data_step())
        except ValueError:
            pass  # undecodable cursor is reported by _check_aligned_entry
    by_dir: Dict[str, List[str]] = {}
    for key in ns.store.list(ns.key("checkpoints")):
        by_dir.setdefault(key.rsplit("/", 1)[0], []).append(key)
    for dirkey, keys in sorted(by_dir.items()):
        mkey = f"{dirkey}/MANIFEST.ckpt"
        if mkey in referenced:
            continue
        step = checkpoint_dir_step(dirkey.rsplit("/", 1)[-1])
        superseded = step is not None and (
            (latest_bound >= 0 and step < latest_bound)
            or step in bound_steps)
        if superseded:
            report.orphans.extend(sorted(keys))
            report.issues.append(FsckIssue(
                "warn", "orphan-model-checkpoint", dirkey,
                f"model upload at data step {step} was never bound by a "
                f"RunManifest entry and is superseded by a bound checkpoint "
                f"at data step "
                f"{step if step in bound_steps else latest_bound} "
                f"(safe to delete)"))
        else:
            report.pending.extend(sorted(keys))
            report.issues.append(FsckIssue(
                "warn", "pending-model-checkpoint", dirkey,
                f"model upload not (yet) bound by any RunManifest entry — "
                f"either a live trainer mid-commit or a crashed one's "
                f"leftover (not touched)"))


def _check_derive(ns: Namespace, view: Optional[DatasetView],
                  report: FsckReport,
                  parent_ns: Optional[Namespace]) -> None:
    """Derived-stream audits (streams produced by ``repro.graph``):

      * **derive cursor chain** — contiguous, decodable, non-regressive
        (src_step and out_seq both monotone), and never ahead of the
        manifest (a cursor binding outputs the manifest does not commit is
        a torn derive commit — the worker commits the cursor last).
      * **provenance-dangling** — a derived TGB whose provenance names
        source TGB ids the source stream's manifest no longer resolves.
        Warn severity: a legitimately trimmed source looks the same as a
        lost one from storage alone, and the derived bytes remain valid.
      * **orphan reclassification** — uncommitted TGB objects that carry a
        provenance footer and sit at/above the committed derive cursor's
        ``out_seq`` were uploaded by a window whose cursor never committed.
        Unlike a live raw producer's pending set, the restarted worker
        regenerates them deterministically (content-addressed), so they are
        *safe* orphans and ``--repair`` deletes them.
    """
    from repro_torch.core.tgb import TGBReader
    from repro_torch.graph.cursor import DeriveCursorError, DeriveCursorStore

    cur_store = DeriveCursorStore(ns)
    seqs = cur_store.seqs()
    for prev, cur in zip(seqs, seqs[1:]):
        if cur != prev + 1:
            report.issues.append(FsckIssue(
                "error", "torn-derive-cursor-chain", cur_store.key(prev + 1),
                f"derive cursor sequence jumps {prev} -> {cur}"))
    cursors = {}
    for seq in seqs:
        try:
            cursors[seq] = cur_store.read(seq)
        except DeriveCursorError as e:
            report.issues.append(FsckIssue(
                "error", "corrupt-derive-cursor", cur_store.key(seq), str(e)))
    prev_dc = None
    for seq in sorted(cursors):
        dc = cursors[seq]
        if prev_dc is not None and (dc.src_step < prev_dc.src_step
                                    or dc.out_seq < prev_dc.out_seq):
            report.issues.append(FsckIssue(
                "error", "regressive-derive-cursor", cur_store.key(seq),
                f"cursor seq {seq} rolls progress back: src_step "
                f"{prev_dc.src_step} -> {dc.src_step}, out_seq "
                f"{prev_dc.out_seq} -> {dc.out_seq}"))
        prev_dc = dc
    latest = cursors.get(seqs[-1]) if seqs else None
    if latest is not None and view is not None:
        committed = max((ps.committed_offset
                         for ps in view.producers.values()), default=-1)
        if latest.out_seq > committed + 1:
            report.issues.append(FsckIssue(
                "error", "torn-derive-commit", cur_store.key(latest.seq),
                f"derive cursor binds outputs through out_seq "
                f"{latest.out_seq} but the manifest commits only through "
                f"offset {committed} — the cursor must always commit last"))
    # -- provenance-dangling ---------------------------------------------------
    if view is not None and parent_ns is not None:
        src_ids: Dict[str, Optional[set]] = {}
        for step, t in view.derived_tgbs():
            src_name = t.provenance.get("src_stream", "")
            if src_name not in src_ids:
                from repro_torch.core.manifest import open_manifest_store
                sns = parent_ns.stream(src_name)
                try:
                    sm = open_manifest_store(sns)
                    slatest = sm.latest_version()
                    sview = sm.load_view(slatest) if slatest >= 0 else None
                except Exception:
                    sview = None
                src_ids[src_name] = ({d.tgb_id for d in sview.tgbs}
                                     if sview is not None else None)
            ids = src_ids[src_name]
            missing = [i for i in t.provenance.get("src", [])
                       if ids is None or i not in ids]
            if missing:
                report.issues.append(FsckIssue(
                    "warn", "provenance-dangling", t.object_key,
                    f"derived TGB {t.tgb_id} (step {step}) cites source TGBs "
                    f"{missing} of stream {src_name!r} that its manifest no "
                    f"longer resolves (trimmed source, or lost lineage) — "
                    f"re-derivation from scratch is impossible"))
    # -- orphan reclassification -----------------------------------------------
    floor = latest.out_seq if latest is not None else 0
    for key in list(report.pending):
        parsed = _parse_tgb_key(ns, key)
        if parsed is None:
            continue
        _pid, offset = parsed
        try:
            footer = TGBReader(ns.store, key).footer()
        except Exception:
            continue  # unreadable pending object stays pending (not touched)
        if footer.provenance is None or offset < floor:
            continue
        report.pending.remove(key)
        report.orphans.append(key)
        report.issues[:] = [i for i in report.issues
                            if not (i.kind == "pending-tgb" and i.key == key)]
        report.issues.append(FsckIssue(
            "warn", "orphan-derived-tgb", key,
            f"derived output at offset {offset} has no committed derive "
            f"cursor (committed out_seq={floor}); a restarted worker "
            f"regenerates it content-addressed (safe to delete)"))


def fsck(ns: Namespace, repair: bool = False,
         recurse_streams: bool = True,
         parent_ns: Optional[Namespace] = None) -> FsckReport:
    """Audit one run namespace through the storage layer alone.

    ``repair=True`` deletes the *safely* orphaned objects (superseded
    duplicate TGBs below their producer's committed offset, derived outputs
    whose window never committed a derive cursor, and model uploads
    superseded by a later RunManifest entry) — never pending ones, never
    manifests. Returns the full :class:`FsckReport`.
    """
    report = FsckReport(namespace=ns.prefix)
    n_shards: Optional[int] = None
    try:
        n_shards = read_shard_config(ns)
    except Exception as e:
        report.issues.append(FsckIssue(
            "error", "corrupt-shard-config", ns.key("manifest", "shards.cfg"),
            f"cannot decode: {type(e).__name__}: {e}"))
    if n_shards is not None and n_shards > 1:
        view = _check_sharded(ns, n_shards, report)
        # downstream checks compare watermark / RunManifest cursor versions
        # against the retained range; on a sharded run versions are the
        # monotone merged scalar, for which any value up to the current head
        # is restorable (load_view treats the version as a floor)
        latest = view.version if view is not None else -1
        versions = list(range(0, latest + 1, max(1, latest))) if latest >= 0 \
            else []
    else:
        versions = _manifest_versions(ns)
        view = _check_chain(ns, versions, report)
    _check_tgbs(ns, view, report)
    _check_derive(ns, view, report, parent_ns)
    _check_trim_skew(ns, view, versions, report)
    _check_runmanifest(ns, versions, report)
    if repair and report.orphans:
        for key in list(report.orphans):
            ns.store.delete(key)
            report.repaired.append(key)
        report.orphans.clear()
    if recurse_streams:
        for name in list_streams(ns):
            report.streams[name] = fsck(ns.stream(name), repair=repair,
                                        recurse_streams=False, parent_ns=ns)
    return report
