"""Read-only run introspection (the ``batchweave inspect`` engine).

Builds a plain-dict summary of a run namespace straight from storage:
manifest chain shape, per-producer durable state, watermarks, the trim
marker, derivation state (derive cursors + per-TGB provenance on derived
streams), and (recursively) every stream of a multi-stream run. The dict is
stable and JSON-serializable so scripts can consume ``--json`` output.

Port of ``repro.ops.inspect``, copied as it is but for its imports.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.lifecycle import read_trim_marker, read_watermarks
from repro_torch.core.manifest import (MANIFEST_FORMAT_FLAT, ManifestStore,
                                 ShardedManifestStore, read_shard_config)
from repro_torch.core.objectstore import Namespace, NoSuchKey
from repro_torch.ops.fsck import _manifest_versions, list_streams

__all__ = ["inspect_run"]


def _inspect_runmanifest(ns: Namespace) -> Optional[Dict]:
    """Summary of the run's aligned-checkpoint chain (None when the run has
    no RunManifest — a bare data-plane namespace)."""
    from repro_torch.run.manifest import RunManifestError, RunManifestStore

    runs = RunManifestStore(ns)
    seqs = runs.seqs()
    if not seqs:
        return None
    out: Dict = {"entries": len(seqs), "oldest": seqs[0], "latest": seqs[-1]}
    try:
        rm = runs.read(seqs[-1])
        ck = rm.data_checkpoint()
        out["aligned"] = {
            "step": rm.step,
            "model_key": rm.model_key,
            "topology": list(rm.topology),
            "data_dp": rm.data_dp,
            "data_step": rm.aligned_data_step(),
            "cursor_version": ck.version,
            "streams": ({name: {"version": v, "step": s}
                         for name, v, s in ck.streams}
                        if ck.composite else None),
        }
    except ValueError as e:  # RunManifestError or a corrupt bound token:
        out["error"] = str(e)  # report it — fsck names the exact issue
    return out


def _inspect_derive(ns: Namespace, view) -> Optional[Dict]:
    """Derivation summary of one stream (None for raw streams): the derive
    cursor chain plus every derived TGB's provenance record."""
    from repro_torch.graph.cursor import DeriveCursorError, DeriveCursorStore

    cur_store = DeriveCursorStore(ns)
    seqs = cur_store.seqs()
    derived = view.derived_tgbs() if view is not None else []
    if not seqs and not derived:
        return None
    out: Dict = {"cursors": len(seqs)}
    if seqs:
        try:
            dc = cur_store.read(seqs[-1])
            out["cursor"] = {"seq": dc.seq, "src_step": dc.src_step,
                             "out_seq": dc.out_seq, "graph": dc.graph,
                             "op": dc.op, "worker": dc.worker_id}
        except DeriveCursorError as e:
            out["cursor_error"] = str(e)
    out["derived_tgbs"] = [
        {"step": step, "tgb_id": t.tgb_id,
         "src_stream": t.provenance.get("src_stream"),
         "src": list(t.provenance.get("src", [])),
         "op": t.provenance.get("op"),
         "params": t.provenance.get("params"),
         "graph": t.provenance.get("graph"),
         "out_index": t.provenance.get("k")}
        for step, t in derived
    ]
    return out


def inspect_run(ns: Namespace, recurse_streams: bool = True) -> Dict:
    """Summarize one run namespace from storage alone (no client state)."""
    store = ns.store
    versions = _manifest_versions(ns)
    out: Dict = {
        "namespace": ns.prefix,
        "manifests": {
            "retained": len(versions),
            "oldest": versions[0] if versions else None,
            "latest": versions[-1] if versions else None,
        },
        "producers": {},
        "watermarks": {},
        "trim": None,
        "tgb_objects": len(store.list(ns.key("tgb"))),
    }
    view = None
    try:
        n_shards = read_shard_config(ns)
    except Exception:
        n_shards = None
    if n_shards is not None and n_shards > 1:
        m = ShardedManifestStore(ns, n_shards)
        latest = m.latest_version()
        mv = m.load_view(latest) if latest >= 0 else None
        shard_rows = []
        for k, shard in enumerate(m.shards):
            head = shard.latest_version(hint=-1)
            sv = shard.load_view(head) if head >= 0 else None
            shard_rows.append({
                "shard": k,
                "head_version": head,
                "base_step": sv.base_step if sv is not None else 0,
                "live_entries": len(sv.tgbs) if sv is not None else 0,
                "producers": sorted(sv.producers) if sv is not None else [],
            })
        seg_seqs = m.segments.seqs()
        out["manifests"]["sharded"] = {
            "n_shards": n_shards,
            "merged_version": latest,
            "frontier": mv.frontier if mv is not None else -1,
            "shards": shard_rows,
            "segments": {
                "retained": len(seg_seqs),
                "oldest": seg_seqs[0] if seg_seqs else None,
                "latest": seg_seqs[-1] if seg_seqs else None,
                "folded_steps": (m.segments.read(seg_seqs[-1]).end_step
                                 if seg_seqs else 0),
            },
        }
        if mv is not None:
            view = mv
            out["view"] = {
                "version": mv.version,
                "base_step": mv.base_step,
                "total_steps": mv.total_steps,
                "live_tgbs": len(mv.tgbs),
                "live_bytes": sum(t.size_bytes for t in mv.tgbs),
            }
            out["producers"] = {
                pid: {"committed_offset": st.committed_offset,
                      "last_commit_version": st.last_commit_version,
                      "epoch": st.epoch}
                for pid, st in sorted(mv.producers.items())
            }
    elif versions:
        manifests = ManifestStore(ns)
        doc = manifests.read_doc(versions[-1])
        out["manifests"]["format"] = doc.get("format", MANIFEST_FORMAT_FLAT)
        try:
            out["manifests"]["bytes"] = store.head(
                ns.manifest_key(versions[-1]))
        except (KeyError, NoSuchKey):
            out["manifests"]["bytes"] = None
        view = manifests.load_view(versions[-1])
        out["view"] = {
            "version": view.version,
            "base_step": view.base_step,
            "total_steps": view.total_steps,
            "live_tgbs": len(view.tgbs),
            "live_bytes": sum(t.size_bytes for t in view.tgbs),
        }
        out["producers"] = {
            pid: {"committed_offset": st.committed_offset,
                  "last_commit_version": st.last_commit_version,
                  "epoch": st.epoch}
            for pid, st in sorted(view.producers.items())
        }
    for rank, wm in sorted(read_watermarks(ns).items()):
        out["watermarks"][str(rank)] = {"version": wm.version, "step": wm.step}
    trim = read_trim_marker(ns)
    if trim is not None:
        out["trim"] = {"safe_step": trim[0], "safe_version": trim[1]}
    derive = _inspect_derive(ns, view)
    if derive is not None:
        out["derive"] = derive
    out["runmanifest"] = _inspect_runmanifest(ns)
    if recurse_streams:
        streams = {name: inspect_run(ns.stream(name), recurse_streams=False)
                   for name in list_streams(ns)}
        if streams:
            out["streams"] = streams
    return out
