"""``batchweave`` — the operator CLI (``python -m repro_torch.ops``).

Three storage-native subcommands, per the paper's recovery design (every
piece of operational truth lives in the object store, so an operator tool
needs nothing but the namespace):

  * ``inspect`` — manifest chain, per-producer durable state, watermarks,
    trim marker, per-TGB derivation provenance; recurses into streams.
  * ``fsck``    — detect orphaned TGBs, torn commits / torn delta-manifest
    chains, trim-vs-checkpoint skew, torn derive-cursor chains, and
    provenance-dangling derived TGBs. ``--repair`` deletes safe orphans
    (including derived outputs with no committed derive cursor).
  * ``trim``    — run one watermark-driven reclamation cycle (logical trim
    marker + optional physical deletion), exactly what the background
    reclaimer does.
  * ``obs``     — dump every component's latest flight-recorder snapshot
    (full metric catalog + same-incarnation rates).
  * ``top``     — one row per component: throughput, steps/s, ingestion
    lag, commit-conflict rate — rendered purely from storage snapshots,
    so it works on live runs and post-mortem alike.

Exit codes: 0 = ok/clean, 1 = fsck found problems, 2 = usage error.

Port of ``repro.ops.cli``, copied as it is but for its imports and the
program name in its help.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.core.lifecycle import Reclaimer
from repro_torch.core.objectstore import (FileObjectStore, Namespace,
                                          ObjectStore)
from repro_torch.ops.fsck import FsckReport, fsck, list_streams
from repro_torch.ops.inspect import inspect_run

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.ops",
        description="BatchWeave ops: inspect / fsck / trim a run namespace "
                    "purely through the storage layer.")
    ap.add_argument("--root", required=True,
                    help="filesystem object-store root (FileObjectStore dir)")
    ap.add_argument("--namespace", "-n", default="runs/dataplane",
                    help="run namespace prefix (default: runs/dataplane)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("inspect", help="summarize manifest chain, producer "
                                   "state, watermarks, trim marker")

    fs = sub.add_parser("fsck", help="detect orphans, torn commits, torn "
                                     "manifest chains, trim skew")
    fs.add_argument("--repair", action="store_true",
                    help="delete safely-orphaned TGB objects")

    tr = sub.add_parser("trim", help="run one reclamation cycle")
    tr.add_argument("--ranks", type=int, default=None,
                    help="expected checkpointing ranks (default: however "
                         "many watermarks exist)")
    tr.add_argument("--logical-only", action="store_true",
                    help="only advance the trim marker; no deletion")

    sub.add_parser("obs", help="dump flight-recorder snapshots (full metric "
                               "catalog per component)")
    sub.add_parser("top", help="per-component throughput / lag / conflict "
                               "table from storage snapshots")
    return ap


def _print_fsck(report: FsckReport, as_json: bool, out) -> None:
    if as_json:
        def enc(r: FsckReport) -> dict:
            return {
                "namespace": r.namespace, "clean": r.clean,
                "checked_manifests": r.checked_manifests,
                "checked_tgbs": r.checked_tgbs,
                "orphans": r.orphans, "pending": r.pending,
                "repaired": r.repaired,
                "issues": [vars(i) for i in r.issues],
                "streams": {k: enc(v) for k, v in r.streams.items()},
            }
        json.dump(enc(report), out, indent=2)
        out.write("\n")
        return
    print(report.summary(), file=out)
    for issue in report.issues:
        print(f"  {issue}", file=out)
    for key in report.repaired:
        print(f"  [repaired] deleted {key}", file=out)
    for name, sr in sorted(report.streams.items()):
        print(f"stream {name!r}: {sr.summary()}", file=out)
        for issue in sr.issues:
            print(f"  {issue}", file=out)
        for key in sr.repaired:
            print(f"  [repaired] deleted {key}", file=out)


def _run_trim(ns: Namespace, ranks: Optional[int], logical_only: bool,
              as_json: bool, out) -> None:
    targets = [("", ns)] + [(name, ns.stream(name))
                            for name in list_streams(ns)]
    rows = []
    for name, tns in targets:
        r = Reclaimer(tns, expected_ranks=ranks,
                      physical_delete=not logical_only)
        wg = r.run_cycle()
        rows.append({
            "stream": name or None,
            "advanced": wg is not None,
            "safe_step": wg.step if wg else None,
            "safe_version": wg.version if wg else None,
            "tgbs_deleted": r.stats.tgbs_deleted,
            "manifests_deleted": r.stats.manifests_deleted,
            "bytes_reclaimed": r.stats.bytes_reclaimed,
        })
    if as_json:
        json.dump(rows, out, indent=2)
        out.write("\n")
        return
    for row in rows:
        label = f"stream {row['stream']!r}" if row["stream"] else ns.prefix
        if not row["advanced"]:
            print(f"trim {label}: no global watermark yet (nothing trimmed)",
                  file=out)
        else:
            print(f"trim {label}: safe_step={row['safe_step']} "
                  f"safe_version={row['safe_version']} "
                  f"deleted {row['tgbs_deleted']} tgbs / "
                  f"{row['manifests_deleted']} manifests "
                  f"({row['bytes_reclaimed']} B)", file=out)


def main(argv: Optional[List[str]] = None, store: Optional[ObjectStore] = None,
         out=None) -> int:
    """CLI entry point. ``store``/``out`` are injectable for tests."""
    out = out or sys.stdout
    parser = build_parser()
    args = parser.parse_args(argv)
    if store is None:
        import os
        if not os.path.isdir(args.root):
            # never create the store as a side effect of an audit — a typo'd
            # --root must fail loudly, not report a fresh empty run as clean
            parser.error(f"--root {args.root!r} does not exist")
        store = FileObjectStore(args.root)
    ns = Namespace(store, args.namespace)
    if args.cmd == "inspect":
        info = inspect_run(ns)
        if args.as_json:
            json.dump(info, out, indent=2)
            out.write("\n")
        else:
            _print_inspect(info, out)
        return 0
    if args.cmd == "fsck":
        report = fsck(ns, repair=args.repair)
        _print_fsck(report, args.as_json, out)
        # like fsck(8): nonzero if problems were found, even when --repair
        # just corrected them — scripts learn the namespace *was* dirty
        repaired = bool(report.repaired) or \
            any(r.repaired for r in report.streams.values())
        return 0 if report.clean and not repaired else 1
    if args.cmd == "trim":
        _run_trim(ns, args.ranks, args.logical_only, args.as_json, out)
        return 0
    if args.cmd in ("obs", "top"):
        from repro_torch.ops.obs import obs_summary, render_obs, render_top
        summary = obs_summary(ns)
        if args.as_json:
            json.dump(summary, out, indent=2)
            out.write("\n")
        elif args.cmd == "top":
            render_top(summary, out)
        else:
            render_obs(summary, out)
        return 0
    return 2  # unreachable: argparse enforces the subcommand


def _print_inspect(info: dict, out, indent: str = "") -> None:
    m = info["manifests"]
    print(f"{indent}namespace {info['namespace']}", file=out)
    if m["latest"] is None:
        print(f"{indent}  no manifests committed yet "
              f"({info['tgb_objects']} tgb objects)", file=out)
    else:
        print(f"{indent}  manifests: v{m['oldest']}..v{m['latest']} retained "
              f"({m['retained']}), format={m.get('format')}, "
              f"latest={m.get('bytes')} B", file=out)
        v = info["view"]
        print(f"{indent}  view: base_step={v['base_step']} "
              f"total_steps={v['total_steps']} live_tgbs={v['live_tgbs']} "
              f"({v['live_bytes']} B); {info['tgb_objects']} tgb objects on "
              f"store", file=out)
        for pid, st in info["producers"].items():
            print(f"{indent}  producer {pid}: "
                  f"committed_offset={st['committed_offset']} "
                  f"last_commit=v{st['last_commit_version']} "
                  f"epoch={st['epoch']}", file=out)
    for rank, wm in info["watermarks"].items():
        print(f"{indent}  watermark rank{rank}: v{wm['version']} "
              f"step={wm['step']}", file=out)
    if info["trim"]:
        print(f"{indent}  trim marker: safe_step={info['trim']['safe_step']} "
              f"safe_version={info['trim']['safe_version']}", file=out)
    dv = info.get("derive")
    if dv:
        cur = dv.get("cursor")
        if cur:
            print(f"{indent}  derive cursor: seq={cur['seq']} "
                  f"src_step={cur['src_step']} out_seq={cur['out_seq']} "
                  f"op={cur['op']} graph={cur['graph'][:12]}…", file=out)
        elif dv.get("cursor_error"):
            print(f"{indent}  derive cursor: UNREADABLE "
                  f"({dv['cursor_error']})", file=out)
        for t in dv.get("derived_tgbs", []):
            print(f"{indent}  derived step {t['step']} ({t['tgb_id']}): "
                  f"{t['op']} over {t['src_stream']!r}"
                  f"[{', '.join(t['src'])}] k={t['out_index']} "
                  f"params={t['params'][:12]}…", file=out)
    rm = info.get("runmanifest")
    if rm:
        if "error" in rm:
            print(f"{indent}  runmanifest: {rm['entries']} entries, latest "
                  f"seq {rm['latest']} UNREADABLE ({rm['error']})", file=out)
        else:
            a = rm["aligned"]
            print(f"{indent}  runmanifest: {rm['entries']} entries; aligned "
                  f"@ step {a['step']} (dp={a['topology'][0]} "
                  f"cp={a['topology'][1]}, data_dp={a['data_dp']}, "
                  f"data_step={a['data_step']}) model={a['model_key']}",
                  file=out)
            for sname, cur in (a["streams"] or {}).items():
                print(f"{indent}    stream {sname!r} cursor: "
                      f"v{cur['version']} step={cur['step']}", file=out)
    for name, sub in sorted(info.get("streams", {}).items()):
        print(f"{indent}  stream {name!r}:", file=out)
        _print_inspect(sub, out, indent=indent + "  ")
