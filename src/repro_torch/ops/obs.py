"""Storage-native telemetry reads: the ``obs`` / ``top`` ops subcommands.

Everything here is computed from flight-recorder snapshots
(``<run>/obs/<component>/<seq>.snap``) plus the committed manifest chain —
no live process is consulted, so the same view works while a run is
executing and after every participant has exited (post-mortem).

Per component the summary carries the latest decoded snapshot, its age, and
**rates** derived by differencing the newest pair of snapshots from the same
incarnation (the ``inc`` token): a counter differenced across a process
restart would go negative, so rate math never crosses incarnations.

Family-specific derived fields:

  * ``producer.*``  — ingest throughput (bytes_committed/s), commit-conflict
    rate (conflicts / attempts), commit attempts/s;
  * ``consumer.*``  — read throughput (bytes_consumed/s), steps/s, retry
    count, and **ingestion lag**: the manifest frontier's total steps minus
    the steps this incarnation consumed (how far the reader trails what is
    already committed);
  * ``derive.*``    — windows completed, store-hit ratio;
  * ``store.*``     — resilience layer: hedge win rate (hedges_won /
    hedges_fired), breaker state rendered as closed/half-open/open, breaker
    opens, retry-budget exhaustions (brownout/outage diagnosis — see
    docs/OPERATIONS.md "Brownout and outage runbook").

Port of ``repro.ops.obs``, copied as it is but for its imports; the
snapshots it reads are byte-compatible across the two packages.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.manifest import open_manifest_store
from repro_torch.core.objectstore import Namespace
from repro_torch.obs.recorder import component_dirs, read_snapshots

__all__ = ["component_summary", "obs_summary", "render_obs", "render_top"]

#: snapshots read per component when computing rates (newest N)
RATE_WINDOW = 8


def _frontier(ns: Namespace) -> Optional[Dict[str, int]]:
    """The committed manifest frontier, or None before the first commit."""
    m = open_manifest_store(ns)
    v = m.latest_version()
    if v < 0:
        return None
    view = m.load_view(v)
    return {"version": v, "total_steps": view.total_steps}


def _fields(doc: Dict) -> Dict[str, object]:
    """Metric names with the ``<component>.`` prefix stripped."""
    comp = doc.get("component", "")
    pre = comp + "."
    out = {}
    for name, value in (doc.get("metrics") or {}).items():
        out[name[len(pre):] if name.startswith(pre) else name] = value
    return out


def _scalar(fields: Dict[str, object], key: str, default=0):
    v = fields.get(key, default)
    return v if isinstance(v, (int, float)) else default


def component_summary(ns: Namespace, component: str,
                      frontier: Optional[Dict[str, int]] = None) -> Dict:
    """One component's storage-side summary (see module docstring)."""
    snaps = read_snapshots(ns, component, last=RATE_WINDOW)
    if not snaps:
        return {"component": component, "snaps": 0}
    latest = snaps[-1]
    fields = _fields(latest)
    family = component.split(".", 1)[0]
    out: Dict[str, object] = {
        "component": component,
        "family": family,
        "snaps": len(snaps),
        "latest_seq": latest.get("seq"),
        "inc": latest.get("inc"),
        "wall": latest.get("wall"),
        "metrics": fields,
    }
    # rate math: newest earlier snapshot from the SAME incarnation
    prev = next((s for s in reversed(snaps[:-1])
                 if s.get("inc") == latest.get("inc")), None)
    rates: Dict[str, float] = {}
    if prev is not None:
        dt = float(latest.get("t", 0)) - float(prev.get("t", 0))
        if dt > 0:
            pf = _fields(prev)
            for key in fields:
                a, b = fields.get(key), pf.get(key)
                if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                    rates[key + "_per_s"] = (a - b) / dt
    out["rates"] = rates
    # family-specific derived fields
    if family == "producer":
        attempts = _scalar(fields, "commit_attempts")
        out["conflict_rate"] = \
            _scalar(fields, "commit_conflicts") / max(1, attempts)
        out["throughput_Bps"] = rates.get("bytes_committed_per_s")
    elif family == "consumer":
        out["throughput_Bps"] = rates.get("bytes_consumed_per_s")
        out["steps_per_s"] = rates.get("steps_consumed_per_s")
        if frontier is not None:
            out["lag_steps"] = max(
                0, frontier["total_steps"] - _scalar(fields,
                                                     "steps_consumed"))
    elif family == "derive":
        derived = _scalar(fields, "tgbs_derived")
        out["store_hit_ratio"] = \
            _scalar(fields, "store_hits") / max(1, derived)
    elif family == "store":
        fired = _scalar(fields, "hedges_fired")
        out["hedge_win_rate"] = _scalar(fields, "hedges_won") / max(1, fired)
        out["breaker"] = {0: "closed", 1: "half-open", 2: "open"}.get(
            int(_scalar(fields, "breaker_state")), "?")
        out["throttled_per_s"] = rates.get("throttled_per_s")
    return out


def obs_summary(ns: Namespace, now: Optional[float] = None,
                recurse: bool = True) -> Dict:
    """The full storage-side telemetry view of one run namespace."""
    import time
    from repro_torch.ops.fsck import list_streams

    now = time.time() if now is None else now
    frontier = _frontier(ns)
    components = []
    for comp in component_dirs(ns):
        row = component_summary(ns, comp, frontier=frontier)
        if row.get("wall") is not None:
            row["age_s"] = max(0.0, now - float(row["wall"]))
        components.append(row)
    out = {"namespace": ns.prefix, "frontier": frontier,
           "components": components}
    if recurse:
        streams = {}
        for name in list_streams(ns):
            streams[name] = obs_summary(ns.stream(name), now=now,
                                        recurse=False)
        if streams:
            out["streams"] = streams
    return out


# -- plain-text rendering ---------------------------------------------------

def _fmt_bytes(v) -> str:
    if v is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB"):
        if abs(v) < 1024 or unit == "GB":
            return f"{v:.1f}{unit}"
        v /= 1024.0
    return f"{v:.1f}GB"


def _fmt(v, spec="{:.2f}") -> str:
    return "-" if v is None else spec.format(v)


def render_top(summary: Dict, out, indent: str = "") -> None:
    """Compact one-row-per-component table (the ``top`` subcommand)."""
    fr = summary.get("frontier")
    frontier_txt = (f"frontier v{fr['version']} total_steps="
                    f"{fr['total_steps']}" if fr else "no manifests yet")
    print(f"{indent}{summary['namespace']}: {frontier_txt}", file=out)
    rows = summary.get("components", [])
    if not rows:
        print(f"{indent}  (no telemetry snapshots published)", file=out)
    else:
        hdr = (f"{'COMPONENT':28} {'AGE':>7} {'THROUGHPUT/s':>13} "
               f"{'STEPS/s':>8} {'LAG':>6} {'CONFLICT':>9} {'RETRY':>6}")
        print(indent + "  " + hdr, file=out)
        for row in rows:
            if row.get("snaps", 0) == 0:
                continue
            m = row.get("metrics", {})
            print(indent + "  " + (
                f"{row['component']:28} "
                f"{_fmt(row.get('age_s'), '{:.1f}s'):>7} "
                f"{_fmt_bytes(row.get('throughput_Bps')):>13} "
                f"{_fmt(row.get('steps_per_s'), '{:.2f}'):>8} "
                f"{_fmt(row.get('lag_steps'), '{:.0f}'):>6} "
                f"{_fmt(row.get('conflict_rate'), '{:.1%}'):>9} "
                f"{_scalar(m, 'read_retries', 0):>6}"), file=out)
    for name, sub in sorted(summary.get("streams", {}).items()):
        print(f"{indent}stream {name!r}:", file=out)
        render_top(sub, out, indent=indent + "  ")


def render_obs(summary: Dict, out, indent: str = "") -> None:
    """Full per-component metric dump (the ``obs`` subcommand)."""
    fr = summary.get("frontier")
    frontier_txt = (f"frontier v{fr['version']} total_steps="
                    f"{fr['total_steps']}" if fr else "no manifests yet")
    print(f"{indent}{summary['namespace']}: {frontier_txt}", file=out)
    for row in summary.get("components", []):
        if row.get("snaps", 0) == 0:
            print(f"{indent}  {row['component']}: no readable snapshots",
                  file=out)
            continue
        age = _fmt(row.get("age_s"), "{:.1f}s")
        print(f"{indent}  {row['component']} (seq {row['latest_seq']}, "
              f"inc {row['inc']}, {row['snaps']} snaps, age {age}):",
              file=out)
        for key, value in sorted(row.get("metrics", {}).items()):
            if isinstance(value, dict):  # histogram summary
                parts = ", ".join(f"{k}={_fmt(v)}" if isinstance(v, float)
                                  else f"{k}={v}"
                                  for k, v in sorted(value.items()))
                print(f"{indent}    {key}: {parts}", file=out)
            else:
                print(f"{indent}    {key}: {value}", file=out)
        for key, value in sorted(row.get("rates", {}).items()):
            print(f"{indent}    rate {key}: {value:.3f}", file=out)
    for name, sub in sorted(summary.get("streams", {}).items()):
        print(f"{indent}stream {name!r}:", file=out)
        render_obs(sub, out, indent=indent + "  ")
