"""Roofline analysis over the port's dry-run records, with the constants of
one NVIDIA H100 (port of ``repro.launch.roofline``).

Per (arch x shape x mesh) cell, from the dry run's per-device costs
(``launch/dryrun.py``, ``launch/hlo_analysis.py``):

    compute term    = FLOPs_per_device / PEAK_FLOPS         [bf16 dense]
    memory term     = bytes_per_device / HBM_BW
    collective term = collective_link_bytes_per_device / LINK_BW

``LINK_BW`` is the network's, not NVLink's: a host holds 8 H100s, so the
"model" axis of 16 spans two hosts and the "data" axis 16 (or 32) hosts,
and every ring of either crosses InfiniBand, one 400 Gb/s NDR port a GPU
(50 GB/s each way). NVLink's 450 GB/s each way (``NVLINK_BW``) would bound
only groups inside one host.

MODEL_FLOPS = 6*N*D (train) or 2*N*D (serving), N = parameters (active
parameters for MoE), D = tokens per step (decode: global_batch, one new
token each); ideal step = MODEL_FLOPS / (chips x PEAK_FLOPS).

These rows are projections for a mesh of H100s from a dry run, not
measurements: no mesh of 256 cards ran them.

The fused loop (``train/pipeline.py``) divides measured compute by
``ideal_step_s`` to place each run on the roofline.

Deviations from the reference:

  * the constants are the H100 SXM5 data sheet's (dense, no sparsity, at the
    card's 700 W limit) and InfiniBand's, not the TPU's;
  * ``chips(rec)`` multiplies the mesh's dims (``"2x16x16"`` -> 512) where
    the reference knows only its two dry-run meshes (512 or else 256); both
    agree on those.

Usage:
    python -m repro_torch.launch.roofline --dir experiments/dryrun_torch [--csv out.csv]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["HBM_BW", "HBM_PER_CHIP", "LINK_BW", "NVLINK_BW", "PEAK_FLOPS",
           "RooflineRow", "analyze_record", "chips", "format_table",
           "ideal_step_s", "load_rows", "main", "model_flops",
           "tokens_per_step"]

#: NVIDIA H100 SXM5: dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
#: NVIDIA H100 SXM5: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVIDIA H100 SXM5: NVLink 4 bytes/s in one direction (900 GB/s both ways)
NVLINK_BW = 450e9
#: one 400 Gb/s InfiniBand NDR port a GPU, bytes/s in one direction
LINK_BW = 50e9
#: NVIDIA H100 80GB: device memory a card
HBM_PER_CHIP = 80 * 2**30


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    hlo_flops_total: float = 0.0
    useful_ratio: float = 0.0
    step_time_s: float = 0.0
    mfu: float = 0.0
    peak_mem_gib: float = 0.0
    reason: str = ""


def tokens_per_step(rec: dict) -> int:
    if rec["kind"] == "decode":
        return rec["global_batch"]          # one new token per sequence
    return rec["global_batch"] * rec["seq_len"]


def model_flops(rec: dict) -> float:
    n = rec["active_params"] if rec["family"] == "moe" else rec["params"]
    d = tokens_per_step(rec)
    factor = 6.0 if rec["kind"] == "train" else 2.0  # fwd-only for serving
    return factor * n * d


def chips(rec: dict) -> int:
    return math.prod(int(n) for n in rec["mesh"].split("x"))


def ideal_step_s(n_params: float, tokens: int, kind: str = "train",
                 n_chips: int = 1, peak_flops: float = PEAK_FLOPS) -> float:
    """Roofline-ideal step seconds: MODEL_FLOPS / aggregate peak."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params * tokens / (n_chips * peak_flops)


def analyze_record(rec: dict) -> RooflineRow:
    row = RooflineRow(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                      status=rec["status"], reason=rec.get("reason", ""))
    if rec["status"] != "ok":
        return row
    h = rec["hlo"]
    row.compute_s = h["flops"] / PEAK_FLOPS
    row.memory_s = h["bytes_accessed"] / HBM_BW
    row.collective_s = h["total_collective_bytes"] / LINK_BW
    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s}
    row.dominant = max(terms, key=terms.get)
    row.model_flops = model_flops(rec)
    row.hlo_flops_total = h["flops"] * chips(rec)
    row.useful_ratio = row.model_flops / max(1.0, row.hlo_flops_total)
    # roofline step time: max of the three overlapped terms (optimistic)
    row.step_time_s = max(row.compute_s, row.memory_s, row.collective_s)
    ideal = row.model_flops / (chips(rec) * PEAK_FLOPS)
    row.mfu = ideal / row.step_time_s if row.step_time_s > 0 else 0.0
    row.peak_mem_gib = rec["memory"]["peak_per_device_bytes"] / 2**30
    return row


def load_rows(dirpath: str, tag: Optional[str] = None) -> List[RooflineRow]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        if tag and not path.endswith(f"__{tag}.json"):
            continue
        with open(path) as f:
            rec = json.load(f)
        rows.append(analyze_record(rec))
    return rows


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':8s} {'status':8s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} "
           f"{'dominant':>10s} {'useful':>7s} {'MFU':>6s} {'mem GiB':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.status != "ok":
            lines.append(f"{r.arch:22s} {r.shape:12s} {r.mesh:8s} {r.status:8s}"
                         f"  -- {r.reason[:70]}")
            continue
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:8s} {r.status:8s} "
            f"{r.compute_s:10.4f} {r.memory_s:10.4f} {r.collective_s:10.4f} "
            f"{r.dominant:>10s} {r.useful_ratio:7.3f} {r.mfu:6.3f} "
            f"{r.peak_mem_gib:8.2f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = load_rows(args.dir, tag=args.tag)
    print(format_table(rows))
    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["arch", "shape", "mesh", "status", "compute_s",
                        "memory_s", "collective_s", "dominant", "model_flops",
                        "hlo_flops_total", "useful_ratio", "step_time_s",
                        "mfu", "peak_mem_gib", "reason"])
            for r in rows:
                w.writerow([r.arch, r.shape, r.mesh, r.status, r.compute_s,
                            r.memory_s, r.collective_s, r.dominant,
                            r.model_flops, r.hlo_flops_total, r.useful_ratio,
                            r.step_time_s, r.mfu, r.peak_mem_gib, r.reason])


if __name__ == "__main__":
    main()
