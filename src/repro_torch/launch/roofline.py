"""Roofline ideal of a step on one NVIDIA H100 (port of
``repro.launch.roofline``, the part the fused loop needs).

    MODEL_FLOPS = 6*N*D (train) or 2*N*D (serving), N = parameters (active
    parameters for MoE), D = tokens per step (decode: global_batch, one new
    token each); ideal step = MODEL_FLOPS / (chips x PEAK_FLOPS).

The fused loop (``train/pipeline.py``) divides measured compute by
``ideal_step_s`` to place each run on the roofline: compute drifting away
from the ideal is a kernel or model regression, while data wait growing
under flat compute-vs-roofline indicts the data plane.

Deviations from the reference:

  * the constants are the H100 SXM5 data sheet's (dense, no sparsity, at the
    card's 700 W limit), not the TPU's;
  * ``chips(rec)`` multiplies the mesh's dims (``"2x16x16"`` -> 512) where
    the reference knows only its two dry-run meshes (512 or else 256); both
    agree on those;
  * ``analyze_record``, ``load_rows`` and the CLI read dry-run HLO records,
    which the port has none of yet: they raise ``UnsupportedOperation``
    (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import math

from repro_torch.dataplane.types import UnsupportedOperation

__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "analyze_record", "chips",
           "ideal_step_s", "load_rows", "model_flops", "tokens_per_step"]

#: NVIDIA H100 SXM5: dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
#: NVIDIA H100 SXM5: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVIDIA H100 SXM5: NVLink 4 bytes/s in one direction (900 GB/s both ways)
NVLINK_BW = 450e9


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


def _dry_run_refused(name: str):
    raise UnsupportedOperation(
        f"roofline.{name} reads dry-run HLO records, which the port has none "
        f"of yet: ROADMAP Queue 1, item 11")


def analyze_record(rec: dict):
    _dry_run_refused("analyze_record")


def load_rows(dirpath: str, tag=None):
    _dry_run_refused("load_rows")


def main():
    _dry_run_refused("main")


if __name__ == "__main__":
    main()
