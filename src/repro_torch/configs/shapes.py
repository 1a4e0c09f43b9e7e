"""Assigned input-shape set (port of ``repro.configs.shapes``, a copy),
identical across the 10 LM-family architectures.

  train_4k     seq_len=4,096   global_batch=256   -> train_step
  prefill_32k  seq_len=32,768  global_batch=32    -> prefill_step
  decode_32k   seq_len=32,768  global_batch=128   -> serve_step (1 new token,
                                                    state/KV cache of seq_len)
  long_500k    seq_len=524,288 global_batch=1     -> serve_step; sub-quadratic
                                                    archs only (SSM/hybrid)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(shape: InputShape, cfg) -> Tuple[bool, str]:
    """(runnable, reason). long_500k is skipped for pure full-attention archs
    per the assignment (noted in DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention architecture: 512k-context decode "
                       "requires sub-quadratic attention (skip per assignment; "
                       "see DESIGN.md §4)")
    return True, ""
