#!/usr/bin/env python3
"""Does the program's tracer change how often the benchmark's traced slices
lose their marker kernels? The harness's two profiler slices
(``weavebench/wb/trace.TracedSlice``: 6 steps, then 3 with operator shapes)
over ``granite-8b-l8`` cut in depth, trained through ``FusedTrainLoop`` on
random tokens, round after round in one process.

    python3 tools/slice_drops.py [--rounds 24] [--layers 4]

Rounds alternate the program's tracer in the first slice: off in even
rounds, on in odd ones (the harness turns it on there), so both arms meet
the same process age. Prints one JSON line a round: seconds since start,
the arm, the spin kernels each slice's trace holds (``MARKERS`` + 1 when
none is lost; 0 is the harness's "the trace holds none of the 256 marker
kernels") and the spans the tracer recorded. Needs one NVIDIA card; builds
K1 and K2 from this checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / "build" / "cache" / sub)
sys.path[:0] = [str(ROOT / "weavebench"), str(ROOT / "src")]


class _RandomTokens:
    """A token source of random (4, 1024) grids (nothing to restore)."""

    topology = None

    def __init__(self, vocab):
        import numpy as np
        self.vocab, self.rng = vocab, np.random.default_rng(0)

    def next_tokens(self, timeout_s=None):
        return self.rng.integers(0, self.vocab, (4, 1024), dtype="int32")

    def cursors(self):
        return None

    def restore(self, cursors):
        raise NotImplementedError

    def start_prefetch(self):
        pass

    def stop_prefetch(self):
        pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("slice_drops: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.models import ModelConfig, init_params, param_specs
    from repro_torch.obs.tracer import TRACER
    from repro_torch.train import (OptimizerConfig, StepConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.pipeline import FusedTrainLoop
    from wb.trace import TracedSlice

    bench = ROOT / "weavebench"
    m = json.loads((bench / "configs/granite-8b-l8.json").read_text())["model"]
    m["num_layers"] = args.layers
    cfg = ModelConfig(**m)
    opt_d = json.loads((bench / "traffic/pretrain-s1k.json").read_text())["optimizer"]
    params = init_params(param_specs(cfg), seed=0, device="cuda")
    opt = init_opt_state(params, opt_d.pop("state_dtype"))
    step = make_train_step(cfg, OptimizerConfig(**opt_d), StepConfig())

    def spins(s):
        return sum(e.get("cat") == "kernel" and "spin_kernel" in e.get("name", "")
                   for e in s.events())

    with FusedTrainLoop(_RandomTokens(cfg.vocab_size), step, params, opt, depth=2,
                        timeout_s=60.0) as loop:
        loop.run(3)
        for r in range(args.rounds):
            arm = "on" if r % 2 else "off"
            loop.run(5)
            TRACER.clear()
            if arm == "on":
                TRACER.enable()
            with TracedSlice(torch) as first:
                loop.run(6)
            TRACER.disable()
            with TracedSlice(torch, ops=True) as second:
                loop.run(3)
            print(json.dumps({"t": round(time.perf_counter() - T0, 1), "round": r,
                              "arm": arm, "first": spins(first), "second": spins(second),
                              "spans": len(TRACER.spans())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
