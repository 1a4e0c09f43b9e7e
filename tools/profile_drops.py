#!/usr/bin/env python3
"""Which device events does torch.profiler drop? rwkv6-3b's prefill at
``chip_smoke.py``'s serving shape (8 prompts of 1000 tokens), profiled as
phase 18 (b)'s card check profiles it, in one process over several minutes
with bf16 matmuls on the card between the profiles.

    python3 tools/profile_drops.py [--minutes 7]

Each round profiles the prefill three ways, in turns: ``bare`` (the
prefill alone), ``pause`` (a ~20 ms spin of the card and a 50 ms sleep of
the host first) and ``markers`` (``chip_smoke.open_trace``: TRACER_MARKERS
spin kernels first, waited for). Prints one JSON line a profile: seconds
since the first, the arm, the device events seen, the K2 and K4 launches
the profile names beside the wrappers' counts, and the spin kernels seen.
A drop by time spares the prefill after the pause; a drop of the first
events by count takes the spin and the prefill's first launches all the
same. Needs one NVIDIA card; builds K2 and K4 from this checkout.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--minutes", type=float, default=7.0,
                    help="keep profiling rounds until this long after the first")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_drops: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import common as kcommon
    from repro_torch.models import init_decode_state, prefill

    kcommon.build(("rmsnorm", "wkv6"), force=True)
    cfg = get_config("rwkv6_3b")
    params = cs.serving_weights(torch, cfg)
    tokens = cs.token_grid(torch, cfg, np.random.default_rng(cs.SEED), cs.BATCH, cs.PROMPT)
    print(cs.nvidia_smi_line(), flush=True)

    def pause():
        torch.cuda._sleep(40_000_000)
        torch.cuda.synchronize()
        time.sleep(0.05)

    firsts = {"bare": lambda: None, "pause": pause, "markers": lambda: cs.open_trace(torch)}

    def one(arm, fn, since):
        kcommon.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            firsts[arm]()
            fn()
            torch.cuda.synchronize()
        dev = [e.name for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        print(json.dumps({
            "s": round(since, 1), "arm": arm, "device_events": len(dev),
            "profiled": {k: sum(cs.KERNEL_SYMBOLS[k] in n for n in dev)
                         for k in ("rmsnorm", "wkv6")},
            "launches": {k: kcommon.launches[k] for k in ("rmsnorm", "wkv6")},
            "spins": sum("spin_kernel" in n for n in dev)}), flush=True)

    with torch.inference_mode():
        state = init_decode_state(cfg, cs.BATCH, cs.MAX_SEQ, device="cuda")

        def fn():
            prefill(cfg, params, {"tokens": tokens}, cache=state)

        fn()  # warm-up
        a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
        t_start = time.monotonic()
        arms = list(firsts)
        while True:
            since = time.monotonic() - t_start
            for arm in arms:
                one(arm, fn, since)
            arms = arms[1:] + arms[:1]
            if since > args.minutes * 60 - 60:
                return 0
            t1 = time.monotonic()
            while time.monotonic() - t1 < 45:
                for _ in range(20):
                    a = (a @ a).clamp_(-1, 1)
                torch.cuda.synchronize()


if __name__ == "__main__":
    sys.exit(main())
