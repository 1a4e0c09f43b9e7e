#!/usr/bin/env python3
"""Decode ms a step of the port's serving paths on one NVIDIA card, for one
tree of the repository, with ``chip_smoke.py``'s settings (phase 4:
granite-8b through ``ServeEngine``; 5: rwkv6-3b; 14: deepseek-moe-16b; 15:
zamba2-7b; 16: musicgen-medium after its 128-frame prefix; 8 prompts of
1000 tokens, 31 decode steps after a warm-up batch).

    python3 tools/decode_overhead.py --tree DIR [--models granite_8b,rwkv6_3b]
    python3 tools/decode_overhead.py --dispatch

Imports ``chip_smoke`` and ``repro_torch`` from ``DIR`` (a checkout of any
commit since the serving phases exist), builds that tree's kernels, serves
each model and prints, per model, one JSON line: the tree, the model, the
decode ms a step and tokens/s as chip_smoke reports them, the card and its
``nvidia-smi`` name and power limit. Two trees are compared inside one call
on one card, in turns (parent, change, change, parent), each run a process
of its own; a time from two calls is not comparable.

``--dispatch`` times the host's cost of one call of an operator that only
allocates its output, three ways: a Python function, a ``torch.library``
operator defined through ``Library.define`` / ``impl`` (the port's route)
and one through ``torch.library.custom_op``; microseconds a call, on CPU
and on CUDA tensors of a decode step's RMSNorm input (8, 4096).
"""
import argparse
import contextlib
import io
import json
import re
import sys
from pathlib import Path

MODELS = ("granite_8b", "rwkv6_3b", "deepseek_moe_16b", "zamba2_7b",
          "musicgen_medium")


def dispatch_routes(torch) -> dict:
    """An operator that only allocates its output, by route: a Python
    function, ``Library.define`` / ``impl``, ``custom_op``."""
    from torch import Tensor

    lib = torch.library.Library("decode_overhead", "FRAGMENT")
    lib.define("lib_op(Tensor x, Tensor s, float eps) -> Tensor")
    for key in ("CPU", "CUDA"):
        lib.impl("lib_op", lambda x, s, eps: torch.empty_like(x), key)

    @torch.library.custom_op("decode_overhead::custom", mutates_args=())
    def custom(x: Tensor, s: Tensor, eps: float) -> Tensor:
        return torch.empty_like(x)

    return {"python": lambda x, s, eps: torch.empty_like(x),
            "library": torch.ops.decode_overhead.lib_op.default,
            "custom_op": custom, "_keep": lib}


def dispatch_us(torch, routes: dict, device: str, n: int = 20000) -> dict:
    """Host microseconds a call, by route, on ``device``'s tensors."""
    import time

    x = torch.ones(8, 4096, device=device, dtype=torch.bfloat16)
    w = torch.ones(4096, device=device)
    out = {}
    for name, fn in routes.items():
        if name.startswith("_"):
            continue
        for _ in range(1000):
            fn(x, w, 1e-5)
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x, w, 1e-5)
        out[name] = (time.perf_counter() - t0) / n * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="root of a repository tree")
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--dispatch", action="store_true",
                    help="time one call of an operator by route and stop")
    args = ap.parse_args(argv)
    if args.dispatch:
        import torch
        routes = dispatch_routes(torch)
        devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
        for device in devices:
            print(json.dumps({"device": device,
                              "us_per_call": dispatch_us(torch, routes, device)}))
        return 0
    if not args.tree:
        ap.error("--tree is required")
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch

    if not torch.cuda.is_available():
        print("decode_overhead: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import common as kcommon

    smi = cs.nvidia_smi_line()
    kcommon.build(force=True)
    for name in args.models.split(","):
        cfg = get_config(name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cfg.family in ("dense", "moe"):
                served = cs.phase_serve(torch, kcommon, cfg)
            elif cfg.family == "audio":
                served = cs.phase_serve_direct(torch, kcommon, cfg, cs.dense_launches,
                                               prefix=cs.AUDIO_PREFIX)
            else:
                served = cs.phase_serve_direct(
                    torch, kcommon, cfg,
                    cs.rwkv_launches if cfg.family == "rwkv" else cs.hybrid_launches)
        del served
        line = next(ln for ln in buf.getvalue().splitlines() if "ms/step" in ln)
        ms = float(re.search(r"\(([0-9.]+) ms/step", line).group(1))
        rate = re.search(r"ms/step, ([0-9.]+) (tokens|frames)/s", line)
        print(json.dumps({"tree": str(tree), "model": name, "decode_ms_per_step": ms,
                          f"{rate.group(2)}_per_s": float(rate.group(1)),
                          "device": torch.cuda.get_device_name(0), "smi": smi}),
              flush=True)
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
