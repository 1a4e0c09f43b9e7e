"""Read the controls of a cell's comparison on the chip, at the cell's own
size, one JSON line a seed:

    python3 weavebench/control.py --workload <name> --seeds 1,2,3
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cache" / "nv")
sys.path[:0] = [str(ROOT / "weavebench"), str(ROOT / "src")]

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    from wb.control import control_readings
    from wb.spec import Spec

    for seed in map(int, args.seeds.split(",")):
        out = control_readings(Spec(), args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
