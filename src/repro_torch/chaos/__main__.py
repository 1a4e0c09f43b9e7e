"""``python -m repro_torch.chaos`` — run the failure-isolation scenarios
(port of ``repro.chaos.__main__``)."""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.chaos import SCENARIOS, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos",
        description="BatchWeave chaos harness: scripted kill/restart "
                    "scenarios asserting exactly-once recovery, atomic "
                    "visibility, and clean fsck.")
    ap.add_argument("--only", default=None,
                    help="comma-separated scenario names (default: all)")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-injection seed (default 0)")
    ap.add_argument("--list", action="store_true", dest="list_only",
                    help="list scenario names and exit")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="enable span tracing for the run and write a "
                         "Chrome trace (chrome://tracing / Perfetto) to FILE")
    args = ap.parse_args(argv)

    if args.list_only:
        for name in sorted(SCENARIOS):
            print(name)
        return 0
    only = args.only.split(",") if args.only else None
    if args.trace:
        from repro_torch.obs.tracer import enable_tracing
        enable_tracing()
    try:
        results = run_all(only=only, seed=args.seed)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.trace:
        from repro_torch.obs.tracer import TRACER
        TRACER.write_chrome_trace(args.trace)
        print(f"# chrome trace: {args.trace} ({len(TRACER.spans())} spans)",
              file=sys.stderr)
    if args.as_json:
        json.dump([vars(r) for r in results], sys.stdout, indent=2)
        print()
    else:
        for r in results:
            print(r.row())
        n_fail = sum(1 for r in results if not r.passed)
        print(f"# {len(results) - n_fail}/{len(results)} scenarios passed "
              f"(seed={args.seed})")
    return 0 if all(r.passed for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
