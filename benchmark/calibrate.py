#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, at the cell's
own size, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seed <first> --seeds 12 \
        --controls 3 [--faults half_batch ...]

For each of `--seeds` seeds (from `--seed` on, by steps of 7919) the
numbers the cell compares for the program as it runs; for the first
`--controls` seeds also the control's (the plain reference one precision
below the configuration's, put in the program's place) and each fault's
(benchmark/faults.py, planted in the program). One JSON line a seed on
standard output, then a summary line: for each number the largest
program reading (the lower end of a limit) and the smallest control and
fault readings (the upper end). The benchmark's own runs never run this.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--rehearse-cpu", action="store_true")
    a = ap.parse_args(argv)
    args = run.parse(["--workload", a.workload, "--seed", str(a.seed), "--seconds", "0"]
                     + (["--rehearse-cpu"] if a.rehearse_cpu else []))
    ctx = run.context(args)
    if isinstance(ctx, int):
        return ctx
    driver = ctx.spec.module("drivers", ctx.traffic["driver"])
    seeds = [a.seed + 7919 * i for i in range(a.seeds)]
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    driver.calibrate(ctx, seeds, a.controls, a.faults, emit)
    summary = {}
    for row in rows:
        for kind, nums in row.items():
            if not isinstance(nums, dict):
                continue
            for name, v in nums.items():
                key = f"{kind}.{name}"
                pick = max if kind == "program" else min
                v = v if math.isfinite(v) else 1e300
                summary[key] = v if key not in summary else pick(summary[key], v)
    print(json.dumps({"summary": summary, "card": run_card(ctx)}), flush=True)
    return 0


def run_card(ctx):
    from benchmark import runtime

    return runtime.card_line(ctx.torch, ctx.device)


if __name__ == "__main__":
    sys.exit(main())
