#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json. The cell names a
configuration (configs/) and a traffic mix (traffic/), and the mix names
the driver (drivers/) that runs it: set-up (weights and inputs from the
seed, the port's network, every shape warmed up), a timed window of
`--seconds`, with `--trace 1` a short profiled window after it, then the
comparison of what the timed path produced with the plain reference
(reference/), once the window's numbers are read.

Standard output ends with one JSON line: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, optionally breakdown, and last the numbers compared, each
beside its limit; standard error ends with the same comparison, a line a
number. The run exits non-zero and prints no result where no CUDA device
is visible, where there are fewer than the cell asks for, or where JAX or
the JAX package is loaded once the window has closed. `--rehearse-cpu`
runs the same code on the CPU for the tests, with no device metric.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    """Before torch loads: CUPTI's lazy re-initialisation off (a second
    profile after graph replays can lose kernels), and every build and
    kernel cache at a fixed path inside the checkout."""
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    cache = os.path.join(ROOT, "benchmark", ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


class Context:
    """What a driver gets: the cell, its files, the device and the seed."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def log(self, msg: str) -> None:
        print(f"[{time.perf_counter() - self.t_start:8.2f}s] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on the CPU (tests only: no device metric)")
    return ap.parse_args(argv)


def context(args):
    """The Context of a run of `args.workload`, or an exit code where no
    device the cell asks for is visible."""
    _environment()
    from benchmark import harness

    spec = harness.Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])

    import torch

    if args.rehearse_cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("no CUDA device is visible: the benchmark runs on the GPU only",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < int(cell["chips"]):
            print(f"the cell asks for {cell['chips']} devices, "
                  f"{torch.cuda.device_count()} are visible", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    return Context(
        args=args, seed=int(args.seed), seconds=float(args.seconds), trace=bool(args.trace),
        spec=spec, cell=cell, cfg=cfg, traffic=traffic, limits=spec.limits(cell["name"]),
        model=spec.module("models", cfg["model"]), ref=spec.module("reference", cfg["reference"]),
        precision=spec.module("reference", "precision"), device=device, torch=torch,
        t_start=T_START, harness=harness)


def main(argv=None) -> int:
    ctx = context(parse(argv))
    if isinstance(ctx, int):
        return ctx
    args, spec, cell, traffic, torch, device, harness = (
        ctx.args, ctx.spec, ctx.cell, ctx.traffic, ctx.torch, ctx.device, ctx.harness)
    driver = spec.module("drivers", traffic["driver"])
    out = driver.run(ctx)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    device_rec = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu"),
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        device_rec["busy_s"] = out["trace"].busy_s
        device_rec["window_s"] = out["trace"].window_s
    metrics = {}
    for m in spec.metrics_for(cell["name"], args.trace):
        v = out["metrics"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = harness.metric_entry(v, m["unit"])
    checks = out["checks"]
    for line in [f"card {out.get('card', '')}"] + checks.lines():
        print(line, file=sys.stderr)
    print(harness.result_line(checks.correct, out["attempted"], out["failed"], metrics,
                              device_rec, checks.as_dict(), out.get("breakdown")))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
