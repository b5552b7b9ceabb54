"""Shared pieces of the harness: the specification and its files, the
module check, the correctness checks and the result line.

Nothing here imports torch at module level, so the CPU tests can load it
without a card and the run can set its environment before torch starts.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
from typing import Dict, Iterable, List, Optional

# the top-level module names a run may not hold once its window has closed:
# JAX and the JAX package. Compared whole, so `deeplearning4j_tpu_torch`
# (the port) is not `deeplearning4j_tpu`.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# drivers, reference and adapter modules are Python module names
MODULE_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among module names `names`."""
    bad = set(FORBIDDEN_MODULES)
    return sorted({n.split(".", 1)[0] for n in names} & bad)


def load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def valid_name(name) -> bool:
    return isinstance(name, str) and NAME_RE.match(name) is not None


def valid_unit(unit) -> bool:
    return isinstance(unit, str) and UNIT_RE.match(unit) is not None


class Spec:
    """BENCHMARK.json and the files it names, rooted at a checkout."""

    def __init__(self, root: str):
        self.root = root
        self.bench = os.path.join(root, "benchmark")
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))

    def path(self, *parts) -> str:
        return os.path.join(self.bench, *parts)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        if not valid_name(name):
            raise ValueError(f"bad traffic name {name!r}")
        return load_json(self.path("traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return load_json(self.path("limits", f"{cell}.json"))

    def metrics_for(self, cell: str, trace: bool) -> List[dict]:
        """The cell's metrics: its end-to-end ones (trace off) or its
        per-layer ones (trace on). A metric with a `workloads` list
        belongs to those cells; one without belongs to every cell that
        reports the end-to-end metric it moves."""
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def families(self) -> Dict[str, dict]:
        """{family: {"patterns": [...], "counts": module}}: the union of
        every file in families/, patterns lower-cased."""
        out: Dict[str, dict] = {}
        d = self.path("families")
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".json"):
                continue
            f = load_json(os.path.join(d, fn))
            fam = out.setdefault(f["family"], {"patterns": [], "counts": f["counts"]})
            if fam["counts"] != f["counts"]:
                raise ValueError(f"family {f['family']!r}: {fn} names counts "
                                 f"{f['counts']!r}, another file {fam['counts']!r}")
            fam["patterns"] += [p.lower() for p in f["kernels"]]
        return out

    def module(self, kind: str, name: str):
        """benchmark/<kind>/<name>.py, loaded by path (drivers, models,
        reference, counts)."""
        if not MODULE_RE.match(name):
            raise ValueError(f"bad {kind} module name {name!r}")
        return load_module(self.path(kind, f"{name}.py"), f"benchmark.{kind}.{name}")

    def reader(self, metric: str):
        """The per-layer metric's reader, benchmark/metrics/<metric>.py."""
        if not valid_name(metric):
            raise ValueError(f"bad metric name {metric!r}")
        return load_module(self.path("metrics", f"{metric}.py"),
                           "benchmark.metrics." + metric.replace(".", "__").replace("-", "_"))


def load_module(path: str, name: str):
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# -- correctness ---------------------------------------------------------------

class Checks:
    """The numbers a run compares, each beside its limit. `correct` holds
    when every number is finite and at most its limit and no fault was
    recorded."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.rows: List[tuple] = []
        self.faults: List[str] = []

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for check {name!r}")
        self.rows.append((name, float(value), float(self.limits[name])))

    def fault(self, what: str) -> None:
        self.faults.append(what)

    @property
    def correct(self) -> bool:
        return (not self.faults and bool(self.rows)
                and all(math.isfinite(v) and v <= lim for _, v, lim in self.rows))

    def as_dict(self) -> dict:
        # a number that is not finite is written as its name ("inf", "nan")
        out = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
               for n, v, lim in self.rows}
        if self.faults:
            out["faults"] = list(self.faults)
        return out

    def lines(self) -> List[str]:
        out = [f"check {n} {v!r} limit {lim!r}" for n, v, lim in self.rows]
        out += [f"check fault {f}" for f in self.faults]
        return out


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b| (inf where b is 0 and a is not)."""
    if a == b:
        return 0.0
    return abs(a - b) / abs(b) if b != 0 else math.inf


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Iterable[str]) -> Dict[str, float]:
    """For each leaf the gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf's (some leaves' norms are all but zero)."""
    names = list(leaves)
    med = sorted(ref[n] for n in names)[len(names) // 2]
    out = {}
    for n in names:
        denom = max(ref[n], med)
        out[n] = (abs(prog[n] - ref[n]) / denom if denom > 0 and math.isfinite(prog[n])
                  else (0.0 if prog[n] == ref[n] else math.inf))
    return out


def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else math.inf


def counted_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: a
    norm at least `share` of the median leaf's. A leaf below it moves
    under an adaptive updater by round-off alone."""
    vals = sorted(grad_norms.values())
    med = vals[len(vals) // 2] if vals else 0.0
    return [n for n, g in grad_norms.items() if g >= share * med]


# -- the result line -----------------------------------------------------------

def metric_entry(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks  # last, as the contract asks
    return json.dumps(out, allow_nan=False)
