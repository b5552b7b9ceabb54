"""Concurrency audit — merged static + runtime lock-discipline findings.

The two halves of lock checking live in different modules on purpose:

- utils/locktrace is the RUNTIME sanitizer (lockdep-style): armed via
  ``DL4J_LOCKCHECK=1`` it witnesses real acquisition orders, blocking
  calls (device syncs included) under held locks, and device dispatches
  entered with a lock held, with bounded stack witnesses.
- analysis/lint is the LEXICAL pass: `with lock:` nesting plus the
  acquire()/release() call form, no execution needed.

This module is where they meet. ``report()`` joins the two lock-order
graphs — runtime lock classes are keyed by construction site
(``path.py:123``) and the linter records which lexical lock key
(``Class.attr``) each ``threading.Lock()`` assignment site constructs,
so edges witnessed both ways collapse onto one node and carry an
``origin`` label: ``static`` (lexically provable, never yet executed),
``runtime`` (witnessed under load, lexically invisible — e.g. locks
taken through helper indirection), or ``both``. Cycles in the MERGED
graph become CN001 errors naming every edge's origin and witness;
runtime blocking-under-lock records become CN002 and dispatch-under-
lock CN003 warnings (the lexical pass emits its own CN002/CN003 for
what it can see without running — same codes, same baseline).

Gate: ``--smoke`` runs a dedicated serving + decode + sparse/paramserver
exercise with the sanitizer armed, then diffs ALL CN finding names
against ``deeplearning4j_tpu_torch/analysis/lock_baseline.txt`` (the
name-diff pattern of the lint gate: it starts green on a committed —
ideally empty — baseline and only regressions fail). Tier-1 runs it on
the CPU (tests/test_torch_locktrace.py), chip_smoke.py on the card.

The port of the JAX package's analysis/concurrency_audit.py: the same
merge, finding names and flags; the smoke takes a ``device`` ("cuda"
unless the caller asks for the CPU).

Run: python -m deeplearning4j_tpu_torch.analysis.concurrency_audit
       [--smoke] [--device cpu] [--json -] [--names-out PATH]
       [--baseline FILE]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Dict, List, Tuple

from deeplearning4j_tpu_torch.analysis.findings import (
    ERROR,
    WARNING,
    Finding,
    format_findings,
    summarize,
)
from deeplearning4j_tpu_torch.utils import locktrace

logger = logging.getLogger("deeplearning4j_tpu_torch")

_EMPTY_SNAP = {"enabled": False, "locks": {}, "edges": [], "blocking": [],
               "dispatch": []}


def _static(paths=None, base_dir=None):
    from deeplearning4j_tpu_torch.analysis import lint

    findings, edges, ctor_sites = lint.collect(
        paths or lint.DEFAULT_TARGETS, base_dir)
    cn = [f for f in findings if f.code.startswith("CN")]
    return cn, edges, ctor_sites


def merged_edges(static_edges: Dict[Tuple[str, str], str], snap: dict,
                 ctor_sites: Dict[str, str]) -> Dict[Tuple[str, str], dict]:
    """One edge map over both graphs. Runtime construction sites that
    the linter attributed to a lexical lock key are renamed to that key
    so the same lock is ONE node regardless of which half saw it."""
    out: Dict[Tuple[str, str], dict] = {}
    for (a, b), loc in static_edges.items():
        out[(a, b)] = {"src": a, "dst": b, "origin": "static",
                       "location": loc}
    for e in snap.get("edges", []):
        a = ctor_sites.get(e["src"], e["src"])
        b = ctor_sites.get(e["dst"], e["dst"])
        rec = out.get((a, b))
        if rec is None:
            out[(a, b)] = {"src": a, "dst": b, "origin": "runtime",
                           "count": e["count"], "thread": e["thread"],
                           "witness": e["witness"]}
        else:
            rec["origin"] = "both"
            rec["count"] = rec.get("count", 0) + e["count"]
            rec.setdefault("thread", e["thread"])
            rec.setdefault("witness", e["witness"])
    return out


def report(runtime: bool = True, paths=None, base_dir=None) -> dict:
    """The audit: static CN findings + runtime CN findings + CN001
    cycles over the merged lock-order graph."""
    static_cn, static_edges, ctor_sites = _static(paths, base_dir)
    snap = locktrace.snapshot() if runtime else dict(_EMPTY_SNAP)
    edges = merged_edges(static_edges, snap, ctor_sites)
    findings: List[Finding] = list(static_cn)

    from deeplearning4j_tpu_torch.analysis.lint import _find_cycles

    loc_map = {k: (v.get("location")
                   or (v.get("witness") or ["<runtime>"])[0])
               for k, v in edges.items()}
    for cycle, loc in _find_cycles(loc_map):
        detail = []
        for a, b in zip(cycle, cycle[1:]):
            rec = edges.get((a, b))
            if rec is None:
                continue
            d = f"{a} -> {b} [{rec['origin']}]"
            t = rec.get("thread")
            if t:
                d += f" (thread {t})"
            w = rec.get("witness")
            if w:
                d += " witness: " + " <- ".join(w[:4])
            detail.append(d)
        findings.append(Finding(
            "CN001", ERROR, loc,
            "lock-order cycle: " + " -> ".join(cycle) + " || "
            + " || ".join(detail),
            "pick one global acquisition order for these locks and "
            "stick to it on every path",
            name="CN001:" + "->".join(sorted(set(cycle)))))

    for b in snap.get("blocking", []):
        rel = b["site"].rsplit(":", 1)[0]
        msg = (f"{b['kind']} while holding {', '.join(b['held'])} "
               f"(x{b['count']}, thread {b['thread']})")
        if b.get("witness"):
            msg += " witness: " + " <- ".join(b["witness"][:4])
        findings.append(Finding(
            "CN002", WARNING, b["site"], msg,
            "snapshot state under the lock, release, THEN block — or "
            "baseline the name in the lock baseline with a comment "
            "saying why it is safe",
            name=f"CN002:{b['kind']}:{rel}:{b['func']}"))

    for d in snap.get("dispatch", []):
        rel = d["site"].rsplit(":", 1)[0]
        findings.append(Finding(
            "CN003", WARNING, d["site"],
            f"device dispatch '{d['what']}' entered while holding "
            f"{', '.join(d['held'])} (x{d['count']}, thread "
            f"{d['thread']})",
            "stage inputs under the lock, dispatch outside it",
            name=f"CN003:{d['what']}:{rel}:{d['func']}"))

    return {
        "runtime": bool(snap.get("enabled", False)),
        "lock_classes": snap.get("locks", {}),
        "edges": sorted((dict(v) for v in edges.values()),
                        key=lambda e: (e["src"], e["dst"])),
        "findings": findings,
        "summary": summarize(findings),
    }


def finding_names(doc: dict) -> List[str]:
    """ALL CN finding names (errors AND warnings): unlike lint.sh the
    lock gate diffs the complete vocabulary — a new blocking-under-lock
    warning is exactly the regression this gate exists to catch."""
    return sorted({f.name for f in doc["findings"]})


def smoke(device="cuda") -> dict:
    """Dedicated sanitizer exercise for the lock-audit gate: the three
    lock-heaviest tiers — serving (ParallelInference admission +
    dispatch), decode (continuous batching through a weight swap), and
    the sparse/paramserver pipeline (prefetch + coherence + drains) —
    run in-process with the sanitizer armed so their real acquisition
    orders land in one merged graph. The serving and decode nets live on
    `device` ("cuda" by default; raises without a GPU unless "cpu")."""
    import numpy as np

    locktrace.install()
    results = {}

    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    conf = (NeuralNetConfiguration.builder()
            .seed(7).updater(Updater.SGD).learning_rate(0.05)
            .weight_init("xavier").list()
            .layer(DenseLayer(n_in=12, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device=device).init()
    pi = ParallelInference(net, max_batch_size=8)
    try:
        rng = np.random.default_rng(0)
        for i in range(6):
            pi.output(rng.standard_normal(
                (1 + i % 4, 12)).astype(np.float32))
        results["serving_requests"] = 6
    finally:
        pi.shutdown()

    from deeplearning4j_tpu_torch.serving import decode as _decode

    results["decode_ok"] = bool(_decode.smoke(requests=6,
                                              device=device)["ok"])

    from deeplearning4j_tpu_torch.parallel import sparse as _sparse

    sv = _sparse.smoke()
    if not sv["ok"]:
        raise AssertionError(f"sparse smoke violated under lockcheck: {sv}")
    results["sparse_ok"] = True
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.analysis.concurrency_audit",
        description="merged static+runtime lock-discipline audit "
                    "(CN001-CN003)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs for the static half (default: the "
                         "repo targets)")
    ap.add_argument("--smoke", action="store_true",
                    help="arm the sanitizer and run the serving + decode "
                         "+ sparse exercise before reporting (the "
                         "lock-audit gate)")
    ap.add_argument("--device", default="cuda",
                    help="device of the smoke's nets (default cuda; "
                         "raises without a GPU unless given cpu)")
    ap.add_argument("--json", dest="json_out", default=None, metavar="PATH",
                    help="write the full report as JSON ('-' = stdout)")
    ap.add_argument("--names-out", default=None, metavar="PATH",
                    help="write sorted CN finding names (one per line) — "
                         "the artifact the gate diffs against the "
                         "baseline")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppress findings whose names appear in this "
                         "file; exit 1 only on new ones")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.smoke:
        from deeplearning4j_tpu_torch import configure_logging

        if all(isinstance(h, logging.NullHandler)
               for h in logger.handlers):
            configure_logging()
        results = smoke(device=args.device)
        logger.info("lock-audit smoke: %s", json.dumps(results))

    doc = report(runtime=True, paths=args.paths or None)
    names = finding_names(doc)

    if args.names_out:
        with open(args.names_out, "w") as f:
            f.write("".join(n + "\n" for n in names))
    serializable = dict(doc)
    serializable["findings"] = [f.to_dict() for f in doc["findings"]]
    if args.json_out == "-":
        print(json.dumps(serializable, indent=2))
    elif args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(serializable, f, indent=2)
        print(f"wrote {args.json_out}")
    elif not args.quiet:
        print(format_findings(doc["findings"]))
    if args.json_out != "-":  # keep stdout parseable under --json -
        print(f"lock audit: {len(doc['edges'])} order edges "
              f"({sum(1 for e in doc['edges'] if e['origin'] != 'static')} "
              f"runtime-witnessed), {len(names)} CN findings, "
              f"runtime={'armed' if doc['runtime'] else 'off'}")

    if args.baseline:
        try:
            with open(args.baseline) as f:
                allowed = {ln.strip() for ln in f
                           if ln.strip() and not ln.startswith("#")}
        except OSError as e:
            print(f"concurrency_audit: cannot read baseline "
                  f"{args.baseline}: {e}", file=sys.stderr)
            return 2
        new = [n for n in names if n not in allowed]
        if new:
            print(f"LOCK AUDIT REGRESSIONS — CN findings not in "
                  f"{args.baseline}:", file=sys.stderr)
            for n in new:
                print(f"  {n}", file=sys.stderr)
            return 1
        return 0
    return 1 if any(f.severity == ERROR for f in doc["findings"]) else 0


if __name__ == "__main__":
    # `python -m` runs a second copy of this module as __main__; keep
    # all state in the canonical import so snapshot() sees one world
    from deeplearning4j_tpu_torch.analysis import concurrency_audit as _canonical

    sys.exit(_canonical.main())
