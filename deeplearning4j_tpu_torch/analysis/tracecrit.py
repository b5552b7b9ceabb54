"""Span-tree reconstruction + critical-path analysis over trace exports
(`cli trace <file-or-url>` — the readout half of utils/tracing's
distributed tracer).

Input: the JSONL span export (utils/tracing.Tracer.to_jsonl — one event
per line with `trace`/`id`/`parent`/`ts`/`dur` in microseconds), from a
file, a `TracingListener` artifact, or a live server's `GET /trace`.

Per trace the analyzer rebuilds the span tree and computes the
**critical path**: starting from the trace's covering root span, walk
backward from the span's end picking the latest-finishing child chain of
non-overlapping intervals — the sequence of spans that actually gated
the end-to-end latency. Each step on the path is charged its SELF time
(duration minus the time covered by its own on-path children), so the
per-stage breakdown sums to ~the root duration and answers "which stage
do I fix to move the p99": the falsifiable counterpart to the admission
estimator's predicted-late decisions, and the resolution target for the
histogram exemplars in utils/metrics (exemplar trace_id -> this report).

Partial traces are handled: a span whose parent id is absent from the
export (the remote half of a cross-process trace, or a parent that aged
out of the ring) is treated as a root — the analysis is honest about
what the export contains rather than refusing it.

The port's own copy of the JAX package's analysis/tracecrit.py (pure
Python, no torch): the port's utils/tracing writes the same JSONL format.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

# child intervals jitter by clock granularity; allow this much overhang
# (microseconds) when chaining "non-overlapping" children
_EPS_US = 1.0


def parse_jsonl(text: str) -> List[dict]:
    """Span events from a JSONL export; blank/corrupt lines are skipped
    (a live /trace endpoint can race a writer mid-line)."""
    events = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(ev, dict) and "name" in ev:
            events.append(ev)
    return events


def group_traces(events: List[dict]) -> Dict[str, List[dict]]:
    """{trace_id: [events]} over complete ("X"-phase) spans AND instant
    markers; events without a trace id (pre-distributed exports) are
    dropped — there is no tree to build for them."""
    out: Dict[str, List[dict]] = {}
    for ev in events:
        tid = ev.get("trace")
        if tid:
            out.setdefault(tid, []).append(ev)
    return out


def _spans_of(trace_events: List[dict]) -> List[dict]:
    return [e for e in trace_events if e.get("ph", "X") == "X"]


def _roots(spans: List[dict]) -> List[dict]:
    ids = {s["id"] for s in spans}
    return [s for s in spans
            if s.get("parent") is None or s["parent"] not in ids]


def _union_len(intervals: List[tuple]) -> float:
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def critical_path(trace_events: List[dict]) -> List[dict]:
    """The latency-gating chain of one trace, root first. Each entry:
    {name, id, start_us, dur_us, self_us, args} where `self_us` is the
    span's duration minus the time covered by its own on-path
    descendants — the per-stage charge that sums to ~the root duration.

    Async-aware: a child recorded retroactively after a queue hop (the
    serving pipeline's dispatch span under its request's already-closed
    admission span) can END after its parent — chain selection therefore
    works on each span's *effective* end (its own end or its latest
    descendant's, whichever is later), so the path follows the handoff
    instead of stopping at the first closed parent."""
    spans = _spans_of(trace_events)
    if not spans:
        return []
    children: Dict[object, List[dict]] = {}
    ids = {s["id"] for s in spans}
    for s in spans:
        p = s.get("parent")
        if p is not None and p in ids:
            children.setdefault(p, []).append(s)
    roots = _roots(spans)

    eff_memo: Dict[object, float] = {}

    def eff_end(s: dict) -> float:
        v = eff_memo.get(s["id"])
        if v is None:
            v = s.get("ts", 0.0) + s.get("dur", 0.0)
            eff_memo[s["id"]] = v  # breaks cycles from corrupt exports
            for k in children.get(s["id"], []):
                v = max(v, eff_end(k))
            eff_memo[s["id"]] = v
        return v

    # the covering root: widest effective window, earliest start on ties.
    # A parent-id cycle (corrupt/merged export) can leave NO root — fall
    # back to every span as a candidate rather than refusing the export
    root = max(roots or spans,
               key=lambda s: (eff_end(s) - s.get("ts", 0.0),
                              -s.get("ts", 0.0)))

    path: List[dict] = []
    visited = set()  # parent-id cycles must not recurse forever

    def walk(span: dict):
        if span["id"] in visited:
            return
        visited.add(span["id"])
        path.append(span)
        kids = children.get(span["id"], [])
        # walk backward from the span's effective end choosing the
        # latest-finishing chain of non-overlapping children — the
        # fork-join critical chain; anything not on it ran in the
        # shadow of it
        chain: List[dict] = []
        cursor = eff_end(span) + _EPS_US
        for k in sorted(kids, key=eff_end, reverse=True):
            if eff_end(k) <= cursor:
                chain.append(k)
                cursor = k.get("ts", 0.0) + _EPS_US
        for k in reversed(chain):
            walk(k)

    walk(root)

    # self time: each path step's duration minus the union of its
    # on-path DESCENDANTS' intervals clipped to its own — double-count-
    # free even when async children overhang their parents
    parent_of = {s["id"]: s.get("parent") for s in spans}

    def is_descendant(did, aid) -> bool:
        cur, seen = parent_of.get(did), set()
        while cur is not None and cur not in seen:
            if cur == aid:
                return True
            seen.add(cur)
            cur = parent_of.get(cur)
        return False

    out: List[dict] = []
    for s in path:
        s0 = s.get("ts", 0.0)
        s1 = s0 + s.get("dur", 0.0)
        intervals = []
        for o in path:
            if o is s or not is_descendant(o["id"], s["id"]):
                continue
            a = max(s0, o.get("ts", 0.0))
            b = min(s1, o.get("ts", 0.0) + o.get("dur", 0.0))
            if b > a:
                intervals.append((a, b))
        out.append({
            "name": s.get("name", "?"),
            "id": s["id"],
            "start_us": s0,
            "dur_us": s.get("dur", 0.0),
            "self_us": max(0.0, s.get("dur", 0.0)
                           - _union_len(intervals)),
            "args": s.get("args") or {},
        })
    return out


def analyze_trace(trace_id: str, trace_events: List[dict]) -> dict:
    """One trace's report: covering duration, span count, the critical
    path, and the per-stage (span-name) self-time breakdown."""
    spans = _spans_of(trace_events)
    path = critical_path(trace_events)
    stages: Dict[str, float] = {}
    for step in path:
        stages[step["name"]] = stages.get(step["name"], 0.0) \
            + step["self_us"]
    # covering window, not the root span's own duration: async children
    # recorded after a queue handoff can overhang the root (an
    # admission-rooted trace ends at its forward, not at admission)
    duration = (max(s["start_us"] + s["dur_us"] for s in path)
                - path[0]["start_us"]) if path else 0.0
    return {
        "trace_id": trace_id,
        "duration_us": round(duration, 3),
        "n_spans": len(spans),
        "n_events": len(trace_events),
        "root": path[0]["name"] if path else None,
        "critical_path": path,
        "critical_path_us": round(sum(s["self_us"] for s in path), 3),
        "stage_self_us": {k: round(v, 3)
                          for k, v in sorted(stages.items(),
                                             key=lambda kv: -kv[1])},
        "markers": [e.get("name") for e in trace_events
                    if e.get("ph") == "i"],
    }


def analyze(events: List[dict], top: int = 5,
            trace_id: Optional[str] = None) -> dict:
    """Full-export report: the top-k slowest traces (by covering root
    duration), or exactly one trace when `trace_id` is given (the
    exemplar-resolution path)."""
    traces = group_traces(events)
    if trace_id is not None:
        hits = {t: evs for t, evs in traces.items()
                if t == trace_id or t.startswith(trace_id)}
        reports = [analyze_trace(t, evs) for t, evs in hits.items()]
    else:
        reports = [analyze_trace(t, evs) for t, evs in traces.items()]
        reports.sort(key=lambda r: -r["duration_us"])
        reports = reports[:max(1, int(top))]
    return {
        "n_events": len(events),
        "n_traces": len(traces),
        "traces": reports,
    }


def format_report(report: dict, max_path: int = 24) -> str:
    """Human view: one block per trace — duration, stage breakdown, the
    critical path indented by tree depth order."""
    lines = [f"{report['n_traces']} trace(s) over {report['n_events']} "
             f"event(s); showing {len(report['traces'])}"]
    for tr in report["traces"]:
        lines.append("")
        lines.append(f"trace {tr['trace_id']} — "
                     f"{tr['duration_us'] / 1e3:.3f} ms, "
                     f"{tr['n_spans']} span(s), root {tr['root']}")
        if tr["markers"]:
            lines.append(f"  markers: {', '.join(tr['markers'])}")
        lines.append(f"  critical path "
                     f"({tr['critical_path_us'] / 1e3:.3f} ms):")
        for step in tr["critical_path"][:max_path]:
            lines.append(
                f"    {step['self_us'] / 1e3:9.3f} ms self "
                f"({step['dur_us'] / 1e3:9.3f} ms span)  {step['name']}")
        if len(tr["critical_path"]) > max_path:
            lines.append(f"    ... {len(tr['critical_path']) - max_path} "
                         "more")
        lines.append("  per-stage self time:")
        for name, us in tr["stage_self_us"].items():
            lines.append(f"    {us / 1e3:9.3f} ms  {name}")
    return "\n".join(lines)
