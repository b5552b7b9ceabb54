"""Standalone training report — one self-contained HTML file, no server.

Reference: deeplearning4j-ui-components' standalone rendering path (build
Component trees from training results, emit a static page) — the artifact
you attach to an experiment record. Assembled from the same stats-storage
records the live dashboard reads (ui/codec.py stream), so any run that
used a StatsListener (or a FileStatsStorage on disk) can be rendered
after the fact:

    from deeplearning4j_tpu_torch.ui import FileStatsStorage
    from deeplearning4j_tpu_torch.ui.report import write_training_report
    write_training_report(FileStatsStorage("stats.bin"), "report.html")

The port of the JAX package's ui/report.py: the same storage gives the
same HTML in both packages.
"""

from __future__ import annotations

import time
from typing import List, Optional

from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartLine,
    Component,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    register_component,
    render_page,
)
from deeplearning4j_tpu_torch.ui.stats import split_stat_key
from deeplearning4j_tpu_torch.ui.storage import StatsStorage


# -- flow (layer-graph) view --------------------------------------------------

def _graph_depths(nodes, edges):
    """Longest-path depth per node id (layered layout columns)."""
    ids = [n["id"] for n in nodes]
    indeg = {i: 0 for i in ids}
    outs = {i: [] for i in ids}
    for src, dst in edges:
        if src in outs and dst in indeg:
            outs[src].append(dst)
            indeg[dst] += 1
    depth = {i: 0 for i in ids}
    queue = [i for i in ids if indeg[i] == 0]
    while queue:
        cur = queue.pop(0)
        for nxt in outs[cur]:
            depth[nxt] = max(depth[nxt], depth[cur] + 1)
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                queue.append(nxt)
    return depth


@register_component
class FlowGraph(Component):
    """The flow view: the model DAG laid out in depth columns, each node a
    box with its label and (when known) parameter count + latest mean
    |param| (reference: FlowListenerModule's per-layer boxes)."""

    component_type = "FlowGraph"

    NODE_W, NODE_H, GAP_X, GAP_Y = 148, 40, 40, 14

    def __init__(self, graph: dict, layer_stats: Optional[dict] = None):
        self.graph = graph or {"nodes": [], "edges": []}
        self.layer_stats = layer_stats or {}

    def to_dict(self):
        return {"componentType": self.component_type, "graph": self.graph,
                "layerStats": self.layer_stats}

    @classmethod
    def _from_dict(cls, d):
        return cls(d.get("graph"), d.get("layerStats"))

    def render_html(self):
        import html as _h

        nodes = self.graph.get("nodes", [])
        edges = self.graph.get("edges", [])
        if not nodes:
            return "<div class='chart'><h3>flow</h3>(no graph)</div>"
        depth = _graph_depths(nodes, edges)
        cols: dict = {}
        for n in nodes:
            cols.setdefault(depth[n["id"]], []).append(n)
        pos = {}
        for d, members in cols.items():
            for r, n in enumerate(members):
                pos[n["id"]] = (
                    8 + d * (self.NODE_W + self.GAP_X),
                    8 + r * (self.NODE_H + self.GAP_Y),
                )
        w = 16 + (max(cols) + 1) * (self.NODE_W + self.GAP_X)
        h = 16 + max(len(m) for m in cols.values()) * (
            self.NODE_H + self.GAP_Y)
        parts = []
        for src, dst in edges:
            if src not in pos or dst not in pos:
                continue
            x0, y0 = pos[src]
            x1, y1 = pos[dst]
            parts.append(
                f'<line x1="{x0 + self.NODE_W}" y1="{y0 + self.NODE_H / 2}" '
                f'x2="{x1}" y2="{y1 + self.NODE_H / 2}" stroke="#999" '
                'marker-end="url(#arr)"/>')
        for n in nodes:
            x, y = pos[n["id"]]
            li = n.get("layer_index")
            stat = self.layer_stats.get(str(li)) or self.layer_stats.get(li)
            label = n["label"].split("\n")
            fill = "#e3f2fd" if li is not None else "#eeeeee"
            parts.append(
                f'<rect x="{x}" y="{y}" width="{self.NODE_W}" '
                f'height="{self.NODE_H}" rx="4" fill="{fill}" '
                'stroke="#90a4ae"/>')
            parts.append(
                f'<text x="{x + 6}" y="{y + 15}" font-size="10" '
                f'font-weight="bold">{_h.escape(label[0][:24])}</text>')
            sub = label[1] if len(label) > 1 else ""
            if stat:
                sub = (f"{stat.get('n_params', '?')}p"
                       + (f"  |w|~{stat['param_mean']:.3g}"
                          if "param_mean" in stat else ""))
            if sub:
                parts.append(
                    f'<text x="{x + 6}" y="{y + 30}" font-size="9" '
                    f'fill="#555">{_h.escape(str(sub)[:28])}</text>')
        defs = ('<defs><marker id="arr" markerWidth="8" markerHeight="8" '
                'refX="7" refY="3" orient="auto"><path d="M0,0 L7,3 L0,6" '
                'fill="none" stroke="#999"/></marker></defs>')
        return (f'<div class="chart"><h3>model flow</h3>'
                f'<svg width="{w}" height="{h}">{defs}{"".join(parts)}'
                "</svg></div>")


# -- report assembly ----------------------------------------------------------

def _series(ups: List[dict], key: str):
    return [(u["iteration"], u[key]) for u in ups if key in u]


def _layer_stats_latest(ups: List[dict], static: dict) -> dict:
    """Per layer-index: n_params + latest mean |param| (averaged over the
    layer's param tensors)."""
    out = {}
    for meta in static.get("layers", []):
        out[str(meta["index"])] = {"n_params": meta["n_params"]}
    for u in reversed(ups):
        pm = u.get("param_mm")
        if not pm:
            continue
        per: dict = {}
        for k, v in pm.items():
            li, _ = split_stat_key(k)
            per.setdefault(li, []).append(v)
        for li, vals in per.items():
            out.setdefault(li, {})["param_mean"] = sum(vals) / len(vals)
        break
    return out


def build_report_components(storage: StatsStorage,
                            session_id: Optional[str] = None
                            ) -> List[Component]:
    """Component tree for one session's training run (newest session when
    not named)."""
    if session_id is None:
        session_id = storage.latest_session_id()
        if session_id is None:
            return [ComponentText("no sessions in storage", bold=True)]
    static = storage.get_static_info(session_id) or {}
    ups = [u for u in storage.get_updates(session_id) if "score" in u]

    comps: List[Component] = []
    rows = [["session", session_id]]
    for key in ("model_class", "backend", "device", "n_devices",
                "total_params"):
        if key in static:
            rows.append([key, static[key]])
    if ups:
        rows.append(["iterations", ups[-1]["iteration"] + 1])
        rows.append(["final score", f"{ups[-1]['score']:.6g}"])
        if static.get("start_time"):
            rows.append(["started",
                         time.strftime("%Y-%m-%d %H:%M:%S",
                                       time.localtime(static["start_time"]))])
    comps.append(ComponentDiv(
        [ComponentTable(["key", "value"], rows)], "run summary"))

    charts: List[Component] = []
    if _series(ups, "score"):
        charts.append(ChartLine("score vs iteration",
                                {"score": _series(ups, "score")}))
    if _series(ups, "samples_per_sec"):
        charts.append(ChartLine("throughput (samples/sec)",
                                {"samples/sec":
                                 _series(ups, "samples_per_sec")}))
    if _series(ups, "etl_ms"):
        charts.append(ChartLine("ETL wait (ms)",
                                {"etl ms": _series(ups, "etl_ms")}))
    if charts:
        comps.append(ComponentDiv(charts, "training progress"))

    # per-layer mean-magnitude series (grad/update/param), one chart per
    # layer with its params as series
    layer_series: dict = {}
    for group, label in (("grad_mm", "grad"), ("update_mm", "update"),
                         ("param_mm", "param")):
        for u in ups:
            for k, v in (u.get(group) or {}).items():
                li, pname = split_stat_key(k)
                layer_series.setdefault(li, {}).setdefault(
                    f"{label} |{pname}|", []).append((u["iteration"], v))
    if layer_series:
        layer_charts = [
            ChartLine(f"layer {li}", series)
            for li, series in sorted(layer_series.items(),
                                     key=lambda kv: int(kv[0]))
        ]
        comps.append(ComponentDiv(layer_charts,
                                  "per-layer mean magnitudes"))

    for u in reversed(ups):
        if "hists" in u:
            hcomps = [
                ChartHistogram(name, h["edges"], h["counts"])
                for name, h in u["hists"].items()
            ]
            comps.append(ComponentDiv(
                hcomps, f"parameter histograms (iteration "
                        f"{u['iteration']})"))
            break

    graph = static.get("graph")
    if graph:
        comps.append(ComponentDiv(
            [FlowGraph(graph, _layer_stats_latest(ups, static))],
            "model flow"))
    return comps


def render_training_report(storage: StatsStorage,
                           session_id: Optional[str] = None,
                           title: str = "training report") -> str:
    return render_page(title, build_report_components(storage, session_id))


def write_training_report(storage: StatsStorage, out_path: str,
                          session_id: Optional[str] = None,
                          title: str = "training report") -> str:
    html = render_training_report(storage, session_id, title)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
