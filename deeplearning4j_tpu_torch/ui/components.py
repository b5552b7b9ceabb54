"""Server-independent report component DSL — the ui-components analog.

Reference: deeplearning4j-ui-parent/deeplearning4j-ui-components — a
library of chart/table/text components (ChartLine, ChartHistogram,
ChartScatter, ComponentTable, ComponentText, ComponentDiv, StyleChart...)
that serialize to JSON (componentType-discriminated) and render to a
self-contained page with NO running server, used for standalone training
reports.

Shape: each component is a small dataclass with the same
componentType-tagged JSON wire format (to_json/from_json round-trip) and
a `render_html()` that emits inline SVG/HTML — zero external assets, zero
JavaScript required, so the artifact opens anywhere (the box it was
produced on may have no egress). `render_page` wraps a component list
into one self-contained HTML document. A copy of the JAX package's
ui/components.py: the same component JSON renders the same HTML string in
both packages.
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class StyleChart:
    """Subset of the reference's StyleChart the renderer honors."""

    width: int = 420
    height: int = 180
    stroke_color: str = "#1565c0"

    def to_dict(self):
        return dataclasses.asdict(self)


def _esc(s) -> str:
    return _html.escape(str(s), quote=True)


def _style_from_dict(d: dict, default_width: int = 420,
                     default_height: int = 180) -> StyleChart:
    st = d.get("style", {})
    return StyleChart(st.get("width", default_width),
                      st.get("height", default_height),
                      st.get("stroke_color", "#1565c0"))


def _polyline(points: Sequence[Tuple[float, float]], w: int, h: int,
              color: str) -> str:
    """Scaled SVG path + min/max caption for one series."""
    pts = [(float(x), float(y)) for x, y in points
           if y is not None and y == y]  # drop None/NaN
    if len(pts) < 2:
        return f'<svg width="{w}" height="{h}"></svg>'
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    sx = lambda x: 4 + (w - 8) * (x - x0) / max(x1 - x0, 1e-9)
    sy = lambda y: h - 16 - (h - 24) * (y - y0) / max(y1 - y0, 1e-9)
    d = " ".join(
        f"{'M' if i == 0 else 'L'}{sx(x):.1f},{sy(y):.1f}"
        for i, (x, y) in enumerate(pts))
    return (
        f'<svg width="{w}" height="{h}">'
        f'<path d="{d}" fill="none" stroke="{color}" stroke-width="1.5"/>'
        f'<text x="4" y="{h - 3}" font-size="9" fill="#888">'
        f"x [{x0:g}, {x1:g}]  y [{y0:.5g}, {y1:.5g}]</text></svg>"
    )


class Component:
    """Base: componentType-tagged JSON + HTML rendering."""

    component_type = "Component"

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def render_html(self) -> str:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Component":
        t = d.get("componentType")
        cls = _REGISTRY.get(t)
        if cls is None:
            raise ValueError(f"unknown componentType {t!r}")
        return cls._from_dict(d)

    @staticmethod
    def from_json(s: str) -> "Component":
        return Component.from_dict(json.loads(s))


class ComponentText(Component):
    """Reference: ComponentText — a styled text run."""

    component_type = "ComponentText"

    def __init__(self, text: str, size: float = 13.0, bold: bool = False):
        self.text = text
        self.size = size
        self.bold = bold

    def to_dict(self):
        return {"componentType": self.component_type, "text": self.text,
                "style": {"fontSize": self.size, "bold": self.bold}}

    @classmethod
    def _from_dict(cls, d):
        st = d.get("style", {})
        return cls(d.get("text", ""), st.get("fontSize", 13.0),
                   st.get("bold", False))

    def render_html(self):
        weight = "bold" if self.bold else "normal"
        return (f'<p style="font-size:{self.size}px;'
                f'font-weight:{weight}">{_esc(self.text)}</p>')


class ComponentTable(Component):
    """Reference: ComponentTable — header + string rows."""

    component_type = "ComponentTable"

    def __init__(self, header: Sequence[str], rows: Sequence[Sequence]):
        self.header = [str(h) for h in header]
        self.rows = [[str(c) for c in r] for r in rows]

    def to_dict(self):
        return {"componentType": self.component_type,
                "header": self.header, "content": self.rows}

    @classmethod
    def _from_dict(cls, d):
        return cls(d.get("header", []), d.get("content", []))

    def render_html(self):
        head = "".join(f"<th>{_esc(h)}</th>" for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in r) + "</tr>"
            for r in self.rows)
        return (f'<table><tr>{head}</tr>{body}</table>')


class ChartLine(Component):
    """Reference: ChartLine — named x/y series on one chart."""

    component_type = "ChartLine"

    _PALETTE = ("#1565c0", "#2e7d32", "#c62828", "#6a1b9a", "#ef6c00",
                "#00695c", "#4e342e", "#37474f")

    def __init__(self, title: str,
                 series: Dict[str, Sequence[Tuple[float, float]]],
                 style: Optional[StyleChart] = None):
        self.title = title
        self.series = {k: [(float(x), float(y)) for x, y in v]
                       for k, v in series.items()}
        self.style = style or StyleChart()

    def to_dict(self):
        return {
            "componentType": self.component_type, "title": self.title,
            "x": {k: [p[0] for p in v] for k, v in self.series.items()},
            "y": {k: [p[1] for p in v] for k, v in self.series.items()},
            "seriesNames": list(self.series),
            "style": self.style.to_dict(),
        }

    @classmethod
    def _from_dict(cls, d):
        series = {
            k: list(zip(d["x"][k], d["y"][k]))
            for k in d.get("seriesNames", [])
        }
        return cls(d.get("title", ""), series, _style_from_dict(d))

    def render_html(self):
        w, h = self.style.width, self.style.height
        parts = [f'<div class="chart"><h3>{_esc(self.title)}</h3>']
        legend = []
        for i, (name, pts) in enumerate(self.series.items()):
            color = self._PALETTE[i % len(self._PALETTE)]
            legend.append(
                f'<span style="color:{color}">&#9632; {_esc(name)}</span>')
            parts.append(_polyline(pts, w, h, color))
        parts.append('<div style="font-size:10px">' + " ".join(legend)
                     + "</div></div>")
        return "".join(parts)


class ChartHistogram(Component):
    """Reference: ChartHistogram — bin edges + counts."""

    component_type = "ChartHistogram"

    def __init__(self, title: str, edges: Sequence[float],
                 counts: Sequence[float],
                 style: Optional[StyleChart] = None):
        self.title = title
        self.edges = [float(e) for e in edges]
        self.counts = [float(c) for c in counts]
        self.style = style or StyleChart(height=140)

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "lowerBounds": self.edges[:-1], "upperBounds": self.edges[1:],
                "yValues": self.counts, "style": self.style.to_dict()}

    @classmethod
    def _from_dict(cls, d):
        lo = d.get("lowerBounds", [])
        up = d.get("upperBounds", [])
        edges = lo + up[-1:] if lo else []
        return cls(d.get("title", ""), edges, d.get("yValues", []),
                   _style_from_dict(d, default_height=140))

    def render_html(self):
        w, h = self.style.width, self.style.height
        n = len(self.counts)
        if not n:
            return f'<div class="chart"><h3>{_esc(self.title)}</h3></div>'
        mx = max(max(self.counts), 1.0)
        bars = []
        for i, c in enumerate(self.counts):
            bh = (h - 24) * c / mx
            bars.append(
                f'<rect x="{i * w / n:.1f}" y="{h - 16 - bh:.1f}" '
                f'width="{max(w / n - 1, 1):.1f}" height="{bh:.1f}" '
                f'fill="{self.style.stroke_color}"/>')
        caption = (f"[{self.edges[0]:.4g}, {self.edges[-1]:.4g}]"
                   if self.edges else "")
        return (f'<div class="chart"><h3>{_esc(self.title)}</h3>'
                f'<svg width="{w}" height="{h}">{"".join(bars)}'
                f'<text x="4" y="{h - 3}" font-size="9" fill="#888">'
                f"{caption}</text></svg></div>")


class ChartScatter(Component):
    """Reference: ChartScatter — point cloud (t-SNE plots etc.)."""

    component_type = "ChartScatter"

    def __init__(self, title: str,
                 points: Sequence[Tuple[float, float]],
                 labels: Optional[Sequence[str]] = None,
                 style: Optional[StyleChart] = None):
        self.title = title
        self.points = [(float(x), float(y)) for x, y in points]
        self.labels = list(labels) if labels else None
        self.style = style or StyleChart(width=520, height=420)

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "x": [p[0] for p in self.points],
                "y": [p[1] for p in self.points],
                "labels": self.labels, "style": self.style.to_dict()}

    @classmethod
    def _from_dict(cls, d):
        return cls(d.get("title", ""),
                   list(zip(d.get("x", []), d.get("y", []))),
                   d.get("labels"),
                   _style_from_dict(d, default_width=520,
                                    default_height=420))

    def render_html(self):
        w, h = self.style.width, self.style.height
        if not self.points:
            return f'<div class="chart"><h3>{_esc(self.title)}</h3></div>'
        xs = [p[0] for p in self.points]
        ys = [p[1] for p in self.points]
        x0, x1, y0, y1 = min(xs), max(xs), min(ys), max(ys)
        sx = lambda x: 10 + (w - 20) * (x - x0) / max(x1 - x0, 1e-9)
        sy = lambda y: h - 10 - (h - 20) * (y - y0) / max(y1 - y0, 1e-9)
        parts = []
        for i, (x, y) in enumerate(self.points):
            parts.append(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="3" '
                         f'fill="{self.style.stroke_color}"/>')
            if self.labels and i < len(self.labels):
                parts.append(f'<text x="{sx(x) + 4:.1f}" y="{sy(y):.1f}" '
                             f'font-size="9">{_esc(self.labels[i])}</text>')
        return (f'<div class="chart"><h3>{_esc(self.title)}</h3>'
                f'<svg width="{w}" height="{h}">{"".join(parts)}</svg></div>')


class ComponentDiv(Component):
    """Reference: ComponentDiv — a container of child components."""

    component_type = "ComponentDiv"

    def __init__(self, children: Sequence[Component], title: str = ""):
        self.children = list(children)
        self.title = title

    def to_dict(self):
        return {"componentType": self.component_type, "title": self.title,
                "components": [c.to_dict() for c in self.children]}

    @classmethod
    def _from_dict(cls, d):
        return cls([Component.from_dict(c)
                    for c in d.get("components", [])], d.get("title", ""))

    def render_html(self):
        head = f"<h2>{_esc(self.title)}</h2>" if self.title else ""
        return ("<div>" + head
                + "".join(c.render_html() for c in self.children) + "</div>")


_REGISTRY = {
    c.component_type: c
    for c in (ComponentText, ComponentTable, ChartLine, ChartHistogram,
              ChartScatter, ComponentDiv)
}


def register_component(cls) -> type:
    """Add a Component subclass to the from_json dispatch (the DSL is
    open, like the reference's Component jackson subtypes)."""
    _REGISTRY[cls.component_type] = cls
    return cls

_CSS = """
 body { font-family: sans-serif; margin: 1.5em; background: #fafafa; }
 h1 { font-size: 1.3em; } h2 { font-size: 1.05em; color: #333;
   border-bottom: 1px solid #ddd; padding-bottom: 2px; }
 h3 { font-size: 0.9em; color: #444; margin: 0.2em 0; }
 .chart { background: #fff; border: 1px solid #ddd; margin: 0.5em;
          padding: 0.5em; display: inline-block; vertical-align: top; }
 table { border-collapse: collapse; background: #fff; }
 td, th { border: 1px solid #ccc; padding: 2px 8px; font-size: 0.85em; }
"""


def render_page(title: str, components: Sequence[Component]) -> str:
    """One fully self-contained HTML document (inline CSS + SVG, no
    scripts, no external assets) — the reference's standalone-report
    rendering path, server-free by construction."""
    body = "".join(c.render_html() for c in components)
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
        f"<body><h1>{_esc(title)}</h1>{body}</body></html>"
    )
