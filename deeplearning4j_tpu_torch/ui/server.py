"""Training dashboard HTTP server.

Reference: PlayUIServer (deeplearning4j-play, runnable with --uiPort) +
TrainModule route table (module/train/TrainModule.java:96-112):
/train -> overview, /train/overview(/data), /train/model(/graph,
/data/:layerId), /train/system(/data), /train/sessions/current|all; the
RemoteReceiverModule accepts stats POSTed from remote training processes.

Self-contained stdlib implementation: JSON data routes consumed by an
inline HTML/SVG dashboard (no external assets — the box it runs on may
have zero egress), polling /train/overview/data every 2s.

The port of the JAX package's ui/server.py: the same routes, page and
JSON. The t-SNE tab's `/tsne/compute` runs the port's Tsne on the
server's `device` ("cuda" when None); the system page charts the port's
registry gauges under the JAX package's family names.
"""

from __future__ import annotations

import json
import struct
from typing import Optional
from urllib.parse import urlparse

from deeplearning4j_tpu_torch.ui.codec import decode_record
from deeplearning4j_tpu_torch.ui.stats import split_stat_key
from deeplearning4j_tpu_torch.ui.storage import StatsStorage
from deeplearning4j_tpu_torch.utils.jsonhttp import (
    JsonHttpServer,
    html_response,
    json_response,
)


_PAGE = """<!doctype html>
<html><head><title>dl4j-tpu training UI</title>
<style>
 body {{ font-family: sans-serif; margin: 1.5em; background: #fafafa; }}
 h1 {{ font-size: 1.2em; }} h2 {{ font-size: 1em; color: #444; }}
 .chart {{ background: #fff; border: 1px solid #ddd; margin: 0.6em;
           padding: 0.4em; display: inline-block; }}
 nav a {{ margin-right: 1.2em; }}
 table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #ccc;
   padding: 2px 8px; font-size: 0.85em; }}
</style></head>
<body>
<nav><a href="/train/overview">overview</a><a href="/train/model">model</a>
<a href="/train/flow">flow</a>
<a href="/train/system">system</a><a href="/train/histogram">histogram</a>
<a href="/train/activations">activations</a><a href="/train/alerts">alerts</a>
<a href="/tsne">tsne</a></nav>
<h1>dl4j-tpu training — {title}</h1>
<div id="content">loading…</div>
<script>
const VIEW = "{view}";
function line(points, w, h, color) {{
  if (points.length < 2) return "<svg width="+w+" height="+h+"></svg>";
  const xs = points.map(p => p[0]), ys = points.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const sx = x => 4 + (w-8) * (x - x0) / Math.max(x1 - x0, 1e-9);
  const sy = y => h - 4 - (h-8) * (y - y0) / Math.max(y1 - y0, 1e-9);
  const d = points.map((p,i) => (i?"L":"M") + sx(p[0]).toFixed(1) + "," +
                                sy(p[1]).toFixed(1)).join(" ");
  return `<svg width=${{w}} height=${{h}}><path d="${{d}}" fill="none"
          stroke="${{color}}" stroke-width="1.5"/></svg>
          <div style="font-size:0.7em;color:#888">min ${{y0.toPrecision(4)}}
          max ${{y1.toPrecision(4)}}</div>`;
}}
function chart(title, pts, color) {{
  return `<div class="chart"><h2>${{title}}</h2>${{line(pts,380,160,color)}}</div>`;
}}
async function refresh() {{
  const r = await fetch("/train/" + VIEW + "/data");
  const d = await r.json();
  let html = "";
  if (VIEW == "overview") {{
    html += chart("score vs iteration", d.score, "#1565c0");
    html += chart("samples/sec", d.samples_per_sec, "#2e7d32");
    html += chart("update:param ratio (log10)", d.update_ratio, "#c62828");
    html += chart("etl ms", d.etl_ms, "#6a1b9a");
  }} else if (VIEW == "model") {{
    for (const layer of d.layers) {{
      html += `<h2>layer ${{layer.index}} — ${{layer.type}}
               (${{layer.n_params}} params)</h2>`;
      for (const [name, pts] of Object.entries(layer.series))
        html += chart(name, pts, "#00695c");
    }}
  }} else if (VIEW == "histogram") {{
    html += `<p>iteration ${{d.iteration}}</p>`;
    for (const [name, h] of Object.entries(d.hists || {{}})) {{
      const n = h.counts.length, W = 380, H = 140;
      const mx = Math.max(...h.counts, 1);
      let bars = "";
      for (let i = 0; i < n; i++) {{
        const bh = (H - 20) * h.counts[i] / mx;
        bars += `<rect x=${{(i * W / n).toFixed(1)}} y=${{(H - bh).toFixed(1)}}
                 width=${{(W / n - 1).toFixed(1)}} height=${{bh.toFixed(1)}}
                 fill="#1565c0"/>`;
      }}
      html += `<div class="chart"><h2>${{name}}</h2>
        <svg width=${{W}} height=${{H}}>${{bars}}</svg>
        <div style="font-size:0.7em;color:#888">
        [${{h.edges[0].toPrecision(3)}}, ${{h.edges[n].toPrecision(3)}}]
        </div></div>`;
    }}
  }} else if (VIEW == "activations") {{
    const a = d.activations;
    if (!a) {{ html = "no activation frames yet"; }}
    else {{
      html += `<p>layer ${{a.layer}}, iteration ${{d.iteration}}</p>`;
      a.channels.forEach((ch, ci) => {{
        const h = ch.length, w = ch[0].length, S = 4;
        html += `<canvas id="act${{ci}}" width=${{w * S}} height=${{h * S}}
                 style="border:1px solid #ddd;margin:4px"></canvas>`;
      }});
      setTimeout(() => a.channels.forEach((ch, ci) => {{
        const h = ch.length, w = ch[0].length, S = 4;
        const ctx = document.getElementById("act" + ci).getContext("2d");
        for (let y = 0; y < h; y++) for (let x = 0; x < w; x++) {{
          const v = Math.round(255 * ch[y][x]);
          ctx.fillStyle = `rgb(${{v}},${{v}},${{v}})`;
          ctx.fillRect(x * S, y * S, S, S);
        }}
      }}), 0);
    }}
  }} else if (VIEW == "flow") {{
    html += `<div class="chart">${{d.svg || "(no graph yet)"}}</div>`;
  }} else if (VIEW == "alerts") {{
    if (!d.ledger) {{
      html += `<p>${{d.note || "no run ledger attached"}}</p>`;
    }} else {{
      html += `<p>run <code>${{d.run_id}}</code> — ledger
               <code>${{d.ledger}}</code></p>`;
      html += "<table><tr><th>rule</th><th>state</th><th>severity</th>"
            + "<th>value</th><th>definition</th></tr>";
      for (const r of d.rules || []) {{
        const color = r.state == "firing" ? "#c62828"
                    : r.state == "pending" ? "#ef6c00" : "#2e7d32";
        html += `<tr><td>${{r.rule}}</td>
                 <td style="color:${{color}}"><b>${{r.state}}</b></td>
                 <td>${{r.severity}}</td><td>${{r.value ?? ""}}</td>
                 <td>${{r.detail}}</td></tr>`;
      }}
      html += "</table>";
      if ((d.transitions || []).length) {{
        html += "<h2>recent transitions</h2><table>"
              + "<tr><th>ts</th><th>rule</th><th>to</th><th>value</th></tr>";
        for (const t of d.transitions.slice(-20).reverse())
          html += `<tr><td>${{t.ts}}</td><td>${{t.rule}}</td>
                   <td>${{t.to}}</td><td>${{t.value ?? ""}}</td></tr>`;
        html += "</table>";
      }}
    }}
  }} else if (VIEW == "tsne") {{
    const W = 760, H = 560;
    let pts = "";
    if (d.coords && d.coords.length) {{
      const xs = d.coords.map(c => c[0]), ys = d.coords.map(c => c[1]);
      const x0 = Math.min(...xs), x1 = Math.max(...xs);
      const y0 = Math.min(...ys), y1 = Math.max(...ys);
      d.coords.forEach((c, i) => {{
        const px = 20 + (W - 40) * (c[0] - x0) / Math.max(x1 - x0, 1e-9);
        const py = 20 + (H - 40) * (c[1] - y0) / Math.max(y1 - y0, 1e-9);
        pts += `<circle cx=${{px.toFixed(1)}} cy=${{py.toFixed(1)}} r=3
                fill="#1565c0"/>`;
        if (d.words && d.words[i])
          pts += `<text x=${{(px + 5).toFixed(1)}} y=${{py.toFixed(1)}}
                  font-size="10">${{d.words[i]}}</text>`;
      }});
    }}
    html += `<div class="chart"><h2>t-SNE (${{(d.coords || []).length}}
             points)</h2><svg width=${{W}} height=${{H}}>${{pts}}</svg></div>`;
  }} else {{
    html += "<table><tr><th>key</th><th>value</th></tr>";
    for (const [k,v] of Object.entries(d.static || {{}}))
      html += `<tr><td>${{k}}</td><td>${{JSON.stringify(v)}}</td></tr>`;
    html += "</table>";
    for (const [dev, pts] of Object.entries(d.memory || {{}}))
      html += chart(dev + " bytes in use", pts, "#ef6c00");
    for (const [name, pts] of Object.entries(d.live || {{}}))
      html += chart(name, pts, "#00838f");
  }}
  document.getElementById("content").innerHTML = html;
}}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


class UIServer:
    """UIServer(storage, port=9090).start() -> bound port."""

    _instance = None

    def __init__(self, storage: StatsStorage, port: int = 9090, device=None):
        self.storage = storage
        # where /tsne/compute runs; resolved at the request, so a
        # dashboard over a stats file opens on a host without a GPU
        self.device = device
        self._tsne = {"words": [], "coords": []}
        # live registry gauge history for the system view: sampled once
        # per /train/system/data poll (the dashboard's own 2s cadence —
        # no extra thread), bounded per series. This is what makes the
        # devprof headline gauges (step_mfu, step_flops_per_second,
        # device_memory_bytes{kind}) and the serving queue depth visible
        # in the UI instead of only in a Prometheus scrape.
        self._sys_hist: dict = {}
        self._sys_t0 = None
        # JsonHttpServer handles requests on multiple threads: the
        # history dict is mutated per poll and must not be iterated
        # concurrently with an insert
        import threading

        self._sys_lock = threading.Lock()
        self._server = JsonHttpServer(get=self._get, post=self._post,
                                      port=port)

    @property
    def port(self) -> int:
        return self._server.port

    @classmethod
    def get_instance(cls, storage: Optional[StatsStorage] = None,
                     port: int = 9090, device=None) -> "UIServer":
        """Singleton accessor (reference: UIServer.getInstance())."""
        if cls._instance is None:
            from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage

            cls._instance = cls(storage or InMemoryStatsStorage(), port, device)
            cls._instance.start()
        return cls._instance

    # -- data assembly -------------------------------------------------------

    def _current_session(self) -> Optional[str]:
        return self.storage.latest_session_id()

    def _score_updates(self, session: Optional[str]) -> list:
        """Training-progress records only — the stream also carries
        activation frames (ConvolutionalIterationListener) without a
        score."""
        ups = self.storage.get_updates(session) if session else []
        return [u for u in ups if "score" in u]

    def _overview_data(self, session: Optional[str]) -> dict:
        ups = self._score_updates(session)
        import math

        def ratio(u):
            um, pm = u.get("update_mm"), u.get("param_mm")
            if not um or not pm:
                return None
            us = sum(um.values()) / max(len(um), 1)
            ps = sum(pm.values()) / max(len(pm), 1)
            if us <= 0 or ps <= 0:
                return None
            return math.log10(us / ps)

        return {
            "session": session,
            "score": [[u["iteration"], u["score"]] for u in ups],
            "samples_per_sec": [
                [u["iteration"], u["samples_per_sec"]] for u in ups],
            "etl_ms": [[u["iteration"], u["etl_ms"]] for u in ups],
            "update_ratio": [
                [u["iteration"], r] for u in ups
                if (r := ratio(u)) is not None],
        }

    def _histogram_data(self, session: Optional[str]) -> dict:
        """Newest parameter-histogram record (HistogramModule analog)."""
        for u in reversed(self._score_updates(session)):
            if "hists" in u:
                return {"session": session, "iteration": u["iteration"],
                        "hists": u["hists"]}
        return {"session": session, "iteration": None, "hists": {}}

    def _activations_data(self, session: Optional[str]) -> dict:
        """Newest conv-activation frame (ConvolutionalListenerModule)."""
        ups = self.storage.get_updates(session) if session else []
        for u in reversed(ups):
            if "activations" in u:
                return {"session": session, "iteration": u["iteration"],
                        "activations": u["activations"]}
        return {"session": session, "iteration": None, "activations": None}

    def _model_data(self, session: Optional[str]) -> dict:
        ups = self._score_updates(session)
        static = (self.storage.get_static_info(session) or {}) if session else {}
        layers = []
        for meta in static.get("layers", []):
            li = meta["index"]
            series = {}
            for group, label in (("grad_mm", "grad"), ("update_mm", "update"),
                                 ("param_mm", "param")):
                for u in ups:
                    g = u.get(group) or {}
                    for k, v in g.items():
                        kli, pname = split_stat_key(k)
                        if kli == str(li):
                            series.setdefault(
                                f"{label} |{pname}|", []
                            ).append([u["iteration"], v])
            layers.append({**meta, "series": series})
        return {"session": session, "layers": layers}

    # registry families charted on the system page (exact family names;
    # every labeled child becomes its own series)
    _SYSTEM_GAUGES = ("step_mfu", "step_flops_per_second",
                      "step_device_seconds", "device_memory_bytes",
                      "serving_queue_depth")

    def _sample_system_gauges(self) -> dict:
        """Append the live devprof/serving gauges to the bounded
        per-series history and return {series: [[t, v], ...]} — called
        from the data route, so history advances at the dashboard's own
        poll cadence and costs nothing when nobody is watching."""
        import time

        from deeplearning4j_tpu_torch.utils.metrics import get_registry

        try:
            scalars = get_registry().scalar_values()
        except Exception:
            scalars = {}
        with self._sys_lock:
            if self._sys_t0 is None:
                self._sys_t0 = time.time()
            t = round(time.time() - self._sys_t0, 1)
            for key, v in scalars.items():
                if key.split("{")[0] in self._SYSTEM_GAUGES:
                    hist = self._sys_hist.setdefault(key, [])
                    hist.append([t, v])
                    del hist[:-300]  # bounded: ~10 min at the 2s poll
            return {k: list(v) for k, v in self._sys_hist.items()}

    def _system_data(self, session: Optional[str]) -> dict:
        ups = self.storage.get_updates(session) if session else []
        static = (self.storage.get_static_info(session) or {}) if session else {}
        memory = {}
        for u in ups:
            for dev, m in (u.get("memory") or {}).items():
                memory.setdefault(dev, []).append(
                    [u["iteration"], m.get("bytes_in_use", 0)])
        return {"session": session, "static": static, "memory": memory,
                "live": self._sample_system_gauges()}

    def _alerts_data(self) -> dict:
        """Live SLO rule states from the attached run ledger (the same
        payload as the inference server's GET /alerts)."""
        from deeplearning4j_tpu_torch.utils import runledger

        led = runledger.current()
        if led is None:
            return {"ledger": None, "rules": [], "firing": [],
                    "transitions": [],
                    "note": "no run ledger attached — pass "
                            "run_ledger= to fit()/the server, or "
                            "attach one via utils.runledger"}
        return led.alert_status()

    # -- http ----------------------------------------------------------------

    def _get(self, path, body, headers):
        path = urlparse(path).path.rstrip("/") or "/train/overview"
        session = self._current_session()
        pages = {"/train": "overview", "/train/overview": "overview",
                 "/train/model": "model", "/train/system": "system",
                 "/train/histogram": "histogram",
                 "/train/activations": "activations",
                 "/train/flow": "flow",
                 "/train/alerts": "alerts",
                 "/tsne": "tsne", "/train/tsne": "tsne"}
        if path in pages:
            view = pages[path]
            return html_response(_PAGE.format(title=view, view=view))
        if path == "/train/overview/data":
            return json_response(self._overview_data(session))
        if path == "/train/histogram/data":
            return json_response(self._histogram_data(session))
        if path == "/train/activations/data":
            return json_response(self._activations_data(session))
        if path in ("/train/tsne/data", "/tsne/data"):
            return json_response(self._tsne)
        if path == "/train/model/data":
            return json_response(self._model_data(session))
        if path == "/train/flow/data":
            # flow view (reference: FlowListenerModule): the model DAG
            # rendered server-side by the report DSL's FlowGraph with
            # per-layer latest stats overlaid
            from deeplearning4j_tpu_torch.ui.report import (
                FlowGraph,
                _layer_stats_latest,
            )

            static = (self.storage.get_static_info(session) or {}
                      ) if session else {}
            ups = self._score_updates(session)
            graph = static.get("graph") or {}
            svg = (FlowGraph(graph, _layer_stats_latest(ups, static))
                   .render_html() if graph else None)
            return json_response({"session": session, "graph": graph,
                                  "svg": svg})
        if path == "/train/model/graph":
            st = (self.storage.get_static_info(session) or {}
                  ) if session else {}
            return json_response({"layers": st.get("layers", [])})
        if path == "/train/system/data":
            return json_response(self._system_data(session))
        if path == "/train/alerts/data":
            return json_response(self._alerts_data())
        if path == "/train/sessions/current":
            return json_response({"session": session})
        if path == "/train/sessions/all":
            return json_response(
                {"sessions": self.storage.list_session_ids()})
        return None

    def _post(self, path, body, headers):
        # remote receiver (reference: RemoteReceiverModule) + t-SNE upload
        # (reference: TsneModule POST /tsne/upload)
        session = headers.get("X-Session-Id", "remote")
        path = urlparse(path).path
        try:
            if path == "/remote/static":
                self.storage.put_static_info(session, json.loads(body))
            elif path == "/remote/update":
                self.storage.put_update(session, decode_record(body))
            elif path in ("/tsne/coords", "/tsne/upload"):
                import html

                req = json.loads(body)
                coords = [[float(a), float(b)] for a, b in req["coords"]]
                # words are interpolated into the page's innerHTML — escape
                # server-side so an unauthenticated poster can't plant XSS
                self._tsne = {"words": [html.escape(str(w))
                                        for w in req.get("words", [])],
                              "coords": coords}
            elif path == "/tsne/compute":
                # run the device t-SNE over posted vectors (the tab the
                # reference feeds from files; clustering/tsne.py does the
                # math here)
                import numpy as np

                from deeplearning4j_tpu_torch.clustering import Tsne

                req = json.loads(body)
                x = np.asarray(req["vectors"], np.float32)
                t = Tsne(n_components=2,
                         perplexity=float(req.get("perplexity", 20.0)),
                         n_iter=int(req.get("iters", 300)),
                         device=self.device)
                import html

                coords = t.fit_transform(x)
                self._tsne = {"words": [html.escape(str(w))
                                        for w in req.get("words", [])],
                              "coords": np.asarray(coords).tolist()}
            else:
                return None
            return json_response({"status": "ok"})
        except (ValueError, KeyError, IndexError, struct.error) as e:
            return json_response({"error": str(e)}, 400)

    def start(self) -> int:
        return self._server.start()

    def stop(self):
        self._server.stop()
        if UIServer._instance is self:
            UIServer._instance = None
