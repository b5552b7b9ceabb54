"""The port's report DSL and standalone report (ui/components.py,
ui/report.py) and the flow view against the JAX package's: the same
components render the same HTML string in both packages, the component
JSON crosses between them, the same storage gives the same report, and
model_graph is the same topology for a chain and a DAG."""

import json
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.ui import (
    ChartHistogram,
    ChartLine,
    ChartScatter,
    Component,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    FlowGraph,
    InMemoryStatsStorage,
    StatsListener,
    UIServer,
    render_page,
    render_training_report,
    write_training_report,
)
from deeplearning4j_tpu_torch.ui.components import StyleChart
from deeplearning4j_tpu_torch.ui.stats import model_graph


def _components(ns):
    """The same component list built from either package's classes."""
    custom = ns.StyleChart(width=800, height=300, stroke_color="#000000")
    return [
        ns.ComponentText("hello <b>", size=15, bold=True),
        ns.ComponentTable(["a", "b"], [[1, 2], [3, "<x>"]]),
        ns.ChartLine("scores", {"s": [(0, 1.0), (1, 0.5), (2, 0.25)],
                                "t": [(0, float("nan")), (1, 2.0), (2, 3.0)]}),
        ns.ChartLine("styled", {"s": [(0, 1.0), (1, 2.0)]}, style=custom),
        ns.ChartHistogram("w", [0.0, 0.5, 1.0], [3, 7]),
        ns.ChartHistogram("w2", [0.0, 1.0], [5], style=custom),
        ns.ChartScatter("pts", [(0.0, 1.0), (2.0, 3.0)], labels=["a", "b"], style=custom),
        ns.ComponentDiv([ns.ComponentText("inner")], title="box"),
        ns.FlowGraph({"nodes": [{"id": "a", "label": "a", "layer_index": 0},
                                {"id": "b", "label": "b\nDense"}],
                      "edges": [["a", "b"]]}, {"0": {"n_params": 5, "param_mean": 0.5}}),
    ]


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _jax_ns():
    from deeplearning4j_tpu.ui import components as jc
    from deeplearning4j_tpu.ui import report as jr

    return _NS(StyleChart=jc.StyleChart, ComponentText=jc.ComponentText,
               ComponentTable=jc.ComponentTable, ChartLine=jc.ChartLine,
               ChartHistogram=jc.ChartHistogram, ChartScatter=jc.ChartScatter,
               ComponentDiv=jc.ComponentDiv, FlowGraph=jr.FlowGraph, Component=jc.Component,
               render_page=jc.render_page)


PORT = _NS(StyleChart=StyleChart, ComponentText=ComponentText, ComponentTable=ComponentTable,
           ChartLine=ChartLine, ChartHistogram=ChartHistogram, ChartScatter=ChartScatter,
           ComponentDiv=ComponentDiv, FlowGraph=FlowGraph, Component=Component,
           render_page=render_page)


@pytest.mark.parametrize("i", range(9))
def test_component_renders_and_serializes_as_jax(i):
    jax_ns = _jax_ns()
    ours, theirs = _components(PORT)[i], _components(jax_ns)[i]
    assert ours.render_html() == theirs.render_html()
    assert ours.to_json() == theirs.to_json()
    # each package reads the other's JSON
    back = Component.from_json(theirs.to_json())
    assert type(back) is type(ours) and back.to_json() == ours.to_json()
    assert jax_ns.Component.from_json(ours.to_json()).to_json() == theirs.to_json()


def test_render_page_matches_jax_and_is_self_contained():
    html = render_page("t", _components(PORT))
    assert html == _jax_ns().render_page("t", _components(_jax_ns()))
    assert html.startswith("<!doctype html>") and "hello &lt;b&gt;" in html
    assert "http://" not in html and "https://" not in html and "src=" not in html


def test_render_page_escapes_text():
    html = render_page("t", [ComponentText("<script>alert(1)</script>"),
                             ChartLine("s", {"a": [(0, 1.0), (1, 2.0)]})])
    assert "<script>alert(1)</script>" not in html
    assert "&lt;script&gt;" in html and "<svg" in html


def test_unknown_component_type_is_rejected_as_jax():
    from deeplearning4j_tpu.ui.components import Component as JComponent

    bad = json.dumps({"componentType": "Nope"})
    for cls in (Component, JComponent):
        with pytest.raises((ValueError, KeyError)):
            cls.from_json(bad)


# -- the report from a storage ---------------------------------------------------

def _mlp(ns_conf, MLN, **kw):
    conf = (ns_conf.NeuralNetConfiguration.builder().seed(3)
            .updater("adam").learning_rate(0.05).list()
            .layer(ns_conf.DenseLayer(n_out=12, activation="relu"))
            .layer(ns_conf.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(ns_conf.InputType.feed_forward(6)).build())
    return MLN(conf, **kw).init()


def _trained_storage(histograms=True):
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = _mlp(tconf, MultiLayerNetwork, device="cpu")
    storage = InMemoryStatsStorage()
    net.set_collect_stats(True)
    net.set_listeners(StatsListener(storage, session_id="sess-report",
                                    histogram_bins=16 if histograms else 0,
                                    histogram_frequency=2))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    y = np.zeros((64, 3), np.float32)
    y[np.arange(64), rng.integers(0, 3, 64)] = 1.0
    net.fit(x, y, batch_size=16, epochs=3, async_prefetch=False)
    return storage


def test_training_report_artifact(tmp_path):
    storage = _trained_storage()
    out = str(tmp_path / "report.html")
    assert write_training_report(storage, out, title="run 42") == out
    html = open(out).read()
    for piece in ("run 42", "score vs iteration", "<svg", "per-layer mean magnitudes",
                  "parameter histograms", "model flow", "DenseLayer"):
        assert piece in html, piece
    assert "http" not in html.replace("http-equiv", "")


def test_training_report_equals_jax_for_the_same_storage(tmp_path):
    """The port's run's records in each package's store give the same HTML
    file (the "started" time is the record's own, so nothing to mask)."""
    from deeplearning4j_tpu.ui import InMemoryStatsStorage as JS
    from deeplearning4j_tpu.ui.report import write_training_report as jwrite

    src = _trained_storage()
    j = JS()
    j.put_static_info("sess-report", src.get_static_info("sess-report"))
    for u in src.get_updates("sess-report"):
        j.put_update("sess-report", u)
    ours, theirs = str(tmp_path / "port.html"), str(tmp_path / "jax.html")
    write_training_report(src, ours, title="t")
    jwrite(j, theirs, title="t")
    assert open(ours).read() == open(theirs).read()


def test_report_empty_storage(tmp_path):
    from deeplearning4j_tpu.ui import InMemoryStatsStorage as JS
    from deeplearning4j_tpu.ui.report import render_training_report as jrender

    out = str(tmp_path / "empty.html")
    write_training_report(InMemoryStatsStorage(), out)
    assert "no sessions" in open(out).read()
    assert render_training_report(InMemoryStatsStorage()) == jrender(JS())


# -- model graph + flow route -------------------------------------------------

def test_model_graph_mln_chain_matches_jax():
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.ui.stats import model_graph as jgraph
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    g = model_graph(_mlp(tconf, MultiLayerNetwork, device="cpu"))
    assert g == jgraph(_mlp(jconf, JMLN))
    assert [n["id"] for n in g["nodes"]] == ["input", "layer0", "layer1"]
    assert g["edges"] == [["input", "layer0"], ["layer0", "layer1"]]


def test_model_graph_compgraph_dag_matches_jax():
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
    from deeplearning4j_tpu.ui.stats import model_graph as jgraph
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph

    def build(ns):
        return (ns.NeuralNetConfiguration.builder().graph_builder()
                .add_inputs("in")
                .add_layer("a", ns.DenseLayer(n_out=4, activation="tanh"), "in")
                .add_layer("b", ns.DenseLayer(n_out=4, activation="tanh"), "in")
                .add_vertex("m", ns.MergeVertex(), "a", "b")
                .add_layer("out", ns.OutputLayer(n_out=2, activation="softmax"), "m")
                .set_outputs("out")
                .set_input_types(ns.InputType.feed_forward(3)).build())

    g = model_graph(ComputationGraph(build(tconf), device="cpu").init())
    assert g == jgraph(JCG(build(jconf)).init())
    assert ["a", "m"] in g["edges"] and ["b", "m"] in g["edges"]
    assert {"a", "b", "out"} <= {n["id"] for n in g["nodes"] if "layer_index" in n}


def test_flow_route_serves_graph_svg():
    storage = _trained_storage(histograms=False)
    server = UIServer(storage, port=0, device="cpu")
    port = server.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/train/flow/data") as r:
            d = json.loads(r.read())
        assert d["graph"]["edges"] == [["input", "layer0"], ["layer0", "layer1"]]
        assert d["svg"] and "<svg" in d["svg"] and "DenseLayer" in d["svg"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/train/flow") as r:
            assert "flow" in r.read().decode()
    finally:
        server.stop()
