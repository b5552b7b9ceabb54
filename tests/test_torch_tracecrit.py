"""The port's trace critical-path readout (analysis/tracecrit.py, its own
copy of the JAX module) against the JAX package's: the same `analyze`
report and rendering on a synthetic span export (nesting, an async child
that overhangs its closed parent, a parent that aged out of the ring, a
parent-id cycle, instant markers, a corrupt line), and on the export of
a port `TracingListener` fit, which the port's utils/tracing writes in
the JAX format."""

import json

import numpy as np

from deeplearning4j_tpu.analysis import tracecrit as jax_tracecrit
from deeplearning4j_tpu_torch.analysis import tracecrit


def _ev(trace, sid, name, ts, dur, parent=None, ph="X", **args):
    ev = {"name": name, "ph": ph, "trace": trace, "id": sid, "ts": ts,
          "dur": dur, "args": args}
    if parent is not None:
        ev["parent"] = parent
    return ev


def _synthetic_jsonl() -> str:
    evs = [
        # a request: admission, then a queue hop whose dispatch overhangs
        # the closed admission span, then the forward under it
        _ev("t" * 32, 1, "serve/request", 0.0, 100.0),
        _ev("t" * 32, 2, "serve/admit", 5.0, 10.0, parent=1),
        _ev("t" * 32, 3, "serve/dispatch", 40.0, 120.0, parent=1, bucket=8),
        _ev("t" * 32, 4, "serve/forward", 60.0, 90.0, parent=3),
        _ev("t" * 32, 5, "fault/injected", 70.0, 0.0, parent=4, ph="i"),
        # fork-join children: only the latest-finishing chain is critical
        _ev("a" * 32, 10, "fit/step", 0.0, 50.0),
        _ev("a" * 32, 11, "fit/data_wait", 0.0, 10.0, parent=10),
        _ev("a" * 32, 12, "fit/dispatch", 10.0, 30.0, parent=10),
        _ev("a" * 32, 13, "fit/prefetch", 5.0, 20.0, parent=10),
        _ev("a" * 32, 14, "fit/books", 40.0, 9.0, parent=10),
        # the remote half of a trace: its parent is not in the export
        _ev("b" * 32, 20, "remote/child", 3.0, 7.0, parent=999),
        # a parent-id cycle (a corrupt merge) must not recurse forever
        _ev("c" * 32, 30, "loop/a", 0.0, 5.0, parent=31),
        _ev("c" * 32, 31, "loop/b", 1.0, 3.0, parent=30),
        # no trace id: dropped
        {"name": "legacy", "ph": "X", "id": 40, "ts": 0.0, "dur": 1.0},
    ]
    lines = [json.dumps(e) for e in evs]
    lines.insert(3, '{"name": "torn li')  # a writer raced mid-line
    lines.insert(5, "")
    return "\n".join(lines) + "\n"


def test_synthetic_export_reports_alike():
    text = _synthetic_jsonl()
    events = tracecrit.parse_jsonl(text)
    assert events == jax_tracecrit.parse_jsonl(text)
    assert tracecrit.group_traces(events) == jax_tracecrit.group_traces(events)
    for kw in ({}, {"top": 2}, {"trace_id": "tttt"}, {"trace_id": "zz"}):
        got = tracecrit.analyze(events, **kw)
        ref = jax_tracecrit.analyze(events, **kw)
        assert got == ref, kw
        assert tracecrit.format_report(got) == jax_tracecrit.format_report(ref)
    full = tracecrit.analyze(events, top=10)
    assert full["n_traces"] == 4
    req = next(t for t in full["traces"] if t["trace_id"] == "t" * 32)
    # the path follows the queue hop past the closed admission span
    assert [s["name"] for s in req["critical_path"]] == [
        "serve/request", "serve/admit", "serve/dispatch", "serve/forward"]
    assert req["duration_us"] == 160.0 and req["markers"] == ["fault/injected"]
    step = next(t for t in full["traces"] if t["trace_id"] == "a" * 32)
    assert [s["name"] for s in step["critical_path"]] == [
        "fit/step", "fit/data_wait", "fit/dispatch", "fit/books"]
    assert abs(step["critical_path_us"] - 50.0) < 1e-9


def test_tracing_listener_export_reports_alike(tmp_path):
    """A port fit under TracingListener exports the JAX JSONL format;
    both analyzers give the same report and rendering, and every step is
    its own trace rooted at fit/step (each batch's pull, `fit/data_wait`,
    precedes its step: a root of its own)."""
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.listeners import TracingListener
    from deeplearning4j_tpu_torch.utils import tracing

    conf = (NeuralNetConfiguration.builder().seed(1).updater(Updater.SGD)
            .learning_rate(0.1).list()
            .layer(DenseLayer(n_in=4, n_out=6, activation="tanh"))
            .layer(OutputLayer(n_in=6, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]
    path = str(tmp_path / "fit_trace.jsonl")
    was = tracing.is_enabled()
    tracing.get_tracer().clear()
    try:
        net.set_listeners(TracingListener(path))
        net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
        net.set_listeners()
        tracing.get_tracer().write_jsonl(path)
    finally:
        tracing.enable(was)
        tracing.get_tracer().clear()
    with open(path) as f:
        text = f.read()
    events = tracecrit.parse_jsonl(text)
    assert events == jax_tracecrit.parse_jsonl(text)
    got = tracecrit.analyze(events, top=10)
    ref = jax_tracecrit.analyze(events, top=10)
    assert got == ref
    assert tracecrit.format_report(got) == jax_tracecrit.format_report(ref)
    assert got["n_traces"] >= 3
    assert {t["root"] for t in got["traces"]} == {"fit/step", "fit/data_wait"}
    for t in got["traces"]:
        if t["root"] == "fit/step":
            assert "fit/dispatch" in t["stage_self_us"]
