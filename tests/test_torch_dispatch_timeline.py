"""The fit loop's dispatch timeline and phase spans on the CPU.

utils/devprof's timeline (the card's time, input stall and host gap a
dispatch, from timing events that nothing waits on) driven through its
fit-loop hooks with stand-in events on a simulated stream, since the CPU
has no CUDA events; the tracer naming its spans to an active
torch.profiler capture with the tracer off, and stamping its exports on
the profiler's clock with it on; the fit loop's spans and a fused fit
under TracingListener; the benchmark's readers of the three histograms.
The card's own run of the timeline is tests/test_torch_dispatch_timeline_cuda.py.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import harness, readers
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train.listeners import TracingListener
from deeplearning4j_tpu_torch.utils import devprof, tracing
from deeplearning4j_tpu_torch.utils.metrics import get_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISTOGRAMS = ("fit_device_seconds", "fit_input_stall_seconds", "fit_host_gap_seconds")


# -- the dispatch timeline, on a simulated stream ----------------------------------


class _Stream:
    """A CUDA stream's clock in ms: what runs on it next starts at `now`."""

    def __init__(self):
        self.now = 0.0

    def wait_event(self, ev):
        self.now = max(self.now, ev.t)


class _Event:
    """A timing event on `_Stream`: complete once the card's progress
    (`done_at[0]`) has passed it."""

    done_at = [float("inf")]

    def __init__(self, t=None):
        self.t = t

    def record(self, stream=None):
        self.t = stream.now

    def query(self):
        time.sleep(0)  # let another thread in between a query and its use
        return self.t <= _Event.done_at[0]

    def elapsed_time(self, other):
        return other.t - self.t


class _Net:
    """What devprof reads of a CUDA net."""

    def __init__(self):
        self.device = torch.device("cuda")
        self.iteration = 0
        self.params_list = [{"w": torch.zeros(8)}]
        self.upd_state = None
        self._dispatch_timeline = None

    def model_flops_per_example(self):
        return 1000.0, "estimate"


class _Batch:
    _input_events = None


@pytest.fixture
def card(monkeypatch):
    """A simulated stream standing in for the card's current stream."""
    stream = _Stream()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing=False: _Event())
    monkeypatch.setattr(_Event, "done_at", [float("inf")])
    return stream


def _hists():
    reg = get_registry()
    out = {}
    for h in HISTOGRAMS:
        fam = reg.get(h)
        ch = fam.labels() if fam is not None else None
        out[h] = (ch.count, ch.sum) if ch is not None else (0, 0.0)
    return out


def _delta(a, b):
    return {h: (b[h][0] - a[h][0], b[h][1] - a[h][1]) for h in a}


def _dispatch(prof, net, stream, *, device_ms, gap_ms=0.0, copies=(), steps=1):
    """One dispatch as the fit loop runs it: its batches' waits on their
    copies (each done at the given card time), the host `gap_ms` late,
    then the dispatch's `device_ms` on the card. Returns the record."""
    batches = []
    for done in copies:
        b = _Batch()
        b._input_events = prof.timed_wait(stream, _Event(done), net.device)
        batches.append(b)
    stream.now += gap_ms
    rec = prof.begin_dispatch(net, batches)
    stream.now += device_ms
    net.iteration += steps
    prof.end_dispatch(net, rec, 8 * steps)
    prof.on_step(net, 8 * steps, None)
    return rec


def test_each_resolved_dispatch_splits_its_period_into_device_stall_and_gap(card):
    prof = devprof.DeviceProfiler(sample_every=0)
    net = _Net()
    h0 = _hists()
    _dispatch(prof, net, card, device_ms=10.0, copies=(0.0,))
    # the copy lands 4 ms after the last dispatch ended: a stall of 4
    _dispatch(prof, net, card, device_ms=10.0, copies=(card.now + 4.0,))
    # the host enqueues 3 ms late; two batches, one stalls 1 ms
    _dispatch(prof, net, card, device_ms=12.0, gap_ms=3.0,
              copies=(card.now + 1.0, 0.0), steps=2)
    d = _delta(h0, _hists())
    assert {n for n, _ in d.values()} == {3}  # one observation a dispatch
    assert d["fit_device_seconds"][1] == pytest.approx(0.032)
    # the first dispatch's copy was done before its wait began
    assert d["fit_input_stall_seconds"][1] == pytest.approx(0.005)
    assert d["fit_host_gap_seconds"][1] == pytest.approx(0.003)  # the first reads 0
    # device + stall + gap of the two dispatches with a period is their period
    period_s = (card.now - 10.0) * 1e-3
    assert (d["fit_device_seconds"][1] - 0.010 + d["fit_input_stall_seconds"][1]
            + d["fit_host_gap_seconds"][1]) == pytest.approx(period_s)
    [fit] = prof.recent_fits()
    assert fit["dispatches"] == fit["resolved"] == 3
    assert fit["device_seconds"] == pytest.approx(0.032)
    assert fit["input_stall_seconds"] == pytest.approx(0.005)
    assert fit["host_gap_seconds"] == pytest.approx(0.003)


def test_records_wait_for_their_events_and_a_fit_keeps_its_own_sums(card):
    """Nothing resolves before its E has completed; the fit's exit
    resolves what has and keeps the rest, which the next fit's first
    dispatch resolves into the fit it belongs to."""
    prof = devprof.DeviceProfiler(sample_every=0)
    net = _Net()
    _Event.done_at[0] = -1.0  # the card has finished nothing yet
    h0 = _hists()
    for _ in range(3):
        _dispatch(prof, net, card, device_ms=5.0)
    assert _delta(h0, _hists())["fit_device_seconds"][0] == 0
    _Event.done_at[0] = 10.0  # the first two dispatches have completed
    prof.end_fit(net)
    assert _delta(h0, _hists())["fit_device_seconds"][0] == 2
    _Event.done_at[0] = float("inf")
    _dispatch(prof, net, card, device_ms=7.0)  # the next fit's first
    first, second = prof.recent_fits()
    assert (first["dispatches"], first["resolved"]) == (3, 3)
    assert first["device_seconds"] == pytest.approx(0.015)
    assert (second["dispatches"], second["resolved"]) == (1, 1)
    assert second["device_seconds"] == pytest.approx(0.007)
    assert second["host_gap_seconds"] == 0.0  # a fit's first dispatch


def test_a_full_ring_leaves_a_dispatch_untimed_and_breaks_the_chain(card):
    prof = devprof.DeviceProfiler(sample_every=0)
    net = _Net()
    untimed = get_registry().counter("fit_dispatch_untimed_total", "").labels()
    u0 = untimed.value
    _Event.done_at[0] = -1.0
    for _ in range(devprof.PENDING_LIMIT):
        _dispatch(prof, net, card, device_ms=1.0)
    assert _dispatch(prof, net, card, device_ms=1.0) is None
    assert untimed.value == u0 + 1
    _Event.done_at[0] = float("inf")
    h0 = _hists()
    _dispatch(prof, net, card, device_ms=2.0, gap_ms=50.0)
    d = _delta(h0, _hists())
    assert d["fit_device_seconds"][0] == devprof.PENDING_LIMIT + 1
    # after the untimed dispatch the next has no period: no gap charged
    assert d["fit_host_gap_seconds"][1] == 0.0
    [fit] = prof.recent_fits()
    assert fit["dispatches"] == devprof.PENDING_LIMIT + 2
    assert fit["resolved"] == devprof.PENDING_LIMIT + 1


def test_the_step_gauges_read_the_cards_clock_over_the_sample_window(card, monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_FLOPS", "1e9")
    prof = devprof.DeviceProfiler(sample_every=2)
    net = _Net()
    gauge = get_registry().gauge("step_device_seconds").labels()
    s0 = get_registry().counter("devprof_samples_total").labels().value
    _dispatch(prof, net, card, device_ms=1.0)
    # two periods of 2 + 4 ms, 2 steps each: 1.5 ms a step
    _dispatch(prof, net, card, device_ms=1.0, gap_ms=1.0, steps=2)
    _dispatch(prof, net, card, device_ms=3.0, gap_ms=1.0, steps=2)
    assert get_registry().counter("devprof_samples_total").labels().value == s0 + 1
    assert gauge.value == pytest.approx(1.5e-3)
    fps = 1000.0 * 32 / 6e-3
    assert get_registry().gauge("step_flops_per_second", "", ("source",)).labels(
        "estimate").value == pytest.approx(fps)


def test_readers_on_other_threads_resolve_each_record_once(card):
    """recent_fits() resolves from any thread while the fit thread
    dispatches: every record is observed exactly once."""
    import sys
    import threading

    prof = devprof.DeviceProfiler(sample_every=4)
    net = _Net()
    stop = threading.Event()

    errors = []

    def reader():
        try:
            while not stop.is_set():
                prof.recent_fits()
        except Exception as e:  # a lost race surfaces here
            errors.append(e)

    readers_ = [threading.Thread(target=reader) for _ in range(8)]
    h0 = _hists()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in readers_:
            t.start()
        for _ in range(300):
            _dispatch(prof, net, card, device_ms=1.0, copies=(card.now + 0.5,))
    finally:
        stop.set()
        for t in readers_:
            t.join(timeout=10)
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in readers_)
    assert errors == []
    [fit] = prof.recent_fits()
    assert fit["dispatches"] == fit["resolved"] == 300
    d = _delta(h0, _hists())
    assert d["fit_device_seconds"] == (300, pytest.approx(0.3))
    assert d["fit_input_stall_seconds"] == (300, pytest.approx(0.15))


def test_a_cpu_net_has_no_timeline():
    net = MultiLayerNetwork(_conf(), device="cpu").init()
    prof = devprof.DeviceProfiler(sample_every=0)
    assert prof.begin_dispatch(net, []) is None
    prof.end_dispatch(net, None, 8)
    h0 = _hists()
    net.fit(*_xy(), batch_size=8, async_prefetch=False)
    assert net._dispatch_timeline is None
    assert _delta(h0, _hists())["fit_device_seconds"][0] == 0


# -- spans and the profiler -------------------------------------------------------


def _profiled(fn):
    """Run fn under a CPU torch.profiler capture: its raw host events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()]


def test_a_span_names_an_active_profiler_with_the_tracer_off():
    assert not tracing.is_enabled()
    tracer = tracing.get_tracer()
    n0 = len(tracer.recent())

    def work():
        with tracing.span("fit/launch", mode="replay"):
            torch.ones(4).sum()

    names = [n for n, _ in _profiled(work)]
    assert "fit/launch" in names
    assert len(tracer.recent()) == n0  # the ring buffer records nothing


def test_outside_a_profiler_a_span_is_the_null_span_and_cheap():
    assert not tracing.is_enabled()
    assert tracing.span("fit/step") is tracing.NULL_SPAN
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tracing.span("fit/step"):
            pass
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 10e-6, f"{per_call * 1e6:.2f} us a span"


def test_exports_stamp_ts_on_the_profilers_clock():
    tracer = tracing.get_tracer()
    was = tracing.is_enabled()
    tracer.clear()
    tracing.enable(True)
    try:
        def work():
            with tracing.span("clock/probe"):
                time.sleep(0.002)

        events = _profiled(work)
    finally:
        tracing.enable(was)
    start_us = [s for n, s in events if n == "clock/probe"][0] * 1e-3
    [line] = [json.loads(l) for l in tracer.to_jsonl().splitlines()
              if json.loads(l)["name"] == "clock/probe"]
    [chrome] = [e for e in tracer.to_chrome_trace()["traceEvents"]
                if e["name"] == "clock/probe"]
    tracer.clear()
    assert abs(line["ts"] - start_us) < 250
    assert abs(chrome["ts"] - start_us) < 250


def _conf():
    return (NeuralNetConfiguration.builder().seed(3).updater("sgd")
            .learning_rate(0.1).list()
            .layer(DenseLayer(n_out=6, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())


def _xy(n=16):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def test_a_fused_fit_keeps_its_path_under_the_tracing_listener(tmp_path, monkeypatch):
    """TracingListener is fusion-safe: set_fused_steps(2) still groups the
    batches, one `iteration` instant a dispatch carries its first
    iteration and its steps, and the host prefetch thread's pulls are
    spans too."""
    jsonl = str(tmp_path / "fit.jsonl")
    net = MultiLayerNetwork(_conf(), device="cpu").init().set_fused_steps(2)
    fused = []
    run_fused = net._run_fused
    monkeypatch.setattr(net, "_run_fused",
                        lambda *a, **k: fused.append(a[2]) or run_fused(*a, **k))
    net.set_listeners(TracingListener(jsonl_path=jsonl))
    tracing.get_tracer().clear()
    net.fit(*_xy(16), batch_size=4, async_prefetch=True)
    assert not tracing.is_enabled()
    lines = [json.loads(l) for l in open(jsonl)]
    tracing.get_tracer().clear()
    assert fused == [2, 2]
    marks = [e["args"] for e in lines if e["name"] == "iteration"]
    assert marks == [{"iteration": 0, "steps": 2}, {"iteration": 2, "steps": 2}]
    names = [e["name"] for e in lines]
    assert names.count("fit/launch") == 2 and names.count("fit/collect") == 2
    assert "prefetch/host_next" in names and "prefetch/stage" in names


# -- the benchmark's readers --------------------------------------------------------


READERS = [(f"{base}.{kind}", hist)
           for base, hist in (("dispatch_device_ms", "fit_device_seconds"),
                              ("input_stall_ms", "fit_input_stall_seconds"),
                              ("host_gap_ms", "fit_host_gap_seconds"))
           for kind in ("images", "tokens")]

_FITS = [  # the set-up's fits, the timed window's (4 dispatches), the traced one's
    {"fit": 1, "dispatches": 1, "resolved": 1, "device_seconds": 9.0,
     "input_stall_seconds": 9.0, "host_gap_seconds": 0.0},
    {"fit": 2, "dispatches": 4, "resolved": 4, "device_seconds": 0.040,
     "input_stall_seconds": 0.008, "host_gap_seconds": 0.002},
    {"fit": 3, "dispatches": 2, "resolved": 2, "device_seconds": 0.5,
     "input_stall_seconds": 0.5, "host_gap_seconds": 0.5},
]
_WANT_MS = {"fit_device_seconds": 10.0, "fit_input_stall_seconds": 2.0,
            "fit_host_gap_seconds": 0.5}


def _reading(spec, registry):
    r = readers.Reading(spec=spec, cfg={}, traffic={}, ref=None, device_name="cpu")
    r.registry = dict(registry)
    return r


@pytest.mark.parametrize("metric,hist", READERS)
def test_the_dispatch_timeline_readers(metric, hist, monkeypatch):
    spec = harness.Spec(ROOT)
    assert any(m["name"] == metric for m in spec.data["per_layer"])
    read = spec.reader(metric).read
    window = {"fit_dispatch_seconds": (4, 0.8)}
    # an empty registry (a CPU run: the histograms stay empty)
    assert read(_reading(spec, {})) is None
    monkeypatch.setattr(devprof, "recent_fits", lambda: [dict(f) for f in _FITS])
    # the window's fit, matched by its dispatches
    assert read(_reading(spec, window)) == pytest.approx(_WANT_MS[hist])
    # a window no fit matches, and a histogram with no observation
    assert read(_reading(spec, {"fit_dispatch_seconds": (5, 1.0)})) is None
    assert read(_reading(spec, {**window, hist: (0, 0.0)})) is None
    # a registry that holds the histogram already is read as it is
    assert read(_reading(spec, {**window, hist: (2, 0.010)})) == pytest.approx(5.0)
    # a port without the timeline gives nothing to read
    monkeypatch.delattr(devprof, "recent_fits")
    assert read(_reading(spec, window)) is None
