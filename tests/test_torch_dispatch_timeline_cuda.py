"""The fit loop's dispatch timeline on a Hopper GPU (`cuda` marker; each
test skips itself without one): a graphed fit synchronizes nothing, with
the tracer off and on; each resolved dispatch observes the card's time,
its input stall and its host gap once, and the three add up to its
period on the card; a graph's replay runs between the events the fit
loop records on the current stream; a staging copy slowed on the card
shows as input stall, a host that is late as host gap; and a fused fit
under TracingListener captures and replays its graph.

This file imports nothing of JAX: `python -m pytest --noconftest
tests/test_torch_dispatch_timeline_cuda.py` runs it where JAX is not
installed, and `-s` prints each case's figures.
"""

import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.models.resnet import tiny_resnet_conf
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.train.listeners import TracingListener
from deeplearning4j_tpu_torch.utils import devprof, tracing
from deeplearning4j_tpu_torch.utils.metrics import get_registry

HISTOGRAMS = ("fit_device_seconds", "fit_input_stall_seconds", "fit_host_gap_seconds")


@pytest.fixture(autouse=True)
def _card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    was = tracing.is_enabled()
    yield
    tracing.enable(was)
    tracing.get_tracer().clear()


def _resnet():
    return ComputationGraph(tiny_resnet_conf(), device="cuda").init().set_fused_steps(2)


def _resnet_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return DataSet(x, y)


def _lstm():
    return char_lstm_network(vocab_size=12, hidden=64, tbptt_length=10,
                             learning_rate=0.01, seed=3, device="cuda")


def _lstm_data(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, (n, 41))
    eye = np.eye(12, dtype=np.float32)
    return DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]])


# (make, data, batch): a dispatch is 2 batches of the conv net, or one
# TBPTT batch of 4 segments
NETS = {"tiny_resnet": (_resnet, _resnet_data, 4, 2),
        "tbptt_lstm": (_lstm, _lstm_data, 4, 1)}


def _hists():
    reg = get_registry()
    return {h: (reg.get(h).labels().count, reg.get(h).labels().sum)
            if reg.get(h) is not None else (0, 0.0) for h in HISTOGRAMS}


class _SyncCounter:
    """Counts torch.cuda.synchronize, Stream.synchronize and
    Event.synchronize calls while armed."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.armed = False
        for owner, name in ((torch.cuda, "synchronize"),
                            (torch.cuda.Stream, "synchronize"),
                            (torch.cuda.Event, "synchronize")):
            orig = getattr(owner, name)
            monkeypatch.setattr(owner, name, self._wrap(orig, name))

    def _wrap(self, orig, name):
        def wrapped(*a, **k):
            if self.armed:
                self.calls.append(name)
            return orig(*a, **k)
        return wrapped


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("kind", sorted(NETS))
def test_a_graphed_fit_synchronizes_nothing_and_times_every_dispatch(kind, traced, monkeypatch):
    make, data, batch, per_dispatch = NETS[kind]
    net = make()
    # the warm-up and the capture (a capture synchronizes, once a program)
    net.fit(ListDataSetIterator(data(2 * batch * per_dispatch), batch))
    counter = _SyncCounter(monkeypatch)
    n = 40
    tracing.enable(traced)
    h0 = _hists()
    counter.armed = True
    net.fit(ListDataSetIterator(data(n * batch * per_dispatch, seed=1), batch))
    counter.armed = False
    tracing.enable(False)
    assert counter.calls == []
    [g] = net.fit_graphs()
    assert g["replays"] >= n
    torch.cuda.synchronize()
    fit = devprof.recent_fits()[-1]
    assert fit["dispatches"] == fit["resolved"] == n
    counts = {h: _hists()[h][0] - h0[h][0] for h in HISTOGRAMS}
    # the previous fit's last records resolve in this one, and this fit's
    # last ones in recent_fits()
    assert len(set(counts.values())) == 1 and n <= counts[HISTOGRAMS[0]] <= n + 2
    print(kind, "traced" if traced else "untraced", fit)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(NETS))
def test_device_stall_and_gap_add_up_to_each_dispatchs_period(kind, monkeypatch):
    make, data, batch, per_dispatch = NETS[kind]
    net = make()
    net.fit(ListDataSetIterator(data(2 * batch * per_dispatch), batch))
    times = []
    orig = devprof.DeviceProfiler.dispatch_times

    def spy(rec):
        out = orig(rec)
        times.append(out)
        return out

    monkeypatch.setattr(devprof.DeviceProfiler, "dispatch_times", staticmethod(spy))
    net.fit(ListDataSetIterator(data(32 * batch * per_dispatch, seed=2), batch))
    torch.cuda.synchronize()
    devprof.recent_fits()
    periods = [t for t in times if t[3] is not None]
    assert len(periods) >= 30
    for device_s, stall_s, gap_s, period_s in periods:
        assert device_s > 0 and stall_s >= 0 and gap_s >= 0
        assert abs(device_s + stall_s + gap_s - period_s) <= 0.02 * period_s
    print(kind, "device, stall, gap, period (ms), the first 3:",
          [[round(1e3 * v, 4) for v in t] for t in periods[:3]])


@pytest.mark.cuda
def test_a_replay_runs_between_events_on_the_current_stream():
    """torch's CUDAGraph.replay launches on the current stream: two events
    recorded on it around a replay of a graph that sleeps on the card
    read at least the sleep."""
    cycles = 20_000_000  # about 10 ms at the H100's clocks
    side = torch.cuda.Stream()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1000)  # warm the sleep kernel off the capture
    torch.cuda.synchronize()
    with torch.cuda.graph(g, stream=side):
        torch.cuda._sleep(cycles)
    bare = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    cur = torch.cuda.current_stream()
    bare[0].record(cur)
    torch.cuda._sleep(cycles)
    bare[1].record(cur)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record(cur)
    g.replay()
    e.record(cur)
    torch.cuda.synchronize()
    slept = bare[0].elapsed_time(bare[1])
    print("sleep", slept, "ms; replay between events", s.elapsed_time(e), "ms")
    assert s.elapsed_time(e) >= 0.95 * slept > 1.0


class _SlowStaging:
    """An on-device transform that holds the staging stream `cycles` on
    the card before the batch is ready."""

    def __init__(self, cycles):
        self.cycles = cycles

    def __call__(self, ds):
        torch.cuda._sleep(self.cycles)
        return ds


class _LateHost(DataSetIterator):
    """Batches from `ds` in `batch`es, the host pausing `pause_s` before
    each from the `start`-th on."""

    def __init__(self, ds, batch, pause_s, start=2):
        self.inner = ListDataSetIterator(ds, batch)
        self.pause_s, self.start = pause_s, start

    def __iter__(self):
        for i, b in enumerate(self.inner):
            if i >= self.start:
                time.sleep(self.pause_s)
            yield b

    def reset(self):
        self.inner.reset()

    def batch_size(self):
        return self.inner.batch_size()


def _window_means(net, iterator, **fit_kw):
    """The fit's mean device time, input stall and host gap a dispatch, ms."""
    net.fit(iterator, **fit_kw)
    torch.cuda.synchronize()
    fit = devprof.recent_fits()[-1]
    n = fit["resolved"]
    return {k: 1e3 * fit[k] / n
            for k in ("device_seconds", "input_stall_seconds", "host_gap_seconds")}


@pytest.mark.cuda
def test_a_slowed_staging_copy_is_input_stall_and_a_late_host_is_host_gap():
    data = _lstm_data(64, seed=3)
    base = _lstm()
    base.fit(ListDataSetIterator(_lstm_data(8), 4))
    plain = _window_means(base, ListDataSetIterator(data, 4))
    slow = _lstm()
    slow.set_input_transform(_SlowStaging(20_000_000))  # ~10 ms a batch
    slow.fit(ListDataSetIterator(_lstm_data(8), 4))
    stalled = _window_means(slow, ListDataSetIterator(data, 4))
    late = _window_means(base, _LateHost(data, 4, pause_s=0.02), async_prefetch=False)
    print("plain", plain, "slowed staging", stalled, "late host", late)
    assert stalled["input_stall_seconds"] > plain["input_stall_seconds"] + 4.0
    assert late["host_gap_seconds"] > plain["host_gap_seconds"] + 10.0


@pytest.mark.cuda
def test_a_fused_fit_under_the_tracing_listener_captures_and_replays(tmp_path):
    import json

    net = _resnet().set_listeners(TracingListener(jsonl_path=str(tmp_path / "t.jsonl")))
    net.fit(ListDataSetIterator(_resnet_data(32), 4))  # 4 dispatches of 2
    [g] = net.fit_graphs()
    assert g["replays"] == 3  # warm-up, capture + replay, replay, replay
    lines = [json.loads(l) for l in open(tmp_path / "t.jsonl")]
    marks = [e["args"] for e in lines if e["name"] == "iteration"]
    assert marks == [{"iteration": 2 * i, "steps": 2} for i in range(4)]
    modes = [e["args"]["mode"] for e in lines if e["name"] == "fit/launch"]
    assert modes == ["eager", "capture", "replay", "replay"]
