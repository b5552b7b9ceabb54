"""The port's sampled device profiler and OOM forensics (utils/devprof.py),
the flight recorder's memory trajectory and OOM rendering
(utils/blackbox.py), and the tenant attribution of sampled windows.

Restated from the JAX package's tests/test_costmodel_devprof.py:
`test_devprof_disabled_is_inert`,
`test_devprof_step_seconds_counts_optimizer_steps`,
`test_devprof_unsampled_step_cost`, `test_injected_oom_serving_forward`
and `test_blackbox_memory_trajectory`; the gauges from a sampled fit and
the injected mid-fit OOM are held on the port's own behaviour. Sampling
is off in this file except where a test turns it on
(`configure(sample_every=0)`, the JAX package's tier-1 setting), so no
other test's timing moves. On the CPU a sample synchronizes nothing and
the `live` gauge has no allocator to read; the card's run is
chip_smoke.py's phase 15c.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.analysis import costmodel
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import blackbox
from deeplearning4j_tpu_torch.utils import devprof
from deeplearning4j_tpu_torch.utils import faultpoints as fp
from deeplearning4j_tpu_torch.utils.metrics import get_registry


@pytest.fixture(autouse=True)
def _sampling_off():
    prev = devprof.get_profiler().sample_every
    devprof.configure(sample_every=0)
    fp.clear()
    yield
    fp.clear()
    devprof.configure(sample_every=prev)


def _dense_net(n_in=8, classes=3):
    # ADAM: its two moment buffers give the updater a real byte footprint
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Updater.ADAM)
            .learning_rate(0.05).weight_init("xavier").list()
            .layer(DenseLayer(n_in=n_in, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _dense_ds(n=8, n_in=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    return DataSet(rng.standard_normal((n, n_in)).astype(np.float32),
                   np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


def _batches(n, seed=0):
    """n batches of 8 as one DataSet (the iterator cuts it)."""
    parts = [_dense_ds(seed=seed + i) for i in range(n)]
    return ListDataSetIterator(DataSet(np.concatenate([p.features for p in parts]),
                                       np.concatenate([p.labels for p in parts])), 8)


def _scalar(name):
    return get_registry().scalar_values().get(name, 0.0)


def test_devprof_disabled_is_inert():
    net = _dense_net()
    assert devprof.get_profiler().sample_every == 0
    devprof.get_profiler().on_step(net, 8, None)
    assert getattr(net, "_devprof_state", None) is None


def test_default_cadence_is_the_jax_packages():
    """Every 16th dispatch samples unless DL4J_DEVPROF_SAMPLE_EVERY says
    otherwise, as in the JAX package."""
    import os

    assert devprof.DEFAULT_SAMPLE_EVERY == int(os.environ.get("DL4J_DEVPROF_SAMPLE_EVERY", "16"))
    assert devprof.DeviceProfiler().sample_every == devprof.DEFAULT_SAMPLE_EVERY


def test_devprof_step_seconds_counts_optimizer_steps():
    """One fused/TBPTT dispatch advances `iteration` by its whole segment
    count; per-step device time divides by THAT, not by the dispatch
    count."""
    prof = devprof.DeviceProfiler(sample_every=1)
    net = _dense_net()
    prof.sample_now(net)  # opens the window at iteration 0
    t0 = time.perf_counter()
    time.sleep(0.06)
    net.iteration += 4  # one fused dispatch = 4 optimizer steps
    prof.on_step(net, 32, None)
    dt = time.perf_counter() - t0
    g = get_registry().gauge("step_device_seconds").labels().value
    assert 0.005 < g < dt / 3.5, (g, dt)


def test_devprof_unsampled_step_cost():
    """The unsampled on_step path is a couple of integer ops: well under
    10 us a call, under 1% of even a 1 ms step."""
    prof = devprof.DeviceProfiler(sample_every=100_000)
    net = _dense_net()
    prof.on_step(net, 4, None)  # state init off the clock
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        prof.on_step(net, 4, None)
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 10e-6, f"on_step cost {per_call * 1e6:.2f}us"


def test_devprof_gauges_from_a_sampled_fit(monkeypatch):
    """A fit with sample_every=2 and a cost model attached publishes the
    step time, FLOP/s and (with a peak figure) MFU under the costmodel
    source, the memory watermarks, and closes its window with the fit."""
    monkeypatch.setenv("BENCH_PEAK_FLOPS", "1e12")
    net = _dense_net()
    m = costmodel.train_step_cost(net, batch_size=8)
    net.attach_cost_model(m, batch=8)
    s0 = _scalar("devprof_samples_total")
    devprof.configure(sample_every=2)
    net.fit(_batches(8), epochs=1, async_prefetch=False)
    devprof.configure(sample_every=0)
    assert _scalar("devprof_samples_total") - s0 >= 3
    assert _scalar("step_device_seconds") > 0
    fps = _scalar('step_flops_per_second{source="costmodel"}')
    assert fps > 0
    assert _scalar('step_mfu{source="costmodel"}') == pytest.approx(fps / 1e12)
    assert _scalar('device_memory_bytes{kind="params"}') == 4 * (8 * 8 + 8 + 8 * 3 + 3)
    assert _scalar('device_memory_bytes{kind="updater"}') == 2 * 4 * (8 * 8 + 8 + 8 * 3 + 3)
    assert _scalar('device_memory_bytes{kind="activations_est"}') == m.activation_peak_bytes
    assert net._devprof_state is None  # the window dies with the fit


def test_sampled_windows_are_charged_to_the_nets_tenant():
    from deeplearning4j_tpu_torch.utils import resourcemeter

    net = _dense_net().set_tenant("gold")
    assert net._tenant == "gold"
    resourcemeter.enable()
    try:
        prof = devprof.DeviceProfiler(sample_every=1)
        prof.sample_now(net)
        time.sleep(0.01)
        net.iteration += 1
        prof.on_step(net, 8, None)
        values = get_registry().scalar_values()
        spend = resourcemeter.spend_table(values)["gold"]
        assert spend["device_seconds"][resourcemeter.TIER_TRAINING] > 0
        assert spend["hbm_bytes"] >= 4 * (8 * 8 + 8 + 8 * 3 + 3)
    finally:
        resourcemeter.disable()


def test_is_oom_recognizes_the_allocators_errors():
    assert devprof.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                                      "allocate 2.00 GiB"))
    assert devprof.is_oom(RuntimeError("CUDA error: out of memory"))
    assert devprof.is_oom(fp.InjectedOOM("train_step", 1))
    assert not devprof.is_oom(RuntimeError("shape mismatch"))


def test_largest_live_buffers_names_tensors_once_by_storage():
    keep = torch.zeros(300_000)
    view = keep[:10]  # noqa: F841  (a view: the same storage, counted once)
    top = devprof.largest_live_buffers(top=50, device="cpu")
    assert top and top[0]["nbytes"] >= top[-1]["nbytes"]
    hits = [b for b in top if b["nbytes"] == keep.numel() * 4]
    assert len(hits) >= 1 and hits[0]["device"] == "cpu"
    assert devprof.device_bytes_in_use("cpu") is None


def test_injected_oom_mid_fit_dumps_forensics():
    net = _dense_net()
    before = _scalar('oom_total{where="fit"}')
    plan = fp.FaultPlan(seed=3).add("train_step", "oom", every_nth=2, max_fires=1)
    with fp.active(plan):
        with pytest.raises(fp.InjectedOOM) as ei:
            net.fit(_batches(6), epochs=1, async_prefetch=False)
    assert devprof.is_oom(ei.value)
    assert _scalar('oom_total{where="fit"}') == before + 1
    path = blackbox.get_recorder().last_dump_path
    assert path is not None
    with open(path) as f:
        doc = json.load(f)
    ev = [e for e in doc["events"] if e.get("kind") == "oom"][-1]
    assert ev["where"] == "fit"
    assert ev["top_buffers"], "dump names no live tensors"
    assert ev["top_buffers"][0]["nbytes"] >= ev["top_buffers"][-1]["nbytes"]
    # no model was attached: one trace on fake tensors now, cached
    assert ev["static"]["activation_peak_bytes"] > 0
    assert ev["static"]["flops_source"] == "costmodel(post-hoc, batch=2)"
    assert net._cost_model_meta["source"] == "costmodel(post-hoc, batch=2)"
    text = blackbox.render_dump(doc)
    assert "OOM forensics — where: fit" in text
    assert "largest live buffers" in text and "RESOURCE_EXHAUSTED" in text
    assert net._devprof_state is None


def test_injected_oom_serving_forward():
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    net = _dense_net()
    pi = ParallelInference(net, max_batch_size=4, batch_timeout_ms=1.0,
                           component_prefix="oomtest")
    try:
        pi.warmup((8,))
        before = len([e for e in blackbox.get_recorder().snapshot()["events"]
                      if e.get("kind") == "oom"])
        n0 = _scalar('oom_total{where="serving_forward"}')
        plan = fp.FaultPlan(seed=1).add("replica_forward", "oom", every_nth=1,
                                        max_fires=1)
        with fp.active(plan):
            with pytest.raises(Exception) as ei:
                pi.output(np.zeros((2, 8), np.float32))
        assert devprof.is_oom(ei.value)
        events = [e for e in blackbox.get_recorder().snapshot()["events"]
                  if e.get("kind") == "oom"]
        assert len(events) > before
        assert events[-1]["where"] == "serving_forward"
        assert _scalar('oom_total{where="serving_forward"}') == n0 + 1
        # the pipeline serves on after the failed group
        assert pi.output(np.zeros((2, 8), np.float32)).shape == (2, 3)
    finally:
        pi.shutdown()


def test_blackbox_memory_trajectory():
    from deeplearning4j_tpu_torch.utils.blackbox import FlightRecorder

    gauge = get_registry().gauge(
        "device_memory_bytes",
        "device memory watermarks polled at devprof samples", ("kind",))
    rec = FlightRecorder(metrics_every=1)
    gauge.labels("live").set(1000.0)
    rec.record_metrics_delta()  # baseline capture
    gauge.labels("live").set(2000.0)
    rec.record_metrics_delta()
    gauge.labels("live").set(3000.0)
    rec.record_metrics_delta()
    deltas = rec.snapshot()["metrics_deltas"]
    mems = [d["memory"]['device_memory_bytes{kind="live"}']
            for d in deltas if "memory" in d]
    # ABSOLUTE levels per capture — the trajectory, not just the slope
    assert mems[-2:] == [2000.0, 3000.0]
