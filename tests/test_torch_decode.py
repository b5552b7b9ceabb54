"""The port's continuous-batching decode engine
(deeplearning4j_tpu_torch/serving/decode.py) on the CPU.

- its greedy tokens equal the JAX package's DecodeEngine on shared
  weights, and the port's own sequential `rnn_time_step` loop at batch 1;
- a request admitted mid-flight decodes identically;
- a weight swap between waves serves the new weights, with no step
  function rebuilt;
- `set_fused_steps(4)` emits the tokens K=1 emits;
- per-tenant books conserve, including shed work;
- the engine's hooks: lifecycle spans, the decode_step fault point, the
  watchdog heartbeat, flight-recorder events and per-tenant metering.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.models.charlstm import char_lstm_network as jax_network
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExceeded,
    RequestValidationError,
)
from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

VOCAB = 13


def _nets(layers=2, hidden=16, seed=5):
    jnet = jax_network(vocab_size=VOCAB, hidden=hidden, layers=layers,
                       tbptt_length=8, seed=seed)
    tnet = char_lstm_network(vocab_size=VOCAB, hidden=hidden, layers=layers,
                             tbptt_length=8, seed=seed, device="cpu")
    tnet.params_list = params_from_numpy(
        tnet.conf, [{k: np.asarray(v) for k, v in p.items()}
                    for p in jnet.params_list], device="cpu")
    return jnet, tnet


def reference_decode(net, prompt, max_new):
    """The sequential loop: one request at a time, one token per
    rnn_time_step call at batch 1."""
    net.clear_rnn_state()
    eye = np.eye(VOCAB, dtype=np.float32)
    out = None
    for t in prompt:
        out = net.rnn_time_step(eye[[t]])
    toks = []
    while len(toks) < max_new:
        g = int(np.argmax(np.asarray(out)[0]))
        toks.append(g)
        out = net.rnn_time_step(eye[[g]])
    net.clear_rnn_state()
    return toks


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, size=1 + i % 5).tolist(), 3 + i % 4)
            for i in range(n)]


def _run(eng, reqs, tenants=None):
    try:
        futs = [eng.generate(p, max_new_tokens=m,
                             tenant=(tenants[i % len(tenants)] if tenants
                                     else "default"))
                for i, (p, m) in enumerate(reqs)]
        return [f.result(timeout=120) for f in futs], eng.metrics()
    finally:
        eng.shutdown()


def test_tokens_equal_jax_engine_and_sequential_loop():
    jnet, tnet = _nets()
    reqs = _requests(0, 8)
    port, m = _run(DecodeEngine(tnet, n_slots=3, component_prefix="t_port"), reqs)
    jax_out, _ = _run(JaxDecodeEngine(jnet, n_slots=3, component_prefix="t_jax"), reqs)
    assert port == jax_out
    assert port == [reference_decode(tnet, p, mx) for p, mx in reqs]
    assert m["completed"] == len(reqs) and m["conservation_ok"]
    assert m["program_cache_size"] == 2


def test_mid_flight_admission_decodes_identically():
    _, net = _nets(layers=1)
    reqs = [([1, 2, 3], 8), ([5, 4], 8)]
    late = ([7, 1], 6)
    refs = [reference_decode(net, p, m) for p, m in reqs]
    ref_late = reference_decode(net, *late)
    eng = DecodeEngine(net, n_slots=3, component_prefix="t_mid")
    late_fut = []
    fired = threading.Event()

    def on_token(_tok):
        # runs on the engine thread after request 0's first emitted token:
        # both initial requests are mid-decode right now
        if not fired.is_set():
            fired.set()
            late_fut.append(eng.generate(late[0], max_new_tokens=late[1]))

    try:
        f0 = eng.generate(reqs[0][0], max_new_tokens=reqs[0][1], on_token=on_token)
        f1 = eng.generate(reqs[1][0], max_new_tokens=reqs[1][1])
        outs = [f0.result(timeout=120), f1.result(timeout=120)]
        assert fired.wait(10)
        out_late = late_fut[0].result(timeout=120)
    finally:
        eng.shutdown()
    assert outs == refs
    assert out_late == ref_late


def test_weight_swap_serves_new_weights_without_rebuilds():
    _, net = _nets(layers=1)
    wave1, wave2 = _requests(1, 4), _requests(2, 4)
    v1 = net.params_list
    v2 = [{k: t * 1.5 for k, t in p.items()} for p in v1]
    eng = DecodeEngine(net, n_slots=2, component_prefix="t_swap")
    try:
        out1 = [eng.generate(p, max_new_tokens=m).result(120) for p, m in wave1]
        warm = eng.program_cache_size()
        v = eng.load_version(v2)
        out2 = [eng.generate(p, max_new_tokens=m).result(120) for p, m in wave2]
        m = eng.metrics()
    finally:
        eng.shutdown()
    assert v == 1 and m["version"] == 1 and m["swaps"] == 1
    assert warm == 2 and m["program_cache_size"] == 2
    assert out1 == [reference_decode(net, p, mx) for p, mx in wave1]
    net.params_list = v2
    assert out2 == [reference_decode(net, p, mx) for p, mx in wave2]
    with pytest.raises(ValueError):
        DecodeEngine.load_version(eng, [{k: t[:1] for k, t in p.items()}
                                        for p in v1])


def test_fused_steps_k4_equals_k1_and_books_conserve_per_tenant():
    _, net = _nets()
    reqs = _requests(3, 10)
    out1, m1 = _run(DecodeEngine(net, n_slots=4, component_prefix="t_k1",
                                 tenant_weights={"a": 3.0, "b": 1.0}),
                    reqs, tenants=["a", "b"])
    eng = DecodeEngine(net, n_slots=4, component_prefix="t_k4",
                       tenant_weights={"a": 3.0, "b": 1.0}).set_fused_steps(4)
    out4, m4 = _run(eng, reqs, tenants=["a", "b"])
    assert out4 == out1
    assert m4["steps"] < m1["steps"]  # one engine iteration per 4 tokens
    for m in (m1, m4):
        assert m["conservation_ok"]
        assert {t: b["completed"] for t, b in m["tenants"].items()} == \
            {"a": 5, "b": 5}
        assert m["tokens"] == sum(mx for _, mx in reqs)


def test_expired_and_invalid_requests_are_shed_or_refused():
    _, net = _nets(layers=1)
    eng = DecodeEngine(net, n_slots=2, component_prefix="t_shed")
    try:
        with pytest.raises(DeadlineExceeded):
            eng.generate([1, 2], max_new_tokens=3, deadline_ms=0, tenant="x")
        with pytest.raises(RequestValidationError):
            eng.generate([VOCAB], max_new_tokens=3)
        with pytest.raises(RequestValidationError):
            eng.generate([], max_new_tokens=3)
        assert eng.generate([3], max_new_tokens=2, tenant="x").result(60) == \
            reference_decode(net, [3], 2)
        m = eng.metrics()
    finally:
        eng.shutdown()
    x = m["tenants"]["x"]
    assert x["rejected"] == 1 and x["completed"] == 1 and x["admitted"] == 1
    assert m["conservation_ok"]


# -- the engine's hooks -------------------------------------------------------


def test_hooks_spans_heartbeat_blackbox_and_swap_events():
    """Traced, a request's lifecycle is decode/admit -> decode/step(s) ->
    decode/emit in one trace; each weight flip leaves a decode/swap span
    and a flight-recorder event; the engine's heartbeat is registered
    while it runs and gone after shutdown; start and stop are recorded."""
    from deeplearning4j_tpu_torch.utils import blackbox, health, tracing

    _, net = _nets(layers=1)
    t_start = time.time()
    tracing.get_tracer().clear()
    tracing.enable(True)
    eng = DecodeEngine(net, n_slots=2, component_prefix="t_hooks")
    try:
        assert "t_hooks_engine" in health.get_health().status()["components"]
        with tracing.span("client"):
            toks = eng.generate([1, 2], max_new_tokens=3, tenant="acme").result(60)
        eng.load_version([{k: t * 1.5 for k, t in p.items()}
                          for p in net.params_list])
        eng.generate([3], max_new_tokens=2).result(60)
        spans = tracing.get_tracer().recent()
    finally:
        tracing.enable(False)
        tracing.get_tracer().clear()
        eng.shutdown()
    assert toks == reference_decode(net, [1, 2], 3)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    admit = [e for e in by_name["decode/admit"] if e["args"]["tenant"] == "acme"]
    emit = [e for e in by_name["decode/emit"] if e["args"]["tenant"] == "acme"]
    assert len(admit) == 1 and len(emit) == 1
    assert emit[0]["trace"] == admit[0]["trace"]
    assert emit[0]["args"]["tokens"] == 3
    assert by_name["decode/step"] and all(
        e["args"]["active"] >= 1 for e in by_name["decode/step"])
    assert [e["args"]["version"] for e in by_name["decode/swap"]] == [1]
    assert "t_hooks_engine" not in health.get_health().status()["components"]
    kinds = [e["kind"] for e in blackbox.get_recorder().snapshot()["events"]
             if e["ts"] >= t_start - 1]
    for kind in ("decode_engine_start", "decode_weight_swap", "decode_engine_stop"):
        assert kind in kinds, kinds


def test_decode_step_fault_fails_active_and_engine_keeps_serving():
    """An `error` fault at the decode_step point fails the sequences in
    the step (their carry was mid-flight) and nothing else; the books
    conserve and the next request decodes as the sequential loop does. A
    `hang` there makes the engine's heartbeat stale."""
    from deeplearning4j_tpu_torch.utils import faultpoints as fp
    from deeplearning4j_tpu_torch.utils import health

    _, net = _nets(layers=1)
    eng = DecodeEngine(net, n_slots=2, component_prefix="t_fault",
                       health_stall_after=0.2)
    comp = "t_fault_engine"
    try:
        plan = fp.FaultPlan(seed=4).add("decode_step", "error", between=(2, 2))
        with fp.active(plan):
            with pytest.raises(RuntimeError, match="decode step failed"):
                eng.generate([1, 2, 3], max_new_tokens=4).result(60)
        assert [e["invocation"] for e in plan.event_log()] == [2]
        assert eng.generate([5, 4], max_new_tokens=3).result(60) == \
            reference_decode(net, [5, 4], 3)
        m = eng.metrics()
        assert m["failed"] == 1 and m["completed"] == 1 and m["conservation_ok"]
        hang = fp.FaultPlan(seed=5).add("decode_step", "hang", between=(1, 1),
                                        hang_seconds=30.0)
        with fp.active(hang):
            fut = eng.generate([2], max_new_tokens=2)
            seen = []
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and not seen:
                st = health.get_health().status()["components"].get(comp, {})
                if st.get("status") in ("degraded", "unhealthy"):
                    seen.append(st["status"])
                time.sleep(0.02)
            hang.release()
            assert fut.result(60) == reference_decode(net, [2], 2)
        assert seen, "the watchdog never saw the wedged step"
    finally:
        fp.clear()
        eng.shutdown()


def test_metering_splits_step_seconds_over_tenant_slots():
    """Metered, each step's wall time is split over the tenants whose
    slots it advanced (the per-tenant sums equal the decode tier's
    process total), tokens are booked per tenant, the live weights are
    attributed per version, and the books register under the decode
    tier."""
    from deeplearning4j_tpu_torch.utils import metrics, resourcemeter

    _, net = _nets(layers=1)
    resourcemeter.enable()
    eng = DecodeEngine(net, n_slots=3, component_prefix="t_meter",
                       tenant_weights={"ma": 2.0, "mb": 1.0})
    try:
        futs = [eng.generate(p, max_new_tokens=m, tenant=("ma", "mb")[i % 2])
                for i, (p, m) in enumerate(_requests(7, 6))]
        outs = [f.result(60) for f in futs]
        eng.load_version([{k: t * 1.1 for k, t in p.items()}
                          for p in net.params_list])
        eng.generate([1], max_new_tokens=1, tenant="ma").result(60)
        snap = resourcemeter.snapshot()
        decode_books = resourcemeter.merged_books(resourcemeter.TIER_DECODE)
    finally:
        eng.shutdown()
        resourcemeter.disable()
    for t in ("ma", "mb"):
        rec = snap["tenants"][t]
        assert rec["device_seconds"][resourcemeter.TIER_DECODE] > 0
    tokens = {t: snap["tenants"][t]["tokens"] for t in ("ma", "mb")}
    want = {"ma": 1 + sum(len(o) for i, o in enumerate(outs) if i % 2 == 0),
            "mb": sum(len(o) for i, o in enumerate(outs) if i % 2 == 1)}
    assert tokens == want
    assert snap["conservation"]["ok"], snap["conservation"]
    assert decode_books["ma"]["completed"] >= 4 and decode_books["mb"]["completed"] >= 3
    nbytes = sum(a.numel() * a.element_size() for p in net.params_list
                 for a in p.values())
    hbm = metrics.get_registry().get("tenant_hbm_bytes").labels("default").value
    assert hbm >= nbytes  # the live version (v1) is attributed, v0 released
