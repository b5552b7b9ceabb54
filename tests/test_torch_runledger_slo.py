"""The port's run ledger and SLO rules (deeplearning4j_tpu_torch/utils/
runledger.py, analysis/slo.py): the JAX package's cases that need neither
its CLI, its UI nor its cost model, run on the port (rules, debounce,
rate of change, burn rate, serde, records and reconstruction, rollup
retention, the <10 µs off-path hooks, the fit knob, the alert lifecycle
under injected latency, health conditions); then the two packages
against each other — every rule kind fed one sample stream gives the
same transitions one by one, and a ledger written by either package
reads back through the other's `read_ledger`/`summarize_run` to equal
summaries; and the four `run_ledger=` entry points and the server's
`--ledger` flag take a path and close the ledger they own.

Everything here is host arithmetic: comparisons are exact, except the
JAX cases' own bounds (pytest.approx on burn values, the timing
bounds)."""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.analysis import slo
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    NeuralNetConfiguration,
    OutputLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import faultpoints as fp
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import runledger

N_IN = 6


@pytest.fixture(autouse=True)
def _clean_slate():
    """No leftover fault plan, attached ledger or health condition."""
    fp.clear()
    runledger.detach()
    yield
    fp.clear()
    runledger.detach()
    h = _health.get_health()
    with h._lock:
        leftovers = list(h._conditions)
    for comp in leftovers:
        h.set_condition(comp, _health.OK, reason="test teardown")


def _conf(seed=7):
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater(Updater.SGD).learning_rate(0.05).weight_init("xavier")
            .list()
            .layer(DenseLayer(n_in=N_IN, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())


def _net(seed=7):
    return MultiLayerNetwork(_conf(seed), device="cpu").init()


def _xy(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, N_IN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _series_delta(path, prefix):
    """Growth of every series starting with `prefix`, summed, between the
    ledger's first and last reconstructed samples."""
    samples = list(runledger.iter_samples(runledger.read_ledger(path)))

    def total(values):
        return sum(v for k, v in values.items()
                   if k.startswith(prefix) and ":" not in k)

    return total(samples[-1][1]) - total(samples[0][1])


# -- rule engine (pure) ---------------------------------------------------------


def test_threshold_and_drift_rules_with_selectors():
    rules = slo.SLORuleSet([
        slo.SLORule(name="depth", kind="threshold",
                    series="serving_queue_depth", op=">", value=4.0),
        slo.SLORule(name="mfu", kind="drift", series="step_mfu",
                    op="<", reference=0.8, frac=0.5, severity="warning"),
        slo.SLORule(name="live_mem", kind="drift",
                    series='device_memory_bytes{kind="live"}',
                    op=">", reference=1000.0, frac=0.9),
    ])
    out = rules.evaluate(1.0, {
        "serving_queue_depth": 2.0,
        'step_mfu{source="analytic"}': 0.5,
        'device_memory_bytes{kind="live"}': 100.0,
        'device_memory_bytes{kind="params"}': 5000.0,  # label-filtered out
    })
    assert out == [] and rules.firing() == []
    out = rules.evaluate(2.0, {
        "serving_queue_depth": 9.0,
        'step_mfu{source="analytic"}': 0.1,
        'device_memory_bytes{kind="live"}': 950.0,
    })
    assert sorted(t["rule"] for t in out) == ["depth", "live_mem", "mfu"]
    assert all(t["to"] == "firing" for t in out)
    out = rules.evaluate(3.0, {})  # absence of data is not an alert
    assert sorted(t["rule"] for t in out) == ["depth", "live_mem", "mfu"]
    assert all(t["to"] == "resolved" for t in out)


def test_for_seconds_debounce_pending_then_firing():
    rules = slo.SLORuleSet([slo.SLORule(
        name="r", kind="threshold", series="g", op=">", value=1.0,
        for_seconds=5.0)])
    assert rules.evaluate(0.0, {"g": 2.0}) == []  # pending
    assert rules.status()[0]["state"] == "pending"
    assert rules.evaluate(3.0, {"g": 2.0}) == []
    out = rules.evaluate(6.0, {"g": 2.0})
    assert [t["to"] for t in out] == ["firing"]
    out = rules.evaluate(7.0, {"g": 0.0})
    assert [t["to"] for t in out] == ["resolved"]
    assert rules.evaluate(8.0, {"g": 2.0}) == []  # pending again


def test_rate_of_change_rule():
    rules = slo.SLORuleSet([slo.SLORule(
        name="oom", kind="rate_of_change", series="oom_total",
        op=">", value=0.0)])
    assert rules.evaluate(0.0, {"oom_total": 0.0}) == []
    assert rules.evaluate(1.0, {"oom_total": 0.0}) == []
    out = rules.evaluate(2.0, {"oom_total": 1.0})
    assert [t["to"] for t in out] == ["firing"]
    out = rules.evaluate(3.0, {"oom_total": 1.0})
    assert [t["to"] for t in out] == ["resolved"]


def _hist_sample(good, total, le="0.1"):
    return {
        "lat:count": float(total),
        "lat:sum": float(total) * 0.01,
        f"lat:bucket:{le}": float(good),
        "lat:bucket:+Inf": float(total),
    }


def test_burn_rate_rule_windowed():
    rules = slo.SLORuleSet([slo.SLORule(
        name="p99", kind="burn_rate", series="lat",
        objective=0.9, threshold_ms=100.0, window_seconds=0.0,
        max_burn=1.0, min_events=5)])
    assert rules.evaluate(0.0, _hist_sample(0, 0)) == []
    assert rules.evaluate(1.0, _hist_sample(20, 20)) == []
    out = rules.evaluate(2.0, _hist_sample(22, 30))
    assert [t["to"] for t in out] == ["firing"]
    assert out[0]["value"] == pytest.approx(8.0)
    out = rules.evaluate(3.0, _hist_sample(23, 31))
    assert [t["to"] for t in out] == ["resolved"]
    assert rules.evaluate(4.0, _hist_sample(43, 51)) == []
    assert rules.status()[0]["fired_total"] == 1


def test_rule_serde_roundtrip_and_validation():
    pack = slo.default_rule_pack(
        serving={"default_deadline_ms": 100.0, "queue_capacity": 4})
    text = json.dumps({"rules": [r.to_dict() for r in pack]})
    rs = slo.SLORuleSet.from_json(text)
    assert [r.name for r in rs.rules] == [r.name for r in pack]
    burn = next(r for r in rs.rules if r.name == "serving_p99_deadline_burn")
    assert burn.threshold_ms == 100.0 and burn.objective == 0.99
    assert burn.series == "serving_output_seconds"
    with pytest.raises(ValueError):
        slo.SLORule(name="x", kind="nope", series="g")
    with pytest.raises(ValueError):
        slo.SLORule(name="x", kind="threshold", series="g")  # no value
    with pytest.raises(ValueError):
        slo.SLORuleSet.from_dicts([{"name": "x", "kind": "threshold",
                                    "series": "g", "value": 1.0,
                                    "bogus_field": 2}])


def test_default_rule_pack_refuses_a_cost_model():
    """The cost-model rules, since analysis/costmodel.py is ported: a step
    cost model gives the MFU-below-roofline drift rule at its ceiling (the
    JAX package's test_default_rule_pack_from_cost_model), and the
    residency rule only where the card's memory is known. The argument
    is still never ignored: something that is not a cost model raises."""
    from deeplearning4j_tpu_torch.analysis.costmodel import train_step_cost
    from deeplearning4j_tpu_torch.nn.conf import InputType
    from deeplearning4j_tpu_torch.utils.flops import peak_hbm_bytes_per_chip

    conf = (NeuralNetConfiguration.builder().seed(7).updater(Updater.SGD)
            .learning_rate(0.05).weight_init("xavier").list()
            .layer(DenseLayer(n_in=N_IN, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    cm = train_step_cost(MultiLayerNetwork(conf, device="cpu").init(), batch_size=2)
    by_name = {r.name: r for r in slo.default_rule_pack(cost_model=cm)}
    mfu = by_name["mfu_below_roofline"]
    assert mfu.kind == "drift" and mfu.op == "<" and mfu.frac == 0.5
    assert mfu.reference == pytest.approx(cm.roofline()["mfu_ceiling"])
    assert mfu.reference_source == "costmodel:mfu_ceiling"
    if peak_hbm_bytes_per_chip() is None:  # off the GPU: no budget
        assert "hbm_residency" not in by_name
    with pytest.raises(AttributeError):
        slo.default_rule_pack(cost_model=object())


# -- the ledger artifact -----------------------------------------------------------


def test_ledger_records_reconstructs_and_enriches(tmp_path):
    path = str(tmp_path / "run.jsonl")
    c = _metrics.get_registry().counter("ledger_demo_total", "t").labels()
    led = runledger.RunLedger(path, sample_every=60.0,
                              links={"bench": "BENCH_x.json"})
    runledger.attach(led)
    try:
        c.inc(5)
        net = _net()
        x, y = _xy(24)
        net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
        led.sample_now()
        c.inc(2)
        led.add_link("trace", "trace.jsonl")
    finally:
        led.close()
    assert runledger.current() is None  # close() detaches
    doc = runledger.read_ledger(path)
    man = doc["manifest"]
    assert man["run_id"] == led.run_id
    assert man["devices"].get("platform") == "cpu"
    assert man["links"] == {"bench": "BENCH_x.json", "trace": "trace.jsonl"}
    assert man.get("config_hash") and man.get("network_type") == "MultiLayerNetwork"
    assert man.get("flops_source") == "analytic"
    samples = list(runledger.iter_samples(doc))
    assert len(samples) >= 3
    last = samples[-1][1]
    assert last["ledger_demo_total"] == 7.0
    assert last["fit_step_total"] >= 3.0
    sample_rows = [r for r in doc["rows"] if r["kind"] == "sample"]
    appearances = ["ledger_demo_total" in r["values"] for r in sample_rows]
    assert appearances[1] is True
    assert any(":bucket:" in k for k in last)


def test_ledger_rollup_retention_bounds_the_artifact(tmp_path):
    path = str(tmp_path / "soak.jsonl")
    g = _metrics.get_registry().gauge("soak_gauge", "t").labels()
    led = runledger.RunLedger(path, sample_every=60.0, raw_window=8,
                              rollup_chunk=4)
    led.start()
    try:
        for i in range(40):
            g.set(float(i))
            led.sample_now()
    finally:
        led.close()
    doc = runledger.read_ledger(path)
    kinds = [r["kind"] for r in doc["rows"]]
    assert kinds.count("rollup") >= 5
    assert kinds.count("sample") <= 8 + 4 + 2
    samples = list(runledger.iter_samples(doc))
    assert samples[-1][1]["soak_gauge"] == 39.0
    roll = next(r for r in doc["rows"] if r["kind"] == "rollup")
    st = roll["series"]["soak_gauge"]
    assert st["min"] <= st["mean"] <= st["max"]
    assert st["last"] == st["max"]


def test_hook_overhead_unattached_and_fit_ab_within_noise(tmp_path):
    """With no ledger attached both hooks cost < 10 µs a call, and a fit
    with a ledger recording stays within noise of one without."""
    assert runledger.current() is None
    net = _net()
    t0 = time.perf_counter()
    for _ in range(10_000):
        runledger.note_fit_step(net)
    per_call = (time.perf_counter() - t0) / 10_000
    assert per_call < 10e-6, f"note_fit_step cost {per_call * 1e6:.2f}us"
    t0 = time.perf_counter()
    for _ in range(10_000):
        runledger.note_request()
    per_call = (time.perf_counter() - t0) / 10_000
    assert per_call < 10e-6, f"note_request cost {per_call * 1e6:.2f}us"

    x, y = _xy(n=120)

    def fit_once():
        fnet = _net(seed=3)
        fnet.fit(x, y, epochs=1, batch_size=4, async_prefetch=False)
        t = time.perf_counter()
        fnet.fit(x, y, epochs=1, batch_size=4, async_prefetch=False)
        return time.perf_counter() - t

    on_t, off_t = [], []
    for i in range(2):
        led = runledger.RunLedger(str(tmp_path / f"ab_{i}.jsonl"), sample_every=30.0)
        runledger.attach(led)
        try:
            on_t.append(fit_once())
        finally:
            led.close()
        off_t.append(fit_once())
    assert min(on_t) < min(off_t) * 1.8 + 0.1, (on_t, off_t)


def test_fit_run_ledger_knob_owns_and_closes(tmp_path):
    path = str(tmp_path / "fit.jsonl")
    net = _net()
    x, y = _xy(32)
    net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False, run_ledger=path)
    assert runledger.current() is None
    samples = list(runledger.iter_samples(runledger.read_ledger(path)))
    assert len(samples) >= 2
    assert samples[-1][1]["fit_step_total"] \
        - samples[0][1].get("fit_step_total", 0) == 4.0


# -- the injected-degradation round trip ------------------------------------------


def test_alert_lifecycle_under_injected_latency(tmp_path):
    """A latency fault on `replica_forward` flips the burn-rate rule to
    firing (health DEGRADED naming the rule, /alerts lists it, the
    recorded ledger fails `evaluate_ledger`), and releasing the fault
    resolves it."""
    from deeplearning4j_tpu_torch.serving import InferenceServer

    path = str(tmp_path / "serve.jsonl")
    rules = [slo.SLORule(
        name="p99_deadline_burn", kind="burn_rate",
        series="serving_output_seconds",
        objective=0.9, threshold_ms=100.0, window_seconds=0.0,
        max_burn=1.0, min_events=3, severity="error",
        component="serving", for_seconds=0.0)]
    led = runledger.RunLedger(path, sample_every=60.0, rules=rules)
    server = InferenceServer(_net(), port=0, max_batch_size=4,
                             batch_timeout_ms=1.0, warmup_shape=(N_IN,),
                             run_ledger=led)
    port = server.start()
    url = f"http://127.0.0.1:{port}"

    def predict(n=1):
        for _ in range(n):
            body = json.dumps({"features": [[0.1] * N_IN]}).encode()
            req = urllib.request.Request(
                f"{url}/predict", data=body,
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=20).read()

    def alerts():
        with urllib.request.urlopen(f"{url}/alerts", timeout=10) as r:
            return json.loads(r.read().decode())

    try:
        predict(4)
        led.sample_now()
        assert led.rules.firing() == []
        plan = fp.FaultPlan(seed=1).add("replica_forward", "latency",
                                        every_nth=1, latency_ms=150.0)
        with fp.active(plan):
            predict(4)
            led.sample_now()
        assert led.rules.firing() == ["p99_deadline_burn"]
        comp = _health.get_health().status()["components"]["serving"]
        assert comp["status"] == "degraded"
        assert "p99_deadline_burn" in comp["condition"]["reason"]
        a = alerts()
        assert a["firing"] == ["p99_deadline_burn"]
        state = next(r for r in a["rules"] if r["rule"] == "p99_deadline_burn")
        assert state["state"] == "firing" and state["value"] > 1.0
        assert any(f.code == "SLO001" for f in led.findings)
        scalars = _metrics.get_registry().scalar_values()
        assert scalars.get('slo_alerts_total{rule="p99_deadline_burn",'
                           'severity="error"}', 0) >= 1
        from deeplearning4j_tpu_torch.utils.blackbox import get_recorder

        with get_recorder()._lock:
            events = [dict(e) for e in get_recorder()._events]
        assert any(e.get("kind") == "slo_alert"
                   and e.get("rule") == "p99_deadline_burn" for e in events)
        predict(4)
        led.sample_now()
        assert led.rules.firing() == []
        assert alerts()["firing"] == []
        comps = _health.get_health().status()["components"]
        assert comps.get("serving", {}).get("status", "ok") == "ok"
    finally:
        server.stop()
        led.close()
    # offline gate: the recorded ledger replays through the manifest's
    # own rules, and the firing window fails it
    doc = runledger.read_ledger(path)
    verdict = slo.evaluate_ledger(
        runledger.iter_samples(doc),
        [slo.SLORule.from_dict(r) for r in doc["manifest"]["rules"]])
    assert verdict["ok"] is False
    assert verdict["ever_fired_errors"] == ["p99_deadline_burn"]


# -- health condition mechanics -----------------------------------------------------


def test_health_condition_merges_and_clears():
    h = _health.get_health()
    h.set_condition("cond_demo", _health.DEGRADED, reason="rule r1")
    st = h.status()
    assert st["components"]["cond_demo"]["status"] == "degraded"
    assert st["status"] != "ok"
    scalars = _metrics.get_registry().scalar_values()
    assert scalars['component_health{component="cond_demo"}'] == 1.0
    h.set_condition("cond_demo", _health.OK)
    assert "cond_demo" not in h.status()["components"]
    assert _metrics.get_registry().scalar_values()[
        'component_health{component="cond_demo"}'] == 0.0
    seq = h.last_seq()
    h.set_condition("never_set", _health.OK)
    assert h.last_seq() == seq


# -- the two packages against each other -------------------------------------------


def _stream(kind, seed=0, n=60):
    """A seeded sample stream that crosses each rule's limit both ways."""
    rng = np.random.default_rng(seed)
    out, good, total, c = [], 0.0, 0.0, 0.0
    for i in range(n):
        ts = 0.5 * i + float(rng.uniform(0, 0.2))
        if kind == "burn_rate":
            new = int(rng.integers(0, 30))
            slow = new if (i // 10) % 2 else int(rng.integers(0, 2))
            total += new
            good += new - slow
            vals = {'lat{route="a"}:count': total,
                    'lat{route="a"}:sum': total * 0.02,
                    'lat{route="a"}:bucket:0.05': good,
                    'lat{route="a"}:bucket:0.1': good,
                    'lat{route="a"}:bucket:+Inf': total}
        elif kind == "rate_of_change":
            c += float(rng.integers(0, 4)) * ((i // 7) % 2)
            vals = {'shed_total{stage="a"}': c, 'shed_total{stage="b"}': c / 2}
        else:
            vals = {'g{kind="live"}': float(rng.uniform(0, 2)),
                    'g{kind="other"}': 9.0}
        if i % 13 == 12:
            vals = {}  # a gap in the data
        out.append((ts, vals))
    return out


RULE_OF_KIND = {
    "threshold": dict(kind="threshold", series='g{kind="live"}', op=">",
                      value=1.2, for_seconds=1.0),
    "drift": dict(kind="drift", series="g", op="<", reference=2.0, frac=0.25),
    "rate_of_change": dict(kind="rate_of_change", series="shed_total", op=">",
                           value=2.0, for_seconds=0.6),
    "burn_rate": dict(kind="burn_rate", series="lat", objective=0.9,
                      threshold_ms=60.0, window_seconds=2.0, max_burn=2.0,
                      min_events=5),
}


@pytest.mark.parametrize("kind", sorted(RULE_OF_KIND))
def test_each_rule_kind_transitions_alike_in_both_packages(kind):
    from deeplearning4j_tpu.analysis import slo as jslo

    spec = dict(name=f"r_{kind}", **RULE_OF_KIND[kind])
    trs, jrs = slo.SLORuleSet([slo.SLORule(**spec)]), jslo.SLORuleSet([jslo.SLORule(**spec)])
    fired = 0
    for ts, vals in _stream(kind):
        a, b = trs.evaluate(ts, dict(vals)), jrs.evaluate(ts, dict(vals))
        assert a == b, (ts, a, b)
        assert trs.status() == jrs.status(), ts
        fired += sum(t["to"] == "firing" for t in a)
    assert fired >= 1  # the stream really exercised the rule
    assert trs.ever_fired() == jrs.ever_fired() and trs.to_dicts() == jrs.to_dicts()
    t_pack = [r.to_dict() for r in slo.default_rule_pack(
        serving={"default_deadline_ms": 50, "queue_capacity": 8}, tenants={"a": 0.5})]
    j_pack = [r.to_dict() for r in jslo.default_rule_pack(
        serving={"default_deadline_ms": 50, "queue_capacity": 8}, tenants={"a": 0.5})]
    assert t_pack == j_pack


def _write_ledger(pkg, path):
    """Drive one package's registry and RunLedger through a short run with
    an alerting rule; returns the ledger's run id."""
    if pkg == "jax":
        from deeplearning4j_tpu.analysis import slo as s
        from deeplearning4j_tpu.utils import metrics as m
        from deeplearning4j_tpu.utils import runledger as r
    else:
        s, m, r = slo, _metrics, runledger
    reg = m.get_registry()
    c = reg.counter("xledger_requests_total", "t", ("route",))
    g = reg.gauge("xledger_depth", "t").labels()
    h = reg.histogram("xledger_seconds", "t").labels()
    led = r.RunLedger(path, sample_every=60.0, raw_window=6, rollup_chunk=3,
                      rules=[s.SLORule(name="deep", kind="threshold",
                                       series="xledger_depth", op=">", value=5.0)])
    led.start()
    try:
        for i in range(14):
            c.labels("a").inc(i % 3)
            g.set(float((i * 7) % 11))
            h.observe(0.001 * (i + 1))
            led.sample_now(ts=1000.0 + i)
    finally:
        led.close()
    return led.run_id


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ledger_reads_alike_in_both_packages(writer, tmp_path):
    from deeplearning4j_tpu.utils import runledger as jrl

    path = str(tmp_path / f"{writer}.jsonl")
    run_id = _write_ledger(writer, path)
    tdoc, jdoc = runledger.read_ledger(path), jrl.read_ledger(path)
    assert tdoc == jdoc and tdoc["manifest"]["run_id"] == run_id
    assert [r["kind"] for r in tdoc["rows"]].count("rollup") >= 2
    assert list(runledger.iter_samples(tdoc)) == list(jrl.iter_samples(jdoc))
    assert list(runledger.iter_alerts(tdoc)) == list(jrl.iter_alerts(jdoc))
    tsum, jsum = runledger.summarize_run(tdoc), jrl.summarize_run(jdoc)
    assert tsum == jsum
    depth = tsum["series"]["xledger_depth"]
    assert depth["last"] == float((13 * 7) % 11)  # survives the rollups
    assert (runledger.compare_runs(tsum, tsum)
            == jrl.compare_runs(jsum, jsum))
    assert [x["run_id"] for x in runledger.list_ledgers(str(tmp_path))] == [run_id]


# -- the entry points ---------------------------------------------------------------


def _tiny_char_lstm():
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network

    return char_lstm_network(vocab_size=7, hidden=8, layers=1, device="cpu")


def _entry_fit(path):
    net = _net()
    x, y = _xy(24)
    net.fit(ListDataSetIterator(DataSet(x, y), 8), epochs=1, async_prefetch=False,
            run_ledger=path)
    return "fit_step_total", 3


def _entry_parallel_inference(path):
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

    pi = ParallelInference(_net(), max_batch_size=4, batch_timeout_ms=1.0,
                           run_ledger=path)
    assert runledger.current() is not None
    try:
        for i in range(5):
            pi.output(np.full((1, N_IN), 0.1 * i, np.float32))
    finally:
        pi.shutdown()
    return "serving_requests_total", 5


def _entry_decode(path):
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    eng = DecodeEngine(_tiny_char_lstm(), n_slots=2, run_ledger=path)
    try:
        futs = [eng.generate([1, 2], max_new_tokens=3) for _ in range(4)]
        for f in futs:
            assert len(f.result(timeout=60)) == 3
    finally:
        eng.shutdown()
    return "decode_requests_total", 4


def _entry_server(path):
    from deeplearning4j_tpu_torch.serving import InferenceServer

    server = InferenceServer(_net(), port=0, max_batch_size=4, batch_timeout_ms=1.0,
                             warmup_shape=(N_IN,), default_deadline_ms=5000.0,
                             queue_capacity=16, run_ledger=path)
    url = f"http://127.0.0.1:{server.start()}"
    try:
        for _ in range(3):
            body = json.dumps({"features": [[0.2] * N_IN]}).encode()
            urllib.request.urlopen(urllib.request.Request(
                f"{url}/predict", data=body,
                headers={"Content-Type": "application/json"}), timeout=20).read()
        with urllib.request.urlopen(f"{url}/alerts", timeout=10) as r:
            a = json.loads(r.read().decode())
        assert sorted(a) == ["firing", "ledger", "rules", "run_id", "transitions"]
        assert a["ledger"] == path and a["firing"] == []
        assert {r["rule"] for r in a["rules"]} >= {
            "serving_p99_deadline_burn", "serving_queue_unbounded", "oom"}
    finally:
        server.stop()
    return "serving_requests_total", 3


def _entry_cli(path):
    from deeplearning4j_tpu_torch.serving import inference_server as srv
    from deeplearning4j_tpu_torch.utils import model_serializer as ms

    zpath = os.path.join(os.path.dirname(path), "m.zip")
    ms.save_model(_net(), zpath)
    seen = {}

    def join(self):
        seen["rules"] = [r["rule"] for r in runledger.current().alert_status()["rules"]]
        raise KeyboardInterrupt  # stands in for ^C: main() stops the server

    orig = srv.InferenceServer.join
    srv.InferenceServer.join = join
    try:
        srv.main(["--modelPath", zpath, "--device", "cpu", "--port", "0",
                  "--ledger", path, "--defaultDeadlineMs", "1000"])
    finally:
        srv.InferenceServer.join = orig
    assert "serving_p99_deadline_burn" in seen["rules"]
    return "serving_requests_total", 0


ENTRY_POINTS = {"fit": _entry_fit, "parallel_inference": _entry_parallel_inference,
                "decode_engine": _entry_decode, "inference_server": _entry_server,
                "cli_ledger_flag": _entry_cli}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_takes_a_ledger_path_and_closes_it(entry, tmp_path):
    import threading

    path = str(tmp_path / f"{entry}.jsonl")
    series, sent = ENTRY_POINTS[entry](path)
    assert runledger.current() is None  # detached
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("dl4j-ledger")]  # closed
    doc = runledger.read_ledger(path)
    assert doc["manifest"]["devices"]["platform"] == "cpu"
    assert "fit_steps_hooked" in doc["manifest"]  # the closing note
    assert _series_delta(path, series) == sent
