"""The port's fault-tolerance utilities — utils/{sigchain, faultpoints,
health, blackbox, tracing, tenancy, concurrency}.py and the listeners
beyond ScoreIterationListener — each held to the JAX package's copy on a
few cases mirrored from its tests: the SIGTERM chain's order, the same
`FaultPlan(seed)` firing at the same calls in both packages, a watchdog
stall raising StepHangError under `fit(hang_timeout=...)`, the flight
recorder's non-blocking score, and the tracing export's JSON keys.
"""

import json
import queue
import signal
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.utils import faultpoints as jfp
from deeplearning4j_tpu.utils import tracing as jtracing
from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import listeners as tl
from deeplearning4j_tpu_torch.utils import blackbox, concurrency, sigchain, tenancy
from deeplearning4j_tpu_torch.utils import faultpoints as fp
from deeplearning4j_tpu_torch.utils import tracing
from deeplearning4j_tpu_torch.utils.health import StepHangError, get_health


def _net():
    conf = (NeuralNetConfiguration.builder().seed(3).updater("sgd")
            .learning_rate(0.1).list()
            .layer(DenseLayer(n_out=6, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _xy(n=20):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


# -- sigchain ----------------------------------------------------------------------


def test_sigchain_runs_actions_in_priority_order_whatever_the_arming_order():
    ran = []
    sigchain.register("t-dump", lambda s, f: ran.append("dump"),
                      priority=sigchain.PRIORITY_DUMP)
    sigchain.register("t-save", lambda s, f: ran.append("save"),
                      priority=sigchain.PRIORITY_SAVE)
    try:
        assert sigchain.PRIORITY_SAVE < sigchain.PRIORITY_DUMP
        mine = [(name, fn) for _, name, fn in sigchain.actions()
                if name.startswith("t-")]
        assert [name for name, _ in mine] == ["t-save", "t-dump"]
        for _, fn in mine:
            fn(signal.SIGTERM, None)
        assert ran == ["save", "dump"]
    finally:
        sigchain.unregister("t-dump")
        sigchain.unregister("t-save")
    assert not any(n.startswith("t-") for _, n, _ in sigchain.actions())


def test_a_held_sigterm_runs_at_the_safe_point_or_when_the_hold_ends():
    """Inside `deferred()` a SIGTERM runs the chain (actions, then the
    previous handler) only at `safe_point()` or when the outermost hold
    ends; outside any hold it runs at once."""
    ran = []
    old = signal.signal(signal.SIGTERM, lambda s, f: ran.append("prev"))
    sigchain.register("t-save", lambda s, f: ran.append("save"),
                      priority=sigchain.PRIORITY_SAVE)
    try:
        with sigchain.deferred():
            with sigchain.deferred():
                signal.raise_signal(signal.SIGTERM)
                assert ran == []
            assert ran == []  # an inner hold's end is not a safe point
            sigchain.safe_point()
            assert ran == ["save", "prev"]
            signal.raise_signal(signal.SIGTERM)
            assert ran == ["save", "prev"]
        assert ran == ["save", "prev"] * 2
        sigchain.safe_point()  # nothing pending: a no-op
        signal.raise_signal(signal.SIGTERM)
        assert ran == ["save", "prev"] * 3
    finally:
        sigchain.unregister("t-save")
        signal.signal(signal.SIGTERM, old)


# -- faultpoints -------------------------------------------------------------------


def _plan(mod, seed):
    plan = mod.FaultPlan(seed=seed)
    plan.add("train_step", "error", p=0.3)
    plan.add("ckpt_write", "corrupt", every_nth=3)
    plan.add("decode_step", "latency", between=(2, 4), latency_ms=0.0)
    return plan


def _drive(plan):
    for _ in range(40):
        for point in ("train_step", "ckpt_write", "decode_step"):
            plan.decide(point)
    return plan.event_log()


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_the_same_plan_fires_at_the_same_calls_in_both_packages(seed):
    log = _drive(_plan(fp, seed))
    assert log and log == _drive(_plan(jfp, seed))
    assert fp.FaultPlan.from_json(_plan(fp, seed).to_json()).to_json() == \
        _plan(jfp, seed).to_json()


def test_fault_kinds_raise_or_return_as_in_the_jax_package():
    assert fp.KINDS == jfp.KINDS and fp.KNOWN_POINTS == jfp.KNOWN_POINTS
    plan = fp.FaultPlan(seed=1)
    plan.add("train_step", "oom", every_nth=2)
    plan.add("ckpt_write", "corrupt", every_nth=1)
    with fp.active(plan):
        assert fp.fault_point("train_step") is None
        with pytest.raises(fp.InjectedOOM, match="RESOURCE_EXHAUSTED"):
            fp.fault_point("train_step")
        assert fp.fault_point("ckpt_write") == "corrupt"
    assert fp.get_plan() is None


def test_an_oom_fault_unwinds_the_fit_and_a_nan_fault_taints_the_batch():
    x, y = _xy()
    net = _net()
    plan = fp.FaultPlan(seed=0).add("train_step", "oom", every_nth=2)
    with fp.active(plan):
        with pytest.raises(fp.InjectedOOM):
            net.fit(x, y, batch_size=5)
    assert net.iteration == 1
    scores = tl.CollectScoresIterationListener()
    net = _net().set_listeners(scores)
    with fp.active(fp.FaultPlan(seed=0).add("train_step", "nan", between=(2, 2))):
        net.fit(x, y, batch_size=5)
    assert np.isfinite(scores.scores[0][1]) and np.isnan(scores.scores[1][1])


def test_a_corrupt_fault_damages_the_written_checkpoint(tmp_path):
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.utils.model_serializer import verify_checkpoint

    lst = CheckpointListener(str(tmp_path), every_n_epochs=None)
    with fp.active(fp.FaultPlan(seed=0).add("ckpt_write", "corrupt", every_nth=1)):
        path = lst.save(_net(), reason="manual")
    assert not verify_checkpoint(path)["ok"]


# -- health: the watchdog and hang_timeout ------------------------------------------


def test_fit_hang_timeout_raises_a_diagnosable_error():
    x, y = _xy()

    class StallingIterator(DataSetIterator):
        def __iter__(self):
            yield DataSet(x[:10], y[:10])
            for _ in range(1000):  # a python-level wedge, 20 s worth
                time.sleep(0.02)

    t0 = time.monotonic()
    with pytest.raises(StepHangError) as ei:
        # inline, as the JAX package's test: a prefetch worker wedged in
        # the iterator's own code cannot be joined when the fit unwinds
        _net().fit(StallingIterator(), epochs=1, async_prefetch=False,
                   hang_timeout=0.3)
    assert time.monotonic() - t0 < 15
    with open(ei.value.dump_path) as f:
        doc = json.load(f)
    assert "hang" in doc["reason"] and doc["last_step"] == 0
    assert "fit" not in get_health().status()["components"]


def test_fit_registers_its_heartbeat_only_while_it_runs():
    seen = []

    class Probe(tl.IterationListener):
        def iteration_done(self, model, iteration, info):
            seen.append("fit" in get_health().status()["components"])

    x, y = _xy()
    _net().set_listeners(Probe()).fit(x, y, batch_size=10)
    assert seen == [True, True]
    assert "fit" not in get_health().status()["components"]


# -- blackbox --------------------------------------------------------------------


def test_recorder_keeps_the_score_tensor_and_resolves_it_at_dump_time(tmp_path):
    x, y = _xy()
    rec = blackbox.get_recorder()
    n0 = rec.snapshot()["steps_recorded_total"]
    net = _net()
    net.fit(x, y, batch_size=10)
    steps = rec.snapshot()["steps"]
    assert rec.snapshot()["steps_recorded_total"] == n0 + 2
    assert steps[-1]["step"] == 1 and isinstance(steps[-1]["score"], float)
    with rec._lock:
        assert torch.is_tensor(rec._steps[-1]["score"])  # not read at record time
    text = blackbox.render_dump(rec.snapshot("unit test"))
    assert "unit test" in text and "MainThread" in text


def test_a_score_whose_step_has_not_finished_reports_pending():
    class NotDone:
        def query(self):
            return False

    class Score:
        def __float__(self):
            raise AssertionError("a snapshot must not block on the device")

    assert blackbox._resolve_score(Score(), NotDone()) == "pending"
    assert blackbox._resolve_score(torch.tensor(0.5)) == 0.5


# -- tracing ----------------------------------------------------------------------


def _trace(mod):
    tr = mod.Tracer()
    tr.enabled = True
    with tr.span("fit/step", data_wait_ms=1.0):
        with tr.span("fit/dispatch"):
            tr.instant("iteration", iteration=0)
    return tr


def test_the_tracing_export_has_the_jax_packages_keys(tmp_path):
    t, j = _trace(tracing), _trace(jtracing)
    tl_, jl = t.recent(), j.recent()
    assert [e["name"] for e in tl_] == [e["name"] for e in jl]
    assert [sorted(e) for e in tl_] == [sorted(e) for e in jl]
    tc, jc = t.to_chrome_trace(), j.to_chrome_trace()
    assert sorted(tc) == sorted(jc)
    assert ([sorted(e) for e in tc["traceEvents"]]
            == [sorted(e) for e in jc["traceEvents"]])
    assert ([sorted(e["args"]) for e in tc["traceEvents"]]
            == [sorted(e["args"]) for e in jc["traceEvents"]])
    path = t.write_jsonl(str(tmp_path / "t.jsonl"))
    assert [json.loads(l)["name"] for l in open(path)] == \
        ["iteration", "fit/dispatch", "fit/step"]


def test_tracing_is_off_by_default_and_the_fit_spans_appear_when_on(tmp_path):
    assert not tracing.is_enabled()
    assert tracing.span("x") is tracing.NULL_SPAN
    x, y = _xy()
    jsonl = str(tmp_path / "fit.jsonl")
    net = _net().set_listeners(tl.TracingListener(jsonl_path=jsonl))
    net.fit(x, y, batch_size=10)
    assert not tracing.is_enabled()  # restored at the fit's end
    names = [json.loads(l)["name"] for l in open(jsonl)]
    for want in ("fit/step", "fit/dispatch", "fit/device_sync", "iteration"):
        assert want in names


# -- listeners --------------------------------------------------------------------


def test_performance_collect_composable_and_evaluative_listeners():
    x, y = _xy(40)
    lines, evals = [], []
    perf = tl.PerformanceListener(frequency=2, print_fn=lines.append)
    coll = tl.CollectScoresIterationListener(frequency=2)
    ev = tl.EvaluativeListener(ListDataSetIterator(DataSet(x, y), 10),
                               frequency=3, print_fn=evals.append)
    net = _net().set_listeners(tl.ComposableIterationListener(perf, coll), ev)
    net.fit(x, y, batch_size=5)
    assert [i for i, _ in coll.scores] == [0, 2, 4, 6]
    assert lines and all("samples/s" in s and "etl" in s for s in lines)
    assert len(evals) == 2 and ev.last_evaluation.confusion.sum() == 40


def test_health_transition_listener_forwards_transitions():
    class Router:
        def __init__(self):
            self.updates = []

        def put_update(self, session, record):
            self.updates.append(record)

    router = Router()
    lst = tl.HealthTransitionListener(router=router)
    health = get_health()
    health.set_condition("t-component", "degraded", "unit test")
    health.set_condition("t-component", "ok")
    lst.on_fit_end(_net())
    recs = [t for u in router.updates for t in u["health_transitions"]]
    assert [(t["from"], t["to"]) for t in recs
            if t["component"] == "t-component"] == [("ok", "degraded"),
                                                    ("degraded", "ok")]


# -- tenancy, concurrency -------------------------------------------------------


def test_tenancy_interns_and_scopes_like_the_jax_package():
    from deeplearning4j_tpu.utils import tenancy as jtenancy

    for raw in ("gold", "  Gold Tier! ", "x" * 200):
        assert tenancy.intern(raw) == jtenancy.intern(raw)
    with tenancy.tenant_scope("gold"):
        assert tenancy.current_tenant() == "gold"
    assert tenancy.current_tenant() is None


def test_get_abortable_aborts_instead_of_hanging():
    q = queue.Queue()
    stop = threading.Event()
    threading.Timer(0.05, stop.set).start()
    with pytest.raises(concurrency.QueueAborted):
        concurrency.get_abortable(q, stop)
    q.put(1)
    assert concurrency.get_abortable(q, threading.Event()) == 1
