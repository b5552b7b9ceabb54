"""Fault injection and overload on the port's serving path
(deeplearning4j_tpu_torch/parallel/inference.py, serving/
inference_server.py) on the CPU: the serving cases of
tests/test_chaos.py.

Every case is driven by a deterministic FaultPlan (the port's
utils/faultpoints; a JAX reference runs under the same plan in the JAX
package's) and waits on pipeline state, never on how long something
took: where the reference case races a stage against a clock, this one
either waits for the stage (queue depths, fault invocations) or sets the
caller's wait grace out of the race, so the outcome does not depend on
the speed of the machine or its load. The conservation law
`admitted == completed + shed + failed` holds in every case.
"""

import json
import threading
import time

import jax
import numpy as np
import pytest
from torch_serving import TIMEOUT, join_all, mlp_pair, status_of, twin, wait_until

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.serving import InferenceServer as JaxServer
from deeplearning4j_tpu.utils import faultpoints as jfp
from deeplearning4j_tpu_torch.parallel import inference as tinf
from deeplearning4j_tpu_torch.parallel.inference import (
    _WAIT_SHED_GRACE,
    DeadlineExceeded,
    ParallelInference,
    RequestRejected,
)
from deeplearning4j_tpu_torch.serving import InferenceServer
from deeplearning4j_tpu_torch.utils import faultpoints as fp
from deeplearning4j_tpu_torch.utils import health as _health

N_IN = 6


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    """No plan survives a test in either package, and no thread stays
    parked on a hang fault."""
    fp.clear()
    jfp.clear()
    yield
    fp.clear()
    jfp.clear()


@pytest.fixture
def pair(tmp_path):
    return mlp_pair(tmp_path, n_in=N_IN, hidden=8, n_out=3)


def _x(rows=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, N_IN)).astype(np.float32)


def _conserved(m):
    assert m["admitted"] == m["completed"] + m["shed"] + m["failed"], m
    return m


def _invocations(plan, point="replica_forward"):
    return plan.invocations().get(point, 0)


# -- injected forwards fail loudly, books balance, replay holds ---------------


def _serving_error_round(pkg_pi, fpmod, net, plan, n_requests=12):
    """One warmed ParallelInference, `n_requests` requests one after
    another under `plan` (one forward a request: the per-point
    invocation sequence is deterministic)."""
    pi = pkg_pi(net, max_batch_size=4, batch_timeout_ms=1.0,
                component_prefix="chaos_seq")
    outcomes, outputs = [], []
    try:
        pi.warmup((N_IN,))  # warm and pin the shape BEFORE the chaos
        with fpmod.active(plan):
            for i in range(n_requests):
                x = _x(rows=2, seed=i)
                try:
                    outputs.append((x, np.asarray(pi.output(x))))
                    outcomes.append(".")
                except fpmod.FaultInjected:
                    outcomes.append("F")
        m = _conserved(pi.metrics())
    finally:
        pi.shutdown()
    return plan.event_log(), "".join(outcomes), outputs, m


def test_serving_error_injection_conservation_and_replay(pair):
    jnet, tnet = pair
    plan = fp.FaultPlan(seed=7).add("replica_forward", "error", every_nth=3)
    log1, pattern1, outputs, m = _serving_error_round(
        ParallelInference, fp, tnet, plan)
    assert pattern1 == "..F..F..F..F"
    assert m["admitted"] == 12 and m["failed"] == 4
    assert m["completed"] == 8 and m["shed"] == 0
    # no silently wrong result: survivors equal the JAX package's forward
    for x, out in outputs:
        np.testing.assert_allclose(out, np.asarray(jnet.output(x)),
                                   rtol=1e-5, atol=1e-6)
    # replay: same seed + plan, same fault sequence
    plan.reset()
    log2, pattern2, _, _ = _serving_error_round(ParallelInference, fp, tnet, plan)
    assert log2 == log1 and pattern2 == pattern1
    assert [e["invocation"] for e in log1] == [3, 6, 9, 12]
    # and the JAX package under the same plan: the same log and books
    jplan = jfp.FaultPlan(seed=7).add("replica_forward", "error", every_nth=3)
    jlog, jpattern, _, jm = _serving_error_round(
        lambda net, **kw: jpar.ParallelInference(
            net, jpar.data_parallel_mesh(jax.devices()[:1]), **kw),
        jfp, jnet, jplan)
    assert jlog == log1 and jpattern == pattern1
    for k in ("admitted", "completed", "shed", "failed", "rejected"):
        assert jm[k] == m[k], k


def test_deadline_expired_at_admission_is_shed_not_served(pair):
    _, tnet = pair
    pi = ParallelInference(tnet, max_batch_size=4, batch_timeout_ms=1.0,
                           component_prefix="chaos_adm")
    try:
        pi.warmup((N_IN,))
        with pytest.raises(DeadlineExceeded) as ei:
            pi.output(_x(), deadline_ms=0.0)
        assert ei.value.stage == "admission"
        m = _conserved(pi.metrics())
        # never admitted: the refusal sits OUTSIDE the conservation law
        assert m["rejected"] == 1 and m["admitted"] == 0
        assert m["shed_by"] == {"admission/expired": 1}
    finally:
        pi.shutdown()


def test_queue_full_rejection_and_predicted_late(pair):
    """Wedge the single device forward (a hang fault) and fill each
    pipeline stage in turn, waiting for each: the forward holds r1, the
    handoff r2, the collector r3, the queue r4 and r5 (capacity 2) — the
    next caller is refused at once. After release, forwards that carried
    a 20 ms injected latency make a 1 ms budget predictably late."""
    _, tnet = pair
    plan = (fp.FaultPlan(seed=1)
            .add("replica_forward", "hang", between=(1, 1), hang_seconds=TIMEOUT)
            .add("replica_forward", "latency", between=(2, 6), latency_ms=20.0))
    pi = ParallelInference(tnet, max_batch_size=1, batch_timeout_ms=1.0,
                           queue_capacity=2, handoff_capacity=1,
                           component_prefix="chaos_qf")
    stage_reached = [
        lambda: _invocations(plan) == 1,              # r1 inside the forward
        lambda: pi._handoff.qsize() == 1,             # r2 in the handoff
        lambda: pi.metrics()["requests"] == 3 and pi._q.qsize() == 0,  # r3 held
        lambda: pi._q.qsize() == 1,                   # r4 queued
        lambda: pi._q.qsize() == 2,                   # r5 queued
    ]
    threads = []
    try:
        with fp.active(plan):
            for i in range(5):
                t = threading.Thread(
                    target=lambda i=i: pi.output(_x(rows=1, seed=i)),
                    daemon=True, name=f"dl4j-test-client-{i}")
                t.start()
                threads.append(t)
                assert wait_until(stage_reached[i], timeout=TIMEOUT), i
            with pytest.raises(RequestRejected) as ei:
                pi.output(_x(rows=1, seed=99))
            assert ei.value.reason == "queue_full"
            assert ei.value.retry_after >= 0.0
            plan.release()  # un-wedge: everything queued completes
            join_all(threads)
            m = _conserved(pi.metrics())
            assert m["completed"] == 5
            assert m["shed_by"].get("admission/queue_full") == 1
            # four of the five recorded forwards carried >= 20 ms
            assert pi.estimated_wait() > 0.01
            # a fresh estimate (the staleness probe has its own test)
            pi._last_forward_mono = time.monotonic()
            with pytest.raises(RequestRejected) as ei:
                pi.output(_x(rows=1, seed=100), deadline_ms=1.0)
            assert ei.value.reason == "predicted_late"
            assert ei.value.retry_after > 0.0
    finally:
        plan.release()
        pi.shutdown()


def test_stale_estimator_probe_self_heals_admission(pair):
    """A rolling p50 poisoned past every deadline must not shed 100%
    forever: warm-up runs never enter the estimator, a FRESH slow
    estimate sheds predicted_late, and once the idle pipeline's estimate
    is stale ONE probe is admitted to re-learn."""
    _, tnet = pair
    pi = ParallelInference(tnet, max_batch_size=1, batch_timeout_ms=1.0,
                           queue_capacity=4, component_prefix="chaos_probe")
    try:
        pi.warmup((N_IN,))
        assert pi.estimated_wait() == 0.0
        for _ in range(8):
            pi._batch_lat.record(1.0)
        pi._last_forward_mono = time.monotonic()
        with pytest.raises(RequestRejected) as ei:
            pi.output(_x(rows=1), deadline_ms=50.0)
        assert ei.value.reason == "predicted_late"
        pi._last_forward_mono = time.monotonic() - 10.0
        out = pi.output(_x(rows=1), deadline_ms=500.0)
        assert np.asarray(out).shape[0] == 1
        m = _conserved(pi.metrics())
        assert m["completed"] == 1
        assert m["shed_by"].get("admission/predicted_late") == 1
        # the probe refreshed the staleness clock: back to shedding
        with pytest.raises(RequestRejected) as ei:
            pi.output(_x(rows=1), deadline_ms=50.0)
        assert ei.value.reason == "predicted_late"
    finally:
        pi.shutdown()


def test_requests_expired_in_queue_are_shed_not_forwarded(pair, monkeypatch):
    """Requests whose deadline passes WHILE queued behind a wedged
    forward are shed at the collector or dispatch stage; the device
    never runs them. The callers' own wait grace is set out of the race
    (the backstop has its own test), so the pipeline sheds first however
    slowly this machine runs."""
    monkeypatch.setattr(tinf, "_WAIT_SHED_GRACE", TIMEOUT)
    _, tnet = pair
    plan = fp.FaultPlan(seed=2).add("replica_forward", "hang",
                                    between=(1, 1), hang_seconds=TIMEOUT)
    pi = ParallelInference(tnet, max_batch_size=1, batch_timeout_ms=1.0,
                           component_prefix="chaos_exp")
    results = {}

    def client(i, deadline_ms):
        try:
            results[i] = ("ok", pi.output(_x(rows=1, seed=i),
                                          deadline_ms=deadline_ms))
        except DeadlineExceeded as e:
            results[i] = ("shed", e.stage)
        except Exception as e:
            results[i] = ("err", repr(e))

    try:
        pi.warmup((N_IN,))
        with fp.active(plan):
            t0 = threading.Thread(target=client, args=(0, None),
                                  daemon=True, name="dl4j-test-c0")
            t0.start()
            assert wait_until(lambda: _invocations(plan) == 1, timeout=TIMEOUT)
            late = [threading.Thread(target=client, args=(i, 80.0), daemon=True,
                                     name=f"dl4j-test-c{i}") for i in range(1, 4)]
            t_submit = time.monotonic()
            for t in late:
                t.start()
            assert wait_until(lambda: pi.metrics()["admitted"] == 4, timeout=TIMEOUT)
            # every banked deadline has passed before the release
            time.sleep(max(0.0, t_submit + 0.08 - time.monotonic()) + 0.02)
            plan.release()
            join_all([t0] + late)
        assert results[0][0] == "ok"  # the hung one still completed
        for i in range(1, 4):
            assert results[i][0] == "shed", results[i]
            assert results[i][1] in ("collector", "dispatch")
        m = _conserved(pi.metrics())
        assert m["shed"] == 3 and m["completed"] == 1
        assert _invocations(plan) == 1  # no forward ran for the shed ones
    finally:
        plan.release()
        pi.shutdown()


def test_wedged_pipeline_wait_backstop_sheds_the_caller(pair):
    """When the pipeline wedges, the caller's own bounded wait (deadline
    + grace) sheds it with stage "wait", and the forward that completes
    after the release does not count the request twice."""
    _, tnet = pair
    plan = fp.FaultPlan(seed=12).add("replica_forward", "hang",
                                     between=(1, 1), hang_seconds=TIMEOUT)
    pi = ParallelInference(tnet, max_batch_size=2, batch_timeout_ms=1.0,
                           component_prefix="chaos_wait")
    try:
        pi.warmup((N_IN,))
        with fp.active(plan):
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceeded) as ei:
                pi.output(_x(), deadline_ms=100.0)
            waited = time.monotonic() - t0
            assert ei.value.stage == "wait"
            # bounded by the deadline and the grace, not by the hang
            assert waited < 0.1 + _WAIT_SHED_GRACE + TIMEOUT / 3, waited
            plan.release()
        assert wait_until(lambda: _conserved(pi.metrics())["shed"] == 1)
        m = pi.metrics()
        assert m["completed"] == 0 and m["shed_by"] == {"wait/expired": 1}
    finally:
        plan.release()
        pi.shutdown()


def test_hang_fault_trips_watchdog_then_recovers(pair):
    """An injected hang is a device wedge: the dispatcher's heartbeat
    goes stale, the watchdog degrades the component, and release()
    recovers it."""
    _, tnet = pair
    plan = fp.FaultPlan(seed=3).add("replica_forward", "hang",
                                    between=(1, 1), hang_seconds=TIMEOUT)
    pi = ParallelInference(tnet, max_batch_size=2, batch_timeout_ms=1.0,
                           health_stall_after=0.25, component_prefix="chaos_wd")
    comp = "chaos_wd_dispatcher"

    def status():
        return _health.get_health().status()["components"].get(comp, {}).get("status")

    try:
        pi.warmup((N_IN,))
        with fp.active(plan):
            t = threading.Thread(target=lambda: pi.output(_x()), daemon=True,
                                 name="dl4j-test-hang")
            t.start()
            assert wait_until(lambda: status() in ("degraded", "unhealthy"),
                              timeout=TIMEOUT), "watchdog never saw the wedge"
            plan.release()
            join_all([t])
        assert wait_until(lambda: status() == "ok", timeout=TIMEOUT)
        _conserved(pi.metrics())
    finally:
        plan.release()
        pi.shutdown()


# -- the REST layer -----------------------------------------------------------


def _http_fault_walk(server_cls, fpmod, net, mesh=None):
    """The status codes and shed bodies of one server under an
    `http_handler` fault on the 2nd request, then the deadline contract."""
    server = server_cls(net, mesh=mesh, max_batch_size=4, warmup_shape=(N_IN,))
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    body = {"features": _x().tolist()}
    rec = {}
    plan = fpmod.FaultPlan(seed=8).add("http_handler", "error", between=(2, 2))
    try:
        with fpmod.active(plan):
            rec["faulted"] = [status_of(f"{base}/predict", body)[:2] for _ in range(3)]
        code, shed, hdrs = status_of(f"{base}/predict", {**body, "deadline_ms": 0})
        rec["shed"] = (code, shed, int(hdrs["Retry-After"]))
        rec["health"] = status_of(f"{base}/health")[1]["status"]
        # the header spelling of the same budget, not in canonical casing
        rec["header_shed"] = status_of(f"{base}/predict",
                                       raw=json.dumps(body).encode(),
                                       headers={"x-deadline-ms": "0"})[0]
        # a NaN or infinite budget is malformed input: 400, not a shed
        rec["nonfinite"] = [status_of(f"{base}/predict",
                                      raw=json.dumps({**body, "deadline_ms": v}).encode())
                            for v in (float("nan"), float("inf"))]
        rec["metrics"] = status_of(f"{base}/metrics")[1]
    finally:
        server.stop()
        server.inference.shutdown()
    return rec


def test_http_handler_fault_is_a_500_and_the_server_survives(pair):
    jnet, tnet = pair
    t = _http_fault_walk(InferenceServer, fp, tnet)
    j = _http_fault_walk(JaxServer, jfp, jnet,
                         mesh=jpar.data_parallel_mesh(jax.devices()[:1]))
    codes = [c for c, _ in t["faulted"]]
    assert codes == [c for c, _ in j["faulted"]] == [200, 500, 200]
    assert "FaultInjected" in t["faulted"][1][1]["error"]
    assert "predictions" in t["faulted"][2][1]
    code, shed, retry_after = t["shed"]
    assert code == j["shed"][0] == 429
    assert shed["shed"] is True and shed["stage"] == "admission"
    assert sorted(shed) == sorted(j["shed"][1])
    assert retry_after >= 1  # RFC 9110 integer delta-seconds
    assert t["health"] == "ok"
    assert t["header_shed"] == j["header_shed"] == 429
    for (c, b, _), (jc, _, _) in zip(t["nonfinite"], j["nonfinite"]):
        assert c == jc == 400 and "finite" in b["error"]
    m = t["metrics"]
    assert m["rejected"] >= 2
    assert m["admitted"] == m["completed"] + m["shed"] + m["failed"]
    for k in ("admitted", "completed", "shed", "failed", "rejected"):
        assert m[k] == j["metrics"][k], k


# -- seeded chaos sweep and overload ------------------------------------------


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_chaos_serving_sweep_invariants(pair, seed):
    """Concurrent clients under seeded random faults end with the books
    balanced, every client terminated and the watchdog quiet — recovered
    or cleanly failed, never wedged. Which request meets a fault depends
    on how requests fuse, so the check is that every fired error failed
    at least one caller and a run without one failed none."""
    _, tnet = pair
    plan = (fp.FaultPlan(seed=seed)
            .add("replica_forward", "error", p=0.08)
            .add("replica_forward", "latency", p=0.25, latency_ms=15.0))
    pi = ParallelInference(tnet, max_batch_size=4, batch_timeout_ms=2.0,
                           queue_capacity=64, health_stall_after=20.0,
                           component_prefix=f"chaos_sw{seed}")
    counts = {"ok": 0, "fault": 0, "shed": 0}
    lock = threading.Lock()

    def client(i):
        for j in range(10):
            try:
                pi.output(_x(rows=1 + (i + j) % 4, seed=i * 100 + j),
                          deadline_ms=2000.0)
                k = "ok"
            except fp.FaultInjected:
                k = "fault"
            except (DeadlineExceeded, RequestRejected):
                k = "shed"
            with lock:
                counts[k] += 1

    try:
        pi.warmup((N_IN,))
        with fp.active(plan):
            threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                        name=f"dl4j-test-sw{i}") for i in range(6)]
            for t in threads:
                t.start()
            join_all(threads, timeout=4 * TIMEOUT)
        m = _conserved(pi.metrics())
        assert sum(counts.values()) == 60
        errors = [e for e in plan.event_log() if e["kind"] == "error"]
        assert counts["fault"] >= len(errors)
        assert (counts["fault"] > 0) == bool(errors)
        assert m["failed"] == counts["fault"]
        assert _invocations(plan) == m["batches"] + len(errors)
        for name, d in _health.get_health().status()["components"].items():
            if name.startswith(f"chaos_sw{seed}"):
                assert d["status"] == "ok", (name, d)
    finally:
        pi.shutdown()


class _Gated:
    """A model whose forwards wait until `open` is set, then take a fixed
    15 ms: the pipeline fills completely before it serves anything, so
    overload reaches admission whatever the machine's speed."""

    def __init__(self, inner):
        self._inner = inner
        self.open = threading.Event()

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def output(self, x):
        self.open.wait(timeout=TIMEOUT)
        time.sleep(0.015)
        return self._inner.output(x)


def test_overload_sheds_instead_of_queueing(pair, tmp_path):
    """16 closed-loop clients against a pipeline that holds at most 10
    one-row requests (2 in the forward, 2 handed off, 2 in the
    collector, 4 queued): admission sheds the excess instead of queueing
    it, the queue never passes its capacity, the books balance, no
    served request waited past its deadline plus the caller's grace (the
    wait backstop), and the watchdog opens no stall."""
    jnet, _ = pair
    model = _Gated(twin(jnet, tmp_path))
    slo_ms = 250.0
    pi = ParallelInference(model, max_batch_size=2, batch_timeout_ms=1.0,
                           queue_capacity=4, handoff_capacity=1,
                           default_deadline_ms=slo_ms, health_stall_after=20.0,
                           component_prefix="chaos_ovl")
    seq0 = _health.get_health().last_seq()
    lat_ok, shed = [], [0]
    lock = threading.Lock()
    stop = threading.Event()
    max_depth = [0]

    def client(i):
        x = _x(rows=1, seed=i)
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                pi.output(x)
                with lock:
                    lat_ok.append(time.monotonic() - t0)
            except (DeadlineExceeded, RequestRejected):
                with lock:
                    shed[0] += 1
                time.sleep(0.002)  # a real client backs off

    try:
        model.open.set()
        pi.warmup((N_IN,))
        model.open.clear()
        threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                    name=f"dl4j-test-ovl{i}") for i in range(16)]
        for t in threads:
            t.start()
        assert wait_until(lambda: pi.metrics()["rejected"] > 0, timeout=TIMEOUT), \
            "a full pipeline refused nothing"
        model.open.set()
        t_end = time.monotonic() + 1.0
        while time.monotonic() < t_end:
            max_depth[0] = max(max_depth[0], pi._q.qsize())
            time.sleep(0.01)
        stop.set()
        join_all(threads)
        m = _conserved(pi.metrics())
        assert m["shed"] + m["rejected"] > 0 and shed[0] > 0
        assert m["completed"] > 0 and len(lat_ok) == m["completed"]
        assert max_depth[0] <= 4, max_depth[0]
        bound = slo_ms / 1e3 + _WAIT_SHED_GRACE
        late = [t for t in lat_ok if t > bound + 1.0]
        assert not late, f"served past the backstop: {late[:5]}"
        for tr in _health.get_health().transitions_since(seq0):
            assert not tr["component"].startswith("chaos_ovl"), tr
    finally:
        stop.set()
        model.open.set()
        pi.shutdown()
