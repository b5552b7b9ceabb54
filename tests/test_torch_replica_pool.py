"""The port's self-healing ReplicaPool (deeplearning4j_tpu_torch/parallel/
inference.py) on the CPU: the cases of tests/test_replica_pool.py.

Wedge one replica's device forward under traffic and no caller sees an
error beyond the requests inside that forward: queued work re-routes to
a sibling, the watchdog's UNHEALTHY transition evicts the replica, a
fresh one respawns under the same component names, and the cycle shows
in `component_health` transitions and the `serving_replica_*` counters.
Where the outcome is deterministic the pool's outputs and books are held
to the JAX package's pool on the same weights (f32 rtol 1e-5).
"""

import threading
import time

import jax
import numpy as np
import pytest
from torch_serving import (
    TIMEOUT,
    http,
    join_all,
    mlp_pair,
    status_of,
    text_of,
    wait_until,
)

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.parallel.inference import ReplicaPool as JaxPool
from deeplearning4j_tpu_torch.parallel.inference import (
    ReplicaPool,
    RequestValidationError,
)
from deeplearning4j_tpu_torch.serving import InferenceServer
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics

N_IN = 6


def _pair(tmp_path):
    return mlp_pair(tmp_path, n_in=N_IN, hidden=8, n_out=3)


class WedgeableModel:
    """Delegates to a real net, but can be wedged: while `wedged` is set,
    `output` blocks on `release` — the dispatcher stuck inside a device
    forward that the watchdog exists to catch."""

    def __init__(self, net):
        self._net = net
        self.wedged = threading.Event()
        self.release = threading.Event()

    def _require_init(self):
        self._net._require_init()

    @property
    def device(self):
        return self._net.device

    @property
    def output_compile_count(self):
        return self._net.output_compile_count

    def output(self, x):
        if self.wedged.is_set():
            self.release.wait(timeout=TIMEOUT)
        return self._net.output(x)


def _wedgeable_pool(net, n=2, **kw):
    """A pool whose factory hands out fresh WedgeableModel wrappers over
    one shared net; returns (pool, made), made[i] the i-th spawned."""
    made = []

    def factory():
        m = WedgeableModel(net)
        made.append(m)
        return m

    kw.setdefault("max_batch_size", 8)
    kw.setdefault("batch_timeout_ms", 1.0)
    return ReplicaPool(model_factory=factory, n_replicas=n, **kw), made


def test_pool_serves_and_aggregates(tmp_path):
    jnet, tnet = _pair(tmp_path)
    pool = ReplicaPool(tnet, n_replicas=2, max_batch_size=8,
                       batch_timeout_ms=1.0, component_prefix="tp_basic")
    jpool = JaxPool(jnet, n_replicas=2, max_batch_size=8, batch_timeout_ms=1.0,
                    mesh=jpar.data_parallel_mesh(jax.devices()[:1]),
                    component_prefix="tp_basic_jax")
    x = np.random.default_rng(0).standard_normal((3, N_IN)).astype(np.float32)
    try:
        pool.warmup((N_IN,))
        jpool.warmup((N_IN,))
        outs = [pool.output(x) for _ in range(6)]
        want = np.asarray(jpool.output(x))
        for o in outs:
            assert o.shape == (3, 3)
            np.testing.assert_allclose(o, want, rtol=1e-5, atol=1e-6)
        m = pool.metrics()
        assert m["requests"] == 6 and m["in_rotation"] == 2
        assert m["evictions"] == 0
        # round-robin spread the traffic over both replicas
        served = [r["requests"] for r in m["replicas"]]
        assert all(s > 0 for s in served) and sum(served) == 6
        assert sorted(m) == sorted(jpool.metrics())
        comps = _health.get_health().status()["components"]
        assert "tp_basic_r0_dispatcher" in comps
        assert "tp_basic_r1_dispatcher" in comps
    finally:
        pool.shutdown()
        jpool.shutdown()
    # shutdown unregisters every replica's heartbeats
    comps = _health.get_health().status()["components"]
    assert not any(c.startswith("tp_basic_") for c in comps)


def test_explicit_evict_respawns_and_keeps_serving(tmp_path):
    _, tnet = _pair(tmp_path)
    pool = ReplicaPool(tnet, n_replicas=2, max_batch_size=8,
                       batch_timeout_ms=1.0, component_prefix="tp_evict")
    try:
        x = np.ones((2, N_IN), np.float32)
        pool.output(x)
        gen0 = pool.metrics()["replicas"][0]["generation"]
        pool.evict(0, "test eviction")
        assert wait_until(lambda: pool.metrics()["in_rotation"] == 2)
        m = pool.metrics()
        assert m["evictions"] == 1 and m["respawns"] == 1
        assert m["replicas"][0]["generation"] == gen0 + 1
        for _ in range(4):
            assert pool.output(x).shape == (2, 3)
        # the evicted replica's books stay in the aggregate
        m = pool.metrics()
        assert m["requests"] == 5 and m["completed"] == 5
    finally:
        pool.shutdown()


def test_wedged_replica_evicted_by_watchdog_only_inflight_fails(tmp_path):
    """Wedge one replica's forward under traffic: only a request inside
    that forward may fail; everything queued on the wedged replica or
    arriving during the eviction is served by a sibling; the watchdog ->
    eviction -> respawn cycle shows in the health transitions and the
    serving_replica_* counters."""
    _, tnet = _pair(tmp_path)
    evictions = _metrics.get_registry().get("serving_replica_evictions_total")
    seq0 = _health.get_health().last_seq()
    pool, models = _wedgeable_pool(tnet, component_prefix="tp_wedge",
                                   health_stall_after=0.15)
    x = np.ones((1, N_IN), np.float32)
    results, errors = [], []
    try:
        pool.warmup((N_IN,))
        models[0].wedged.set()

        def call(i):
            try:
                results.append((i, pool.output(x)))
            except Exception as e:
                errors.append((i, e))

        threads = [threading.Thread(target=call, args=(i,),
                                    name=f"dl4j-test-client-{i}")
                   for i in range(12)]
        for t in threads:
            t.start()
            time.sleep(0.01)
        assert wait_until(lambda: pool.metrics()["evictions"] >= 1,
                          timeout=15.0), "watchdog never triggered an eviction"
        models[0].wedged.clear()
        models[0].release.set()  # let the wedged daemon thread die
        join_all(threads)
        assert wait_until(lambda: pool.metrics()["in_rotation"] == 2,
                          timeout=15.0)
        assert len(results) >= 8, (
            f"{len(errors)} failures: {[repr(e) for _, e in errors]}")
        for _, e in errors:
            assert "in flight" in str(e) or "evicted" in str(e), repr(e)
        for _ in range(4):
            assert pool.output(x).shape == (1, 3)
        assert pool.metrics()["respawns"] >= 1
        trs = _health.get_health().transitions_since(seq0)
        assert any(t["component"].startswith("tp_wedge_r0_")
                   and t["to"] == _health.UNHEALTHY for t in trs)
        evictions = evictions or _metrics.get_registry().get(
            "serving_replica_evictions_total")
        assert evictions.labels("0").value >= 1
    finally:
        models[0].release.set()
        pool.shutdown()


def test_server_with_replicas_no_5xx_across_eviction(tmp_path):
    """An InferenceServer backed by a ReplicaPool keeps answering 200
    while a replica is evicted and respawned, and one /metrics scrape
    carries the pool's lifecycle numbers."""
    _, tnet = _pair(tmp_path)
    server = InferenceServer(tnet, max_batch_size=8, batch_timeout_ms=1.0,
                             n_replicas=2, warmup_shape=(N_IN,))
    port = server.start()
    url = f"http://127.0.0.1:{port}"
    try:
        body = {"features": np.ones((2, N_IN)).tolist()}
        assert status_of(f"{url}/predict", body)[0] == 200
        server.inference.evict(0, "operator kill")  # no in-flight work
        statuses = [status_of(f"{url}/predict", body)[0] for _ in range(8)]
        assert statuses == [200] * 8, statuses
        m = http(f"{url}/metrics")
        assert m["evictions"] >= 1 and m["n_replicas"] == 2
        text = text_of(f"{url}/metrics?format=prometheus")
        assert "serving_replica_evictions_total" in text
        assert "serving_replicas_in_rotation" in text
        assert "component_health" in text
    finally:
        server.stop()


def test_pool_validation_errors_propagate(tmp_path):
    jnet, tnet = _pair(tmp_path)
    for cls, net in ((ReplicaPool, tnet), (JaxPool, jnet)):
        pool = cls(net, n_replicas=2, max_batch_size=8,
                   component_prefix="tp_val", retry_window=1.0)
        try:
            with pytest.raises(ValueError) as ei:
                pool.output(np.ones((0, N_IN), np.float32))
            assert type(ei.value).__name__ == RequestValidationError.__name__
        finally:
            pool.shutdown()


def test_pool_shutdown_rejects_new_work(tmp_path):
    _, tnet = _pair(tmp_path)
    pool = ReplicaPool(tnet, n_replicas=1, max_batch_size=8,
                       component_prefix="tp_down", retry_window=0.5)
    pool.shutdown()
    with pytest.raises(RuntimeError):
        pool.output(np.ones((1, N_IN), np.float32))
