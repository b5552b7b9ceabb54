"""The port's bucketed, pipelined serving (deeplearning4j_tpu_torch/
parallel/inference.py, serving/inference_server.py) held against the
JAX package's on the CPU: the cases of tests/test_inference_serving.py,
each sending the same requests through both packages' ParallelInference
or InferenceServer on the same weights (carried by the model zip).

Outputs agree at f32 rtol 1e-5; forward-cache insertions
(`output_compile_count`), bucket hits where the grouping is
deterministic, JSON keys and status codes are equal. A fused or padded
row is held against the per-request forward at ROW_RTOL / ROW_ATOL, not
byte for byte: the JAX package's own exact-row check fails on its CPU
backend (XLA rounds a matmul differently at another batch size).
"""

import threading

import jax
import numpy as np
import pytest
from torch_serving import (
    ROW_ATOL,
    ROW_RTOL,
    TIMEOUT,
    host,
    http,
    join_all,
    mlp_pair,
    requests,
    status_of,
    twin,
    two_head_pair,
)

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.serving import InferenceServer as JaxServer
from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.serving import InferenceServer

F32 = dict(rtol=1e-5, atol=1e-6)


def _jmesh():
    """A one-device JAX mesh: the port serves on one device, and the JAX
    package's forward-cache count depends on its shard count (a bucket
    pads to a multiple of it)."""
    return jpar.data_parallel_mesh(jax.devices()[:1])


def _both(jnet, tnet, **kw):
    return (jpar.ParallelInference(jnet, _jmesh(), **kw),
            tpar.ParallelInference(tnet, tpar.data_parallel_mesh(), **kw))


def _concurrent(pi, xs):
    results = {}

    def call(i):
        results[i] = pi.output(xs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    join_all(threads)
    return results


# -- bucket policy ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 48, 64, 100])
def test_default_bucket_set(n):
    assert tpar.power_of_two_buckets(n) == jpar.power_of_two_buckets(n)
    assert tpar.power_of_two_buckets(64) == [1, 2, 4, 8, 16, 32, 64]


def test_custom_buckets_validated(tmp_path):
    jnet, tnet = mlp_pair(tmp_path)
    for pkg, net in ((jpar, jnet), (tpar, tnet)):
        with pytest.raises(ValueError, match="bucket"):
            pkg.ParallelInference(net, max_batch_size=32, buckets=[4, 8])
        with pytest.raises(ValueError, match="max_batch_size"):
            pkg.ParallelInference(net, max_batch_size=0)
    jpi, tpi = _both(jnet, tnet, max_batch_size=32, buckets=[8, 32, 16],
                     inference_mode=tpar.InferenceMode.SEQUENTIAL)
    assert tpi.buckets == jpi.buckets == [8, 16, 32]


def test_empty_request_rejected(tmp_path):
    """A 0-row request is refused at admission in both packages and adds
    no forward-cache entry."""
    jnet, tnet = mlp_pair(tmp_path)
    jpi, tpi = _both(jnet, tnet, max_batch_size=8)
    try:
        for pi, net in ((jpi, jnet), (tpi, tnet)):
            before = net.output_compile_count
            with pytest.raises(ValueError, match="empty"):
                pi.output(np.zeros((0, 12), np.float32))
            assert net.output_compile_count == before
    finally:
        jpi.shutdown()
        tpi.shutdown()


# -- forward-cache stability ------------------------------------------------

def test_mixed_sizes_bounded_compiles_and_close_results(tmp_path):
    """Ten distinct concurrent request sizes through BATCHED mode: the
    warm-up's cache insertions equal the JAX package's compiles (one per
    bucket), traffic adds none, and each caller's rows agree with its
    own per-request output (ROW_RTOL) and with the JAX package's."""
    jnet, tnet = mlp_pair(tmp_path)
    jpi, tpi = _both(jnet, tnet, max_batch_size=16)
    sizes = [1, 2, 3, 5, 8, 11, 16, 4, 7, 13]
    xs = requests(sizes)
    try:
        assert tpi.buckets == jpi.buckets == [1, 2, 4, 8, 16]
        jpi.warmup((12,))
        tpi.warmup((12,))
        warm = tnet.output_compile_count
        assert warm == jnet.output_compile_count == len(tpi.buckets)
        got = _concurrent(tpi, xs)
        want = _concurrent(jpi, xs)
        assert tnet.output_compile_count == warm
        assert jnet.output_compile_count == warm
        m = tpi.metrics()
        assert m["requests"] == len(sizes) and m["examples"] == sum(sizes)
        assert m["oversized"] == 0
        assert sum(m["bucket_hits"].values()) == m["batches"] > 0
        assert sorted(m) == sorted(jpi.metrics())
    finally:
        jpi.shutdown()
        tpi.shutdown()
    for i, x in enumerate(xs):
        np.testing.assert_allclose(got[i], host(tnet.output(x)),
                                   rtol=ROW_RTOL, atol=ROW_ATOL)
        np.testing.assert_allclose(got[i], np.asarray(want[i]), **F32)


def test_sequential_mode_is_bucketed_too(tmp_path):
    """SEQUENTIAL mode runs each request alone at its bucket: the same
    cache insertions and the same bucket hits as the JAX package."""
    jnet, tnet = mlp_pair(tmp_path)
    ref = twin(jnet, tmp_path)  # same weights, its own forward cache
    jpi, tpi = _both(jnet, tnet, max_batch_size=16,
                     inference_mode=tpar.InferenceMode.SEQUENTIAL)
    jpi.warmup((12,))
    tpi.warmup((12,))
    warm = tnet.output_compile_count
    assert warm == jnet.output_compile_count
    for x in requests([3, 5, 9, 13, 16, 1]):
        out = tpi.output(x)
        np.testing.assert_allclose(out, host(ref.output(x)),
                                   rtol=ROW_RTOL, atol=ROW_ATOL)
        np.testing.assert_allclose(out, np.asarray(jpi.output(x)), **F32)
    assert tnet.output_compile_count == warm == jnet.output_compile_count
    assert tpi.metrics()["bucket_hits"] == jpi.metrics()["bucket_hits"]


def test_oversized_request_served_alone(tmp_path):
    jnet, tnet = mlp_pair(tmp_path)
    jpi, tpi = _both(jnet, tnet, max_batch_size=8)
    try:
        x = requests([24])[0]
        out = tpi.output(x)
        assert out.shape == (24, 4)
        np.testing.assert_allclose(out, np.asarray(jpi.output(x)), **F32)
        assert tpi.metrics()["oversized"] == jpi.metrics()["oversized"] == 1
    finally:
        jpi.shutdown()
        tpi.shutdown()


def test_output_cache_is_shape_keyed_multilayer(tmp_path):
    jnet, tnet = mlp_pair(tmp_path)
    x8, x16 = requests([8, 16])
    counts = []
    for net in (jnet, tnet):
        seen = [net.output_compile_count]
        net.output(x8)
        net.output(x8)  # same shape: cache hit
        seen.append(net.output_compile_count)
        net.output(x16)
        seen.append(net.output_compile_count)
        net.output(x8, training=True)  # one entry per training flag
        seen.append(net.output_compile_count)
        counts.append(seen)
    assert counts[1] == counts[0] == [0, 1, 2, 3]


def test_output_cache_is_shape_keyed_compgraph(tmp_path):
    from deeplearning4j_tpu.nn.compgraph import ComputationGraph
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )

    conf = (NeuralNetConfiguration.builder()
            .seed(7).updater(Updater.SGD).learning_rate(0.05)
            .weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_in=12, n_out=16, activation="tanh"),
                       "in")
            .add_layer("out", OutputLayer(n_in=16, n_out=4,
                                          activation="softmax",
                                          loss="mcxent"), "d")
            .set_outputs("out")
            .build())
    jg = ComputationGraph(conf).init()
    tg = twin(jg, tmp_path)
    x8, x16 = requests([8, 16])
    counts = []
    for g in (jg, tg):
        g.output(x8)
        g.output(x8)
        seen = [g.output_compile_count]
        g.output(x16)
        seen.append(g.output_compile_count)
        counts.append(seen)
    assert counts[1] == counts[0] == [1, 2]


def test_multi_output_graph_through_parallel_inference(tmp_path):
    """A multi-output graph's output() is a list: the batch slice and the
    scatter apply per head."""
    jg, tg = two_head_pair(tmp_path)
    ref = twin(jg, tmp_path)
    jpi, tpi = _both(jg, tg, max_batch_size=8)
    xs = requests([3, 5, 2])
    try:
        got = _concurrent(tpi, xs)
        want = _concurrent(jpi, xs)
    finally:
        jpi.shutdown()
        tpi.shutdown()
    for i, x in enumerate(xs):
        out = got[i]
        assert isinstance(out, list) and len(out) == 2
        assert out[0].shape == (x.shape[0], 4)
        assert out[1].shape == (x.shape[0], 2)
        for head, r, j in zip(out, ref.output(x), want[i]):
            np.testing.assert_allclose(head, host(r), rtol=ROW_RTOL,
                                       atol=ROW_ATOL)
            np.testing.assert_allclose(head, np.asarray(j), **F32)


def test_multi_output_graph_through_inference_server(tmp_path):
    """/predict on a two-head graph returns one predictions entry per
    head, in both packages."""
    jg, tg = two_head_pair(tmp_path)
    x = requests([3])[0]
    preds = []
    for cls, net, mesh in ((JaxServer, jg, _jmesh()), (InferenceServer, tg, None)):
        server = cls(net, mesh=mesh, max_batch_size=8, warmup_shape=(12,))
        port = server.start()
        try:
            preds.append(http(f"http://127.0.0.1:{port}/predict",
                              {"features": x.tolist()})["predictions"])
        finally:
            server.stop()
    jp, tp = preds
    assert len(tp) == len(jp) == 2
    for t_head, j_head in zip(tp, jp):
        np.testing.assert_allclose(np.asarray(t_head, np.float32),
                                   np.asarray(j_head, np.float32), **F32)


# -- admission races --------------------------------------------------------

def test_first_request_shape_race(tmp_path):
    """Two feature shapes racing to be the first request: one pins the
    shape under the admission lock, every loser is refused at admission
    (ValueError), and a correctly shaped caller never fails because of
    the other shape. The model-incompatible shape may win the pin, then
    fails at the model and unpins, so the endpoint is never poisoned."""
    jnet, _ = mlp_pair(tmp_path)
    for attempt in range(4):
        tnet = twin(jnet, tmp_path)
        pi = tpar.ParallelInference(tnet, tpar.data_parallel_mesh(),
                                    max_batch_size=32)
        try:
            n_each = 6
            xs = (requests([4] * n_each, n_in=12)
                  + requests([4] * n_each, n_in=7, seed=1))
            start = threading.Barrier(2 * n_each)
            outcomes = {}

            def call(i):
                start.wait()
                try:
                    outcomes[i] = pi.output(xs[i]).shape
                except ValueError:
                    outcomes[i] = "rejected"
                except Exception as e:
                    outcomes[i] = ("failed", type(e).__name__)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(xs))]
            for t in threads:
                t.start()
            join_all(threads)
            for i, x in enumerate(xs):
                o = outcomes[i]
                if x.shape[1:] == (12,):
                    assert o in ("rejected", (4, 4)), (i, o)
                else:
                    assert o == "rejected" or (
                        isinstance(o, tuple) and o[0] == "failed"), (i, o)
            assert pi.output(requests([4])[0]).shape == (4, 4)
        finally:
            pi.shutdown()


def test_bad_first_request_does_not_poison_endpoint(tmp_path):
    """A first request of a width the model rejects pins the shape only
    provisionally; its failed forward unpins it and later well-formed
    requests are served — in both packages, with the same result."""
    jnet, tnet = mlp_pair(tmp_path)
    jpi, tpi = _both(jnet, tnet, max_batch_size=8)
    x = requests([3])[0]
    try:
        outs = []
        for pi in (jpi, tpi):
            with pytest.raises(Exception):
                pi.output(np.zeros((2, 7), np.float32))  # model wants 12
            outs.append(np.asarray(pi.output(x)))
        assert outs[1].shape == (3, 4)
        np.testing.assert_allclose(outs[1], host(tnet.output(x)),
                                   rtol=ROW_RTOL, atol=ROW_ATOL)
        np.testing.assert_allclose(outs[1], outs[0], **F32)
    finally:
        jpi.shutdown()
        tpi.shutdown()


def test_shutdown_under_load_no_hung_futures(tmp_path):
    """Requests racing shutdown(): each caller gets a result or a fast
    RuntimeError, never a future that hangs."""
    _, tnet = mlp_pair(tmp_path)
    pi = tpar.ParallelInference(tnet, tpar.data_parallel_mesh(),
                                max_batch_size=8, batch_timeout_ms=1.0)
    pi.warmup((12,))
    x = requests([2])[0]
    served, rejected, hung = [], [], []

    def client(i):
        try:
            assert pi.output(x).shape == (2, 4)
            served.append(i)
        except RuntimeError:
            rejected.append(i)
        except BaseException:
            hung.append(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
    killer = threading.Thread(target=pi.shutdown)
    for j, t in enumerate(threads):
        t.start()
        if j == 12:  # shut down mid-stream
            killer.start()
    join_all([killer] + threads)
    assert not hung
    assert len(served) + len(rejected) == 32
    with pytest.raises(RuntimeError, match="shut down"):
        pi.output(x)


# -- REST server ------------------------------------------------------------

_BAD_PAYLOADS = ({"features": [[1.0, 2.0]]},  # wrong width
                 {"features": 3.5},           # scalar
                 {"features": []},            # empty
                 {})                          # missing key


def _route_walk(server_cls, net, x, mesh=None):
    """Drive every route of one server; returns what both packages must
    agree on."""
    server = server_cls(net, mesh=mesh, max_batch_size=8, warmup_shape=(12,))
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    rec = {}
    try:
        rec["health"] = http(f"{base}/health")
        rec["preds"] = np.asarray(http(f"{base}/predict", {"features": x.tolist()})
                                  ["predictions"], np.float32)
        rec["single"] = np.asarray(http(f"{base}/predict", {"features": x[0].tolist()})
                                   ["predictions"], np.float32)
        rec["metrics"] = http(f"{base}/metrics")
        rec["bad"] = [status_of(f"{base}/predict", p)[0] for p in _BAD_PAYLOADS]
        rec["missing_route"] = status_of(f"{base}/nosuch")[0]
        rec["generate_off"] = status_of(f"{base}/generate", {"prompt": [1]})[0]
        rec["health_after"] = http(f"{base}/health")["status"]
        rec["tenants_keys"] = sorted(http(f"{base}/tenants"))
        rec["prom"] = status_of(f"{base}/metrics?format=prometheus")[0]
        # server-side faults are 5xx, not mislabeled 400s: stop the
        # inference engine under the still-serving HTTP layer
        server.inference.shutdown()
        rec["after_shutdown"] = status_of(f"{base}/predict", {"features": x.tolist()})[0]
    finally:
        server.stop()
    return rec


def test_inference_server_routes(tmp_path, monkeypatch):
    from deeplearning4j_tpu.utils import resourcemeter as jrm
    from deeplearning4j_tpu_torch.utils import resourcemeter as trm

    # both packages unmetered, whatever an earlier test in this process
    # armed: /tenants answers with the meter's state
    monkeypatch.setattr(jrm, "_METER", None)
    monkeypatch.setattr(trm, "_METER", None)
    jnet, tnet = mlp_pair(tmp_path)
    x = requests([3])[0]
    t = _route_walk(InferenceServer, tnet, x)
    j = _route_walk(JaxServer, jnet, x, mesh=_jmesh())
    assert t["health"]["status"] == j["health"]["status"] == "ok"
    assert t["health"]["model"] == j["health"]["model"] == "MultiLayerNetwork"
    assert t["health"]["feature_shape"] == j["health"]["feature_shape"] == [12]
    assert sorted(t["health"]) == sorted(j["health"])
    np.testing.assert_allclose(t["preds"], host(tnet.output(x)), rtol=ROW_RTOL,
                               atol=ROW_ATOL)
    np.testing.assert_allclose(t["preds"], j["preds"], **F32)
    np.testing.assert_allclose(t["single"], t["preds"][0], rtol=ROW_RTOL,
                               atol=ROW_ATOL)
    tm, jm = t["metrics"], j["metrics"]
    assert sorted(tm) == sorted(jm)
    assert sorted(tm["latency_ms"]) == sorted(jm["latency_ms"])
    assert tm["requests"] == jm["requests"] == 2
    assert tm["latency_ms"]["count"] == 2 and tm["latency_ms"]["p99_ms"] is not None
    assert tm["bucket_hits"] == jm["bucket_hits"]
    assert set(tm["bucket_hits"]) == {"1", "2", "4", "8"}
    assert tm["forward_compiles"] == jm["forward_compiles"] == 4
    assert tm["queue_depth"] == 0
    assert t["bad"] == j["bad"] == [400, 400, 400, 400]
    assert t["missing_route"] == j["missing_route"] == 404
    assert t["generate_off"] == j["generate_off"] == 404
    assert t["health_after"] == "ok"
    assert t["tenants_keys"] == j["tenants_keys"]
    assert t["prom"] == j["prom"] == 200
    assert t["after_shutdown"] == j["after_shutdown"] == 500


def test_inference_server_concurrent_load(tmp_path):
    """Many clients with mixed sizes through REST, fused dispatch and
    bucket padding: every response has its shape, nothing is inserted
    into the forward cache after warm-up, the books add up."""
    _, tnet = mlp_pair(tmp_path)
    server = InferenceServer(tnet, max_batch_size=16, warmup_shape=(12,),
                             batch_timeout_ms=1.0)
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    warm = tnet.output_compile_count
    sizes = [int(s) for s in np.random.default_rng(0).integers(1, 17, size=32)]
    xs = requests(sizes)
    errors = []

    def client(i):
        try:
            preds = np.asarray(http(f"{base}/predict", {"features": xs[i].tolist()})
                               ["predictions"], np.float32)
            if preds.shape != (sizes[i], 4):
                errors.append((i, preds.shape))
        except BaseException as e:
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(xs))]
    try:
        for t in threads:
            t.start()
        join_all(threads, timeout=2 * TIMEOUT)
        assert not errors, errors[:5]
        assert warm == len(server.inference.buckets)
        assert tnet.output_compile_count == warm
        m = http(f"{base}/metrics")
        assert m["requests"] == len(xs) and m["examples"] == sum(sizes)
        assert m["latency_ms"]["count"] == len(xs)
        assert m["admitted"] == m["completed"] == len(xs)
    finally:
        server.stop()


def test_books_exact_under_thread_stress(tmp_path):
    """More client threads than cores, with the interpreter switching
    threads every microsecond: no admission, completion or bucket hit is
    lost (a lost update under the admission lock would break one of the
    equalities), and float64 requests share the float32 warm-up's cache
    entries."""
    import sys

    _, tnet = mlp_pair(tmp_path)
    pi = tpar.ParallelInference(tnet, max_batch_size=8, batch_timeout_ms=0.5)
    sizes = [1 + (i * 5) % 8 for i in range(96)]
    xs = requests(sizes, seed=3)
    switch = sys.getswitchinterval()
    try:
        pi.warmup((12,))
        warm = tnet.output_compile_count
        sys.setswitchinterval(1e-6)
        got = _concurrent(pi, [x.astype(np.float64) for x in xs])
    finally:
        sys.setswitchinterval(switch)
        pi.shutdown()
    m = pi.metrics()
    assert m["requests"] == m["admitted"] == m["completed"] == len(xs)
    assert m["examples"] == sum(sizes)
    assert sum(m["bucket_hits"].values()) == m["batches"]
    assert m["conservation_ok"] and m["failed"] == m["shed"] == 0
    assert tnet.output_compile_count == warm
    for i, x in enumerate(xs):
        np.testing.assert_allclose(got[i], host(tnet.output(x)), rtol=ROW_RTOL,
                                   atol=ROW_ATOL)
