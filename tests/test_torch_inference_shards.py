"""The port's ParallelInference sharded over several devices of one
process (`devices=`, deeplearning4j_tpu_torch/parallel/inference.py) held
against the JAX package's on its 8-device CPU mesh (tests/conftest.py
forces 8 host devices): the port runs `devices=["cpu"] * 8`, the same
eight-way split.

Bucket lists and forward-cache insertions (`output_compile_count`) are
equal, and both equal `_expected_traces(buckets, 8)` of
tests/test_inference_serving.py (a bucket below the shard count pads up
to it). A group's rows are byte-identical to the same padded group
forwarded block by block on one device (the split changes nothing but
where the blocks run), within ROW_RTOL of the per-request output() (a
one-row block takes another matmul path on the CPU than a wider batch,
2e-7 apart), and within f32 rtol 1e-5 of the JAX package's rows.
"""

import threading
import types

import numpy as np
import pytest
import torch
from torch_serving import (
    ROW_ATOL,
    ROW_RTOL,
    http,
    join_all,
    mlp_pair,
    requests,
    two_head_pair,
)

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.serving import InferenceServer as JaxServer
from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.parallel import inference
from deeplearning4j_tpu_torch.parallel.inference import ReplicaPool
from deeplearning4j_tpu_torch.parallel.mesh import pad_wrap
from deeplearning4j_tpu_torch.serving import InferenceServer

F32 = dict(rtol=1e-5, atol=1e-6)
SHARDS = 8


def _expected_traces(buckets, n_shards):
    """Distinct padded shapes: each bucket is padded up to a multiple of
    the shard count before dispatch, so buckets below it collapse (the
    JAX package's test helper of the same name)."""
    return len({b + (-b) % n_shards for b in buckets})


def _blockwise(net, x, bucket, n_shards):
    """The padded group forwarded block by block on the net's device,
    joined and cut: what a sharded forward must give, bit for bit."""
    padded = pad_wrap(pad_wrap(x, bucket), n_shards)
    outs = [net.output(b) for b in np.split(padded, n_shards)]
    if isinstance(outs[0], list):
        return [torch.cat(col).numpy()[:len(x)] for col in zip(*outs)]
    return torch.cat(outs).numpy()[:len(x)]


def _concurrent(pi, xs):
    results = {}

    def call(i):
        results[i] = pi.output(xs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    join_all(threads)
    return results


def test_eight_shards_match_the_jax_mesh(tmp_path):
    """Mixed concurrent request sizes through both packages at 8 shards:
    equal buckets and cache insertions (2 for buckets 1..16), none added
    by traffic, and each caller's rows against its own forward and the
    JAX package's."""
    jnet, tnet = mlp_pair(tmp_path)
    jpi = jpar.ParallelInference(jnet, max_batch_size=16)
    tpi = tpar.ParallelInference(tnet, devices=["cpu"] * SHARDS,
                                 max_batch_size=16)
    sizes = [1, 2, 3, 5, 8, 11, 16, 4, 7, 13]
    xs = requests(sizes)
    try:
        assert jpi.n_shards == tpi.n_shards == SHARDS
        assert tpi.buckets == jpi.buckets == [1, 2, 4, 8, 16]
        jpi.warmup((12,))
        tpi.warmup((12,))
        want = _expected_traces(tpi.buckets, SHARDS)
        assert tnet.output_compile_count == jnet.output_compile_count == want == 2
        got = _concurrent(tpi, xs)
        assert tnet.output_compile_count == want
        m = tpi.metrics()
        assert (m["requests"], m["examples"]) == (len(sizes), sum(sizes))
        jgot = _concurrent(jpi, xs)
    finally:
        jpi.shutdown()
        tpi.shutdown()
    for i, x in enumerate(xs):
        assert got[i].shape == (sizes[i], 4)
        np.testing.assert_allclose(got[i], tnet.output(x).numpy(),
                                   rtol=ROW_RTOL, atol=ROW_ATOL)
        np.testing.assert_allclose(got[i], np.asarray(jgot[i]), **F32)


@pytest.mark.parametrize("size", [1, 3, 8, 13, 16])
def test_sharded_rows_are_the_blockwise_forward(tmp_path, size):
    """One request alone: its rows are byte-identical to the bucket- and
    shard-padded group forwarded block by block, and within f32 rtol of
    the JAX package's 8-device forward of the same request."""
    jnet, tnet = mlp_pair(tmp_path)
    (x,) = requests([size], seed=size)
    tpi = tpar.ParallelInference(tnet, devices=["cpu"] * SHARDS,
                                 max_batch_size=16)
    jpi = jpar.ParallelInference(jnet, max_batch_size=16)
    try:
        got = tpi.output(x)
        jgot = np.asarray(jpi.output(x))
    finally:
        tpi.shutdown()
        jpi.shutdown()
    bucket = tpi._bucket_for(size)
    np.testing.assert_array_equal(got, _blockwise(tnet, x, bucket, SHARDS))
    np.testing.assert_allclose(got, jgot, **F32)


def test_three_shards_do_not_divide_the_group(tmp_path):
    """3 shards: every bucket wraps up to a multiple of 3 (1, 2 -> 3;
    4 -> 6; 8 -> 9), each a cache entry of its own, an oversized request
    too, and the rows are the blockwise forward's."""
    _, tnet = mlp_pair(tmp_path)
    tpi = tpar.ParallelInference(tnet, devices=["cpu"] * 3, max_batch_size=8,
                                 inference_mode=tpar.InferenceMode.SEQUENTIAL)
    try:
        assert tpi.n_shards == 3
        tpi.warmup((12,))
        assert tnet.output_compile_count == _expected_traces(tpi.buckets, 3) == 3
        xs = requests([1, 5, 8, 10], seed=3)  # 10: no bucket, 12 rows
        got = [tpi.output(x) for x in xs]
        assert tpi.metrics()["oversized"] == 1
        assert tnet.output_compile_count == 4
    finally:
        tpi.shutdown()
    for x, g in zip(xs, got):
        bucket = tpi._bucket_for(len(x)) or len(x)
        np.testing.assert_array_equal(g, _blockwise(tnet, x, bucket, 3))


def test_multi_output_graph_over_shards(tmp_path):
    """A two-head graph split over 8 shards: each head is joined per
    output and cut to the caller's rows, and both agree with the JAX
    package's 8-device forward."""
    jg, tg = two_head_pair(tmp_path)
    tpi = tpar.ParallelInference(tg, devices=["cpu"] * SHARDS, max_batch_size=8)
    jpi = jpar.ParallelInference(jg, max_batch_size=8)
    xs = requests([1, 5, 8], seed=5)
    try:
        got = [tpi.output(x) for x in xs]
        jgot = [jpi.output(x) for x in xs]
        assert tg.output_compile_count == jg.output_compile_count == 1
    finally:
        tpi.shutdown()
        jpi.shutdown()
    for x, g, j in zip(xs, got, jgot):
        assert isinstance(g, list) and [o.shape for o in g] == \
            [(len(x), 4), (len(x), 2)]
        want = _blockwise(tg, x, tpi._bucket_for(len(x)), SHARDS)
        for o, w, jo in zip(g, want, j):
            np.testing.assert_array_equal(o, w)
            np.testing.assert_allclose(o, np.asarray(jo), **F32)


def test_replica_pool_passes_devices_on(tmp_path):
    """A two-replica pool with devices=: every replica shards over them,
    and the pool's rows equal the JAX pool's on its 8-device mesh."""
    from deeplearning4j_tpu.parallel.inference import ReplicaPool as JaxPool

    jnet, tnet = mlp_pair(tmp_path)
    pool = ReplicaPool(tnet, n_replicas=2, devices=["cpu"] * SHARDS,
                       max_batch_size=8)
    jpool = JaxPool(jnet, n_replicas=2, max_batch_size=8)
    try:
        assert all(pi.n_shards == SHARDS for pi in pool._replicas)
        for x in requests([3, 6, 1, 8]):
            np.testing.assert_allclose(pool.output(x), np.asarray(jpool.output(x)),
                                       **F32)
        assert pool.metrics()["requests"] == 4
    finally:
        pool.shutdown()
        jpool.shutdown()


def test_inference_server_passes_devices_on(tmp_path):
    """/predict through the port's server with devices=: the server's
    pipeline has 8 shards and answers as the JAX server on its 8-device
    mesh, with equal forward-cache insertions after warm-up."""
    jnet, tnet = mlp_pair(tmp_path)
    server = InferenceServer(tnet, devices=["cpu"] * SHARDS, max_batch_size=8,
                             warmup_shape=(12,))
    jserver = JaxServer(jnet, max_batch_size=8, warmup_shape=(12,))
    (x,) = requests([5], seed=7)
    try:
        assert server.inference.n_shards == SHARDS
        assert tnet.output_compile_count == jnet.output_compile_count == 1
        got = []
        for srv in (server, jserver):
            port = srv.start()
            got.append(np.asarray(http(f"http://127.0.0.1:{port}/predict",
                                       {"features": x.tolist()})["predictions"]))
    finally:
        server.stop()
        jserver.stop()
    np.testing.assert_allclose(got[0], got[1], **F32)


def test_default_devices_and_the_process_mesh_refusal(tmp_path):
    """Without devices= a model serves on its own device alone, a CUDA
    model too (the old path; sharding is opt-in); a mesh whose data axis
    spans several processes is still refused, and the message points to
    devices=."""
    _, tnet = mlp_pair(tmp_path)
    pi = tpar.ParallelInference(tnet, max_batch_size=4)
    try:
        assert pi.devices == [torch.device("cpu")] and pi.n_shards == 1
    finally:
        pi.shutdown()
    cuda1 = torch.device("cuda", 1)
    assert inference._shard_devices(cuda1) == [cuda1]
    assert inference._shard_devices(cuda1, ["cuda:0", "cuda:1"]) == \
        [torch.device("cuda", 0), cuda1]
    two_ranks = types.SimpleNamespace(shape={"data": 2, "model": 1})
    with pytest.raises(ValueError, match=r"devices="):
        tpar.ParallelInference(tnet, two_ranks)
    with pytest.raises(ValueError, match="at least one device"):
        tpar.ParallelInference(tnet, devices=[])


@pytest.fixture
def copied_replicas(monkeypatch):
    """No shard device counts as the model's own, so every block reads a
    replica copied from the model (on the CPU, a copy on the same device):
    the path a shard on another GPU takes."""
    monkeypatch.setattr(inference, "_same_device", lambda a, b: False)


def test_replicas_follow_the_model_between_requests(tmp_path, copied_replicas):
    """Between two requests the model changes: set_params, a fit step,
    an in-place edit. The next request reads the new weights on every
    shard, as the JAX pipeline reads model.params_list at each forward."""
    _, tnet = mlp_pair(tmp_path)
    cpu = torch.device("cpu")
    tpi = tpar.ParallelInference(tnet, devices=["cpu"] * 2, max_batch_size=8,
                                 inference_mode=tpar.InferenceMode.SEQUENTIAL)
    (x,) = requests([8], seed=11)
    rng = np.random.default_rng(12)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]

    def set_params():
        tnet.set_params(tnet.params() * 0.5)

    def fit_step():
        tnet.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)

    def edit_in_place():
        with torch.no_grad():
            tnet.params_list[0]["W"].mul_(-1.0)

    try:
        first = tpi.output(x)
        replica = inference._replica(tnet, cpu)
        assert replica[0][0]["W"] is not tnet.params_list[0]["W"]
        assert inference._replica(tnet, cpu) is replica  # unchanged: reused
        before = first
        for change in (set_params, fit_step, edit_in_place):
            change()
            got = tpi.output(x)
            assert not np.array_equal(got, before), change.__name__
            np.testing.assert_array_equal(
                got, _blockwise(tnet, x, tpi._bucket_for(8), 2))
            before = got
    finally:
        tpi.shutdown()


def test_a_pool_shares_one_replica_per_device(tmp_path, copied_replicas):
    """A two-replica pool over two shards of one device holds one copy of
    the shared model's parameters, not one per pipeline or per shard."""
    _, tnet = mlp_pair(tmp_path)
    pool = ReplicaPool(tnet, n_replicas=2, devices=["cpu"] * 2, max_batch_size=8)
    try:
        for x in requests([3, 6, 1, 8]):
            np.testing.assert_allclose(pool.output(x), tnet.output(x).numpy(),
                                       rtol=ROW_RTOL, atol=ROW_ATOL)
        assert list(inference._REPLICAS[tnet]) == ["cpu"]
    finally:
        pool.shutdown()
