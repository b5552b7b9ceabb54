"""The port's parameter server (deeplearning4j_tpu_torch/parallel/
paramserver.py): the JAX package's paramserver and failover cases run on
the port with their bounds as written, then the two packages against
each other — a port client on a JAX server and a JAX client on a port
server, f32 and bf16 wire, give byte-equal pulls after the same pushes;
a journal and snapshot written by one package restore in the other to
bit-equal tables; `_bf16_from_f32` is bit-equal to the JAX function on
signed zeros, infinities, NaN payloads and round-half ties.

Everything here is numpy on the host: exact equality throughout, except
the bounds the JAX cases state (rtol 1e-6 on f32 round trips, 1e-2 on
bf16 ones, the convergence and timing bounds)."""

import os
import struct
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.parallel import paramserver as jps
from deeplearning4j_tpu_torch.parallel import paramserver as tps
from deeplearning4j_tpu_torch.parallel.paramserver import (
    EmbeddingParameterServer,
    EmbeddingPSClient,
    _pack_request,
)
from deeplearning4j_tpu_torch.utils import faultpoints as fp

PKGS = {"jax": jps, "port": tps}


def _wait_until(pred, timeout=10.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


# -- the JAX package's paramserver cases, on the port ---------------------------


def test_pull_push_round_trip_sharded():
    rng = np.random.default_rng(0)
    t0 = rng.standard_normal((10, 4)).astype(np.float32)
    s1 = EmbeddingParameterServer({"syn0": t0.copy()})
    s2 = EmbeddingParameterServer({"syn0": t0.copy()})
    p1, p2 = s1.start(), s2.start()
    client = EmbeddingPSClient(
        [f"http://127.0.0.1:{p1}", f"http://127.0.0.1:{p2}"])
    try:
        rows = np.array([3, 0, 7, 2])
        got = client.pull("syn0", rows)
        np.testing.assert_allclose(got, t0[rows], rtol=1e-6)

        deltas = np.ones((4, 4), np.float32)
        client.push_async("syn0", rows, deltas)
        client.flush()
        got2 = client.pull("syn0", rows)
        np.testing.assert_allclose(got2, t0[rows] + 1.0, rtol=1e-6)
        # each row landed only on its modulo-owner
        assert s1.pushes_applied >= 1 and s2.pushes_applied >= 1
    finally:
        client.close()
        s1.stop()
        s2.stop()


def test_two_workers_async_sgd_converges():
    """Two workers doing Hogwild-style pulls/pushes against one server
    drive a toy embedding objective down (async-SGD semantics, with the
    reference's acknowledged nondeterminism)."""
    rng = np.random.default_rng(1)
    vocab, dim = 30, 8
    server = EmbeddingParameterServer({
        "syn0": (rng.standard_normal((vocab, dim)) * 0.1).astype(np.float32)})
    port = server.start()
    url = f"http://127.0.0.1:{port}"
    target = np.zeros((vocab, dim), np.float32)
    target[::2, 0] = 1.0
    target[1::2, 0] = -1.0

    def worker(seed):
        client = EmbeddingPSClient([url])
        w_rng = np.random.default_rng(seed)
        for _ in range(60):
            rows = w_rng.choice(vocab, size=8, replace=False)
            vecs = client.pull("syn0", rows)
            grad = vecs - target[rows]
            client.push_async("syn0", rows, -0.3 * grad)
        client.flush()
        client.close()

    threads = [threading.Thread(target=worker, args=(s,)) for s in (7, 8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        final = server.tables["syn0"]
        err = float(np.mean((final - target) ** 2))
        assert err < 0.02, err
        assert server.pushes_applied > 100
    finally:
        server.stop()


def test_empty_pull_returns_well_formed_array():
    server = EmbeddingParameterServer({"syn0": np.zeros((6, 5), np.float32)})
    port = server.start()
    client = EmbeddingPSClient([f"http://127.0.0.1:{port}"])
    try:
        out = client.pull("syn0", np.array([], np.int64))
        assert out.shape == (0, 5) and out.dtype == np.float32
    finally:
        client.close()
        server.stop()


def test_dead_endpoint_drops_push_and_counts_it():
    """A dead shard must not kill the drain thread — the push is dropped,
    counted, and later pushes to live endpoints still apply
    (replay_capacity=0: the degrade-by-dropping path)."""
    server = EmbeddingParameterServer({"syn0": np.zeros((4, 3), np.float32)})
    port = server.start()
    client = EmbeddingPSClient(
        [f"http://127.0.0.1:{port}", "http://127.0.0.1:1"],
        timeout=2.0, max_retries=1, retry_backoff=0.01, replay_capacity=0)
    try:
        rows = np.array([1, 3])  # odd rows -> owner 1 (the dead one)
        client.push_async("syn0", rows, np.ones((2, 3), np.float32))
        client.flush()
        assert client.dropped_pushes == 1
        client.push_async("syn0", np.array([0, 2]), np.ones((2, 3), np.float32))
        client.flush()
        assert server.tables["syn0"][0, 0] == 1.0
        assert server.tables["syn0"][2, 0] == 1.0
    finally:
        client.close()
        server.stop()


def test_binary_payload_throughput():
    """The hot path is raw bytes, not JSON: pushes/sec of a [1024, 128] f32
    row batch above the JAX case's floor."""
    dim, n_rows, n_pushes = 128, 1024, 50
    server = EmbeddingParameterServer({"syn0": np.zeros((65536, dim), np.float32)})
    port = server.start()
    client = EmbeddingPSClient([f"http://127.0.0.1:{port}"], queue_size=8)
    try:
        rng = np.random.default_rng(0)
        rows = rng.choice(65536, size=n_rows, replace=False)
        deltas = rng.standard_normal((n_rows, dim)).astype(np.float32)
        client.push_async("syn0", rows, deltas)  # warm the connection
        client.flush()
        t0 = time.perf_counter()
        for _ in range(n_pushes):
            client.push_async("syn0", rows, deltas)
        client.flush()
        rate = n_pushes / (time.perf_counter() - t0)
        assert client.dropped_pushes == 0
        assert rate > 20, rate
    finally:
        client.close()
        server.stop()


def test_three_endpoint_pull_runs_shards_concurrently():
    """A pull spanning 3 endpoints with an injected per-RPC latency takes
    ~max(latencies), not their sum: the sub-pulls run on concurrent
    dl4j-ps-pull-* threads."""
    rng = np.random.default_rng(2)
    t0 = rng.standard_normal((9, 4)).astype(np.float32)
    servers = [EmbeddingParameterServer({"syn0": t0.copy()}) for _ in range(3)]
    ports = [s.start() for s in servers]
    client = EmbeddingPSClient([f"http://127.0.0.1:{p}" for p in ports])
    try:
        rows = np.arange(9)
        client.pull("syn0", rows)  # warm connections
        lat_ms = 150.0
        plan = fp.FaultPlan(seed=0)
        plan.add("paramserver_rpc", "latency", p=1.0, latency_ms=lat_ms)
        with fp.active(plan):
            start = time.perf_counter()
            got = client.pull("syn0", rows)
            wall = time.perf_counter() - start
        np.testing.assert_allclose(got, t0[rows], rtol=1e-6)
        assert wall < 2.0 * lat_ms / 1e3, f"3-shard pull took {wall * 1e3:.0f}ms"
        assert wall >= 0.9 * lat_ms / 1e3, f"pull took {wall * 1e3:.0f}ms"
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_flush_waits_for_inflight_post():
    """flush() returns only once the delta is applied server-side, not
    when the queue merely looks empty."""
    server = EmbeddingParameterServer({"syn0": np.zeros((4, 3), np.float32)})
    port = server.start()
    client = EmbeddingPSClient([f"http://127.0.0.1:{port}"])
    try:
        plan = fp.FaultPlan(seed=0)
        plan.add("paramserver_rpc", "latency", p=1.0, latency_ms=400.0)
        with fp.active(plan):
            client.push_async("syn0", np.array([1]), np.ones((1, 3), np.float32))
            assert client.flush(timeout=10.0) is True
            assert server.tables["syn0"][1, 0] == 1.0
        assert client.dropped_pushes == 0
    finally:
        client.close()
        server.stop()


def test_flush_timeout_returns_false_on_wedged_endpoint():
    """flush(timeout=) is a bounded wait on a wedged endpoint; once it
    recovers the queued push still drains."""
    server = EmbeddingParameterServer({"syn0": np.zeros((4, 3), np.float32)})
    port = server.start()
    client = EmbeddingPSClient([f"http://127.0.0.1:{port}"])
    try:
        plan = fp.FaultPlan(seed=0)
        plan.add("paramserver_rpc", "hang", p=1.0, hang_seconds=3.0, max_fires=1)
        with fp.active(plan):
            client.push_async("syn0", np.array([0]), np.ones((1, 3), np.float32))
            start = time.perf_counter()
            ok = client.flush(timeout=0.5)
            wall = time.perf_counter() - start
        assert ok is False
        assert wall < 2.5, f"flush(timeout=0.5) blocked {wall:.1f}s"
        assert client.flush(timeout=10.0) is True
        assert server.tables["syn0"][0, 0] == 1.0
    finally:
        client.close()
        server.stop()


def test_bf16_wire_is_opt_in_halves_bytes_and_round_trips():
    """wire_dtype='bf16' halves row-block wire bytes (counter-verified),
    round-trips within bf16 tolerance, and accumulates in f32 on the
    server. Never default-on."""
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    rng = np.random.default_rng(3)
    dim, n = 32, 64
    t0 = rng.standard_normal((n, dim)).astype(np.float32)
    server = EmbeddingParameterServer({"syn0": t0.copy()})
    port = server.start()
    url = f"http://127.0.0.1:{port}"
    clients = []
    try:
        with pytest.raises(ValueError):
            EmbeddingPSClient([url], wire_dtype="fp8")
        c32 = EmbeddingPSClient([url])
        c16 = EmbeddingPSClient([url], wire_dtype="bf16")
        clients = [c32, c16]
        assert c32.wire_dtype == "f32"

        def pull_wire_bytes():
            vals = get_registry().scalar_values()
            return sum(v for k, v in vals.items()
                       if k.startswith("paramserver_wire_bytes_total")
                       and 'route="pull.bin"' in k)

        rows = np.arange(n)
        b0 = pull_wire_bytes()
        exact = c32.pull("syn0", rows)
        b1 = pull_wire_bytes()
        approx = c16.pull("syn0", rows)
        b2 = pull_wire_bytes()
        np.testing.assert_allclose(exact, t0, rtol=1e-6)
        np.testing.assert_allclose(approx, t0, rtol=1e-2, atol=1e-2)
        f32_bytes, bf16_bytes = b1 - b0, b2 - b1
        assert 0 < bf16_bytes < 0.65 * f32_bytes, (f32_bytes, bf16_bytes)
        c16.push_async("syn0", rows, np.full((n, dim), 0.5, np.float32))
        assert c16.flush(timeout=10.0) is True
        np.testing.assert_allclose(server.tables["syn0"], t0 + 0.5, rtol=1e-6)
    finally:
        for c in clients:
            c.close()
        server.stop()


# -- the JAX package's failover cases, on the port -------------------------------


def test_journal_replays_after_crash(tmp_path):
    jdir = str(tmp_path / "j")
    t0 = np.zeros((8, 3), np.float32)
    server = EmbeddingParameterServer({"syn0": t0.copy()}, journal_dir=jdir)
    port = server.start()
    try:
        client = EmbeddingPSClient([f"http://127.0.0.1:{port}"])
        rows = np.array([0, 2, 5])
        client.push_async("syn0", rows, np.ones((3, 3), np.float32))
        client.push_async("syn0", rows, np.ones((3, 3), np.float32))
        client.flush()
        _wait_until(lambda: server.pushes_applied == 2)
        expect = server.tables["syn0"].copy()
        client.close()
    finally:
        server.stop()  # "crash": no snapshot() — only the journal survives

    reborn = EmbeddingParameterServer({"syn0": t0.copy()}, journal_dir=jdir)
    try:
        np.testing.assert_array_equal(reborn.tables["syn0"], expect)
        assert reborn.tables["syn0"][0, 0] == 2.0
    finally:
        reborn.stop()


def test_snapshot_truncates_journal_and_restores(tmp_path):
    jdir = str(tmp_path / "s")
    server = EmbeddingParameterServer({"syn0": np.zeros((4, 2), np.float32)},
                                      journal_dir=jdir)
    server.push("syn0", [1], np.full((1, 2), 3.0, np.float32))
    path = server.snapshot()
    assert os.path.exists(path)
    assert os.path.getsize(os.path.join(jdir, "journal.bin")) == 0
    server.push("syn0", [2], np.full((1, 2), 5.0, np.float32))
    expect = server.tables["syn0"].copy()
    server.stop()

    reborn = EmbeddingParameterServer({"syn0": np.zeros((4, 2), np.float32)},
                                      journal_dir=jdir)
    try:
        np.testing.assert_array_equal(reborn.tables["syn0"], expect)
    finally:
        reborn.stop()


def test_torn_journal_tail_discarded(tmp_path):
    jdir = str(tmp_path / "torn")
    server = EmbeddingParameterServer({"syn0": np.zeros((4, 2), np.float32)},
                                      journal_dir=jdir)
    server.push("syn0", [0], np.ones((1, 2), np.float32))
    server.push("syn0", [1], np.ones((1, 2), np.float32))
    expect = server.tables["syn0"].copy()
    server.stop()
    payload = _pack_request("syn0", np.array([3], np.int64),
                            np.ones((1, 2), np.float32))
    with open(os.path.join(jdir, "journal.bin"), "ab") as f:
        f.write(struct.pack("<I", len(payload)) + payload[: len(payload) // 2])
    reborn = EmbeddingParameterServer({"syn0": np.zeros((4, 2), np.float32)},
                                      journal_dir=jdir)
    try:
        np.testing.assert_array_equal(reborn.tables["syn0"], expect)
        assert reborn.tables["syn0"][3, 0] == 0.0  # torn push NOT applied
    finally:
        reborn.stop()


def test_snapshot_every_auto_truncates(tmp_path):
    jdir = str(tmp_path / "auto")
    server = EmbeddingParameterServer({"syn0": np.zeros((4, 2), np.float32)},
                                      journal_dir=jdir, snapshot_every=3)
    for i in range(7):
        server.push("syn0", [i % 4], np.ones((1, 2), np.float32))
    try:
        assert os.path.exists(os.path.join(jdir, "tables.npz"))
        with open(os.path.join(jdir, "journal.bin"), "rb") as f:
            buf = f.read()
        (rec_len,) = struct.unpack_from("<I", buf, 0)
        assert len(buf) == 4 + rec_len  # exactly one record
    finally:
        server.stop()


def test_snapshot_shape_mismatch_rejected(tmp_path):
    jdir = str(tmp_path / "shape")
    server = EmbeddingParameterServer({"syn0": np.zeros((4, 2), np.float32)},
                                      journal_dir=jdir)
    server.push("syn0", [0], np.ones((1, 2), np.float32))
    server.snapshot()
    server.stop()
    with pytest.raises(ValueError, match="shape"):
        EmbeddingParameterServer({"syn0": np.zeros((9, 9), np.float32)},
                                 journal_dir=jdir)


def test_client_parks_and_replays_when_endpoint_returns(tmp_path):
    """Pushes against a down endpoint PARK (not drop), and the drain's
    idle tick replays them once the journal-backed endpoint returns."""
    jdir = str(tmp_path / "replay")
    t0 = np.zeros((6, 2), np.float32)
    server = EmbeddingParameterServer({"syn0": t0.copy()}, journal_dir=jdir)
    port = server.start()
    client = EmbeddingPSClient([f"http://127.0.0.1:{port}"], timeout=2.0,
                               max_retries=1, retry_backoff=0.01,
                               replay_capacity=16)
    reborn = None
    try:
        rows = np.array([1, 4])
        client.push_async("syn0", rows, np.ones((2, 2), np.float32))
        client.flush()
        _wait_until(lambda: server.pushes_applied == 1)
        server.stop()  # the outage

        for _ in range(3):
            client.push_async("syn0", rows, np.ones((2, 2), np.float32))
        client.flush()
        assert _wait_until(lambda: client.pending_pushes() == 3)
        assert client.dropped_pushes == 0  # parked, not lost

        reborn = EmbeddingParameterServer({"syn0": t0.copy()},
                                          journal_dir=jdir, port=port)
        reborn.start()
        assert _wait_until(lambda: client.pending_pushes() == 0, 15.0)
        _wait_until(lambda: reborn.pushes_applied >= 3)
        np.testing.assert_array_equal(reborn.tables["syn0"][1],
                                      np.full(2, 4.0, np.float32))
        assert client.dropped_pushes == 0
    finally:
        client.close()
        if reborn is not None:
            reborn.stop()


def test_replay_overflow_drops_oldest_and_counts(tmp_path):
    client = EmbeddingPSClient(["http://127.0.0.1:1"], timeout=0.5,
                               max_retries=0, retry_backoff=0.01,
                               replay_capacity=2)
    try:
        rows = np.array([0])
        for _ in range(5):
            client.push_async("syn0", rows, np.ones((1, 3), np.float32))
        client.flush()
        assert _wait_until(lambda: client.dropped_pushes >= 3)
        assert client.pending_pushes() <= 2
    finally:
        client.close()
    # close() against a still-dead endpoint accounts the parked remainder
    assert client.pending_pushes() == 0
    assert client.dropped_pushes == 5


def test_pull_retries_through_a_blip(tmp_path):
    t0 = np.arange(12, dtype=np.float32).reshape(6, 2)
    server = EmbeddingParameterServer({"syn0": t0.copy()})
    port = server.start()
    server.stop()  # learn a port, then take the server down

    client = EmbeddingPSClient([f"http://127.0.0.1:{port}"], timeout=2.0,
                               max_retries=8, retry_backoff=0.2)
    reborn = EmbeddingParameterServer({"syn0": t0.copy()}, port=port)

    def bring_back():
        time.sleep(0.4)
        reborn.start()

    t = threading.Thread(target=bring_back, daemon=True, name="dl4j-test-bringback")
    t.start()
    try:
        got = client.pull("syn0", np.array([2, 5]))
        np.testing.assert_array_equal(got, t0[[2, 5]])
    finally:
        t.join()
        client.close()
        reborn.stop()


# -- the two packages against each other ----------------------------------------


def test_bf16_from_f32_is_bit_equal_to_the_jax_function():
    rng = np.random.default_rng(11)
    specials = np.array([
        0x00000000, 0x80000000,              # +0, -0
        0x7F800000, 0xFF800000,              # +Inf, -Inf
        0x7FC00000, 0xFFC00000,              # quiet NaNs
        0x7F800001, 0xFF800001,              # signalling NaNs, low payload
        0x7FFFFFFF, 0xFFFFFFFF,              # all-ones payloads (RNE would carry)
        0x7F80FFFF, 0x7FBF8000, 0x7FFF8000,  # payloads at the rounding bit
        0x3F808000, 0x3F818000,              # ties: even and odd kept bit
        0xBF808000, 0xBF818000,
        0x3F807FFF, 0x3F808001,              # just below / above a tie
        0x7F7F8000, 0x7F7FFFFF,              # ties that round to Inf
        0x00008000, 0x00018000, 0x00000001,  # subnormal ties and the smallest
    ], np.uint32).view(np.float32)
    rand = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    # every fourth random word forced to a tie (low 16 bits 0x8000)
    rand[::4] = (rand[::4] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    a = np.concatenate([specials, rand.view(np.float32)]).reshape(-1, 4)
    got, want = tps._bf16_from_f32(a), jps._bf16_from_f32(a)
    assert got.dtype == want.dtype == np.dtype("<u2")
    assert got.tobytes() == want.tobytes()
    back_t, back_j = tps._f32_from_bf16(got), jps._f32_from_bf16(want)
    assert back_t.tobytes() == back_j.tobytes()


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_wire_messages_are_the_same_bytes(wire):
    rng = np.random.default_rng(12)
    rows = rng.integers(0, 1000, 37)
    deltas = rng.standard_normal((37, 9)).astype(np.float32)
    for args in (("emb", rows), ("emb", rows, deltas)):
        a = tps._pack_request(*args, wire_dtype=wire)
        assert a == jps._pack_request(*args, wire_dtype=wire)
        for mod in (tps, jps):
            name, r, d, w = mod._unpack_request(a)
            assert (name, w) == ("emb", wire) and r.tobytes() == rows.astype("<i8").tobytes()
    assert tps._pack_rows(deltas, wire) == jps._pack_rows(deltas, wire)
    assert (tps._unpack_rows(tps._pack_rows(deltas, wire)).tobytes()
            == jps._unpack_rows(jps._pack_rows(deltas, wire)).tobytes())


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("serving", ["jax", "port"])
def test_cross_package_client_and_server_give_byte_equal_pulls(serving, wire):
    """The serving package's two 2-endpoint servers start from one table;
    the OTHER package's client drives the first, the serving package's own
    client the second, with the same pushes: every pull and the final
    tables are byte-equal."""
    spkg = PKGS[serving]
    cpkg = PKGS["port" if serving == "jax" else "jax"]
    rng = np.random.default_rng(13)
    t0 = rng.standard_normal((40, 6)).astype(np.float32)
    groups = [[spkg.EmbeddingParameterServer({"emb": t0.copy()}) for _ in range(2)]
              for _ in range(2)]
    urls = [[f"http://127.0.0.1:{s.start()}" for s in g] for g in groups]
    cross = cpkg.EmbeddingPSClient(urls[0], wire_dtype=wire)
    same = spkg.EmbeddingPSClient(urls[1], wire_dtype=wire)
    try:
        for k in range(4):
            rows = rng.integers(0, 40, 12)
            got = [c.pull("emb", rows) for c in (cross, same)]
            assert got[0].tobytes() == got[1].tobytes(), k
            deltas = (-0.1 * got[0] + rng.standard_normal(got[0].shape)
                      .astype(np.float32) * 1e-3).astype(np.float32)
            for c in (cross, same):
                c.push_async("emb", rows, deltas)
                assert c.flush(timeout=10.0) is True
        everything = np.arange(40)
        assert (cross.pull("emb", everything).tobytes()
                == same.pull("emb", everything).tobytes())
        for a, b in zip(*groups):
            assert a.tables["emb"].tobytes() == b.tables["emb"].tobytes()
            assert a.pushes_applied == b.pushes_applied == 4
        assert cross.dropped_pushes == same.dropped_pushes == 0
    finally:
        cross.close()
        same.close()
        for g in groups:
            for s in g:
                s.stop()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_and_snapshot_restore_across_packages(writer, tmp_path):
    """A journal directory (a snapshot plus a journal tail) written by one
    package restores in the other to bit-equal tables."""
    wpkg = PKGS[writer]
    rpkg = PKGS["port" if writer == "jax" else "jax"]
    rng = np.random.default_rng(14)
    init = {"syn0": rng.standard_normal((16, 5)).astype(np.float32),
            "syn1": np.zeros((16, 5), np.float32)}
    jdir = str(tmp_path / "j")
    server = wpkg.EmbeddingParameterServer({k: v.copy() for k, v in init.items()},
                                           journal_dir=jdir)
    for k in range(6):
        rows = rng.integers(0, 16, 4).tolist()
        name = ("syn0", "syn1")[k % 2]
        server.push(name, rows, rng.standard_normal((4, 5)).astype(np.float32))
        if k == 2:
            server.snapshot()
    want = {k: v.copy() for k, v in server.tables.items()}
    server.stop()
    assert os.path.getsize(os.path.join(jdir, "journal.bin")) > 0
    reborn = rpkg.EmbeddingParameterServer({k: v.copy() for k, v in init.items()},
                                           journal_dir=jdir)
    try:
        for k in want:
            assert reborn.tables[k].tobytes() == want[k].tobytes(), k
    finally:
        reborn.stop()
