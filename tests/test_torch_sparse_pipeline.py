"""The port's overlapped sparse-embedding pipeline (deeplearning4j_tpu_torch/
parallel/sparse.py): the JAX package's seven non-audit cases on the port
(book conservation, order with duplicates, byte-identical prefetch-on/off
trajectories, deadlines through the cache under an outage,
write-through, no leaked threads, per-tenant pull spend), the module's
smoke, and the recsys workload end to end against the JAX package: the
same zipf stream through the JAX pipeline with the JAX tower (the
`bench.py` `bench_recsys` tower, copied here) and through the port's
pipeline with the port's tower (models/recsys.tower_step), from the JAX
tower's parameters carried across as numpy.

Tolerances: the JAX cases' own (rtol 1e-6, exact bytes); the cross-package
run holds the tower to rtol 1e-5 and the table after flush to rtol 1e-5 /
atol 1e-7 after 8 steps (f32; JAX runs its matmuls at "highest")."""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.recsys import zipf_cdf, zipf_ids
from deeplearning4j_tpu_torch.parallel.paramserver import (
    EmbeddingParameterServer,
    EmbeddingPSClient,
)
from deeplearning4j_tpu_torch.parallel.sparse import (
    SPARSE_THREAD_PREFIX,
    SparseEmbeddingPipeline,
)
from deeplearning4j_tpu_torch.utils import faultpoints as fp

TOWER_RTOL = 1e-5
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-7


def _sparse_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(SPARSE_THREAD_PREFIX)]


def _start_servers(init, n):
    servers = [EmbeddingParameterServer({"emb": init.copy()}) for _ in range(n)]
    urls = [f"http://127.0.0.1:{s.start()}" for s in servers]
    return servers, urls


def _run_arm(init, batches, *, prefetch, cache_rows, lr=0.1):
    servers, urls = _start_servers(init, 2)
    try:
        client = EmbeddingPSClient(urls)
        try:
            with SparseEmbeddingPipeline(client, "emb", cache_rows=cache_rows,
                                         prefetch=prefetch) as pipe:
                for k, ids in enumerate(batches):
                    rows = pipe.lookup(ids)
                    if k + 1 < len(batches):
                        pipe.prefetch(batches[k + 1])
                    pipe.push(ids, (-lr * rows).astype(np.float32))
                stats = pipe.stats()
            assert client.flush(timeout=30.0) is True
            final = client.pull("emb", np.arange(init.shape[0]))
        finally:
            client.close()
    finally:
        for s in servers:
            s.stop()
    return final, stats


# -- the JAX package's cases, on the port ----------------------------------------


def test_books_conserve_and_duplicates_coalesce():
    rng = np.random.default_rng(0)
    init = rng.standard_normal((64, 8)).astype(np.float32)
    batches = [rng.integers(0, 16, size=48) for _ in range(5)]
    final, stats = _run_arm(init, batches, prefetch=True, cache_rows=32)
    assert stats["pull_rows"] == stats["cache_hit"] + stats["cache_miss"], stats
    assert stats["coalesced"] > 0, stats
    assert stats["cache_hit"] > 0, stats
    assert final.shape == init.shape


def test_lookup_returns_rows_in_order_with_duplicates():
    rng = np.random.default_rng(1)
    init = rng.standard_normal((32, 4)).astype(np.float32)
    servers, urls = _start_servers(init, 2)
    try:
        client = EmbeddingPSClient(urls)
        try:
            with SparseEmbeddingPipeline(client, "emb", cache_rows=8) as pipe:
                ids = np.array([5, 0, 5, 31, 0])
                got = pipe.lookup(ids)
                np.testing.assert_allclose(got, init[ids], rtol=1e-6)
                got2 = pipe.lookup(ids)
                np.testing.assert_allclose(got2, init[ids], rtol=1e-6)
                s = pipe.stats()
                assert s["cache_hit"] == 3 and s["cache_miss"] == 3, s
        finally:
            client.close()
    finally:
        for s in servers:
            s.stop()


def test_prefetch_on_off_trajectories_byte_identical():
    rng = np.random.default_rng(2)
    init = (rng.standard_normal((48, 6)) * 0.5).astype(np.float32)
    batches = [zipf_ids(24, 48, alpha=1.3, seed=100 + k) for k in range(8)]
    on, s_on = _run_arm(init, batches, prefetch=True, cache_rows=12)
    off, s_off = _run_arm(init, batches, prefetch=False, cache_rows=0)
    assert on.tobytes() == off.tobytes(), (np.abs(on - off).max(), s_on, s_off)
    assert s_on["pull_rows"] == s_on["cache_hit"] + s_on["cache_miss"]
    assert s_off["cache_hit"] == 0


def test_deadline_honored_through_cache_and_under_outage():
    rng = np.random.default_rng(3)
    init = rng.standard_normal((32, 4)).astype(np.float32)
    servers, urls = _start_servers(init, 1)
    try:
        client = EmbeddingPSClient(urls)
        try:
            with SparseEmbeddingPipeline(client, "emb", cache_rows=32) as pipe:
                warm = np.arange(8)
                pipe.lookup(warm)  # fill the cache before the outage
                plan = fp.FaultPlan(seed=0)
                plan.add("paramserver_rpc", "hang", p=1.0, hang_seconds=3.0)
                cold = np.arange(16, 24)
                with fp.active(plan):
                    got = pipe.lookup(warm, deadline_ms=500)
                    np.testing.assert_allclose(got, init[warm], rtol=1e-6)
                    pipe.prefetch(cold)
                    start = time.monotonic()
                    with pytest.raises(TimeoutError):
                        pipe.lookup(cold, deadline_ms=300)
                    wall = time.monotonic() - start
                    assert wall < 2.0, f"deadline overshot: {wall:.1f}s"
                got = pipe.lookup(cold)
                np.testing.assert_allclose(got, init[cold], rtol=1e-6)
        finally:
            client.close()
    finally:
        for s in servers:
            s.stop()


def test_push_write_through_keeps_cache_coherent():
    init = np.zeros((16, 4), np.float32)
    servers, urls = _start_servers(init, 2)
    try:
        client = EmbeddingPSClient(urls)
        try:
            with SparseEmbeddingPipeline(client, "emb", cache_rows=16) as pipe:
                ids = np.array([2, 3])
                pipe.lookup(ids)
                pipe.push(ids, np.ones((2, 4), np.float32))
                got = pipe.lookup(ids)  # served write-through, no flush
                np.testing.assert_allclose(got, np.ones((2, 4)), rtol=1e-6)
            assert client.flush(timeout=30.0) is True
            final = client.pull("emb", ids)
            np.testing.assert_allclose(final, np.ones((2, 4)), rtol=1e-6)
        finally:
            client.close()
    finally:
        for s in servers:
            s.stop()


def test_close_leaves_no_sparse_threads():
    init = np.zeros((8, 2), np.float32)
    servers, urls = _start_servers(init, 1)
    try:
        client = EmbeddingPSClient(urls)
        try:
            pipe = SparseEmbeddingPipeline(client, "emb", cache_rows=4)
            pipe.lookup(np.array([0, 1]))
            pipe.prefetch(np.array([2, 3]))
            assert _sparse_threads()
            pipe.close()
            pipe.close()  # idempotent
            assert not _sparse_threads(), _sparse_threads()
            with pytest.raises(RuntimeError):
                pipe.lookup(np.array([0]))
            with pytest.raises(RuntimeError):
                pipe.prefetch(np.array([0]))
        finally:
            client.close()
    finally:
        for s in servers:
            s.stop()


def test_pull_spend_books_to_tenant_under_paramserver_tier():
    from deeplearning4j_tpu_torch.utils import resourcemeter
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    tenant = "sparse-spend-test"

    def tier_spend():
        spend = resourcemeter.spend_table(get_registry().scalar_values())
        return (spend.get(tenant, {}).get("device_seconds", {})
                .get(resourcemeter.TIER_PARAMSERVER, 0.0))

    resourcemeter.enable()
    try:
        before = tier_spend()
        init = np.zeros((32, 4), np.float32)
        servers, urls = _start_servers(init, 2)
        try:
            client = EmbeddingPSClient(urls, tenant=tenant)
            try:
                with SparseEmbeddingPipeline(client, "emb", cache_rows=8,
                                             tenant=tenant) as pipe:
                    pipe.lookup(np.arange(16))
            finally:
                client.close()
        finally:
            for s in servers:
                s.stop()
        after = tier_spend()
        assert after > before, (before, after)
        verdict = resourcemeter.conservation(get_registry().scalar_values())
        assert verdict["ok"], verdict
    finally:
        resourcemeter.disable()


def test_smoke_is_ok():
    from deeplearning4j_tpu_torch.parallel import sparse

    report = sparse.smoke()
    assert report["ok"], report
    assert report["prefetch_matches_sync"] and not report["leaked_threads"]


# -- the recsys workload against the JAX package --------------------------------

VOCAB, DIM, HIDDEN, BATCH, STEPS, LR = 2000, 16, 24, 64, 8, 0.05


def _jax_tower(seed):
    """`bench.py` `bench_recsys`'s dense tower (init and jitted SGD step),
    as that function defines it."""
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    params0 = {
        "w1": jax.random.normal(ks[0], (DIM, HIDDEN), jnp.float32) * np.sqrt(2.0 / DIM),
        "b1": jnp.zeros((HIDDEN,), jnp.float32),
        "w2": jax.random.normal(ks[1], (HIDDEN, HIDDEN), jnp.float32)
        * np.sqrt(2.0 / HIDDEN),
        "b2": jnp.zeros((HIDDEN,), jnp.float32),
        "w3": jax.random.normal(ks[2], (HIDDEN, 2), jnp.float32) * np.sqrt(2.0 / HIDDEN),
        "b3": jnp.zeros((2,), jnp.float32),
    }

    def _loss(p, emb, y):
        h = jnp.maximum(emb @ p["w1"] + p["b1"], 0.0)
        h = jnp.maximum(h @ p["w2"] + p["b2"], 0.0)
        logits = h @ p["w3"] + p["b3"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    @jax.jit
    def _step(p, emb, y):
        loss, (gp, gemb) = jax.value_and_grad(_loss, argnums=(0, 1))(p, emb, y)
        new_p = jax.tree_util.tree_map(lambda a, g: a - LR * g, p, gp)
        return new_p, (-LR) * gemb, loss

    return params0, _step


def _drive(pkg_ps, pkg_sparse, init, batches, step, p, to_emb, to_np):
    """bench_recsys's pipelined arm: lookup, prefetch the next batch, the
    tower step, push the rows' delta; returns (tower, table, stats)."""
    servers = [pkg_ps.EmbeddingParameterServer({"emb": init.copy()}) for _ in range(2)]
    client = pkg_ps.EmbeddingPSClient([f"http://127.0.0.1:{s.start()}" for s in servers])
    try:
        with pkg_sparse.SparseEmbeddingPipeline(client, "emb", cache_rows=256,
                                                prefetch=True) as pipe:
            pipe.prefetch(batches[0])
            for k in range(STEPS):
                emb = pipe.lookup(batches[k])
                pipe.prefetch(batches[k + 1])
                p, delta = step(p, to_emb(emb), k)
                pipe.push(batches[k], to_np(delta))
            stats = pipe.stats()
        assert client.flush(timeout=60.0) is True
        table = client.pull("emb", np.arange(VOCAB))
    finally:
        client.close()
        for s in servers:
            s.stop()
    return p, table, stats


def test_recsys_pipeline_and_tower_agree_with_the_jax_package():
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import paramserver as jps
    from deeplearning4j_tpu.parallel import sparse as jsparse
    from deeplearning4j_tpu_torch.models.recsys import TOWER_KEYS, tower_step
    from deeplearning4j_tpu_torch.parallel import paramserver as tps
    from deeplearning4j_tpu_torch.parallel import sparse as tsparse

    cdf = zipf_cdf(VOCAB, 1.1)
    batches = [zipf_ids(BATCH, VOCAB, 1.1, seed=k, cdf=cdf) for k in range(STEPS + 1)]
    labels = [(ids & 1).astype(np.int32) for ids in batches]
    init = (np.random.default_rng(4).standard_normal((VOCAB, DIM)) * 0.1).astype(np.float32)
    jp0, jstep = _jax_tower(0)

    def jax_step(p, emb, k):
        p, delta, _ = jstep(p, emb, jnp.asarray(labels[k]))
        return p, delta

    jp, jtable, jstats = _drive(jps, jsparse, init, batches, jax_step, jp0,
                                jnp.asarray, np.asarray)

    def port_step(p, emb, k):
        p, delta, _ = tower_step(p, emb, torch.from_numpy(labels[k].astype(np.int64)), LR)
        return p, delta

    tp0 = {k: torch.from_numpy(np.asarray(jp0[k]).copy()) for k in TOWER_KEYS}
    tp, ttable, tstats = _drive(tps, tsparse, init, batches, port_step, tp0,
                                torch.from_numpy, lambda d: d.numpy())
    for k in TOWER_KEYS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=TOWER_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(ttable, jtable, rtol=TABLE_RTOL, atol=TABLE_ATOL)
    assert not np.array_equal(ttable, init)  # the pushes landed
    for key in ("pull_rows", "coalesced"):
        assert tstats[key] == jstats[key], key
    assert (tstats["cache_hit"] + tstats["cache_miss"]
            == jstats["cache_hit"] + jstats["cache_miss"] == tstats["pull_rows"])
