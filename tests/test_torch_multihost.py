"""Multi-host data parallelism of the port: two real processes joined by
`initialize_distributed` over TCP on localhost, each feeding its own local
shard through `MultiHostDataParallel.fit_local_shards`, equal one process
fitting the global batches (the port in this process, and the JAX
package's sharded step on 2 virtual CPU devices), within the JAX tests'
tolerance (rtol 2e-5, atol 2e-6).
"""

import os
import socket

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ExistingDataSetIterator as JIter
from deeplearning4j_tpu.parallel import ParallelWrapper, data_parallel_mesh
from deeplearning4j_tpu.utils import model_serializer as jms

from tests import torch_parallel_workers as W
from tests.multihost_common import build_net, global_data
from tests.torch_dist import once, run_ranks

RTOL, ATOL = 2e-5, 2e-6


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once(tmp_path_factory, "multihost", lambda: _runs(tmp_path_factory))


def _runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    x, y = global_data()
    path = os.path.join(tmp, "net.zip")
    jnet = build_net()
    jms.save_model(jnet, path)
    # the JAX package: one process, 2 devices, the global batches
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 32, 16)]
    ParallelWrapper(jnet, data_parallel_mesh(jax.devices()[:2])).fit(
        JIter([JDataSet(a, b) for a, b in batches]), epochs=2, async_prefetch=False)
    # the port, one process: the global batches
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.utils.model_serializer import load_model

    one = load_model(path, device="cpu")
    one.fit(ExistingDataSetIterator([DataSet(a, b) for a, b in batches]), epochs=2,
            async_prefetch=False)
    # two processes, each its rows of every global batch
    local = [[(a[r * 8:(r + 1) * 8], b[r * 8:(r + 1) * 8]) for a, b in batches]
             for r in range(2)]
    ranks = run_ranks(W.multihost_fit, 2, path, local,
                      f"tcp://127.0.0.1:{_free_port()}", init=False)
    want = [(f"{i}/{k}", np.asarray(p[k])) for i, p in enumerate(jnet.params_list)
            for k in sorted(p)]
    return want, W._leaves(one.params_list), one.iteration, ranks


def test_two_process_equals_single_process(runs):
    _, one, iters, ranks = runs
    for rec in ranks:
        assert rec["iteration"] == iters == 4
        for (k, a), (_, b) in zip(rec["params"], one):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)


def test_two_process_equals_jax_sharded_step(runs):
    want, _, _, ranks = runs
    for rec in ranks:
        for (k, a), (_, b) in zip(rec["params"], want):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)


def test_ranks_see_the_same_global_scores(runs):
    _, _, _, ranks = runs
    assert len(ranks[0]["scores"]) == 4
    assert ranks[0]["scores"] == ranks[1]["scores"]


def test_local_batch_divisibility_is_checked(runs):
    """The local shard must divide the process's shards (one a process:
    any batch does); a divisible 3-row batch passes, so no error."""
    _, _, _, ranks = runs
    assert ranks[0]["indivisible"] is None
