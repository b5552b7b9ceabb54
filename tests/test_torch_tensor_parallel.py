"""Tensor parallelism of the port (parallel/tensor.py): Megatron's
column/row split of a Dense stack on gloo processes on the CPU, at 2
ranks (a 1 x 2 mesh) and at 2 x 2 (data plus model parallelism), against
the JAX package's tensor-parallel fit on as many virtual CPU devices
(rtol 2e-5, atol 2e-6, the JAX test's tolerance): every rank holds its
slice, the gathered parameters and the scores equal the JAX package's.
"""

import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf import DenseLayer, NeuralNetConfiguration, OutputLayer, Updater
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu.parallel import shard_params_tp
from deeplearning4j_tpu.parallel.mesh import mesh_2d
from deeplearning4j_tpu.train.listeners import IterationListener
from deeplearning4j_tpu.utils import model_serializer as jms

from tests import torch_parallel_workers as W
from tests.torch_dist import once, run_ranks

RTOL, ATOL = 2e-5, 2e-6


def _conf():
    return (NeuralNetConfiguration.builder().seed(11).updater(Updater.ADAM)
            .learning_rate(0.01).weight_init("xavier").list()
            .layer(DenseLayer(n_in=12, n_out=32, activation="tanh"))
            .layer(DenseLayer(n_in=32, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
            .build())


def _data(n=64, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    y = np.zeros((n, 4), np.float32)
    y[np.arange(n), rng.integers(0, 4, n)] = 1.0
    return x, y


class _Tap(IterationListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, info):
        self.scores.append(float(np.asarray(info["score"]())))


def _jax_tp(data_axis, model_axis, path):
    net = MultiLayerNetwork(_conf()).init()
    jms.save_model(net, path)
    mesh = mesh_2d(data_axis, model_axis, jax.devices()[:data_axis * model_axis])
    shard_params_tp(net, mesh)
    if data_axis > 1:
        net.set_mesh(mesh)
    tap = _Tap()
    net.set_listeners(tap)
    x, y = _data()
    net.fit(x, y, batch_size=32, epochs=2, async_prefetch=False)
    return tap.scores, [(f"{i}/{k}", np.asarray(p[k])) for i, p in enumerate(net.params_list)
                        for k in sorted(p)]


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=["tp2", "dp2xtp2"])
def runs(request, tmp_path_factory):
    d, m = request.param

    def compute():
        path = os.path.join(tmp_path_factory.mktemp("tp"), "net.zip")
        want = _jax_tp(d, m, path)
        return (d, m), want, run_ranks(W.tp_fit, d * m, path, _data(), d, m)

    return once(tmp_path_factory, f"tp-{d}x{m}", compute)


def test_each_rank_holds_its_slice(runs):
    (d, m), _, ranks = runs
    for rec in ranks:
        assert rec["shapes"][0] == (12, 32 // m)   # column-parallel
        assert rec["shapes"][1] == (32 // m, 16)   # row-parallel
        assert rec["shapes"][2] == (16, 4)         # the head stays whole
        assert rec["local_shapes_after"] == rec["shapes"]


def test_scores_equal_jax_tensor_parallel(runs):
    _, (scores, _), ranks = runs
    for rec in ranks:
        np.testing.assert_allclose(rec["scores"], scores, rtol=RTOL, atol=ATOL)


def test_gathered_params_equal_jax_tensor_parallel(runs):
    _, (_, params), ranks = runs
    for rec in ranks:
        assert [k for k, _ in rec["params"]] == [k for k, _ in params]
        for (k, a), (_, b) in zip(rec["params"], params):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)


def test_tp_output_is_replicated(runs):
    """output() runs the split forward (the row layer's psum) and every
    rank returns the same whole result."""
    _, _, ranks = runs
    for rec in ranks[1:]:
        np.testing.assert_array_equal(rec["output"], ranks[0]["output"])
    assert ranks[0]["output"].shape == (8, 4)
