"""The port's data-parallel step on R = 4 gloo processes on the CPU
against the JAX package's sharded step on 4 of the 8 virtual CPU devices
(tests/conftest.py): an MLP, an MLP with batch norm (global-batch
statistics, running statistics included), a ComputationGraph, an LSTM
under truncated BPTT, a center-loss head with L1 and L2, and a
70-example epoch whose tail is padded, at the
JAX tests' tolerances (rtol 5e-5, atol 5e-6). The same weights go into
both packages through the model zip. All port runs share one spawn of 4
ranks (a module fixture); each test reads its case. A world-R fit equals
the port's own one-process fit for a dropout net too: every rank draws
the global batch's noise and keeps its rows.
"""

import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.resnet import tiny_resnet_conf
from deeplearning4j_tpu.nn.compgraph import ComputationGraph
from deeplearning4j_tpu.nn.conf import (
    BackpropType,
    BatchNormalization,
    CenterLossOutputLayer,
    DenseLayer,
    LSTM,
    NeuralNetConfiguration,
    OutputLayer,
    RnnOutputLayer,
    Updater,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu.parallel import data_parallel_mesh
from deeplearning4j_tpu.train.listeners import IterationListener
from deeplearning4j_tpu.utils import model_serializer as jms

from tests import torch_parallel_workers as W
from tests.torch_dist import once, run_ranks

R = 4
RTOL, ATOL = 5e-5, 5e-6  # the JAX package's test_parallel.py tolerances


def _mlp_conf(with_bn=False, seed=7):
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Updater.NESTEROVS)
         .learning_rate(0.05).momentum(0.9).weight_init("xavier").list()
         .layer(DenseLayer(n_in=12, n_out=16, activation="tanh")))
    if with_bn:
        b = b.layer(BatchNormalization(n_in=16))
    return b.layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss="mcxent")).build()


def _center_conf():
    """A center-loss head (its term and its class-center update divide by
    the global batch) with L1 and L2 (1/R of the penalty on each rank)."""
    return (NeuralNetConfiguration.builder().seed(4).updater(Updater.SGD)
            .learning_rate(0.05).weight_init("xavier").l1(1e-3).l2(1e-2).list()
            .layer(DenseLayer(n_in=12, n_out=16, activation="tanh"))
            .layer(CenterLossOutputLayer(n_in=16, n_out=4, activation="softmax",
                                         loss="mcxent", alpha=0.1, lambda_=0.5))
            .build())


def _graph_conf():
    return (NeuralNetConfiguration.builder().seed(9).updater(Updater.SGD)
            .learning_rate(0.05).weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("h", DenseLayer(n_in=12, n_out=16, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_in=16, n_out=4, activation="softmax",
                                          loss="mcxent"), "h")
            .set_outputs("out").build())


def _rnn_conf():
    return (NeuralNetConfiguration.builder().seed(5).updater(Updater.SGD)
            .learning_rate(0.05).weight_init("xavier").list()
            .layer(LSTM(n_in=6, n_out=8, activation="tanh"))
            .layer(RnnOutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .backprop_type(BackpropType.TRUNCATED_BPTT).t_bptt_lengths(4).build())


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    y = np.zeros((n, 4), np.float32)
    y[np.arange(n), rng.integers(0, 4, n)] = 1.0
    return x, y


def _image_data():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((16, 8, 8, 3)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]


def _rnn_data():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 12, 6)).astype(np.float32)
    y = np.zeros((16, 12, 3), np.float32)
    y[np.arange(16)[:, None], np.arange(12)[None, :], rng.integers(0, 3, (16, 12))] = 1.0
    return x, y


class _Tap(IterationListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, info):
        self.scores.append(float(np.asarray(info["score"]())))


CASES = {
    # name: (net builder, data, batch size, epochs)
    "mlp": (lambda: MultiLayerNetwork(_mlp_conf()).init(), _data(64), 16, 2),
    "mlp_bn": (lambda: MultiLayerNetwork(_mlp_conf(with_bn=True)).init(),
               _data(64, seed=3), 32, 1),
    "graph": (lambda: ComputationGraph(_graph_conf()).init(), _data(64, seed=5), 16, 2),
    "tbptt": (lambda: MultiLayerNetwork(_rnn_conf()).init(), _rnn_data(), 16, 1),
    "center_l1l2": (lambda: MultiLayerNetwork(_center_conf()).init(), _data(64, seed=6), 16, 2),
    # convolutions and three BNs: 4 rows a rank, the statistics over 256
    # pixels a channel
    "tiny_resnet": (lambda: ComputationGraph(tiny_resnet_conf()).init(), _image_data(), 16, 2),
    # 70 = 4 x 16 + a tail of 6, padded by wrapping to the 16 of this fit
    "tail": (lambda: MultiLayerNetwork(_mlp_conf()).init(), _data(70, seed=1), 16, 1),
}


def _jax_leaves(tree):
    out = []
    for i, layer in enumerate(tree):
        if layer is None:
            continue
        for k in sorted(layer):
            out.append((f"{i}/{k}", np.asarray(layer[k])))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once(tmp_path_factory, "dp", lambda: _runs(tmp_path_factory))


def _runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    jax_runs, port_cases = {}, {}
    for name, (build, (x, y), bs, ep) in CASES.items():
        net = build()
        path = os.path.join(tmp, f"{name}.zip")
        jms.save_model(net, path)
        net.set_mesh(data_parallel_mesh(jax.devices()[:R]))
        tap = _Tap()
        if name != "tbptt":
            # the JAX package's per-segment TBPTT loop (the one a listener
            # selects) does not run under a mesh; its fused batch does
            net.set_listeners(tap)
        net.fit(x, y, batch_size=bs, epochs=ep, async_prefetch=False)
        jax_runs[name] = {"scores": tap.scores, "params": _jax_leaves(net.params_list),
                          "state": _jax_leaves(net.state_list), "iteration": net.iteration,
                          "score": float(np.asarray(net._score))}
        port_cases[name] = (path, (x, y), {"batch_size": bs, "epochs": ep,
                                           "listen": name != "tbptt"})
    # the same ResNet through K4-K8's plain versions (the card's path):
    # R ranks against this process's one-process run
    path, data, kw = port_cases["tiny_resnet"]
    port_cases["tiny_resnet_fused"] = (path, data, {**kw, "fused_bn": True})
    one_fused = W._fit_record(W._load(path), data, mesh=False, fused_bn=True, **kw)
    ranks = run_ranks(W.dp_cases, R, port_cases)
    jax_runs["one_process_fused"] = one_fused
    dropout = {"world1": W.dropout_draw(0, 1, _data(64, seed=8)),
               "world2": run_ranks(W.dropout_draw, 2, _data(64, seed=8))}
    return jax_runs, ranks, dropout


def _assert_leaves(got, want, what):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_scores_match_jax_sharded_step(runs, case):
    jax_runs, ranks, _ = runs
    want = jax_runs[case]
    for rec in ranks:
        assert rec[case]["iteration"] == want["iteration"]
        np.testing.assert_allclose(rec[case]["scores"], want["scores"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rec[case]["score"], want["score"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_match_jax_sharded_step(runs, case):
    jax_runs, ranks, _ = runs
    for rec in ranks:
        _assert_leaves(rec[case]["params"], jax_runs[case]["params"], f"{case} param")


def test_ranks_hold_identical_params(runs):
    """Every rank applies the same summed gradient: the replicas stay
    bit-equal."""
    _, ranks, _ = runs
    for case in CASES:
        for rec in ranks[1:]:
            for (k, a), (_, b) in zip(rec[case]["params"], ranks[0][case]["params"]):
                np.testing.assert_array_equal(a, b, err_msg=f"{case} {k}")


def test_batchnorm_running_stats_are_global(runs):
    """Global-batch statistics: the running mean and variance equal the JAX
    package's (GSPMD's cross-device batch reduction) on every rank."""
    jax_runs, ranks, _ = runs
    want = [(k, v) for k, v in jax_runs["mlp_bn"]["state"]]
    assert want, "the BN layer has running statistics"
    for rec in ranks:
        _assert_leaves(rec["mlp_bn"]["state"], want, "BN state")


def test_center_loss_centers_are_global(runs):
    """The center-loss head's class centers move toward the GLOBAL batch's
    class means (their counts and sums summed over the ranks)."""
    jax_runs, ranks, _ = runs
    want = jax_runs["center_l1l2"]["state"]
    assert want, "the center-loss head has its centers"
    for rec in ranks:
        _assert_leaves(rec["center_l1l2"]["state"], want, "centers")


def test_fused_batchnorm_path_is_global(runs):
    """Through K4-K8's plain versions (the conv epilogue's sums, K6, K7,
    K8) the R-rank fit equals the one-process fit on the same path: the
    sums between K4/K5 and K6 and between K7 and K8 cross the ranks."""
    jax_runs, ranks, _ = runs
    one = jax_runs["one_process_fused"]
    assert one["plain_calls"].get("bn_normalize_reference", 0) > 0
    for rec in ranks:
        got = rec["tiny_resnet_fused"]
        assert got["plain_calls"] == one["plain_calls"]
        np.testing.assert_allclose(got["scores"], one["scores"], rtol=RTOL, atol=ATOL)
        _assert_leaves(got["params"], one["params"], "fused param")
        _assert_leaves(got["state"], one["state"], "fused BN state")
    # one all-reduce a BN forward (K4/K5 -> K6) and one a BN backward
    # (K7 -> K8) on this path
    got = ranks[0]["tiny_resnet_fused"]
    calls = got["plain_calls"]
    assert got["stats"]["bn_stats"]["calls"] == (calls["bn_normalize_reference"]
                                                 + calls["bn_backward_reduce_reference"])


def test_batchnorm_reduces_its_sums(runs):
    """The plain BN path all-reduces twice forward (the mean, then the sums
    about it) and once backward per BN a step."""
    _, ranks, _ = runs
    stats = ranks[0]["mlp_bn"]["stats"]
    steps = ranks[0]["mlp_bn"]["iteration"]
    assert stats["bn_stats"]["calls"] == 3 * steps


def test_tail_books_count_real_examples(runs):
    """The padded tail step counts as a step of the books, and the
    allreduce books are the payload a step."""
    _, ranks, _ = runs
    rec = ranks[0]["tail"]
    assert rec["iteration"] == 5
    assert rec["books"]["bytes"] == rec["payload"] * 5
    assert rec["payload"] == 4 * (12 * 16 + 16 + 16 * 4 + 4)


def test_dropout_world2_equals_world1(runs):
    """Dropout under the mesh draws the global batch's mask from the step
    generator and keeps this rank's rows: the two-rank fit is the
    one-process fit."""
    _, _, dropout = runs
    one = dropout["world1"]
    for rec in dropout["world2"]:
        np.testing.assert_allclose(rec["scores"], one["scores"], rtol=RTOL, atol=ATOL)
        _assert_leaves(rec["params"], one["params"], "dropout param")


# -- the line-search solvers under a data mesh ------------------------------------

LS_ALGOS = ("line_gradient_descent", "conjugate_gradient", "lbfgs")
LS_RTOL, LS_ATOL = 2e-5, 2e-6  # the sharded-step tolerance (JAX test_sharded_step.py)


def _line_search_conf(algo):
    return (NeuralNetConfiguration.builder().seed(4).optimization_algo(algo)
            .learning_rate(0.5).weight_init("xavier").list()
            .layer(DenseLayer(n_in=8, n_out=12, activation="tanh"))
            .layer(OutputLayer(n_in=12, n_out=4, activation="softmax"))
            .build())


def _line_search_data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = np.zeros((64, 4), np.float32)
    y[np.arange(64), rng.integers(0, 4, 64)] = 1.0
    return x, y


@pytest.fixture(scope="module")
def line_search_runs(tmp_path_factory):
    return once(tmp_path_factory, "dp_line_search",
                lambda: _line_search_runs(tmp_path_factory))


def _line_search_runs(tmp_path_factory):
    """Each algorithm: 3 epochs of one 64-row batch, on 2 gloo ranks (each
    binds 32 rows), in this process without a mesh, and in the JAX package
    on 2 of its virtual CPU devices."""
    tmp = tmp_path_factory.mktemp("dpls")
    data = _line_search_data()
    kw = {"batch_size": 64, "epochs": 3, "prefetch": False}
    cases, one, jx = {}, {}, {}
    for algo in LS_ALGOS:
        net = MultiLayerNetwork(_line_search_conf(algo)).init()
        path = os.path.join(tmp, f"{algo}.zip")
        jms.save_model(net, path)
        cases[algo] = (path, data, kw)
        one[algo] = W._fit_record(W._load(path), data, mesh=False, **kw)
        net.set_mesh(data_parallel_mesh(jax.devices()[:2]))
        tap = _Tap()
        net.set_listeners(tap)
        net.fit(*data, batch_size=64, epochs=3, async_prefetch=False)
        jx[algo] = {"scores": tap.scores, "params": _jax_leaves(net.params_list)}
    return one, jx, run_ranks(W.dp_cases, 2, cases)


@pytest.mark.parametrize("algo", LS_ALGOS)
def test_meshed_line_search_fit_matches_one_process(line_search_runs, algo):
    """The repaired fault: a line-search fit under a two-rank data mesh
    trains (it raised NotImplementedError before), every rank keeps the
    same parameters, and they are the one-process fit's and the JAX
    package's meshed fit's."""
    one, jx, ranks = line_search_runs
    for rec in ranks:
        got = rec[algo]
        assert got["iteration"] == one[algo]["iteration"] == 3
        np.testing.assert_allclose(got["scores"], one[algo]["scores"],
                                   rtol=LS_RTOL, atol=LS_ATOL)
        for (k, a), (_, b) in zip(got["params"], one[algo]["params"]):
            np.testing.assert_allclose(a, b, rtol=LS_RTOL, atol=LS_ATOL, err_msg=k)
        np.testing.assert_allclose(got["scores"], jx[algo]["scores"],
                                   rtol=LS_RTOL, atol=LS_ATOL)
        assert [k for k, _ in got["params"]] == [k for k, _ in jx[algo]["params"]]
        for (k, a), (_, b) in zip(got["params"], jx[algo]["params"]):
            np.testing.assert_allclose(a, b, rtol=LS_RTOL, atol=LS_ATOL,
                                       err_msg=f"{algo} vs JAX meshed {k}")
    for (k, a), (_, b) in zip(ranks[1][algo]["params"], ranks[0][algo]["params"]):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert one[algo]["scores"][-1] < one[algo]["scores"][0]
