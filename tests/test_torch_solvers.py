"""The port's line-search solvers (train/solvers.py,
MultiLayerNetwork._fit_line_search) against the JAX package's: the cases
of tests/test_pretrain_solvers.py (`test_line_search_optimizers_decrease_loss`,
`test_unknown_optimization_algo_raises`), the first step of each solver
against the JAX package from the same zip (f32, rtol 1e-5 / atol 1e-7),
and the ComputationGraph rule: any `optimization_algo` trains by SGD,
as the JAX graph does.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_parity  # noqa: E402
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.train.sentinel import DivergenceSentinel  # noqa: E402

ALGOS = ["line_gradient_descent", "conjugate_gradient", "lbfgs"]


def _xy(n=32, nin=8, nout=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nin)).astype(np.float32)
    y = np.zeros((n, nout), np.float32)
    y[np.arange(n), rng.integers(0, nout, n)] = 1.0
    return x, y


def _conf(NNC, Dense, Out, algo, seed=4):
    return (NNC.builder().seed(seed).optimization_algo(algo)
            .learning_rate(0.5).weight_init("xavier").list()
            .layer(Dense(n_in=8, n_out=12, activation="tanh"))
            .layer(Out(n_in=12, n_out=4, activation="softmax"))
            .build())


@pytest.mark.parametrize("algo", ALGOS)
def test_line_search_optimizers_decrease_loss(algo):
    net = MultiLayerNetwork(_conf(NeuralNetConfiguration, DenseLayer,
                                  OutputLayer, algo), device="cpu").init()
    x, y = _xy(64)
    s0 = net.score(x, y)
    net.fit(x, y, epochs=20, batch_size=64, async_prefetch=False)
    s1 = net.score(x, y)
    factor = 0.85 if algo == "line_gradient_descent" else 0.7
    assert s1 < s0 * factor, (algo, s0, s1)
    assert net.iteration == 20


def test_unknown_optimization_algo_raises():
    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder()
        .optimization_algo("newton_raphson")
        .list()
        .layer(DenseLayer(n_in=4, n_out=4, activation="tanh"))
        .layer(OutputLayer(n_in=4, n_out=2, activation="softmax"))
        .build(), device="cpu").init()
    x, y = _xy(8, 4, 2)
    with pytest.raises(ValueError, match="unknown optimization algorithm"):
        net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)


def _jax_net(algo):
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer as JDense, NeuralNetConfiguration as JNNC,
        OutputLayer as JOut)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    return JMLN(_conf(JNNC, JDense, JOut, algo)).init()


@pytest.mark.parametrize("algo", ALGOS)
def test_first_steps_match_the_jax_package(algo, tmp_path):
    """The same parameters through both packages' solvers: the first step
    and the two after it (the CG and L-BFGS memories then hold history)."""
    jnet = _jax_net(algo)
    tnet = torch_parity.port_twin(jnet, tmp_path)
    x, y = _xy(64)
    for _ in range(3):
        jnet.fit(x, y, epochs=1, batch_size=64, async_prefetch=False)
        tnet.fit(x, y, epochs=1, batch_size=64, async_prefetch=False)
        torch_parity.assert_close(jnet._score, tnet._score, "f32_step", "score")
        torch_parity.assert_params_close(jnet, tnet, "f32_step")
    assert tnet._step_diag is None and jnet._step_diag is None
    assert tnet.iteration == jnet.iteration == 3


def test_the_sentinel_judges_a_line_search_step_on_its_score():
    net = MultiLayerNetwork(_conf(NeuralNetConfiguration, DenseLayer,
                                  OutputLayer, "lbfgs"), device="cpu").init()
    sent = DivergenceSentinel()
    net.set_sentinel(sent)
    x, y = _xy(64)
    net.fit(x, y, epochs=2, batch_size=64, async_prefetch=False)
    assert sent.anomalies == 0 and net._step_diag is None
    assert torch.isfinite(net._score)


def _graph_conf(NNC, Dense, Out, IT, algo):
    return (NNC.builder().seed(9).optimization_algo(algo).learning_rate(0.1)
            .graph_builder().add_inputs("in")
            .add_layer("d", Dense(n_out=8, activation="tanh"), "in")
            .add_layer("out", Out(n_out=4, activation="softmax",
                                  loss="mcxent"), "d")
            .set_outputs("out").set_input_types(IT.feed_forward(8)).build())


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient"])
def test_a_graph_trains_by_sgd_whatever_optimization_algo_says(algo, tmp_path):
    """The JAX ComputationGraph never reads optimization_algo: a non-SGD
    graph takes SGD steps, in both packages, eager and fused alike."""
    from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer as JDense, InputType as JIT, NeuralNetConfiguration as JNNC,
        OutputLayer as JOut)

    jnet = JCG(_graph_conf(JNNC, JDense, JOut, JIT, algo)).init()
    tnet = torch_parity.port_twin(jnet, tmp_path)
    sgd = ComputationGraph(_graph_conf(NeuralNetConfiguration, DenseLayer,
                                       OutputLayer, InputType, "sgd"),
                           device="cpu").init()
    sgd.params_list = [{k: v.clone() for k, v in p.items()}
                       for p in tnet.params_list]
    fused = torch_parity.port_twin(jnet, tmp_path).set_fused_steps(2)
    x, y = _xy(32)
    for net in (jnet, tnet, sgd, fused):
        net.fit(x, y, epochs=1, batch_size=16, async_prefetch=False)
    torch_parity.assert_params_close(jnet, tnet, "f32_step")
    assert all(torch.equal(a, b) for a, b in zip(tnet.params(), sgd.params()))
    assert all(torch.equal(a, b) for a, b in zip(tnet.params(), fused.params()))
    assert tnet.iteration == 2
