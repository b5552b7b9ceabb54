"""The port's gradient check (train/gradientcheck.py) on the cases of
tests/test_gradientcheck.py: central differences against autograd in f64
(the network's dtype for the check), eps 1e-6, rel 1e-5 with a 1e-8
absolute floor, as the reference runs them (GradientCheckTests,
CNNGradientCheckTest, LSTMGradientCheckTests, BNGradientCheckTest,
LossFunctionGradientCheck). Each case is also cross-checked by
`torch.autograd.gradcheck` on the same f64 loss of the flat parameters
(its default tolerances, atol 1e-5 / rtol 1e-3), and one against the JAX
package's analytic f64 gradient from the same zip (rtol 1e-10)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_parity  # noqa: E402
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    ActivationLayer,
    AutoEncoder,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    GravesBidirectionalLSTM,
    GravesLSTM,
    InputType,
    LSTM,
    MergeVertex,
    NeuralNetConfiguration,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.train.gradientcheck import (  # noqa: E402
    check_gradients,
    check_gradients_graph,
    f64_loss,
)


def _check(net, x, y, features_mask=None, labels_mask=None, verbose=False):
    assert check_gradients(net, x, y, features_mask=features_mask,
                           labels_mask=labels_mask, verbose=verbose)
    with f64_loss(net, x, y, features_mask, labels_mask) as (fn, flat0):
        assert torch.autograd.gradcheck(fn, (flat0.clone().requires_grad_(),),
                                        eps=1e-6)


RNG = np.random.default_rng(12345)


def _labels(n, c):
    y = np.zeros((n, c))
    y[np.arange(n), RNG.integers(0, c, n)] = 1.0
    return y


def _rnn_labels(n, t, c):
    y = np.zeros((n, t, c))
    idx = RNG.integers(0, c, (n, t))
    for i in range(n):
        y[i, np.arange(t), idx[i]] = 1.0
    return y


# smooth activations only (reference whitelist GradientCheckUtil.java:48-59)
@pytest.mark.parametrize("act,loss,out_act", [
    ("tanh", "mcxent", "softmax"),
    ("sigmoid", "mse", "identity"),
    ("softplus", "mcxent", "softmax"),
    ("cube", "mse", "tanh"),
    ("softsign", "xent", "sigmoid"),
    ("elu", "mse", "identity"),
])
def test_mlp_gradients(act, loss, out_act):
    conf = (
        NeuralNetConfiguration.builder()
        .seed(12345)
        .list()
        .layer(DenseLayer(n_in=4, n_out=5, activation=act))
        .layer(OutputLayer(n_out=3, activation=out_act, loss=loss))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.normal(size=(6, 4))
    if loss == "xent":
        y = RNG.uniform(0.1, 0.9, size=(6, 3))
    else:
        y = _labels(6, 3)
    _check(net, x, y, verbose=True)


def test_mlp_with_l1_l2_gradients():
    conf = (
        NeuralNetConfiguration.builder()
        .seed(12345)
        .l1(0.01)
        .l2(0.02)
        .list()
        .layer(DenseLayer(n_in=4, n_out=5, activation="tanh"))
        .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    # keep weights away from 0 so |w| is differentiable at the check points
    x = RNG.normal(size=(5, 4))
    y = _labels(5, 3)
    _check(net, x, y)


def test_cnn_gradients():
    conf = (
        NeuralNetConfiguration.builder()
        .seed(12345)
        .list()
        .layer(ConvolutionLayer(kernel_size=(2, 2), n_out=3, activation="tanh"))
        .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2), pooling_type="avg"))
        .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.convolutional(6, 6, 2))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.normal(size=(4, 6, 6, 2))
    y = _labels(4, 2)
    _check(net, x, y, verbose=True)


def test_cnn_max_pool_gradients():
    # max pool is piecewise-linear; fine for gradient checks away from ties
    conf = (
        NeuralNetConfiguration.builder()
        .seed(99)
        .list()
        .layer(ConvolutionLayer(kernel_size=(3, 3), n_out=2, activation="sigmoid"))
        .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.convolutional(7, 7, 1))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.normal(size=(3, 7, 7, 1))
    y = _labels(3, 2)
    _check(net, x, y)


def test_batchnorm_gradients():
    conf = (
        NeuralNetConfiguration.builder()
        .seed(12345)
        .list()
        .layer(DenseLayer(n_in=4, n_out=6, activation="tanh"))
        .layer(BatchNormalization())
        .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(4))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.normal(size=(8, 4))
    y = _labels(8, 3)
    _check(net, x, y, verbose=True)


def test_lstm_gradients():
    conf = (
        NeuralNetConfiguration.builder()
        .seed(12345)
        .list()
        .layer(LSTM(n_out=4, activation="tanh"))
        .layer(RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.recurrent(3))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.normal(size=(3, 5, 3))
    y = _rnn_labels(3, 5, 2)
    _check(net, x, y, verbose=True)


def test_graves_lstm_gradients_with_mask():
    conf = (
        NeuralNetConfiguration.builder()
        .seed(12345)
        .list()
        .layer(GravesLSTM(n_out=3, activation="tanh"))
        .layer(RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.recurrent(2))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.normal(size=(2, 6, 2))
    y = _rnn_labels(2, 6, 2)
    mask = np.ones((2, 6))
    mask[0, 4:] = 0
    mask[1, 5:] = 0
    _check(net, x, y, features_mask=mask, labels_mask=mask)


def test_bidirectional_lstm_gradients():
    conf = (
        NeuralNetConfiguration.builder()
        .seed(5)
        .list()
        .layer(GravesBidirectionalLSTM(n_out=3, activation="tanh"))
        .layer(GlobalPoolingLayer(pooling_type="avg"))
        .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.recurrent(2))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.normal(size=(2, 4, 2))
    y = _labels(2, 2)
    _check(net, x, y)


def test_embedding_gradients():
    conf = (
        NeuralNetConfiguration.builder()
        .seed(12345)
        .list()
        .layer(EmbeddingLayer(n_in=7, n_out=4, activation="tanh"))
        .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.integers(0, 7, size=(6, 1)).astype(np.float64)
    y = _labels(6, 3)
    _check(net, x, y)


def test_autoencoder_supervised_gradients():
    conf = (
        NeuralNetConfiguration.builder()
        .seed(3)
        .list()
        .layer(AutoEncoder(n_in=5, n_out=4, activation="sigmoid"))
        .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .build()
    )
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = RNG.normal(size=(4, 5))
    y = _labels(4, 2)
    _check(net, x, y)


def test_graph_gradients():
    """check_gradients_graph on a two-branch graph with a merge."""
    conf = (NeuralNetConfiguration.builder().seed(7).graph_builder()
            .add_inputs("in")
            .add_layer("a", DenseLayer(n_in=4, n_out=3, activation="tanh"), "in")
            .add_layer("b", DenseLayer(n_in=4, n_out=2, activation="sigmoid"), "in")
            .add_vertex("m", MergeVertex(), "a", "b")
            .add_layer("out", OutputLayer(n_in=5, n_out=3, activation="softmax",
                                          loss="mcxent"), "m")
            .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu").init()
    x = RNG.normal(size=(5, 4))
    y = _labels(5, 3)
    assert check_gradients_graph(net, [x], [y])
    with f64_loss(net, [x], [y]) as (fn, flat0):
        assert torch.autograd.gradcheck(fn, (flat0.clone().requires_grad_(),),
                                        eps=1e-6)


def test_f64_analytic_gradient_matches_the_jax_package(tmp_path):
    """The analytic side itself: the port's f64 gradient of a GravesLSTM
    net equals the JAX package's f64 gradient from the same zip."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.common.dtypes import PrecisionPolicy as JPolicy
    from deeplearning4j_tpu.nn.conf import (
        GravesLSTM as JGraves, InputType as JIT,
        NeuralNetConfiguration as JNNC, RnnOutputLayer as JRnnOut)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.train.gradientcheck import enable_x64

    jnet = JMLN(JNNC.builder().seed(12345).list()
                .layer(JGraves(n_out=3, activation="tanh"))
                .layer(JRnnOut(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(JIT.recurrent(2)).build()).init()
    tnet = torch_parity.port_twin(jnet, tmp_path)
    x = RNG.normal(size=(2, 6, 2))
    y = _rnn_labels(2, 6, 2)
    with enable_x64():
        jnet.policy = JPolicy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
                              output_dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), jnet.params_list)
        jg = jax.grad(lambda p: jnet._loss(p, jnet.state_list, jnp.asarray(x),
                                           jnp.asarray(y), None, None,
                                           rng=None)[0])(p64)
        jg = [{k: np.asarray(v) for k, v in g.items()} for g in jg]
    from deeplearning4j_tpu_torch.nn.params import flat_to_params

    with f64_loss(tnet, x, y) as (fn, flat0):
        flat = flat0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(flat), flat)
        tg = flat_to_params(tnet._ordered_layer_confs(),
                            [{k: v.double() for k, v in p.items()}
                             for p in tnet.params_list], g)
    torch_parity.assert_grads_close(jg, tg, "f64_grad")
