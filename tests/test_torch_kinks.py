"""Subgradients at kinks and ties: the port's activations and losses
(deeplearning4j_tpu_torch/ops/) against the JAX package's, differentiated
by autograd and by jax.grad at the points where a function has a kink, a
clip edge, a hinge margin or a zero residual. Random inputs never land on
them. Tolerance: exact in f64, gradients and values alike.

The JAX package's rules: `jnp.clip` and `jnp.maximum` split a tie 0.5/0.5,
`jax.nn.leaky_relu` takes slope 1 at 0, `jnp.abs` takes +1 at 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.train.gradientcheck import enable_x64
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import losses as tlosses

# every kink of the elementwise activations: 0 (both signs), the hard
# clips' edges (±1; ±2.5 for hardsigmoid), relu6's 6, thresholdedrelu's 1
_ACT_POINTS = np.array([-6.0, -2.5, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 2.5, 6.0, 7.0])

_ACTIVATIONS = ["identity", "relu", "relu6", "leakyrelu", "elu", "selu",
                "hardtanh", "hardsigmoid", "rectifiedtanh", "thresholdedrelu",
                "cube", "softsign", "rrelu"]

# queue 3's table: (function, probe point) -> the JAX gradient
_TABLE = [("hardtanh", 1.0, 0.5), ("hardtanh", -1.0, 0.5),
          ("hardsigmoid", 2.5, 0.1), ("hardsigmoid", -2.5, 0.1),
          ("leakyrelu", 0.0, 1.0), ("leakyrelu", -0.0, 1.0),
          ("rectifiedtanh", 0.0, 0.5), ("rectifiedtanh", -0.0, 0.5)]


def _jax_act_grad(name, x):
    with enable_x64():
        fn = jact.activation_fn(name)
        xj = jnp.asarray(x, jnp.float64)
        val = np.asarray(fn(xj))
        grad = np.asarray(jax.grad(lambda v: fn(v).sum())(xj))
    return val, grad


def _torch_act_grad(name, x):
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    y = tact.apply_activation(name, xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    return y.detach().numpy(), g.numpy()


# each activation's own kinks besides 0
_EDGES = {"hardtanh": [-1.0, 1.0], "hardsigmoid": [-2.5, 2.5],
          "relu6": [6.0], "thresholdedrelu": [1.0]}


@pytest.mark.parametrize("name", _ACTIVATIONS)
def test_activation_subgradients_match_jax_exactly_in_f64(name):
    """Exact at every kink point; between them the smooth pieces (expm1,
    tanh, x/(1+|x|)) may part in the last bits, so rtol 1e-14 and atol
    1e-15 there."""
    jv, jg = _jax_act_grad(name, _ACT_POINTS)
    tv, tg = _torch_act_grad(name, _ACT_POINTS)
    kinks = np.isin(_ACT_POINTS, [0.0] + _EDGES.get(name, []))
    np.testing.assert_array_equal(tg[kinks], jg[kinks])
    np.testing.assert_array_equal(tv[kinks], jv[kinks])
    np.testing.assert_allclose(tv, jv, rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(tg, jg, rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("name,point,expected", _TABLE)
def test_table_activation_kinks_take_the_jax_subgradient(name, point, expected):
    _, jg = _jax_act_grad(name, np.array([point]))
    _, tg = _torch_act_grad(name, np.array([point]))
    assert jg[0] == pytest.approx(expected, rel=1e-15)
    assert tg[0] == jg[0]


def _loss_grads(name, labels, preout, activation="identity"):
    with enable_x64():
        lj, pj = jnp.asarray(labels), jnp.asarray(preout)
        jval = np.asarray(jlosses.loss_value(name, lj, pj, activation))
        jg = np.asarray(jax.grad(
            lambda p: jlosses.loss_value(name, lj, p, activation).sum())(pj))
    pt = torch.tensor(preout, dtype=torch.float64, requires_grad=True)
    tval = tlosses.loss_value(name, torch.tensor(labels, dtype=torch.float64),
                              pt, activation)
    (tg,) = torch.autograd.grad(tval.sum(), pt)
    return jval, jg, tval.detach().numpy(), tg.numpy()


_LABELS = np.array([[0.5, -1.5, 2.0, 1.0], [1.0, -1.0, 0.25, -3.0]])


@pytest.mark.parametrize("name", ["l1", "mean_absolute_error",
                                  "mean_absolute_percentage_error",
                                  "mse", "l2", "squared_loss"])
def test_zero_residual_losses_match_jax_exactly_in_f64(name):
    """out == labels everywhere, and beside them: JAX's abs takes +1 at 0
    (l1 1.0, mean_absolute_error 0.25 over 4 columns)."""
    preout = _LABELS.copy()
    preout[1, 2] += 0.5
    jval, jg, tval, tg = _loss_grads(name, _LABELS, preout)
    np.testing.assert_array_equal(tval, jval)
    np.testing.assert_array_equal(tg, jg)
    if name == "l1":
        assert tg[0, 0] == 1.0
    if name == "mean_absolute_error":
        assert tg[0, 0] == 0.25


@pytest.mark.parametrize("name", ["hinge", "squared_hinge"])
def test_hinge_margin_matches_jax_exactly_in_f64(name):
    """labels·out == 1 (the margin), beside it and past it: hinge's tie
    gives ∓0.5, squared_hinge's 0."""
    labels = np.array([[1.0, -1.0, 1.0, -1.0], [1.0, -1.0, 1.0, -1.0]])
    preout = np.array([[1.0, -1.0, 0.5, 2.0], [2.0, -2.0, -0.5, 0.0]])
    jval, jg, tval, tg = _loss_grads(name, labels, preout)
    np.testing.assert_array_equal(tval, jval)
    np.testing.assert_array_equal(tg, jg)
    if name == "hinge":
        assert tg[0, 0] == -0.5 and tg[0, 1] == 0.5


def test_a_leakyrelu_nets_bias_gradient_matches_jax_at_step_one():
    """A zero-bias dense unit over an all-zero input row: the
    pre-activation is exactly 0, where leakyrelu's slope decides the
    bias gradient. Both packages from the same zip, f64."""
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer, NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.common.dtypes import PrecisionPolicy
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
    from deeplearning4j_tpu_torch.nn.params import params_from_numpy
    from deeplearning4j_tpu_torch.common.dtypes import PrecisionPolicy as TPolicy

    conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=3, n_out=4, activation="leakyrelu"))
            .layer(OutputLayer(n_in=4, n_out=2, activation="identity",
                               loss="mse"))
            .build())
    jnet = JNet(conf).init()
    x = np.zeros((1, 3))
    y = np.array([[1.0, -1.0]])
    with enable_x64():
        jnet.policy = PrecisionPolicy(param_dtype=jnp.float64,
                                      compute_dtype=jnp.float64,
                                      output_dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), jnet.params_list)
        jg = jax.grad(lambda p: jnet._loss(
            p, jnet.state_list, jnp.asarray(x), jnp.asarray(y), None, None,
            rng=None)[0])(p64)
    tnet = TNet(MultiLayerConfiguration.from_json(conf.to_json()), device="cpu")
    tnet.init()
    tnet.params_list = params_from_numpy(
        tnet.conf, [{k: np.asarray(v, np.float64) for k, v in p.items()}
                    for p in jnet.params_list], device="cpu")
    tnet.params_list = [{k: v.double() for k, v in p.items()}
                        for p in tnet.params_list]
    tnet.policy = TPolicy(torch.float64, torch.float64, torch.float64)
    leaves = [p[k].requires_grad_(True) for p in tnet.params_list for k in sorted(p)]
    s, _ = tnet._loss(tnet.params_list, tnet.state_list,
                      torch.tensor(x), torch.tensor(y), None, None, None)
    grads = torch.autograd.grad(s, leaves)
    jleaves = [np.asarray(p[k]) for p in jg for k in sorted(p)]
    for t, j in zip(grads, jleaves):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-14, atol=0)
    # layer 0's bias: its pre-activation is exactly 0, so slope 1 (not
    # F.leaky_relu's 0.01) carries the whole upstream gradient
    np.testing.assert_array_equal(grads[sorted(tnet.params_list[0]).index("b")].numpy(),
                                  np.asarray(jg[0]["b"]))
    assert np.asarray(jg[0]["b"]).any()
