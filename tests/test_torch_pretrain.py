"""The port's layerwise pretraining (MultiLayerNetwork.pretrain,
pretrain_layer, fit with conf.pretrain) and the center-loss head (both
networks) against the JAX package's, on the CPU.

Same configuration JSON, same parameters (carried across with
params_from_numpy), same numpy batches. The pretraining noise — the
AutoEncoder's keep mask, the VAE's eps, the RBM chain's uniforms — is the
JAX package's, redrawn from the key its step uses (fold_in(PRNGKey(seed ^
(0xBEEF + layer)), iteration)) and handed to the port. f32: scores rtol
1e-5; parameters after the steps rtol 1e-5 / atol 1e-6 (the same
expressions, summed in another order); center-loss centers rtol 1e-5 /
atol 1e-7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train.listeners import IterationListener as JListener
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph as TCG
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.nn.params import params_from_numpy, states_from_numpy
from deeplearning4j_tpu_torch.train.listeners import IterationListener as TListener

SCORE = dict(rtol=1e-5, atol=0)
PARAM = dict(rtol=1e-5, atol=1e-6)
CENTERS = dict(rtol=1e-5, atol=1e-7)


def _np_tree(tree):
    return [None if p is None else {k: np.asarray(v) for k, v in p.items()} for p in tree]


def _port_of(jnet):
    """The JAX network's conf, parameters and layer state in the port, on
    the CPU."""
    if isinstance(jnet, JCG):
        tnet = TCG(ComputationGraphConfiguration.from_json(jnet.conf.to_json()),
                   device="cpu").init()
    else:
        tnet = TMLN(MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                    device="cpu").init()
    tnet.params_list = params_from_numpy(tnet.conf, _np_tree(jnet.params_list),
                                         device="cpu")
    tnet.state_list = states_from_numpy(tnet.conf, _np_tree(jnet.state_list),
                                        device="cpu")
    tnet.upd_state = tnet.updater_def.init_tree(tnet.params_list)
    return tnet


def _params_close(tnet, jnet, tol=PARAM):
    for tp, jp in zip(tnet.params_list, jnet.params_list):
        assert set(tp) == set(jp)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **tol)


class _JScores(JListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, info):
        self.scores.append(float(info["score"]()))


class _TScores(TListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, info):
        self.scores.append(float(info["score"]()))


# -- pretraining -------------------------------------------------------------

def _pretrain_conf(layer, pretrain=False, updater="adam", lr=0.01):
    return (JNNC.builder().seed(3).updater(updater).learning_rate(lr)
            .weight_init("xavier").list()
            .layer(layer)
            .layer(JL.DenseLayer(n_out=5, activation="tanh"))
            .layer(JL.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(8)).pretrain(pretrain).build())


_LAYERS = {
    "autoencoder": lambda: JL.AutoEncoder(n_out=6, activation="sigmoid",
                                          corruption_level=0.3, loss="mse"),
    "vae": lambda: JL.VariationalAutoencoder(
        n_out=4, encoder_layer_sizes=[7], decoder_layer_sizes=[7],
        activation="tanh", num_samples=2),
    "rbm": lambda: JL.RBM(n_out=6, activation="sigmoid", hidden_unit="binary",
                          visible_unit="binary", k=2, sparsity=0.05),
}


def _jax_noise(jconf):
    """The port's `noise(idx, it, x_in)` hook, giving JAX's draws."""
    def noise(idx, it, x_in):
        conf = jconf.layers[idx]
        rng = jax.random.fold_in(
            jax.random.PRNGKey(jconf.net_conf.seed ^ (0xBEEF + idx)), it)
        B = x_in.shape[0]
        if isinstance(conf, JL.AutoEncoder):
            out = np.array(jax.random.bernoulli(rng, 1.0 - conf.corruption_level,
                                                tuple(x_in.shape)))
        elif isinstance(conf, JL.VariationalAutoencoder):
            eps = []
            for _ in range(int(conf.num_samples)):
                rng, k = jax.random.split(rng)
                eps.append(np.asarray(jax.random.normal(k, (B, conf.n_out), jnp.float32)))
            out = np.stack(eps)
        else:
            out = np.stack([np.asarray(jax.random.uniform(
                jax.random.fold_in(rng, j), (B, conf.n_out), jnp.float32))
                for j in range(int(conf.k) + 1)])
        return torch.from_numpy(out)

    return noise


def _data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(n, 8)).astype(np.float32)
    if seed % 2:  # binary visible data for the RBM
        x = (x > 0.5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


@pytest.mark.parametrize("kind", sorted(_LAYERS))
def test_pretrain_layer_matches_jax(kind):
    """pretrain_layer: 2 epochs of 3 batches with the same noise; the
    pretrained layer's parameters and the last score agree, and the
    layers above are untouched."""
    jconf = _pretrain_conf(_LAYERS[kind]())
    jnet = JMLN(jconf).init()
    tnet = _port_of(jnet)
    x, _ = _data(seed=1 if kind == "rbm" else 0)
    jnet.pretrain_layer(0, x, epochs=2, batch_size=8)
    tnet.pretrain_layer(0, x, epochs=2, batch_size=8, noise=_jax_noise(jconf))
    _params_close(tnet, jnet)
    np.testing.assert_allclose(float(tnet._score), float(jnet._score), **SCORE)


@pytest.mark.parametrize("kind", sorted(_LAYERS))
def test_pretrain_then_fit_with_conf_pretrain(kind):
    """fit on a conf with pretrain=True pretrains every pretrainable layer
    once, then trains by backprop: the scores of the supervised steps and
    the final parameters agree with the JAX package's."""
    jconf = _pretrain_conf(_LAYERS[kind](), pretrain=True)
    jnet = JMLN(jconf).init()
    tnet = _port_of(jnet)
    vb0 = tnet.params_list[0]["pzx_mean_b" if kind == "vae" else "b"].clone()
    tnet._pretrain_noise = _jax_noise(jconf)
    x, y = _data(seed=1 if kind == "rbm" else 0)
    jl, tl = _JScores(), _TScores()
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    jnet.fit(x, y, epochs=2, batch_size=8, async_prefetch=False)
    tnet.fit(x, y, epochs=2, batch_size=8, async_prefetch=False)
    assert len(tl.scores) == len(jl.scores) == 6
    np.testing.assert_allclose(tl.scores, jl.scores, **SCORE)
    _params_close(tnet, jnet)
    assert not torch.equal(vb0, tnet.params_list[0]["pzx_mean_b" if kind == "vae" else "b"])
    # pretraining runs once per network
    assert tnet._pretrained


def test_pretrain_noise_draws_have_the_stated_shapes():
    """The port's own noise (no hook): shapes, dtypes, and a uniform
    chain whose mean is 1/2 within 5 standard errors."""
    x, _ = _data(n=400, seed=1)
    for kind, shape in (("autoencoder", (400, 8)), ("vae", (2, 400, 4)),
                        ("rbm", (3, 400, 6))):
        tnet = _port_of(JMLN(_pretrain_conf(_LAYERS[kind]())).init())
        eps = tnet._pretrain_noise(0, 0, torch.from_numpy(x))
        assert tuple(eps.shape) == shape
        if kind == "rbm":
            assert abs(eps.mean().item() - 0.5) < 5 * np.sqrt(1 / 12 / eps.numel())
        assert torch.equal(eps, tnet._pretrain_noise(0, 0, torch.from_numpy(x)))
        assert not torch.equal(eps, tnet._pretrain_noise(0, 1, torch.from_numpy(x)))


def test_pretrain_rejects_a_layer_that_is_not_pretrainable():
    tnet = _port_of(JMLN(_pretrain_conf(_LAYERS["rbm"]())).init())
    with pytest.raises(ValueError, match="not pretrainable"):
        tnet.pretrain_layer(1, _data()[0])


# -- center loss ---------------------------------------------------------------

def _center_mln_conf():
    return (JNNC.builder().seed(5).updater("nesterovs").learning_rate(0.05)
            .momentum(0.9).weight_init("xavier").list()
            .layer(JL.DenseLayer(n_out=6, activation="tanh"))
            .layer(JL.CenterLossOutputLayer(n_out=3, activation="softmax",
                                            loss="mcxent", alpha=0.1, lambda_=0.05))
            .set_input_type(JIT.feed_forward(5)).build())


def _center_data(seed=2, n=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _fit_both(jnet, tnet, x, y, epochs=2, batch=8, **kw):
    jl, tl = _JScores(), _TScores()
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    jnet.fit(x, y, epochs=epochs, batch_size=batch, async_prefetch=False, **kw)
    tnet.fit(x, y, epochs=epochs, batch_size=batch, async_prefetch=False, **kw)
    return jl.scores, tl.scores


def test_center_loss_mln_score_and_centers():
    jnet = JMLN(_center_mln_conf()).init()
    tnet = _port_of(jnet)
    x, y = _center_data()
    # a nonzero center state first, so the term is not trivially 0
    jnet.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
    tnet.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
    np.testing.assert_allclose(tnet.score(x, y), float(jnet.score(x, y)), **SCORE)
    jscores, tscores = _fit_both(jnet, tnet, x, y)
    np.testing.assert_allclose(tscores, jscores, **SCORE)
    _params_close(tnet, jnet)
    np.testing.assert_allclose(tnet.state_list[-1]["centers"].numpy(),
                               np.asarray(jnet.state_list[-1]["centers"]), **CENTERS)
    assert float(np.abs(np.asarray(jnet.state_list[-1]["centers"])).max()) > 0


def test_center_loss_masked_rows_leave_the_centers():
    """A labels mask that drops a row: the row counts neither in the score
    nor in the centers' EMA, in both packages."""
    jnet = JMLN(_center_mln_conf()).init()
    tnet = _port_of(jnet)
    x, y = _center_data(n=8)
    lm = np.ones((8,), np.float32)
    lm[[1, 5]] = 0.0
    from deeplearning4j_tpu.data.dataset import DataSet as JDS
    from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS

    jnet.fit(JDS(x, y, None, lm), batch_size=8, async_prefetch=False)
    tnet.fit(TDS(x, y, None, lm), batch_size=8, async_prefetch=False)
    np.testing.assert_allclose(float(tnet._score), float(jnet._score), **SCORE)
    np.testing.assert_allclose(tnet.state_list[-1]["centers"].numpy(),
                               np.asarray(jnet.state_list[-1]["centers"]), **CENTERS)


def test_center_loss_graph_head():
    """The ComputationGraph's center-loss head: scores, parameters and
    centers over 6 steps."""
    gb = (JNNC.builder().seed(6).updater("adam").learning_rate(0.01)
          .weight_init("xavier").graph_builder().add_inputs("in"))
    gb.add_layer("h", JL.DenseLayer(n_in=5, n_out=6, activation="relu"), "in")
    gb.add_layer("out", JL.CenterLossOutputLayer(n_in=6, n_out=3, activation="softmax",
                                                 loss="mcxent", alpha=0.2,
                                                 lambda_=0.1), "h")
    gb.set_outputs("out")
    jnet = JCG(gb.build()).init()
    tnet = _port_of(jnet)
    x, y = _center_data(seed=4)
    jscores, tscores = _fit_both(jnet, tnet, x, y)
    np.testing.assert_allclose(tscores, jscores, **SCORE)
    _params_close(tnet, jnet)
    np.testing.assert_allclose(tnet.state_list[-1]["centers"].numpy(),
                               np.asarray(jnet.state_list[-1]["centers"]), **CENTERS)
    np.testing.assert_allclose(tnet.score(x, y), float(jnet.score(x, y)), **SCORE)


def test_center_loss_fused_steps_equal_the_loop():
    """set_fused_steps(3): the fused program (a loop of steps on the CPU)
    leaves the same parameters, updater state and centers as the loop."""
    jnet = JMLN(_center_mln_conf()).init()
    loop, fused = _port_of(jnet), _port_of(jnet)
    fused.set_fused_steps(3)
    x, y = _center_data(n=24)
    loop.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
    fused.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
    assert fused._programs  # the group ran as one program
    for a, b in ((loop.params_list, fused.params_list),
                 (loop.state_list, fused.state_list)):
        for pa, pb in zip(a, b):
            for k in (pa or {}):
                assert torch.equal(pa[k], pb[k])
