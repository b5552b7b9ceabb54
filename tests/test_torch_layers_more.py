"""The layers of the port's second layer slice (Convolution1D,
Subsampling1D, ZeroPadding, masked global pooling, LocalResponseNormalization,
AutoEncoder, CenterLossOutputLayer, FrozenLayer, VariationalAutoencoder,
SelfAttentionLayer, RBM) against the JAX package's, on the CPU.

Each layer conf crosses over as JSON; the JAX package initializes the
parameters and the port takes the same numpy arrays. Forwards and the
gradients of sum(y * cotangent) with respect to the input and every
parameter are compared in f32: forwards rtol 1e-5 / atol 1e-6, gradients
rtol 1e-4 / atol 1e-5 (sums of products in another order, through a
softmax or a power for some). The port's own gradients are held in f64 by
torch.autograd.gradcheck (its default tolerances). The stochastic pieces
(AutoEncoder corruption, VAE sampling, RBM sampling) take the noise the
JAX function draws, redrawn from its key.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.serde import config_to_dict
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import rbm as jrbm
from deeplearning4j_tpu.nn.layers import special as jspecial
from deeplearning4j_tpu.nn.layers import registry as jreg
from deeplearning4j_tpu_torch.nn.conf.serde import config_from_dict
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.layers import rbm as trbm
from deeplearning4j_tpu_torch.nn.layers import registry as treg
from deeplearning4j_tpu_torch.nn.layers import special as tspecial

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _port_conf(jconf):
    """The JAX conf through JSON. A VAE's reconstruction_distribution dict
    carries a "type" key that neither package's config reader takes as
    plain data (a known fault of the reference), so it is set after."""
    dist = getattr(jconf, "reconstruction_distribution", None)
    if dist is None:
        return config_from_dict(config_to_dict(jconf))
    jconf.reconstruction_distribution = None
    try:
        tconf = config_from_dict(config_to_dict(jconf))
    finally:
        jconf.reconstruction_distribution = dist
    tconf.reconstruction_distribution = dict(dist)
    return tconf


def _jparams(jconf, seed=0):
    p = jreg.init_layer_params(jax.random.PRNGKey(seed), jconf, jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _tparams(params, dtype=torch.float32):
    return {k: torch.tensor(v, dtype=dtype) for k, v in params.items()}


def _close(port, ref, tol=FWD):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _layer_case(jconf, x, *, mask=None, training=False, seed=0, state=None):
    """Forward, input and parameter gradients of one layer in both
    packages; returns the port's pieces for further checks."""
    tconf = _port_conf(jconf)
    assert treg.param_order(tconf) == jreg.param_order(jconf)
    params = _jparams(jconf, seed)
    tinit = treg.init_layer_params(torch.Generator().manual_seed(0), tconf, torch.float32)
    assert {k: tuple(v.shape) for k, v in tinit.items()} == \
        {k: v.shape for k, v in params.items()}
    rng = np.random.default_rng(seed + 1)
    jm = None if mask is None else jnp.asarray(mask)

    def jfwd(p, xx):
        ctx = jreg.LayerContext(training=training, mask=jm, state=state and {
            k: jnp.asarray(v) for k, v in state.items()})
        return jreg.forward_layer(jconf, p, xx, ctx)[0]

    jy = jfwd({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    cot = rng.standard_normal(jy.shape).astype(np.float32)
    jgx, jgp = jax.grad(lambda xx, p: jnp.sum(jfwd(p, xx) * cot), argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})

    def tfwd(p, xx, dtype=torch.float32):
        ctx = treg.LayerContext(
            training=training,
            mask=None if mask is None else torch.tensor(mask, dtype=dtype),
            state=state and {k: torch.tensor(v, dtype=dtype) for k, v in state.items()})
        return treg.forward_layer(tconf, p, xx, ctx)[0]

    tp = {k: v.requires_grad_() for k, v in _tparams(params).items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = tfwd(tp, tx)
    _close(ty, jy)
    (ty * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, jgx, GRAD)
    for k in params:  # a parameter the forward does not use has no grad
        g = tp[k].grad
        _close(torch.zeros_like(tp[k]) if g is None else g, jgp[k], GRAD)

    # the port's gradients in f64 against finite differences
    names = sorted(params)
    p64 = [torch.tensor(params[k], dtype=torch.float64, requires_grad=True) for k in names]
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda xx, *ps: tfwd(dict(zip(names, ps)), xx, torch.float64), (x64, *p64))
    return tconf, params


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("mode,stride,padding", [
    ("truncate", 1, 1), ("truncate", 2, 0), ("same", 2, 0), ("same", 1, 0)])
def test_convolution1d(mode, stride, padding):
    conf = JL.Convolution1DLayer(n_in=3, n_out=4, kernel_size=3, stride=stride,
                                 padding=padding, convolution_mode=mode,
                                 activation="tanh", weight_init="xavier")
    _layer_case(conf, _x((2, 8, 3)))


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("mode", ["truncate", "same"])
def test_subsampling1d(ptype, mode):
    conf = JL.Subsampling1DLayer(pooling_type=ptype, kernel_size=2, stride=2,
                                 convolution_mode=mode, pnorm=2)
    # 7 steps: SAME pads one step on the high side, truncate drops one
    _layer_case(conf, _x((2, 7, 3)))


def test_zero_padding():
    _layer_case(JL.ZeroPaddingLayer(padding=(1, 2, 0, 3)), _x((2, 4, 5, 3)))


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_masked_time(ptype):
    """[b, t, f] input with a time mask: one row with masked steps, one
    fully masked (avg divides by max(sum(mask), 1) there)."""
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0], [1, 0, 1, 0, 1]], np.float32)
    conf = JL.GlobalPoolingLayer(pooling_type=ptype, pnorm=3)
    x = _x((3, 5, 4))
    if ptype == "pnorm":
        x = np.abs(x) + 0.5  # |x|^p is smooth away from 0
    _layer_case(conf, x, mask=mask)
    if ptype in ("avg", "sum"):
        mask0 = mask.copy()
        mask0[2] = 0.0
        _layer_case(conf, x, mask=mask0)


@pytest.mark.parametrize("n", [5, 4])
def test_local_response_normalization(n):
    """Odd and even windows: an even n leans low, (n//2, n-1-n//2)."""
    conf = JL.LocalResponseNormalization(n=float(n), k=2.0, alpha=1e-2, beta=0.75)
    _layer_case(conf, _x((2, 3, 3, 7)))


def test_autoencoder_forward_and_reconstruct():
    conf = JL.AutoEncoder(n_in=6, n_out=4, activation="sigmoid", weight_init="xavier",
                          corruption_level=0.3)
    tconf, params = _layer_case(conf, _x((5, 6)))
    x = np.random.default_rng(3).uniform(size=(5, 6)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jrec = jcore.autoencoder_reconstruct(
        conf, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jreg.LayerContext(training=True, rng=key))
    keep = np.array(jax.random.bernoulli(key, 0.7, x.shape))
    trec = tcore.autoencoder_reconstruct(
        tconf, _tparams(params), torch.from_numpy(x), treg.LayerContext(training=True),
        keep=torch.from_numpy(keep))
    _close(trec, jrec)
    # no corruption outside training
    jrec0 = jcore.autoencoder_reconstruct(
        conf, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jreg.LayerContext(training=False, rng=key))
    trec0 = tcore.autoencoder_reconstruct(
        tconf, _tparams(params), torch.from_numpy(x), treg.LayerContext(training=False))
    _close(trec0, jrec0)


def test_autoencoder_keep_draw_statistics():
    """The port's own corruption draw keeps 1 - corruption_level of the
    entries: over 100k draws within 5 standard deviations."""
    conf = _port_conf(JL.AutoEncoder(n_in=100, n_out=4, corruption_level=0.3))
    keep = tcore.autoencoder_keep(conf, (1000, 100), torch.Generator().manual_seed(0))
    n = keep.numel()
    assert abs(keep.float().mean().item() - 0.7) < 5 * np.sqrt(0.7 * 0.3 / n)


def test_center_loss_output_layer_forward_and_state():
    conf = JL.CenterLossOutputLayer(n_in=5, n_out=3, activation="softmax",
                                    weight_init="xavier")
    tconf, _ = _layer_case(conf, _x((4, 5)))
    jst = jreg.init_layer_state(conf, jnp.float32)
    tst = treg.init_layer_state(tconf, torch.float32)
    assert set(tst) == set(jst) == {"centers"}
    assert tuple(tst["centers"].shape) == jst["centers"].shape == (3, 5)


def test_frozen_layer_runs_inner_in_inference_mode():
    """A frozen BN uses its running statistics and passes its state
    through; a frozen dense layer applies no dropout in training."""
    bn = JL.FrozenLayer(inner=JL.BatchNormalization(n_in=4))
    state = {"mean": np.array([0.1, -0.2, 0.3, 0.0], np.float32),
             "var": np.array([1.5, 0.5, 2.0, 1.0], np.float32)}
    tconf, _ = _layer_case(bn, _x((6, 4)), training=True, state=state)
    assert treg.param_order(tconf) == ("gamma", "beta")
    tst = treg.init_layer_state(tconf, torch.float32)
    assert set(tst) == set(jreg.init_layer_state(bn, jnp.float32))
    y, ns = treg.forward_layer(
        tconf, _tparams(_jparams(bn)), torch.from_numpy(_x((6, 4))),
        treg.LayerContext(training=True, state={k: torch.tensor(v) for k, v in state.items()}))
    assert ns is None
    dense = JL.FrozenLayer(inner=JL.DenseLayer(n_in=4, n_out=3, activation="tanh",
                                               dropout=0.5, weight_init="xavier"))
    tconf, params = _layer_case(dense, _x((6, 4)), training=True)
    ctx = treg.LayerContext(training=True, rng=torch.Generator().manual_seed(1))
    y1 = treg.forward_layer(tconf, _tparams(params), torch.from_numpy(_x((6, 4))), ctx)[0]
    y0 = treg.forward_layer(tconf, _tparams(params), torch.from_numpy(_x((6, 4))),
                            treg.LayerContext())[0]
    assert torch.equal(y0, y1)


_DISTS = [
    {"type": "bernoulli"},
    {"type": "gaussian", "activation": "tanh"},
    {"type": "exponential", "activation": "tanh"},
    {"type": "loss_wrapper", "loss": "mse", "activation": "sigmoid"},
]


def _vae_conf(dist, samples=2):
    return JL.VariationalAutoencoder(
        n_in=6, n_out=3, encoder_layer_sizes=[5, 4], decoder_layer_sizes=[4],
        activation="tanh", pzx_activation="identity", weight_init="xavier",
        reconstruction_distribution=dist, num_samples=samples)


def _jax_vae_eps(conf, key, shape, training=True):
    """The eps the JAX vae_elbo draws from `key`: one split per sample."""
    out = []
    for _ in range(int(conf.num_samples) if training else 1):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("dist", _DISTS, ids=lambda d: d["type"])
def test_vae_forward_and_elbo(dist):
    conf = _vae_conf(dist)
    tconf, params = _layer_case(conf, _x((4, 6)))
    assert treg.param_order(tconf) == (
        "enc_0_W", "enc_0_b", "enc_1_W", "enc_1_b", "pzx_mean_W", "pzx_mean_b",
        "pzx_logstd_W", "pzx_logstd_b", "dec_0_W", "dec_0_b", "pxz_W", "pxz_b")
    x = np.random.default_rng(5).uniform(0.05, 0.95, size=(4, 6)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for training in (True, False):
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        j_elbo = lambda p: jspecial.vae_elbo(conf, p, jnp.asarray(x), key, training)
        eps = torch.from_numpy(_jax_vae_eps(conf, key, (4, 3), training))
        tp = {k: v.requires_grad_() for k, v in _tparams(params).items()}
        t_elbo = tspecial.vae_elbo(tconf, tp, torch.from_numpy(x), training=training,
                                   eps=eps)
        _close(t_elbo, j_elbo(jp))
        jg = jax.grad(lambda p: jnp.sum(j_elbo(p)))(jp)
        t_elbo.sum().backward()
        for k in params:
            _close(tp[k].grad, jg[k], GRAD)


def test_vae_eps_draw_statistics():
    """The port's own eps are standard normals: mean and variance over
    60k draws within 5 standard errors."""
    conf = _port_conf(_vae_conf({"type": "bernoulli"}, samples=3))
    e = tspecial.vae_eps(conf, (2000, 10), torch.Generator().manual_seed(0))
    assert e.shape == (3, 2000, 10)
    n = e.numel()
    assert abs(e.mean().item()) < 5 / np.sqrt(n)
    assert abs(e.var().item() - 1.0) < 5 * np.sqrt(2.0 / n)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_self_attention(causal, masked):
    conf = JL.SelfAttentionLayer(n_in=5, n_out=8, n_heads=2, causal=causal,
                                 activation="identity", weight_init="xavier")
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32) if masked else None
    tconf, _ = _layer_case(conf, _x((2, 4, 5)), mask=mask)
    assert treg.param_order(tconf) == ("Wq", "Wk", "Wv", "Wo", "b")
    nb = _port_conf(JL.SelfAttentionLayer(n_in=5, n_out=8, n_heads=2,
                                          projection_bias=False))
    assert treg.param_order(nb) == ("Wq", "Wk", "Wv", "Wo")


def _jax_rbm_noise(conf, rng, shape):
    """The uniforms (binary) or normals (gaussian) the JAX chain draws at
    each Gibbs step j from fold_in(rng, j)."""
    out = []
    for j in range(int(conf.k) + 1):
        k = jax.random.fold_in(rng, j)
        out.append(np.asarray(jax.random.normal(k, shape, jnp.float32)
                              if conf.hidden_unit == "gaussian"
                              else jax.random.uniform(k, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("hidden,visible,k,sparsity", [
    ("binary", "binary", 1, 0.0), ("binary", "binary", 3, 0.1),
    ("gaussian", "gaussian", 2, 0.0), ("rectified", "binary", 1, 0.0)])
def test_rbm_forward_and_cd_stats(hidden, visible, k, sparsity):
    conf = JL.RBM(n_in=6, n_out=4, activation="sigmoid", weight_init="xavier",
                  hidden_unit=hidden, visible_unit=visible, k=k, sparsity=sparsity)
    tconf, params = _layer_case(conf, _x((5, 6)))
    assert treg.param_order(tconf) == ("W", "b", "vb")
    v0 = (np.random.default_rng(2).uniform(size=(5, 6)) > 0.5).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    jg, jx = jrbm.rbm_cd_stats(conf, {k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(v0), rng)
    if hidden == "binary":  # the JAX bernoulli draw is uniform < p
        p = jnp.asarray(np.random.default_rng(3).uniform(size=(5, 4)), jnp.float32)
        key = jax.random.fold_in(rng, 0)
        assert bool(jnp.all(jax.random.bernoulli(key, p)
                            == (jax.random.uniform(key, p.shape, jnp.float32) < p)))
    noise = torch.from_numpy(_jax_rbm_noise(conf, rng, (5, 4)))
    tg, tx = trbm.rbm_cd_stats(tconf, _tparams(params), torch.from_numpy(v0), noise=noise)
    _close(tx, jx)
    for name in ("W", "b", "vb"):
        _close(tg[name], jg[name], GRAD)


# the port's decoder layers, which the JAX package does not have
# (models/granite_hybrid.py)
PORT_ONLY_LAYERS = {"SequenceEmbeddingLayer", "RMSNormLayer", "GatedMLPLayer",
                    "GroupedQueryAttentionLayer", "Mamba2Layer", "TiedOutputLayer"}


def test_all_layer_confs_registered_with_the_jax_param_order():
    """Every layer conf the JAX package registers has an init and a
    forward in the port; beyond them the port registers its decoder
    layers only."""
    assert {c.__name__ for c in treg._INIT} == {c.__name__ for c in jreg._INIT} | PORT_ONLY_LAYERS
    assert ({c.__name__ for c in treg._FORWARD}
            == {c.__name__ for c in jreg._FORWARD} | PORT_ONLY_LAYERS)
