"""Special layers: variational autoencoder, frozen-layer wrapper.

The port of the JAX package's nn/layers/special.py (reference:
nn/layers/variational/VariationalAutoencoder.java — an internal encoder
and decoder MLP, the ELBO objective, pluggable reconstruction
distributions — and nn/layers/FrozenLayer.java). Same parameter names and
order. The ELBO's reparameterisation noise is an argument (`eps`), drawn
from a generator only when the caller gives none.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.core import affine
from deeplearning4j_tpu_torch.nn.layers.registry import (
    LayerContext,
    forward_layer,
    init_layer_params,
    init_layer_state,
    param_order,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.ops.losses import loss_value


# -- variational autoencoder -------------------------------------------------

def _mlp_params(gen, sizes, conf, dtype, prefix):
    params = {}
    for i in range(len(sizes) - 1):
        n_in, n_out = int(sizes[i]), int(sizes[i + 1])
        params[f"{prefix}{i}_W"] = init_weights(
            gen, (n_in, n_out), n_in, n_out, conf.weight_init, conf.dist, dtype)
        params[f"{prefix}{i}_b"] = torch.zeros((n_out,), dtype=dtype)
    return params


def _recon_kind(conf) -> dict:
    return conf.reconstruction_distribution or {"type": "bernoulli"}


def vae_init(gen, conf: L.VariationalAutoencoder, dtype):
    n_in, n_z = int(conf.n_in), int(conf.n_out)
    enc = [n_in] + list(conf.encoder_layer_sizes)
    dec = [n_z] + list(conf.decoder_layer_sizes)

    def w(n_i, n_o, fan_out=None):
        return init_weights(gen, (n_i, n_o), n_i, fan_out or n_o,
                            conf.weight_init, conf.dist, dtype)

    params = _mlp_params(gen, enc, conf, dtype, "enc_")
    last_e = int(enc[-1])
    params["pzx_mean_W"] = w(last_e, n_z)
    params["pzx_mean_b"] = torch.zeros((n_z,), dtype=dtype)
    params["pzx_logstd_W"] = w(last_e, n_z)
    params["pzx_logstd_b"] = torch.zeros((n_z,), dtype=dtype)
    params.update(_mlp_params(gen, dec, conf, dtype, "dec_"))
    last_d = int(dec[-1])
    # the reconstruction distribution's parameters: a gaussian needs mean
    # and log std (2 n_in outputs), the others n_in
    out_mult = 2 if _recon_kind(conf).get("type", "bernoulli") == "gaussian" else 1
    params["pxz_W"] = w(last_d, out_mult * n_in, n_in)
    params["pxz_b"] = torch.zeros((out_mult * n_in,), dtype=dtype)
    return params


def vae_encode(conf, params, x):
    """(mean, log std) of q(z|x)."""
    h = x
    for i in range(len(conf.encoder_layer_sizes)):
        h = apply_activation(conf.activation,
                             affine(h, params[f"enc_{i}_W"], params[f"enc_{i}_b"]))
    mean = apply_activation(conf.pzx_activation,
                            affine(h, params["pzx_mean_W"], params["pzx_mean_b"]))
    log_std = affine(h, params["pzx_logstd_W"], params["pzx_logstd_b"])
    return mean, log_std


def vae_decode(conf, params, z):
    """The decoder's pre-activation of the reconstruction distribution."""
    h = z
    for i in range(len(conf.decoder_layer_sizes)):
        h = apply_activation(conf.activation,
                             affine(h, params[f"dec_{i}_W"], params[f"dec_{i}_b"]))
    return affine(h, params["pxz_W"], params["pxz_b"])


def vae_forward(conf: L.VariationalAutoencoder, params, x, ctx: LayerContext):
    """Supervised path: the layer's activation is the mean of q(z|x)
    (reference: VariationalAutoencoder.activate returns pzxMean)."""
    mean, _ = vae_encode(conf, params, x)
    return mean, None


def vae_samples(conf, training: bool = True) -> int:
    return int(conf.num_samples) if training else 1


def vae_eps(conf, shape, gen, device=None, dtype=torch.float32, training=True):
    """The reparameterisation noise of one ELBO estimate:
    [samples, batch, n_z] standard normals."""
    return torch.randn((vae_samples(conf, training),) + tuple(shape),
                       generator=gen, device=device, dtype=dtype)


def vae_elbo(conf: L.VariationalAutoencoder, params, x, rng=None, training=True,
             eps=None):
    """Negative ELBO per example, the unsupervised pretraining objective
    (reference: VariationalAutoencoder.computeGradientAndScore): the
    analytic KL(q(z|x) || N(0, I)) plus the reconstruction NLL averaged
    over conf.num_samples Monte-Carlo samples (one outside training),
    z = mean + exp(log std) * eps. `eps` [samples, batch, n_z] is the
    noise; without it, it is drawn from the generator `rng`."""
    mean, log_std = vae_encode(conf, params, x)
    kl = 0.5 * (mean * mean + torch.exp(2.0 * log_std) - 2.0 * log_std - 1.0).sum(-1)
    dist = _recon_kind(conf)
    kind = dist.get("type", "bernoulli")
    n_in = int(conf.n_in)
    if eps is None:
        eps = vae_eps(conf, mean.shape, rng, mean.device, mean.dtype, training)
    n_samples = vae_samples(conf, training)
    recon = 0.0
    for s in range(n_samples):
        z = mean + torch.exp(log_std) * eps[s].to(mean.dtype)
        out = vae_decode(conf, params, z)
        if kind == "gaussian":
            r_mean = apply_activation(dist.get("activation", "identity"), out[:, :n_in])
            r_logstd = out[:, n_in:]
            # -log N(x; r_mean, exp(r_logstd)^2)
            nll = 0.5 * (((x - r_mean) ** 2) * torch.exp(-2.0 * r_logstd)
                         + 2.0 * r_logstd + math.log(2.0 * math.pi)).sum(-1)
        elif kind == "exponential":
            # the activation of the preout gives log(lambda);
            # -log p(x) = -log(lambda) + lambda x
            log_lambda = apply_activation(dist.get("activation", "identity"), out)
            nll = (-log_lambda + torch.exp(log_lambda) * x).sum(-1)
        elif kind == "loss_wrapper":
            # any loss function as the reconstruction objective
            nll = loss_value(dist.get("loss", "mse"), x, out,
                             dist.get("activation", "identity"), None)
        elif kind == "bernoulli":
            # stable from logits
            nll = (x * F.softplus(-out) + (1.0 - x) * F.softplus(out)).sum(-1)
        else:
            raise ValueError(
                f"unknown reconstruction distribution {kind!r} "
                "(gaussian | bernoulli | exponential | loss_wrapper)")
        recon = recon + nll
    return recon / n_samples + kl


def vae_order(conf: L.VariationalAutoencoder):
    names = []
    for i in range(len(conf.encoder_layer_sizes)):
        names += [f"enc_{i}_W", f"enc_{i}_b"]
    names += ["pzx_mean_W", "pzx_mean_b", "pzx_logstd_W", "pzx_logstd_b"]
    for i in range(len(conf.decoder_layer_sizes)):
        names += [f"dec_{i}_W", f"dec_{i}_b"]
    names += ["pxz_W", "pxz_b"]
    return tuple(names)


register_layer(L.VariationalAutoencoder, vae_init, vae_forward, order_fn=vae_order)


# -- frozen wrapper ----------------------------------------------------------

def frozen_init(gen, conf: L.FrozenLayer, dtype):
    return init_layer_params(gen, conf.inner, dtype)


def frozen_state(conf: L.FrozenLayer, dtype):
    return init_layer_state(conf.inner, dtype)


def frozen_forward(conf: L.FrozenLayer, params, x, ctx: LayerContext):
    """The inner layer in inference mode (no dropout; a frozen BN uses its
    running statistics and a frozen conv takes no training kernel), its
    state passed through unchanged — reference: FrozenLayer applies the
    layer as at test time. Its parameters take no gradient and no update:
    the network's trainable mask leaves them out of the step
    (nn/netbase.py `_step`)."""
    inner_ctx = LayerContext(training=False, rng=ctx.rng, mask=ctx.mask,
                             timesteps=ctx.timesteps, state=ctx.state)
    y, _ = forward_layer(conf.inner, params, x, inner_ctx)
    return y, None


register_layer(L.FrozenLayer, frozen_init, frozen_forward,
               order_fn=lambda c: param_order(c.inner), state_fn=frozen_state)
