"""Restricted Boltzmann machine.

The port of the JAX package's nn/layers/rbm.py (reference:
nn/layers/feedforward/rbm/RBM.java — contrastiveDivergence() (:102) runs
CD-k Gibbs chains: propUp (:224), sampleHiddenGivenVisible (:223), gibbhVh
(:208), propDown (:276), with BINARY/GAUSSIAN/RECTIFIED unit types
(:228,279)). CD is not the gradient of a tractable objective, so the
statistics are computed explicitly, as a gradient-shaped dict the
network's updater applies like any other gradient.

The chain's noise is an argument: `noise[j]` [batch, nOut] drives the
hidden sample of Gibbs step j (uniforms for binary units, a sample is
u < p; standard normals added to the mean for gaussian units; rectified
units take their mean and use none). Without it, it is drawn from a
generator.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.core import affine, dense_forward
from deeplearning4j_tpu_torch.nn.layers.registry import register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights


def rbm_init(gen, conf: L.RBM, dtype):
    W = init_weights(gen, (conf.n_in, conf.n_out), conf.n_in, conf.n_out,
                     conf.weight_init, conf.dist, dtype)
    return {
        "W": W,
        "b": torch.full((conf.n_out,), conf.bias_init or 0.0, dtype=dtype),  # hidden
        "vb": torch.zeros((conf.n_in,), dtype=dtype),  # visible
    }


def rbm_order(conf):
    return ("W", "b", "vb")


# the supervised path is propUp: activation(x W + hidden bias)
register_layer(L.RBM, rbm_init, dense_forward, order_fn=rbm_order)


def prop_up(conf, params, v):
    pre = affine(v, params["W"], params["b"])
    if conf.hidden_unit == "gaussian":
        return pre
    if conf.hidden_unit == "rectified":
        return torch.relu(pre)
    return torch.sigmoid(pre)


def prop_down(conf, params, h):
    pre = affine(h, params["W"].T, params["vb"])
    if conf.visible_unit == "gaussian":
        return pre
    return torch.sigmoid(pre)


def sample_hidden(conf, h_prob, noise):
    if conf.hidden_unit == "binary":
        return (noise < h_prob).to(h_prob.dtype)
    if conf.hidden_unit == "gaussian":
        return h_prob + noise.to(h_prob.dtype)
    return h_prob  # rectified: the mean (the reference samples NReLU)


def rbm_noise(conf, batch: int, gen, device=None, dtype=torch.float32):
    """[k + 1, batch, nOut] chain noise: uniforms for binary hidden units,
    standard normals for gaussian ones (rectified units ignore it)."""
    shape = (int(conf.k) + 1, int(batch), int(conf.n_out))
    if conf.hidden_unit == "gaussian":
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return torch.rand(shape, generator=gen, device=device, dtype=dtype)


def rbm_cd_stats(conf: L.RBM, params, v0, rng=None, noise=None):
    """One CD-k estimate. Returns (grads dict matching params, per-example
    reconstruction cross-entropy as the monitoring score); the grads point
    in the DESCENT direction for the updater (minimise -log p)."""
    if noise is None:
        noise = rbm_noise(conf, v0.shape[0], rng, v0.device, v0.dtype)
    h0_prob = prop_up(conf, params, v0)
    h = sample_hidden(conf, h0_prob, noise[0])
    vk, hk_prob = v0, h0_prob
    for step in range(int(conf.k)):
        vk = prop_down(conf, params, h)
        hk_prob = prop_up(conf, params, vk)
        h = sample_hidden(conf, hk_prob, noise[step + 1])
    inv_b = 1.0 / v0.shape[0]
    grads = {
        "W": -(v0.T @ h0_prob - vk.T @ hk_prob) * inv_b,
        "b": -(h0_prob - hk_prob).mean(0),
        "vb": -(v0 - vk).mean(0),
    }
    if conf.sparsity:
        # the sparsity penalty pulls the mean hidden activation down
        grads["b"] = grads["b"] + conf.sparsity * h0_prob.mean(0)
    eps = 1e-7
    vr = prop_down(conf, params, h0_prob).clamp(eps, 1 - eps)
    recon_xent = -(v0 * torch.log(vr) + (1 - v0) * torch.log(1 - vr)).sum(-1)
    return grads, recon_xent
