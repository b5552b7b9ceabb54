"""Core feed-forward layers: dense, output heads, embedding, activation,
dropout.

Reference impls: nn/layers/feedforward/dense/DenseLayer.java (preOutput =
input·W + b then activation, BaseLayer.java), BaseOutputLayer.java,
feedforward/embedding/EmbeddingLayer.java, DropoutLayer, ActivationLayer.
Same parameters, names and math as the JAX package's nn/layers/core.py.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import apply_activation


def apply_dropout(x, retain_prob, ctx: LayerContext):
    """Inverted dropout on a layer's *input*, matching the reference
    (BaseLayer.preOutput applies Dropout.applyDropout to the input;
    `dropout` is the retain probability, util/Dropout.java)."""
    if not ctx.training or retain_prob is None or retain_prob <= 0.0 or retain_prob >= 1.0:
        return x
    if ctx.rng is None:
        return x
    keep = torch.rand(x.shape, generator=ctx.rng, device=x.device) < retain_prob
    return torch.where(keep, x / retain_prob, torch.zeros_like(x))


# -- dense -------------------------------------------------------------------

def affine(x, W, b):
    """x @ W + b in the promoted dtype, as jnp promotes a bf16 activation
    times f32 weights to f32 (torch's matmul does not promote)."""
    dt = torch.promote_types(x.dtype, W.dtype)
    return x.to(dt) @ W.to(dt) + b.to(dt)


def dense_init(gen, conf: L.DenseLayer, dtype):
    W = init_weights(gen, (conf.n_in, conf.n_out), conf.n_in, conf.n_out,
                     conf.weight_init, conf.dist, dtype)
    b = torch.full((conf.n_out,), conf.bias_init or 0.0, dtype=dtype)
    return {"W": W, "b": b}


def dense_forward(conf, params, x, ctx: LayerContext):
    x = apply_dropout(x, conf.dropout, ctx)
    z = affine(x, params["W"], params["b"])
    return apply_activation(conf.activation, z, key=ctx.rng, training=ctx.training), None


register_layer(L.DenseLayer, dense_init, dense_forward)


# -- output heads ------------------------------------------------------------
# OutputLayer / RnnOutputLayer forward = dense + activation; the loss is
# applied by the network. RnnOutputLayer applies the same W
# time-distributed.

register_layer(L.OutputLayer, dense_init, dense_forward)


def rnn_output_forward(conf, params, x, ctx: LayerContext):
    # x: [batch, time, nIn]: one [batch*time, nIn] x [nIn, nOut] product
    z = affine(x, params["W"], params["b"])
    return apply_activation(conf.activation, z, key=ctx.rng, training=ctx.training), None


register_layer(L.RnnOutputLayer, dense_init, rnn_output_forward)


# -- activation / dropout / loss (parameterless) -----------------------------

def _no_params(gen, conf, dtype):
    return {}


def activation_forward(conf, params, x, ctx: LayerContext):
    return apply_activation(conf.activation, x, key=ctx.rng, training=ctx.training), None


register_layer(L.ActivationLayer, _no_params, activation_forward)


def dropout_forward(conf, params, x, ctx: LayerContext):
    return apply_dropout(x, conf.dropout, ctx), None


register_layer(L.DropoutLayer, _no_params, dropout_forward)
register_layer(L.LossLayer, _no_params, activation_forward)


# -- embedding ---------------------------------------------------------------

def embedding_init(gen, conf: L.EmbeddingLayer, dtype):
    W = init_weights(gen, (conf.n_in, conf.n_out), conf.n_in, conf.n_out,
                     conf.weight_init, conf.dist, dtype)
    out = {"W": W}
    if conf.has_bias:
        out["b"] = torch.full((conf.n_out,), conf.bias_init or 0.0, dtype=dtype)
    return out


def embedding_forward(conf, params, x, ctx: LayerContext):
    """x: integer indices [batch] or [batch, 1] (reference:
    EmbeddingLayer.java — one-hot-equivalent lookup)."""
    idx = x.long()
    if idx.dim() == 2 and idx.shape[-1] == 1:
        idx = idx[:, 0]
    z = params["W"][idx]
    if conf.has_bias:
        z = z + params["b"]
    return apply_activation(conf.activation, z, key=ctx.rng, training=ctx.training), None


def embedding_order(conf):
    return ("W", "b") if conf.has_bias else ("W",)


register_layer(L.EmbeddingLayer, embedding_init, embedding_forward, order_fn=embedding_order)
