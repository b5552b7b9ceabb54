"""Core feed-forward layers: dense, output heads (the center-loss head
included), embedding, activation, dropout, autoencoder.

Reference impls: nn/layers/feedforward/dense/DenseLayer.java (preOutput =
input·W + b then activation, BaseLayer.java), BaseOutputLayer.java,
training/CenterLossOutputLayer.java, feedforward/embedding/
EmbeddingLayer.java, DropoutLayer, ActivationLayer,
feedforward/autoencoder/AutoEncoder.java. Same parameters, names and math
as the JAX package's nn/layers/core.py.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.ops.losses import example_presence, global_present_count
from deeplearning4j_tpu_torch.parallel.mesh import copy_to_axis, data_sum, draw_rows, psum


def apply_dropout(x, retain_prob, ctx: LayerContext):
    """Inverted dropout on a layer's *input*, matching the reference
    (BaseLayer.preOutput applies Dropout.applyDropout to the input;
    `dropout` is the retain probability, util/Dropout.java)."""
    if not ctx.training or retain_prob is None or retain_prob <= 0.0 or retain_prob >= 1.0:
        return x
    if ctx.rng is None:
        return x
    # inside a data-parallel step: the global batch's draw, this rank's rows
    keep = draw_rows(lambda s: torch.rand(s, generator=ctx.rng, device=x.device),
                     x.shape) < retain_prob
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
    if ctx.tp is None:
        z = affine(x, params["W"], params["b"])
    else:
        # Megatron's pair (parallel/tensor.py): a column layer's input
        # collects its gradient from every rank; a row layer sums its
        # partial products, then adds the replicated bias
        role, mesh, axis = ctx.tp
        if role == "column":
            z = affine(copy_to_axis(x, mesh, axis), params["W"], params["b"])
        else:
            dt = torch.promote_types(x.dtype, params["W"].dtype)
            z = psum(x.to(dt) @ params["W"].to(dt), mesh, axis) + params["b"].to(dt)
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


def center_loss_state(conf: L.CenterLossOutputLayer, dtype):
    # per-class feature centers, EMA-updated outside the gradient
    # (reference: CenterLossOutputLayer / CenterLossParamInitializer 'cL')
    return {"centers": torch.zeros((conf.n_out, conf.n_in), dtype=dtype)}


register_layer(L.CenterLossOutputLayer, dense_init, dense_forward,
               state_fn=center_loss_state)


def center_loss_term(conf: L.CenterLossOutputLayer, state, feats, y, per_ex,
                     l_mask, training):
    """The center-loss head's extra score and its new state (reference:
    CenterLossOutputLayer.java): lambda * mean over present examples of
    0.5 ||f - c_y||^2 on the head's (post-dropout) input features `feats`,
    and, in training, each class center present in the batch moved toward
    its batch mean, c <- (1 - alpha) c + alpha mean(f : y = class), outside
    the gradient (None when not training). `per_ex` is the base loss per
    example, for the presence of masked rows."""
    centers = state["centers"].to(feats.dtype)  # [classes, nIn]
    y32 = y.to(feats.dtype)
    diff = feats - y32 @ centers  # one-hot pick
    center_per_ex = 0.5 * (diff * diff).sum(-1)
    present = example_presence(per_ex, l_mask)
    term = (conf.lambda_ * (center_per_ex * present).sum()
            / global_present_count(present).clamp_min(1.0))
    if not training:
        return term, None
    with torch.no_grad():
        yw = y32 * present[:, None]  # pad rows excluded from the EMA
        # the class counts and feature sums of the global batch (one
        # buffer, summed over the data axis inside a data-parallel step)
        sums = data_sum(torch.cat([yw.sum(0)[:, None], yw.T @ feats.detach()], 1),
                        "center_loss")
        counts = sums[:, :1]  # [classes, 1]
        means = sums[:, 1:] / counts.clamp_min(1.0)
        updated = torch.where(counts > 0,
                              (1.0 - conf.alpha) * centers + conf.alpha * means,
                              centers)
    return term, {"centers": updated.to(state["centers"].dtype)}


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


# -- autoencoder -------------------------------------------------------------

def autoencoder_init(gen, conf: L.AutoEncoder, dtype):
    out = dense_init(gen, conf, dtype)
    out["vb"] = torch.zeros((conf.n_in,), dtype=dtype)  # visible bias, for decoding
    return out


def autoencoder_keep(conf: L.AutoEncoder, shape, gen, device=None):
    """The corruption draw: True where an input entry survives (with
    probability 1 - corruption_level)."""
    return draw_rows(lambda s: torch.rand(s, generator=gen, device=device),
                     shape) < 1.0 - conf.corruption_level


def autoencoder_reconstruct(conf: L.AutoEncoder, params, x, ctx: LayerContext,
                            corrupt: bool = True, keep=None):
    """Unsupervised pass: corrupt -> encode -> decode with tied weights
    (reference: AutoEncoder.java, decode with W^T and the visible bias).
    Corruption zeroes the entries where `keep` is False; without `keep` it
    is drawn from ctx.rng. It applies only in training with a corruption
    level above 0."""
    h_in = x
    if corrupt and ctx.training and conf.corruption_level > 0:
        if keep is None and ctx.rng is not None:
            keep = autoencoder_keep(conf, x.shape, ctx.rng, x.device)
        if keep is not None:
            h_in = torch.where(keep, x, torch.zeros_like(x))
    h = apply_activation(conf.activation, affine(h_in, params["W"], params["b"]))
    return apply_activation(conf.activation, affine(h, params["W"].T, params["vb"]))


def autoencoder_order(conf):
    return ("W", "b", "vb")


register_layer(L.AutoEncoder, autoencoder_init, dense_forward,
               order_fn=autoencoder_order)
