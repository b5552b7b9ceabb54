"""Decoder language-model layers: the token embedding over [b, t] ids,
RMSNorm, the gated (SwiGLU) MLP and the tied output head (configs in
nn/conf/layers.py; the model is models/granite_hybrid.py). The Mamba-2
mixer is nn/layers/ssm.py and grouped-query attention
nn/layers/attention.py.

Parameters are f32 under both precision policies and cast to the
activation's dtype at use, as the other layers do; the RMSNorm statistic
is taken in f32 and its output rounded to the input's dtype before the
gain, as Hugging Face's GraniteMoeHybridRMSNorm does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights


def linear_init(gen, conf, n_in: int, n_out: int, dtype):
    """A [n_in, n_out] projection by the layer's weight init."""
    return init_weights(gen, (n_in, n_out), n_in, n_out, conf.weight_init, conf.dist, dtype)


def rms_norm(x, gamma, eps: float):
    """x / sqrt(mean(x^2) + eps) over the last axis in f32, rounded to x's
    dtype, times gamma."""
    h = x.float()
    h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps)
    return h.to(x.dtype) * gamma.to(x.dtype)


# -- token embedding ---------------------------------------------------------

def seq_embedding_init(gen, conf: L.SequenceEmbeddingLayer, dtype):
    return {"W": linear_init(gen, conf, int(conf.n_in), int(conf.n_out), dtype)}


def seq_embedding_forward(conf, params, x, ctx: LayerContext):
    """ids [b, t] (any integer or integral float dtype) -> rows [b, t, n_out]
    in the network's compute dtype."""
    rows = F.embedding(x.long(), params["W"])
    return rows.to(ctx.dtype or rows.dtype), None


register_layer(L.SequenceEmbeddingLayer, seq_embedding_init, seq_embedding_forward,
               order_fn=lambda conf: ("W",))


# -- RMSNorm -----------------------------------------------------------------

def rms_norm_init(gen, conf: L.RMSNormLayer, dtype):
    return {"gamma": torch.ones((int(conf.n_in),), dtype=dtype)}


def rms_norm_forward(conf, params, x, ctx: LayerContext):
    return rms_norm(x, params["gamma"], conf.eps), None


register_layer(L.RMSNormLayer, rms_norm_init, rms_norm_forward,
               order_fn=lambda conf: ("gamma",))


# -- gated MLP ---------------------------------------------------------------

def gated_mlp_init(gen, conf: L.GatedMLPLayer, dtype):
    n, k = int(conf.n_in), int(conf.hidden_size)
    return {"W_in": linear_init(gen, conf, n, 2 * k, dtype),
            "W_out": linear_init(gen, conf, k, n, dtype)}


def _gate(gu, activation):
    from deeplearning4j_tpu_torch.ops.activations import apply_activation

    gate, up = gu.chunk(2, dim=-1)
    return apply_activation(activation, gate) * up


def gated_mlp_forward(conf, params, x, ctx: LayerContext):
    dt = x.dtype
    # the activation's output is formed again in the backward: the layer
    # keeps x W_in and the gated product, not a third [b, t, hidden] tensor
    h = checkpoint(_gate, x @ params["W_in"].to(dt), conf.activation,
                   use_reentrant=False, preserve_rng_state=False)
    return h @ params["W_out"].to(dt), None


register_layer(L.GatedMLPLayer, gated_mlp_init, gated_mlp_forward,
               order_fn=lambda conf: ("W_in", "W_out"))


# -- tied output head --------------------------------------------------------

def tied_logits(conf: L.TiedOutputLayer, table, x):
    """x W^T / logits_scaling with the tied table W [vocab, n_in]; the
    scaling is applied to x before the product (exact for a power of two,
    and it saves one [b, t, vocab] pass)."""
    return (x * (1.0 / conf.logits_scaling)) @ table.to(x.dtype).T


def tied_output_forward(conf, params, x, ctx: LayerContext):
    from deeplearning4j_tpu_torch.ops.activations import apply_activation

    return apply_activation(conf.activation, tied_logits(conf, params["W"], x),
                            key=ctx.rng, training=ctx.training), None


register_layer(L.TiedOutputLayer, lambda gen, conf, dtype: {}, tied_output_forward,
               order_fn=lambda conf: ())
