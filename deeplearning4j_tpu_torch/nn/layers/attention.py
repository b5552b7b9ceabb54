"""Multi-head self-attention layer (config: SelfAttentionLayer).

The port of the JAX package's nn/layers/attention.py, computed as the
JAX package computes it: the q, k, v projections, explicit scores scaled
by 1/sqrt(head width), the time mask (masked keys cannot be attended,
masked outputs are zero) and the causal triangle, a softmax over the
keys, then the weighted sum of the values and the output projection.
Without a mask the scores and the weighted sum accumulate in f32 at
least, as the JAX package's `full_attention` does.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import apply_activation


def attention_init(gen, conf: L.SelfAttentionLayer, dtype):
    n_in, n_out = int(conf.n_in), int(conf.n_out)
    if n_out % conf.n_heads != 0:
        raise ValueError(
            f"n_out {n_out} must be divisible by n_heads {conf.n_heads}")

    def mk(i, o):
        return init_weights(gen, (i, o), i, o, conf.weight_init, conf.dist, dtype)

    p = {"Wq": mk(n_in, n_out), "Wk": mk(n_in, n_out), "Wv": mk(n_in, n_out),
         "Wo": mk(n_out, n_out)}
    if conf.projection_bias:
        p["b"] = torch.zeros((n_out,), dtype=dtype)
    return p


def _causal(T, device):
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


def full_attention(q, k, v, causal=False):
    """Softmax attention over [B, T, H, D] inputs, the scores and the
    weighted sum in f32 at least."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        s = s.masked_fill(~_causal(q.shape[1], q.device), float("-inf"))
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", a.to(v.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)


def masked_attention(q, k, v, mask, causal=False):
    """Attention in q's dtype with the keys where `mask` [B, T] is 0 (and
    above the diagonal when causal) at a score of -1e30."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s.masked_fill(~(mask[:, None, None, :] > 0), -1e30)
    if causal:
        s = s.masked_fill(~_causal(q.shape[1], q.device), -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def attention_forward(conf: L.SelfAttentionLayer, params, x, ctx: LayerContext):
    """x: [b, t, nIn] -> [b, t, nOut]."""
    B, T, _ = x.shape
    H = int(conf.n_heads)
    E = int(conf.n_out)
    dt = x.dtype
    q = (x @ params["Wq"].to(dt)).reshape(B, T, H, E // H)
    k = (x @ params["Wk"].to(dt)).reshape(B, T, H, E // H)
    v = (x @ params["Wv"].to(dt)).reshape(B, T, H, E // H)
    if ctx.mask is not None:
        o = masked_attention(q, k, v, ctx.mask.to(dt), conf.causal)
    else:
        o = full_attention(q, k, v, causal=conf.causal)
    y = o.reshape(B, T, E) @ params["Wo"].to(dt)
    if conf.projection_bias:
        y = y + params["b"].to(dt)
    if ctx.mask is not None:
        y = y * ctx.mask.to(dt)[..., None]
    return apply_activation(conf.activation or "identity", y,
                            key=ctx.rng, training=ctx.training), None


def attention_order(conf):
    return ("Wq", "Wk", "Wv", "Wo", "b") if conf.projection_bias else (
        "Wq", "Wk", "Wv", "Wo")


register_layer(L.SelfAttentionLayer, attention_init, attention_forward,
               order_fn=attention_order)
