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


# -- grouped-query attention (config: GroupedQueryAttentionLayer) ------------

def gqa_init(gen, conf: L.GroupedQueryAttentionLayer, dtype):
    n, D = int(conf.n_in), int(conf.head_dim)
    hq, hkv = int(conf.n_heads), int(conf.n_kv_heads)
    if hq % hkv:
        raise ValueError(f"n_heads {hq} must be a multiple of n_kv_heads {hkv}")

    def mk(i, o):
        return init_weights(gen, (i, o), i, o, conf.weight_init, conf.dist, dtype)

    return {"Wq": mk(n, hq * D), "Wk": mk(n, hkv * D), "Wv": mk(n, hkv * D),
            "Wo": mk(hq * D, n)}


def blocked_causal_attention(q, k, v, scale: float, block: int = 128):
    """Causal softmax attention over [B, H, T, D] in blocks of `block`
    queries, each block's scores [B, H, block, keys so far] in f32 at
    least: the same function as fused attention, with no [T, T] tensor."""
    acc = torch.promote_types(q.dtype, torch.float32)
    T = q.shape[2]
    outs = []
    for i in range(0, T, block):
        j = min(i + block, T)
        s = (q[:, :, i:j].to(acc) @ k[:, :, :j].to(acc).transpose(-1, -2)) * scale
        rows = torch.arange(i, j, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(j, device=q.device)[None, :] > rows, float("-inf"))
        outs.append((torch.softmax(s, dim=-1) @ v[:, :, :j].to(acc)).to(q.dtype))
    return torch.cat(outs, dim=2)


def gqa_core(q, k, v, scale: float):
    """Causal attention of q [B, Hq, T, D] over k, v [B, Hkv, T, D], each
    key head shared by Hq / Hkv query heads: PyTorch's fused attention on
    the card, query blocks elsewhere."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if q.device.type == "cuda":
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)
    return blocked_causal_attention(q, k, v, scale)


def gqa_forward(conf: L.GroupedQueryAttentionLayer, params, x, ctx: LayerContext):
    """x [b, t, n] -> [b, t, n]."""
    from deeplearning4j_tpu_torch.utils import tracing

    B, T, _ = x.shape
    D, hq, hkv = int(conf.head_dim), int(conf.n_heads), int(conf.n_kv_heads)
    dt = x.dtype
    q = (x @ params["Wq"].to(dt)).view(B, T, hq, D).transpose(1, 2)
    k = (x @ params["Wk"].to(dt)).view(B, T, hkv, D).transpose(1, 2)
    v = (x @ params["Wv"].to(dt)).view(B, T, hkv, D).transpose(1, 2)
    scale = conf.score_scale if conf.score_scale is not None else 1.0 / math.sqrt(D)
    with tracing.span("attn/gqa"):
        o = gqa_core(q, k, v, float(scale))
    return o.transpose(1, 2).reshape(B, T, hq * D) @ params["Wo"].to(dt), None


register_layer(L.GroupedQueryAttentionLayer, gqa_init, gqa_forward,
               order_fn=lambda conf: ("Wq", "Wk", "Wv", "Wo"))
