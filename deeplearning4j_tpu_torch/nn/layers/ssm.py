"""The Mamba-2 mixer (config: Mamba2Layer), as Hugging Face's
GraniteMoeHybridMambaLayer computes it (Dao & Gu, arXiv:2405.21060):

    [z | xBC | dt] = x W_in                      (no bias)
    xBC = SiLU(causal depthwise conv_d_conv(xBC) + conv_b)
    [xs | B | C] = xBC;  dt = softplus(dt + dt_bias);  A = -exp(A_log)
    y = SSD(xs, dt, A, B, C) + D xs               (chunks of chunk_size)
    out = RMSNorm(y * SiLU(z)) * norm_gamma @ W_out

The SSD is ops/fused_ssd.py: the CUDA kernels on the card, the plain
chunked version on the CPU. dt, A and D stay f32 under the bf16 policy;
the gated norm's statistic is f32 and its output is rounded to the
activation's dtype before the gain.

Initialisation (mamba_ssm's defaults): W_in and W_out by the layer's
weight init, the conv's weight and bias uniform in +-1/sqrt(d_conv) (a
depthwise Conv1d's default), A = U(1, 16) as A_log, dt = exp(U(log 1e-3,
log 1e-1)) (at least 1e-4) as its softplus inverse dt_bias, D = 1 and the
norm's gain 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.lm import linear_init
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext, register_layer
from deeplearning4j_tpu_torch.ops.fused_ssd import ssd_scan


def mamba_widths(conf: L.Mamba2Layer):
    """(inner width, conv channels, in_proj width)."""
    inner = int(conf.n_heads) * int(conf.head_dim)
    conv = inner + 2 * int(conf.n_groups) * int(conf.d_state)
    return inner, conv, inner + conv + int(conf.n_heads)


def _uniform(gen, shape, lo, hi, dtype):
    return (lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32)).to(dtype)


def mamba_init(gen, conf: L.Mamba2Layer, dtype):
    n, H, K = int(conf.n_in), int(conf.n_heads), int(conf.d_conv)
    inner, conv, proj = mamba_widths(conf)
    bound = 1.0 / math.sqrt(K)
    dt = torch.exp(_uniform(gen, (H,), math.log(1e-3), math.log(1e-1), torch.float32))
    dt = dt.clamp_min(1e-4)
    return {"W_in": linear_init(gen, conf, n, proj, dtype),
            "conv_W": _uniform(gen, (conv, K), -bound, bound, dtype),
            "conv_b": _uniform(gen, (conv,), -bound, bound, dtype),
            "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
            "A_log": torch.log(_uniform(gen, (H,), 1.0, 16.0, torch.float32)).to(dtype),
            "D": torch.ones((H,), dtype=dtype),
            "norm_gamma": torch.ones((inner,), dtype=dtype),
            "W_out": linear_init(gen, conf, inner, n, dtype)}


MAMBA_ORDER = ("W_in", "conv_W", "conv_b", "dt_bias", "A_log", "D", "norm_gamma", "W_out")


def mamba_forward(conf: L.Mamba2Layer, params, x, ctx: LayerContext):
    """x [b, t, n] -> [b, t, n]."""
    B, T, _ = x.shape
    H, P, G, N = int(conf.n_heads), int(conf.head_dim), int(conf.n_groups), int(conf.d_state)
    inner, conv, _ = mamba_widths(conf)
    dt_ = x.dtype
    z, xbc, dt = (x @ params["W_in"].to(dt_)).split([inner, conv, H], dim=-1)
    K = int(conf.d_conv)
    xbc = F.conv1d(xbc.transpose(1, 2), params["conv_W"].to(dt_).view(conv, 1, K),
                   params["conv_b"].to(dt_),
                   padding=K - 1, groups=conv)[..., :T].transpose(1, 2)
    xs, Bm, Cm = F.silu(xbc).split([inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y = ssd_scan(xs.reshape(B, T, H, P), dt, A, Bm.reshape(B, T, G, N),
                 Cm.reshape(B, T, G, N), params["D"].float(), int(conf.chunk_size))
    # the f32 intermediates of the gated norm are formed again in the
    # backward (the layer keeps y and z, not four [b, t, inner] f32 tensors)
    y = checkpoint(gated_rms_norm, y.reshape(B, T, inner), z, params["norm_gamma"],
                   conf.norm_eps, use_reentrant=False, preserve_rng_state=False)
    return y @ params["W_out"].to(dt_), None


def gated_rms_norm(y, z, gamma, eps: float):
    """RMSNorm(y * SiLU(z)) * gamma, the statistic in f32, the result
    rounded to y's dtype before the gain (Hugging Face's
    GraniteMoeHybridRMSNormGated)."""
    h = y.float() * F.silu(z.float())
    h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps)
    return h.to(y.dtype) * gamma.to(y.dtype)


register_layer(L.Mamba2Layer, mamba_init, mamba_forward, order_fn=lambda conf: MAMBA_ORDER)
