"""Convolution, pooling and global pooling layers (NHWC, HWIO weights).

The port of the JAX package's nn/layers/conv.py (reference:
nn/layers/convolution/ConvolutionLayer.java and the cuDNN helper plugin,
CudnnConvolutionHelper.java:345). The builtin conv is F.conv2d on
channels-last views of the NHWC tensors; SAME padding is XLA's, with the
odd extra pixel on the high side, so it is applied explicitly where the
two sides differ. In training, a registered "conv2d" helper takes over
when it supports the call (ops/fused_conv_bn.py: the conv with the BN
statistics epilogue).

Pooling (reference: SubsamplingLayer.java): max pads with -inf, sum,
avg and pnorm with zeros, and avg divides by the full window, as the JAX
package's reduce_window does. Conv1D (NWC input, WIO weights) and
Subsampling1D run the same code over the time axis; global pooling over
a [batch, time, features] input honours the time mask (reference:
GlobalPoolingLayer.java + MaskedReductionUtil).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionMode, PoolingType
from deeplearning4j_tpu_torch.nn.layers.core import apply_dropout
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.ops.fused_conv_bn import conv2d_nhwc, same_pads
from deeplearning4j_tpu_torch.ops.helpers import HelperError, get_helper


def _pads_2d(conf, x_shape, kernel, strides, dilation=(1, 1)):
    """((top, bottom), (left, right)) for a conf's padding on NHWC x."""
    if conf.convolution_mode == ConvolutionMode.SAME:
        return tuple(same_pads(int(x_shape[1 + i]), kernel[i], strides[i],
                               dilation[i])[1:] for i in range(2))
    p = conf.padding
    return (int(p[0]), int(p[0])), (int(p[1]), int(p[1]))


# -- 2D convolution ----------------------------------------------------------

def conv_init(gen, conf: L.ConvolutionLayer, dtype):
    kh, kw = int(conf.kernel_size[0]), int(conf.kernel_size[1])
    W = init_weights(gen, (kh, kw, conf.n_in, conf.n_out), conf.n_in * kh * kw,
                     conf.n_out * kh * kw, conf.weight_init, conf.dist, dtype)
    out = {"W": W}
    if conf.has_bias:
        out["b"] = torch.full((conf.n_out,), conf.bias_init or 0.0, dtype=dtype)
    return out


def conv_forward(conf: L.ConvolutionLayer, params, x, ctx: LayerContext):
    x = apply_dropout(x, conf.dropout, ctx)
    kernel = tuple(int(k) for k in conf.kernel_size)
    strides = tuple(int(s) for s in conf.stride)
    dilation = tuple(int(d) for d in conf.dilation)
    w = params["W"].to(x.dtype)
    # vendor-kernel plugin point (the CudnnConvolutionHelper analog): a
    # helper that raises on CPU tensors is disabled by the SPI and the
    # builtin conv below runs instead
    z = None
    helper = get_helper(
        "conv2d", kernel=kernel, stride=strides, dilation=dilation,
        same=conf.convolution_mode == ConvolutionMode.SAME,
        has_bias=conf.has_bias, activation=conf.activation, dtype=x.dtype,
        n_in=int(x.shape[-1]), n_out=int(conf.n_out),
        x_shape=tuple(int(d) for d in x.shape), training=ctx.training,
        device=x.device)
    if helper is not None:
        try:
            z = helper(x, w, strides=strides)
        except HelperError:
            z = None
    if z is None:
        z = conv2d_nhwc(x, w, strides,
                        _pads_2d(conf, x.shape, kernel, strides, dilation), dilation)
    if conf.has_bias:
        z = z + params["b"].to(z.dtype)
    return apply_activation(conf.activation, z, key=ctx.rng, training=ctx.training), None


def conv_order(conf):
    return ("W", "b") if conf.has_bias else ("W",)


register_layer(L.ConvolutionLayer, conv_init, conv_forward, order_fn=conv_order)


# -- 1D convolution over time ------------------------------------------------

def _pads_1d(conf, length, k, s):
    if conf.convolution_mode == ConvolutionMode.SAME:
        return same_pads(int(length), k, s)[1:]
    return int(conf.padding), int(conf.padding)


def conv1d_init(gen, conf: L.Convolution1DLayer, dtype):
    k = int(conf.kernel_size)
    W = init_weights(gen, (k, conf.n_in, conf.n_out), conf.n_in * k,
                     conf.n_out * k, conf.weight_init, conf.dist, dtype)
    out = {"W": W}
    if conf.has_bias:
        out["b"] = torch.full((conf.n_out,), conf.bias_init or 0.0, dtype=dtype)
    return out


def conv1d_forward(conf: L.Convolution1DLayer, params, x, ctx: LayerContext):
    """x: [batch, time, nIn] -> [batch, time', nOut]; W is [k, nIn, nOut]."""
    x = apply_dropout(x, conf.dropout, ctx)
    k, s = int(conf.kernel_size), int(conf.stride)
    lo, hi = _pads_1d(conf, x.shape[1], k, s)
    xn = x.permute(0, 2, 1)
    if lo != hi:
        xn, lo = F.pad(xn, (lo, hi)), 0
    z = F.conv1d(xn, params["W"].to(x.dtype).permute(2, 1, 0), stride=s, padding=lo)
    z = z.permute(0, 2, 1).contiguous()
    if conf.has_bias:
        z = z + params["b"].to(z.dtype)
    return apply_activation(conf.activation, z, key=ctx.rng, training=ctx.training), None


register_layer(L.Convolution1DLayer, conv1d_init, conv1d_forward, order_fn=conv_order)


# -- pooling -----------------------------------------------------------------

def _pool2d(x, pooling_type, kernel, strides, pads, pnorm):
    """Window pooling over H, W of NHWC x with explicit pads."""
    (t, b), (l, r) = pads
    xn = x.permute(0, 3, 1, 2)
    if pooling_type == PoolingType.MAX:
        y = F.max_pool2d(F.pad(xn, (l, r, t, b), value=float("-inf")), kernel, strides)
    elif pooling_type in (PoolingType.SUM, PoolingType.AVG, PoolingType.PNORM):
        p = float(pnorm) if pooling_type == PoolingType.PNORM else 1.0
        v = xn.abs() ** p if pooling_type == PoolingType.PNORM else xn
        # sum over the zero-padded window (divisor_override=1)
        y = F.avg_pool2d(F.pad(v, (l, r, t, b)), kernel, strides, divisor_override=1)
        if pooling_type == PoolingType.AVG:
            y = y / (kernel[0] * kernel[1])
        elif pooling_type == PoolingType.PNORM:
            y = y ** (1.0 / p)
    else:
        raise ValueError(f"unknown pooling type {pooling_type!r}")
    return y.permute(0, 2, 3, 1).contiguous()


def _no_params(gen, conf, dtype):
    return {}


def subsampling_forward(conf: L.SubsamplingLayer, params, x, ctx: LayerContext):
    kernel = (int(conf.kernel_size[0]), int(conf.kernel_size[1]))
    strides = (int(conf.stride[0]), int(conf.stride[1]))
    pads = _pads_2d(conf, x.shape, kernel, strides)
    return _pool2d(x, conf.pooling_type, kernel, strides, pads, conf.pnorm), None


register_layer(L.SubsamplingLayer, _no_params, subsampling_forward)


def subsampling1d_forward(conf: L.Subsampling1DLayer, params, x, ctx: LayerContext):
    """[batch, time, c] pooled over time: the 2-D pooling with a unit
    width axis."""
    k, s = int(conf.kernel_size), int(conf.stride)
    pads = (_pads_1d(conf, x.shape[1], k, s), (0, 0))
    y = _pool2d(x[:, :, None, :], conf.pooling_type, (k, 1), (s, 1), pads, conf.pnorm)
    return y[:, :, 0, :], None


register_layer(L.Subsampling1DLayer, _no_params, subsampling1d_forward)


# -- zero padding ------------------------------------------------------------

def zero_padding_forward(conf: L.ZeroPaddingLayer, params, x, ctx: LayerContext):
    pt, pb, pl, pr = (int(v) for v in conf.padding)
    return F.pad(x, (0, 0, pl, pr, pt, pb)), None


register_layer(L.ZeroPaddingLayer, _no_params, zero_padding_forward)


# -- global pooling ----------------------------------------------------------

def global_pooling_forward(conf: L.GlobalPoolingLayer, params, x, ctx: LayerContext):
    """CNN input [b, h, w, c]: pool over h, w. RNN input [b, t, f]: pool
    over t, honouring the time mask: masked steps are -inf for max and
    zero otherwise, and avg divides by max(sum(mask), 1) (reference:
    GlobalPoolingLayer.java + MaskedReductionUtil)."""
    if x.dim() == 4:
        dims, mask = (1, 2), None
    elif x.dim() == 3:
        dims, mask = (1,), ctx.mask
    else:
        raise ValueError(f"global pooling expects 3d/4d input, got shape {tuple(x.shape)}")
    pt = conf.pooling_type
    if mask is not None:
        m = mask[..., None].to(x.dtype)
        x = x.masked_fill(m <= 0, float("-inf")) if pt == PoolingType.MAX else x * m
    if pt == PoolingType.MAX:
        return x.amax(dim=dims), None
    if pt == PoolingType.SUM:
        return x.sum(dim=dims), None
    if pt == PoolingType.AVG:
        if mask is not None:
            return x.sum(dim=dims) / mask.sum(dim=1).clamp_min(1.0)[..., None], None
        return x.mean(dim=dims), None
    if pt == PoolingType.PNORM:
        p = float(conf.pnorm)
        return (x.abs() ** p).sum(dim=dims) ** (1.0 / p), None
    raise ValueError(f"unknown pooling type {pt!r}")


register_layer(L.GlobalPoolingLayer, _no_params, global_pooling_forward)
