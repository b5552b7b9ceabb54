"""Batch normalization.

The port of the JAX package's nn/layers/norm.py (reference:
nn/layers/normalization/BatchNormalization.java and its cuDNN helper).
The builtin training path is `BNTrain`, an autograd Function with the
hand-written backward of the JAX package's `_bn_train` custom_vjp: every
full-size tensor stays in x's dtype and only per-channel statistics are
f32, with bf16 statistics centered on bf16(mean) so they do not cancel.
Inside a data-parallel step (parallel/mesh.data_parallel_scope) the
statistics are the global batch's: the per-channel sums are summed over
the data axis before each pass that needs them — the mean, then the sums
about it (the second pass centres on the GLOBAL mean, so two all-reduces,
not one) — and the backward's two sums likewise, as GSPMD's cross-device
batch reduction gives them in the JAX package.
Its backward consults the "bn_backward" helper (the fused K7 + K8 passes
of ops/fused_conv_bn.py); the forward consults "batch_norm", which takes
over when x is a conv output whose statistics the conv kernel already
summed.

LocalResponseNormalization (reference: LocalResponseNormalization.java)
is the JAX package's window sum over the channel axis of NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext, register_layer
from deeplearning4j_tpu_torch.ops.fused_conv_bn import bn_backward_pieces
from deeplearning4j_tpu_torch.ops.helpers import HelperError, get_helper
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    active_data_mesh,
    all_reduce_,
    data_shards,
)


def _global_sum(t, dp):
    """t summed over the data axis of `dp` (t itself for None)."""
    return t if dp is None else all_reduce_(t, dp, DATA_AXIS, site="bn_stats")


def _acc_dtype(dtype):
    """Statistics dtype: f32, or f64 when the network runs f64."""
    return torch.promote_types(dtype, torch.float32)


def _bn_stats_centered(x, dp=None):
    """bf16 statistics without catastrophic cancellation: the mean with
    f32 sums; xc = x - bf16(mean) (exact in bf16 near the mean, by
    Sterbenz); then E[xc^2] - E[xc]^2 in f32. Returns (mean, var, xc,
    delta), delta = mean - bf16(mean), so that x - mean == xc - delta.
    With `dp` (a mesh) the sums are the global batch's."""
    c = x.shape[-1]
    n = x.numel() // c
    n_all = n if dp is None else n * data_shards(dp)
    x2 = x.reshape(n, c)
    mean = _global_sum(x2.float().sum(0), dp) / n_all
    mean_b = mean.to(x.dtype)
    xc = x - mean_b
    xc2 = xc.reshape(n, c)
    sums = _global_sum(torch.stack([xc2.float().sum(0), (xc2 * xc2).float().sum(0)]), dp)
    mu_r = sums[0] / n_all
    var = torch.clamp_min(sums[1] / n_all - mu_r * mu_r, 0.0)
    return mean, var, xc, mean - mean_b.float()


def _bn_stats(x, dp=None):
    """Per-channel (mean, var) in the statistics dtype; with `dp` (a mesh)
    the global batch's, the mean then the squares about it, as below."""
    if x.dtype == torch.bfloat16:
        mean, var, _, _ = _bn_stats_centered(x, dp)
        return mean, var
    dims = tuple(range(x.dim() - 1))
    xf = x.to(_acc_dtype(x.dtype))
    if dp is None:
        mean = xf.mean(dims)
        return mean, (xf - mean).square().mean(dims)
    n_all = (x.numel() // x.shape[-1]) * data_shards(dp)
    mean = _global_sum(xf.sum(dims), dp) / n_all
    return mean, _global_sum((xf - mean).square().sum(dims), dp) / n_all


class BNTrain(torch.autograd.Function):
    """(y, mean, var) = BNTrain.apply(x, gamma, beta, eps): training-mode
    batch norm over every axis but the last. mean and var feed the running
    averages only and carry no gradient (as in the reference, where the
    global statistics are state, not parameters). Inside a data-parallel
    step the statistics and the backward's sums are the global batch's."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        acc = _acc_dtype(x.dtype)
        dp = ctx.dp = active_data_mesh()
        if x.dtype == torch.bfloat16:
            mean, var, xc, delta = _bn_stats_centered(x, dp)
            inv = torch.rsqrt(var + eps)
            scale = gamma.to(acc) * inv
            # y = scale * (x - mean) + beta = scale * (xc - delta) + beta
            shift = beta.to(acc) - delta * scale
            y = xc * scale.to(x.dtype) + shift.to(x.dtype)
        else:
            mean, var = _bn_stats(x, dp)
            inv = torch.rsqrt(var + eps)
            scale = gamma.to(acc) * inv
            shift = beta.to(acc) - mean * scale
            y = x * scale.to(x.dtype) + shift.to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        # the mesh only inside a data-parallel step
        dx, dgamma, dbeta = bn_backward_pieces(g.to(x.dtype), x, mean, inv, gamma, n,
                                               **({} if ctx.dp is None else {"dp": ctx.dp}))
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def batchnorm_init(gen, conf: L.BatchNormalization, dtype):
    n = int(conf.n_in)
    return {"gamma": torch.full((n,), conf.gamma, dtype=dtype),
            "beta": torch.full((n,), conf.beta, dtype=dtype)}


def batchnorm_state(conf: L.BatchNormalization, dtype):
    n = int(conf.n_in)
    return {"mean": torch.zeros((n,), dtype=dtype), "var": torch.ones((n,), dtype=dtype)}


def batchnorm_forward(conf: L.BatchNormalization, params, x, ctx: LayerContext):
    """Normalizes over all axes but the last (channels for NHWC). Training
    uses batch statistics and updates the running ones as the reference
    does (global = decay * global + (1 - decay) * batch); inference uses
    the running statistics."""
    eps = conf.eps
    state = ctx.state or {}
    acc = _acc_dtype(x.dtype)
    if ctx.training:
        if conf.lock_gamma_beta:
            # locked: the configured constants, not trainable
            c = params["gamma"].shape[0] if "gamma" in params else x.shape[-1]
            gamma = torch.full((c,), conf.gamma, dtype=acc, device=x.device)
            beta = torch.full((c,), conf.beta, dtype=acc, device=x.device)
        else:
            gamma, beta = params["gamma"], params["beta"]
        # vendor-kernel plugin point (the CudnnBatchNormalizationHelper
        # analog): when x is a conv output whose statistics the conv kernel
        # stashed, the fused apply consumes them — one read of x, not two.
        # With ctx.fuse_relu the output is rectified, by the kernel or here.
        y = None
        helper = get_helper("batch_norm", x=x, training=True)
        if helper is not None:
            try:
                y, mean, var = helper(x, gamma, beta, eps, relu=ctx.fuse_relu)
            except HelperError:
                y = None
        if y is None:
            y, mean, var = BNTrain.apply(x, gamma, beta, eps)
            if ctx.fuse_relu:
                y = torch.relu(y)
        d = conf.decay
        st_mean, st_var = state.get("mean"), state.get("var")
        new_state = {
            "mean": ((d * st_mean.to(acc) + (1 - d) * mean).to(st_mean.dtype)
                     if st_mean is not None else mean),
            "var": ((d * st_var.to(acc) + (1 - d) * var).to(st_var.dtype)
                    if st_var is not None else var),
        }
        return y, new_state
    mean, var = state.get("mean"), state.get("var")
    if mean is None:
        mean, var = _bn_stats(x)
    inv = torch.rsqrt(var.to(acc) + eps)
    xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    if conf.lock_gamma_beta:
        return conf.gamma * xhat + conf.beta, None
    return params["gamma"].to(x.dtype) * xhat + params["beta"].to(x.dtype), None


def batchnorm_order(conf):
    return ("gamma", "beta")


register_layer(L.BatchNormalization, batchnorm_init, batchnorm_forward,
               order_fn=batchnorm_order, state_fn=batchnorm_state)


# -- local response normalization -------------------------------------------

def _no_params(gen, conf, dtype):
    return {}


def lrn_forward(conf: L.LocalResponseNormalization, params, x, ctx: LayerContext):
    """Cross-channel LRN on NHWC: y = x / (k + alpha * sum_window(x^2))^beta
    over a window of n channels, (n // 2, n - 1 - n // 2) on either side,
    so an even n leans low; alpha is not divided by n (the JAX package's
    reduce_window, as written)."""
    n = int(conf.n)
    half = n // 2
    sq = F.pad(x * x, (half, n - 1 - half))
    ssum = sq.unfold(-1, n, 1).sum(-1)
    return x / (conf.k + conf.alpha * ssum) ** conf.beta, None


register_layer(L.LocalResponseNormalization, _no_params, lrn_forward)
