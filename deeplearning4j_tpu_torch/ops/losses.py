"""Loss functions.

The port of the JAX package's ops/losses.py: the reference's
LossFunctions.LossFunction enum and ILossFunction SPI. A loss sees the
output layer's *pre-output* (logits) plus its activation, so
softmax + cross-entropy runs as the numerically stable log-softmax.

Every function returns a per-example score vector [batch]; the network
averages over present examples (`masked_example_mean`). Masks multiply
per-element scores before the feature-axis reduction. Gradients are never
hand-written: autograd differentiates through these, as jax.grad does in
the JAX package, and every clip, maximum and abs takes jnp's subgradient
at its kink (ops/activations.py `tie_clip`, `tie_max`, `sign_abs`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from deeplearning4j_tpu_torch.parallel.mesh import active_data_mesh, data_sum
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.activations import (
    apply_activation,
    sign_abs,
    tie_clip,
    tie_max,
)

_EPS = 1e-8

# name -> fn(labels, preout, activation, mask) -> per-example score [batch]
_REGISTRY: Dict[str, Callable] = {}


def register_loss(name: str, fn: Callable) -> None:
    """Custom-loss SPI (reference: ILossFunction implementations)."""
    _REGISTRY[name.lower()] = fn


def _expand(mask, ndim):
    while mask.dim() < ndim:
        mask = mask[..., None]
    return mask


def _reduce(per_elem, mask):
    """Apply an element mask then sum over all non-batch axes."""
    if mask is not None:
        # mask may be [batch], [batch, 1] or full element shape; broadcast
        per_elem = per_elem * _expand(mask.to(per_elem.dtype), per_elem.dim())
    axes = tuple(range(1, per_elem.dim()))
    return per_elem.sum(dim=axes) if axes else per_elem


def _out(preout, activation):
    return apply_activation(activation, preout)


def _loss(name):
    def deco(fn):
        register_loss(name, fn)
        return fn

    return deco


@_loss("mse")
def mse(labels, preout, activation, mask=None):
    d = _out(preout, activation) - labels
    return _reduce(d * d, mask) / labels.shape[-1]


@_loss("l2")
def l2(labels, preout, activation, mask=None):
    # reference LossL2 = sum of squared errors (no 1/n)
    d = _out(preout, activation) - labels
    return _reduce(d * d, mask)


@_loss("l1")
def l1(labels, preout, activation, mask=None):
    return _reduce(sign_abs(_out(preout, activation) - labels), mask)


@_loss("mean_absolute_error")
def mean_absolute_error(labels, preout, activation, mask=None):
    return l1(labels, preout, activation, mask) / labels.shape[-1]


@_loss("mean_absolute_percentage_error")
def mape(labels, preout, activation, mask=None):
    out = _out(preout, activation)
    per = sign_abs((labels - out) / (labels + _EPS)) * 100.0
    return _reduce(per, mask) / labels.shape[-1]


@_loss("mean_squared_logarithmic_error")
def msle(labels, preout, activation, mask=None):
    d = torch.log1p(_out(preout, activation)) - torch.log1p(labels)
    return _reduce(d * d, mask) / labels.shape[-1]


@_loss("xent")
def xent(labels, preout, activation, mask=None):
    """Binary cross-entropy; from the logits directly when the activation
    is sigmoid."""
    if activation == "sigmoid":
        # log(sigmoid(z)) = -softplus(-z); log(1-sigmoid(z)) = -softplus(z)
        per = labels * F.softplus(-preout) + (1.0 - labels) * F.softplus(preout)
    else:
        out = tie_clip(_out(preout, activation), _EPS, 1.0 - _EPS)
        per = -(labels * torch.log(out) + (1.0 - labels) * torch.log(1.0 - out))
    return _reduce(per, mask)


@_loss("mcxent")
def mcxent(labels, preout, activation, mask=None):
    """Multi-class cross-entropy; the fused log-softmax path when the
    output activation is softmax (the common OutputLayer configuration)."""
    if activation == "softmax":
        logp = torch.log_softmax(preout, dim=-1)
    else:
        logp = torch.log(tie_max(_out(preout, activation), _EPS))
    return _reduce(-labels * logp, mask)


class _TiedXent(torch.autograd.Function):
    """Per-token cross-entropy of logits (x * scale) W^T against ids, in
    chunks of `chunk` tokens: no [tokens, vocab] tensor outlives its chunk;
    the backward computes each chunk's logits again."""

    @staticmethod
    def forward(ctx, x, W, ids, scale, chunk):
        Wc = W.to(x.dtype)
        out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        for i in range(0, x.shape[0], chunk):
            z = (x[i:i + chunk] * scale) @ Wc.T
            out[i:i + chunk] = F.cross_entropy(z.float(), ids[i:i + chunk], reduction="none")
        ctx.save_for_backward(x, W, ids)
        ctx.scale, ctx.chunk = scale, chunk
        return out

    @staticmethod
    def backward(ctx, g):
        x, W, ids = ctx.saved_tensors
        scale, chunk = ctx.scale, ctx.chunk
        Wc = W.to(x.dtype)
        dx = torch.empty_like(x)
        dW = torch.zeros(W.shape, dtype=torch.float32, device=W.device)
        for i in range(0, x.shape[0], chunk):
            xs = x[i:i + chunk] * scale
            p = torch.softmax((xs @ Wc.T).float(), dim=-1)
            rows = torch.arange(p.shape[0], device=p.device)
            p[rows, ids[i:i + chunk]] -= 1.0
            p = (p * g[i:i + chunk, None]).to(x.dtype)
            dx[i:i + chunk] = (p @ Wc) * scale
            dW += (p.T @ xs).float()
        return dx, dW.to(W.dtype), None, None, None


def tied_sparse_mcxent(x, W, labels, scale: float, mask=None, chunk: int = 4096):
    """Multi-class cross-entropy against integer class ids (the loss
    "sparse_mcxent" of a TiedOutputLayer) of the softmax logits
    (x * scale) W^T, for features x [batch, time, n], the table W
    [classes, n] and labels [batch, time] (any integer or integral float
    dtype): per example the mean over its time steps (masked steps count
    0), so that the network's mean over examples is the mean over every
    token. The logits are formed and log-softmaxed in f32 a chunk of
    tokens at a time: neither a [batch * time, classes] logit tensor nor a
    one-hot label tensor is ever held whole (the backward forms each
    chunk again)."""
    ids = labels.long().reshape(-1)
    per = _TiedXent.apply(x.reshape(-1, x.shape[-1]), W, ids, float(scale), int(chunk))
    per = per.view(labels.shape)
    if mask is not None:
        per = per * mask.to(per.dtype).reshape(per.shape)
    return per.mean(dim=tuple(range(1, per.dim()))) if per.dim() > 1 else per


@_loss("negativeloglikelihood")
def negativeloglikelihood(labels, preout, activation, mask=None):
    # reference LossNegativeLogLikelihood extends LossMCXENT
    return mcxent(labels, preout, activation, mask)


@_loss("kl_divergence")
def kl_divergence(labels, preout, activation, mask=None):
    out = tie_clip(_out(preout, activation), _EPS, 1.0 - _EPS)
    lab = tie_clip(labels, _EPS, 1.0 - _EPS)
    return _reduce(lab * (torch.log(lab) - torch.log(out)), mask)


@_loss("reconstruction_crossentropy")
def reconstruction_crossentropy(labels, preout, activation, mask=None):
    return xent(labels, preout, activation, mask)


@_loss("cosine_proximity")
def cosine_proximity(labels, preout, activation, mask=None):
    out = _out(preout, activation)
    if mask is not None:
        m = _expand(mask.to(out.dtype), out.dim())
        out = out * m
        labels = labels * m
    dot = (labels * out).sum(dim=-1)
    norm = (torch.linalg.vector_norm(labels, dim=-1)
            * torch.linalg.vector_norm(out, dim=-1))
    cos = dot / tie_max(norm, _EPS)
    while cos.dim() > 1:  # reduce any remaining time axes
        cos = cos.sum(dim=-1)
    return -cos


@_loss("hinge")
def hinge(labels, preout, activation, mask=None):
    # labels in {-1, 1}
    out = _out(preout, activation)
    return _reduce(tie_max(1.0 - labels * out, 0.0), mask)


@_loss("squared_hinge")
def squared_hinge(labels, preout, activation, mask=None):
    h = tie_max(1.0 - labels * _out(preout, activation), 0.0)
    return _reduce(h * h, mask)


@_loss("poisson")
def poisson(labels, preout, activation, mask=None):
    out = _out(preout, activation)
    return _reduce(out - labels * torch.log(tie_max(out, _EPS)), mask)


@_loss("squared_loss")
def squared_loss(labels, preout, activation, mask=None):
    return l2(labels, preout, activation, mask)


@_loss("rmse_xent")
def rmse_xent(labels, preout, activation, mask=None):
    # reference legacy LossFunction: sqrt of the per-example SSE
    d = _out(preout, activation) - labels
    return torch.sqrt(_reduce(d * d, mask) + _EPS)


class LossFunction:
    """Enum-style names mirroring LossFunctions.LossFunction."""

    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    XENT = "xent"
    MCXENT = "mcxent"
    SQUARED_LOSS = "squared_loss"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    COSINE_PROXIMITY = "cosine_proximity"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mean_absolute_percentage_error"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "mean_squared_logarithmic_error"
    POISSON = "poisson"
    RMSE_XENT = "rmse_xent"


def example_presence(per_ex, mask: Optional[torch.Tensor]):
    """[batch] 0/1 presence from a labels mask: an example whose mask is
    all zero (a pad row) is absent. None mask -> all present."""
    if mask is None:
        return torch.ones(per_ex.shape[0], dtype=per_ex.dtype, device=per_ex.device)
    m = mask
    while m.dim() > 1:
        m = m.amax(dim=-1)
    return (m > 0).to(per_ex.dtype)


def global_present_count(present):
    """The present-example count a loss divides by: this batch's, or,
    inside a data-parallel step (parallel/mesh.data_parallel_scope), the
    global batch's, summed over the data axis, so that each rank's loss is
    its share of the one global-batch mean."""
    return data_sum(present.sum(), "loss_count")


def masked_example_mean(per_ex, mask: Optional[torch.Tensor]):
    """Mean of per-example losses over PRESENT examples only: the plain
    mean when no example is fully masked. Dividing by the present count
    (not the batch, as the reference does) keeps the per-real-example
    gradient scale constant across padded batches, as in the JAX
    package. Inside a data-parallel step the count is the global batch's
    (`global_present_count`)."""
    if mask is None and active_data_mesh() is None:
        return per_ex.mean()
    present = example_presence(per_ex, mask)
    return (per_ex * present).sum() / global_present_count(present).clamp_min(1.0)


def loss_value(name: str, labels, preout, activation: str,
               mask: Optional[torch.Tensor] = None):
    """Per-example loss [batch] for the named loss function."""
    try:
        fn = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: {sorted(_REGISTRY)}") from None
    return fn(labels, preout, activation, mask)
