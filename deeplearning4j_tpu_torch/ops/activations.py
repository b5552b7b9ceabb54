"""Activation functions.

Covers the full activation enum the reference's config DSL accepts
(org.nd4j.linalg.activations.Activation), plus an SPI for custom
activations (the reference's IActivation). Same functions and names as
the JAX package's ops/activations.py, as torch element-wise ops. RReLU's
random alpha at train time needs a generator, so every activation takes
an optional `key` (a `torch.Generator`).

At a kink or a tie each function takes the JAX package's subgradient, so
that autograd and jax.grad agree there too: `clip` and `maximum` split a
tie evenly between their arguments (`tie_clip`, `tie_max`; torch.maximum
and torch.minimum do the same, torch.clamp does not), `abs` takes +1 at 0
(`sign_abs`), and leaky ReLU takes slope 1 at 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

# name -> fn(x, key=None, training=False) -> tensor
_REGISTRY: Dict[str, Callable] = {}


def register_activation(name: str, fn: Callable) -> None:
    """Custom-activation SPI (reference: IActivation implementations)."""
    _REGISTRY[name.lower()] = fn


def tie_max(x, lo: float):
    """max(x, lo) with jnp.maximum's gradient: half of it at x == lo."""
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def tie_clip(x, lo: float, hi: float):
    """clip(x, lo, hi) with jnp.clip's gradient: half of it at either
    edge, none outside."""
    return torch.minimum(tie_max(x, lo),
                         torch.full((), hi, dtype=x.dtype, device=x.device))


def sign_abs(x):
    """|x| with jnp.abs's gradient: +1 at 0."""
    return torch.where(x >= 0, x, -x)


def _simple(name):
    def deco(fn):
        register_activation(name, lambda x, key=None, training=False: fn(x))
        return fn

    return deco


@_simple("identity")
def identity(x):
    return x


@_simple("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@_simple("tanh")
def tanh(x):
    return torch.tanh(x)


@_simple("relu")
def relu(x):
    return torch.relu(x)


@_simple("relu6")
def relu6(x):
    return F.relu6(x)


@_simple("leakyrelu")
def leakyrelu(x):
    # Reference default alpha 0.01 (ActivationLReLU.DEFAULT_ALPHA); slope
    # 1 at x == 0, as jax.nn.leaky_relu's where(x >= 0, ...)
    return torch.where(x == 0, x, F.leaky_relu(x, negative_slope=0.01))


@_simple("elu")
def elu(x):
    return F.elu(x)


@_simple("selu")
def selu(x):
    return F.selu(x)


@_simple("softplus")
def softplus(x):
    return F.softplus(x)


@_simple("softsign")
def softsign(x):
    return F.softsign(x)


@_simple("hardtanh")
def hardtanh(x):
    return tie_clip(x, -1.0, 1.0)


@_simple("hardsigmoid")
def hardsigmoid(x):
    # Reference ActivationHardSigmoid: clip(0.2*x + 0.5, 0, 1)
    return tie_clip(0.2 * x + 0.5, 0.0, 1.0)


@_simple("cube")
def cube(x):
    return x * x * x


@_simple("rationaltanh")
def rationaltanh(x):
    # Reference ActivationRationalTanh: 1.7159 * tanh_approx(2x/3) where
    # tanh_approx(y) = sign(y) * (1 - 1/(1+|y|+y^2+1.41645*y^4))
    y = 2.0 * x / 3.0
    a = torch.abs(y)
    approx = torch.sign(y) * (1.0 - 1.0 / (1.0 + a + y * y + 1.41645 * (y**4)))
    return 1.7159 * approx


@_simple("rectifiedtanh")
def rectifiedtanh(x):
    return tie_max(torch.tanh(x), 0.0)


@_simple("swish")
def swish(x):
    return F.silu(x)


@_simple("gelu")
def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


@_simple("mish")
def mish(x):
    return x * torch.tanh(F.softplus(x))


@_simple("thresholdedrelu")
def thresholdedrelu(x):
    return torch.where(x > 1.0, x, torch.zeros_like(x))


@_simple("softmax")
def softmax(x):
    # Row softmax over the feature axis (last axis), matching the reference's
    # 2d [batch, nOut] / time-distributed conventions.
    return torch.softmax(x, dim=-1)


@_simple("logsoftmax")
def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


def _rrelu(x, key=None, training=False, lower=1.0 / 8.0, upper=1.0 / 3.0):
    """Randomized leaky ReLU (reference ActivationRReLU: U[l,u] alpha when
    training, (l+u)/2 at inference)."""
    if training and key is not None:
        from deeplearning4j_tpu_torch.parallel.mesh import draw_rows

        u = draw_rows(lambda s: torch.rand(s, generator=key, device=x.device, dtype=x.dtype),
                      x.shape)
        alpha = lower + (upper - lower) * u
    else:
        alpha = (lower + upper) / 2.0
    return torch.where(x >= 0, x, alpha * x)


register_activation("rrelu", _rrelu)


class Activation:
    """Enum-style names (string constants) mirroring the reference enum."""

    CUBE = "cube"
    ELU = "elu"
    HARDSIGMOID = "hardsigmoid"
    HARDTANH = "hardtanh"
    IDENTITY = "identity"
    LEAKYRELU = "leakyrelu"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    RELU = "relu"
    RRELU = "rrelu"
    SELU = "selu"
    SIGMOID = "sigmoid"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    SWISH = "swish"
    GELU = "gelu"
    TANH = "tanh"


def activation_fn(name: str) -> Callable:
    """Look up an activation by name. Returned callable has signature
    fn(x, key=None, training=False)."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def apply_activation(name: str, x, key: Optional[torch.Generator] = None,
                     training: bool = False):
    return activation_fn(name)(x, key=key, training=training)
