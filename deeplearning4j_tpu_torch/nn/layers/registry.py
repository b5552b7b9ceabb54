"""Layer implementation registry.

Maps a config dataclass type to its functional implementation:

- init_params(gen, conf, dtype) -> dict[name, tensor]   (trainable)
- init_state(conf, dtype)       -> dict[name, tensor] | None  (non-trainable,
  e.g. batchnorm running stats)
- forward(conf, params, x, ctx) -> (y, new_state)

ctx is a LayerContext carrying training flag, rng, masks and minibatch
metadata — the information the reference threads through Layer.activate
arguments and network fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Type

import torch

_INIT: Dict[Type, Callable] = {}
_STATE: Dict[Type, Callable] = {}
_FORWARD: Dict[Type, Callable] = {}
_ORDER: Dict[Type, Callable] = {}


@dataclasses.dataclass
class LayerContext:
    """Per-call context for a layer forward."""

    training: bool = False
    rng: Optional[torch.Generator] = None
    mask: Optional[torch.Tensor] = None  # [batch, time] for RNN inputs
    timesteps: Optional[int] = None  # batch time length (for ff<->rnn reshape)
    state: Optional[dict] = None  # layer's mutable state going in
    # a BatchNormalization whose only consumer is a relu ActivationLayer
    # (ComputationGraph decides it, in training): the BN returns its output
    # rectified, and the graph passes it through the relu vertex
    fuse_relu: bool = False
    # a tensor-parallel Dense layer's (role, mesh, axis): role "column" or
    # "row" (parallel/tensor.py); None when the layer is not split
    tp: Optional[tuple] = None
    # the network's compute dtype, for a layer whose input carries none
    # (integer token ids); None where the caller sets no policy
    dtype: Optional[torch.dtype] = None


def register_layer(conf_cls, init_fn, forward_fn, order_fn=None, state_fn=None):
    _INIT[conf_cls] = init_fn
    _FORWARD[conf_cls] = forward_fn
    if order_fn is not None:
        _ORDER[conf_cls] = order_fn
    if state_fn is not None:
        _STATE[conf_cls] = state_fn


def _lookup(table, conf):
    for cls in type(conf).__mro__:
        if cls in table:
            return table[cls]
    return None


def init_layer_params(gen, conf, dtype) -> Dict[str, Any]:
    fn = _lookup(_INIT, conf)
    if fn is None:
        raise NotImplementedError(f"no init for layer conf {type(conf).__name__}")
    return fn(gen, conf, dtype)


def init_layer_state(conf, dtype) -> Optional[dict]:
    fn = _lookup(_STATE, conf)
    return None if fn is None else fn(conf, dtype)


def forward_layer(conf, params, x, ctx: LayerContext) -> Tuple[Any, Optional[dict]]:
    fn = _lookup(_FORWARD, conf)
    if fn is None:
        raise NotImplementedError(f"no forward for layer conf {type(conf).__name__}")
    return fn(conf, params, x, ctx)


def param_order(conf) -> Tuple[str, ...]:
    """Stable parameter-name order used for the flattened view
    (reference: each nn/params/*ParamInitializer defines the layout of its
    slice of flattenedParams). Same order as the JAX package."""
    fn = _lookup(_ORDER, conf)
    if fn is not None:
        return fn(conf)
    return ("W", "b")
