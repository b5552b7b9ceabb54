"""Numeric gradient checking, the port of the JAX package's
train/gradientcheck.py.

Analog of the reference's GradientCheckUtil
(gradientcheck/GradientCheckUtil.java, 515 LoC): central-difference
numerical gradients against the analytic ones, per parameter, in f64.
The reference enforces global double precision and a whitelist of smooth
activations (:48-91). Here f64 is the network's own dtype for the check:
`check_gradients` runs the loss under an f64 precision policy on f64
copies of the parameters, on the network's device, and autograd gives
the analytic side. On the card the helper kernels take no f64 input, so
the check runs the layers' plain versions there too: it validates layer
forwards and loss wiring, not the kernels (those are held to their plain
versions by chip_smoke.py).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Optional

import numpy as np
import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")

_F64 = torch.float64


def numeric_gradient(f: Callable, flat, epsilon: float = 1e-6,
                     indices=None) -> np.ndarray:
    """Central differences: (f(x + eps e_i) - f(x - eps e_i)) / (2 eps),
    for each index (all by default). `f` maps a flat f64 tensor to a
    scalar."""
    flat = torch.as_tensor(flat, dtype=_F64).detach()
    idx = range(flat.numel()) if indices is None else indices
    out = np.zeros(flat.numel(), dtype=np.float64)
    with torch.no_grad():
        for i in idx:
            plus = flat.clone()
            plus[i] += epsilon
            minus = flat.clone()
            minus[i] -= epsilon
            out[i] = (float(f(plus)) - float(f(minus))) / (2.0 * epsilon)
    return out


def check_gradients_fn(
    loss_of_flat: Callable,
    flat_params,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-5,
    min_abs_error: float = 1e-8,
    max_checks: Optional[int] = None,
    seed: int = 0,
    verbose: bool = False,
) -> bool:
    """Check d(loss)/d(flat) analytic vs numeric. `loss_of_flat` maps a
    flat f64 tensor to a scalar tensor. The reference's pass criterion:
    relative error |a-n| / (|a|+|n|) <= max_rel_error, with an
    absolute-error floor for near-zero gradients
    (GradientCheckUtil.java:161-180)."""
    flat64 = torch.as_tensor(flat_params, dtype=_F64).detach()
    x = flat64.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_of_flat(x), x)
    analytic = g.detach().cpu().numpy()

    n = flat64.numel()
    if max_checks is not None and max_checks < n:
        rng = np.random.default_rng(seed)
        indices = rng.choice(n, size=max_checks, replace=False)
    else:
        indices = range(n)
    numeric = numeric_gradient(loss_of_flat, flat64, epsilon, indices)

    fails = 0
    for i in indices:
        a, m = analytic[i], numeric[i]
        denom = abs(a) + abs(m)
        rel = abs(a - m) / denom if denom > 0 else 0.0
        if rel > max_rel_error and abs(a - m) > min_abs_error:
            fails += 1
            if verbose:
                logger.info("param %d: analytic=%.8g numeric=%.8g rel=%.3g",
                            i, a, m, rel)
    if verbose:
        logger.info("gradient check: %d/%d ok",
                    len(list(indices)) - fails, len(list(indices)))
    return fails == 0


@contextlib.contextmanager
def f64_loss(net, xs, ys, features_masks=None, labels_masks=None):
    """(loss_of_flat, flat0) of a network's full training loss (data term
    plus l1/l2, no random draws) in f64 on the net's device: the
    parameters, layer state and batch as f64 copies, the net's precision
    policy set to f64 for the duration. `xs`/`ys`/masks are arrays for a
    MultiLayerNetwork and lists for a ComputationGraph."""
    from deeplearning4j_tpu_torch.common.dtypes import PrecisionPolicy
    from deeplearning4j_tpu_torch.nn.params import flat_to_params, params_to_flat

    net._require_init()
    dev = net.device

    def t64(a):
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return [t64(v) for v in a]
        if torch.is_tensor(a):
            return a.detach().to(dev, _F64)
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    confs = net._ordered_layer_confs()
    params64 = [{k: t64(v) for k, v in p.items()} for p in net.params_list]
    states64 = [None if s is None else {k: t64(v) for k, v in s.items()}
                for s in net.state_list]
    data = [t64(a) for a in (xs, ys, features_masks, labels_masks)]

    def loss_of_flat(flat):
        plist = flat_to_params(confs, params64, flat)
        s, _ = net._loss(plist, states64, *data, None, training=True)
        return s

    saved = net.policy
    net.policy = PrecisionPolicy(_F64, _F64, _F64)
    try:
        yield loss_of_flat, params_to_flat(confs, params64)
    finally:
        net.policy = saved


def check_gradients(net, x, y, features_mask=None, labels_mask=None,
                    epsilon: float = 1e-6, max_rel_error: float = 1e-5,
                    min_abs_error: float = 1e-8, max_checks: Optional[int] = None,
                    verbose: bool = False) -> bool:
    """Gradient-check a MultiLayerNetwork's full loss (data term + l1/l2)
    against its flattened parameter vector, in f64 (reference:
    GradientCheckUtil.checkGradients(MultiLayerNetwork, ...))."""
    with f64_loss(net, x, y, features_mask, labels_mask) as (fn, flat0):
        return check_gradients_fn(fn, flat0, epsilon=epsilon,
                                  max_rel_error=max_rel_error,
                                  min_abs_error=min_abs_error,
                                  max_checks=max_checks, verbose=verbose)


def check_gradients_graph(net, xs, ys, features_masks=None, labels_masks=None,
                          epsilon: float = 1e-6, max_rel_error: float = 1e-5,
                          min_abs_error: float = 1e-8,
                          max_checks: Optional[int] = None,
                          verbose: bool = False) -> bool:
    """Gradient-check a ComputationGraph (reference:
    GradientCheckUtil.checkGradients(ComputationGraph, ...)). xs/ys are
    lists aligned with the graph's inputs/outputs."""
    with f64_loss(net, list(xs), list(ys), features_masks,
                  labels_masks) as (fn, flat0):
        return check_gradients_fn(fn, flat0, epsilon=epsilon,
                                  max_rel_error=max_rel_error,
                                  min_abs_error=min_abs_error,
                                  max_checks=max_checks, verbose=verbose)
