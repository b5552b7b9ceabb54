"""Updaters (optimizers) with the reference's semantics.

The port of the JAX package's train/updaters.py (reference: nd4j
GradientUpdater implementations driven through
BaseMultiLayerUpdater.update, gradient normalization in preApply
:284-325, and nn/conf/Updater.java). An updater is a pair of functions
applied per leaf over the list of per-layer parameter dicts:

    init(param)                   -> state dict for that leaf
    apply(g, state, lr, t, hyper) -> (update, new state)

`updates` are deltas to ADD to the parameters (minimize: -lr * ...).
`UpdaterDef.step_` is the eager form the training step uses: it adds each
update to its parameter and writes the new state into the old state's
tensors, in place, under torch.no_grad().

Because the update is in place, anything that keeps the state of one
step while later steps run must copy it: a checkpoint snapshot clones
every leaf (utils/model_serializer.py `ModelSnapshot.capture`), where
the JAX package may hold references to its immutable arrays. A later
multi-tensor updater keeps that rule.

Learning-rate schedules are computed on the host per step (`schedule_lr`)
and reach the step as 0-d f32 tensors on the network's device, `lr` and
the iteration counter `t`, read from a vector the host fills before each
dispatch (nn/netbase.py `_clock`): a captured CUDA graph reads them from
that buffer instead of baking them in. Parameters and updater state are
f32 under every precision policy (common/dtypes.py), so an f32 `lr`
tensor rounds nothing that the Python float it replaces did not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class UpdaterDef:
    """A concrete updater: init + leafwise apply."""

    name: str
    init: Callable[[torch.Tensor], Dict[str, torch.Tensor]]
    apply: Callable[..., Any]  # (g, state, lr, t, hyper) -> (update, new_state)
    hyper: Dict[str, float]

    def init_tree(self, params_list: List[Dict[str, torch.Tensor]]):
        return [{k: self.init(v) for k, v in p.items()} for p in params_list]

    def apply_tree(self, grads, state, lr_tree, t):
        """(updates, new_state) over the list of dicts; `lr_tree` is a
        scalar (a number or a 0-d tensor) or a list of dicts of per-leaf
        learning rates."""
        scalar = isinstance(lr_tree, (int, float)) or torch.is_tensor(lr_tree)
        updates, new_state = [], []
        for i, (g, s) in enumerate(zip(grads, state)):
            u_i, s_i = {}, {}
            for k in g:
                lr = lr_tree if scalar else lr_tree[i][k]
                u_i[k], s_i[k] = self.apply(g[k], s[k], lr, t, self.hyper)
            updates.append(u_i)
            new_state.append(s_i)
        return updates, new_state

    def step_(self, params, grads, state, lr_tree, t):
        """Apply one update in place: params += update, state <- new
        state. Returns the updates."""
        with torch.no_grad():
            updates, new_state = self.apply_tree(grads, state, lr_tree, t)
            for p, u, s, ns in zip(params, updates, state, new_state):
                for k in u:
                    p[k].add_(u[k])
                    for name, v in ns[k].items():
                        s[k][name].copy_(v)
        return updates


# -- implementations ---------------------------------------------------------

def _no_state(p):
    return {}


def _zeros(*names):
    return lambda p: {n: torch.zeros_like(p) for n in names}


def _sgd(hyper):
    def apply(g, s, lr, t, hp):
        return -lr * g, s

    return UpdaterDef("sgd", _no_state, apply, hyper)


def _nesterovs(hyper):
    """Nesterov momentum, reference formulation (nd4j Nesterovs.java):
    vNew = mu*v - lr*g;  update = -mu*v + (1+mu)*vNew."""

    def apply(g, s, lr, t, hp):
        mu = hp["momentum"]
        v = s["v"]
        v_new = mu * v - lr * g
        return -mu * v + (1.0 + mu) * v_new, {"v": v_new}

    return UpdaterDef("nesterovs", _zeros("v"), apply, hyper)


def _adam(hyper):
    def apply(g, s, lr, t, hp):
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["epsilon"]
        m = b1 * s["m"] + (1 - b1) * g
        v = b2 * s["v"] + (1 - b2) * (g * g)
        tt = t + 1.0  # bias correction with t counted from 1
        mhat = m / (1 - b1 ** tt)
        vhat = v / (1 - b2 ** tt)
        return -lr * mhat / (torch.sqrt(vhat) + eps), {"m": m, "v": v}

    return UpdaterDef("adam", _zeros("m", "v"), apply, hyper)


def _adamax(hyper):
    def apply(g, s, lr, t, hp):
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["epsilon"]
        m = b1 * s["m"] + (1 - b1) * g
        u = torch.maximum(b2 * s["u"], g.abs())
        tt = t + 1.0
        return -lr * m / ((1 - b1 ** tt) * (u + eps)), {"m": m, "u": u}

    return UpdaterDef("adamax", _zeros("m", "u"), apply, hyper)


def _adadelta(hyper):
    """Reference AdaDelta (nd4j AdaDelta.java): no learning rate; rho and
    epsilon. The passed lr is ignored, as in the reference."""

    def apply(g, s, lr, t, hp):
        rho, eps = hp["rho"], hp["epsilon"]
        msg = rho * s["msg"] + (1 - rho) * g * g
        dx = -g * torch.sqrt(s["msdx"] + eps) / torch.sqrt(msg + eps)
        msdx = rho * s["msdx"] + (1 - rho) * dx * dx
        return dx, {"msg": msg, "msdx": msdx}

    return UpdaterDef("adadelta", _zeros("msg", "msdx"), apply, hyper)


def _adagrad(hyper):
    def apply(g, s, lr, t, hp):
        h = s["h"] + g * g
        return -lr * g / (torch.sqrt(h) + hp["epsilon"]), {"h": h}

    return UpdaterDef("adagrad", _zeros("h"), apply, hyper)


def _rmsprop(hyper):
    def apply(g, s, lr, t, hp):
        decay, eps = hp["rms_decay"], hp["epsilon"]
        r = decay * s["r"] + (1 - decay) * g * g
        return -lr * g / (torch.sqrt(r) + eps), {"r": r}

    return UpdaterDef("rmsprop", _zeros("r"), apply, hyper)


def _none(hyper):
    def apply(g, s, lr, t, hp):
        return torch.zeros_like(g), s

    return UpdaterDef("none", _no_state, apply, hyper)


_FACTORIES = {
    "sgd": _sgd,
    "nesterovs": _nesterovs,
    "adam": _adam,
    "adamax": _adamax,
    "adadelta": _adadelta,
    "adagrad": _adagrad,
    "rmsprop": _rmsprop,
    "none": _none,
}


def make_updater(
    name: str,
    learning_rate: float = 0.1,
    momentum: float = 0.9,
    rho: float = 0.95,
    rms_decay: float = 0.95,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
) -> UpdaterDef:
    hyper = dict(momentum=momentum, rho=rho, rms_decay=rms_decay,
                 beta1=beta1, beta2=beta2, epsilon=epsilon,
                 learning_rate=learning_rate)
    factory = _FACTORIES.get(name.lower())
    if factory is None:
        raise ValueError(f"unknown updater {name!r}")
    return factory(hyper)


def updater_from_conf(conf) -> UpdaterDef:
    """Build from a NeuralNetConfiguration (the reference's builder
    hyperparameter names)."""
    return make_updater(
        conf.updater,
        learning_rate=conf.learning_rate,
        momentum=conf.momentum,
        rho=conf.rho,
        rms_decay=conf.rms_decay,
        beta1=conf.adam_mean_decay,
        beta2=conf.adam_var_decay,
        epsilon=conf.epsilon,
    )


# -- learning-rate schedules -------------------------------------------------

def schedule_lr(conf, iteration: int) -> float:
    """Host-side LR schedule (reference: LearningRatePolicy). Returns the
    lr for this iteration."""
    base = conf.learning_rate
    pol = conf.lr_policy
    if pol in (None, "none"):
        return base
    if pol == "schedule":
        sched = conf.lr_schedule or {}
        best = base
        for k in sorted(int(i) for i in sched):
            if iteration >= k:
                best = sched[str(k)]
        return best
    if pol == "exponential":
        return base * (conf.lr_policy_decay_rate ** iteration)
    if pol == "inverse":
        return base / (1.0 + conf.lr_policy_decay_rate * iteration) ** conf.lr_policy_power
    if pol == "poly":
        return base * (1.0 - iteration / max(conf.lr_policy_steps, 1.0)) ** conf.lr_policy_power
    if pol == "sigmoid":
        return base / (1.0 + math.exp(-conf.lr_policy_decay_rate * (iteration - conf.lr_policy_steps)))
    if pol == "step":
        return base * (conf.lr_policy_decay_rate ** (iteration // max(conf.lr_policy_steps, 1.0)))
    raise ValueError(f"unknown lr policy {pol!r}")


# -- gradient normalization --------------------------------------------------

def normalize_gradients(layer_grads, mode: str, threshold: float):
    """Gradient normalization/clipping per layer before the updater
    (reference: BaseMultiLayerUpdater.preApply :284-325). layer_grads is
    a list of per-layer dicts."""
    if mode in (None, "none"):
        return layer_grads

    def _l2(g):  # leaves in sorted-key order, as jax.tree_util walks a dict
        return torch.sqrt(sum((g[k] * g[k]).sum() for k in sorted(g)) + 1e-12)

    def _norm(v):
        return torch.sqrt((v * v).sum() + 1e-12)

    out = []
    for g in layer_grads:
        if not g:
            out.append(g)
            continue
        if mode == "renormalize_l2_per_layer":
            n = _l2(g)
            out.append({k: v / n for k, v in g.items()})
        elif mode == "renormalize_l2_per_param_type":
            out.append({k: v / _norm(v) for k, v in g.items()})
        elif mode == "clip_elementwise_absolute_value":
            out.append({k: v.clamp(-threshold, threshold) for k, v in g.items()})
        elif mode == "clip_l2_per_layer":
            scale = torch.clamp_max(threshold / _l2(g), 1.0)
            out.append({k: v * scale for k, v in g.items()})
        elif mode == "clip_l2_per_param_type":
            out.append({k: v * torch.clamp_max(threshold / _norm(v), 1.0)
                        for k, v in g.items()})
        else:
            raise ValueError(f"unknown gradient normalization {mode!r}")
    return out
