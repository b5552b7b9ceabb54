"""Line-search (full-gradient) optimizers: line gradient descent,
conjugate gradient, L-BFGS. The port of the JAX package's
train/solvers.py.

Reference: optimize/solvers/ — LineGradientDescent, ConjugateGradient,
LBFGS over BaseOptimizer (line-search optimize() :182-230) with
BackTrackLineSearch (Armijo backtracking). The search loop runs on the
host around the network's loss and its autograd gradient on the flat
parameter vector, which stays on the net's device; each decision
(a slope, an Armijo test, a CG beta, an L-BFGS rho) reads one scalar
back. No kernel of the port runs here that the SGD step does not run.

SGD remains the fast path (one step per batch, train/updaters.py); these
optimizers trade steps per second for more progress per batch, as in the
reference.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


class BackTrackLineSearch:
    """Armijo backtracking (reference: optimize/solvers/BackTrackLineSearch
    .java): try the full step, halve until sufficient decrease or maxIter."""

    def __init__(self, c1: float = 1e-4, rho: float = 0.5, max_iterations: int = 5):
        self.c1 = c1
        self.rho = rho
        self.max_iterations = max_iterations

    def search(self, value_fn: Callable, x0, f0, g0, direction, step0: float):
        """Returns (x_new, f_new, step_taken)."""
        slope = _dot(g0, direction)
        if slope >= 0:
            # not a descent direction: the caller resets (CG/LBFGS do)
            return x0, f0, 0.0
        step = step0
        for i in range(self.max_iterations):
            x_new = x0 + step * direction
            f_new = float(value_fn(x_new))
            if np.isfinite(f_new) and f_new <= f0 + self.c1 * step * slope:
                if i == 0:
                    # full step accepted: expand while it keeps helping
                    # (reference: BackTrackLineSearch stpmax probing)
                    for _ in range(self.max_iterations):
                        x_try = x0 + 2.0 * step * direction
                        f_try = float(value_fn(x_try))
                        ok = (
                            np.isfinite(f_try)
                            and f_try <= f0 + self.c1 * 2.0 * step * slope
                            and f_try < f_new
                        )
                        if not ok:
                            break
                        step *= 2.0
                        x_new, f_new = x_try, f_try
                return x_new, f_new, step
            step *= self.rho  # backtrack
        return x0, f0, 0.0


class _FlatProblem:
    """The network loss and its gradient as functions of the flat
    parameter vector (training-mode forward, the bound batch)."""

    def __init__(self, net):
        from deeplearning4j_tpu_torch.nn.params import flat_to_params

        confs = net._ordered_layer_confs()

        def loss_of_flat(flat, states, x, y, f_mask, l_mask, rng):
            plist = flat_to_params(confs, net.params_list, flat)
            s, _ = net._loss(plist, states, x, y, f_mask, l_mask,
                             rng=rng, training=True)
            return s

        self._loss = loss_of_flat
        self._bound = None

    def bind(self, states, x, y, f_mask, l_mask, rng) -> "_FlatProblem":
        self._bound = (states, x, y, f_mask, l_mask, rng)
        return self

    def _rng(self):
        # a generator is consumed by its draws: every evaluation redraws
        # from the bound seed, as the JAX package reuses its key
        rng = self._bound[5]
        if rng is None:
            return None
        return torch.Generator(device=rng.device).set_state(rng.get_state())

    def value_and_grad(self, flat):
        states, x, y, fm, lm, _ = self._bound
        flat = flat.detach().requires_grad_(True)
        s = self._loss(flat, states, x, y, fm, lm, self._rng())
        (g,) = torch.autograd.grad(s, flat)
        return s.detach(), g

    def value(self, flat):
        states, x, y, fm, lm, _ = self._bound
        with torch.no_grad():
            return self._loss(flat, states, x, y, fm, lm, self._rng())


class BaseLineSearchOptimizer:
    """One `optimize(...)` call = direction + line search on one batch
    (reference: BaseOptimizer.optimize :182-230)."""

    name = "base"

    def __init__(self, max_line_search_iterations: int = 5):
        self.line_search = BackTrackLineSearch(
            max_iterations=max_line_search_iterations
        )
        self.reset()

    def reset(self):
        pass

    def direction(self, g, flat):
        raise NotImplementedError

    def optimize(self, problem: _FlatProblem, flat, step0: float):
        f0, g = problem.value_and_grad(flat)
        f0 = float(f0)
        d = self.direction(g, flat)
        new_flat, f_new, step = self.line_search.search(
            problem.value, flat, f0, g, d, step0
        )
        if step == 0.0:
            # no progress along d (or not a descent direction): reset the
            # memory and take a plain small gradient step (reference:
            # step fallback)
            self.reset()
            new_flat = flat - step0 * g
            f_new = float(problem.value(new_flat))
        self._post_step(g, new_flat - flat)
        return new_flat, f_new

    def _post_step(self, g, s):
        pass


class LineGradientDescent(BaseLineSearchOptimizer):
    """Steepest descent + line search (reference: LineGradientDescent.java)."""

    name = "line_gradient_descent"

    def direction(self, g, flat):
        return -g


class ConjugateGradient(BaseLineSearchOptimizer):
    """Nonlinear CG, Polak-Ribière with automatic restart (reference:
    ConjugateGradient.java)."""

    name = "conjugate_gradient"

    def reset(self):
        self._g_prev = None
        self._d_prev = None

    def direction(self, g, flat):
        if self._g_prev is None:
            d = -g
        else:
            gg = _dot(self._g_prev, self._g_prev)
            beta = max(0.0, _dot(g, g - self._g_prev) / max(gg, 1e-20))
            d = -g + beta * self._d_prev
            if _dot(d, g) >= 0:  # not a descent direction: restart
                d = -g
        self._g_prev = g
        self._d_prev = d
        return d


class LBFGS(BaseLineSearchOptimizer):
    """Limited-memory BFGS, two-loop recursion (reference: LBFGS.java,
    default history m=10)."""

    name = "lbfgs"

    def __init__(self, m: int = 10, max_line_search_iterations: int = 5):
        self.m = m
        super().__init__(max_line_search_iterations)

    def reset(self):
        self._s = []  # param deltas
        self._y = []  # gradient deltas
        self._g_prev = None

    def direction(self, g, flat):
        if self._g_prev is not None:
            y = g - self._g_prev
            s = self._last_step
            ys = _dot(y, s)
            if ys > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.m:
                    self._s.pop(0)
                    self._y.pop(0)
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / _dot(y, s)
            a = rho * _dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            gamma = _dot(s_last, y_last) / _dot(y_last, y_last)
            q = gamma * q
        for a, rho, s, y in reversed(alphas):
            b = rho * _dot(y, q)
            q = q + (a - b) * s
        self._g_prev = g
        return -q

    def _post_step(self, g, s):
        self._last_step = s


_OPTIMIZERS = {
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


def make_line_search_optimizer(algo: str) -> BaseLineSearchOptimizer:
    cls = _OPTIMIZERS.get(algo)
    if cls is None:
        raise ValueError(
            f"unknown optimization algorithm {algo!r}; known: sgd, "
            + ", ".join(sorted(_OPTIMIZERS))
        )
    return cls()
