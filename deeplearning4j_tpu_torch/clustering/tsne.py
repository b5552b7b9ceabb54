"""t-SNE dimensionality reduction on the device (reference:
plot/BarnesHutTsne.java, 858 LoC, and plot/Tsne.java — perplexity search,
early exaggeration, momentum + per-parameter gains).

The reference approximates the N-body repulsion with a Barnes-Hut
quadtree on the CPU. Here, as in the JAX package's clustering/tsne.py,
the exact O(N^2) formulation is a few [N, N] matmul/softmax blocks on the
device — exact, and fast at the scales the UI t-SNE tab serves. The
perplexity search and the gradient loop are plain loops of device ops
with no host read inside them.

Two differences of form from the JAX package, none of result:

* The gradient is `4 (rowsum(PQ)[:, None] * Y - PQ @ Y)`, where the JAX
  package writes `4 (diag(rowsum(PQ)) - PQ) @ Y` and so builds an N x N
  diagonal. The same quantity, summed in another order.
* The initial embedding: the JAX package draws `1e-4 * N(0, 1)` from
  `jax.random.PRNGKey(seed)`, a draw that is not bit-portable. The port
  takes it as `y0=` when given, else draws `1e-4 * N(0, 1)` from a
  `torch.Generator` seeded with `seed` on the CPU and moves it.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.common.dtypes import default_policy


def _pairwise_sq(x: torch.Tensor) -> torch.Tensor:
    """max(||x_i||^2 + ||x_j||^2 - 2 x_i.x_j, 0), the product's scaling
    and the subtraction in the GEMM's epilogue."""
    x2 = torch.sum(x * x, dim=1)
    d2 = torch.addmm(x2[:, None] + x2[None, :], x, x.T, alpha=-2.0)
    return d2.clamp_min_(0.0)


def _cond_probs(d2: torch.Tensor, beta: torch.Tensor):
    """Row-wise conditional p_{j|i} for precision vector beta, diag zeroed."""
    logits = -d2 * beta[:, None]
    logits.fill_diagonal_(float("-inf"))
    p = torch.softmax(logits, dim=1)
    # per-row Shannon entropy -> perplexity = 2^H
    h = -torch.sum(torch.where(p > 0, p * torch.log2(p + 1e-30), 0.0), dim=1)
    return p, h


def _binary_search_beta(d2: torch.Tensor, target_h: torch.Tensor, iters: int = 40):
    """Vectorized per-point precision search matching log2(perplexity)."""
    n = d2.shape[0]
    beta = torch.ones((n,), dtype=d2.dtype, device=d2.device)
    lo = torch.full((n,), float("-inf"), dtype=d2.dtype, device=d2.device)
    hi = torch.full((n,), float("inf"), dtype=d2.dtype, device=d2.device)
    for _ in range(iters):
        _, h = _cond_probs(d2, beta)
        too_high = h > target_h  # entropy too high -> sharpen (raise beta)
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0,
                           torch.where(torch.isinf(lo), beta / 2.0, 0.5 * (lo + hi)))
        # lo is only -inf before the first time entropy was too high
        beta = torch.clamp_min(beta, 1e-12)
    p, _ = _cond_probs(d2, beta)
    return p


def _joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetric P of `x` ([n, d]) after the perplexity search."""
    n = x.shape[0]
    target_h = torch.full((n,), float(np.log2(perplexity)), dtype=torch.float32,
                          device=x.device)
    p = _binary_search_beta(_pairwise_sq(x), target_h)
    return (p + p.T) / (2.0 * n)


def _tsne_run(p_sym, y0, n_iter, stop_lying_iter, momentum_switch, lr):
    """Gradient loop: KL(P||Q) descent with gains + momentum (the
    reference's update schedule: early exaggeration 12x until
    stop_lying_iter, momentum 0.5 -> 0.8 at momentum_switch)."""
    y = y0
    vel = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    for i in range(n_iter):
        num = _pairwise_sq(y).add_(1.0).reciprocal_()   # student-t kernel
        num.fill_diagonal_(0.0)
        q = num / torch.clamp_min(torch.sum(num), 1e-12)
        exaggeration = 12.0 if i < stop_lying_iter else 1.0
        # (exaggeration * P - Q) * num, [n, n], in q's buffer
        pq = q.sub_(p_sym, alpha=exaggeration).mul_(num).neg_()
        grad = 4.0 * (torch.sum(pq, dim=1)[:, None] * y - pq @ y)
        momentum = 0.5 if i < momentum_switch else 0.8
        same_sign = torch.sign(grad) == torch.sign(vel)
        gains = torch.clamp_min(torch.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
        vel = momentum * vel - lr * gains * grad
        y = y + vel
        y = y - torch.mean(y, dim=0, keepdim=True)
    return y


def _kl_divergence(p_sym: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    num = _pairwise_sq(y).add_(1.0).reciprocal_()
    num.fill_diagonal_(0.0)
    q = num / torch.clamp_min(torch.sum(num), 1e-12)
    return torch.sum(torch.where(p_sym > 0,
                                 p_sym * torch.log((p_sym + 1e-12) / (q + 1e-12)),
                                 0.0))


class Tsne:
    """Tsne(n_components=2, perplexity=30, n_iter=1000).fit_transform(X).

    ``theta`` is accepted for reference-API compatibility
    (BarnesHutTsne's approximation knob) and ignored: the exact device
    path needs no approximation at dashboard scales. Runs on `device`
    ("cuda" when None).
    """

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 1000,
                 stop_lying_iteration: int = 250,
                 momentum_switch_iteration: int = 250,
                 theta: float = 0.5, seed: int = 0, device=None):
        del theta
        self.n_components = int(n_components)
        self.perplexity = float(perplexity)
        self.learning_rate = float(learning_rate)
        self.n_iter = int(n_iter)
        self.stop_lying_iteration = int(stop_lying_iteration)
        self.momentum_switch_iteration = int(momentum_switch_iteration)
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_: float = float("nan")

    def fit_transform(self, x: np.ndarray, y0=None) -> np.ndarray:
        default_policy().apply()
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        n = x.shape[0]
        if self.perplexity >= n:
            raise ValueError(f"perplexity {self.perplexity} >= n {n}")
        p_sym = _joint_probabilities(x, self.perplexity)
        if y0 is None:
            gen = torch.Generator().manual_seed(int(self.seed))
            y0 = 1e-4 * torch.randn((n, self.n_components), generator=gen)
        if not torch.is_tensor(y0):
            y0 = torch.as_tensor(np.asarray(y0, np.float32))
        y0 = y0.to(device=self.device, dtype=torch.float32)
        y = _tsne_run(p_sym, y0, self.n_iter, self.stop_lying_iteration,
                      self.momentum_switch_iteration, self.learning_rate)
        self.kl_ = float(_kl_divergence(p_sym, y))
        return y.cpu().numpy()
