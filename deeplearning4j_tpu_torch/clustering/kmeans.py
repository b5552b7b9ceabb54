"""K-means clustering with device-side Lloyd iterations.

Capability parity with the reference's KMeansClustering
(clustering/kmeans/KMeansClustering.java:43-49 — setup(clusterCount,
maxIterationCount, distanceFunction) / setup(clusterCount,
minDistributionVariationRate, ...) over the BaseClusteringAlgorithm
iterate-until-converged framework). One Lloyd step is an [n, k] distance
block (matmul), an argmin assignment, and a one-hot-product centroid
update, all on the device; the host only checks convergence between
steps. The port of the JAX package's clustering/kmeans.py.

The centroid sums stay a one-hot product (`one_hot(assign).T @ points`),
as in the JAX package: `index_add_`/`scatter_add_` on CUDA add with
atomics, so two runs could round differently and flip an assignment at
the next step; the product is one GEMM with a fixed summation order, and
two runs on the card are bit-equal.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.clustering.distances import is_similarity, pairwise
from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.common.dtypes import default_policy


@dataclasses.dataclass
class Cluster:
    """One cluster of a ClusterSet: its center and member point indices."""

    center: np.ndarray
    point_indices: np.ndarray

    @property
    def count(self) -> int:
        return int(self.point_indices.size)


@dataclasses.dataclass
class ClusterSet:
    """Result of a clustering run (reference: cluster/ClusterSet.java).
    `device` is where `nearest_cluster` computes: the run's device."""

    centers: np.ndarray          # [k, d]
    assignments: np.ndarray      # [n] cluster index per point
    distances: np.ndarray        # [n] distance of each point to its center
    distance_function: str
    iterations: int
    device: Optional[str] = None

    @property
    def clusters(self) -> List[Cluster]:
        return [
            Cluster(self.centers[c], np.nonzero(self.assignments == c)[0])
            for c in range(self.centers.shape[0])
        ]

    def nearest_cluster(self, point: np.ndarray) -> int:
        dev = resolve_device(self.device)
        d = pairwise(torch.as_tensor(np.asarray(point, np.float32), device=dev)[None, :],
                     torch.as_tensor(self.centers, device=dev),
                     self.distance_function)[0]
        return int(torch.argmax(d) if is_similarity(self.distance_function)
                   else torch.argmin(d))


def _lloyd_step(points: torch.Tensor, centers: torch.Tensor, distance: str):
    """One Lloyd iteration: assign + recompute. Distances as matmul;
    similarity functions (cosine) assign by argmax and renormalize the
    centers (spherical k-means). argmin/argmax return the first index
    among equal values, as jnp.argmin does."""
    d = pairwise(points, centers, distance)
    assign = torch.argmax(d, dim=1) if is_similarity(distance) else torch.argmin(d, dim=1)
    best = torch.gather(d, 1, assign[:, None])[:, 0]
    k = centers.shape[0]
    onehot = F.one_hot(assign, k).to(points.dtype)                # [n, k]
    sums = onehot.T @ points                                      # [k, d]
    counts = torch.sum(onehot, dim=0)[:, None]                    # [k, 1]
    new_centers = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0),
                              centers)
    if distance == "cosinesimilarity":
        norm = torch.sqrt(torch.sum(new_centers * new_centers, dim=1, keepdim=True))
        new_centers = new_centers / torch.clamp_min(norm, 1e-12)
    return new_centers, assign, best


def _point_d2(points: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    diff = points - center[None, :]
    return torch.sum(diff * diff, dim=1)


class KMeansClustering:
    """setup(cluster_count, max_iterations, distance) -> .apply_to(points).

    Convergence: stops when the assignment-distribution variation rate
    drops below ``min_distribution_variation_rate`` (the reference's
    ConvergenceCondition) or after ``max_iterations``. Runs on `device`
    ("cuda" when None).
    """

    def __init__(self, cluster_count: int, max_iterations: int = 100,
                 distance_function: str = "euclidean",
                 min_distribution_variation_rate: float = 1e-4,
                 seed: int = 0, init: str = "kmeans++", device=None):
        if distance_function not in ("euclidean", "sqeuclidean", "manhattan",
                                     "cosinesimilarity"):
            # 'dot' has no meaningful centroid objective — reject it
            raise ValueError(
                f"k-means supports euclidean/sqeuclidean/manhattan/"
                f"cosinesimilarity, got {distance_function!r}")
        self.cluster_count = int(cluster_count)
        self.max_iterations = int(max_iterations)
        self.distance_function = distance_function
        self.min_rate = float(min_distribution_variation_rate)
        self.seed = seed
        self.init = init
        self.device = resolve_device(device)

    @classmethod
    def setup(cls, cluster_count: int, max_iterations: int = 100,
              distance_function: str = "euclidean", **kw) -> "KMeansClustering":
        return cls(cluster_count, max_iterations, distance_function, **kw)

    # -- init ---------------------------------------------------------------

    def _init_centers(self, points: torch.Tensor) -> torch.Tensor:
        n = points.shape[0]
        rng = np.random.default_rng(self.seed)
        k = self.cluster_count
        if self.init == "random":
            idx = rng.choice(n, size=k, replace=False)
            return points[torch.as_tensor(np.sort(idx), device=points.device)]
        # k-means++ — D^2 sampling; each round's distance update is one
        # device [n] column read back
        first = int(rng.integers(0, n))
        chosen = [first]
        d2 = _point_d2(points, points[first]).cpu().numpy()
        for _ in range(1, k):
            mass = float(d2.sum())
            if mass <= 1e-12:  # all remaining points coincide with a center
                nxt = int(rng.integers(0, n))
            else:
                nxt = int(rng.choice(n, p=d2 / mass))
            chosen.append(nxt)
            d2 = np.minimum(d2, _point_d2(points, points[nxt]).cpu().numpy())
        return points[torch.as_tensor(chosen, device=points.device)]

    # -- main loop ----------------------------------------------------------

    def apply_to(self, points: np.ndarray) -> ClusterSet:
        default_policy().apply()
        pts = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
        n = pts.shape[0]
        if self.cluster_count > n:
            raise ValueError(f"cluster_count {self.cluster_count} > n {n}")
        centers = self._init_centers(pts)
        prev_assign: Optional[np.ndarray] = None
        assign = best = None
        it = 0
        for it in range(1, self.max_iterations + 1):
            centers, assign_d, best_d = _lloyd_step(pts, centers, self.distance_function)
            assign = assign_d.cpu().numpy()
            best = best_d.cpu().numpy()
            if prev_assign is not None:
                rate = float(np.mean(assign != prev_assign))
                if rate <= self.min_rate:
                    break
            prev_assign = assign
        return ClusterSet(
            centers=centers.cpu().numpy(),
            assignments=assign.astype(np.int32),
            distances=best,
            distance_function=self.distance_function,
            iterations=it,
            device=str(self.device),
        )
