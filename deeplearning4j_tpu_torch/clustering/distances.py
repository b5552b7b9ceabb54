"""Batched distance blocks shared by the clustering/neighbor modules.

The reference computes distances point-at-a-time through ND4J accumulations
(clustering/algorithm/BaseClusteringAlgorithm.java, vptree/VPTree.java
distance calls). Here every distance is an [n, m] block on the device:
||x - c||^2 = ||x||^2 + ||c||^2 - 2 x.c is one matmul, and the host only
ever sees the reduced results (argmin/top-k). The port of the JAX
package's clustering/distances.py; its f32 matmuls run without TF32
(`common/dtypes.default_policy().apply()` at each entry point).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.common.dtypes import default_policy

EPS = 1e-12

SUPPORTED = ("euclidean", "sqeuclidean", "manhattan", "cosinesimilarity", "dot")


def pairwise(x: torch.Tensor, y: torch.Tensor, distance: str) -> torch.Tensor:
    """[n, d] x [m, d] -> [n, m] distance/similarity block, on x's device."""
    if distance in ("euclidean", "sqeuclidean"):
        x2 = torch.sum(x * x, dim=1)[:, None]
        y2 = torch.sum(y * y, dim=1)[None, :]
        d2 = torch.clamp_min(x2 + y2 - 2.0 * (x @ y.T), 0.0)
        return torch.sqrt(d2) if distance == "euclidean" else d2
    if distance == "manhattan":
        # no matmul form; cdist sums |x - y| without the [n, m, d] broadcast
        return torch.cdist(x, y, p=1.0)
    if distance == "cosinesimilarity":
        xn = x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + EPS)
        yn = y / torch.sqrt(torch.sum(y * y, dim=1, keepdim=True) + EPS)
        return xn @ yn.T
    if distance == "dot":
        return x @ y.T
    raise ValueError(f"unknown distance {distance!r}; supported: {SUPPORTED}")


def is_similarity(distance: str) -> bool:
    """Similarity functions rank DEscending (reference VPTree 'invert')."""
    return distance in ("cosinesimilarity", "dot")


def top_k(d: torch.Tensor, k: int, descending: bool):
    """The k best of each row of `d`, ties by ascending index (the order of
    XLA's top_k): a stable sort of the block, so a duplicated point or a
    query against its own stored index ranks the same on every device."""
    vals, idx = torch.sort(d, dim=1, descending=descending, stable=True)
    return vals[:, :k], idx[:, :k]


def brute_force_knn(points: np.ndarray, queries: np.ndarray, k: int,
                    distance: str = "euclidean", device=None):
    """Exact k-NN of each query against all points — one [q, n] device
    block + top-k. Returns (indices [q, k], distances [q, k])."""
    dev = resolve_device(device)
    default_policy().apply()
    d = pairwise(torch.as_tensor(np.asarray(queries, np.float32), device=dev),
                 torch.as_tensor(np.asarray(points, np.float32), device=dev),
                 distance)
    vals, idx = top_k(d, k, descending=is_similarity(distance))
    return idx.cpu().numpy().astype(np.int32), vals.cpu().numpy()
