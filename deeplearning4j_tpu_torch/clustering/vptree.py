"""Vantage-point tree for exact k-NN (reference:
clustering/vptree/VPTree.java:224-251 search(target, k, results,
distances); 'invert' flag flips similarity functions to rank descending).

The reference recurses point-at-a-time; here the tree is a host-side
index structure over numpy data, but every distance evaluation is
batched — construction partitions with one vectorized distance column per
node, and search walks the tree with branch-and-bound while scoring whole
leaves at once. For small point sets a flat brute-force device matmul
beats any tree; VPTree picks that path automatically below
``brute_force_threshold``, and for distances a metric tree cannot prune
(cosine, dot, `invert`). The port of the JAX package's
clustering/vptree.py: the tree and its search order are the same for the
same seed, and the flat path keeps the points resident on its device from
construction (the JAX package uploads them on every search).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.distances import is_similarity, pairwise, top_k
from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.common.dtypes import default_policy


def _np_dist(x: np.ndarray, y: np.ndarray, distance: str) -> np.ndarray:
    """Host-side [n] distances of points x to a single point y."""
    if distance in ("euclidean", "sqeuclidean"):
        d2 = np.maximum(((x - y[None, :]) ** 2).sum(axis=1), 0.0)
        return np.sqrt(d2) if distance == "euclidean" else d2
    if distance == "manhattan":
        return np.abs(x - y[None, :]).sum(axis=1)
    if distance == "cosinesimilarity":
        xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
        yn = y / (np.linalg.norm(y) + 1e-12)
        return xn @ yn
    if distance == "dot":
        return x @ y
    raise ValueError(f"unknown distance {distance!r}")


class _Node:
    __slots__ = ("vp_index", "radius", "inside", "outside", "leaf_indices")

    def __init__(self):
        self.vp_index: int = -1
        self.radius: float = 0.0
        self.inside: Optional["_Node"] = None
        self.outside: Optional["_Node"] = None
        self.leaf_indices: Optional[np.ndarray] = None


class VPTree:
    """VPTree(points, similarity_function='euclidean', invert=False).

    ``search(target, k)`` returns (indices, distances) of the k nearest
    (or most similar, for similarity functions / invert=True) points.
    The flat path runs on `device` ("cuda" when None).
    """

    def __init__(self, points: np.ndarray,
                 similarity_function: str = "euclidean",
                 invert: bool = False, leaf_size: int = 64,
                 brute_force_threshold: int = 2048, seed: int = 0,
                 device=None):
        self.points = np.asarray(points, np.float32)
        self.distance = similarity_function
        # similarity functions rank descending; invert flips explicitly
        self.descending = is_similarity(similarity_function) ^ bool(invert)
        self.leaf_size = int(leaf_size)
        self.brute = self.points.shape[0] <= int(brute_force_threshold)
        self._rng = np.random.default_rng(seed)
        # metric-tree pruning is only valid for true metrics
        self._prunable = similarity_function in (
            "euclidean", "manhattan") and not invert
        self.device = resolve_device(device)
        self.root = None
        self._points_dev = None
        if self.brute or not self._prunable:
            default_policy().apply()
            self._points_dev = torch.as_tensor(self.points, device=self.device)
        if not self.brute:
            self.root = self._build(np.arange(self.points.shape[0]))

    # -- construction -------------------------------------------------------

    def _build(self, idx: np.ndarray) -> Optional[_Node]:
        if idx.size == 0:
            return None
        node = _Node()
        if idx.size <= self.leaf_size or not self._prunable:
            node.leaf_indices = idx
            return node
        vp_pos = int(self._rng.integers(0, idx.size))
        vp = idx[vp_pos]
        rest = np.delete(idx, vp_pos)
        d = _np_dist(self.points[rest], self.points[vp], self.distance)
        node.vp_index = int(vp)
        node.radius = float(np.median(d))
        inside = rest[d <= node.radius]
        outside = rest[d > node.radius]
        if inside.size == 0 or outside.size == 0:  # degenerate split
            node.leaf_indices = rest
            return node
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    # -- search -------------------------------------------------------------

    def search(self, target: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        target = np.asarray(target, np.float32).reshape(-1)
        k = min(int(k), self.points.shape[0])
        if self.brute or not self._prunable:
            # flat device path, ranked by self.descending (invert honored)
            d = pairwise(torch.as_tensor(target, device=self.device)[None, :],
                         self._points_dev, self.distance)
            vals, idx = top_k(d, k, descending=self.descending)
            return (idx[0].cpu().numpy().astype(np.int32),
                    vals[0].cpu().numpy())
        # branch-and-bound over the metric tree; max-heap of the current
        # k best (negated distances)
        heap: List[Tuple[float, int]] = []

        def consider(indices: np.ndarray):
            d = _np_dist(self.points[indices], target, self.distance)
            for i, di in zip(indices, d):
                if len(heap) < k:
                    heapq.heappush(heap, (-float(di), int(i)))
                elif -heap[0][0] > di:
                    heapq.heapreplace(heap, (-float(di), int(i)))

        def tau() -> float:
            return -heap[0][0] if len(heap) == k else np.inf

        def walk(node: Optional[_Node]):
            if node is None:
                return
            if node.leaf_indices is not None:
                consider(node.leaf_indices)
                if node.vp_index >= 0:
                    consider(np.array([node.vp_index]))
                return
            dvp = float(_np_dist(self.points[node.vp_index][None, :],
                                 target, self.distance)[0])
            consider(np.array([node.vp_index]))
            if dvp <= node.radius:
                walk(node.inside)
                if dvp + tau() > node.radius:
                    walk(node.outside)
            else:
                walk(node.outside)
                if dvp - tau() <= node.radius:
                    walk(node.inside)

        walk(self.root)
        out = sorted((-nd, i) for nd, i in heap)
        idx = np.array([i for _, i in out])
        dist = np.array([d for d, _ in out])
        return idx, dist
