"""KD-tree for low-dimensional exact neighbor search (reference:
clustering/kdtree/KDTree.java:129-157 knn(point, threshold); insert/delete
point API).

Host-side axis-median tree over numpy data with vectorized leaf scoring —
the same stance as VPTree: trees organize indices, vectorized numpy does
the tiny per-node arithmetic. KD-trees only pay off in low dimension; for
d ≳ 20 use VPTree or brute force. A copy of the JAX package's
clustering/kdtree.py: it touches no device.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _KDNode:
    __slots__ = ("axis", "split", "index", "left", "right", "leaf_indices")

    def __init__(self):
        self.axis = 0
        self.split = 0.0
        self.index = -1
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None
        self.leaf_indices: Optional[np.ndarray] = None


class KDTree:
    def __init__(self, points: np.ndarray, leaf_size: int = 32):
        self.points = np.asarray(points, np.float32)
        self.dims = self.points.shape[1]
        self.leaf_size = int(leaf_size)
        self.root = self._build(np.arange(self.points.shape[0]), depth=0)

    def _build(self, idx: np.ndarray, depth: int) -> Optional[_KDNode]:
        if idx.size == 0:
            return None
        node = _KDNode()
        if idx.size <= self.leaf_size:
            node.leaf_indices = idx
            return node
        axis = depth % self.dims
        vals = self.points[idx, axis]
        order = np.argsort(vals, kind="stable")
        mid = idx.size // 2
        node.axis = axis
        node.index = int(idx[order[mid]])
        node.split = float(vals[order[mid]])
        node.left = self._build(idx[order[:mid]], depth + 1)
        node.right = self._build(idx[order[mid + 1:]], depth + 1)
        return node

    def knn(self, point: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest by euclidean distance -> (indices, distances)."""
        q = np.asarray(point, np.float32).reshape(-1)
        k = min(int(k), self.points.shape[0])
        heap: List[Tuple[float, int]] = []  # max-heap via negation

        def consider(indices: np.ndarray):
            d2 = ((self.points[indices] - q[None, :]) ** 2).sum(axis=1)
            for i, di in zip(indices, d2):
                if len(heap) < k:
                    heapq.heappush(heap, (-float(di), int(i)))
                elif -heap[0][0] > di:
                    heapq.heapreplace(heap, (-float(di), int(i)))

        def tau2() -> float:
            return -heap[0][0] if len(heap) == k else np.inf

        def walk(node: Optional[_KDNode]):
            if node is None:
                return
            if node.leaf_indices is not None:
                consider(node.leaf_indices)
                return
            consider(np.array([node.index]))
            delta = q[node.axis] - node.split
            near, far = (node.right, node.left) if delta > 0 else (node.left, node.right)
            walk(near)
            if delta * delta <= tau2():
                walk(far)

        walk(self.root)
        out = sorted((-nd, i) for nd, i in heap)
        idx = np.array([i for _, i in out])
        dist = np.sqrt(np.array([d for d, _ in out]))
        return idx, dist
