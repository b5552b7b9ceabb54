"""In-memory graph (reference: graph/api/IGraph.java + graph/graph/
Graph.java — vertex set with adjacency lists, directed or undirected,
optional edge weights)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class Graph:
    def __init__(self, num_vertices: int, directed: bool = False):
        self.num_vertices = int(num_vertices)
        self.directed = bool(directed)
        self._adj: List[List[int]] = [[] for _ in range(num_vertices)]
        self._w: List[List[float]] = [[] for _ in range(num_vertices)]

    def add_edge(self, a: int, b: int, weight: float = 1.0) -> None:
        if not (0 <= a < self.num_vertices and 0 <= b < self.num_vertices):
            raise ValueError(f"edge ({a},{b}) out of range")
        self._adj[a].append(b)
        self._w[a].append(float(weight))
        if not self.directed:
            self._adj[b].append(a)
            self._w[b].append(float(weight))

    @classmethod
    def from_edge_list(cls, num_vertices: int,
                       edges: Sequence[Tuple[int, int]],
                       directed: bool = False) -> "Graph":
        g = cls(num_vertices, directed)
        for e in edges:
            g.add_edge(e[0], e[1], e[2] if len(e) > 2 else 1.0)
        return g

    def neighbors(self, v: int) -> List[int]:
        return self._adj[v]

    def degree(self, v: int) -> int:
        return len(self._adj[v])

    def weights(self, v: int) -> List[float]:
        return self._w[v]

    def random_neighbor(self, v: int, rng: np.random.Generator,
                        weighted: bool = False) -> Optional[int]:
        nbrs = self._adj[v]
        if not nbrs:
            return None
        if weighted:
            w = np.asarray(self._w[v])
            return int(rng.choice(nbrs, p=w / w.sum()))
        return int(nbrs[rng.integers(0, len(nbrs))])
