"""Random-walk sequence generators (reference: graph/iterator/
RandomWalkIterator.java + WeightedWalkIterator — fixed-length walks
starting from every vertex, with a NoEdgeHandling policy for dead ends)."""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph


class NoEdgeHandling:
    SELF_LOOP = "self_loop"          # stay at the vertex
    EXCEPTION = "exception"
    CUTOFF = "cutoff"                # end the walk early


class RandomWalkIterator:
    """Yields one fixed-length walk per start vertex per epoch, in
    shuffled vertex order (reference semantics)."""

    def __init__(self, graph: Graph, walk_length: int,
                 weighted: bool = False, seed: int = 0,
                 no_edge_handling: str = NoEdgeHandling.SELF_LOOP):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.weighted = weighted
        self.no_edge = no_edge_handling
        self._rng = np.random.default_rng(seed)

    def walk_from(self, start: int) -> List[int]:
        walk = [start]
        v = start
        for _ in range(self.walk_length):
            nxt = self.graph.random_neighbor(v, self._rng, self.weighted)
            if nxt is None:
                if self.no_edge == NoEdgeHandling.EXCEPTION:
                    raise RuntimeError(f"vertex {v} has no outgoing edges")
                if self.no_edge == NoEdgeHandling.CUTOFF:
                    break
                nxt = v  # self loop
            walk.append(nxt)
            v = nxt
        return walk

    def __iter__(self) -> Iterator[List[int]]:
        order = self._rng.permutation(self.graph.num_vertices)
        for start in order:
            yield self.walk_from(int(start))


class Node2VecWalkIterator:
    """Biased 2nd-order walks (Grover & Leskovec node2vec; the reference's
    models/node2vec/Node2Vec.java is a deprecated stub — this is the real
    algorithm the stub pointed at). From edge (prev -> cur), the next hop
    x is drawn with unnormalized probability
        1/p  if x == prev        (return)
        1    if x ~ prev         (BFS-ish: stays near)
        1/q  otherwise           (DFS-ish: explores outward)
    times the edge weight when `weighted`. p == q == 1 degenerates to
    RandomWalkIterator's uniform walks."""

    def __init__(self, graph: Graph, walk_length: int, *, p: float = 1.0,
                 q: float = 1.0, weighted: bool = False, seed: int = 0,
                 no_edge_handling: str = NoEdgeHandling.SELF_LOOP):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.p = float(p)
        self.q = float(q)
        self.weighted = weighted
        self.no_edge = no_edge_handling
        self._rng = np.random.default_rng(seed)
        # adjacency sets for the O(1) "is x a neighbor of prev" probe
        self._nbr_sets = [set(graph.neighbors(v))
                          for v in range(graph.num_vertices)]

    def walk_from(self, start: int) -> List[int]:
        walk = [start]
        prev, cur = None, start
        for _ in range(self.walk_length):
            nbrs = self.graph.neighbors(cur)
            if not nbrs:
                if self.no_edge == NoEdgeHandling.EXCEPTION:
                    raise RuntimeError(f"vertex {cur} has no outgoing edges")
                if self.no_edge == NoEdgeHandling.CUTOFF:
                    break
                walk.append(cur)  # self loop
                prev = cur
                continue
            w = (np.asarray(self.graph.weights(cur), np.float64)
                 if self.weighted else np.ones(len(nbrs)))
            if prev is not None:
                prev_nbrs = self._nbr_sets[prev]
                bias = np.asarray(
                    [1.0 / self.p if x == prev
                     else (1.0 if x in prev_nbrs else 1.0 / self.q)
                     for x in nbrs])
                w = w * bias
            w = w / w.sum()
            nxt = int(self._rng.choice(len(nbrs), p=w))
            nxt = nbrs[nxt]
            walk.append(nxt)
            prev, cur = cur, nxt
        return walk

    def __iter__(self) -> Iterator[List[int]]:
        order = self._rng.permutation(self.graph.num_vertices)
        for start in order:
            yield self.walk_from(int(start))
