"""DeepWalk graph embeddings (reference: graph/models/deepwalk/
DeepWalk.java:95 fit(IGraph, walkLength) — random walks fed to
skip-gram with GraphHuffman hierarchical softmax over
InMemoryGraphLookupTable).

Walks are generated host-side (numpy pointer chasing) and the
skip-gram/HS updates run as the SAME batched device step the NLP stack
uses (nlp/learning.py — the AggregateSkipGram analog); the graph-specific
Huffman coding degenerates to the NLP Huffman over vertex frequencies in
the walk corpus, which is exactly what DeepWalk's degree-weighted coding
approximates."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walkers import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    VectorsConfiguration,
)


class GraphVectors:
    """Read-side API over trained vertex embeddings (reference:
    graph/models/GraphVectors.java)."""

    def __init__(self, sv: SequenceVectors, num_vertices: int):
        self._sv = sv
        self.num_vertices = num_vertices

    def vertex_vector(self, v: int) -> np.ndarray:
        return self._sv.lookup.vector(str(v))

    def similarity(self, a: int, b: int) -> float:
        return self._sv.lookup.similarity(str(a), str(b))

    def verts_nearest(self, v: int, top_n: int = 10) -> List[int]:
        return [int(w) for w, _ in
                self._sv.lookup.words_nearest(str(v), top_n)]


class DeepWalk:
    """Builder-style API mirroring DeepWalk.Builder (vectorSize,
    windowSize, learningRate) + fit(graph, walk_length). The vectors
    train on `device` (None: "cuda")."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, walks_per_vertex: int = 10,
                 seed: int = 0, batch_size: int = 1024, *, device=None):
        self.device = resolve_device(device)
        self.vector_size = int(vector_size)
        self.window_size = int(window_size)
        self.learning_rate = float(learning_rate)
        self.walks_per_vertex = int(walks_per_vertex)
        self.seed = seed
        self.batch_size = batch_size
        self.vectors: Optional[GraphVectors] = None

    def _make_walker(self, graph: Graph, walk_length: int, weighted: bool,
                     epoch: int):
        """Walk-iterator factory — the only thing subclasses override."""
        return RandomWalkIterator(graph, walk_length, weighted=weighted,
                                  seed=self.seed + epoch)

    def fit(self, graph: Graph, walk_length: int = 40,
            weighted: bool = False) -> GraphVectors:
        walks: List[List[str]] = []
        for epoch in range(self.walks_per_vertex):
            it = self._make_walker(graph, walk_length, weighted, epoch)
            walks.extend([str(v) for v in walk] for walk in it)
        conf = VectorsConfiguration(
            layer_size=self.vector_size,
            window=self.window_size,
            learning_rate=self.learning_rate,
            min_word_frequency=1,
            use_hierarchic_softmax=True,   # DeepWalk's GraphHuffman analog
            negative=0,
            epochs=1,
            batch_size=self.batch_size,
            seed=self.seed,
        )
        sv = SequenceVectors(conf, walks, device=self.device)
        sv.fit()
        self.vectors = GraphVectors(sv, graph.num_vertices)
        return self.vectors


class Node2Vec(DeepWalk):
    """node2vec = DeepWalk with biased 2nd-order walks (p: return
    parameter, q: in-out parameter) feeding the same SequenceVectors
    device step. Reference intent: models/node2vec/Node2Vec.java (a
    deprecated stub wiring a GraphWalker into SequenceVectors — here the
    wiring actually works)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, walks_per_vertex: int = 10,
                 p: float = 1.0, q: float = 1.0, seed: int = 0,
                 batch_size: int = 1024, *, device=None):
        super().__init__(vector_size=vector_size, window_size=window_size,
                         learning_rate=learning_rate,
                         walks_per_vertex=walks_per_vertex, seed=seed,
                         batch_size=batch_size, device=device)
        self.p = float(p)
        self.q = float(q)

    def _make_walker(self, graph: Graph, walk_length: int, weighted: bool,
                     epoch: int):
        from deeplearning4j_tpu_torch.graph.walkers import Node2VecWalkIterator

        return Node2VecWalkIterator(
            graph, walk_length, p=self.p, q=self.q, weighted=weighted,
            seed=self.seed + epoch)
