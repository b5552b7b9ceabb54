"""Graph embeddings (reference: deeplearning4j-graph, 3,363 LoC —
IGraph/Graph, random-walk iterators, DeepWalk + GraphHuffman +
InMemoryGraphLookupTable, GraphVectors serving API)."""

from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, GraphVectors, Node2Vec
from deeplearning4j_tpu_torch.graph.walkers import (RandomWalkIterator,
    Node2VecWalkIterator)

__all__ = ["Graph", "DeepWalk", "GraphVectors", "Node2Vec",
           "RandomWalkIterator", "Node2VecWalkIterator"]
