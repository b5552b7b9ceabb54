"""Clustering + neighbor-search algorithms on the device.

Capability parity with the reference's deeplearning4j-core clustering
package (clustering/kmeans, clustering/vptree, clustering/kdtree,
plot/BarnesHutTsne), as in the JAX package's clustering/: the distance
work is batched matmuls on the device instead of per-point Java loops.
Every computing entry point takes `device=` ("cuda" when None).
"""

from deeplearning4j_tpu_torch.clustering.kmeans import ClusterSet, KMeansClustering
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.tsne import Tsne
from deeplearning4j_tpu_torch.clustering.vptree import VPTree

__all__ = [
    "KMeansClustering",
    "ClusterSet",
    "VPTree",
    "KDTree",
    "Tsne",
]
