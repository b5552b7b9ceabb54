"""Serving entry points: the model-inference REST server (bucketed,
pipelined ParallelInference behind POST /predict, plus the
continuous-batching autoregressive decode engine behind POST
/generate), ParallelInference itself (parallel/), and the REST k-NN
server over a VPTree (clustering/)."""

from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
from deeplearning4j_tpu_torch.serving.inference_server import InferenceServer
from deeplearning4j_tpu_torch.serving.knnserver import NearestNeighborsServer

__all__ = ["DecodeEngine", "InferenceServer", "NearestNeighborsServer"]
