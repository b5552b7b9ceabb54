"""Serving entry points: the model-inference REST server (bucketed,
pipelined ParallelInference behind POST /predict, plus the
continuous-batching autoregressive decode engine behind POST
/generate), and ParallelInference itself (parallel/). The k-NN server
waits for clustering/."""

from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
from deeplearning4j_tpu_torch.serving.inference_server import InferenceServer

__all__ = ["DecodeEngine", "InferenceServer"]
