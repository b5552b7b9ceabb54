"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

A second package beside the JAX one, with the same layout and module
names, held against it on the same inputs. Plain tensor code is PyTorch;
every Pallas kernel of a ported slice is a CUDA kernel written by hand
for Hopper (`csrc/`, built at first use by ops/cuda_build.py). Entry
points run on the GPU unless the caller passes device="cpu".

Ported so far: char-LSTM serving and training, ResNet-50 training,
LeNet, VGG16 through the Keras importer, layerwise pretraining and
transfer learning — the conf DSL and its JSON (graphs included), every
layer conf's forward, `MultiLayerNetwork` inference and `fit` with
truncated BPTT, `ComputationGraph` training and inference (losses,
updaters, data iterators, MNIST, listeners), and the
continuous-batching decode engine, the model zip (both packages load
each other's), checkpointing with mid-epoch resume, evaluation and early
stopping, with every kernel of the JAX package: the fused LSTM step, sequence and sequence-backward kernels,
and the conv + BN-statistics, BN apply and BN backward kernels; and the
divergence sentinel (quarantine and checkpoint rollback), the
line-search solvers, the gradient check, the DL4J-format zip importer,
and the record, streaming and CIFAR/Iris/LFW data iterators; and the
embeddings stack — Word2Vec, ParagraphVectors, GloVe and the serializer
(`nlp/`), DeepWalk and node2vec (`graph/`), and the native corpus
pipeline (`native/`, built with g++ at first use) — whose device math
is PyTorch ops, as the JAX package's is XLA ops; scale-out on
`torch.distributed` (`parallel/`); and the serving front end — the
bucketed, load-shedding `ParallelInference`, the self-healing
`ReplicaPool` and the REST `InferenceServer` (`/predict`, `/generate`).
"""

__version__ = "0.1.0"

import logging as _logging

# library code logs to the package logger and never configures handlers
_logging.getLogger("deeplearning4j_tpu_torch").addHandler(_logging.NullHandler())
