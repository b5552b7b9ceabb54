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
`ReplicaPool` and the REST `InferenceServer` (`/predict`, `/generate`);
the parameter-server path and the run ledger; and device observability
and static analysis — the model doctor (`analysis/shapeflow.py`,
`net.doctor()`, the importers' preflight), the step cost model and its
audit on fake tensors (`analysis/costmodel.py`, `analysis/graph_audit.py`),
the conv kernels' coverage table with the routing's economic stage as
its plan (`analysis/kernelcoverage.py`), the sampled device profiler with OOM
forensics (`utils/devprof.py`) and the torch.profiler family summary
(`utils/profiler.py`); the training UI and the clustering stack (`ui/`,
`clustering/`, `serving/knnserver.py`, `keras_backend.py`); and the
operator CLI (`cli.py`, `python -m deeplearning4j_tpu_torch.cli`, 19
subcommands, `--device cpu` to run off the GPU) with the lock audit: the
runtime lock-order sanitizer (`utils/locktrace.py`, armed by
`DL4J_LOCKCHECK=1`), the concurrency lint (`analysis/lint.py`), their
merge (`analysis/concurrency_audit.py`) and the trace critical-path
readout (`analysis/tracecrit.py`). Every module of the JAX package has a
counterpart here.
"""

__version__ = "0.1.0"

import logging as _logging

# library code logs to the package logger and never configures handlers
_logging.getLogger("deeplearning4j_tpu_torch").addHandler(_logging.NullHandler())


def configure_logging(level=_logging.INFO, json_lines: bool = False,
                      stream=None):
    """Opt-in log output for applications and CLIs.

    Plain mode attaches a conventional stderr handler. `json_lines=True`
    emits one JSON object per record (ts/level/logger/message, plus
    `trace_id`/`span_id` — the active distributed-tracing context when a
    span is open on the logging thread, empty strings otherwise — so one
    trace id greps across logs, span exports, flight-recorder dumps and
    histogram exemplars) so log aggregators get structured records
    without a parsing layer. Calling again replaces the handler installed
    by the previous call (idempotent — safe from notebooks/REPLs)."""
    import json as _json
    import time as _time

    from deeplearning4j_tpu_torch.utils import tracing as _tracing

    logger = _logging.getLogger("deeplearning4j_tpu_torch")
    for h in list(logger.handlers):
        if getattr(h, "_dl4j_tpu_configured", False):
            logger.removeHandler(h)
    handler = _logging.StreamHandler(stream)
    if json_lines:
        class _JsonFormatter(_logging.Formatter):
            def format(self, record):
                # format() runs on the emitting thread, so the active
                # span context here IS the one the message belongs to
                ctx = _tracing.current_context()
                doc = {
                    "ts": round(record.created, 3),
                    "iso": _time.strftime(
                        "%Y-%m-%dT%H:%M:%S",
                        _time.gmtime(record.created)) + "Z",
                    "level": record.levelname,
                    "logger": record.name,
                    "message": record.getMessage(),
                    "trace_id": ctx.trace_id if ctx is not None else "",
                    "span_id": (format(ctx.span_id, "016x")
                                if ctx is not None else ""),
                }
                if record.exc_info:
                    doc["exc"] = self.formatException(record.exc_info)
                return _json.dumps(doc)

        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(_logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    handler._dl4j_tpu_configured = True
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger


import os as _os

if _os.environ.get("DL4J_LOCKCHECK", "") == "1":
    # arm the lock-order sanitizer BEFORE any framework module runs its
    # module-level lock constructions (utils.metrics, utils.health) so
    # those locks are traced too; off-path cost is zero — the import
    # below is what patches, and it only happens under the env flag
    from deeplearning4j_tpu_torch.utils import locktrace as _locktrace  # noqa: F401
