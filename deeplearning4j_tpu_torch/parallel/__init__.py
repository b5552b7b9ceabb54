"""Scale-out: data, tensor, sequence and pipeline parallelism, and the
serving-side request types shared by the serving tiers.

The port of the JAX package's parallel/ on `torch.distributed`, one
process a device: a `Mesh` of ranks with a process group per axis
(`mesh`), the data-parallel step's plan (`sharded`: batch sharding and the
bucketed gradient all-reduce, with global batch-norm statistics in the
layers), the deprecated `ParallelWrapper` facade, the multi-host entry
point (`multihost`), tensor parallelism (`tensor`), GPipe pipeline
parallelism (`pipeline`) and ring-attention sequence parallelism
(`sequence`), and the serving pool: ParallelInference with shape buckets
and load shedding, and the self-healing ReplicaPool (`inference`).
"""

from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExceeded,
    InferenceMode,
    ParallelInference,
    ReplicaPool,
    RequestRejected,
    RequestValidationError,
    power_of_two_buckets,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharded,
    data_parallel_mesh,
    data_shards,
    mesh_2d,
    n_devices,
    replicated,
)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_parallel_mesh,
    shard_stage_params,
)
from deeplearning4j_tpu_torch.parallel.sharded import MeshPlan, auto_mesh_enabled
from deeplearning4j_tpu_torch.parallel.tensor import shard_params_tp, tp_dense_specs
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

__all__ = [
    "pipeline_apply",
    "pipeline_parallel_mesh",
    "shard_stage_params",
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharded",
    "data_parallel_mesh",
    "data_shards",
    "mesh_2d",
    "n_devices",
    "replicated",
    "MeshPlan",
    "auto_mesh_enabled",
    "ParallelWrapper",
    "ParallelInference",
    "ReplicaPool",
    "InferenceMode",
    "RequestValidationError",
    "RequestRejected",
    "DeadlineExceeded",
    "power_of_two_buckets",
    "shard_params_tp",
    "tp_dense_specs",
]
