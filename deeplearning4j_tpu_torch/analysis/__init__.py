"""Analysis records (the port of the JAX package's analysis/): so far the
`Finding` record the divergence sentinel reports through."""

from deeplearning4j_tpu_torch.analysis.findings import Finding

__all__ = ["Finding"]
