"""The JAX package's analysis/jaxpr_audit.py under its own path.

The port audits the ops one optimizer step dispatches, traced once on
fake tensors, rather than a jaxpr: that audit is analysis/graph_audit.py
(the same JX001–JX005 codes, severities and finding names). This module
re-exports it, so code written against the JAX package's module path
runs on the port. JX006's `check_donation` has no counterpart: the
port's updater adds its deltas to the parameters in place, and nothing
is donated.
"""

from deeplearning4j_tpu_torch.analysis.graph_audit import (  # noqa: F401
    LARGE_CONST_BYTES,
    audit_fn,
    audit_network,
    audit_trace,
)

__all__ = ["LARGE_CONST_BYTES", "audit_fn", "audit_network", "audit_trace"]
