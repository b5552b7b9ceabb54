"""Functional layer implementations.

Dispatch: conf dataclass type -> (init_params, forward) via the registry in
registry.py. Param dicts use the JAX package's names and order, so the
flattened parameter view is the same vector in both packages.
"""

from deeplearning4j_tpu_torch.nn.layers.registry import (
    forward_layer,
    init_layer_params,
    init_layer_state,
    param_order,
)

# Import impl modules for their registration side effects.
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: E402,F401
    attention,
    conv,
    core,
    lm,
    norm,
    rbm,
    recurrent,
    special,
    ssm,
)
