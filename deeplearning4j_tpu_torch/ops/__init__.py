"""Tensor-op surface: activations, the helper SPI, and the hand-written
CUDA kernels behind it."""

from deeplearning4j_tpu_torch.ops.activations import Activation, activation_fn, register_activation
from deeplearning4j_tpu_torch.ops.helpers import (
    HelperError,
    get_helper,
    helper_names,
    register_helper,
    set_helper_enabled,
)
from deeplearning4j_tpu_torch.ops import fused_conv_bn, fused_lstm  # noqa: F401  (register their helpers)
