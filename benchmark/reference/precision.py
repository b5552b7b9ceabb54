"""Precision switches of the plain references: the float32 reference with
TF32 off, and the controls one step below a configuration's precision.

- `exact_f32()`: a context with cuBLAS's and cuDNN's TF32 off, so every
  float32 matmul and convolution keeps float32 (the reference's own
  precision), restored on exit. Every reference and control runs in it.
- `tf32_quant`: rounds a matmul's operands (and the gradients that flow
  back through them) to TF32's 10 mantissa bits: the control of a
  float32 configuration with TF32 off, as the tensor cores' TF32 path
  computes it, accumulating in float32, and the same on the CPU.
- `fp8_quant`: rounds a conv's or matmul's operands to float8 (e4m3 in
  the forward, e5m2 for the gradient that flows back), each tensor scaled
  to the format's range by its largest magnitude: the control of a bf16
  configuration, as an fp8 tensor-core path with per-tensor scales would
  compute it, accumulating in float32.

Imports torch only.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """cuBLAS's and cuDNN's TF32 off inside, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, fmax / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest."""
    i = x.detach().float().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return r


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32_round(g)


def tf32_quant(x: torch.Tensor) -> torch.Tensor:
    return _Tf32.apply(x)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_quant(x: torch.Tensor) -> torch.Tensor:
    """Operands rounded to bfloat16: not a control, a witness of what a
    bf16 computation of the same reference gives (calibrate.py)."""
    return _Bf16.apply(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def quantizer(control: str):
    """The operand rounding of a control ("fp8" or "tf32"), or identity
    for the reference itself (control "")."""
    return {"fp8": fp8_quant, "tf32": tf32_quant, "bf16": bf16_quant, "": identity}[control]


# the control of each configuration precision: the nearest precision below
CONTROL_OF = {"bf16": "fp8", "fp16": "fp8", "f32": "tf32"}
