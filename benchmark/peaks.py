"""Published peaks of the cards the benchmark runs on, per precision.

NVIDIA H100 data sheet, dense rates without sparsity, at the full power
limit (700 W for the SXM card, 350 W for PCIe). A run writes the card's
power limit beside the numbers priced with these. `f32` is the rate
outside the tensor cores (a float32 net with TF32 off, as the port's f32
policy sets it); `tf32` the tensor-core TF32 rate.

Looked up by a substring of `torch.cuda.get_device_name()`, first match
first: the PCIe card before the SXM default. A card that no row names
gets no peak, and every share of a peak is then left out of the line.
"""

from __future__ import annotations

from typing import Optional

# (name fragment, {precision: FLOP/s}, HBM bytes/s)
CARDS = (
    ("H100 PCIe", {"bf16": 756e12, "fp16": 756e12, "tf32": 378e12,
                   "f32": 51e12, "fp8": 1513e12}, 2.0e12),
    ("H100", {"bf16": 989e12, "fp16": 989e12, "tf32": 494.7e12,
              "f32": 67e12, "fp8": 1979e12}, 3.35e12),
)


def _row(device_name: str):
    for frag, flops, hbm in CARDS:
        if frag in (device_name or ""):
            return flops, hbm
    return None


def flops_peak(device_name: str, precision: str) -> Optional[float]:
    """The card's dense peak in `precision` ("bf16", "f32", ...)."""
    row = _row(device_name)
    return None if row is None else row[0].get(precision)


def hbm_peak(device_name: str) -> Optional[float]:
    row = _row(device_name)
    return None if row is None else row[1]
