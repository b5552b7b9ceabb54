"""What a per-layer metric's reader reads, and the arithmetic the readers
share.

A driver fills one `Reading` per run; each file in metrics/ defines
`read(reading)` and returns a number or None. None means the reader
found nothing to read in this cell, and the metric is left out of the
line: a share of a roofline or of a peak is never reported as 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from benchmark import peaks


class Reading:
    def __init__(self, *, spec, cfg, traffic, ref, device_name: str):
        self.spec = spec
        self.cfg = cfg
        self.traffic = traffic
        self.ref = ref
        self.device_name = device_name
        # the main (untraced) window
        self.rate: Optional[float] = None          # samples/s
        self.flops_per_sample: Optional[float] = None
        self.registry: Dict[str, tuple] = {}       # histogram: (count, sum) over the window
        # the profiled window after it
        self.trace = None                          # trace.Trace
        self.units: List[dict] = []                # the work units it ran

    def peak(self) -> Optional[float]:
        return peaks.flops_peak(self.device_name, self.cfg["precision"])


def itemsize(cfg) -> int:
    return {"bf16": 2, "fp16": 2, "f32": 4}[cfg["precision"]]


def mean_ms(reading: Reading, histogram: str) -> Optional[float]:
    """Mean of a registry histogram over the window, in ms."""
    n, s = reading.registry.get(histogram, (0, 0.0))
    return None if n <= 0 else 1e3 * s / n


def mfu(reading: Reading) -> Optional[float]:
    """Model FLOPs a second over the window's samples, as a % of the
    card's peak in the configuration's precision."""
    peak = reading.peak()
    if reading.trace is None or peak is None or not reading.rate or not reading.flops_per_sample:
        return None
    return 100.0 * reading.rate * reading.flops_per_sample / peak


def device_idle(reading: Reading) -> Optional[float]:
    t = reading.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(reading: Reading, family: str) -> Optional[float]:
    """The family's share of its roofline in the profiled window: the
    least time its work needs (each instance's larger of FLOPs over the
    precision's peak and bytes over HBM's), summed over the window's
    units, over the device time of its kernels. None where no kernel of
    the family ran or the card's peaks are unknown."""
    t = reading.trace
    fams = reading.spec.families()
    if t is None or family not in fams:
        return None
    secs = t.family_seconds(fams[family]["patterns"])
    peak, hbm = reading.peak(), peaks.hbm_peak(reading.device_name)
    if secs <= 0 or peak is None or hbm is None:
        return None
    counts = reading.spec.module("counts", fams[family]["counts"])
    size = itemsize(reading.cfg)
    bound = 0.0
    for unit in reading.units:
        for flops, nbytes in counts.work(reading.cfg, reading.ref, unit, size):
            bound += max(flops / peak, nbytes / hbm)
    if bound <= 0:
        return None
    return 100.0 * bound / secs


def evaluate(spec, cell_name: str, reading: Reading) -> Dict[str, float]:
    """Every per-layer metric of the cell that its reader finds something
    to read for, by name."""
    out = {}
    for m in spec.metrics_for(cell_name, trace=True):
        v = spec.reader(m["name"]).read(reading)
        if v is not None:
            out[m["name"]] = float(v)
    return out
