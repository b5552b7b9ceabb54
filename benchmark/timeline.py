"""The port's dispatch timeline over a training cell's timed window, for
the readers of the card's time, the input stall and the host gap a
dispatch (metrics/dispatch_device_ms.*, input_stall_ms.*, host_gap_ms.*).

On a CUDA net the port's device profiler (utils/devprof) brackets each
fit dispatch with timing events and resolves them, without waiting, into
one observation a dispatch of `fit_device_seconds`,
`fit_input_stall_seconds` and `fit_host_gap_seconds`, which it also sums
per fit (`devprof.recent_fits()`). Where the window's registry reading
(`reading.registry`, filled by drivers/train_fit.py) lacks these
histograms, `fill` takes them from the timed window's fit: the one whose
dispatches number the window's `fit_dispatch_seconds` observations. A
program without the timeline, and a CPU run, leave them out, and the
readers find nothing to read.
"""

from __future__ import annotations

# registry histogram: its sum in a fit of devprof.recent_fits()
HISTOGRAMS = {"fit_device_seconds": "device_seconds",
              "fit_input_stall_seconds": "input_stall_seconds",
              "fit_host_gap_seconds": "host_gap_seconds"}


def fill(reading) -> None:
    """Add the three histograms' (count, sum) over the timed window to
    `reading.registry`, where it lacks them and the program has them."""
    if all(h in reading.registry for h in HISTOGRAMS):
        return
    n = reading.registry.get("fit_dispatch_seconds", (0, 0.0))[0]
    if n <= 0:
        return
    from deeplearning4j_tpu_torch.utils import devprof

    recent = getattr(devprof, "recent_fits", None)
    if recent is None:  # a port without the dispatch timeline
        return
    window = [f for f in recent() if f["dispatches"] == n]
    if not window:
        return
    fit = window[-1]
    for h, key in HISTOGRAMS.items():
        reading.registry.setdefault(h, (fit["resolved"], fit[key]))
