"""fit_dispatch_ms.tokens: the fit loop's host time a dispatch, in ms: the mean
of the registry histogram `fit_dispatch_seconds` (nn/netbase.py
`_timed_fit`: the step call, or a fused group's eager run, capture or
replay) over the timed window."""

from benchmark.readers import mean_ms


def read(reading):
    return mean_ms(reading, "fit_dispatch_seconds")
