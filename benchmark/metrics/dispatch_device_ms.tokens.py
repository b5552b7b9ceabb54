"""dispatch_device_ms.tokens: the card's time a fit dispatch, in ms: the mean
of `fit_device_seconds` (the port's utils/devprof: E - S of the timing
events recorded just before and just after each dispatch is enqueued) over
the timed window."""

from benchmark import timeline
from benchmark.readers import mean_ms


def read(reading):
    timeline.fill(reading)
    return mean_ms(reading, "fit_device_seconds")
