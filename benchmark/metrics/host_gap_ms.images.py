"""host_gap_ms.images: the time the card waited for the host to enqueue a
dispatch, in ms: the mean of `fit_host_gap_seconds` (the port's
utils/devprof: S less the previous dispatch's E less the input stall; 0 for
a fit's first dispatch) over the timed window."""

from benchmark import timeline
from benchmark.readers import mean_ms


def read(reading):
    timeline.fill(reading)
    return mean_ms(reading, "fit_host_gap_seconds")
