"""input_stall_ms.tokens: the time the card's stream waited on a dispatch's
staged batch copies, in ms: the mean of `fit_input_stall_seconds` (the
port's utils/devprof: B - A of the timing events around the stream's wait on
each batch's copy, data/prefetch.py, summed over the dispatch's batches)
over the timed window."""

from benchmark import timeline
from benchmark.readers import mean_ms


def read(reading):
    timeline.fill(reading)
    return mean_ms(reading, "fit_input_stall_seconds")
