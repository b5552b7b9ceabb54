"""data_wait_ms.images: the time the fit loop waited on its input pipeline
before a dispatch, in ms: the mean of `fit_data_wait_seconds` (the
pipeline of data/iterators.py and data/prefetch.py) over the timed
window."""

from benchmark.readers import mean_ms


def read(reading):
    return mean_ms(reading, "fit_data_wait_seconds")
