"""device_idle.images: the share of the profiled window in which no kernel,
copy or memset ran on the card, in %."""

from benchmark.readers import device_idle


def read(reading):
    return device_idle(reading)
