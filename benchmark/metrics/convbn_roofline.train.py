"""convbn_roofline.train: the conv + BN family's share of its roofline in
the profiled training window (families/convbn.json, counts/convbn.py)."""

from benchmark.readers import roofline


def read(reading):
    return roofline(reading, "convbn")
