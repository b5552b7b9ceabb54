"""ssd_roofline.train: the SSD scan family's share of its roofline in the
profiled training window (families/ssd_scan.json, counts/ssd_scan.py)."""

from benchmark.readers import roofline


def read(reading):
    return roofline(reading, "ssd_scan")
