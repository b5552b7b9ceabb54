"""lstm_roofline.train: the LSTM sequence family's share of its roofline
in the profiled training window (families/lstm_seq.json,
counts/lstm_seq.py)."""

from benchmark.readers import roofline


def read(reading):
    return roofline(reading, "lstm_seq")
