"""mfu.train_tokens: model FLOPs (3 x the forward's) of the tokens trained
a second over the timed window, as a % of the card's peak in the
configuration's precision (float32 with TF32 off: the non-tensor rate)."""

from benchmark.readers import mfu


def read(reading):
    return mfu(reading)
