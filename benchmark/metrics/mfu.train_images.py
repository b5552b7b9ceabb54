"""mfu.train_images: model FLOPs (3 x the forward's, counts from the
reference's shapes) of the images trained a second over the timed window,
as a % of the card's peak in the configuration's precision."""

from benchmark.readers import mfu


def read(reading):
    return mfu(reading)
