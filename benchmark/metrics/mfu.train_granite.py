"""mfu.train_granite: model FLOPs (3 x the forward's, reference
granite4h.forward_flops_per_sample) of the tokens trained a second over
the timed window, as a % of the card's dense bf16 peak."""

from benchmark.readers import mfu


def read(reading):
    return mfu(reading)
