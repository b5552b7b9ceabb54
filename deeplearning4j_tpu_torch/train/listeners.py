"""Training listeners.

The port of the JAX package's train/listeners.py SPI and its
ScoreIterationListener (reference: optimize/api/IterationListener,
optimize/listeners/ScoreIterationListener). The callback receives a small
info dict; the score is read to the host only when a listener asks for
it, so listeners do not force a device sync on every step. The other
listeners are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    """SPI (reference: optimize/api/IterationListener.java)."""

    def iteration_done(self, model, iteration: int, info: dict) -> None:
        raise NotImplementedError

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass

    def on_fit_end(self, model) -> None:
        """Called when the fit loop exits, also on an exception."""


class ScoreIterationListener(IterationListener):
    """Log the score every `frequency` iterations (reference:
    optimize/listeners/ScoreIterationListener.java)."""

    def __init__(self, frequency: int = 10, print_fn: Optional[Callable] = None):
        self.frequency = max(1, frequency)
        self.print_fn = print_fn or (lambda s: logger.info(s))

    def iteration_done(self, model, iteration, info):
        if iteration % self.frequency == 0:
            score = float(info["score"]())
            self.print_fn(f"Score at iteration {iteration} is {score}")
