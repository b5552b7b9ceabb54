"""Early stopping: conditions, savers, score calculators, trainer.

Reference: deeplearning4j-nn/.../earlystopping/ — EarlyStoppingConfiguration
+ termination conditions (termination/), model savers (saver/), score
calculators (scorecalc/), and the trainer loop with per-iteration and
per-epoch checks + exception capture
(trainer/BaseEarlyStoppingTrainer.java:76-131). The port of the JAX
package's train/earlystopping.py; the file saver writes the port's model
zip (utils/model_serializer.py), which the JAX package also loads.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import List

logger = logging.getLogger("deeplearning4j_tpu_torch")


# -- termination conditions --------------------------------------------------

class EpochTerminationCondition:
    # conditions that read the score are only checked on epochs where a
    # fresh score was computed; score-free conditions (MaxEpochs, custom
    # wall-clock subclasses) run every epoch
    requires_score = True

    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, iteration: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs (reference: MaxEpochsTerminationCondition)."""

    requires_score = False

    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least this good (reference:
    BestScoreEpochTerminationCondition)."""

    def __init__(self, best_expected: float):
        self.best_expected = float(best_expected)

    def terminate(self, epoch, score):
        return score <= self.best_expected

    def __repr__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without (sufficient) improvement (reference:
    ScoreImprovementEpochTerminationCondition)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self.initialize()

    def initialize(self):
        self._best = None
        self._since = 0

    def terminate(self, epoch, score):
        if self._best is None or self._best - score > self.min_improvement:
            self._best = score
            self._since = 0
            return False
        self._since += 1
        return self._since >= self.patience

    def __repr__(self):
        return (f"ScoreImprovementEpochTerminationCondition("
                f"{self.patience}, {self.min_improvement})")


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Wall-clock budget (reference: MaxTimeIterationTerminationCondition)."""

    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self.initialize()

    def initialize(self):
        self._t0 = time.monotonic()

    def terminate(self, iteration, score):
        return time.monotonic() - self._t0 >= self.max_seconds

    def __repr__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort when the score exceeds a bound — divergence guard (reference:
    MaxScoreIterationTerminationCondition)."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, iteration, score):
        return score > self.max_score

    def __repr__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort on NaN/Inf score (reference:
    InvalidScoreIterationTerminationCondition).

    Detection routes through train/sentinel.check_score, the one
    non-finite classification path, so a termination here lands in the
    same books as an in-fit sentinel anomaly:
    `train_anomaly_total{kind="nonfinite_loss"}` plus a flight-recorder
    event."""

    def terminate(self, iteration, score):
        from deeplearning4j_tpu_torch.train import sentinel as _sentinel

        return _sentinel.check_score(iteration, score,
                                     origin="earlystopping")

    def __repr__(self):
        return "InvalidScoreIterationTerminationCondition()"


# -- model savers ------------------------------------------------------------

class InMemoryModelSaver:
    """Keep the best/latest model cloned in memory (reference:
    saver/InMemoryModelSaver.java)."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score):
        self._best = net.clone()

    def save_latest_model(self, net, score):
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """Persist best/latest model zips in a directory (reference:
    saver/LocalFileModelSaver.java — bestModel.bin/latestModel.bin). The
    loaders put the model on the device the saved net ran on."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        self.device = None  # the saved net's, set at save time
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.directory, name)

    def save_best_model(self, net, score):
        from deeplearning4j_tpu_torch.utils.model_serializer import save_model

        self.device = net.device
        save_model(net, self._path("bestModel.zip"))

    def save_latest_model(self, net, score):
        from deeplearning4j_tpu_torch.utils.model_serializer import save_model

        self.device = net.device
        save_model(net, self._path("latestModel.zip"))

    def get_best_model(self):
        from deeplearning4j_tpu_torch.utils.model_serializer import load_model

        return load_model(self._path("bestModel.zip"),
                          device=self.device or "cuda")

    def get_latest_model(self):
        from deeplearning4j_tpu_torch.utils.model_serializer import load_model

        return load_model(self._path("latestModel.zip"),
                          device=self.device or "cuda")


# -- score calculators -------------------------------------------------------

class DataSetLossCalculator:
    """Average loss over a held-out set (reference:
    scorecalc/DataSetLossCalculator.java). Works for MultiLayerNetwork and
    ComputationGraph (the reference needed a separate CG class)."""

    def __init__(self, data, average: bool = True):
        self.data = data
        self.average = average

    def calculate_score(self, net) -> float:
        from deeplearning4j_tpu_torch.data.iterators import DataSetIterator

        if isinstance(self.data, DataSetIterator):
            total, n = 0.0, 0
            for ds in self.data:
                s = net.score(ds)
                b = ds.num_examples()
                total += s * b
                n += b
            self.data.reset()
            if n == 0:
                return float("nan")
            return total / n if self.average else total
        return net.score(self.data)


# -- configuration + result --------------------------------------------------

@dataclasses.dataclass
class EarlyStoppingConfiguration:
    """Mirrors the reference's EarlyStoppingConfiguration.Builder fields."""

    score_calculator: object
    epoch_termination_conditions: List[EpochTerminationCondition] = dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = dataclasses.field(default_factory=list)
    model_saver: object = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


class TerminationReason:
    EPOCH_CONDITION = "epoch_termination_condition"
    ITERATION_CONDITION = "iteration_termination_condition"
    ERROR = "error"


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: object


class _IterationStop(Exception):
    def __init__(self, condition, score):
        self.condition = condition
        self.score = score


class _IterationConditionListener:
    """Fit listener evaluating iteration-level conditions on every step
    (reference: BaseEarlyStoppingTrainer checks inside the fit loop)."""

    def __init__(self, conditions):
        self.conditions = conditions

    def on_epoch_start(self, net, epoch):
        pass

    def on_epoch_end(self, net, epoch):
        pass

    def iteration_done(self, net, iteration, info):
        score = float(info["score"]())
        for c in self.conditions:
            if c.terminate(iteration, score):
                raise _IterationStop(c, score)


class EarlyStoppingTrainer:
    """Train with early stopping (reference:
    trainer/BaseEarlyStoppingTrainer.java:76-131; works for both network
    types because fit()/score()/clone() are the shared surface)."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_data,
                 labels=None, batch_size: int = 32):
        self.config = config
        self.net = net
        self.train_data = train_data
        self.labels = labels
        self.batch_size = batch_size

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        listener = (
            _IterationConditionListener(cfg.iteration_termination_conditions)
            if cfg.iteration_termination_conditions else None
        )
        if listener is not None:
            self.net.add_listener(listener)

        score_vs_epoch = {}
        best_score = None
        best_epoch = -1
        epoch = 0
        reason = TerminationReason.EPOCH_CONDITION
        details = ""
        try:
            while True:
                try:
                    self.net.fit(self.train_data, self.labels, epochs=1,
                                 batch_size=self.batch_size,
                                 async_prefetch=False)
                except _IterationStop as stop:
                    reason = TerminationReason.ITERATION_CONDITION
                    details = repr(stop.condition)
                    break
                last_score = None
                if (epoch % max(1, cfg.evaluate_every_n_epochs)) == 0:
                    last_score = float(
                        cfg.score_calculator.calculate_score(self.net)
                    )
                    score_vs_epoch[epoch] = last_score
                    if best_score is None or last_score < best_score:
                        best_score = last_score
                        best_epoch = epoch
                        cfg.model_saver.save_best_model(self.net, last_score)
                    if cfg.save_last_model:
                        cfg.model_saver.save_latest_model(self.net, last_score)
                # score-free epoch conditions run EVERY epoch (so MaxEpochs
                # cannot overshoot when evaluate_every_n_epochs > 1);
                # score-based conditions only where a fresh score exists
                stop_now = None
                for c in cfg.epoch_termination_conditions:
                    if c.requires_score and last_score is None:
                        continue  # don't re-judge a stale score
                    if c.terminate(epoch, last_score):
                        stop_now = c
                        break
                if stop_now is not None:
                    reason = TerminationReason.EPOCH_CONDITION
                    details = repr(stop_now)
                    break
                epoch += 1
        except Exception as e:  # capture, don't crash (reference :113)
            reason = TerminationReason.ERROR
            details = f"{type(e).__name__}: {e}"
        finally:
            if listener is not None and listener in self.net.listeners:
                self.net.listeners.remove(listener)

        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch + 1,
            best_model_epoch=best_epoch,
            best_model_score=best_score if best_score is not None else float("nan"),
            score_vs_epoch=score_vs_epoch,
            best_model=cfg.model_saver.get_best_model(),
        )
