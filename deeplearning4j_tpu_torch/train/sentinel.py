"""The divergence sentinel and its quarantine and rollback policy, the
port of the JAX package's train/sentinel.py.

A NaN/Inf loss or an exploding gradient corrupts every parameter from
that step on without tripping any crash guard. The loop:

* **Detect**: every optimizer step leaves `net._step_diag`, the 2-vector
  [loss, raw global gradient norm] on the device (nn/netbase.py `_step`;
  a fused TBPTT batch leaves [last loss, largest norm] over its
  segments). While a sentinel is attached the norm covers every leaf,
  frozen ones included, as the JAX step's does.
* **Classify (host)**: `DivergenceSentinel.judge` reads that vector with
  one device-to-host copy and marks the step ok / `nonfinite_loss` /
  `grad_norm_spike` (norm > k x the rolling median of recent healthy
  steps). Each anomaly lands in `train_anomaly_total{kind}`, the flight
  recorder and an SN001 finding; the norm is the `train_grad_norm` gauge.
* **Quarantine**: an anomalous step's parameters, layer state and updater
  state are put back. The port's updater adds its deltas in place, so
  `pre_step` copies those tensors on the device, before the dispatch,
  into undo buffers the sentinel keeps (one multi-tensor copy), and
  `post_step` copies them back INTO the same tensors: a captured CUDA
  graph reads fixed addresses, so the next replay trains the restored
  values without a re-capture. The offending batch is recorded
  (epoch position and content digest), so a replay after a rollback
  skips it (`quarantined_batches_total{action}`).
* **Rollback**: `rollback_after` consecutive anomalies raise
  `RollbackSignal`; the fit loop restores the last good checkpoint
  through the `fit(resume_from=)` machinery (digest-verified, finite, not
  saved during a quarantined step), with an optional learning-rate
  backoff. Past `max_rollbacks` the run raises `TrainingDivergedError`
  carrying the flight-recorder dump path.

Off-path contract: with no sentinel attached the fit loop pays one
attribute read per dispatch (`pre_step` returns at once), pinned under
10 µs by a test. With one attached, each judged step waits for its own
diagnostic, and `set_fused_steps` groups run batch by batch.

The `nan` fault kind (utils/faultpoints, point `train_step`) taints a
chosen batch's features through the real dispatch path, so the whole loop
replays deterministically.
"""

from __future__ import annotations

import hashlib
import logging
import math
import statistics
import weakref
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import tracing as _tracing

logger = logging.getLogger("deeplearning4j_tpu_torch")

OK = "ok"
NONFINITE_LOSS = "nonfinite_loss"
GRAD_NORM_SPIKE = "grad_norm_spike"

_MAX_FINDINGS = 64


class TrainingDivergedError(RuntimeError):
    """Training diverged past what quarantine and rollback could repair
    (or no checkpoint existed to roll back to). `.dump_path` names the
    flight-recorder dump written at raise time: the anomalous steps'
    scores, the quarantine and rollback event trail, and the grad-norm
    trajectory leading in."""

    def __init__(self, message: str, dump_path: Optional[str] = None):
        super().__init__(message)
        self.dump_path = dump_path


class RollbackSignal(Exception):
    """Internal control flow: the sentinel asks the fit loop to restore
    the last good checkpoint. Never escapes `fit()`: the loop answers it
    or converts it to TrainingDivergedError."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def batch_digest(ds) -> Optional[str]:
    """Content digest of a batch's (first) feature array, the
    position-independent half of a quarantine record, so that a shuffled
    replay still recognizes a poisoned batch. A tensor on the card is
    copied to the host first, so the digest (and its dtype string,
    numpy's) does not depend on where the batch lives. None when the
    features cannot be hashed (position matching still works)."""
    try:
        feats = getattr(ds, "features", None)
        if isinstance(feats, (list, tuple)):
            feats = feats[0] if feats else None
        if feats is None:
            return None
        a = feats.detach().cpu().numpy() if torch.is_tensor(feats) \
            else np.asarray(feats)
        h = hashlib.blake2b(digest_size=16)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()
    except Exception:
        return None


class DivergenceSentinel:
    """Host-side policy over the step's (loss, grad-norm) diagnostic.

    grad_norm_factor: a step whose global grad norm exceeds this multiple
        of the rolling median of recent healthy steps is anomalous.
    window / min_history: rolling-median width, and how many healthy
        steps must be seen before spike judgment engages.
    rollback_after: this many CONSECUTIVE anomalous steps escalate from
        per-step quarantine to a checkpoint rollback.
    max_rollbacks: bounded attempts per fit; exceeding it raises
        TrainingDivergedError.
    lr_backoff: optional factor (<1) applied to the configuration's
        learning rate on every rollback.
    checkpoint_dir: where rollback restores from. None = the fit's
        resume_from directory or an attached CheckpointListener's;
        still None disables rollback, so `rollback_after` consecutive
        anomalies raise directly.
    digest_window: how many batch checks after an anomaly keep content
        digest matching armed (each batch hashed to recognize a
        quarantined batch that moved); position matching stays on
        forever. 0 disables hashing.
    on_event: optional callable(kind, payload) mirror of every emitted
        event.
    """

    def __init__(self, *, grad_norm_factor: float = 10.0,
                 window: int = 64, min_history: int = 8,
                 rollback_after: int = 3, max_rollbacks: int = 2,
                 lr_backoff: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 digest_window: int = 1024,
                 on_event: Optional[Callable] = None):
        self.grad_norm_factor = float(grad_norm_factor)
        self.window = max(4, int(window))
        self.min_history = max(2, int(min_history))
        self.rollback_after = max(1, int(rollback_after))
        self.max_rollbacks = max(0, int(max_rollbacks))
        self.lr_backoff = None if lr_backoff is None else float(lr_backoff)
        self.checkpoint_dir = checkpoint_dir
        self.digest_window = max(0, int(digest_window))
        self.on_event = on_event
        self._bound_dir: Optional[str] = None
        self._bound_net = None  # weakref: which net this run's state is for
        # pre_step's undo buffers, one per parameter, layer-state and
        # updater-state tensor of the bound net
        self._undo: List = []
        self._norms: deque = deque(maxlen=self.window)
        self.streak = 0
        self.anomalies = 0
        self.quarantined = 0
        self.rollbacks = 0
        self.findings: List = []
        # quarantine records: {"epoch", "batch_in_epoch", "digest",
        # "anomaly", "iteration"}, consulted by the fit loop's replay skip
        self.records: List[dict] = []
        # iterations whose updates were DISCARDED: a checkpoint a
        # listener captured during the anomalous dispatch (before the
        # judgment) carries exactly those; the rollback rejects them
        self.tainted_iterations: set = set()
        # content-digest matching runs for this many more batch checks
        # (re-armed by every quarantine or match)
        self._digest_checks_left = 0
        reg = _metrics.get_registry()
        self._m_anomaly = _anomaly_counter()
        self._m_quarantine = _quarantine_counter()
        self._m_rollback = reg.counter(
            "train_rollback_total",
            "checkpoint rollbacks triggered by consecutive anomalous "
            "steps").labels()
        self._m_gnorm = reg.gauge(
            "train_grad_norm",
            "global gradient norm of the last judged optimizer step "
            "(read with the score)").labels()

    # -- wiring ---------------------------------------------------------------

    def bind(self, net, resume_dir: Optional[str] = None):
        """Fit-start wiring: resolve the rollback directory (explicit >
        fit resume_from > an attached CheckpointListener) and reset the
        per-fit escalation state. Attaching to a DIFFERENT net clears
        the run-scoped state (quarantine records, tainted iterations,
        grad-norm history): another run's batch positions would
        otherwise match and drop this run's batches."""
        prev = self._bound_net() if self._bound_net is not None else None
        if prev is not net:
            self.records.clear()
            self.tainted_iterations.clear()
            self._norms.clear()
            self._digest_checks_left = 0
            self._undo = []
            self._bound_net = weakref.ref(net)
        d = self.checkpoint_dir or resume_dir
        if d is None:
            from deeplearning4j_tpu_torch.train.checkpoint import (
                CheckpointListener,
            )

            for lst in getattr(net, "listeners", ()):
                if isinstance(lst, CheckpointListener):
                    d = lst.dir
                    break
        self._bound_dir = d
        self.streak = 0
        self.rollbacks = 0
        return self

    @property
    def rollback_dir(self) -> Optional[str]:
        return self.checkpoint_dir or self._bound_dir

    def undo_buffers(self, live: List) -> List:
        """Device buffers shaped like `live` (kept across steps; made
        anew when the tensors' shapes, dtypes or devices change)."""
        if len(self._undo) != len(live) or any(
                b.shape != t.shape or b.dtype != t.dtype or b.device != t.device
                for b, t in zip(self._undo, live)):
            self._undo = [torch.empty_like(t) for t in live]
        return self._undo

    def _emit(self, event: str, **payload):
        _blackbox.get_recorder().record_event(event, **payload)
        _tracing.instant(f"sentinel/{event}", **{
            k: v for k, v in payload.items()
            if isinstance(v, (str, int, float))})
        if self.on_event is not None:
            try:
                self.on_event(event, payload)
            except Exception:
                logger.warning("sentinel on_event hook failed",
                               exc_info=True)

    def _finding(self, severity: str, location: str, message: str,
                 fix_hint: str):
        from deeplearning4j_tpu_torch.analysis.findings import Finding

        if len(self.findings) < _MAX_FINDINGS:
            self.findings.append(Finding(
                code="SN001", severity=severity, location=location,
                message=message, fix_hint=fix_hint))

    # -- classification -------------------------------------------------------

    def judge(self, net) -> str:
        """Classify the step the net just ran. Reads `net._step_diag`
        ([loss, grad_norm]) with ONE device-to-host copy; a path with no
        diagnostic (the line-search solvers) is judged on the score's
        finiteness alone."""
        diag = getattr(net, "_step_diag", None)
        if diag is not None:
            vals = (diag.detach().cpu().numpy() if torch.is_tensor(diag)
                    else np.asarray(diag))
            loss, gnorm = float(vals[0]), float(vals[1])
        else:
            score = net._score
            if score is None:
                return OK
            loss, gnorm = float(score), None
        if gnorm is not None and math.isfinite(gnorm):
            self._m_gnorm.set(gnorm)
        step = int(net.iteration) - 1
        if not math.isfinite(loss) or (
                gnorm is not None and not math.isfinite(gnorm)):
            kind = NONFINITE_LOSS
            detail = f"loss={loss!r} grad_norm={gnorm!r}"
        elif (gnorm is not None and len(self._norms) >= self.min_history
                and gnorm > self.grad_norm_factor
                * statistics.median(self._norms)):
            kind = GRAD_NORM_SPIKE
            detail = (f"grad_norm={gnorm:.6g} > {self.grad_norm_factor:g}x "
                      f"rolling median {statistics.median(self._norms):.6g}")
        else:
            if gnorm is not None:
                self._norms.append(gnorm)
            self.streak = 0
            return OK
        self.streak += 1
        self.anomalies += 1
        self._m_anomaly.labels(kind).inc()
        self._emit("train_anomaly", anomaly=kind, step=step,
                   streak=self.streak, detail=detail)
        self._finding(
            "warning", f"step:{step}",
            f"anomalous optimizer step ({kind}): {detail}",
            "the step was quarantined; persistent anomalies roll back "
            "to the last-good checkpoint (lower the learning rate or "
            "inspect the quarantined batches if this recurs)")
        logger.warning("sentinel: anomalous step %d (%s): %s "
                       "(consecutive: %d)", step, kind, detail, self.streak)
        return kind

    # -- quarantine / escalation ----------------------------------------------

    def quarantine(self, net, batches, kind: str, tainted=None):
        """Record the offending batch(es), so that the replay after a
        rollback skips them, and taint the discarded iteration range, so
        that a checkpoint a listener saved DURING the anomalous dispatch
        is never "last good". Called by `post_step` after it restored
        the pre-step tensors."""
        ts = net._train_state or {}
        if tainted is not None:
            self.tainted_iterations.update(tainted)
        self._digest_checks_left = self.digest_window
        n = len(batches) if batches else 1
        pos0 = int(ts.get("batch_in_epoch", 0)) - n
        for i in range(n):
            ds = batches[i] if batches else None
            rec = {
                "epoch": int(ts.get("epoch", net.epoch)),
                "batch_in_epoch": pos0 + i,
                "digest": None if ds is None else batch_digest(ds),
                "anomaly": kind,
                "iteration": int(net.iteration),
            }
            self.records.append(rec)
            self.quarantined += 1
            self._m_quarantine.labels("quarantined").inc()
            self._emit("batch_quarantined", **rec)
            logger.warning(
                "sentinel: quarantined batch %d of epoch %d (%s); step "
                "update discarded", rec["batch_in_epoch"], rec["epoch"],
                kind)

    def should_skip_batch(self, net, ds) -> bool:
        """The replay half of quarantine: does this batch match a
        quarantine record (epoch position, or content digest when the
        order changed)? The fit loop consumes a match without
        dispatching it."""
        if not self.records:
            return False
        ts = net._train_state or {}
        pos = (int(ts.get("epoch", net.epoch)),
               int(ts.get("batch_in_epoch", 0)))
        # hashing pulls the features to the host, so it runs only for
        # digest_window checks after the latest anomaly or match;
        # position matching covers the steady state
        hash_ok = self._digest_checks_left > 0
        if hash_ok:
            self._digest_checks_left -= 1
        dg = None
        for rec in self.records:
            if (rec["epoch"], rec["batch_in_epoch"]) == pos:
                matched = rec
                break
            if hash_ok and rec["digest"] is not None:
                if dg is None:
                    dg = batch_digest(ds)
                if dg is not None and dg == rec["digest"]:
                    matched = rec
                    break
        else:
            return False
        self._digest_checks_left = self.digest_window
        self._m_quarantine.labels("replay_skipped").inc()
        self._emit("quarantined_batch_skipped", epoch=pos[0],
                   batch_in_epoch=pos[1], anomaly=matched["anomaly"])
        logger.info("sentinel: skipping quarantined batch %d of epoch %d "
                    "on replay", pos[1], pos[0])
        return True

    def escalate(self, net) -> None:
        """After a quarantine: decide whether the anomaly streak warrants
        a rollback. Raises RollbackSignal (the loop restores the last
        good checkpoint) or TrainingDivergedError (nowhere to restore
        from)."""
        if self.streak < self.rollback_after:
            return
        self.streak = 0
        if self.rollback_dir is None:
            self.diverged(
                f"{self.rollback_after} consecutive anomalous steps and "
                f"no checkpoint directory to roll back to (attach a "
                f"CheckpointListener or set checkpoint_dir)")
        raise RollbackSignal(
            f"{self.rollback_after} consecutive anomalous steps")

    def note_rollback(self, net) -> str:
        """Account one rollback attempt (bounded). Returns the directory
        to restore from; raises TrainingDivergedError past the budget."""
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            self.diverged(
                f"training still diverging after {self.max_rollbacks} "
                f"checkpoint rollback(s)")
        self._m_rollback.inc()
        if self.lr_backoff is not None:
            old = net.net_conf.learning_rate
            net.net_conf.learning_rate = old * self.lr_backoff
            logger.warning("sentinel: learning-rate backoff %.3g -> %.3g",
                           old, net.net_conf.learning_rate)
        self._emit("train_rollback", attempt=self.rollbacks,
                   directory=self.rollback_dir,
                   lr=float(net.net_conf.learning_rate))
        logger.warning(
            "sentinel: rolling back to the last-good checkpoint in %r "
            "(attempt %d/%d)", self.rollback_dir, self.rollbacks,
            self.max_rollbacks)
        return self.rollback_dir

    def diverged(self, why: str):
        """Terminal: dump the flight recorder and raise the diagnosable
        error."""
        dump = _blackbox.get_recorder().dump(
            reason=f"training diverged: {why}")
        self._emit("training_diverged", why=why, dump=dump)
        self._finding(
            "error", "fit", f"training diverged: {why}",
            "inspect the dump's grad-norm/score trail; lower the "
            "learning rate, check the input data, or raise "
            "max_rollbacks")
        raise TrainingDivergedError(
            f"training diverged: {why} (forensics: {dump})",
            dump_path=dump)


def _anomaly_counter():
    return _metrics.get_registry().counter(
        "train_anomaly_total",
        "optimizer steps the divergence sentinel classified as "
        "anomalous (the ONE numerical-failure detection path — "
        "early stopping's invalid-score condition counts here too)",
        ("kind",))


def _quarantine_counter():
    return _metrics.get_registry().counter(
        "quarantined_batches_total",
        "batches whose optimizer step was discarded by the divergence "
        "sentinel (`quarantined`) or skipped on post-rollback replay "
        "(`replay_skipped`)", ("action",))


# -- fit-loop hooks (one attribute read when no sentinel is attached) ---------

def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _live(net) -> List:
    return list(_leaves((net.params_list, net.state_list, net.upd_state)))


def pre_step(net):
    """Called by nn/netbase `_timed_fit` BEFORE the dispatch. No sentinel:
    one attribute read and a None compare (the <10 µs off-path
    contract). With one: a device copy of the parameters, layer state
    and updater state into the sentinel's undo buffers (one multi-tensor
    copy queued on the current stream, so it reads what the previous
    step left), plus the iteration and the score. The step changes
    those tensors in place, so a reference is not an undo point."""
    if net._sentinel is None:
        return None
    live = _live(net)
    saved = net._sentinel.undo_buffers(live)
    with torch.no_grad():
        torch._foreach_copy_(saved, live)
    return saved, net.iteration, net._score


def post_step(net, pre, batches) -> Optional[str]:
    """Judge the dispatched step; on an anomaly undo it (copy the
    pre-step clones back into the live tensors, whose addresses a
    captured graph reads: every step changes them in place), quarantine
    the batch and let the sentinel escalate (RollbackSignal /
    TrainingDivergedError) when the streak reaches `rollback_after`."""
    sent = net._sentinel
    if sent is None or pre is None:
        return None
    kind = sent.judge(net)
    if kind == OK:
        return OK
    # a listener (CheckpointListener) may have SAVED during the anomalous
    # dispatch, before this judgment: those saves carry the discarded
    # update, so taint their iterations for the rollback
    saved, iteration, score = pre
    tainted = range(int(iteration) + 1, int(net.iteration) + 1)
    with torch.no_grad():
        torch._foreach_copy_(_live(net), saved)
    net.iteration, net._score = iteration, score
    net._step_diag = None
    net._last_stats = None
    sent.quarantine(net, batches, kind, tainted=tainted)
    sent.escalate(net)
    return kind


# -- the ONE invalid-score detection path -------------------------------------

def check_score(iteration: int, score: float,
                origin: str = "earlystopping") -> bool:
    """Shared non-finite-score check: True when `score` is NaN/Inf,
    counted under `train_anomaly_total{kind="nonfinite_loss"}` with a
    flight-recorder event, so that early stopping's
    InvalidScoreIterationTerminationCondition and the in-fit sentinel
    report through the same books."""
    try:
        finite = math.isfinite(float(score))
    except (TypeError, ValueError):
        finite = False
    if finite:
        return False
    _anomaly_counter().labels(NONFINITE_LOSS).inc()
    _blackbox.get_recorder().record_event(
        "train_anomaly", anomaly=NONFINITE_LOSS, step=int(iteration),
        origin=origin, detail=f"score={score!r}")
    logger.warning("%s: non-finite score %r at iteration %d", origin,
                   score, iteration)
    return True
