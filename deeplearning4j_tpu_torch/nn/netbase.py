"""Shared network machinery, the port of the JAX package's nn/netbase.py:
lazy init, the shape-keyed forward cache with its counter, the flattened
parameter view (params()/setParams(), reference:
MultiLayerNetwork.java:102-104 flattenedParams), listeners, and the fit
loop (`_run_fit` -> `_fit_epochs` -> `_timed_fit` -> the subclass's
`_fit_dataset`) with its registry instruments, heartbeat, spans, fault
point and flight-recorder step record, mid-epoch resume from a checkpoint
directory (`train_state`, `_restore_for_resume`, the skip-replay in
`_fit_epochs`), and the eager optimizer step both networks share
(`_run_step` -> `_step`: autograd, the gradient tail and the updater).
The divergence sentinel, mesh, fused multi-batch steps, run ledger, OOM
forensics and the staged prefetch pipeline are not ported yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.params import (
    flat_to_params,
    num_params,
    param_table,
    params_to_flat,
)
from deeplearning4j_tpu_torch.train.updaters import normalize_gradients, schedule_lr
from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import faultpoints as _faults
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import sigchain as _sigchain
from deeplearning4j_tpu_torch.utils import tracing as _tracing

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _regularizable(name: str) -> bool:
    """Weight-style params get l1/l2; biases and batchnorm affine params do
    not (reference: each ParamInitializer flags regularizable params)."""
    if name in ("gamma", "beta"):
        return False
    return name.rsplit("_", 1)[-1] in ("W", "RW", "pI", "pF", "pO")


def _detached(states):
    return [None if st is None else {k: v.detach() for k, v in st.items()}
            for st in states]


def _layer_seed(seed: int, i: int) -> int:
    """Per-layer generator seed: layer i's draws do not depend on how many
    numbers earlier layers drew (the role jax.random.fold_in plays in the
    JAX package)."""
    return (int(seed) * 1_000_003 + i) % (2 ** 63)


class NetworkBase:
    """Common network state and loops. Subclasses implement `init()`,
    `_fit_dataset(ds)` (one optimizer step or a TBPTT segment loop),
    `_ordered_layer_confs()` (layer configs aligned with params_list) and
    `_merge_states`, and set `device`, `net_conf` and `updater_def`."""

    def __init__(self):
        self.listeners = []
        self.iteration = 0
        self.epoch = 0
        self.params_list = None
        self.state_list = None
        self.upd_state = None
        self._score = None  # last minibatch score (device tensor, lazy read)
        self._last_etl_ms = 0.0
        # resume coordinates of the running fit (train_state()); None
        # outside a fit
        self._train_state = None
        # the fit loop's liveness heartbeat and the hang dump it left
        self._fit_heartbeat = None
        self._hang_dump_path = None
        # [loss, raw global gradient norm] of the last optimizer step
        self._step_diag = None
        # the fit instruments, resolved from the registry once per network
        self._fit_instruments = None
        # forward functions built by `output()` / `rnn_time_step` so far,
        # one per (kind, input shape, dtype) key. PyTorch runs eagerly, so
        # an entry is a closure, not a compiled program; the count keeps
        # the JAX package's meaning — growth under traffic means shape
        # churn — so serving layers can read the same number.
        self._output_fn = None
        self._output_compiles = 0
        self._output_cache_lock = threading.Lock()

    # -- to be provided by subclasses ----------------------------------------

    def init(self):
        raise NotImplementedError

    def _ordered_layer_confs(self) -> List:
        """Layer configs in flattening order, aligned with params_list."""
        raise NotImplementedError

    def _require_init(self):
        if self.params_list is None:
            self.init()

    def _fit_dataset(self, ds):
        raise NotImplementedError

    def _as_input(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _as_data(self, a):
        """A batch array on the device; float64 arrives as float32, as
        jnp.asarray gives it to the JAX package."""
        if a is None:
            return None
        t = self._as_input(a)
        return t.float() if t.dtype == torch.float64 else t

    # -- the optimizer step --------------------------------------------------

    def _reg_penalty(self, params):
        """L1/L2 penalties (reference: BaseLayer.calcL1/calcL2 added to the
        score; their gradients come from differentiating this expression)."""
        reg = 0.0
        for conf, p in zip(self._ordered_layer_confs(), params):
            inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
            l1 = getattr(inner, "l1", 0.0) or 0.0
            l2 = getattr(inner, "l2", 0.0) or 0.0
            if l1 == 0.0 and l2 == 0.0:
                continue
            for name, w in p.items():
                if _regularizable(name):
                    if l1:
                        reg = reg + l1 * w.abs().sum()
                    if l2:
                        reg = reg + 0.5 * l2 * (w * w).sum()
        return reg

    def _lr_mult_tree(self):
        """Per-leaf learning-rate multiplier (per-layer learning_rate and
        bias_learning_rate overrides, reference: layer conf learningRate)."""
        base = self.net_conf.learning_rate
        out = []
        for conf, p in zip(self._ordered_layer_confs(), self.params_list):
            inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
            layer_lr = getattr(inner, "learning_rate", None)
            bias_lr = getattr(inner, "bias_learning_rate", None)
            mult = {}
            for name in p:
                if name == "b" and bias_lr is not None:
                    mult[name] = bias_lr / base
                elif layer_lr is not None:
                    mult[name] = layer_lr / base
                else:
                    mult[name] = 1.0
            out.append(mult)
        return out

    def _trainable_mask(self):
        return [{k: (0.0 if isinstance(conf, L.FrozenLayer) else 1.0) for k in p}
                for conf, p in zip(self._ordered_layer_confs(), self.params_list)]

    def _step(self, loss_builder, states, data, lr: float, t: float, rng):
        """One optimizer step, eagerly: the loss and its gradients by
        autograd, then the shared tail — the diagnostic, trainable mask,
        gradient normalization, per-leaf lr and the updater, which adds its
        deltas to the parameters in place. Returns (merged states, score).
        `self._step_diag` holds [loss, raw global gradient norm] (before
        masking or clipping, in f32), as the JAX step's `diag`."""
        params = self.params_list
        leaves = [v for p in params for v in p.values()]
        for v in leaves:
            v.requires_grad_(True)
        try:
            score, new_states = loss_builder(params, states, data, rng)
            flat = iter(torch.autograd.grad(score, leaves))
        finally:
            for v in leaves:
                v.requires_grad_(False)
        score = score.detach()
        grads = [{k: next(flat) for k in p} for p in params]
        with torch.no_grad():
            # leaves in sorted-key order per layer, as jax.tree_util walks
            gsq = sum(g[k].float().square().sum() for g in grads for k in sorted(g))
            self._step_diag = torch.stack([score.float(), torch.sqrt(gsq)])
            if not self.net_conf.minimize:
                grads = [{k: -v for k, v in g.items()} for g in grads]
            grads = [{k: g[k] * m[k] for k in g}
                     for g, m in zip(grads, self._trainable_mask())]
            grads = normalize_gradients(
                grads, self.net_conf.gradient_normalization,
                self.net_conf.gradient_normalization_threshold)
            lr_tree = [{k: lr * m[k] for k in g}
                       for g, m in zip(grads, self._lr_mult_tree())]
            self.updater_def.step_(params, grads, self.upd_state, lr_tree, t)
        return _detached(self._merge_states(states, new_states)), score

    def _run_step(self, loss_builder, data, stateful_states=None):
        lr = schedule_lr(self.net_conf, self.iteration)
        # the step's generator: seed ^ 0x5EED with the iteration folded in
        rng = torch.Generator(device=self.device).manual_seed(
            ((self.net_conf.seed ^ 0x5EED) * 1_000_003 + self.iteration) % (2 ** 63))
        states = stateful_states if stateful_states is not None else self.state_list
        states, score = self._step(loss_builder, states, data, lr,
                                   float(self.iteration), rng)
        self._score = score
        self.iteration += 1
        return states, score

    # -- listeners -----------------------------------------------------------

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

    def _notify(self, batch_size, ds=None):
        # a consistent point: the whole optimizer step is committed, so a
        # held SIGTERM (the preemption save) may run here
        _sigchain.safe_point()
        if not self.listeners:
            return
        info = {
            "score": lambda: self._score,
            "batch_size": batch_size,
            "etl_ms": self._last_etl_ms,
            # the batch that produced this iteration (lazy)
            "batch": lambda: ds,
        }
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration - 1, info)

    # -- the fit loop --------------------------------------------------------

    def _fit_obs(self):
        """The fit-loop instruments from the shared registry, resolved once
        per network, so the per-step path touches no registry lookup."""
        ins = self._fit_instruments
        if ins is None:
            reg = _metrics.get_registry()
            ins = self._fit_instruments = {
                "steps": reg.counter(
                    "fit_step_total", "optimizer steps run").labels(),
                "examples": reg.counter(
                    "fit_examples_total",
                    "training examples consumed").labels(),
                "data_wait": reg.histogram(
                    "fit_data_wait_seconds",
                    "time blocked on the data iterator (ETL) before a "
                    "dispatch").labels(),
                "dispatch": reg.histogram(
                    "fit_dispatch_seconds",
                    "host time in the train-step call (launches; "
                    "excludes device sync)").labels(),
                "sync": reg.histogram(
                    "fit_device_sync_seconds",
                    "device sync after the step — measured only while "
                    "tracing is enabled, so the default fit path never "
                    "adds blocking syncs").labels(),
                "recorder": _blackbox.get_recorder(),
            }
        return ins

    def _timed_fit(self, fit_fn, data_wait: float, n_examples: int,
                   batches=None):
        """Run one `_fit_dataset` under the step-phase timers: data wait,
        dispatch and (with tracing on) device sync, each a histogram in
        the shared registry and a span when tracing is on, plus the step
        and example counters, a flight-recorder step record and the fit
        heartbeat. PyTorch returns before the device finishes, so the
        dispatch time is host time, as in the JAX package; the device is
        synchronised only while tracing is enabled. `batches` names the
        DataSet(s) behind this dispatch for the `nan` fault kind."""
        ins = self._fit_obs()
        it0 = self.iteration
        sync = None
        # resume bookkeeping BEFORE the dispatch: a checkpoint listener
        # firing inside it (post-step _notify) must record this batch as
        # consumed — the snapshot's params already include its update.
        # Under TBPTT a save between two segments of one batch therefore
        # resumes at the NEXT batch (the JAX package's rule).
        ts = self._train_state
        if ts is not None:
            ts["batch_in_epoch"] += 1
        # beat on entry AND exit: each phase (data wait, dispatch) must
        # individually exceed hang_timeout to read as a stall
        hb0 = self._fit_heartbeat
        if hb0 is not None:
            hb0.beat()
        t0 = time.perf_counter()
        with _tracing.span("fit/step", data_wait_ms=round(data_wait * 1e3, 3)):
            with _tracing.span("fit/dispatch"):
                # chaos hook: an `oom` fault here unwinds the fit as a
                # device allocator failure would; a `nan` fault taints
                # this batch's features so the divergence goes through
                # the real step
                injected = _faults.fault_point("train_step")
                if injected == "nan" and batches:
                    _faults.taint_nan(batches[0])
                fit_fn()
            dispatch = time.perf_counter() - t0
            if _tracing.is_enabled() and self._score is not None:
                t1 = time.perf_counter()
                with _tracing.span("fit/device_sync"):
                    if self._score.is_cuda:
                        torch.cuda.current_stream(self._score.device).synchronize()
                sync = time.perf_counter() - t1
                ins["sync"].observe(sync)
        ins["steps"].inc(max(1, self.iteration - it0))
        ins["examples"].inc(n_examples)
        ins["data_wait"].observe(data_wait)
        ins["dispatch"].observe(dispatch)
        # black box: one ring append, the score kept as a device tensor
        # (resolved only at dump time, never synced here)
        ins["recorder"].record_step(self.iteration - 1, score=self._score,
                                    data_wait=data_wait, dispatch=dispatch,
                                    sync=sync)
        hb = self._fit_heartbeat
        if hb is not None:
            hb.beat()

    def _run_fit(self, iterator, epochs: int,
                 hang_timeout: Optional[float] = None,
                 resume_from: Optional[str] = None, run_ledger=None):
        if run_ledger is not None:
            raise NotImplementedError(
                "run_ledger: utils/runledger.py is not ported yet")
        # SIGTERM actions (the preemption save) read this net, and the
        # loop below changes its parameters, updater state, iteration,
        # epoch and resume coordinates in separate statements: a SIGTERM
        # is held for the whole fit and runs only where they agree (after
        # a batch is pulled, at each listener notification, at an epoch's
        # end, or when the fit ends)
        with _sigchain.deferred():
            skip_batches = 0
            if resume_from is not None:
                skip_batches, epochs, _ = self._restore_for_resume(
                    resume_from, iterator, epochs)
            # liveness: the fit thread holds a busy slot on the "fit"
            # heartbeat for the whole run and beats once per dispatch.
            # With hang_timeout the watchdog's stall action dumps the
            # flight recorder and raises StepHangError here.
            hb = _health.get_health().register(
                "fit",
                stall_after=hang_timeout if hang_timeout else 600.0,
                on_stall=self._hang_action() if hang_timeout else None)
            self._fit_heartbeat = hb
            try:
                with hb.busy():
                    self._fit_epochs(iterator, epochs, skip_batches)
            except _health.StepHangError as e:
                if e.dump_path is not None:
                    raise  # already carries its forensics
                raise _health.StepHangError(
                    f"fit step exceeded hang_timeout={hang_timeout}s without "
                    f"progress (see flight-recorder dump)",
                    dump_path=self._hang_dump_path) from None
            finally:
                self._fit_heartbeat = None
                # resume coordinates die with the fit: a preemption save
                # AFTER a completed fit must record a clean epoch boundary
                self._train_state = None
                _health.get_health().unregister(hb)
                # fires even when an epoch raises: listeners that flipped
                # process-global state for the run restore it here
                for lst in self.listeners:
                    hook = getattr(lst, "on_fit_end", None)
                    if hook is not None:
                        hook(self)
        return self

    def _hang_action(self):
        """The watchdog-side stall action for fit(hang_timeout=...): runs
        on the dl4j-watchdog thread — dump the black box first, then
        async-raise StepHangError into the fitting thread (delivered at
        its next bytecode boundary: a thread blocked inside a CUDA call
        receives it when the call returns)."""
        fit_tid = threading.get_ident()

        def on_stall(hb, stalled_for):
            self._hang_dump_path = _blackbox.get_recorder().dump(
                reason=f"fit step hang: no progress for "
                       f"{stalled_for:.3f}s (hang_timeout={hb.stall_after}s)")
            # the dump takes real time: re-check the fit is still OURS
            # and still stalled before the irrevocable async raise
            if self._fit_heartbeat is not hb:
                return
            state, _, _ = hb.check()
            if state == _health.OK:
                return
            if not _health._async_raise(fit_tid, _health.StepHangError):
                logger.error(
                    "fit hang detected but StepHangError could not be "
                    "delivered; dump at %s", self._hang_dump_path)

        return on_stall

    # -- resume ----------------------------------------------------------------

    def _capture_iterator_state(self, iterator) -> Optional[dict]:
        """The iterator's epoch-start state (the data/iterators `state()`
        protocol), JSON-safe, for checkpoints. None when the iterator is
        stateless or its capture fails — resume then replays
        positionally only."""
        state_fn = getattr(iterator, "state", None)
        if not callable(state_fn):
            return None
        try:
            return state_fn()
        except Exception:
            logger.warning("iterator state capture failed; checkpoints "
                           "will resume positionally only", exc_info=True)
            return None

    def train_state(self) -> Optional[dict]:
        """Point-in-time resume coordinates of the CURRENT fit: epoch,
        batches consumed within it, and the iterator's epoch-start state.
        Embedded into checkpoints (utils/model_serializer trainState.json)
        and replayed by fit(resume_from=...). None outside a fit."""
        ts = self._train_state
        return None if ts is None else dict(ts)

    def _restore_for_resume(self, directory: str, iterator, epochs: int):
        """Load the newest GOOD checkpoint in `directory` into this net
        and prime the mid-epoch replay: restores the iterator's
        epoch-start state and returns (batches to skip in the first
        epoch, epochs remaining out of the requested total, the restored
        path or None). An empty or missing directory is a fresh start.
        Each candidate's SHA-256 manifest is verified before the load; a
        damaged or unloadable candidate is skipped (counted) and the
        previous one used; a changed configuration raises."""
        from deeplearning4j_tpu_torch.train.checkpoint import (
            NoUsableCheckpointError,
            checkpoint_candidates,
            note_bad_checkpoint,
            verified_checkpoints,
        )
        from deeplearning4j_tpu_torch.utils.model_serializer import (
            ConfigMismatchError,
            restore_fit_state,
        )

        meta = path = None
        for cand_path, _ in verified_checkpoints(directory):
            try:
                meta = restore_fit_state(self, cand_path)
            except ConfigMismatchError:
                # a changed architecture is a USER error every candidate
                # repeats — raise it, don't discard the history
                raise
            except Exception as e:
                note_bad_checkpoint(
                    cand_path, f"restore failed: {type(e).__name__}: {e}")
                meta = None
                continue
            path = cand_path
            break
        if meta is None:
            if any(True for _ in checkpoint_candidates(directory)):
                raise NoUsableCheckpointError(
                    f"resume_from={directory!r}: checkpoints exist but "
                    f"every candidate was rejected (see "
                    f"checkpoint_integrity_failures_total and the "
                    f"checkpoint_corrupt events) — not starting fresh "
                    f"over a corrupted history")
            logger.info("resume_from=%r: no checkpoint found — starting "
                        "fresh", directory)
            return 0, epochs, None
        ts = meta.get("train_state") or {}
        skip = int(ts.get("batch_in_epoch", 0))
        it_state = ts.get("iterator_state")
        if it_state is not None:
            restore = getattr(iterator, "restore_state", None)
            if callable(restore):
                restore(it_state)
            else:
                logger.warning(
                    "checkpoint carries iterator state but the iterator "
                    "has no restore_state(); mid-epoch replay may not be "
                    "deterministic")
        remaining = max(0, int(epochs) - int(self.epoch))
        if remaining == 0 and skip > 0:
            remaining = 1  # died inside the final epoch: finish it
        logger.info(
            "resumed from %s: iteration=%d epoch=%d, replaying %d "
            "batch(es), %d epoch(s) remaining", path, self.iteration,
            self.epoch, skip, remaining)
        _blackbox.get_recorder().record_event(
            "resume", checkpoint=path, iteration=int(self.iteration),
            epoch=int(self.epoch), skip_batches=skip)
        return skip, remaining, path

    def _fit_epochs(self, iterator, epochs: int, skip_batches: int = 0):
        skip = int(skip_batches)
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self, self.epoch)
            # resume coordinates for this epoch: captured BEFORE the
            # first batch is pulled, so a checkpoint taken anywhere in
            # the epoch can restore the iterator to the same epoch start
            # (the shuffle permutation) and skip forward
            self._train_state = {
                "epoch": int(self.epoch),
                "batch_in_epoch": 0,
                "iterator_state": self._capture_iterator_state(iterator),
            }
            t_etl = time.perf_counter()
            for ds in iterator:
                wait = time.perf_counter() - t_etl
                self._last_etl_ms = wait * 1e3
                if skip > 0:
                    # mid-epoch replay: this batch was trained before the
                    # checkpoint — consumed from the iterator, not
                    # dispatched (its update is in the restored params)
                    skip -= 1
                    self._train_state["batch_in_epoch"] += 1
                    t_etl = time.perf_counter()
                    continue
                # every batch counted so far is trained: a consistent point
                _sigchain.safe_point()
                self._timed_fit(lambda: self._fit_dataset(ds), wait,
                                ds.num_examples(), batches=[ds])
                t_etl = time.perf_counter()
            if skip > 0:
                # the resumed epoch ended with replay batches still owed
                # (the iterator is shorter than at checkpoint time):
                # continue from the next epoch start, loudly
                logger.warning(
                    "resume fast-forward ran out of batches with %d still "
                    "to skip (iterator shorter than at checkpoint time); "
                    "continuing from the next epoch start", skip)
                skip = 0
            _sigchain.safe_point()  # the epoch's batches are all trained
            for lst in self.listeners:
                lst.on_epoch_end(self, self.epoch)
            self.epoch += 1
            iterator.reset()

    @property
    def output_compile_count(self) -> int:
        """Forward functions built by `output()`/`rnn_time_step` so far —
        one per distinct (kind, input shape/dtype) key."""
        return self._output_compiles

    def _cached_output_fn(self, key, make_fn):
        """Shape-keyed get-or-insert into the forward cache, bumping
        `output_compile_count` on insert. Under a lock so concurrent misses
        on one key produce ONE entry."""
        with self._output_cache_lock:
            if not isinstance(self._output_fn, dict):
                self._output_fn = {}
            fn = self._output_fn.get(key)
            if fn is None:
                fn = self._output_fn[key] = make_fn()
                self._output_compiles += 1
                self._note_compile("output", key)
            return fn

    def _note_compile(self, kind: str, key=None):
        """Record a forward-cache insertion as `compile_total{kind}` in the
        shared registry."""
        _metrics.get_registry().counter(
            "compile_total", "forward-cache insertions (new shapes)",
            ("kind",)).labels(kind).inc()

    # -- flattened params API ------------------------------------------------

    def params(self):
        """Flattened parameter vector (reference: Model.params())."""
        self._require_init()
        return params_to_flat(self._ordered_layer_confs(), self.params_list)

    def set_params(self, flat):
        self._require_init()
        self.params_list = flat_to_params(
            self._ordered_layer_confs(), self.params_list, flat
        )

    def num_params(self) -> int:
        self._require_init()
        return num_params(self._ordered_layer_confs(), self.params_list)

    def param_table(self):
        self._require_init()
        return param_table(self._ordered_layer_confs(), self.params_list)

    def summary(self) -> str:
        self._require_init()
        lines = ["=" * 70]
        total = 0
        for i, (conf, p) in enumerate(
            zip(self._ordered_layer_confs(), self.params_list)
        ):
            n = sum(v.numel() for v in p.values())
            total += n
            lines.append(f"{i:>3}  {type(conf).__name__:<28} params: {n}")
        lines.append(f"total params: {total}")
        lines.append("=" * 70)
        return "\n".join(lines)
