"""Helper SPI — the vendor-kernel plugin point.

Reference: the cuDNN Helper interfaces (ConvolutionHelper.java:35,
BatchNormalizationHelper.java:29, ...) loaded reflectively by layer impls
with checkSupported() fallback to the built-in path. Layers ask
get_helper("op", **ctx) before their builtin torch path; a registered
helper answers `supported(**ctx)` and, when true, its `fn` replaces the
builtin. The hand-written CUDA kernels register here (ops/fused_lstm.py).

One change from the JAX package: the raise -> auto-disable -> builtin
path applies only to calls on CPU tensors. On a CUDA tensor a kernel
error propagates to the caller — a GPU run never swaps a failing kernel
for the builtin path behind the caller's back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger("deeplearning4j_tpu_torch")


# a thread's SPI events while a CUDA graph captures, and the events of the
# streams being captured (see `recording_events`)
_recording = threading.local()
_stream_events: Dict[int, List[Tuple]] = {}


def _count(metric: str, op: str, helper: str, family: str,
           reason: Optional[str] = None):
    """Helper SPI events in the shared registry: selection hits,
    builtin-path fallbacks (with why), and auto-disables, each carrying
    the kernel FAMILY so per-family hit rates are scrape-able, and a
    helper's own routing events (a probe's decline reason). Family
    values come from the registration's `family(**ctx)` callable, which
    must return a bounded slug set. While a CUDA graph captures, events
    are recorded and counted again on each replay."""
    events = getattr(_recording, "events", None)
    if events is None and _stream_events:
        events = _stream_events.get(torch.cuda.current_stream().cuda_stream)
    if events is not None:
        events.append((metric, op, helper, family, reason))
        return
    reg = _metrics.get_registry()
    if reason is None:
        reg.counter(metric, "Helper SPI events",
                    ("op", "helper", "family")).labels(op, helper,
                                                       family).inc()
    else:
        reg.counter(metric, "Helper SPI events",
                    ("op", "helper", "family",
                     "reason")).labels(op, helper, family, reason).inc()


@contextlib.contextmanager
def recording_events(stream=None):
    """While a CUDA graph captures on this thread, the SPI's events go into
    the yielded list instead of the registry: the consults run once, at
    capture, and the graph then replays their choice. With the capture's
    `stream`, events any thread raises on that stream are recorded too (a
    captured backward consults on the autograd engine's thread). The
    graph's owner calls `replay_events` on every replay, so
    `helper_hit_total` and the fallback counters count the calls that
    ran."""
    prev = getattr(_recording, "events", None)
    _recording.events = events = []
    if stream is not None:
        _stream_events[stream.cuda_stream] = events
    try:
        yield events
    finally:
        _recording.events = prev
        if stream is not None:
            _stream_events.pop(stream.cuda_stream, None)


def replay_events(events: List[Tuple]) -> None:
    """Count recorded SPI events once more: one replay of a captured graph."""
    for event in events:
        _count(*event)


class HelperError(RuntimeError):
    """A registered helper fn raised on CPU tensors. The helper has
    already been disabled and the failure logged; callers catch this and
    retry their built-in path (the reference behaves the same way: a
    cuDNN helper that throws is dropped and the layer falls back)."""


@dataclasses.dataclass
class Helper:
    name: str
    fn: Callable
    supported: Callable[..., bool] = lambda **ctx: True
    enabled: bool = True
    family: Optional[Callable[..., str]] = None


_HELPERS: Dict[str, Helper] = {}


def register_helper(op: str, fn: Callable,
                    supported: Optional[Callable[..., bool]] = None,
                    name: Optional[str] = None,
                    family: Optional[Callable[..., str]] = None) -> None:
    """Install a helper for an op slot ("lstm_sequence", ...). Last
    registration wins. `family(**ctx)` maps a call context to the bounded
    kernel-family slug the helper metrics are labeled with (default: the
    op name itself)."""
    _HELPERS[op] = Helper(
        name=name or getattr(fn, "__name__", op),
        fn=fn,
        supported=supported or (lambda **ctx: True),
        family=family,
    )


def _family_of(op: str, h: Helper, ctx: dict) -> str:
    if h.family is None:
        return op
    try:
        return str(h.family(**ctx))
    except Exception:  # a broken family fn must never kill the metric
        return op


def _any_cuda(args, kwargs) -> bool:
    return any(torch.is_tensor(a) and a.is_cuda
               for a in (*args, *kwargs.values()))


def get_helper(op: str, **ctx) -> Optional[Callable]:
    """The helper's fn if one is registered, enabled, and supports this
    call context; else None (caller uses its built-in path).

    The returned callable is guarded. On CPU tensors a helper fn that
    raises is logged and DISABLED, and the call raises HelperError so the
    caller retries its built-in path. On CUDA tensors the error itself
    propagates and the helper stays enabled."""
    h = _HELPERS.get(op)
    if h is None:
        return None
    fam = _family_of(op, h, ctx)
    if not h.enabled:
        _count("helper_fallback_total", op, h.name, fam, "disabled")
        return None
    try:
        if not h.supported(**ctx):
            _count("helper_fallback_total", op, h.name, fam, "unsupported")
            return None
    except Exception as e:  # a broken probe must never kill the fallback
        logger.warning("helper %s probe failed: %s", h.name, e)
        _count("helper_fallback_total", op, h.name, fam, "probe_error")
        return None
    _count("helper_hit_total", op, h.name, fam)

    def guarded(*args, **kwargs):
        try:
            return h.fn(*args, **kwargs)
        except Exception as e:
            if _any_cuda(args, kwargs):
                raise
            h.enabled = False
            logger.warning(
                "helper %s (op %s) raised %s: %s — helper disabled, "
                "falling back to the built-in path", h.name, op,
                type(e).__name__, e)
            _count("helper_auto_disable_total", op, h.name, fam)
            _count("helper_fallback_total", op, h.name, fam, "raised")
            raise HelperError(f"helper {h.name} failed: {e}") from e

    return guarded


def set_helper_enabled(op: str, enabled: bool) -> None:
    if op in _HELPERS:
        _HELPERS[op].enabled = bool(enabled)


def helper_enabled(op: str) -> Optional[bool]:
    """Current enabled state (None when no helper is registered) — lets
    callers snapshot/restore the kill switch."""
    h = _HELPERS.get(op)
    return None if h is None else h.enabled


def helper_names() -> Dict[str, str]:
    return {op: h.name for op, h in _HELPERS.items()}
