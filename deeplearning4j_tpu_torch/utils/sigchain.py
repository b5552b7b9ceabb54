"""Deterministic SIGTERM action chain (a stdlib copy of the JAX
package's utils/sigchain.py, the port imports nothing of that package,
plus the fit loop's hold, `deferred()`, described below).

Two subsystems want the preemption signal: the checkpoint listener
(save the model before the VM disappears) and the flight recorder (dump
the black box). Each used to install its own `signal.signal` handler and
chain to whatever was there before — so INSTALLATION ORDER decided
whether the preemption save ran before the crash dump, and a listener
installed after the crash hooks silently demoted the dump to "whenever
the previous handler got around to it".

This module owns the one SIGTERM handler instead. Subsystems register
named actions with a priority; on SIGTERM every action runs in priority
order (checkpoint save = PRIORITY_SAVE, black-box dump = PRIORITY_DUMP,
so the save always precedes the dump regardless of who armed first),
then the pre-chain handler (or the default die-with-SIGTERM) runs last.
A raising action is logged and skipped — one broken hook must not eat
the preemption window of the others.

A Python signal handler runs between any two bytecodes of the main
thread, so an action that reads the model (the preemption save) could
see a fit step half done: the updater's new parameters beside the old
iteration, or a batch counted that was never trained. The port's fit
loop therefore runs under `deferred()`: a SIGTERM that arrives inside
is held and the chain runs at the loop's next `safe_point()` (where
parameters, updater state, iteration and resume coordinates agree) or
when the hold ends — at most one optimizer step late.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")

# canonical priorities: state first (it needs the grace window most),
# forensics second, whatever was installed before the chain last
PRIORITY_SAVE = 10
PRIORITY_DUMP = 20

_lock = threading.Lock()
_actions: List[Tuple[int, str, Callable]] = []
_prev_handler = None
_installed = False
# the main thread's deferral depth and the signal held while it is above 0
_hold_depth = 0
_pending: Optional[int] = None


def register(name: str, fn: Callable[[int, object], None],
             priority: int = 50) -> None:
    """Add (or replace, by name) a SIGTERM action. `fn(signum, frame)`
    runs inside the signal handler on the main thread — it must not
    block indefinitely. Lower priority runs earlier. Installs the chain
    handler on first registration (main thread only)."""
    with _lock:
        _actions[:] = [a for a in _actions if a[1] != name]
        _actions.append((priority, name, fn))
        _actions.sort(key=lambda a: (a[0], a[1]))
    install()


def unregister(name: str) -> None:
    with _lock:
        _actions[:] = [a for a in _actions if a[1] != name]


def actions() -> List[Tuple[int, str, Callable]]:
    with _lock:
        return list(_actions)


@contextlib.contextmanager
def deferred():
    """Hold the chain while the main thread changes state its actions
    read: a SIGTERM arriving inside runs at the next `safe_point()`, or
    when the outermost hold ends. Signals reach only the main thread, so
    on another thread this holds nothing."""
    global _hold_depth
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    _hold_depth += 1
    try:
        yield
    finally:
        _hold_depth -= 1
        if _hold_depth == 0:
            safe_point()


def safe_point() -> None:
    """Run a SIGTERM that `deferred()` held, now: the caller's state is
    consistent here. A no-op when none is pending or off the main
    thread."""
    global _pending
    signum = _pending
    if signum is None or threading.current_thread() is not threading.main_thread():
        return
    _pending = None
    _run(signum, None)


def _handler(signum, frame):
    global _pending
    if _hold_depth > 0:
        _pending = signum
        return
    _run(signum, frame)


def _run(signum, frame):
    for _, name, fn in actions():
        try:
            fn(signum, frame)
        except Exception:
            logger.exception("SIGTERM action %r failed", name)
    prev = _prev_handler
    if callable(prev):
        prev(signum, frame)
    elif prev != signal.SIG_IGN:
        # die with SIGTERM semantics so parents/timeouts see the real
        # cause, not a clean exit
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def install() -> bool:
    """Install the chain handler (idempotent). Re-installs when someone
    else replaced the handler since (tests save/restore handlers around
    themselves; the chain must survive that). Returns True when the
    chain handler is the live SIGTERM handler after the call."""
    global _prev_handler, _installed
    if threading.current_thread() is not threading.main_thread():
        logger.warning("SIGTERM chain requires the main thread; "
                       "skipping signal installation")
        return False
    current = signal.getsignal(signal.SIGTERM)
    if current is _handler:
        return True
    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        logger.warning("SIGTERM chain installation failed", exc_info=True)
        return False
    _prev_handler = current
    _installed = True
    return True


def installed() -> bool:
    return signal.getsignal(signal.SIGTERM) is _handler
