"""Runtime lock-order sanitizer — lockdep for the framework's threads.

The stack is a dozen cooperating thread pools (serving collector and
dispatcher, decode engine, sparse prefetch, ledger/watchdog daemons,
paramserver drains), and every deadlock class it has hit so far —
reversed acquisition orders, blocking I/O under a mutex, a device sync
while holding the admission lock — is *observable* at runtime long
before two threads actually wedge. This module is the observer:

- Opt-in via ``DL4J_LOCKCHECK=1`` (or ``install()``). When armed it
  wraps ``threading.Lock`` / ``RLock`` / ``Condition`` *construction*
  for callers inside ``deeplearning4j_tpu_torch/`` only — stdlib, torch
  and third-party locks (the JAX package's too) stay raw — and keeps,
  per thread, the ordered set of traced locks currently held.
- Every blocking acquisition attempted while other traced locks are
  held records a directed edge ``held -> wanted`` in a process-global
  lock-order graph, with a bounded repo-frames-only witness stack
  captured the first time each edge appears. Two code paths that take
  the same two locks in opposite orders produce a cycle — a potential
  deadlock that fires as a CN001 finding (analysis/concurrency_audit)
  even when the timing never actually wedges.
- Blocking calls made while holding a traced lock — ``time.sleep``,
  ``queue.Queue.get/put``, ``Condition``/``Event`` waits on *another*
  lock's condition, ``Thread.join``, ``socket.create_connection``, and
  the device syncs ``torch.cuda.synchronize``,
  ``torch.cuda.Stream.synchronize`` and ``torch.cuda.Event.synchronize``
  (what ``block_until_ready`` is to the JAX package) — are recorded as
  CN002 evidence, and a device dispatch entered with a lock held
  (cooperative ``note_dispatch()`` hooks in the fit loop, before the
  eager step or the CUDA graph replay, and in the decode engine) as
  CN003. A device sync is evidence only when its direct caller is repo
  code: ``torch.cuda.graph.__enter__`` syncs on its own, and torch's
  internal syncs are not the framework's.
- Deadlock forensics: lock ownership plus a waiter wait-graph
  (``forensics()``) that names *who holds what and who waits on whom*;
  utils/blackbox embeds it in every dump so a watchdog-caught hang
  renders as a named cycle, not a stack soup.

Off-path contract (the devprof/runledger bar): when the sanitizer is
not installed nothing in the process is patched, and every cooperative
hook (``note_dispatch``/``note_blocking``) is ONE module-global read —
pinned <10us by tests. Traced locks created while armed keep working
after ``uninstall()`` by delegating on the same one-global-read check.

Identity: locks are keyed by their *construction site* (``path:line``,
lockdep's "lock class"), not by instance — a pool that builds one lock
per replica still converges to one node per site, which is what keeps
the graph bounded and lets cross-instance order violations connect.

The port of the JAX package's utils/locktrace.py: the same state, hooks,
snapshot and forensics formats, so the two sanitizers' findings compare
name for name once the package directory is mapped.
"""

from __future__ import annotations

import _thread
import os
import queue
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

_SELF_FILE = os.path.abspath(__file__)
_PKG_DIR = os.path.dirname(os.path.dirname(_SELF_FILE))
_REPO_ROOT = os.path.dirname(_PKG_DIR)

# originals captured once at import — install() swaps them out, traced
# paths and uninstall() always go through this table
_ORIG = {
    "Lock": threading.Lock,
    "RLock": threading.RLock,
    "Condition": threading.Condition,
    "sleep": time.sleep,
    "queue_get": queue.Queue.get,
    "queue_put": queue.Queue.put,
    "cond_wait": threading.Condition.wait,
    "event_wait": threading.Event.wait,
    "thread_join": threading.Thread.join,
    "create_connection": socket.create_connection,
    "cuda_synchronize": torch.cuda.synchronize,
    "stream_synchronize": torch.cuda.Stream.synchronize,
    "event_synchronize": torch.cuda.Event.synchronize,
}

_WITNESS_FRAMES = 8


class _State:
    """All sanitizer state. One instance per install(); dropped whole on
    uninstall() so a stale thread finishing a traced acquire cannot
    corrupt the next session's graph."""

    def __init__(self):
        # a RAW lock (never traced): the sanitizer must not feed itself
        self.mu = _thread.allocate_lock()
        self.tls = threading.local()
        # site -> {"name", "kind", "created"}
        self.locks: Dict[str, dict] = {}
        # (held_site, wanted_site) -> {"count", "thread", "witness"}
        self.edges: Dict[tuple, dict] = {}
        # (kind, site) -> {"count", "held", "thread", "witness", "func"}
        self.blocking: Dict[tuple, dict] = {}
        # (what, site) -> same shape as blocking
        self.dispatch: Dict[tuple, dict] = {}
        # id(traced lock) -> {"site", "thread", "ident", "depth"}
        self.owners: Dict[int, dict] = {}
        # thread ident -> {"thread", "site", "lock", "since"}
        self.waiting: Dict[int, dict] = {}

    def held(self) -> list:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h


_STATE: Optional[_State] = None


# -- frame helpers ------------------------------------------------------------

def _in_repo(fn: str) -> bool:
    """A frame's file lies in this checkout (and is not this module). The
    separator matters: a sibling directory whose name starts with the
    checkout's (a virtualenv beside it) is not repo code."""
    return fn.startswith(_REPO_ROOT + os.sep) and fn != _SELF_FILE


def _witness(skip: int = 2) -> List[str]:
    """Repo-frames-only stack (innermost first), bounded — enough to
    *name* where an edge was minted without dragging pytest/threading
    frames along."""
    out: List[str] = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return out
    depth = 0
    while f is not None and depth < 50 and len(out) < _WITNESS_FRAMES:
        fn = f.f_code.co_filename
        if _in_repo(fn):
            rel = os.path.relpath(fn, _REPO_ROOT).replace(os.sep, "/")
            out.append(f"{rel}:{f.f_lineno} in {f.f_code.co_name}")
        f = f.f_back
        depth += 1
    return out


def _nearest_repo_site(skip: int = 2):
    """(``rel:line``, function) of the innermost repo frame, or None."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return None
    depth = 0
    while f is not None and depth < 50:
        fn = f.f_code.co_filename
        if _in_repo(fn):
            rel = os.path.relpath(fn, _REPO_ROOT).replace(os.sep, "/")
            return f"{rel}:{f.f_lineno}", f.f_code.co_name
        f = f.f_back
        depth += 1
    return None


def _construction_site(depth: int):
    """Caller-frame filter for the patched constructors: only wrap a
    lock whose *immediate* constructing frame is framework code — queue
    internals, threading.Event, torch and user code keep raw primitives.
    The separator matters: the JAX package's directory name is a prefix
    of this one's, and its locks are not the port's."""
    try:
        f = sys._getframe(depth)
    except ValueError:
        return None
    fn = f.f_code.co_filename
    if not fn.startswith(_PKG_DIR + os.sep) or fn == _SELF_FILE:
        return None
    rel = os.path.relpath(fn, _REPO_ROOT).replace(os.sep, "/")
    return f"{rel}:{f.f_lineno}", f.f_code.co_name


# -- traced lock wrappers -----------------------------------------------------

def _register_site(st: _State, site: str, kind: str, name: Optional[str]):
    with st.mu:
        rec = st.locks.get(site)
        if rec is None:
            st.locks[site] = {"name": name, "kind": kind, "created": 1}
        else:
            rec["created"] += 1
            if name and not rec.get("name"):
                rec["name"] = name


def _record_edges(st: _State, held: list, site: str):
    """Directed order edges held -> site, minted at acquire ATTEMPT so
    a pair of threads that really do deadlock still leaves both edges
    (and both witnesses) in the graph."""
    tname = threading.current_thread().name
    with st.mu:
        for _lid, hsite, _d in held:
            if hsite == site:
                continue
            rec = st.edges.get((hsite, site))
            if rec is None:
                st.edges[(hsite, site)] = {
                    "count": 1, "thread": tname, "witness": _witness(3)}
            else:
                rec["count"] += 1


def _acquire_traced(lock, blocking, timeout):
    st = _STATE
    inner = lock._inner
    if st is None:
        return inner.acquire(blocking, timeout)
    held = st.held()
    lid = id(lock)
    if lock._reentrant:
        for ent in held:
            if ent[0] == lid:
                got = inner.acquire(blocking, timeout)
                if got:
                    ent[2] += 1
                    with st.mu:
                        own = st.owners.get(lid)
                        if own is not None:
                            own["depth"] = ent[2]
                return got
    ident = threading.get_ident()
    tname = threading.current_thread().name
    if blocking:
        if held:
            _record_edges(st, held, lock._site)
        with st.mu:
            st.waiting[ident] = {"thread": tname, "site": lock._site,
                                 "lock": lid, "since": time.monotonic()}
        try:
            got = inner.acquire(blocking, timeout)
        finally:
            with st.mu:
                st.waiting.pop(ident, None)
    else:
        # trylocks cannot participate in a deadlock — no order edge
        got = inner.acquire(False)
    if got:
        held.append([lid, lock._site, 1])
        with st.mu:
            st.owners[lid] = {"site": lock._site, "thread": tname,
                              "ident": ident, "depth": 1}
    return got


def _release_traced(lock):
    st = _STATE
    lock._inner.release()
    if st is None:
        return
    lid = id(lock)
    held = st.held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == lid:
            held[i][2] -= 1
            if held[i][2] <= 0:
                del held[i]
                with st.mu:
                    st.owners.pop(lid, None)
            else:
                with st.mu:
                    own = st.owners.get(lid)
                    if own is not None:
                        own["depth"] = held[i][2]
            return
    # released by a thread that never recorded the acquire (pre-install
    # hold, or a plain Lock handed across threads): just drop ownership
    with st.mu:
        st.owners.pop(lid, None)


class _TracedLock:
    """threading.Lock with acquisition-order accounting."""

    _reentrant = False

    def __init__(self, site: str, label: str, name: Optional[str] = None):
        self._inner = _ORIG["Lock"]()
        self._site = site
        self._label = label
        st = _STATE
        if st is not None:
            _register_site(st, site, "Lock", name)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        return _acquire_traced(self, blocking, timeout)

    def release(self):
        _release_traced(self)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<TracedLock {self._site} ({self._label})>"


class _TracedRLock(_TracedLock):
    """threading.RLock with accounting; implements the Condition
    protocol (_release_save/_acquire_restore/_is_owned) so
    ``threading.Condition(traced_rlock)`` waits correctly AND keeps the
    held-set honest across the wait (the lock is NOT held while the
    waiter sleeps)."""

    _reentrant = True

    def __init__(self, site: str, label: str, name: Optional[str] = None):
        self._inner = _ORIG["RLock"]()
        self._site = site
        self._label = label
        st = _STATE
        if st is not None:
            _register_site(st, site, "RLock", name)

    def locked(self):
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else self._inner._is_owned()

    def _drop_bookkeeping(self):
        st = _STATE
        if st is None:
            return None
        lid = id(self)
        held = st.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == lid:
                depth = held[i][2]
                del held[i]
                with st.mu:
                    st.owners.pop(lid, None)
                return depth
        return None

    def _restore_bookkeeping(self, depth):
        st = _STATE
        if st is None or depth is None:
            return
        lid = id(self)
        st.held().append([lid, self._site, depth])
        with st.mu:
            st.owners[lid] = {
                "site": self._site,
                "thread": threading.current_thread().name,
                "ident": threading.get_ident(), "depth": depth}

    def _release_save(self):
        depth = self._drop_bookkeeping()
        return self._inner._release_save(), depth

    def _acquire_restore(self, saved):
        inner_state, depth = saved
        st = _STATE
        ident = threading.get_ident()
        if st is not None:
            with st.mu:
                st.waiting[ident] = {
                    "thread": threading.current_thread().name,
                    "site": self._site, "lock": id(self),
                    "since": time.monotonic()}
        try:
            self._inner._acquire_restore(inner_state)
        finally:
            if st is not None:
                with st.mu:
                    st.waiting.pop(ident, None)
        self._restore_bookkeeping(depth)

    def _is_owned(self):
        return self._inner._is_owned()

    def __repr__(self):
        return f"<TracedRLock {self._site} ({self._label})>"


# -- patched constructors -----------------------------------------------------

def _lock_factory():
    st = _STATE
    if st is None:
        return _ORIG["Lock"]()
    site = _construction_site(2)
    if site is None:
        return _ORIG["Lock"]()
    return _TracedLock(site[0], site[1])


def _rlock_factory():
    st = _STATE
    if st is None:
        return _ORIG["RLock"]()
    site = _construction_site(2)
    if site is None:
        return _ORIG["RLock"]()
    return _TracedRLock(site[0], site[1])


def _condition_factory(lock=None):
    st = _STATE
    if st is not None and lock is None:
        site = _construction_site(2)
        if site is not None:
            lock = _TracedRLock(site[0], site[1])
    return _ORIG["Condition"](lock)


# -- blocking-under-lock probes ----------------------------------------------

def _note_blocking_impl(st: _State, kind: str, exempt_id: Optional[int],
                        skip: int):
    held = getattr(st.tls, "held", None)
    if not held:
        return
    held_sites = [h[1] for h in held if h[0] != exempt_id]
    if not held_sites:
        return
    if getattr(st.tls, "in_probe", False):
        return
    st.tls.in_probe = True
    try:
        near = _nearest_repo_site(skip + 1)
        site, func = near if near is not None else ("<external>", "?")
        tname = threading.current_thread().name
        with st.mu:
            rec = st.blocking.get((kind, site))
            if rec is None:
                st.blocking[(kind, site)] = {
                    "count": 1, "held": sorted(set(held_sites)),
                    "thread": tname, "func": func, "witness": _witness(skip + 1)}
            else:
                rec["count"] += 1
                for s in held_sites:
                    if s not in rec["held"]:
                        rec["held"].append(s)
    finally:
        st.tls.in_probe = False


def note_blocking(kind: str) -> None:
    """Cooperative CN002 hook for blocking operations the patch set
    cannot see (custom socket loops, subprocess waits). Off = one
    module-global read."""
    st = _STATE
    if st is None:
        return
    _note_blocking_impl(st, kind, None, 2)


def note_dispatch(what: str) -> None:
    """Cooperative CN003 hook: call at a device-dispatch boundary (the
    fit step or its graph replay, the decode engine step or window). Records only when the calling
    thread holds a traced lock. Off = one module-global read."""
    st = _STATE
    if st is None:
        return
    held = getattr(st.tls, "held", None)
    if not held:
        return
    held_sites = [h[1] for h in held]
    near = _nearest_repo_site(2)
    site, func = near if near is not None else ("<external>", "?")
    tname = threading.current_thread().name
    with st.mu:
        rec = st.dispatch.get((what, site))
        if rec is None:
            st.dispatch[(what, site)] = {
                "count": 1, "held": sorted(set(held_sites)),
                "thread": tname, "func": func, "witness": _witness(2)}
        else:
            rec["count"] += 1


def _traced_sleep(secs):
    st = _STATE
    if st is not None:
        _note_blocking_impl(st, "time.sleep", None, 2)
    return _ORIG["sleep"](secs)


def _traced_queue_get(self, block=True, timeout=None):
    st = _STATE
    if st is not None and block:
        _note_blocking_impl(st, "queue.get", None, 2)
    return _ORIG["queue_get"](self, block, timeout)


def _traced_queue_put(self, item, block=True, timeout=None):
    st = _STATE
    if st is not None and block:
        _note_blocking_impl(st, "queue.put", None, 2)
    return _ORIG["queue_put"](self, item, block, timeout)


def _direct_caller_in_repo() -> bool:
    try:
        fn = sys._getframe(2).f_code.co_filename
    except ValueError:
        return False
    return _in_repo(fn) and not fn.startswith(_REPO_ROOT + os.sep + ".")


def _traced_cond_wait(self, timeout=None):
    st = _STATE
    if st is not None and _direct_caller_in_repo():
        # waiting on the condition RELEASES its own lock — only the
        # *other* held locks make this a blocking-under-lock finding
        _note_blocking_impl(st, "condition.wait", id(self._lock), 2)
    return _ORIG["cond_wait"](self, timeout)


def _traced_event_wait(self, timeout=None):
    st = _STATE
    if st is not None and _direct_caller_in_repo():
        _note_blocking_impl(st, "event.wait", None, 2)
    return _ORIG["event_wait"](self, timeout)


def _traced_thread_join(self, timeout=None):
    st = _STATE
    if st is not None and _direct_caller_in_repo():
        _note_blocking_impl(st, "thread.join", None, 2)
    return _ORIG["thread_join"](self, timeout)


def _traced_create_connection(*args, **kwargs):
    st = _STATE
    if st is not None:
        _note_blocking_impl(st, "socket.connect", None, 2)
    return _ORIG["create_connection"](*args, **kwargs)


def _traced_cuda_synchronize(device=None):
    st = _STATE
    if st is not None and _direct_caller_in_repo():
        _note_blocking_impl(st, "device_sync", None, 2)
    return _ORIG["cuda_synchronize"](device)


def _traced_stream_synchronize(self):
    st = _STATE
    if st is not None and _direct_caller_in_repo():
        _note_blocking_impl(st, "device_sync", None, 2)
    return _ORIG["stream_synchronize"](self)


def _traced_event_synchronize(self):
    st = _STATE
    if st is not None and _direct_caller_in_repo():
        _note_blocking_impl(st, "device_sync", None, 2)
    return _ORIG["event_synchronize"](self)


# -- install / uninstall ------------------------------------------------------

def enabled() -> bool:
    return _STATE is not None


def install() -> None:
    """Arm the sanitizer: patch lock construction (framework callers
    only) and the blocking-call probe set. Idempotent."""
    global _STATE
    if _STATE is not None:
        return
    _STATE = _State()
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    time.sleep = _traced_sleep
    queue.Queue.get = _traced_queue_get
    queue.Queue.put = _traced_queue_put
    _ORIG["Condition"].wait = _traced_cond_wait
    threading.Event.wait = _traced_event_wait
    threading.Thread.join = _traced_thread_join
    socket.create_connection = _traced_create_connection
    torch.cuda.synchronize = _traced_cuda_synchronize
    torch.cuda.Stream.synchronize = _traced_stream_synchronize
    torch.cuda.Event.synchronize = _traced_event_synchronize


def uninstall() -> None:
    """Restore every patched primitive and drop the state. Traced lock
    instances created while armed keep working (raw delegation)."""
    global _STATE
    if _STATE is None:
        return
    threading.Lock = _ORIG["Lock"]
    threading.RLock = _ORIG["RLock"]
    threading.Condition = _ORIG["Condition"]
    time.sleep = _ORIG["sleep"]
    queue.Queue.get = _ORIG["queue_get"]
    queue.Queue.put = _ORIG["queue_put"]
    _ORIG["Condition"].wait = _ORIG["cond_wait"]
    threading.Event.wait = _ORIG["event_wait"]
    threading.Thread.join = _ORIG["thread_join"]
    socket.create_connection = _ORIG["create_connection"]
    torch.cuda.synchronize = _ORIG["cuda_synchronize"]
    torch.cuda.Stream.synchronize = _ORIG["stream_synchronize"]
    torch.cuda.Event.synchronize = _ORIG["event_synchronize"]
    _STATE = None


def reset() -> None:
    """Clear the recorded graph but stay armed (fresh run boundary)."""
    st = _STATE
    if st is None:
        return
    with st.mu:
        st.edges.clear()
        st.blocking.clear()
        st.dispatch.clear()


def traced_lock(name: Optional[str] = None):
    """Explicitly-traced Lock for tests/fixtures outside the package
    tree (the constructor patch only auto-wraps framework callers).
    Requires install()."""
    if _STATE is None:
        raise RuntimeError("locktrace is not installed (DL4J_LOCKCHECK=1 "
                           "or locktrace.install())")
    near = _nearest_repo_site(2) or ("<external>:0", "?")
    site = name or near[0]
    return _TracedLock(site, near[1], name=name)


def traced_rlock(name: Optional[str] = None):
    """Explicitly-traced RLock (see traced_lock)."""
    if _STATE is None:
        raise RuntimeError("locktrace is not installed (DL4J_LOCKCHECK=1 "
                           "or locktrace.install())")
    near = _nearest_repo_site(2) or ("<external>:0", "?")
    site = name or near[0]
    return _TracedRLock(site, near[1], name=name)


# -- export ------------------------------------------------------------------

def snapshot() -> dict:
    """JSON-safe export of the whole runtime graph for
    analysis/concurrency_audit: lock classes, order edges with
    witnesses, blocking-under-lock records, dispatch-under-lock
    records."""
    st = _STATE
    if st is None:
        return {"enabled": False, "locks": {}, "edges": [],
                "blocking": [], "dispatch": []}
    with st.mu:
        locks = {site: dict(rec) for site, rec in st.locks.items()}
        edges = [{"src": a, "dst": b, **rec}
                 for (a, b), rec in st.edges.items()]
        blocking = [{"kind": k, "site": s, **rec}
                    for (k, s), rec in st.blocking.items()]
        dispatch = [{"what": w, "site": s, **rec}
                    for (w, s), rec in st.dispatch.items()]
    return {"enabled": True, "locks": locks, "edges": edges,
            "blocking": blocking, "dispatch": dispatch}


def _wait_cycles(st: _State) -> List[List[dict]]:
    """Thread-level wait-for cycles: A waits on a lock B owns, B waits
    on a lock A owns — the live deadlock, named. Called under st.mu."""
    cycles: List[List[dict]] = []
    seen_sigs = set()
    for start in list(st.waiting):
        path: List[dict] = []
        index: Dict[int, int] = {}
        cur = start
        while cur in st.waiting:
            if cur in index:
                cyc = path[index[cur]:]
                sig = frozenset(e["ident"] for e in cyc)
                if sig not in seen_sigs:
                    seen_sigs.add(sig)
                    cycles.append([{k: v for k, v in e.items()
                                    if k != "ident"} for e in cyc])
                break
            index[cur] = len(path)
            w = st.waiting[cur]
            own = st.owners.get(w["lock"])
            path.append({
                "ident": cur,
                "thread": w["thread"],
                "waits_for": w["site"],
                "waited_s": round(time.monotonic() - w["since"], 3),
                "held_by": own["thread"] if own else None,
            })
            if own is None:
                break
            cur = own["ident"]
    return cycles


def forensics() -> Optional[dict]:
    """Ownership + waiter wait-graph for crash/stall dumps (consumed by
    utils/blackbox). None when the sanitizer is off — the dump section
    simply doesn't exist then."""
    st = _STATE
    if st is None:
        return None
    with st.mu:
        held: Dict[str, List[dict]] = {}
        for own in st.owners.values():
            held.setdefault(own["thread"], []).append(
                {"site": own["site"], "depth": own["depth"]})
        waiting = [{"thread": w["thread"], "waits_for": w["site"],
                    "waited_s": round(time.monotonic() - w["since"], 3)}
                   for w in st.waiting.values()]
        cycles = _wait_cycles(st)
    return {"enabled": True, "held": held, "waiting": waiting,
            "deadlock_cycles": cycles}


if os.environ.get("DL4J_LOCKCHECK", "") == "1":
    install()
