"""Concurrency/robustness lint — AST checkers over the repo itself.

The thread-leak class once fixed by hand (producers blocked forever on
queues nobody drains, anonymous daemon threads impossible to attribute
in a dump) had no tool preventing its reintroduction. This pass encodes
those conventions as enforceable checks, in the spirit of compile-time
race detection (RacerD, Blackshear et al.) scaled to what an AST can
prove:

  CC001  bare `except:` — swallows KeyboardInterrupt/SystemExit and
         hides real bugs; catch something
  CC002  queue .put/.get without a timeout in a module that runs
         threads — the caller wedges forever when its peer dies
         (data/'s `_put_abortable`/`_get_abortable` and
         utils/concurrency are the sanctioned shapes)
  CC003  thread constructed without a name — undiagnosable in thread
         dumps; the dl4j-* naming convention is enforced
  CC004  thread neither daemon nor joined in its creating scope — can
         hold the interpreter alive on exit
  CC005  lock-order cycle: nested lock scopes — `with <lock>:` AND the
         `acquire()`/`try`/`finally`/`release()` call form, including
         Condition-guarded locks — acquiring locks in conflicting
         orders across the module (static deadlock)
  CC006  print() in library code — the deeplearning4j_tpu_torch logger
         is the only sanctioned channel (cli.py and bench.py are
         operator surfaces and exempt)
  CC007  `time.time()` in deadline/timeout arithmetic — wall-clock
         jumps (NTP slew, manual resets) silently shrink or stretch a
         deadline computed from it; time.monotonic() is the only clock
         deadlines may be built on. Detected when a statement both
         calls `time.time()` and mentions a deadline-ish identifier
         (deadline/timeout/expire/remaining/retry_after...); plain
         timestamping (`"ts": time.time()`) stays legal.

The pass also feeds the concurrency-audit vocabulary (CN codes, see
analysis/concurrency_audit) where a finding is detectable without
running:

  CN002  blocking call lexically inside a held lock scope —
         time.sleep, queue get/put, a Condition/Event wait on *another*
         lock, Thread.join, socket/HTTP I/O, a device sync
         (block_until_ready; torch.cuda.synchronize and a Stream's or
         Event's .synchronize())
         (WARNING: the runtime sanitizer is the authority; the lexical
         hit is the early warning)
  CN003  dispatch-shaped call (step_fn/fit_fn/*_jit, a CUDA graph's
         .replay()) entered with a lock held (WARNING)

Findings carry stable names (`CODE:path:scope[#n]`, no line numbers) so
the gate can diff them against the committed baseline,
deeplearning4j_tpu_torch/analysis/lint_baseline.txt: the gate starts
green and only regressions fail.

The port of the JAX package's analysis/lint.py: the same codes, names
and flags, with the port's dispatch and sync vocabulary added beside the
JAX ones, so both linters give identical names for the same sources.

Run: python -m deeplearning4j_tpu_torch.analysis.lint [--json -] [paths...]
"""

from __future__ import annotations

import ast
import json
import os
import re
import sys
from typing import Dict, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.analysis.findings import (
    ERROR,
    WARNING,
    Finding,
    error_names,
    format_findings,
    summarize,
)

DEFAULT_TARGETS = ("deeplearning4j_tpu_torch",)
# operator surfaces whose stdout IS the interface (lint.py's own CLI
# output included — it is what the gate reads)
PRINT_EXEMPT_BASENAMES = ("cli.py", "bench.py", "lint.py",
                          "concurrency_audit.py")
THREAD_NAME_PREFIX = "dl4j-"

# receiver heuristic for queue ops: the last attribute/name segment, sans
# leading underscores, is queue-ish ("q", "queue", "handoff", "*_q", ...)
_QUEUE_NAME = re.compile(r"^_*(q|queue|handoff|.*_q|.*_queue|.*_handoff)$")
_LOCK_NAME = re.compile(r"(^|_)(lock|mutex)s?$", re.IGNORECASE)
# Condition-ish receivers guard a lock: `with self._wake:` acquires the
# underlying lock exactly like `with self._lock:` does, so they join
# the same lock-order graph (and `<cond>.wait()` releases only its OWN
# lock — waiting while another lock is held is a CN002)
_CONDISH = re.compile(
    r"(^|_)(cond|cv|condition|wake|not_empty|not_full|all_tasks_done)s?$",
    re.IGNORECASE)
# Event-ish receivers: `.wait()` on one of these blocks without
# releasing anything — always a CN002 under a held lock
_EVENTISH = re.compile(
    r"(^|_)(event|evt)s?$|(^|_)stop(ped)?$|(^|_)(done|ready)$",
    re.IGNORECASE)
# dispatch-shaped callables for the static CN003 heuristic: the JAX
# package's jitted step names, and a CUDA graph's replay()
_JIT_FN = re.compile(r"(^|_)(step_fn|fit_fn|train_fn)$|jitted|_jit$|^replay$")
# identifiers that mark a statement as deadline/timeout arithmetic
# (CC007): a `time.time()` in the same statement is wall-clock math on
# a duration contract
_DEADLINE_NAME = re.compile(
    r"deadline|timeout|expire|expiry|remaining|retry_after|retry_by|"
    r"stall_after|due_at", re.IGNORECASE)


def _is_walltime_call(node: ast.Call) -> bool:
    """`time.time()` — the wall clock. (A bare `time()` from
    `from time import time` is rare in this repo and ambiguous with
    user-defined callables, so only the dotted form is claimed.)"""
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "time"
            and isinstance(f.value, ast.Name) and f.value.id == "time"
            and not node.args and not node.keywords)


def _is_queue_receiver(node: ast.expr) -> bool:
    if isinstance(node, ast.Attribute):
        return bool(_QUEUE_NAME.match(node.attr))
    if isinstance(node, ast.Name):
        return bool(_QUEUE_NAME.match(node.id))
    return False


# receiver names that plausibly hold a thread: `t`, `t0`, anything with
# thread/worker in it, or the `_collect_t`-style `*_t` suffix convention
_THREADISH = re.compile(r"^t\d*$|thread|worker|_t$", re.IGNORECASE)


def _is_threadish_receiver(node: ast.expr) -> bool:
    if isinstance(node, ast.Attribute):
        return bool(_THREADISH.search(node.attr))
    if isinstance(node, ast.Name):
        return bool(_THREADISH.search(node.id))
    return False


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _blocking_without_timeout(node: ast.Call, is_get: bool) -> bool:
    """Whether a queue .get/.put call can block with no deadline.
    Signatures: get(block=True, timeout=None); put(item, block=True,
    timeout=None). An explicit block=False — keyword OR positional —
    raises Empty/Full immediately and cannot wedge; a present timeout
    (keyword or positional) bounds the block."""
    args = node.args
    if any(isinstance(a, ast.Starred) for a in args):
        return False  # cannot reason statically
    if _kwarg(node, "timeout") is not None:
        return False
    block_kw = _kwarg(node, "block")
    if isinstance(block_kw, ast.Constant) and block_kw.value is False:
        return False
    pos_block = 0 if is_get else 1
    if len(args) > pos_block + 1:
        return False  # timeout passed positionally
    if len(args) > pos_block:
        b = args[pos_block]
        if isinstance(b, ast.Constant) and b.value is False:
            return False  # q.get(False) / q.put(x, False)
        return True  # q.get(True) / q.put(x, True): blocking, no timeout
    if not is_get and len(args) < 1:
        return False  # put() with item passed by keyword — not our shape
    return True


def _lock_source(node: ast.expr) -> Optional[str]:
    """Dotted source of a lock-ish (or Condition-ish — a Condition
    guards a lock) expression, or None."""
    try:
        src = ast.unparse(node)
    except Exception:
        return None
    last = src.split(".")[-1].split("(")[0]
    if _LOCK_NAME.search(last) or _CONDISH.search(last):
        return src
    return None


def _is_eventish_receiver(node: ast.expr) -> bool:
    if isinstance(node, ast.Attribute):
        return bool(_EVENTISH.search(node.attr))
    if isinstance(node, ast.Name):
        return bool(_EVENTISH.search(node.id))
    return False


def _is_nonblocking_qcall(node: ast.Call, is_get: bool) -> bool:
    """block=False (keyword or positional) — raises instead of blocking."""
    block_kw = _kwarg(node, "block")
    if isinstance(block_kw, ast.Constant) and block_kw.value is False:
        return True
    pos = 0 if is_get else 1
    if len(node.args) > pos:
        b = node.args[pos]
        if isinstance(b, ast.Constant) and b.value is False:
            return True
    return False


class _ModuleLinter(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, tree: ast.Module):
        self.path = path
        self.rel = rel
        self.tree = tree
        self.findings: List[Finding] = []
        self._scope: List[str] = []          # qualname stack
        self._per_scope_counts: Dict[Tuple[str, str], int] = {}
        self._lock_stack: List[str] = []     # locks held lexically
        self._class_stack: List[str] = []
        # module-wide lock-order edges: (a, b) -> first location
        self.lock_edges: Dict[Tuple[str, str], str] = {}
        # `path:line` of a threading.Lock/RLock/Condition construction
        # -> lexical lock key; lets concurrency_audit join the RUNTIME
        # lock-order graph (keyed by construction site) with this
        # lexical one (keyed by Class.attr)
        self.lock_ctor_sites: Dict[str, str] = {}
        src = ast.dump(tree)
        self.runs_threads = ("Thread" in src) or any(
            isinstance(n, (ast.Import, ast.ImportFrom))
            and "threading" in ast.dump(n)
            for n in tree.body)
        self.print_exempt = os.path.basename(path) in PRINT_EXEMPT_BASENAMES

    # -- helpers -------------------------------------------------------------

    def _qualname(self) -> str:
        return ".".join(self._scope) or "<module>"

    def _emit(self, code: str, severity: str, node: ast.AST, message: str,
              fix_hint: str):
        scope = self._qualname()
        key = (code, scope)
        n = self._per_scope_counts.get(key, 0) + 1
        self._per_scope_counts[key] = n
        suffix = "" if n == 1 else f"#{n}"
        self.findings.append(Finding(
            code, severity, f"{self.rel}:{node.lineno}", message, fix_hint,
            name=f"{code}:{self.rel}:{scope}{suffix}"))

    def _lock_key(self, src: str) -> str:
        # class-attribute locks are keyed by Class.attr WITHOUT the
        # module path, so acquisitions of the same class's locks connect
        # across modules in the repo-wide edge graph; module-level locks
        # stay module-scoped (a bare name means nothing elsewhere)
        if src.startswith("self.") and self._class_stack:
            return f"{self._class_stack[-1]}.{src[5:]}"
        return f"{self.rel}:{src}"

    # -- scope tracking ------------------------------------------------------

    def _visit_scope(self, node, name: str):
        self._scope.append(name)
        held = list(self._lock_stack)
        self._lock_stack = []  # lexical lock nesting does not cross defs
        self.generic_visit(node)
        self._lock_stack = held
        self._scope.pop()

    def visit_FunctionDef(self, node):
        self._visit_scope(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._class_stack.append(node.name)
        self._visit_scope(node, node.name)
        self._class_stack.pop()

    # -- CC007 statement tracking --------------------------------------------

    # the statement currently being visited: CC007 is a statement-level
    # judgment ("this statement does deadline math on the wall clock"),
    # but the trigger is a Call node deep inside it
    _stmt: Optional[ast.stmt] = None

    def visit(self, node):
        if isinstance(node, ast.stmt):
            self._stmt = node
        return super().visit(node)

    # a compound statement's nested suites are separate statements with
    # their own judgment — `if time.time() - last > 60:` must not become
    # a finding just because its BODY mentions a timeout somewhere
    _NESTED_SUITE_FIELDS = ("body", "orelse", "finalbody", "handlers")

    @classmethod
    def _mentions_deadline(cls, stmt: ast.stmt) -> bool:
        """Any identifier in the statement's own expressions — name,
        attribute, parameter, keyword argument — that reads as
        deadline/timeout vocabulary. Nested suites are excluded (each
        inner statement is judged on its own), and string constants
        ('{"ts": time.time()}') deliberately do NOT count: timestamping
        stays legal."""
        roots = []
        for field, value in ast.iter_fields(stmt):
            if field in cls._NESTED_SUITE_FIELDS:
                continue
            for n in (value if isinstance(value, list) else [value]):
                if isinstance(n, ast.AST):
                    roots.append(n)
        for root in roots:
            for sub in ast.walk(root):
                if isinstance(sub, ast.Name) \
                        and _DEADLINE_NAME.search(sub.id):
                    return True
                if isinstance(sub, ast.Attribute) \
                        and _DEADLINE_NAME.search(sub.attr):
                    return True
                if isinstance(sub, (ast.arg, ast.keyword)) \
                        and sub.arg and _DEADLINE_NAME.search(sub.arg):
                    return True
        return False

    # -- CC001 bare except ---------------------------------------------------

    def visit_ExceptHandler(self, node):
        if node.type is None:
            self._emit(
                "CC001", ERROR, node,
                "bare `except:` swallows KeyboardInterrupt/SystemExit",
                "catch Exception (or something narrower) and handle or "
                "log it")
        self.generic_visit(node)

    # -- CC002/CC003/CC004/CC006 via calls -----------------------------------

    def visit_Call(self, node):
        func = node.func
        # CC006: print() in library code
        if (isinstance(func, ast.Name) and func.id == "print"
                and not self.print_exempt):
            self._emit(
                "CC006", ERROR, node,
                "print() in library code",
                'log via logging.getLogger("deeplearning4j_tpu_torch") — '
                "or grandfather the site in the lint baseline if it is a "
                "real operator surface")
        # CC003/CC004: threading.Thread(...) construction
        is_thread = (isinstance(func, ast.Name) and func.id == "Thread") or \
            (isinstance(func, ast.Attribute) and func.attr == "Thread")
        if is_thread:
            name_kw = _kwarg(node, "name")
            if name_kw is None:
                self._emit(
                    "CC003", ERROR, node,
                    "thread constructed without a name",
                    f'pass name="{THREAD_NAME_PREFIX}<component>-<role>" '
                    "so thread dumps are attributable")
            elif (isinstance(name_kw, ast.Constant)
                  and isinstance(name_kw.value, str)
                  and not name_kw.value.startswith(THREAD_NAME_PREFIX)):
                self._emit(
                    "CC003", ERROR, node,
                    f"thread name {name_kw.value!r} does not follow the "
                    f"{THREAD_NAME_PREFIX}* convention",
                    f"prefix the name with {THREAD_NAME_PREFIX!r}")
            if not _is_true(_kwarg(node, "daemon")) \
                    and not self._daemon_assigned_nearby(node):
                self._emit(
                    "CC004", ERROR, node,
                    "thread is neither daemon=True nor visibly joined",
                    "pass daemon=True (and still close/join it "
                    "deterministically where possible)")
        # CC007: wall-clock deadline arithmetic. time.time() is only a
        # finding when the SAME statement speaks deadline vocabulary —
        # `deadline = time.time() + budget` is the bug (NTP slew moves
        # the deadline), `{"ts": time.time()}` is legal timestamping.
        if isinstance(node, ast.Call) and _is_walltime_call(node) \
                and self._stmt is not None \
                and self._mentions_deadline(self._stmt):
            self._emit(
                "CC007", ERROR, node,
                "time.time() in deadline/timeout arithmetic — wall-clock "
                "jumps silently shrink or stretch the deadline",
                "build deadlines on time.monotonic(); keep time.time() "
                "for human-facing timestamps only")
        # CC002: queue put/get without timeout in thread code
        if (self.runs_threads and isinstance(func, ast.Attribute)
                and func.attr in ("put", "get")
                and _is_queue_receiver(func.value)):
            if _blocking_without_timeout(node, is_get=func.attr == "get"):
                self._emit(
                    "CC002", ERROR, node,
                    f"queue .{func.attr}() without a timeout in thread "
                    "code — wedges forever when the peer thread dies",
                    "use utils/concurrency.put_abortable/get_abortable "
                    "(or pass timeout= in a poll loop)")
        # CC005 (call form): lock.acquire()/release() participate in the
        # same lock-order graph as `with lock:` — the try/finally idiom
        # was invisible to the lexical pass before
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            src = _lock_source(func.value)
            if src is not None:
                key = self._lock_key(src)
                for held in self._lock_stack:
                    if held != key:
                        self.lock_edges.setdefault(
                            (held, key), f"{self.rel}:{node.lineno}")
                self._lock_stack.append(key)
        elif isinstance(func, ast.Attribute) and func.attr == "release":
            src = _lock_source(func.value)
            if src is not None:
                key = self._lock_key(src)
                for i in range(len(self._lock_stack) - 1, -1, -1):
                    if self._lock_stack[i] == key:
                        del self._lock_stack[i]
                        break
        if self._lock_stack:
            self._check_blocking_under_lock(node, func)
        self.generic_visit(node)

    # -- CN002/CN003: blocking calls lexically under a held lock -------------

    def _check_blocking_under_lock(self, node: ast.Call, func):
        """Static half of the CN002/CN003 runtime probes (WARNING: the
        sanitizer is the authority, this is the no-run early warning).
        Waiting on a Condition that is itself on the lock stack is
        exempt for its OWN lock — `with cond: cond.wait()` is THE
        pattern — but still a finding when other locks stay held."""
        held = sorted(set(self._lock_stack))
        blocked = None
        if isinstance(func, ast.Attribute):
            attr = func.attr
            if attr == "sleep" and isinstance(func.value, ast.Name) \
                    and func.value.id == "time":
                blocked = "time.sleep"
            elif attr in ("get", "put") and _is_queue_receiver(func.value):
                if not _is_nonblocking_qcall(node, is_get=attr == "get"):
                    blocked = f"queue.{attr}"
            elif attr == "wait":
                src = _lock_source(func.value)
                if src is not None:
                    key = self._lock_key(src)
                    others = sorted(set(k for k in self._lock_stack
                                        if k != key))
                    if others:
                        blocked = "condition.wait"
                        held = others
                elif _is_eventish_receiver(func.value):
                    blocked = "event.wait"
            elif attr == "join" and _is_threadish_receiver(func.value):
                blocked = "thread.join"
            elif attr in ("block_until_ready", "synchronize"):
                # torch.cuda.synchronize(), Stream/Event.synchronize()
                blocked = "device_sync"
            elif attr in ("urlopen", "create_connection", "getresponse"):
                blocked = "socket/http"
        elif isinstance(func, ast.Name) and func.id == "urlopen":
            blocked = "socket/http"
        if blocked is not None:
            self._emit(
                "CN002", WARNING, node,
                f"{blocked} while holding lock(s) {', '.join(held)} — "
                "every peer contending for the lock stalls behind this "
                "call (and it can deadlock against the thread that "
                "would unblock it)",
                "snapshot state under the lock, release, THEN block; "
                "or baseline it in the lock baseline with a comment")
            return
        tgt = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        if tgt is not None and _JIT_FN.search(tgt):
            self._emit(
                "CN003", WARNING, node,
                f"device dispatch {tgt}() entered while holding lock(s) "
                f"{', '.join(held)} — the lock is held for a whole "
                "device program (and a compile, on the first call)",
                "stage inputs under the lock, dispatch outside it")

    def _daemon_assigned_nearby(self, call: ast.Call) -> bool:
        """True if the enclosing function also assigns `<x>.daemon = True`
        or joins a thread-ish receiver (conservative: any such statement
        counts). `join` is only credited when the receiver NAME looks
        like a thread — otherwise the ubiquitous str.join (`",".join`,
        `sep.join`) would silently disable the whole check."""
        scope = self._enclosing_function
        if scope is None:
            return False
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and tgt.attr == "daemon" \
                            and _is_true(sub.value):
                        return True
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "join" \
                    and _is_threadish_receiver(sub.func.value):
                return True
        return False

    # -- lock construction sites (runtime-graph join points) ------------------

    def visit_Assign(self, node):
        v = node.value
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
                and v.func.attr in ("Lock", "RLock", "Condition") \
                and isinstance(v.func.value, ast.Name) \
                and v.func.value.id == "threading":
            for tgt in node.targets:
                try:
                    src = ast.unparse(tgt)
                except Exception:
                    continue
                self.lock_ctor_sites[f"{self.rel}:{v.lineno}"] = \
                    self._lock_key(src)
                break
        self.generic_visit(node)

    # -- CC005 lock-order edges ----------------------------------------------

    def visit_With(self, node):
        acquired = []
        for item in node.items:
            src = _lock_source(item.context_expr)
            if src is not None:
                key = self._lock_key(src)
                for held in self._lock_stack:
                    if held != key:
                        self.lock_edges.setdefault(
                            (held, key), f"{self.rel}:{node.lineno}")
                acquired.append(key)
                self._lock_stack.append(key)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._lock_stack.pop()

    visit_AsyncWith = visit_With

    # -- generic visit keeps track of the innermost function -----------------

    _enclosing_function: Optional[ast.AST] = None

    def generic_visit(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            prev = self._enclosing_function
            self._enclosing_function = node
            super().generic_visit(node)
            self._enclosing_function = prev
        else:
            super().generic_visit(node)


def _find_cycles(edges: Dict[Tuple[str, str], str]) -> List[Tuple[List[str], str]]:
    """Cycles in the lock-order graph. Returns (cycle nodes, a location
    of one edge on the cycle)."""
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycles: List[Tuple[List[str], str]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()
    state: Dict[str, int] = {}  # 0 visiting, 1 done

    def dfs(n: str, path: List[str]):
        state[n] = 0
        path.append(n)
        for m in sorted(graph.get(n, ())):
            if state.get(m) == 0:
                cycle = path[path.index(m):]
                sig = tuple(sorted(cycle))
                if sig not in seen_cycles:
                    seen_cycles.add(sig)
                    loc = edges.get((n, m)) or edges.get((m, cycle[0]), "?")
                    cycles.append((cycle + [m], loc))
            elif m not in state:
                dfs(m, path)
        path.pop()
        state[n] = 1

    for n in sorted(graph):
        if n not in state:
            dfs(n, [])
    return cycles


def _py_files(paths) -> List[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                out.extend(os.path.join(root, f)
                           for f in files if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(out)


def collect(paths=DEFAULT_TARGETS, base_dir: Optional[str] = None):
    """Lint files/directories, returning the full lexical harvest:
    ``(findings, lock_edges, lock_ctor_sites)``. The extra two are what
    analysis/concurrency_audit merges with the runtime lock-order graph
    (edges -> static/runtime/both labels; ctor sites -> joining a
    runtime ``path:line`` lock class to its lexical ``Class.attr``
    key). Finding names are stable relative paths rooted at `base_dir`
    (default: cwd)."""
    base = os.path.abspath(base_dir or os.getcwd())
    findings: List[Finding] = []
    lock_edges: Dict[Tuple[str, str], str] = {}
    lock_ctor_sites: Dict[str, str] = {}
    for path in _py_files(paths):
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, base).replace(os.sep, "/")
        try:
            with open(ap, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=ap)
        except (OSError, SyntaxError) as e:
            findings.append(Finding(
                "CC000", ERROR, rel, f"could not parse: {e}",
                "fix the file", name=f"CC000:{rel}"))
            continue
        linter = _ModuleLinter(ap, rel, tree)
        linter.visit(tree)
        findings.extend(linter.findings)
        lock_edges.update(linter.lock_edges)
        lock_ctor_sites.update(linter.lock_ctor_sites)
    for cycle, loc in _find_cycles(lock_edges):
        order = " -> ".join(cycle)
        findings.append(Finding(
            "CC005", ERROR, loc,
            f"lock-order cycle: {order} — two code paths acquire these "
            "locks in conflicting orders (potential deadlock)",
            "pick one global order for these locks and stick to it",
            name="CC005:" + "->".join(sorted(set(cycle)))))
    return findings, lock_edges, lock_ctor_sites


def lint_paths(paths=DEFAULT_TARGETS, base_dir: Optional[str] = None
               ) -> List[Finding]:
    """Lint files/directories; finding names are stable relative paths
    rooted at `base_dir` (default: cwd)."""
    return collect(paths, base_dir)[0]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.analysis.lint",
        description="concurrency/robustness lint (CC001-CC007)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_TARGETS})")
    ap.add_argument("--json", dest="json_out", default=None, metavar="PATH",
                    help="write the findings summary as JSON ('-' = stdout)")
    ap.add_argument("--errors-out", default=None, metavar="PATH",
                    help="write sorted ERROR finding names (one per line) "
                         "— the artifact the gate diffs against the "
                         "baseline")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppress ERROR findings whose names appear in "
                         "this file; exit 1 only on new ones")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human-readable listing")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths or DEFAULT_TARGETS)
    names = error_names(findings)

    if args.errors_out:
        with open(args.errors_out, "w") as f:
            f.write("".join(n + "\n" for n in names))
    if args.json_out == "-":
        print(json.dumps(summarize(findings), indent=2))
    elif args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summarize(findings), f, indent=2)
        print(f"wrote {args.json_out}")
    elif not args.quiet:
        print(format_findings(findings))

    if args.baseline:
        try:
            with open(args.baseline) as f:
                allowed = {ln.strip() for ln in f
                           if ln.strip() and not ln.startswith("#")}
        except OSError as e:
            print(f"lint: cannot read baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        new = [n for n in names if n not in allowed]
        if new:
            print("LINT REGRESSIONS — ERROR findings not in "
                  f"{args.baseline}:", file=sys.stderr)
            for n in new:
                print(f"  {n}", file=sys.stderr)
            return 1
        return 0
    return 1 if names else 0


if __name__ == "__main__":
    sys.exit(main())
