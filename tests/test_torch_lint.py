"""The port's concurrency lint (analysis/lint.py) against the JAX
package's, mirroring the lint cases of tests/test_analysis.py: one
fixture per CC*** code, the sanctioned shapes, CC007's wall-clock
deadlines, the str.join and positional-block corner cases, the lock-order
cycle, the baseline gate and `cli lint`. Both linters run over the same
fixture sources written to tmp_path and must give identical finding
names; the port's own dispatch and sync vocabulary (a CUDA graph's
replay(), torch.cuda syncs) is held on its own. The gate: no ERROR
finding on the port's tree outside its committed baseline, and no CN
finding at all."""

import json
import os
import textwrap

import pytest

from deeplearning4j_tpu.analysis import lint as jax_lint
from deeplearning4j_tpu_torch.analysis import lint
from deeplearning4j_tpu_torch.analysis.findings import ERROR
from deeplearning4j_tpu_torch.analysis.lint import lint_paths
from deeplearning4j_tpu_torch.analysis.lint import main as lint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deeplearning4j_tpu_torch")
BASELINE = os.path.join(PKG, "analysis", "lint_baseline.txt")


def codes(fs):
    return [f.code for f in fs]


def errors(fs):
    return [f for f in fs if f.severity == ERROR]


_BAD_MODULE = textwrap.dedent("""\
    import queue
    import threading
    import time

    q = queue.Queue(maxsize=2)


    def wait_until(timeout):
        deadline = time.time() + timeout
        return deadline


    def worker():
        while True:
            try:
                item = q.get()
            except:
                pass
            print(item)


    def start():
        t = threading.Thread(target=worker)
        t.start()
        q.put(1)


    class A:
        def __init__(self):
            self._lock = threading.Lock()
            self._stats_lock = threading.Lock()

        def f(self):
            with self._lock:
                with self._stats_lock:
                    pass

        def g(self):
            with self._stats_lock:
                with self._lock:
                    pass
    """)

_GOOD_MODULE = textwrap.dedent("""\
    import queue
    import threading

    from deeplearning4j_tpu_torch.utils.concurrency import (
        get_abortable,
        put_abortable,
    )

    q = queue.Queue(maxsize=2)
    stop = threading.Event()


    def worker():
        while True:
            try:
                item = get_abortable(q, stop)
            except Exception:
                return
            q.put(item, timeout=0.5)


    def start():
        t = threading.Thread(target=worker, daemon=True,
                             name="dl4j-test-worker")
        t.start()
        put_abortable(q, 1, stop)
        q.put_nowait(2)
        q.put(3, block=False)  # cannot wedge: raises Full immediately
    """)

_CLOCKS = textwrap.dedent("""\
    import time


    def legal(budget):
        deadline = time.monotonic() + budget  # sanctioned clock
        meta = {"ts": time.time()}            # timestamping
        wall = time.time()                    # no deadline words
        return deadline, meta, wall


    def bad_expiry():
        expires_at = time.time() + 60.0
        return expires_at


    def bad_poll(timeout):
        while time.time() < timeout:
            pass
    """)

_JOINER_BAD = textwrap.dedent("""\
    import threading


    def start(names):
        label = ",".join(names)
        t = threading.Thread(target=print, name="dl4j-x-" + label)
        t.start()
    """)

_JOINER_GOOD = _JOINER_BAD + "    t.join()\n"

_POSARGS = textwrap.dedent("""\
    import queue
    import threading

    q = queue.Queue(maxsize=2)


    def f():
        q.put(1, True)


    def g():
        return q.get(False)
    """)

_ORDERED = textwrap.dedent("""\
    import threading

    a = threading.Lock()
    b_lock = threading.Lock()


    def f():
        with a:
            with b_lock:
                pass


    def g():
        with a:
            with b_lock:
                pass
    """)

_FIXTURES = {
    "badmod.py": _BAD_MODULE,
    "goodmod.py": _GOOD_MODULE,
    "clocks.py": _CLOCKS,
    "joiner_bad.py": _JOINER_BAD,
    "joiner_good.py": _JOINER_GOOD,
    "posargs.py": _POSARGS,
    "ordered.py": _ORDERED,
}


@pytest.fixture
def bad_module(tmp_path):
    p = tmp_path / "badmod.py"
    p.write_text(_BAD_MODULE)
    return p


def _write(tmp_path, name):
    p = tmp_path / name
    p.write_text(_FIXTURES[name])
    return p


def test_lint_flags_every_code_once(bad_module):
    fs = lint_paths([str(bad_module)], base_dir=str(bad_module.parent))
    got = sorted(set(codes(fs)))
    assert got == ["CC001", "CC002", "CC003", "CC004", "CC005", "CC006",
                   "CC007"]
    # stable names: scope-qualified, no line numbers
    names = {f.name for f in fs}
    assert "CC001:badmod.py:worker" in names
    assert "CC002:badmod.py:start" in names  # the timeout-less q.put(1)
    assert any(n.startswith("CC005:") for n in names)
    assert "CC007:badmod.py:wait_until" in names


def test_lint_accepts_the_sanctioned_shapes(tmp_path):
    p = _write(tmp_path, "goodmod.py")
    assert lint_paths([str(p)], base_dir=str(tmp_path)) == []


def test_lint_cc007_walltime_deadlines(tmp_path):
    """CC007 fires only on wall-clock DEADLINE arithmetic: monotonic
    deadlines and plain timestamping both stay legal."""
    p = _write(tmp_path, "clocks.py")
    fs = lint_paths([str(p)], base_dir=str(tmp_path))
    assert sorted(f.name for f in fs) == [
        "CC007:clocks.py:bad_expiry", "CC007:clocks.py:bad_poll"]


def test_lint_str_join_does_not_mask_cc004(tmp_path):
    """str.join in the same function must not count as joining the
    thread — only thread-ish receivers satisfy CC004."""
    p = _write(tmp_path, "joiner_bad.py")
    assert "CC004" in codes(lint_paths([str(p)], base_dir=str(tmp_path)))
    p = _write(tmp_path, "joiner_good.py")
    assert "CC004" not in codes(lint_paths([str(p)], base_dir=str(tmp_path)))


def test_lint_positional_block_forms(tmp_path):
    """q.put(item, True) blocks with no timeout -> CC002; q.get(False)
    cannot block -> clean."""
    p = _write(tmp_path, "posargs.py")
    fs = lint_paths([str(p)], base_dir=str(tmp_path))
    names = {f.name for f in fs if f.code == "CC002"}
    assert names == {"CC002:posargs.py:f"}


def test_lint_lock_order_cycle_needs_conflicting_orders(tmp_path):
    # consistent ordering across call sites: edges, but no cycle
    p = _write(tmp_path, "ordered.py")
    assert "CC005" not in codes(lint_paths([str(p)], base_dir=str(tmp_path)))


@pytest.mark.parametrize("name", sorted(_FIXTURES))
def test_both_linters_give_identical_names(tmp_path, name):
    """The same source through the JAX linter and the port's: the same
    finding names, codes, severities and lines, and the same lexical
    lock edges and construction sites."""
    p = _write(tmp_path, name)
    got, edges, ctor = lint.collect([str(p)], base_dir=str(tmp_path))
    ref, ref_edges, ref_ctor = jax_lint.collect([str(p)],
                                                base_dir=str(tmp_path))
    key = lambda f: (f.name, f.code, f.severity, f.location)  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, ref))
    assert edges == ref_edges and ctor == ref_ctor


_TORCH_VOCAB = textwrap.dedent("""\
    import threading

    import torch


    class E:
        def __init__(self):
            self._lock = threading.Lock()
            self.graph = None
            self.stream = None
            self.done = None

        def replay_under_lock(self):
            with self._lock:
                self.graph.replay()

        def syncs_under_lock(self):
            with self._lock:
                torch.cuda.synchronize()
                self.stream.synchronize()
                self.done.synchronize()

        def clean(self):
            with self._lock:
                g = self.graph
            g.replay()
            torch.cuda.synchronize()
    """)


def test_port_vocabulary_replay_and_syncs(tmp_path):
    """The port's dispatch and sync words beside the JAX ones: a CUDA
    graph's replay() under a lock is CN003, and torch.cuda.synchronize,
    a Stream's and an Event's synchronize() under a lock are CN002
    device_sync (the JAX block_until_ready's kind); outside the lock,
    nothing. The JAX linter knows neither word."""
    p = tmp_path / "torchvocab.py"
    p.write_text(_TORCH_VOCAB)
    fs = lint_paths([str(p)], base_dir=str(tmp_path))
    assert sorted(f.name for f in fs) == [
        "CN002:torchvocab.py:E.syncs_under_lock",
        "CN002:torchvocab.py:E.syncs_under_lock#2",
        "CN002:torchvocab.py:E.syncs_under_lock#3",
        "CN003:torchvocab.py:E.replay_under_lock",
    ]
    assert all("device_sync" in f.message for f in fs if f.code == "CN002")
    assert "replay()" in next(f.message for f in fs if f.code == "CN003")
    assert jax_lint.lint_paths([str(p)], base_dir=str(tmp_path)) == []


def _baseline():
    with open(BASELINE) as f:
        return {ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")}


def test_committed_tree_is_lint_clean_modulo_baseline():
    """THE gate invariant: no ERROR finding on the port's tree outside
    deeplearning4j_tpu_torch/analysis/lint_baseline.txt (empty), and no
    lexical CN finding either (the lock gate's static half)."""
    fs = lint_paths([PKG], base_dir=REPO)
    new = [f.name for f in errors(fs) if f.name not in _baseline()]
    assert not new, f"lint regressions vs lint_baseline.txt: {new}"
    assert _baseline() == set()
    assert [f.name for f in fs if f.code.startswith("CN")] == []
    # the default target is the port's package, relative to the repo
    assert lint.DEFAULT_TARGETS == ("deeplearning4j_tpu_torch",)


def test_lint_main_baseline_gate(bad_module, tmp_path):
    """Introducing a bare except / timeout-less put fails the gate
    (exit 1); a baseline of exactly today's names turns it green."""
    baseline = tmp_path / "baseline.txt"
    baseline.write_text("# nothing grandfathered\n")
    rc = lint_main(["--quiet", "--baseline", str(baseline),
                    str(bad_module)])
    assert rc == 1
    fs = lint_paths([str(bad_module)], base_dir=str(bad_module.parent))
    names = sorted({f.name for f in errors(fs)})
    # names are relative to CWD in main(); regenerate from there
    fs_cwd = lint_paths([str(bad_module)])
    baseline.write_text("".join(
        sorted(f.name + "\n" for f in errors(fs_cwd))))
    assert names  # sanity: the fixture does produce errors
    rc = lint_main(["--quiet", "--baseline", str(baseline),
                    str(bad_module)])
    assert rc == 0
    errs = tmp_path / "errs.txt"
    assert lint_main(["--quiet", "--errors-out", str(errs),
                      str(bad_module)]) == 1
    assert errs.read_text().split() == sorted(f.name for f in errors(fs_cwd))


def test_cli_lint_exits_nonzero_on_errors(bad_module, capsys):
    from deeplearning4j_tpu.cli import main as jax_cli_main
    from deeplearning4j_tpu_torch.cli import main as cli_main

    rc = cli_main(["--device", "cpu", "lint", "--json", "-", str(bad_module)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and not out["ok"] and out["errors"] > 0
    assert jax_cli_main(["lint", "--json", "-", str(bad_module)]) == rc
    ref = json.loads(capsys.readouterr().out)
    # the same verdict and names; the port's fix hints name its own logger
    pick = lambda d: [(f["name"], f["code"], f["severity"], f["location"])  # noqa: E731
                      for f in d["findings"]]
    assert pick(out) == pick(ref)
    assert {k: out[k] for k in ("ok", "errors", "warnings")} == {
        k: ref[k] for k in ("ok", "errors", "warnings")}
