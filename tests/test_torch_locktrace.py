"""The port's lock audit against the JAX package's: the runtime lock-order
sanitizer (utils/locktrace), the merged static + runtime audit
(analysis/concurrency_audit), deadlock forensics in black-box dumps, and
the lexical CC005/CN002/CN003 half (analysis/lint), mirroring
tests/test_concurrency_audit.py case for case on the port. Beside those:
one scenario run under each package's sanitizer in turn gives the same
CN codes and lock names; the port's device-sync probes (torch.cuda
syncs, recorded only when repo code calls them); the fit and decode
dispatch probes; the env arming in a fresh process; and the black-box
dump's `tenants` and `locks` keys, which the port's dump lacked.

Both locktrace modules are imported here, before either is installed:
each captures the stdlib originals at import. One sanitizer is armed at a
time, and DL4J_LOCKCHECK is set only in child processes."""

import json
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import concurrency_audit as jax_ca
from deeplearning4j_tpu.utils import locktrace as jax_locktrace
from deeplearning4j_tpu_torch.analysis import concurrency_audit as ca
from deeplearning4j_tpu_torch.analysis import lint
from deeplearning4j_tpu_torch.utils import locktrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tiny, lock-free file for the static half: keeps report() fast in
# tests that only exercise the runtime graph
_SMALL_STATIC = [os.path.join(
    REPO, "deeplearning4j_tpu_torch", "analysis", "findings.py")]
_JAX_SMALL_STATIC = [os.path.join(
    REPO, "deeplearning4j_tpu", "analysis", "findings.py")]


@pytest.fixture
def armed():
    """Arm the port's sanitizer for one test, restore the stdlib after."""
    assert not jax_locktrace.enabled()
    was = locktrace.enabled()
    if not was:
        locktrace.install()
    locktrace.reset()
    try:
        yield
    finally:
        if not was:
            locktrace.uninstall()


def _mlp(device="cpu"):
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder()
            .seed(42).updater(Updater.SGD).learning_rate(0.1).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=2, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _xy(n=64, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), (x.sum(axis=1) > 0).astype(int)] = 1
    return x, y


# -- CN001: reversed acquisition order ----------------------------------------

def test_reversed_order_is_cn001_with_both_witness_stacks(armed):
    """Two threads taking two locks in opposite orders — no real
    contention needed, the order graph alone convicts, and BOTH edges
    carry a stack witness naming this file."""
    a = locktrace.traced_lock("fixA")
    b = locktrace.traced_lock("fixB")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    t1 = threading.Thread(target=forward, name="dl4j-lockfix-1")
    t1.start()
    t1.join(10)
    t2 = threading.Thread(target=backward, name="dl4j-lockfix-2")
    t2.start()
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()

    snap = locktrace.snapshot()
    by_pair = {(e["src"], e["dst"]): e for e in snap["edges"]}
    assert ("fixA", "fixB") in by_pair and ("fixB", "fixA") in by_pair
    for pair in (("fixA", "fixB"), ("fixB", "fixA")):
        witness = by_pair[pair]["witness"]
        assert witness, f"edge {pair} has no witness stack"
        assert any("test_torch_locktrace" in fr for fr in witness)

    doc = ca.report(runtime=True, paths=_SMALL_STATIC, base_dir=REPO)
    cn1 = [f for f in doc["findings"] if f.code == "CN001"
           and "fixA" in f.name and "fixB" in f.name]
    assert len(cn1) == 1
    msg = cn1[0].message
    assert msg.count("witness:") == 2, msg
    assert "test_torch_locktrace" in msg
    assert "[runtime]" in msg
    assert cn1[0].name == "CN001:fixA->fixB"


def test_consistent_order_is_clean(armed):
    a = locktrace.traced_lock("okA")
    b = locktrace.traced_lock("okB")
    for _ in range(3):
        with a:
            with b:
                pass
    doc = ca.report(runtime=True, paths=_SMALL_STATIC, base_dir=REPO)
    assert not [f for f in doc["findings"] if f.code == "CN001"]
    assert any(e["src"] == "okA" and e["dst"] == "okB"
               for e in doc["edges"])


# -- deadlock forensics: the real wedge ---------------------------------------

def test_real_wedge_forensics_named_and_rendered(armed, tmp_path, capsys):
    """The same fixture wedged for REAL (bounded by acquire timeouts so
    the threads always exit): the live wait-graph names the cycle, the
    watchdog's degradation hook captures it, and the port's
    `cli blackbox` renders the DEADLOCK CYCLE section from the dump."""
    a = locktrace.traced_lock("wedgeA")
    b = locktrace.traced_lock("wedgeB")
    a_held = threading.Event()
    b_held = threading.Event()

    def holder_a():
        with a:
            a_held.set()
            b_held.wait(5)
            if b.acquire(timeout=6):
                b.release()

    def holder_b():
        with b:
            b_held.set()
            a_held.wait(5)
            if a.acquire(timeout=6):
                a.release()

    t1 = threading.Thread(target=holder_a, name="dl4j-wedge-1")
    t2 = threading.Thread(target=holder_b, name="dl4j-wedge-2")
    t1.start()
    t2.start()

    cycle = None
    deadline = time.monotonic() + 5.0
    try:
        while time.monotonic() < deadline:
            fx = locktrace.forensics()
            if fx and fx["deadlock_cycles"]:
                cycle = fx["deadlock_cycles"][0]
                break
            time.sleep(0.02)
        assert cycle is not None, "wait-graph never showed the cycle"
        names = {e["thread"] for e in cycle}
        assert names == {"dl4j-wedge-1", "dl4j-wedge-2"}
        for e in cycle:
            assert e["waits_for"] in ("wedgeA", "wedgeB")
            assert e["held_by"] in names

        # the watchdog's first-stall hook sees the same forensics
        from deeplearning4j_tpu_torch.utils import blackbox

        rec = blackbox.get_recorder()
        rec.on_degradation("lock-fixture", 1.0, ["dl4j-wedge-1"])
        assert rec.last_degradation["locks"]["deadlock_cycles"]

        dump = str(tmp_path / "wedge_dump.json")
        rec.dump(dump, reason="deadlock fixture")
    finally:
        t1.join(15)
        t2.join(15)
    assert not t1.is_alive() and not t2.is_alive()

    from deeplearning4j_tpu_torch.cli import main as cli_main

    assert cli_main(["--device", "cpu", "blackbox", dump]) == 0
    out = capsys.readouterr().out
    assert "DEADLOCK CYCLE" in out
    assert "dl4j-wedge-1" in out and "dl4j-wedge-2" in out
    assert "waits for" in out and "held by" in out


# -- CN002/CN003: runtime probes ----------------------------------------------

def test_blocking_probes_fire_under_lock_only(armed):
    lk = locktrace.traced_lock("probeL")
    # no lock held: probes stay silent
    time.sleep(0.001)
    q = queue.Queue()
    q.put(1)
    q.get()
    assert locktrace.snapshot()["blocking"] == []

    with lk:
        time.sleep(0.001)
        with pytest.raises(queue.Empty):
            q.get(timeout=0.01)
        q.put(2)
        locktrace.note_blocking("custom.rpc")
        locktrace.note_dispatch("fixture/step")
    snap = locktrace.snapshot()
    kinds = {b["kind"] for b in snap["blocking"]}
    assert {"time.sleep", "queue.get", "queue.put", "custom.rpc"} <= kinds
    for b in snap["blocking"]:
        assert "probeL" in b["held"]
    assert snap["dispatch"] and snap["dispatch"][0]["what"] == "fixture/step"
    assert "probeL" in snap["dispatch"][0]["held"]

    doc = ca.report(runtime=True, paths=_SMALL_STATIC, base_dir=REPO)
    names = ca.finding_names(doc)
    assert any(n.startswith("CN002:time.sleep:") for n in names)
    assert any(n.startswith("CN003:fixture/step:") for n in names)


def test_condition_wait_exempts_own_lock(armed):
    """`with cond: cond.wait()` is THE pattern — no finding. The same
    wait with ANOTHER traced lock still held is CN002."""
    outer = locktrace.traced_lock("cvOuter")
    cond = threading.Condition()  # raw: constructed from tests/, unwrapped

    def waker():
        time.sleep(0.05)
        with cond:
            cond.notify_all()

    t = threading.Thread(target=waker, name="dl4j-cv-waker")
    t.start()
    with cond:
        cond.wait(2)
    t.join(10)
    assert all(b["kind"] != "condition.wait"
               for b in locktrace.snapshot()["blocking"])

    t = threading.Thread(target=waker, name="dl4j-cv-waker2")
    t.start()
    with outer:
        with cond:
            cond.wait(2)
    t.join(10)
    waits = [b for b in locktrace.snapshot()["blocking"]
             if b["kind"] == "condition.wait"]
    assert waits and "cvOuter" in waits[0]["held"]


# -- the off-path contract ----------------------------------------------------

def test_uninstrumented_paths_under_10us_per_call():
    assert not locktrace.enabled()
    assert threading.Lock is locktrace._ORIG["Lock"]
    assert time.sleep is locktrace._ORIG["sleep"]
    assert torch.cuda.synchronize is locktrace._ORIG["cuda_synchronize"]
    calls = 20_000
    lk = threading.Lock()

    def acquire_release():
        lk.acquire()
        lk.release()

    for fn in (acquire_release,
               lambda: locktrace.note_dispatch("off"),
               lambda: locktrace.note_blocking("off")):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call = (time.perf_counter() - t0) / calls
        assert per_call < 10e-6, f"{fn}: {per_call * 1e6:.2f}µs/call"


def test_uninstall_restores_stdlib():
    locktrace.install()
    assert threading.Lock is not locktrace._ORIG["Lock"]
    traced = threading.Condition  # patched factory while armed
    assert traced is not locktrace._ORIG["Condition"]
    assert torch.cuda.synchronize is not locktrace._ORIG["cuda_synchronize"]
    locktrace.uninstall()
    assert threading.Lock is locktrace._ORIG["Lock"]
    assert threading.RLock is locktrace._ORIG["RLock"]
    assert threading.Condition is locktrace._ORIG["Condition"]
    assert time.sleep is locktrace._ORIG["sleep"]
    assert queue.Queue.get is locktrace._ORIG["queue_get"]
    assert threading.Event.wait is locktrace._ORIG["event_wait"]
    assert torch.cuda.synchronize is locktrace._ORIG["cuda_synchronize"]
    assert torch.cuda.Stream.synchronize is locktrace._ORIG["stream_synchronize"]
    assert torch.cuda.Event.synchronize is locktrace._ORIG["event_synchronize"]
    with pytest.raises(RuntimeError):
        locktrace.traced_lock("late")


def test_lockcheck_on_fit_is_bit_identical():
    """Arming the sanitizer must not change training numerics: same
    seed, same data, same score with and without the port's sanitizer."""
    x, y = _xy()

    def fit_once():
        net = _mlp()
        net.fit(x, y, epochs=2, batch_size=32, async_prefetch=False)
        return net.score(x, y)

    baseline = fit_once()
    locktrace.install()
    try:
        checked = fit_once()
    finally:
        locktrace.uninstall()
    assert baseline == pytest.approx(checked, abs=1e-9)


# -- lexical half: CC005 call form + static CN002/CN003 -----------------------

_SRC_ACQUIRE_CYCLE = """\
import threading

class S:
    def __init__(self):
        self.a_lock = threading.Lock()
        self.b_lock = threading.Lock()

    def one(self):
        self.a_lock.acquire()
        try:
            with self.b_lock:
                pass
        finally:
            self.a_lock.release()

    def two(self):
        self.b_lock.acquire()
        try:
            self.a_lock.acquire()
            try:
                pass
            finally:
                self.a_lock.release()
        finally:
            self.b_lock.release()
"""

_SRC_COND = """\
import threading

class W:
    def __init__(self):
        self.state_lock = threading.Lock()
        self.cv = threading.Condition()
        self._step_fn = None

    def bad_wait(self):
        with self.state_lock:
            with self.cv:
                self.cv.wait()

    def good_wait(self):
        with self.cv:
            self.cv.wait()

    def bad_dispatch(self, x):
        with self.state_lock:
            return self._step_fn(x)

    def bad_sleep(self):
        self.state_lock.acquire()
        try:
            import time
            time.sleep(1.0)
        finally:
            self.state_lock.release()
"""


def test_lint_acquire_release_form_feeds_cc005(tmp_path):
    """Reversed order expressed via acquire()/try/finally is a lock-order
    cycle, named as the JAX linter names it."""
    from deeplearning4j_tpu.analysis import lint as jax_lint

    p = tmp_path / "mod_cycle.py"
    p.write_text(_SRC_ACQUIRE_CYCLE)
    findings = lint.lint_paths([str(p)], base_dir=str(tmp_path))
    cc5 = [f for f in findings if f.code == "CC005"]
    assert len(cc5) == 1
    assert "S.a_lock" in cc5[0].name and "S.b_lock" in cc5[0].name
    ref = jax_lint.lint_paths([str(p)], base_dir=str(tmp_path))
    assert sorted(f.name for f in findings) == sorted(f.name for f in ref)


def test_lint_static_cn002_cn003(tmp_path):
    from deeplearning4j_tpu.analysis import lint as jax_lint

    p = tmp_path / "mod_cond.py"
    p.write_text(_SRC_COND)
    findings = lint.lint_paths([str(p)], base_dir=str(tmp_path))
    cn2 = [f for f in findings if f.code == "CN002"]
    # bad_wait (condition.wait with W.state_lock still held) + bad_sleep
    # (time.sleep inside the acquire/finally scope); good_wait exempt
    assert len(cn2) == 2
    msgs = " | ".join(f.message for f in cn2)
    assert "condition.wait" in msgs and "time.sleep" in msgs
    assert "W.state_lock" in msgs
    cn3 = [f for f in findings if f.code == "CN003"]
    assert len(cn3) == 1 and "_step_fn" in cn3[0].message
    # the construction sites were mapped to lexical keys for the join
    _, edges, ctor_sites = lint.collect([str(p)], base_dir=str(tmp_path))
    assert "W.state_lock" in ctor_sites.values() and "W.cv" in ctor_sites.values()
    ref, ref_edges, ref_ctor = jax_lint.collect([str(p)], base_dir=str(tmp_path))
    assert sorted(f.name for f in findings) == sorted(f.name for f in ref)
    assert edges == ref_edges and ctor_sites == ref_ctor


def test_merged_edges_origin_labels():
    static = {("S.a", "S.b"): "m.py:12", ("S.b", "S.c"): "m.py:20"}
    snap = {"enabled": True, "locks": {}, "blocking": [], "dispatch": [],
            "edges": [
                {"src": "m.py:5", "dst": "m.py:6", "count": 2,
                 "thread": "t0", "witness": ["m.py:12 in one"]},
                {"src": "m.py:6", "dst": "helper.py:9", "count": 1,
                 "thread": "t1", "witness": []},
            ]}
    ctor = {"m.py:5": "S.a", "m.py:6": "S.b"}
    merged = ca.merged_edges(static, snap, ctor)
    assert merged[("S.a", "S.b")]["origin"] == "both"
    assert merged[("S.a", "S.b")]["count"] == 2
    assert merged[("S.b", "helper.py:9")]["origin"] == "runtime"
    assert merged[("S.b", "S.c")]["origin"] == "static"
    assert merged == jax_ca.merged_edges(static, snap, ctor)


# -- gate semantics -----------------------------------------------------------

def test_baseline_gate_red_then_green(armed, tmp_path, capsys):
    lk = locktrace.traced_lock("gateL")
    with lk:
        time.sleep(0.001)
    doc = ca.report(runtime=True, paths=_SMALL_STATIC, base_dir=REPO)
    names = [n for n in ca.finding_names(doc) if n.startswith("CN002:")]
    assert names

    empty = tmp_path / "empty_baseline.txt"
    empty.write_text("# nothing allowed\n")
    rc = ca.main(["--quiet", "--baseline", str(empty)] + _SMALL_STATIC)
    assert rc == 1
    err = capsys.readouterr().err
    assert "LOCK AUDIT REGRESSIONS" in err and names[0] in err

    allowed = tmp_path / "baseline.txt"
    allowed.write_text("# fixture sleep, exercised on purpose\n"
                       + "".join(n + "\n" for n in names))
    rc = ca.main(["--quiet", "--baseline", str(allowed)] + _SMALL_STATIC)
    assert rc == 0


def test_cli_locks_static_only(capsys):
    """`cli locks` without the sanitizer armed: static half over the
    port's package, which the committed tree keeps clean."""
    from deeplearning4j_tpu_torch.cli import main as cli_main

    cwd = os.getcwd()
    os.chdir(REPO)  # the default target is relative, as in the JAX CLI
    try:
        assert cli_main(["--device", "cpu", "locks"]) == 0
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert "lock audit:" in out and "runtime=off" in out


# -- the same scenario under each package's sanitizer -------------------------

def _scenario(mod):
    """A->B then B->A, a sleep under a lock, a dispatch under a lock."""
    a = mod.traced_lock("scnA")
    b = mod.traced_lock("scnB")
    with a:
        with b:
            pass

    def backward():
        with b:
            with a:
                pass

    t = threading.Thread(target=backward, name="dl4j-scn")
    t.start()
    t.join(10)
    with a:
        time.sleep(0.001)
        mod.note_dispatch("scenario/step")


def _run_armed(mod, audit, small):
    mod.install()
    try:
        mod.reset()
        _scenario(mod)
        doc = audit.report(runtime=True, paths=small, base_dir=REPO)
        locks = sorted(mod.snapshot()["locks"])
    finally:
        mod.uninstall()
    return doc, locks


def test_one_scenario_under_each_sanitizer_gives_the_same_findings():
    assert not locktrace.enabled() and not jax_locktrace.enabled()
    jdoc, jlocks = _run_armed(jax_locktrace, jax_ca, _JAX_SMALL_STATIC)
    tdoc, tlocks = _run_armed(locktrace, ca, _SMALL_STATIC)
    assert not locktrace.enabled() and not jax_locktrace.enabled()
    names = ca.finding_names(tdoc)
    assert names == jax_ca.finding_names(jdoc)
    assert sorted(f.code for f in tdoc["findings"]) == sorted(
        f.code for f in jdoc["findings"]) == ["CN001", "CN002", "CN003"]
    assert "CN001:scnA->scnB" in names
    assert any(n.startswith("CN002:time.sleep:tests/test_torch_locktrace.py:")
               for n in names)
    assert any(n.startswith("CN003:scenario/step:") for n in names)
    assert tlocks == jlocks == ["scnA", "scnB"]
    assert [(e["src"], e["dst"]) for e in tdoc["edges"]] == [
        (e["src"], e["dst"]) for e in jdoc["edges"]]


def test_construction_filter_keeps_the_jax_package_raw(armed):
    """The JAX package's directory name is a prefix of the port's: the
    port's sanitizer wraps locks built by port code only."""
    from deeplearning4j_tpu.utils import metrics as jax_metrics
    from deeplearning4j_tpu_torch.utils import metrics as port_metrics

    jax_reg = jax_metrics.MetricsRegistry()
    port_reg = port_metrics.MetricsRegistry()
    assert not isinstance(jax_reg._lock, locktrace._TracedLock)
    assert isinstance(port_reg._lock, locktrace._TracedLock)
    assert any(site.startswith("deeplearning4j_tpu_torch/utils/metrics.py:")
               for site in locktrace.snapshot()["locks"])
    assert not any(site.startswith("deeplearning4j_tpu/")
                   for site in locktrace.snapshot()["locks"])


# -- the port's device-sync probes and dispatch hooks --------------------------

def test_device_sync_probes_record_repo_callers_only(armed):
    """torch.cuda.synchronize / Stream.synchronize / Event.synchronize
    under a traced lock are CN002 device_sync evidence when repo code
    calls them; a call from outside the repo (torch's own, as
    torch.cuda.graph.__enter__ makes) is not. The probe records before
    the call, so on a CPU-only build the call's own error is expected."""
    lk = locktrace.traced_lock("syncL")
    with lk:
        with pytest.raises(Exception):
            torch.cuda.synchronize()
    blocking = locktrace.snapshot()["blocking"]
    assert [b["kind"] for b in blocking] == ["device_sync"]
    assert blocking[0]["site"].startswith("tests/test_torch_locktrace.py:")
    assert blocking[0]["held"] == ["syncL"]

    for fn in (torch.cuda.Stream.synchronize, torch.cuda.Event.synchronize):
        locktrace.reset()
        with lk:
            try:
                fn(object.__new__(torch.cuda.Event
                                  if "Event" in fn.__qualname__
                                  else torch.cuda.Stream))
            except Exception:
                pass
        assert [b["kind"] for b in locktrace.snapshot()["blocking"]] \
            == ["device_sync"], fn

    # the same sync with its direct caller outside the repo: no evidence
    locktrace.reset()
    outside = compile("try:\n    torch.cuda.synchronize()\nexcept Exception:"
                      "\n    pass\n", os.path.join(os.sep, "opt", "torch_side.py"),
                      "exec")
    with lk:
        exec(outside, {"torch": torch})
    assert locktrace.snapshot()["blocking"] == []

    # nor from a sibling directory whose name has the checkout's as its
    # prefix (a virtualenv beside it): the repo test compares with a
    # separator
    sibling = compile("try:\n    torch.cuda.synchronize()\nexcept Exception:"
                      "\n    pass\n", locktrace._REPO_ROOT + "_venv" + os.sep
                      + "torch_side.py", "exec")
    with lk:
        exec(sibling, {"torch": torch})
    assert locktrace.snapshot()["blocking"] == []


def test_fit_dispatch_probe_names_the_held_lock(armed):
    """A fit entered with a traced lock held is CN003 `fit/dispatch`
    (nn/netbase.py, before the step or the graph replay), as in JAX."""
    x, y = _xy(n=16)
    net = _mlp()
    lk = locktrace.traced_lock("fitL")
    with lk:
        net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
    dispatch = locktrace.snapshot()["dispatch"]
    assert [d["what"] for d in dispatch] == ["fit/dispatch"]
    assert dispatch[0]["held"] == ["fitL"] and dispatch[0]["count"] == 2
    assert dispatch[0]["site"].startswith("deeplearning4j_tpu_torch/nn/netbase.py:")
    doc = ca.report(runtime=True, paths=_SMALL_STATIC, base_dir=REPO)
    assert "CN003:fit/dispatch:deeplearning4j_tpu_torch/nn/netbase.py:_timed_fit" \
        in ca.finding_names(doc)
    # the JAX package names the same hook the same way
    jax_locktrace.install()
    try:
        from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

        jnet = JNet(MultiLayerConfiguration.from_json(net.conf.to_json())).init()
        jlk = jax_locktrace.traced_lock("fitL")
        with jlk:
            jnet.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
        jdisp = jax_locktrace.snapshot()["dispatch"]
    finally:
        jax_locktrace.uninstall()
    assert [(d["what"], d["held"], d["count"], d["func"]) for d in jdisp] == [
        (d["what"], d["held"], d["count"], d["func"]) for d in dispatch]


def test_decode_engine_step_is_dispatched_with_no_lock_held(armed):
    """The decode engine's `decode/step` probe runs on every step and
    window; the engine holds no traced lock there, so nothing is
    recorded, and the smoke's books still conserve under the sanitizer."""
    from deeplearning4j_tpu_torch.serving import decode

    calls = []
    orig = decode._locktrace.note_dispatch
    decode._locktrace.note_dispatch = lambda what: (calls.append(what),
                                                    orig(what))
    try:
        assert decode.smoke(requests=4, device="cpu")["ok"]
    finally:
        decode._locktrace.note_dispatch = orig
    assert calls and set(calls) == {"decode/step"}
    assert locktrace.snapshot()["dispatch"] == []


# -- the gate: the port's smoke gives exactly its baseline --------------------

def _baseline_names(path):
    with open(path) as f:
        return sorted({ln.strip() for ln in f
                       if ln.strip() and not ln.startswith("#")})


def test_lock_audit_smoke_gives_exactly_the_baseline(capsys):
    """`cli locks --smoke --baseline` on the CPU: the serving, decode and
    sparse exercise under the armed sanitizer, merged with the static
    pass over the port's package, names exactly the committed
    lock_baseline.txt (empty), as the JAX tree's gate does its own."""
    baseline = os.path.join(REPO, "deeplearning4j_tpu_torch", "analysis",
                            "lock_baseline.txt")
    assert not locktrace.enabled()
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        rc = ca.main(["--smoke", "--device", "cpu", "--quiet",
                      "--baseline", baseline])
        doc = ca.report(runtime=True)
    finally:
        locktrace.uninstall()
        os.chdir(cwd)
    capsys.readouterr()
    assert rc == 0
    assert doc["runtime"] and len(doc["lock_classes"]) >= 10
    assert any(e["origin"] != "static" for e in doc["edges"])
    assert ca.finding_names(doc) == _baseline_names(baseline) == []


def test_env_arms_the_sanitizer_before_module_locks_are_built():
    """DL4J_LOCKCHECK=1 (in a child: never in this process) arms the
    port's sanitizer at package import, so module-level locks
    (utils.metrics' registry) are traced."""
    code = (
        "import threading, deeplearning4j_tpu_torch\n"
        "from deeplearning4j_tpu_torch.utils import locktrace, metrics\n"
        "print(locktrace.enabled(), type(metrics.get_registry()._lock).__name__,"
        " 'deeplearning4j_tpu' in ''.join(__import__('sys').modules))\n")
    env = dict(os.environ, DL4J_LOCKCHECK="1", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    enabled, kind, _ = res.stdout.split()
    assert enabled == "True" and kind == "_TracedLock"


# -- the black-box dump's keys ------------------------------------------------

def test_dump_carries_the_jax_dump_keys(armed, tmp_path):
    """The same steps and event recorded into each package's flight
    recorder give dumps with the same keys: `tenants` (the resource
    meter's view) and `locks` (the sanitizer's forensics, armed here)
    are in the port's dump as in the JAX dump's."""
    from deeplearning4j_tpu.utils import blackbox as jax_blackbox
    from deeplearning4j_tpu_torch.utils import blackbox

    docs = []
    for mod in (jax_blackbox, blackbox):
        rec = mod.FlightRecorder(capacity=8)
        for i in range(3):
            rec.record_step(i, score=float(i), data_wait=0.001, dispatch=0.002)
        rec.record_event("fixture", detail="x")
        docs.append(rec.snapshot(reason="fixture"))
    jax_doc, doc = docs
    assert set(doc) == set(jax_doc)
    assert {"tenants", "locks"} <= set(doc)
    assert doc["locks"]["enabled"] and doc["locks"]["deadlock_cycles"] == []
    assert "conservation" in doc["tenants"]
    text = blackbox.render_dump(json.loads(json.dumps(doc, default=str)))
    assert "lock forensics (DL4J_LOCKCHECK)" in text
