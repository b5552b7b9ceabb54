"""The port's operator CLI (deeplearning4j_tpu_torch/cli.py) against the
JAX package's cli.py, on the CPU (`--device cpu`; the default is cuda):
every one of the 19 subcommands runs at least once, and where both CLIs
can read the same inputs they are held to each other —

- `train` -> `evaluate` on one CSV and one model zip: the two trained
  zips' parameters within f32 rtol 1e-5 / atol 1e-7, and the same
  evaluation printed for one zip;
- `resume`: the same exit codes and verdicts on the same checkpoint
  directories (happy path, empty, torn, legacy);
- `doctor`: the same finding codes on tiny_resnet and charlstm;
- `chaos`: the same verdicts and `events` for the same plan and seed;
- `trace`: the same rendering of one span export;
- `slo`, `runs`, `metrics --ledger`, `tenants --ledger` on one recorded
  ledger.

The three server subcommands (`inference-server`, `knn-server`,
`ui-server`) block by design: each runs in a child process on a free
port, is asked one request, and is stopped."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.cli import main as jax_cli_main
from deeplearning4j_tpu_torch import cli as port_cli
from deeplearning4j_tpu_torch.utils.model_serializer import load_model, save_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cli(*argv) -> int:
    return port_cli.main(["--device", "cpu", *argv])


def _mlp_conf(pkg):
    mod = __import__(f"{pkg}.nn.conf", fromlist=["x"])
    return (mod.NeuralNetConfiguration.builder().seed(3)
            .updater(mod.Updater.SGD).learning_rate(0.1).list()
            .layer(mod.DenseLayer(n_in=4, n_out=6, activation="tanh"))
            .layer(mod.OutputLayer(n_in=6, n_out=3, activation="softmax",
                                   loss="mcxent"))
            .build())


def _port_mlp():
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(_mlp_conf("deeplearning4j_tpu_torch"),
                             device="cpu").init()


def _csv(tmp_path, n=48, seed=0) -> str:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    lab = (x[:, 0] > 0).astype(int) + (x[:, 1] > 0.5).astype(int)
    path = tmp_path / "data.csv"
    path.write_text("".join(",".join(f"{v:.6f}" for v in row) + f",{k}\n"
                            for row, k in zip(x, lab)))
    return f"csv:{path}:4:3"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the device contract ------------------------------------------------------

def test_main_raises_without_a_gpu_unless_given_cpu(monkeypatch, tmp_path):
    """`--device` defaults to cuda; with no GPU the CLI raises rather
    than running on the CPU silently (the JAX CLI's JAX_PLATFORMS
    handling, made explicit)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "ok.py"
    p.write_text("x = 1\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["lint", str(p)])
    assert port_cli.main(["--device", "cpu", "lint", str(p)]) == 0


def test_every_jax_module_has_a_counterpart_of_the_same_path():
    """With the CLI and the lock audit, every non-__init__ module of the
    JAX package has a port module at the same path, but the two Pallas
    modules (ported as ops/fused_lstm.py and ops/fused_conv_bn.py)."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py") and f != "__init__.py"}

    port = modules("deeplearning4j_tpu_torch")
    assert sorted(modules("deeplearning4j_tpu") - port) == [
        "ops/pallas_conv_bn.py", "ops/pallas_lstm.py"]
    assert {"ops/fused_conv_bn.py", "ops/fused_lstm.py"} <= port
    from deeplearning4j_tpu_torch.analysis import graph_audit, jaxpr_audit

    assert jaxpr_audit.audit_network is graph_audit.audit_network


# -- train -> evaluate, both CLIs ---------------------------------------------

def test_train_then_evaluate_matches_the_jax_cli(tmp_path, capsys):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.utils.model_serializer import save_model as jax_save

    data = _csv(tmp_path)
    start = str(tmp_path / "start.zip")
    jax_save(JNet(_mlp_conf("deeplearning4j_tpu")).init(), start)
    outs = {"jax": str(tmp_path / "jax.zip"), "port": str(tmp_path / "port.zip")}
    argv = ["train", "--model-path", start, "--data", data, "--epochs", "2",
            "--batch-size", "8", "--print-every", "100"]
    assert jax_cli_main(argv + ["--output", outs["jax"]]) == 0
    assert cli(*argv, "--output", outs["port"]) == 0
    capsys.readouterr()

    ref = load_model(outs["jax"], device="cpu")
    got = load_model(outs["port"], device="cpu")
    assert got.iteration == ref.iteration == 12
    for lp, lr in zip(got.params_list, ref.params_list):
        assert set(lp) == set(lr)
        for k in lp:
            torch.testing.assert_close(lp[k], lr[k], rtol=1e-5, atol=1e-7)
    start_net = load_model(start, device="cpu")
    assert not torch.equal(start_net.params_list[0]["W"], got.params_list[0]["W"])

    # one zip through both CLIs' evaluate: the same report
    assert jax_cli_main(["evaluate", "--model-path", outs["jax"],
                         "--data", data]) == 0
    ref_stats = capsys.readouterr().out
    assert cli("evaluate", "--model-path", outs["jax"], "--data", data) == 0
    got_stats = capsys.readouterr().out
    assert got_stats == ref_stats and "Accuracy" in got_stats


def test_guess_and_load_model_is_the_servers_loader(tmp_path):
    """The server and the CLI load through one function (the JAX server
    imports it from its CLI; the port keeps it beside the serializer and
    the CLI re-exports it); a DL4J reference zip and this framework's zip
    both sniff and load."""
    from deeplearning4j_tpu_torch.modelimport.dl4j import export_dl4j_zip
    from deeplearning4j_tpu_torch.serving import inference_server

    assert inference_server.guess_and_load_model is port_cli.guess_and_load_model
    net = _port_mlp()
    ours, dl4j = str(tmp_path / "ours.zip"), str(tmp_path / "dl4j.zip")
    save_model(net, ours)
    export_dl4j_zip(net, dl4j)
    x = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
    for path in (ours, dl4j):
        loaded = port_cli.guess_and_load_model(path, device="cpu")
        torch.testing.assert_close(loaded.output(x), net.output(x),
                                   rtol=1e-6, atol=1e-7)


# -- resume, both CLIs --------------------------------------------------------

def _checkpoints(tmp_path) -> str:
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

    ckdir = str(tmp_path / "ck")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    net = _port_mlp()
    lis = CheckpointListener(ckdir, every_n_iterations=2, every_n_epochs=None,
                             keep_last=3, async_save=False)
    net.set_listeners(lis)
    net.fit(x, y, epochs=1, batch_size=4, async_prefetch=False)
    lis.close()
    return ckdir


def _both_resume(capsys, *argv):
    rc_port = cli("resume", *argv)
    out_port = capsys.readouterr()
    rc_jax = jax_cli_main(["resume", *argv])
    out_jax = capsys.readouterr()
    return (rc_port, out_port.out + out_port.err), (rc_jax, out_jax.out + out_jax.err)


def test_resume_verdicts_match_the_jax_cli(tmp_path, capsys):
    from deeplearning4j_tpu_torch.train.checkpoint import (
        corrupt_zip_entry,
        scan_checkpoints,
    )

    ckdir = _checkpoints(tmp_path)
    (rc, out), (jrc, jout) = _both_resume(capsys, ckdir)
    assert rc == jrc == 0
    assert "integrity: ok" in out and "integrity: ok" in jout
    assert "validated: loads OK" in out and "validated: loads OK" in jout
    (rc, out), (jrc, jout) = _both_resume(capsys, ckdir, "--json")
    assert rc == jrc == 0
    got, ref = json.loads(out), json.loads(jout)
    for k in ("path", "iteration", "epoch", "reason", "network_type",
              "num_params", "train_state"):
        assert got.get(k) == ref.get(k), k
    assert got["integrity"]["ok"] and ref["integrity"]["ok"]
    assert got["integrity"]["entries"] == ref["integrity"]["entries"]

    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    (rc, out), (jrc, jout) = _both_resume(capsys, empty)
    assert rc == jrc == 1 and "no checkpoint" in out and "no checkpoint" in jout

    # legacy: the manifest stripped from a good zip -> passes with a note
    cks = scan_checkpoints(ckdir)
    legacy = str(tmp_path / "legacy")
    os.makedirs(legacy)
    with zipfile.ZipFile(os.path.join(ckdir, cks[-1][1])) as zin, \
            zipfile.ZipFile(os.path.join(legacy, cks[-1][1]), "w") as zout:
        for name in zin.namelist():
            if name != "manifest.json":
                zout.writestr(name, zin.read(name))
    (rc, out), (jrc, jout) = _both_resume(capsys, legacy)
    assert rc == jrc == 0
    assert "no digest manifest" in out and "no digest manifest" in jout

    # torn: the newest checkpoint's payload corrupted
    corrupt_zip_entry(os.path.join(ckdir, cks[-1][1]))
    (rc, out), (jrc, jout) = _both_resume(capsys, ckdir)
    assert rc == jrc == 1
    assert "integrity: FAILED" in out and "integrity: FAILED" in jout
    (rc, _), (jrc, _) = _both_resume(capsys, ckdir, "--no-validate")
    assert rc == jrc == 0


# -- doctor, both CLIs --------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny_resnet", "charlstm"])
def test_doctor_codes_match_the_jax_cli(preset, capsys):
    """The config pass (`--no-jaxpr`) gives both CLIs the same codes. The
    JAX step trace cannot run under this jax (JX000: no
    jax.core.ClosedJaxpr, which the JAX cost-model tests also lack), so
    the port's step audit is held to a clean report of its own, not to
    that."""
    assert cli("doctor", "--preset", preset, "--no-jaxpr", "--json", "-") == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_cli_main(["doctor", "--preset", preset, "--no-jaxpr",
                         "--json", "-"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert got["ok"] and ref["ok"] and got["errors"] == ref["errors"] == 0
    assert sorted(f["code"] for f in got["findings"]) == sorted(
        f["code"] for f in ref["findings"])
    assert cli("doctor", "--preset", preset, "--json", "-") == 0
    full = json.loads(capsys.readouterr().out)
    assert full["ok"] and full["findings"] == got["findings"]
    # the human form adds the lock audit's static section
    assert cli("doctor", "--preset", preset, "--no-jaxpr") == 0
    assert "concurrency:" in capsys.readouterr().out


def test_doctor_needs_exactly_one_source(capsys):
    assert cli("doctor") == 2
    assert "exactly one of" in capsys.readouterr().err


# -- chaos and trace ----------------------------------------------------------

def test_chaos_training_matches_the_jax_cli(tmp_path, capsys):
    """The training preset's default plan and seed: the same verdict, the
    same fault events and point invocations in both CLIs, and a replay
    of the port's run gives the same events."""
    reports = {}
    for who, fn in (("port", cli), ("port2", cli), ("jax", jax_cli_main)):
        out = str(tmp_path / f"{who}.json")
        args = ["chaos", "--preset", "training", "--steps", "8", "--seed", "3",
                "--json", out]
        rc = cli(*args) if fn is cli else fn(args)
        assert rc == 0, who
        capsys.readouterr()
        with open(out) as f:
            reports[who] = json.load(f)
    for who in ("port2", "jax"):
        assert reports[who]["events"] == reports["port"]["events"], who
        assert reports[who]["invocations"] == reports["port"]["invocations"]
        assert reports[who]["verdict"] == reports["port"]["verdict"] == "ok"
    assert reports["port"]["events"]  # the plan did inject


def test_chaos_serving_trace_renders_alike_in_both_clis(tmp_path, capsys):
    """The serving preset under the armed lock sanitizer, with its span
    export: every injected fault is linked to its request's trace, the
    lock audit finds nothing, and `trace` renders the export the same in
    both CLIs (text and JSON), with a missing trace id exiting 1."""
    trace_out = str(tmp_path / "serving.jsonl")
    rep = str(tmp_path / "serving.json")
    assert cli("chaos", "--preset", "serving", "--requests", "24",
               "--clients", "4", "--trace-out", trace_out, "--json", rep) == 0
    capsys.readouterr()
    with open(rep) as f:
        doc = json.load(f)
    assert doc["verdict"] == "ok" and doc["conservation_ok"]
    assert doc["trace"]["fault_trace_ok"] and doc["trace"]["fault_spans"] >= 1
    assert doc["lock_audit"]["errors"] == 0 and doc["lock_audit"]["findings"] == []
    assert doc["lock_audit"]["edges"] >= 1

    assert cli("trace", trace_out, "--top", "3") == 0
    got = capsys.readouterr().out
    assert jax_cli_main(["trace", trace_out, "--top", "3"]) == 0
    assert got == capsys.readouterr().out and "critical path" in got
    assert cli("trace", trace_out, "--json", "-") == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_cli_main(["trace", trace_out, "--json", "-"]) == 0
    assert got == json.loads(capsys.readouterr().out)
    tid = got["traces"][0]["trace_id"]
    assert cli("trace", trace_out, "--trace-id", tid[:12]) == 0
    assert cli("trace", trace_out, "--trace-id", "f" * 32) == 1
    assert cli("trace", str(tmp_path / "missing.jsonl")) == 2
    capsys.readouterr()


def test_chaos_decode_degrades_and_recovers(tmp_path, capsys):
    rep = str(tmp_path / "decode.json")
    assert cli("chaos", "--preset", "decode", "--requests", "24",
               "--clients", "4", "--json", rep) == 0
    capsys.readouterr()
    with open(rep) as f:
        doc = json.load(f)
    assert doc["verdict"] == "ok" and doc["watchdog_tripped"]
    assert doc["loop_exercised"] and doc["conservation_ok"]
    assert doc["lock_audit"]["findings"] == []


# -- the ledger family: slo, runs, metrics --ledger, tenants --------------------

def _ledgers(tmp_path):
    """Two recorded fit ledgers; the second with a rule that fires."""
    from deeplearning4j_tpu_torch.analysis.slo import SLORule

    rng = np.random.default_rng(4)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    ref, cand = str(tmp_path / "ref.jsonl"), str(tmp_path / "cand.jsonl")
    _port_mlp().fit(x, y, epochs=1, batch_size=8, async_prefetch=False,
                    run_ledger=ref)
    from deeplearning4j_tpu_torch.utils import runledger

    rule = SLORule(name="steps_seen", kind="threshold",
                   series="fit_step_total", op=">", value=0.0)
    led = runledger.RunLedger(cand, sample_every=60.0, rules=[rule])
    _port_mlp().fit(x, y, epochs=1, batch_size=8, async_prefetch=False,
                    run_ledger=led)
    led.sample_now()
    led.close()
    return ref, cand


def test_ledger_subcommands(tmp_path, capsys):
    ref, cand = _ledgers(tmp_path)
    # slo: the candidate's ERROR rule fired -> --check exits 1, as in JAX
    assert cli("slo", "--ledger", cand, "--check") == 1
    assert jax_cli_main(["slo", "--ledger", cand, "--check"]) == 1
    capsys.readouterr()
    assert cli("slo", "--ledger", cand, "--json", "-") == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_cli_main(["slo", "--ledger", cand, "--json", "-"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["ever_fired_errors"] == want["ever_fired_errors"] == ["steps_seen"]
    assert [(r["rule"], r["state"]) for r in got["rules"]] == [
        (r["rule"], r["state"]) for r in want["rules"]]
    assert cli("slo", "--ledger", ref) == 2  # recorded without rules
    assert cli("slo", "--ledger", str(tmp_path / "nope.jsonl")) == 2
    # runs: list and compare
    assert cli("runs", str(tmp_path)) == 0
    assert "2 run(s)" in capsys.readouterr().out
    assert cli("runs", "compare", ref, cand, "--json", "-") == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_cli_main(["runs", "compare", ref, cand, "--json", "-"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["reference"]["run_id"] == want["reference"]["run_id"]
    assert cli("runs", "compare", ref) == 2
    # metrics --ledger: the replay's tick view
    assert cli("metrics", "--ledger", cand) == 0
    out = capsys.readouterr().out
    assert "replaying" in out and "fit_step_total" in out
    assert ":bucket:" not in out
    # tenants --ledger
    assert cli("tenants", "--ledger", cand, "--json") == 0
    doc = json.loads(capsys.readouterr().out)
    assert "conservation" in doc and doc["source"].startswith("ledger ")
    assert cli("tenants", "--ledger", cand) == 0
    assert "tenants —" in capsys.readouterr().out


def test_metrics_and_tenants_in_process(tmp_path, capsys):
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    get_registry().counter("cli_demo_total", "t").labels().inc(2)
    assert cli("metrics") == 0
    assert "cli_demo_total" in json.loads(capsys.readouterr().out)
    out = str(tmp_path / "m.prom")
    assert cli("metrics", "--format", "prometheus", "--output", out) == 0
    with open(out) as f:
        assert "cli_demo_total" in f.read()
    assert cli("metrics", "--watch", "0.05", "--watch-count", "2") == 0
    assert capsys.readouterr().out.count("-- ") >= 2
    assert cli("tenants") == 0
    assert "in-process" in capsys.readouterr().out


def test_resourcemeter_smoke_renders_through_cli_tenants(capsys):
    """resourcemeter.smoke(): two decode tenants and a metered fit spend
    non-vacuously, spend and books conserve, and `cli tenants` renders
    the in-process view (the JAX module's smoke, on the port)."""
    from deeplearning4j_tpu_torch.utils import resourcemeter

    was = resourcemeter.is_enabled()
    try:
        rep = resourcemeter.smoke(device="cpu")
    finally:
        if not was:
            resourcemeter.disable()
    out = capsys.readouterr().out
    assert rep["ok"] and rep["moved"] and rep["cli_tenants_rc"] == 0
    assert rep["decode_tenants"] == ["a", "b"] and rep["conservation"]["ok"]
    assert "trainer" in out and "conservation: books_ok=True" in out


# -- blackbox, report, profile, perf -------------------------------------------

def test_blackbox_renders_and_missing_exits_2(tmp_path, capsys):
    from deeplearning4j_tpu_torch.utils import blackbox

    rec = blackbox.FlightRecorder(capacity=8)
    for i in range(3):
        rec.record_step(i, score=0.5 / (i + 1), data_wait=0.001, dispatch=0.002)
    rec.record_event("fixture", where="cli")
    path = str(tmp_path / "dump.json")
    rec.dump(path, reason="cli fixture")
    assert cli("blackbox", path) == 0
    out = capsys.readouterr().out
    assert "reason: cli fixture" in out and "fixture" in out
    assert jax_cli_main(["blackbox", path]) == 0  # the JAX reader reads it
    capsys.readouterr()
    assert cli("blackbox", path, "--json") == 0
    doc = json.loads(capsys.readouterr().out)
    assert {"tenants", "locks"} <= set(doc)
    assert cli("blackbox", str(tmp_path / "none.json")) == 2


def test_report_from_a_stats_file(tmp_path, capsys):
    from deeplearning4j_tpu_torch.ui import FileStatsStorage, StatsListener

    stats = str(tmp_path / "stats.bin")
    storage = FileStatsStorage(stats)
    net = _port_mlp()
    net.set_listeners(StatsListener(storage))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
    html = str(tmp_path / "report.html")
    assert cli("report", "--stats-file", stats, "--output", html) == 0
    assert "1 sessions" in capsys.readouterr().out
    with open(html) as f:
        assert "<html" in f.read().lower()
    assert cli("report", "--stats-file", str(tmp_path / "no.bin"),
               "--output", html) == 2


def test_profile_reads_a_torch_profiler_capture(tmp_path, capsys):
    """`profile` reads what utils.profiler.trace wrote (a CPU capture
    here: aten ops' CPU time, said so), with the cost model's columns
    for the steps the capture ran; an empty directory says so."""
    from deeplearning4j_tpu_torch.models.resnet import tiny_resnet_conf
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
    from deeplearning4j_tpu_torch.utils import profiler

    net = ComputationGraph(tiny_resnet_conf(), device="cpu").init()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 2)]
    log_dir = str(tmp_path / "prof")
    with profiler.trace(log_dir):
        net.fit(x, y, epochs=2, batch_size=2, async_prefetch=False)
    out = str(tmp_path / "prof.json")
    assert cli("profile", "--log-dir", log_dir, "--json", out, "--preset",
               "tiny_resnet", "--batch", "2", "--steps", "2") == 0
    with open(out) as f:
        doc = json.load(f)
    assert doc["families_ms"] and doc["device"] is False
    assert doc["cost_model"]["batch"] == 2
    assert any("bound_ms" in row for row in doc["families"].values())
    # K4-K8 priced per kernel from the preset's routing (tiny_resnet: six
    # 1x1, three 3x3 convs, each with its BN)
    assert {k: v["launches"] for k, v in doc["kernel_costs"].items()} == {
        "conv1x1_stats": 6, "conv_kxk_stats": 3, "bn_apply": 9,
        "bn_backward_reduce": 9, "bn_backward_apply": 9}
    capsys.readouterr()
    assert cli("profile", "--log-dir", log_dir, "--preset", "tiny_resnet",
               "--batch", "2") == 0
    text = capsys.readouterr().out
    assert "device time by op family:" in text and "CPU time" in text
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert cli("profile", "--log-dir", empty) == 0
    assert "no device ops found" in capsys.readouterr().err


def test_perf_counts_the_cost_model(capsys):
    """`perf --json` carries the step cost model's FLOPs (the port's own
    count: the JAX perf test fails in this repo's runs), the coverage
    table, and a drift check whose prior is named for what it is."""
    from deeplearning4j_tpu_torch.analysis.costmodel import (
        _helpers_disabled,
        train_step_cost,
    )
    from deeplearning4j_tpu_torch.models.resnet import tiny_resnet_conf
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph

    assert cli("perf", "--preset", "tiny_resnet", "--batch", "2", "--xla",
               "--json", "-") == 0
    doc = json.loads(capsys.readouterr().out)
    with _helpers_disabled():
        cm = train_step_cost(ComputationGraph(tiny_resnet_conf(), device="cpu")
                             .init(), batch_size=2)
    assert doc["cost_model"]["model_flops"] == cm.model_flops > 0
    assert doc["xla"]["source"] == "FlopCounterMode" and doc["xla"]["flops"] > 0
    assert doc["kernel_coverage"]["rows"]
    assert doc["vs_prior"] is None  # no prior round for tiny_resnet
    assert cli("perf", "--preset", "charlstm", "--batch", "2",
               "--timesteps", "8") == 0
    out = capsys.readouterr().out
    assert "cost model — charlstm" in out
    assert "vs BENCH_r" in out and "FLOP count only, no time" in out


# -- the servers, each in a child process ----------------------------------------

def _wait_http(url, proc, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-2000:]}")
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                return r.status
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"{url} never answered")


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _serve(*argv):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "--device",
         "cpu", *argv], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
    proc.stderr.close()


def test_inference_server_subcommand(tmp_path, capsys):
    """`inference-server` on a char-LSTM zip: /predict equals the
    in-process output(), /generate gives the greedy rnn_time_step tokens,
    and `metrics --url` / `tenants --url` read the live server."""
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network

    vocab = 11
    net = char_lstm_network(vocab_size=vocab, hidden=8, layers=1,
                            tbptt_length=8, device="cpu")
    zpath = str(tmp_path / "charlstm.zip")
    save_model(net, zpath)
    port = _free_port()
    proc = _serve("inference-server", "--model-path", zpath, "--port",
                  str(port), "--max-batch-size", "4", "--decode-slots", "2")
    base = f"http://127.0.0.1:{port}"
    try:
        _wait_http(base + "/metrics", proc)
        eye = np.eye(vocab, dtype=np.float32)
        toks = np.random.default_rng(7).integers(0, vocab, (2, 6))
        pred = np.asarray(_post(base + "/predict", {
            "features": eye[toks].tolist()})["predictions"], np.float32)
        want = net.output(eye[toks]).numpy()
        np.testing.assert_allclose(pred, want, atol=1e-5, rtol=0)
        prompt = [1, 4, 2]
        got = _post(base + "/generate", {"prompt": prompt, "max_tokens": 5})
        net.clear_rnn_state()
        out = None
        for t in prompt:
            out = net.rnn_time_step(eye[[t]])
        ref = []
        while len(ref) < 5:
            g = int(torch.argmax(out[0]).item())
            ref.append(g)
            out = net.rnn_time_step(eye[[g]])
        assert got["tokens"] == ref
        assert cli("metrics", "--url", base) == 0
        snap = json.loads(capsys.readouterr().out)
        assert snap["admitted"] >= 1 and snap["completed"] >= 1
        assert cli("tenants", "--url", base, "--json") == 0
        assert "tenants" in json.loads(capsys.readouterr().out)
    finally:
        _stop(proc)


def test_knn_server_subcommand(tmp_path):
    pts = np.random.default_rng(8).standard_normal((50, 5)).astype(np.float32)
    path = str(tmp_path / "pts.npy")
    np.save(path, pts)
    port = _free_port()
    proc = _serve("knn-server", "--ndarray-path", path, "--port", str(port))
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                res = _post(base + "/knn", {"k": 3, "inputIndex": 0})
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()[-2000:]
                assert time.monotonic() < deadline, "knn server never answered"
                time.sleep(0.2)
        d = np.linalg.norm(pts - pts[0], axis=1)
        order = list(np.argsort(d, kind="stable")[:3])  # the point itself first
        assert [r["index"] for r in res["results"]] == order
    finally:
        _stop(proc)


def test_ui_server_subcommand(tmp_path):
    from deeplearning4j_tpu_torch.ui import FileStatsStorage

    stats = str(tmp_path / "stats.bin")
    FileStatsStorage(stats)
    port = _free_port()
    proc = _serve("ui-server", "--stats-file", stats, "--port", str(port))
    try:
        assert _wait_http(f"http://127.0.0.1:{port}/train", proc) == 200
    finally:
        _stop(proc)
