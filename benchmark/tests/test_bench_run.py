"""run.py end to end on the CPU at tiny sizes: the contract's last line,
the per-layer metrics of a traced run, cells and a metric added from
files alone, and the refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from tiny import checkout  # noqa: F401  (the fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2147483647 + 12345  # more than 32 signed bits hold


def run(checkout, *args, env_extra=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT  # the port's package, from the repo
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=timeout)


def last_line(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,trace,want", [
    ("tiny-resnet-train", 0, {"train_images_per_s", "setup_s"}),
    ("tiny-resnet-train", 1, {"fit_dispatch_ms.images", "data_wait_ms.images",
                              "dummy_layer.images"}),
    ("tiny-lstm-train", 0, {"train_tokens_per_s", "setup_s"}),
])
def test_a_tiny_cell_prints_the_contract_line(checkout, cell, trace, want):
    out = run(checkout, "--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
              "--trace", str(trace), "--rehearse-cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_line(out)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = res["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    if trace:
        assert "busy_s" in dev and "window_s" in dev and "breakdown" in res
        # a CPU run writes no device metric: no share of a peak or a roofline
        assert not any("mfu" in k or "roofline" in k or "idle" in k for k in res["metrics"])
    # the first dispatch and the third (the replayed one) are both compared
    assert {"first_loss_gap", "loss_gap"} <= set(res["checks"])
    # standard error ends with each number compared beside its limit
    tail = out.stderr.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


def test_the_dummy_metric_reads_the_rate(checkout):
    out = run(checkout, "--workload", "tiny-resnet-train", "--seed", "7", "--seconds", "0.5",
              "--trace", "1", "--rehearse-cpu")
    res = last_line(out)
    assert res["metrics"]["dummy_layer.images"]["value"] > 0


def test_same_seed_same_inputs(checkout):
    a = run(checkout, "--workload", "tiny-lstm-train", "--seed", str(SEED), "--seconds", "0.3",
            "--rehearse-cpu")
    b = run(checkout, "--workload", "tiny-lstm-train", "--seed", str(SEED), "--seconds", "0.3",
            "--rehearse-cpu")
    first = [line for line in a.stderr.splitlines() if "first dispatch" in line]
    assert first and first[0].split("]", 1)[1] == \
        [line for line in b.stderr.splitlines() if "first dispatch" in line][0].split("]", 1)[1]


def test_no_card_no_result(checkout):
    """Without --rehearse-cpu a machine with no CUDA device gets no result."""
    out = run(checkout, "--workload", "tiny-resnet-train", "--seed", "1", "--seconds", "0.3",
              env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files only: the
    program is missing, so no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "resnet50-train-b256", "--seed", "1", "--seconds", "1",
                          "--rehearse-cpu"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_a_run_holding_jax_is_refused(checkout):
    """The module check runs in the process that prints the result: a
    driver that loaded a module named `deeplearning4j_tpu` (here a stand-in
    of that top-level name) makes the run exit without a result."""
    fake = os.path.join(checkout, "fakejax")
    os.makedirs(os.path.join(fake, "deeplearning4j_tpu"), exist_ok=True)
    open(os.path.join(fake, "deeplearning4j_tpu", "__init__.py"), "w").close()
    code = ("import sys, runpy; sys.path.insert(0, 'fakejax'); import deeplearning4j_tpu; "
            "sys.argv = ['benchmark/run.py', '--workload', 'tiny-lstm-train', '--seed', '1', "
            "'--seconds', '0.2', '--rehearse-cpu']; runpy.run_path('benchmark/run.py', "
            "run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "deeplearning4j_tpu" in out.stderr
    assert not out.stdout.strip().startswith("{")
