"""The comparison fails what it has to fail, at tiny sizes on the CPU:
each fault a cell can have that the CPU can run (`frozen_capture` needs a
CUDA graph, so calibrate.py reads it on the card), planted in the program
underneath a whole run (the harness's look for a card skipped), and each
cell's control,
the reference one precision below the configuration's in the program's
place."""

import json
import os
import subprocess
import sys

import pytest
from tiny import checkout  # noqa: F401  (the fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2147483647 + 999


def faulted_run(checkout, cell, fault):
    code = ("import sys; sys.path.insert(0, 'benchmark'); sys.path.insert(0, '.')\n"
            "import run\n"
            "from benchmark import faults\n"
            f"with faults.plant({fault!r}):\n"
            f"    rc = run.main(['--workload', {cell!r}, '--seed', '{SEED}', '--seconds', '0.4',"
            " '--rehearse-cpu'])\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,fault", [
    ("tiny-resnet-train", "unchanged"),
    ("tiny-resnet-train", "half_batch"),
    ("tiny-lstm-train", "unchanged"),
    ("tiny-lstm-train", "half_batch"),
])
def test_a_planted_fault_comes_out_not_correct(checkout, cell, fault):
    res = faulted_run(checkout, cell, fault)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["tiny-resnet-train", "tiny-lstm-train"])
def test_the_control_comes_out_not_correct(checkout, cell):
    """calibrate.py's control readings on three seeds, each held to the
    cell's limits: every seed fails one number or more."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", cell,
                          "--seed", str(SEED), "--seeds", "3", "--controls", "3",
                          "--rehearse-cpu"],
                         cwd=checkout, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    limits = json.load(open(os.path.join(checkout, "benchmark", "limits", cell + ".json")))
    seeds = [r for r in rows if "seed" in r]
    assert len(seeds) == 3
    for r in seeds:
        prog = r["program"]
        assert all(prog[k] <= limits[k] for k in limits), (r["seed"], prog)
        ctl = next(v for k, v in r.items() if k.startswith("control_"))
        assert any(ctl[k] > limits[k] for k in limits), (r["seed"], ctl)
