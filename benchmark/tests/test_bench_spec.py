"""BENCHMARK.json and every file it names: keys, names, units, limits of
the contract, and the module check."""

import json
import os
import subprocess
import sys

import pytest
import tiny  # noqa: F401  (puts the repo's root on the path)

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
BENCH = os.path.join(ROOT, "benchmark")

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def _entries():
    for c in SPEC["configs"]:
        yield "config", c
    for w in SPEC["workloads"]:
        yield "workload", w
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        yield "metric", m


@pytest.mark.parametrize("kind,entry", list(_entries()), ids=lambda e: getattr(e, "get", lambda k: e)("name"))
def test_names_units_and_keys(kind, entry):
    assert harness.valid_name(entry["name"]), entry["name"]
    if kind == "config":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("benchmark/configs/")
        assert all(harness.valid_name(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
        cfg = json.load(open(os.path.join(ROOT, entry["file"])))
        assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
        assert cfg["source"] == entry["source"]
    elif kind == "workload":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] in (1, 4)
        assert harness.valid_name(entry["traffic"]) and harness.valid_name(entry["config"])
        assert os.path.exists(os.path.join(BENCH, "traffic", entry["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits", entry["name"] + ".json"))
    else:
        assert harness.valid_unit(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for k in ("why", "layer", "source"):
        if k in entry and kind != "metric" or k == "layer" and k in entry:
            v = entry[k]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v


def test_end_to_end_and_per_layer_rules():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for c in m.get("workloads", []):
            assert c in cells
            reporting = e2e[m["moves"]].get("workloads", cells)
            assert c in reporting
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for c in cells:
        spec = harness.Spec(ROOT)
        names = [m["name"] for m in spec.metrics_for(c, False)]
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics_for(c, True)


def test_every_file_the_cells_name_loads():
    spec = harness.Spec(ROOT)
    fams = spec.families()
    assert {"convbn", "lstm_seq"} <= set(fams)
    for w in SPEC["workloads"]:
        cfg = spec.config(w["config"])
        tr = spec.traffic(w["traffic"])
        assert os.path.exists(os.path.join(BENCH, "drivers", tr["driver"] + ".py"))
        assert os.path.exists(os.path.join(BENCH, "models", cfg["model"] + ".py"))
        assert os.path.exists(os.path.join(BENCH, "reference", cfg["reference"] + ".py"))
        assert tr["rate_metric"] in [m["name"] for m in spec.metrics_for(w["name"], False)]
        for m in spec.metrics_for(w["name"], True):
            assert callable(spec.reader(m["name"]).read)
    for f in fams.values():
        assert os.path.exists(os.path.join(BENCH, "counts", f["counts"] + ".py"))


def test_at_most_a_quarter_of_cells_on_four_chips():
    n4 = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert n4 <= max(1, len(SPEC["workloads"]) // 4)


def test_module_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["jax", "jax.numpy", "numpy"]) == ["jax"]
    assert harness.forbidden_modules(["deeplearning4j_tpu.nn.conf"]) == ["deeplearning4j_tpu"]
    assert harness.forbidden_modules(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]
    assert harness.forbidden_modules(["deeplearning4j_tpu_torch", "deeplearning4j_tpu_torch.nn",
                                      "jaxtyping", "flaxen"]) == []


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.resnet, benchmark.reference.graveslstm, "
            "benchmark.reference.precision, benchmark.counts.convbn, benchmark.counts.lstm_seq\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deeplearning4j_tpu', 'deeplearning4j_tpu_torch')]\n"
            "print(bad)\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_checks_are_false_on_any_breach_or_fault():
    c = harness.Checks({"a": 1.0, "b": 2.0})
    c.add("a", 0.5)
    c.add("b", 2.0)
    assert c.correct
    c.add("a", float("nan"))
    assert not c.correct
    c2 = harness.Checks({"a": 1.0})
    c2.add("a", 0.1)
    c2.fault("a request failed")
    assert not c2.correct
    assert list(json.loads(harness.result_line(True, 1, 0, {}, {}, c.as_dict())))[-1] == "checks"


def test_leaf_gaps_take_the_worst_leaf_against_the_median():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 5e-9}
    gaps = harness.leaf_gaps(prog, ref, ref)
    assert max(gaps, key=gaps.get) == "a" and abs(gaps["a"] - 0.1) < 1e-12
    assert gaps["c"] == 4e-9 / 1.0  # c's gap is over the median leaf's norm
    assert harness.median(gaps.values()) == gaps["c"]
    assert harness.counted_leaves({"a": 1.0, "b": 2.0, "c": 1e-9}) == ["a", "b"]
