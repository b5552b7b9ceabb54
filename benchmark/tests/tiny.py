"""A tiny checkout of the benchmark for the CPU tests (`python -m pytest
benchmark/tests -q` from the repo's root, about two minutes with
`-n 4`): the harness's own files, and a BENCHMARK.json whose cells run
tiny configurations and traffic mixes that live in files of their own,
added beside the real ones without editing any of them. Importing this
module puts the repo's root on the path, for `benchmark`."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIGS = {
    "tiny_resnet": {
        "name": "tiny_resnet", "source": "https://arxiv.org/abs/1512.03385",
        "model": "resnet", "reference": "resnet", "precision": "f32",
        "blocks": [1, 1], "widths": [2, 4], "stem_width": 4, "image_size": 16,
        "channels": 3, "num_classes": 5, "bn_eps": 1e-05, "bn_decay": 0.9,
        "updater": "nesterovs", "learning_rate": 0.01, "momentum": 0.9, "l2": 0.001,
        "reduced": ["blocks", "image_size", "num_classes"], "assumed": {}},
    "tiny_charlstm": {
        "name": "tiny_charlstm", "source": "https://github.com/deeplearning4j/dl4j-examples",
        "model": "charlstm", "reference": "graveslstm", "precision": "f32",
        "vocab_size": 7, "hidden": 8, "layers": 2, "tbptt_length": 5,
        "updater": "rmsprop", "learning_rate": 0.01, "rms_decay": 0.95,
        "epsilon": 1e-08, "l2": 0.001, "reduced": ["layers"], "assumed": {}},
}

TINY_TRAFFIC = {
    "tiny-train-images": {"driver": "train_fit", "batch": 4, "fused_steps": 2, "pool": 4,
                          "rate_metric": "train_images_per_s", "trace_seconds": 0.3},
    "tiny-train-tokens": {"driver": "train_fit", "batch": 3, "length": 10, "fused_steps": 1,
                          "pool": 3, "rate_metric": "train_tokens_per_s",
                          "trace_seconds": 0.3, "start_from": "weights"},
}

TINY_CELLS = [
    {"name": "tiny-resnet-train", "config": "tiny_resnet", "traffic": "tiny-train-images",
     "chips": 1, "why": "test"},
    {"name": "tiny-lstm-train", "config": "tiny_charlstm", "traffic": "tiny-train-tokens",
     "chips": 1, "why": "test"},
]

# both dispatches compared: the first (prefix first_) and the third
TINY_LIMITS = {
    cell: {f"{pre}{k}": v for pre in ("first_", "")
           for k, v in (("loss_gap", 1e-5), ("param_gap", 1e-4), ("state_gap", 1e-4))}
    for cell in ("tiny-resnet-train", "tiny-lstm-train")}


def make_checkout(dest: str, extra_metrics=()) -> str:
    """Copy the benchmark into `dest`, add the tiny files and write a
    BENCHMARK.json with the real entries plus the tiny cells. Returns
    dest."""
    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    b = os.path.join(dest, "benchmark")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec = copy.deepcopy(spec)
    for name, cfg in TINY_CONFIGS.items():
        path = f"benchmark/configs/{name}.json"
        json.dump(cfg, open(os.path.join(dest, path), "w"))
        spec["configs"].append({"name": name, "source": cfg["source"], "file": path,
                                "reduced": cfg["reduced"], "why": "test"})
    for name, tr in TINY_TRAFFIC.items():
        json.dump(tr, open(os.path.join(b, "traffic", f"{name}.json"), "w"))
    for name, lim in TINY_LIMITS.items():
        json.dump(lim, open(os.path.join(b, "limits", f"{name}.json"), "w"))
    spec["workloads"] += TINY_CELLS
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            rate = {"train_images_per_s": "tiny-resnet-train",
                    "train_tokens_per_s": "tiny-lstm-train"}
            kind = m["moves"] if "moves" in m else m["name"]
            if kind in rate:
                m["workloads"].append(rate[kind])
    spec["per_layer"] += list(extra_metrics)
    json.dump(spec, open(os.path.join(dest, "BENCHMARK.json"), "w"), indent=1)
    return dest


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    """A tiny checkout: the benchmark's files, tiny cells added from files
    alone, and a dummy per-layer metric whose reader is a file of its own."""
    dest = str(tmp_path_factory.mktemp("checkout"))
    dummy = {"name": "dummy_layer.images", "unit": "ms", "better": "lower",
             "source": "program_counter", "layer": "fit loop",
             "moves": "train_images_per_s", "workloads": ["tiny-resnet-train"]}
    make_checkout(dest, extra_metrics=[dummy])
    with open(os.path.join(dest, "benchmark", "metrics", "dummy_layer.images.py"), "w") as f:
        f.write('"""A test metric: the window\'s samples a second over 1000."""\n\n\n'
                "def read(reading):\n    return reading.rate / 1000.0\n")
    return dest
