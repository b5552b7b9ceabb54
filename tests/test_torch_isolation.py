"""The port stands alone: it imports neither `jax` nor anything of the JAX
package, opens and maps no file of the JAX package's directory (its
native corpus library included), and its entry points do not drop to the
CPU when no GPU is there."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deeplearning4j_tpu_torch")

_IMPORT_JAX = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|deeplearning4j_tpu)\b", re.M)

_CHILD = """
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
print(len(names), bad)
"""

# Drives the port's native corpus pipeline and a Word2Vec fit_file on a
# temp file, recording every path the process opens or dlopens (audit
# hooks), then lists whatever of the JAX package's directory it opened or
# has mapped (/proc/self/maps).
_FILES_CHILD = """
import os, sys, tempfile
JAX_PKG = sys.argv[1] + os.sep
seen = []

def hook(event, args):
    if event in ("open", "ctypes.dlopen") and args and isinstance(args[0], (str, bytes)):
        seen.append(os.fsdecode(args[0]))

sys.addaudithook(hook)
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.nlp import SequenceVectors, VectorsConfiguration
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "corpus.txt")
    with open(path, "w") as f:
        f.write("a b c a b\\nb c d a\\n" * 20)
    assert native.native_available(), "no C++ toolchain"
    with native.NativeCorpus(path) as c:
        c.vocab(1), c.indexed_sentences(1), c.cooccurrences(1, 2, True)
    conf = VectorsConfiguration(layer_size=4, window=2, min_word_frequency=1)
    SequenceVectors(conf, device="cpu").fit_file(path)
with open("/proc/self/maps") as f:
    maps = [l.split()[-1] for l in f if len(l.split()) >= 6]
opened = sorted({os.path.realpath(p) for p in seen if os.path.isabs(p)})
print(sorted({p for p in opened + maps if p.startswith(JAX_PKG)}))
print(native._lib_path())
"""


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_port_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 15  # every module of the slice was imported
    assert bad == "[]", f"port imports pulled in {bad}"


UI_AND_CLUSTERING = ("ui", "ui.codec", "ui.storage", "ui.stats", "ui.components",
                     "ui.report", "ui.server", "clustering", "clustering.distances",
                     "clustering.kmeans", "clustering.kdtree", "clustering.vptree",
                     "clustering.tsne", "serving.knnserver", "keras_backend")


def test_the_walk_reaches_the_ui_and_clustering_modules():
    """The import walk above covers the training UI, the clustering
    stack, the k-NN server and the Keras backend entry point; each module
    stands under the JAX package's name."""
    import pkgutil

    import deeplearning4j_tpu_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    for mod in UI_AND_CLUSTERING:
        assert f"deeplearning4j_tpu_torch.{mod}" in names, mod
        jax_path = os.path.join(ROOT, "deeplearning4j_tpu", *mod.split("."))
        assert os.path.exists(jax_path + ".py") or os.path.isdir(jax_path), mod


def test_the_port_opens_and_maps_no_file_of_the_jax_package():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    env = dict(os.environ, PYTHONPATH=ROOT)
    jax_pkg = os.path.realpath(os.path.join(ROOT, "deeplearning4j_tpu"))
    res = subprocess.run([sys.executable, "-c", _FILES_CHILD, jax_pkg], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    touched, lib = res.stdout.strip().splitlines()[-2:]
    assert touched == "[]", f"the port opened or mapped {touched}"
    assert lib.startswith(os.path.join(PKG, "_build") + os.sep), lib


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        hits = _IMPORT_JAX.findall(f.read())
    assert not hits, f"{path} imports {hits}"


def test_entry_points_refuse_to_run_on_cpu_silently(monkeypatch):
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_conf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        char_lstm_network(vocab_size=5, hidden=4, layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(char_lstm_conf(vocab_size=5, hidden=4, layers=1),
                          device="cuda")
    net = char_lstm_network(vocab_size=5, hidden=4, layers=1, device="cpu")
    assert net.device.type == "cpu"
    assert all(t.device.type == "cpu" for p in net.params_list for t in p.values())


def test_zip_loaders_refuse_to_run_on_cpu_silently(monkeypatch, tmp_path):
    """load_model, restore_* and restore_latest default to "cuda" and
    raise without a GPU; device="cpu" loads on the CPU."""
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.utils import model_serializer as ms

    ckdir = str(tmp_path / "ck")
    net = char_lstm_network(vocab_size=5, hidden=4, layers=1, device="cpu")
    path = CheckpointListener(ckdir).save(net, reason="manual")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (ms.load_model, ms.restore_multi_layer_network,
                 ms.restore_computation_graph):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointListener.restore_latest(ckdir)
    assert ms.load_model(path, device="cpu").device.type == "cpu"
    back, meta = CheckpointListener.restore_latest(ckdir, device="cpu")
    assert back.device.type == "cpu" and meta["iteration"] == 0


def test_server_loader_refuses_to_run_on_cpu_silently(monkeypatch, tmp_path):
    """The inference server's model loader (the JAX CLI's
    guess_and_load_model, kept beside the port's serializer) defaults to
    "cuda" and raises without a GPU, for the port's zip and a
    reference-format DL4J zip alike; device="cpu" loads on the CPU. The
    server's main() takes the same default."""
    from deeplearning4j_tpu_torch.modelimport.dl4j import export_dl4j_zip
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.serving import inference_server as srv
    from deeplearning4j_tpu_torch.utils import model_serializer as ms

    net = char_lstm_network(vocab_size=5, hidden=4, layers=1, device="cpu")
    ours, dl4j = str(tmp_path / "m.zip"), str(tmp_path / "dl4j.zip")
    ms.save_model(net, ours)
    export_dl4j_zip(net, dl4j)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path in (ours, dl4j):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            srv.guess_and_load_model(path)
        assert srv.guess_and_load_model(path, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srv.main(["--modelPath", ours, "--port", "0"])
