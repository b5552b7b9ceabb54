"""The LeNet slice of the port: data/mnist.py and models/lenet.py against
the JAX package's, on the CPU.

synthetic_mnist, the IDX readers and the iterators are numpy in both
packages, so their arrays are held bit-equal. LeNet (the dl4j-examples
LenetMnistExample, full width) runs 10 Nesterovs steps of batch 32 from
the JAX package's parameters on the same shuffled batches: f32 scores
rtol 1e-5 (the same expressions, summed in another order) and parameters
rtol 1e-4 / atol 1e-6 after the steps. No test touches the network:
every fetcher is built with allow_download=False and the cache directory
is a temporary one.
"""

import gzip
import struct

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import mnist as jmnist
from deeplearning4j_tpu.models import lenet as jlenet
from deeplearning4j_tpu.train.listeners import IterationListener as JListener
from deeplearning4j_tpu_torch.data import mnist as tmnist
from deeplearning4j_tpu_torch.models import lenet as tlenet
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.train.listeners import IterationListener as TListener
from deeplearning4j_tpu_torch.utils.metrics import get_registry


@pytest.fixture(autouse=True)
def _empty_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA", str(tmp_path / "data"))


def test_synthetic_mnist_is_bit_equal():
    for n, seed in ((50, 0), (17, 1), (8, 2)):
        ti, tl = tmnist.synthetic_mnist(n, seed)
        ji, jl = jmnist.synthetic_mnist(n, seed)
        assert ti.dtype == ji.dtype == np.uint8 and tl.dtype == jl.dtype
        assert np.array_equal(ti, ji) and np.array_equal(tl, jl)


def _write_idx(d, images, labels, train=True):
    d.mkdir(parents=True, exist_ok=True)
    pre = "train" if train else "t10k"
    with gzip.open(d / f"{pre}-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with gzip.open(d / f"{pre}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, labels.shape[0]) + labels.tobytes())


def test_idx_readers_and_the_cache(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (6, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 6).astype(np.uint8)
    d = tmp_path / "data" / "mnist"
    _write_idx(d, images, labels)
    img = d / "train-images-idx3-ubyte.gz"
    lab = d / "train-labels-idx1-ubyte.gz"
    assert np.array_equal(tmnist.read_idx_images(img), jmnist._read_idx_images(img))
    assert np.array_equal(tmnist.read_idx_labels(lab), jmnist._read_idx_labels(lab))
    assert np.array_equal(tmnist.read_idx_images(img), images)
    bad = tmp_path / "bad.gz"
    with gzip.open(bad, "wb") as f:
        f.write(struct.pack(">IIII", 2049, 1, 1, 1) + b"\0")
    with pytest.raises(ValueError, match="magic"):
        tmnist.read_idx_images(bad)
    fetch = tmnist.MnistDataFetcher(allow_download=False)
    x, y = fetch.load(train=True)
    assert fetch.source == "cache" and np.array_equal(x, images)
    # the test split is not cached: synthetic fallback
    x, y = fetch.load(train=False)
    assert fetch.source == "synthetic" and x.shape == (2560, 28, 28)


def test_fetcher_without_fallback_raises_in_both():
    for mod in (tmnist, jmnist):
        with pytest.raises(IOError):
            mod.MnistDataFetcher(allow_download=False, synthetic_fallback=False).load(True)


def test_iterators_deal_the_same_batches():
    kw = dict(train=True, num_examples=96)
    t = tmnist.MnistDataSetIterator(32, fetcher=tmnist.MnistDataFetcher(
        allow_download=False), **kw)
    j = jmnist.MnistDataSetIterator(32, fetcher=jmnist.MnistDataFetcher(
        allow_download=False), **kw)
    assert t.source == j.source == "synthetic"
    for _ in range(2):  # two epochs: the shuffle follows the epoch counter
        for tb, jb in zip(t, j):
            assert np.array_equal(tb.features, jb.features)
            assert np.array_equal(tb.labels, jb.labels)
        t.reset()
        j.reset()


def test_lenet_conf_json_round_trips():
    for kw in ({}, {"precision": "bf16", "learning_rate": 0.02, "seed": 7}):
        js = jlenet.lenet_conf(**kw).to_json()
        assert tlenet.lenet_conf(**kw).to_json() == js
        assert MultiLayerConfiguration.from_json(js).to_json() == js


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, info):
        self.scores.append(float(info["score"]()))

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


class _JScores(_Scores, JListener):
    pass


class _TScores(_Scores, TListener):
    pass


def test_lenet_fit_matches_jax():
    jnet = jlenet.lenet_network()
    tnet = tlenet.lenet_network(device="cpu")
    tnet.params_list = params_from_numpy(
        tnet.conf, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params_list],
        device="cpu")
    tnet.upd_state = tnet.updater_def.init_tree(tnet.params_list)
    kw = dict(train=True, num_examples=320)
    jit = jmnist.MnistDataSetIterator(32, fetcher=jmnist.MnistDataFetcher(
        allow_download=False), **kw)
    tit = tmnist.MnistDataSetIterator(32, fetcher=tmnist.MnistDataFetcher(
        allow_download=False), **kw)
    jl, tl = _JScores(), _TScores()
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    declined = get_registry().counter(
        "conv_declined_total", "Helper SPI events",
        ("op", "helper", "family", "reason")).labels(
        "conv2d", "cuda_conv_bn_stats", "conv_other", "bias")
    n0 = declined.value
    jnet.fit(jit, async_prefetch=False)
    tnet.fit(tit, async_prefetch=False)
    assert len(tl.scores) == len(jl.scores) == 10
    np.testing.assert_allclose(tl.scores, jl.scores, rtol=1e-5)
    assert tl.scores[-1] < tl.scores[0]
    for tp, jp in zip(tnet.params_list, jnet.params_list):
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-4, atol=1e-6)
    # both 5x5 truncate-mode convs carry a bias: the conv/BN kernel
    # declines them for "bias" (the JAX package's conv_decision reason)
    assert declined.value == n0 + 2 * 10
    # output() and evaluate() on the same images
    x = tit.dataset.features[:16]
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-6)


def test_lenet_conv_decisions_match_the_jax_package():
    from deeplearning4j_tpu.ops import pallas_conv_bn as pcb
    from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb

    import jax.numpy as jnp

    for conf in tlenet.lenet_conf().layers:
        if type(conf).__name__ != "ConvolutionLayer":
            continue
        ctx = dict(kernel=tuple(conf.kernel_size), stride=tuple(conf.stride),
                   dilation=(1, 1), same=False, has_bias=conf.has_bias,
                   activation=conf.activation, training=True, n_in=conf.n_in,
                   n_out=conf.n_out, x_shape=(32, 28, 28, conf.n_in))
        t = fcb.conv_decision(dtype=torch.float32, **ctx)
        j = pcb.conv_decision(dtype=jnp.float32, **ctx)
        assert (t["status"], t["reason"]) == (j["status"], j["reason"]) == (
            "unsupported", "bias")


def test_lenet_network_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlenet.lenet_network()
    assert isinstance(tlenet.lenet_network(device="cpu"), MultiLayerNetwork)
