"""MNIST dataset: fetcher + iterator.

The port of the JAX package's data/mnist.py (reference:
MnistDataSetIterator / MnistDataFetcher / MnistFetcher in
deeplearning4j-core datasets/iterator/impl/ and base/: download with a
local cache, idx-format parsing). Numpy only, so a seed gives the same
arrays in both packages.

- Cached idx files are read from $DL4J_TPU_DATA/mnist (default
  ~/.deeplearning4j_tpu/mnist).
- With `allow_download` the standard mirrors are tried when the cache is
  empty; `allow_download=False` never touches the network.
- With `synthetic_fallback`, a missing dataset is replaced by a
  DETERMINISTIC synthetic digit set (procedural 28x28 glyphs with random
  shift, noise and intensity), labelled honestly by `source`
  ("cache" | "download" | "synthetic").
"""

from __future__ import annotations

import gzip
import os
import struct
import urllib.request
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

_MIRRORS = [
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
]
_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}


def _cache_dir() -> Path:
    root = os.environ.get("DL4J_TPU_DATA", os.path.expanduser("~/.deeplearning4j_tpu"))
    return Path(root) / "mnist"


def read_idx_images(path) -> np.ndarray:
    """[n, rows, cols] uint8 from a gzipped idx3 file."""
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx image magic {magic}")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path) -> np.ndarray:
    """[n] uint8 from a gzipped idx1 file."""
    with gzip.open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx label magic {magic}")
        return np.frombuffer(f.read(), dtype=np.uint8)


def _try_download(fname: str, dest: Path) -> bool:
    dest.parent.mkdir(parents=True, exist_ok=True)
    for mirror in _MIRRORS:
        try:
            urllib.request.urlretrieve(mirror + fname, dest)  # noqa: S310
            return True
        except Exception:
            continue
    return False


# -- synthetic fallback ------------------------------------------------------
# 7x5 bitmap font for digits 0-9, upscaled to 21x15 and placed with jitter.
_GLYPHS = {
    0: ["01110", "10001", "10001", "10001", "10001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def synthetic_mnist(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped synthetic digits: [n, 28, 28] uint8 and
    [n] int64 labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    images = np.zeros((n, 28, 28), dtype=np.uint8)
    base = {}
    for d, rows in _GLYPHS.items():
        g = np.array([[int(c) for c in r] for r in rows], dtype=np.float32)
        base[d] = np.kron(g, np.ones((3, 3), np.float32))  # 7x5 -> 21x15
    for i in range(n):
        g = base[int(labels[i])]
        canvas = np.zeros((28, 28), np.float32)
        dy = rng.integers(0, 28 - g.shape[0] + 1)
        dx = rng.integers(0, 28 - g.shape[1] + 1)
        intensity = rng.uniform(0.6, 1.0)
        canvas[dy: dy + g.shape[0], dx: dx + g.shape[1]] = g * intensity
        canvas += rng.normal(0, 0.05, (28, 28)).clip(0, 1) * 0.3
        images[i] = (canvas.clip(0, 1) * 255).astype(np.uint8)
    return images, labels.astype(np.int64)


class MnistDataFetcher:
    """Load (cache, download or synthesize) the MNIST arrays."""

    def __init__(self, allow_download: bool = True, synthetic_fallback: bool = True,
                 synthetic_train: int = 12800, synthetic_test: int = 2560):
        self.allow_download = allow_download
        self.synthetic_fallback = synthetic_fallback
        self.synthetic_train = synthetic_train
        self.synthetic_test = synthetic_test
        self.source = None  # "cache" | "download" | "synthetic"

    def load(self, train: bool) -> Tuple[np.ndarray, np.ndarray]:
        d = _cache_dir()
        img_key = "train_images" if train else "test_images"
        lab_key = "train_labels" if train else "test_labels"
        img_path = d / _FILES[img_key]
        lab_path = d / _FILES[lab_key]
        if not (img_path.exists() and lab_path.exists()) and self.allow_download:
            ok = _try_download(_FILES[img_key], img_path) and _try_download(
                _FILES[lab_key], lab_path)
            if ok:
                self.source = "download"
        if img_path.exists() and lab_path.exists():
            self.source = self.source or "cache"
            return read_idx_images(img_path), read_idx_labels(lab_path)
        if not self.synthetic_fallback:
            raise IOError("MNIST unavailable: no cache, no network")
        self.source = "synthetic"
        n = self.synthetic_train if train else self.synthetic_test
        return synthetic_mnist(n, seed=1 if train else 2)


class MnistDataSetIterator(ListDataSetIterator):
    """Reference-shaped API: MnistDataSetIterator(batch, train, seed).
    Features are flattened 784 f32 in [0, 1] (the reference's
    MnistDataFetcher normalization); InputType.convolutional_flat in the
    network conf reshapes them for conv stacks. Host arrays: the fit moves
    each batch to the network's device."""

    def __init__(self, batch: int, train: bool = True, seed: int = 6,
                 shuffle: Optional[bool] = None, num_examples: Optional[int] = None,
                 fetcher: Optional[MnistDataFetcher] = None):
        fetcher = fetcher or MnistDataFetcher()
        images, labels = fetcher.load(train)
        self.source = fetcher.source
        if num_examples is not None:
            images, labels = images[:num_examples], labels[:num_examples]
        x = images.reshape(images.shape[0], -1).astype(np.float32) / 255.0
        y = np.zeros((labels.shape[0], 10), np.float32)
        y[np.arange(labels.shape[0]), labels] = 1.0
        super().__init__(DataSet(x, y), batch,
                         shuffle=train if shuffle is None else shuffle, seed=seed)
