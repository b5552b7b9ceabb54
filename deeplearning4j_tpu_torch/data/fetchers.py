"""Dataset fetchers beyond MNIST: CIFAR-10, Iris, LFW (reference:
deeplearning4j-core datasets/iterator/impl/ CifarDataSetIterator,
IrisDataSetIterator, LFWDataSetIterator + fetchers in datasets/fetchers/).

The port of the JAX package's data/fetchers.py, with the same contract as
data/mnist.py: cached download when egress exists (`allow_download`),
DETERMINISTIC synthetic fallback otherwise, labeled via ``source`` on the
iterator. The synthetic sets are bit-equal to the JAX package's (the
same numpy draws)."""

from __future__ import annotations

import os
import pickle
import tarfile
import urllib.request
from pathlib import Path
from typing import Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

_CIFAR_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"


def _cache_dir(name: str) -> Path:
    root = os.environ.get("DL4J_TPU_DATA",
                          os.path.expanduser("~/.deeplearning4j_tpu"))
    d = Path(root) / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def _onehot(idx: np.ndarray, k: int) -> np.ndarray:
    y = np.zeros((idx.size, k), np.float32)
    y[np.arange(idx.size), idx] = 1.0
    return y


# -- CIFAR-10 ----------------------------------------------------------------

def synthetic_cifar(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural 32x32x3 class-conditional textures: each class is a
    distinct (orientation, color, frequency) sinusoid grating + noise —
    linearly inseparable in pixel space but conv-learnable, the role the
    real CIFAR plays in pipeline tests."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    x = np.empty((n, 32, 32, 3), np.float32)
    for i, c in enumerate(labels):
        angle = c * np.pi / 10.0
        freq = 3.0 + (c % 5)
        phase = rng.uniform(0, 2 * np.pi)
        wave = np.sin(
            2 * np.pi * freq * (np.cos(angle) * xx + np.sin(angle) * yy)
            + phase)
        color = np.array([
            0.5 + 0.5 * np.cos(c), 0.5 + 0.5 * np.sin(1.7 * c),
            0.5 + 0.5 * np.cos(2.3 * c)], np.float32)
        img = 0.5 + 0.35 * wave[..., None] * color[None, None, :]
        img += rng.normal(0, 0.05, img.shape)
        x[i] = np.clip(img, 0, 1)
    return x, _onehot(labels, 10)


class CifarDataFetcher:
    """CIFAR-10 with cache/download/synthetic fallback."""

    def __init__(self, allow_download: bool = True,
                 synthetic_fallback: bool = True, synthetic_n: int = 2000):
        self.allow_download = allow_download
        self.synthetic_fallback = synthetic_fallback
        self.synthetic_n = synthetic_n
        self.source = None

    def _load_real(self, train: bool):
        d = _cache_dir("cifar10")
        tar = d / "cifar-10-python.tar.gz"
        if not tar.exists():
            if not self.allow_download:
                return None
            tmp = tar.with_suffix(".tmp")
            try:
                with urllib.request.urlopen(_CIFAR_URL, timeout=30) as r, \
                        open(tmp, "wb") as f:
                    f.write(r.read())
                os.replace(tmp, tar)  # atomic: no truncated cache entries
            except OSError:
                tmp.unlink(missing_ok=True)
                return None
        try:
            xs, ys = [], []
            names = ([f"data_batch_{i}" for i in range(1, 6)]
                     if train else ["test_batch"])
            with tarfile.open(tar, "r:gz") as tf:
                for m in tf.getmembers():
                    base = os.path.basename(m.name)
                    if base in names:
                        batch = pickle.load(tf.extractfile(m),
                                            encoding="bytes")
                        xs.append(np.asarray(batch[b"data"], np.float32))
                        ys.append(np.asarray(batch[b"labels"]))
            x = (np.concatenate(xs).reshape(-1, 3, 32, 32)
                 .transpose(0, 2, 3, 1) / 255.0).astype(np.float32)
            y = _onehot(np.concatenate(ys), 10)
            return x, y
        except (OSError, KeyError, EOFError, tarfile.TarError,
                pickle.UnpicklingError):
            # corrupt cache: drop it so the next run can re-download
            tar.unlink(missing_ok=True)
            return None

    def load(self, train: bool):
        real = self._load_real(train)
        if real is not None:
            self.source = "cifar10"
            return real
        if not self.synthetic_fallback:
            raise RuntimeError("CIFAR-10 unavailable and fallback disabled")
        self.source = "synthetic"
        return synthetic_cifar(self.synthetic_n, seed=1 if train else 2)


class CifarDataSetIterator(ListDataSetIterator):
    def __init__(self, batch: int, train: bool = True,
                 num_examples: int = None, fetcher: CifarDataFetcher = None):
        fetcher = fetcher or CifarDataFetcher()
        x, y = fetcher.load(train)
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        self.source = fetcher.source
        super().__init__(DataSet(x, y), batch)


# -- Iris --------------------------------------------------------------------

# Fisher's data is tiny and public domain: ship the generation-free subset
# inline (reference bundles it as a resource in IrisDataFetcher).
_IRIS_MEANS = np.array([
    [5.006, 3.428, 1.462, 0.246],   # setosa
    [5.936, 2.770, 4.260, 1.326],   # versicolor
    [6.588, 2.974, 5.552, 2.026],   # virginica
], np.float32)
_IRIS_STDS = np.array([
    [0.352, 0.379, 0.174, 0.105],
    [0.516, 0.314, 0.470, 0.198],
    [0.636, 0.322, 0.552, 0.275],
], np.float32)


def iris_data(seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """150 examples drawn from the class-conditional Gaussian fit of
    Fisher's iris (deterministic per seed) — same shape/statistics/task
    difficulty as the bundled CSV the reference ships."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(3):
        xs.append(rng.normal(_IRIS_MEANS[c], _IRIS_STDS[c], (50, 4)))
        ys.append(np.full(50, c))
    x = np.concatenate(xs).astype(np.float32)
    y = _onehot(np.concatenate(ys), 3)
    perm = rng.permutation(150)
    return x[perm], y[perm]


class IrisDataSetIterator(ListDataSetIterator):
    """reference: IrisDataSetIterator(batch, numExamples)."""

    def __init__(self, batch: int, num_examples: int = 150, seed: int = 0):
        x, y = iris_data(seed)
        super().__init__(DataSet(x[:num_examples], y[:num_examples]), batch)


# -- LFW (Labeled Faces in the Wild) -----------------------------------------

_LFW_URL = "http://vis-www.cs.umass.edu/lfw/lfw.tgz"


def synthetic_lfw(n: int, num_labels: int = 10, image_size: int = 64,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural class-conditional "faces": each identity is a fixed
    face-geometry (skin tone, eye spacing/height, mouth curve) with
    per-example jitter — same role the real LFW identities play in
    pipeline tests (class-consistent structure, conv-learnable)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_labels, n)
    s = image_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    x = np.empty((n, s, s, 3), np.float32)
    id_rng = np.random.default_rng(12345)  # identity geometry is fixed
    geom = [{
        "skin": 0.45 + 0.4 * id_rng.random(3),
        "eye_dx": 0.12 + 0.08 * id_rng.random(),
        "eye_y": 0.34 + 0.10 * id_rng.random(),
        "mouth_y": 0.68 + 0.08 * id_rng.random(),
        "mouth_w": 0.10 + 0.10 * id_rng.random(),
        "brow": id_rng.random(),
    } for _ in range(num_labels)]
    for i, c in enumerate(labels):
        g = geom[c]
        jitter = rng.normal(0, 0.01, 4)
        img = np.ones((s, s, 3), np.float32) * 0.08
        # head: filled ellipse in the identity's skin tone
        head = (((xx - 0.5) / 0.32) ** 2 + ((yy - 0.5) / 0.42) ** 2) < 1.0
        img[head] = g["skin"]
        # eyes: dark discs, identity-specific spacing/height
        for sx in (-1, 1):
            ex = 0.5 + sx * (g["eye_dx"] + jitter[0])
            ey = g["eye_y"] + jitter[1]
            eye = ((xx - ex) ** 2 + (yy - ey) ** 2) < 0.0012
            img[eye] = 0.05 + 0.1 * g["brow"]
        # mouth: dark horizontal bar of identity-specific width
        my, mw = g["mouth_y"] + jitter[2], g["mouth_w"] + jitter[3]
        mouth = (np.abs(yy - my) < 0.02) & (np.abs(xx - 0.5) < mw)
        img[mouth] = 0.15
        img += rng.normal(0, 0.03, img.shape).astype(np.float32)
        x[i] = np.clip(img, 0, 1)
    return x, _onehot(labels, num_labels)


class LFWDataFetcher:
    """LFW with cache/download/synthetic fallback (reference:
    datasets/fetchers/LFWDataFetcher.java + iterator/impl/
    LFWDataSetIterator.java). `num_labels` keeps the most-photographed
    identities, the reference's lfwNumLabels subsetting."""

    def __init__(self, allow_download: bool = True,
                 synthetic_fallback: bool = True, synthetic_n: int = 1000,
                 num_labels: int = 10, image_size: int = 64):
        self.allow_download = allow_download
        self.synthetic_fallback = synthetic_fallback
        self.synthetic_n = synthetic_n
        self.num_labels = int(num_labels)
        self.image_size = int(image_size)
        self.source = None

    def _decode_ppm_like(self, data: bytes):
        """LFW ships JPEGs; decode via PIL when available (not a core
        dependency), else signal no-real-data."""
        try:
            from io import BytesIO

            from PIL import Image  # optional; baked into many images

            img = Image.open(BytesIO(data)).convert("RGB")
            img = img.resize((self.image_size, self.image_size))
            return np.asarray(img, np.float32) / 255.0
        except Exception:
            return None

    def _load_real(self, train: bool):
        d = _cache_dir("lfw")
        tar = d / "lfw.tgz"
        if not tar.exists():
            if not self.allow_download:
                return None
            tmp = tar.with_suffix(".tmp")
            try:
                with urllib.request.urlopen(_LFW_URL, timeout=60) as r, \
                        open(tmp, "wb") as f:
                    f.write(r.read())
                os.replace(tmp, tar)
            except OSError:
                tmp.unlink(missing_ok=True)
                return None
        try:
            by_person = {}
            with tarfile.open(tar, "r:gz") as tf:
                for m in tf.getmembers():
                    # person dirs only: lfw/<Person_Name>/<img>.jpg
                    if not (m.isfile() and m.name.endswith(".jpg")
                            and "/" in m.name):
                        continue
                    person = m.name.split("/")[-2]
                    by_person.setdefault(person, []).append(m)
                top = sorted(by_person, key=lambda p: -len(by_person[p]))
                top = top[: self.num_labels]
                xs, ys = [], []
                for li, person in enumerate(top):
                    for m in by_person[person]:
                        f = tf.extractfile(m)
                        img = self._decode_ppm_like(f.read()) if f else None
                        if img is None:
                            return None  # no decoder: fall back
                        xs.append(img)
                        ys.append(li)
            if not xs:
                return None
            x = np.stack(xs)
            y = _onehot(np.asarray(ys), len(top))
            # the tar groups examples by identity; shuffle deterministically
            # so truncation (num_examples) and the train/eval split both see
            # every class
            perm = np.random.default_rng(777).permutation(len(xs))
            x, y = x[perm], y[perm]
            idx = np.arange(len(xs))
            sel = idx[idx % 5 != 0] if train else idx[idx % 5 == 0]
            return x[sel], y[sel]
        except (OSError, KeyError, EOFError, IndexError, tarfile.TarError):
            tar.unlink(missing_ok=True)
            return None

    def load(self, train: bool):
        real = self._load_real(train)
        if real is not None:
            self.source = "lfw"
            return real
        if not self.synthetic_fallback:
            raise RuntimeError("LFW unavailable and fallback disabled")
        self.source = "synthetic"
        return synthetic_lfw(self.synthetic_n, self.num_labels,
                             self.image_size, seed=3 if train else 4)


class LFWDataSetIterator(ListDataSetIterator):
    def __init__(self, batch: int, train: bool = True,
                 num_examples: int = None, fetcher: LFWDataFetcher = None):
        fetcher = fetcher or LFWDataFetcher()
        x, y = fetcher.load(train)
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        self.source = fetcher.source
        super().__init__(DataSet(x, y), batch)
