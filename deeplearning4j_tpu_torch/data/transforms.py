"""On-device batch transforms: the per-pixel tail of the ETL on the device.

The port of the JAX package's data/transforms.py. The DataVec analog kept
normalization and augmentation in host code; here they run as torch ops
on the already staged device batch, composed by
data/prefetch.DevicePrefetchIterator after placement (or inline in the
fit loop when prefetch is off).

Randomness is deterministic per batch: a per-transform step counter
seeds the batch's generator (seed * 1_000_003 + step, the port's stand-in
for the JAX package's fold_in(key, step)), so step 7 augments alike
whether the pipeline is on, off or replayed. The draws are not the JAX
package's (another generator); normalize, and flip and crop for given
decisions (`decisions`), are the same arithmetic.

Flip and crop need NHWC image batches (4-d); normalize takes any layout.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet


class DeviceBatchTransform:
    """Feature-batch transform: normalize -> random horizontal flip ->
    random crop, any subset.

    Args:
        normalize: (mean, std), broadcastable against the feature batch;
            computes (x - mean) * (1 / std) in x's dtype.
        random_flip: horizontal flip with p=0.5 per example (NHWC).
        random_crop: pad each spatial edge by `random_crop` zero pixels,
            then crop each example back to H x W at a random offset.
        seed: the generator seed; each batch's generator is seeded from
            (seed, step).
    """

    def __init__(self, normalize: Optional[Tuple] = None,
                 random_flip: bool = False,
                 random_crop: Optional[int] = None, seed: int = 0):
        self.normalize = normalize
        self.random_flip = bool(random_flip)
        self.random_crop = None if not random_crop else int(random_crop)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._step = 0
        self._moments = {}  # device -> (mean, std) tensors

    @property
    def randomized(self) -> bool:
        return self.random_flip or self.random_crop is not None

    def decisions(self, step: int, n: int, device):
        """(flip [n] bool or None, crop offsets [n, 2] or None) of the
        batch at `step`, drawn on `device`."""
        gen = torch.Generator(device=device).manual_seed(
            (self.seed * 1_000_003 + int(step)) % (2 ** 63))
        flip = offs = None
        if self.random_flip:
            flip = torch.rand(n, generator=gen, device=device) < 0.5
        if self.random_crop is not None:
            offs = torch.randint(0, 2 * self.random_crop + 1, (n, 2),
                                 generator=gen, device=device)
        return flip, offs

    def _normalize(self, x):
        dev = x.device
        if dev not in self._moments:
            m, s = self.normalize
            self._moments[dev] = tuple(
                torch.as_tensor(np.asarray(v, np.float32)).to(dev) for v in (m, s))
        mean, std = self._moments[dev]
        # x - mean times the reciprocal of std: the JAX package's program
        # divides by a compile-time constant, which XLA turns into this
        # product, so the two packages normalize to the same bits
        return (x - mean.to(x.dtype)) * torch.reciprocal(std.to(x.dtype))

    def apply(self, x, step: int):
        """The transform of one feature batch at `step`."""
        if self.normalize is not None:
            x = self._normalize(x)
        if not self.randomized:
            return x
        if x.dim() != 4:
            raise ValueError(
                f"random flip/crop need NHWC image batches, got shape "
                f"{tuple(x.shape)}; use normalize-only for other features")
        n, h, w = x.shape[0], x.shape[1], x.shape[2]
        flip, offs = self.decisions(step, n, x.device)
        if flip is not None:
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        if offs is not None:
            p = self.random_crop
            xp = F.pad(x, (0, 0, p, p, p, p))
            rows = offs[:, :1] + torch.arange(h, device=x.device)  # [n, h]
            cols = offs[:, 1:] + torch.arange(w, device=x.device)  # [n, w]
            idx = torch.arange(n, device=x.device)
            x = xp[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
        return x

    def __call__(self, ds):
        """Transform a DataSet's or MultiDataSet's features (labels and
        masks pass through). One step per call, shared by every features
        array of a MultiDataSet."""
        from deeplearning4j_tpu_torch.data.prefetch import _carry_metadata

        with self._lock:
            step = self._step
            self._step += 1

        def one(x):
            t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
            return self.apply(t, step)

        if isinstance(ds, MultiDataSet):
            out = MultiDataSet([one(f) for f in ds.features], ds.labels,
                               ds.features_masks, ds.labels_masks)
        else:
            out = DataSet(one(ds.features), ds.labels, ds.features_mask,
                          ds.labels_mask)
        return _carry_metadata(ds, out)

    def reset_steps(self):
        """Rewind the per-batch step counter (to replay a run)."""
        with self._lock:
            self._step = 0
