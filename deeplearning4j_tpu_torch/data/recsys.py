"""Synthetic recsys traffic: zipf-distributed ids over a vocabulary;
the port of the JAX package's data/recsys.py (numpy, bit-equal output).

Real recommendation id streams are heavy-tailed — a few thousand hot
items absorb most lookups — and that skew is exactly what the sparse
pipeline's hot-id cache (parallel/sparse) exploits. This module is the
workload half: seeded, dependency-free zipf sampling (inverse-CDF over
the normalized 1/k^alpha mass, `np.searchsorted` per draw) plus a batch
stream with deterministic labels, used by the sparse pipeline's smoke,
chip_smoke.py's recsys phase and the tests. Everything is reproducible from (seed,
alpha, vocab) — two arms of an A/B run see byte-identical id streams.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def zipf_cdf(vocab: int, alpha: float = 1.2) -> np.ndarray:
    """Cumulative mass of p(k) ~ 1/(k+1)^alpha over ids [0, vocab) —
    id 0 is the hottest. float64 so huge vocabularies still sum to 1."""
    if vocab <= 0:
        raise ValueError(f"vocab must be positive, got {vocab}")
    mass = 1.0 / np.power(np.arange(1, vocab + 1, dtype=np.float64), alpha)
    cdf = np.cumsum(mass)
    cdf /= cdf[-1]
    return cdf


def zipf_ids(n: int, vocab: int, alpha: float = 1.2,
             seed: int = 0, cdf: Optional[np.ndarray] = None
             ) -> np.ndarray:
    """`n` zipf-distributed ids in [0, vocab), int64. Pass a
    precomputed `cdf` (zipf_cdf) when sampling many batches — the
    cumsum dominates per-batch cost for multi-hundred-k vocabularies."""
    if cdf is None:
        cdf = zipf_cdf(vocab, alpha)
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    return np.searchsorted(cdf, u, side="right").astype(np.int64)


def zipf_batches(batch: int, vocab: int, alpha: float = 1.2,
                 seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (ids [batch], labels [batch]) stream. Labels are a
    deterministic function of the id (parity of the id's bit count) so
    the dense tower has something learnable and every arm of an A/B
    bench trains on the identical supervised problem."""
    cdf = zipf_cdf(vocab, alpha)
    step = 0
    while True:
        ids = zipf_ids(batch, vocab, alpha, seed=seed + step, cdf=cdf)
        labels = (_popcount64(ids) & 1).astype(np.int32)
        yield ids, labels
        step += 1


def _popcount64(a: np.ndarray) -> np.ndarray:
    """Vectorized popcount for int64 (no np.bit_count before numpy 2)."""
    v = a.astype(np.uint64)
    out = np.zeros(a.shape, np.int64)
    for _ in range(8):
        # byte-at-a-time bit folding (the classic SWAR popcount)
        b = v & np.uint64(0xFF)
        b = b - ((b >> np.uint64(1)) & np.uint64(0x55))
        b = (b & np.uint64(0x33)) + ((b >> np.uint64(2)) & np.uint64(0x33))
        b = (b + (b >> np.uint64(4))) & np.uint64(0x0F)
        out += b.astype(np.int64)
        v = v >> np.uint64(8)
    return out
