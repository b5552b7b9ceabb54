"""Host-side example generation for embedding training.

The reference walks sentences in VectorCalculationsThread workers and
batches (target, context) updates into aggregate ops
(SequenceVectors.java:285-289, SkipGram.java:266-271). Here the host
produces fixed-shape numpy batches and the device does all the math.
Pair extraction is vectorized: a Python loop per pair would leave the
device waiting on the host. Numpy only: the same np.random.Generator
gives the same batches, bit for bit, as the JAX package's copy.

Conventions (word2vec.c / reference parity):
- dynamic window: per center position the effective window is
  `window - b` with b ~ U[0, window)  (word2vec.c: b = next_random % window).
- skip-gram trains input = CONTEXT word, output = center word.
- CBOW trains input = mean of window words, output = center.
- subsampling of frequent words happens while indexing the sentence.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


class BatchPlan:
    """Static-shape batch configuration + vectorized output-side fill."""

    def __init__(self, *, batch_size: int, context_size: int,
                 hs_arrays=None, negative: int = 0,
                 unigram: Optional[np.ndarray] = None, with_doc: bool = False,
                 device_negatives: bool = False, skip_h_mask: bool = False):
        self.B = int(batch_size)
        self.C = max(1, int(context_size))
        self.negative = int(negative)
        self.with_doc = with_doc
        self.hs = hs_arrays  # (codes [V,L], points [V,L], lengths [V]) or None
        self.unigram = unigram
        # transfer-volume knobs: sample negatives on device from the
        # resident unigram table; omit h_mask when it is identically one
        # (skip-gram — padded rows are no-ops via row_mask alone)
        self.device_negatives = device_negatives
        self.skip_h_mask = skip_h_mask

    def make_batch(self, h_idx, h_mask, targets, doc_idx, rng) -> dict:
        """Assemble one fixed-shape batch from N<=B example rows,
        zero-padding (and masking) the tail. Masks are int8 — they are
        cast to the table dtype on device; bytes on the host link matter
        more than a cast."""
        N = targets.shape[0]
        B, C = self.B, self.C
        b = {
            "h_idx": np.zeros((B, C), np.int32),
            "row_mask": np.zeros((B,), np.int8),
        }
        b["h_idx"][:N] = h_idx
        b["row_mask"][:N] = 1
        if not self.skip_h_mask:
            b["h_mask"] = np.zeros((B, C), np.int8)
            b["h_mask"][:N] = h_mask
        if self.hs is not None:
            codes, points, lengths = self.hs
            L = codes.shape[1]
            b["codes"] = np.zeros((B, L), np.int8)
            b["points"] = np.zeros((B, L), np.int32)
            b["hs_mask"] = np.zeros((B, L), np.int8)
            b["codes"][:N] = codes[targets]
            b["points"][:N] = points[targets]
            b["hs_mask"][:N] = (
                np.arange(L)[None, :] < lengths[targets][:, None]
            )
        if self.negative > 0:
            b["pos"] = np.zeros((B,), np.int32)
            b["pos"][:N] = targets
            if not self.device_negatives:
                b["neg"] = np.zeros((B, self.negative), np.int32)
                t = self.unigram
                b["neg"][:N] = t[rng.integers(0, t.size, (N, self.negative))]
        if self.with_doc:
            b["doc_idx"] = np.zeros((B,), np.int32)
            if doc_idx is not None:
                b["doc_idx"][:N] = doc_idx
        return b


def group_batches(batches, plan: BatchPlan, scan_size: int, lr_fn):
    """Stack consecutive batches into [S, ...] groups for the grouped
    device step (one upload per group). The final short group is padded
    with all-zero no-op batches (row_mask=0). lr_fn(rows_into_group) gives
    each inner batch its LR. Yields (stacked numpy dict, lrs [S] f32,
    valid_rows)."""
    buf: List[dict] = []

    def emit(buf):
        lrs = []
        n = 0
        for b in buf:
            lrs.append(lr_fn(n))
            n += int(b["row_mask"].sum())
        if len(buf) < scan_size:
            zero = {k: np.zeros_like(v) for k, v in buf[0].items()}
            pad = scan_size - len(buf)
            buf = buf + [zero] * pad
            lrs = lrs + [lrs[-1]] * pad
        stacked = {k: np.stack([b[k] for b in buf]) for k in buf[0]}
        return stacked, np.asarray(lrs, np.float32), n

    for b in batches:
        buf.append(b)
        if len(buf) == scan_size:
            yield emit(buf)
            buf = []
    if buf:
        yield emit(buf)


def keep_probabilities(counts: np.ndarray, sample: float) -> Optional[np.ndarray]:
    """word2vec subsampling keep-probability per vocab index."""
    if sample <= 0:
        return None
    total = counts.sum()
    f = counts / max(total, 1)
    keep = (np.sqrt(f / sample) + 1.0) * (sample / np.maximum(f, 1e-12))
    return np.minimum(keep, 1.0)


def subsample(indices: np.ndarray, keep_prob: Optional[np.ndarray], rng) -> np.ndarray:
    if keep_prob is None or indices.size == 0:
        return indices
    return indices[rng.random(indices.size) < keep_prob[indices]]


def skipgram_examples(sent: np.ndarray, window: int, rng):
    """Vectorized (input=context, target=center) pair extraction with the
    dynamic window. Returns (inputs [N], targets [N])."""
    n = sent.size
    if n < 2:
        return (np.zeros(0, np.int64),) * 2
    w = window - rng.integers(0, window, n)  # effective window per center
    ins, tgts = [], []
    for d in range(1, window + 1):
        # context ahead of center: center i, context i+d
        ok = w[: n - d] >= d
        if ok.any():
            ins.append(sent[d:][ok])
            tgts.append(sent[: n - d][ok])
        # context behind center: center i, context i-d
        ok = w[d:] >= d
        if ok.any():
            ins.append(sent[: n - d][ok])
            tgts.append(sent[d:][ok])
    if not ins:
        return (np.zeros(0, np.int64),) * 2
    return np.concatenate(ins), np.concatenate(tgts)


def window_examples(sent: np.ndarray, window: int, rng):
    """Vectorized CBOW/DM extraction: per center, the surrounding window
    as a mask-padded row. Returns (ctx [n, 2*window], mask [n, 2*window],
    targets [n])."""
    n = sent.size
    if n == 0:
        return (
            np.zeros((0, 2 * window), np.int64),
            np.zeros((0, 2 * window), np.float32),
            np.zeros(0, np.int64),
        )
    w = window - rng.integers(0, window, n)
    offsets = np.concatenate(
        [np.arange(-window, 0), np.arange(1, window + 1)]
    )  # [2W]
    pos = np.arange(n)[:, None] + offsets[None, :]          # [n, 2W]
    dist = np.abs(offsets)[None, :]
    valid = (pos >= 0) & (pos < n) & (dist <= w[:, None])
    ctx = sent[np.clip(pos, 0, n - 1)]
    return ctx, valid.astype(np.float32), sent


def generate_batches(
    sentences, plan: BatchPlan, *, window: int, mode: str, rng,
    doc_ids: Optional[Sequence[int]] = None,
) -> Iterator[dict]:
    """Stream fixed-shape batches. mode: skipgram | cbow | dm | dbow.
    For dm/dbow, doc_ids aligns with sentences. Examples from all
    sentences are pooled, then sliced into B-sized batches (tail rows
    masked to true no-ops)."""
    sents = list(sentences)
    docs = list(doc_ids) if doc_ids is not None else None

    h_idx_l: List[np.ndarray] = []
    h_mask_l: List[np.ndarray] = []
    tgt_l: List[np.ndarray] = []
    doc_l: List[np.ndarray] = []

    for si, sent in enumerate(sents):
        if sent.size == 0:
            continue
        if mode == "skipgram":
            ins, tgts = skipgram_examples(sent, window, rng)
            if ins.size == 0:
                continue
            h_idx_l.append(ins[:, None])
            h_mask_l.append(np.ones((ins.size, 1), np.float32))
            tgt_l.append(tgts)
            if docs is not None:
                doc_l.append(np.full(ins.size, docs[si], np.int64))
        elif mode in ("cbow", "dm"):
            ctx, mask, tgts = window_examples(sent, window, rng)
            if mode == "cbow":
                keepr = mask.any(axis=1)  # centers with no context: skip
                ctx, mask, tgts = ctx[keepr], mask[keepr], tgts[keepr]
            if tgts.size == 0:
                continue
            h_idx_l.append(ctx)
            h_mask_l.append(mask)
            tgt_l.append(tgts)
            if docs is not None:
                doc_l.append(np.full(tgts.size, docs[si], np.int64))
        elif mode == "dbow":
            # the doc vector alone predicts each word (reference: DBOW.java)
            h_idx_l.append(np.zeros((sent.size, 1), np.int64))
            h_mask_l.append(np.zeros((sent.size, 1), np.float32))
            tgt_l.append(sent)
            doc_l.append(np.full(sent.size, docs[si], np.int64))
        else:
            raise ValueError(f"unknown mode {mode!r}")

    if not tgt_l:
        return
    C = plan.C
    h_idx = np.concatenate([
        np.pad(a, ((0, 0), (0, C - a.shape[1]))) for a in h_idx_l
    ])
    h_mask = np.concatenate([
        np.pad(a, ((0, 0), (0, C - a.shape[1]))) for a in h_mask_l
    ])
    targets = np.concatenate(tgt_l)
    doc_idx = np.concatenate(doc_l) if doc_l else None

    N = targets.size
    for start in range(0, N, plan.B):
        sl = slice(start, min(start + plan.B, N))
        yield plan.make_batch(
            h_idx[sl], h_mask[sl], targets[sl],
            None if doc_idx is None else doc_idx[sl], rng,
        )
