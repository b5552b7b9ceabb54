"""Device-side skip-gram example generation — train from the CORPUS, not
from shipped pair batches.

The host uploads each epoch's subsampled corpus once (one int32 per
surviving word, sentences separated by `window` sentinel tokens), about
4 bytes a word against ~50 for (input, target, mask) pair batches, and
the device does everything the reference's VectorCalculationsThread
workers did host-side (SequenceVectors.java:285-289, SkipGram.java:271):
dynamic windowing, pair extraction, negative sampling, and the table
updates.

Semantics preserved (word2vec.c / reference parity):
- dynamic window: per center, effective window = window - b with
  b ~ U[0, window) — pairs at distance 1 are always trained.
- skip-gram trains input = CONTEXT word, output = center word.
- sentence boundaries: a `window`-wide sentinel gap guarantees any
  (center, context) pair within `window` distance that crosses a
  boundary touches a sentinel and is masked out.
- lr decays linearly over PAIRS ACTUALLY TRAINED (a device counter
  carried across chunks) toward min_lr — word2vec.c's decay-by-progress,
  measured on true pair counts instead of the host path's estimate.

The update math is learning.py's `_build_update` body (same trust-region
scatter updates), fed from batches generated on the device. The chunks
are dispatched eagerly, one after another; nothing is read back to the
host inside an epoch.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.learning import _build_update, scalar

SENTINEL = -1


def pack_corpus(sentences: List[np.ndarray], window: int,
                bucket: int = 8192) -> np.ndarray:
    """Concatenate indexed sentences into one int32 array with `window`
    SENTINEL tokens between (and after) them, padded with SENTINEL up to
    the next power-of-two multiple of `bucket` (the JAX package's layout,
    which keeps its compiled program's shape fixed across epochs)."""
    gap = np.full(window, SENTINEL, np.int32)
    parts = []
    for s in sentences:
        if s.size == 0:
            continue
        parts.append(s.astype(np.int32))
        parts.append(gap)
    flat = (np.concatenate(parts) if parts
            else np.zeros(0, np.int32))
    size = int(bucket)
    while size < flat.size:
        size *= 2
    if size != flat.size:
        flat = np.concatenate(
            [flat, np.full(size - flat.size, SENTINEL, np.int32)])
    return flat


def live_length(flat: np.ndarray) -> int:
    """One past the last real (non-sentinel) token of a packed corpus."""
    real = np.flatnonzero(flat >= 0)
    return int(real[-1]) + 1 if real.size else 0


def _chunk_pairs(corpus, start, n_centers, window, b):
    """The (input=context, target=center, valid) pair block for centers
    at positions [start, start+n_centers), given each center's window
    draw b [n_centers] in [0, window). Shapes are static:
    [n_centers * 2 * window] flattened pairs."""
    T = corpus.shape[0]
    dev = corpus.device
    c_pos = start + torch.arange(n_centers, device=dev)
    center = corpus[c_pos.clamp(0, T - 1)]
    w_eff = window - b                                   # [n_centers]
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])  # [2W]
    ctx_pos = c_pos[:, None] + offsets[None, :]          # [n_centers, 2W]
    in_bounds = (ctx_pos >= 0) & (ctx_pos < T)
    ctx = corpus[ctx_pos.clamp(0, T - 1)]
    valid = (
        in_bounds
        & (center[:, None] >= 0)
        & (ctx >= 0)
        & (offsets.abs()[None, :] <= w_eff[:, None])
    )
    return (ctx.reshape(-1), center.repeat_interleave(2 * window),
            valid.reshape(-1))


def corpus_pairs_debug(corpus, window, b, n_centers=None):
    """Test hook: the full pair list one chunk would generate (host
    array outputs). `b` is the window draw per center, an array or a
    torch.Generator to draw it from."""
    corpus = torch.as_tensor(np.array(corpus)).long()
    n = int(n_centers if n_centers is not None else corpus.shape[0])
    if isinstance(b, torch.Generator):
        b = torch.randint(0, int(window), (n,), generator=b)
    b = torch.as_tensor(np.array(b)).long()
    ins, tgt, valid = _chunk_pairs(corpus, 0, n, int(window), b)
    return ins.numpy(), tgt.numpy(), valid.numpy().astype(bool)


# draws(chunk) -> (b [n_centers] in [0, window), r [n_centers*2*window,
# negative] in [0, unigram size)): the randomness of one chunk
Draws = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


def make_corpus_skipgram_step(*, negative: int, window: int,
                              pairs_per_batch: int = 8192,
                              max_row_update: float = 0.25):
    """One-call-per-epoch skip-gram trainer.

    step(syn0, syn1neg, unigram, corpus, lr0, min_lr, total_pairs,
         seen0, *, live=None, draws=None, generator=None)
        -> (syn0, syn1neg, mean_loss, seen)

    Walks the corpus in center chunks of pairs_per_batch // (2*window)
    positions; each chunk trains its (<= pairs_per_batch) generated
    pairs through learning.py's update body with the lr for the pairs
    seen so far. `seen0` and the returned `seen` and `mean_loss` are
    device tensors. Each chunk's draws come from `draws(chunk)` when
    given, else from `generator` on the device.

    `live` (one past the last real token, nlp.devicegen.live_length)
    lets the walk stop early: a chunk whose centers all lie past it has
    no valid pair, so every delta is zero, its loss weight is zero and
    the lr counter does not move, and no other chunk's draws depend on
    it. Skipping such chunks gives the same tables and loss.
    """
    body = _build_update(use_hs=False, negative=negative, with_doc=False,
                         train_words=True, max_row_update=max_row_update)
    n_centers = max(1, pairs_per_batch // (2 * window))
    n_pairs = n_centers * 2 * window

    def step(syn0, syn1neg, unigram, corpus, lr0, min_lr, total_pairs,
             seen0, *, live: Optional[int] = None, draws: Optional[Draws] = None,
             generator: Optional[torch.Generator] = None):
        dev, dt = syn0.device, syn0.dtype
        T = corpus.shape[0]
        live = T if live is None else int(live)
        n_chunks = -(-live // n_centers)
        lr0, min_lr, total_pairs = (scalar(x, dev) for x in (lr0, min_lr, total_pairs))
        seen = seen0
        losses, weights = [], []
        for i in range(n_chunks):
            if draws is not None:
                b, r = draws(i)
                b, r = (t.to(dev, non_blocking=True).long() for t in (b, r))
            else:
                b = torch.randint(0, window, (n_centers,), generator=generator, device=dev)
                r = torch.randint(0, unigram.shape[0], (n_pairs, negative),
                                  generator=generator, device=dev)
            ins, tgt, valid = _chunk_pairs(corpus, i * n_centers, n_centers, window, b)
            batch = {
                "h_idx": ins.clamp_min(0)[:, None],
                "row_mask": valid,
                "pos": tgt.clamp_min(0),
                "neg": unigram[r],
            }
            lr = torch.maximum(lr0 * (1.0 - seen / total_pairs), min_lr).to(dt)
            losses.append(body(syn0, None, syn1neg, None, unigram, batch, lr))
            # seen carried in f32: still exact (+<=8192 per chunk) far past
            # int32 range, and it only feeds the lr ramp
            n_valid = valid.to(torch.float32).sum()
            seen = seen + n_valid
            weights.append(n_valid)
        if not losses:
            return syn0, syn1neg, torch.zeros((), dtype=torch.float32, device=dev), seen
        losses, weights = torch.stack(losses), torch.stack(weights)
        # pair-weighted mean: chunks with no valid pair (loss 0) must not
        # dilute the reported epoch loss
        mean_loss = torch.sum(losses * weights) / torch.clamp_min(torch.sum(weights), 1.0)
        return syn0, syn1neg, mean_loss, seen

    return step
