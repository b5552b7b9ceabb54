"""Device-side embedding training steps.

The AggregateSkipGram analog (reference:
models/embeddings/learning/impl/elements/SkipGram.java:271 batches pair
updates into native libnd4j aggregate ops; CBOW.java likewise). One step
consumes a BATCH of examples with static shapes:

  hidden  = mean of gathered syn0 rows (skip-gram: the one input word;
            CBOW/DM: the window, mask-padded; DM/DBOW add a doc row)
  outputs = hierarchical-softmax nodes (points/codes, mask-padded to the
            Huffman max code length) and/or negative samples
  update  = sigmoid-gradient scatter-adds into syn0/syn1/syn1neg/doc

The tables are updated in place. The returned loss is the masked mean
negative log sigmoid, a device tensor: the trainers read it once an
epoch.

Batching semantics: the reference applies pair updates SEQUENTIALLY (the
native aggregate loop), so a word hit N times in a batch sees N staged
updates of compounding freshness. A batched scatter-ADD applies all N
against the same stale row — equivalent for small lr*N, but a hot row
(small vocab x large batch) can see an effective rate of lr*N and
diverge. Updates are therefore summed and then TRUST-REGION CLIPPED per
destination row (norm cap), which preserves the sequential frequency
signal while bounding any single step's movement.

The clip is dense, as in the JAX package: it sums the deltas into a
zero table of the table's full size and takes every row's 2-norm. A
compaction to the touched rows (`torch.unique`) would read their number
back to the host, a sync on every step. `index_add_` sums duplicate rows
with atomics on CUDA, so a table is reproducible to rounding, not to the
bit, and matches the JAX package to a tolerance.

Randomness: the negatives come from the batch (`"neg"`, drawn by the
caller) or, where the batch has none, from the resident unigram table by
`torch.randint` on the device with an explicit torch.Generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# batch entries that index a table; the rest are int8 masks
_INDEX_KEYS = ("h_idx", "points", "pos", "neg", "doc_idx")


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` without a sync: a blocking host-to-device
    copy waits for the device's stream to drain, while an asynchronous
    one from pageable memory is staged at once, so the host keeps
    dispatching ahead of the device."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, non_blocking=True)


def scalar(x, device, dtype=torch.float32) -> torch.Tensor:
    """A 0-d tensor on `device` made by a fill, not a copy (no sync)."""
    return torch.full((), float(x), dtype=dtype, device=device)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (or a stacked group) on `device`: index arrays as
    int64, masks as they came (int8, cast to the table dtype in the
    step). The arrays cross as they are and widen on the device."""
    out = {}
    for k, v in batch.items():
        t = to_device(v, device)
        out[k] = t.long() if k in _INDEX_KEYS else t
    return out


def _scatter_clipped(table, idx, delta, weights, max_row_update):
    """table[idx] += delta (summed over duplicate rows), each row's
    total clipped to max_row_update (weights: 1/0 per slot)."""
    d = delta * weights[:, None]
    acc = torch.zeros_like(table).index_add_(0, idx, d)
    norm = torch.linalg.vector_norm(acc, dim=1, keepdim=True)
    scale = torch.clamp(max_row_update / torch.clamp_min(norm, 1e-12), max=1.0)
    table.add_(acc * scale)


def _build_update(*, use_hs: bool, negative: int, with_doc: bool,
                  train_words: bool, max_row_update: float):
    """The update body shared by the single-batch step and the grouped
    multi-batch step: one batch, tables updated in place, returns the
    batch's loss (a 0-d device tensor)."""

    def step(syn0, syn1, syn1neg, doc, unigram, batch, lr, generator=None):
        h_idx = batch["h_idx"]        # [B, C] rows of syn0
        B = h_idx.shape[0]
        dt = syn0.dtype
        # h_mask may be omitted (skip-gram: always exactly one input row);
        # padded tail rows are already no-ops via row_mask
        if "h_mask" in batch:
            hm = batch["h_mask"].to(dt)
        else:
            hm = torch.ones(h_idx.shape, dtype=dt, device=syn0.device)
        rm = batch["row_mask"].to(dt)  # [B] 0 for padded tail rows

        rows = syn0[h_idx]                              # [B, C, D]
        cnt = torch.sum(hm, dim=1, keepdim=True)        # [B, 1]
        h = torch.sum(rows * hm[..., None], dim=1)      # [B, D]
        if with_doc:
            d_idx = batch["doc_idx"]                    # [B]
            h = h + doc[d_idx]
            cnt = cnt + 1.0
        h = h / torch.clamp_min(cnt, 1.0)

        neu1e = torch.zeros_like(h)
        loss = torch.zeros((), dtype=dt, device=syn0.device)
        denom = torch.zeros((), dtype=dt, device=syn0.device)

        if use_hs:
            points = batch["points"]                    # [B, L] rows of syn1
            codes = batch["codes"].to(dt)               # [B, L] 0/1
            om = batch["hs_mask"].to(dt) * rm[:, None]  # [B, L]
            u = syn1[points]                            # [B, L, D]
            logit = torch.einsum("bd,bld->bl", h, u)
            label = 1.0 - codes
            p = torch.sigmoid(logit)
            g = (label - p) * om                        # [B, L] raw gradient
            neu1e = neu1e + torch.einsum("bl,bld->bd", g, u) * lr
            delta = (g * lr)[..., None] * h[:, None, :]  # [B, L, D]
            if train_words:
                _scatter_clipped(syn1, points.reshape(-1),
                                 delta.reshape(-1, delta.shape[-1]),
                                 om.reshape(-1), max_row_update)
            z = (2.0 * label - 1.0) * logit
            loss = loss + torch.sum(-F.logsigmoid(z) * om)
            denom = denom + torch.sum(om)

        if negative > 0:
            pos = batch["pos"]                          # [B]
            if "neg" in batch:
                neg = batch["neg"]                      # [B, K]
            else:
                # sampled on the device from the resident unigram table
                r = torch.randint(0, unigram.shape[0], (B, negative),
                                  generator=generator, device=syn0.device)
                neg = unigram[r]
            idx = torch.cat([pos[:, None], neg], dim=1)  # [B, 1+K]
            ones = torch.ones((B, 1), dtype=dt, device=syn0.device)
            labels = torch.cat(
                [ones, torch.zeros((B, negative), dtype=dt, device=syn0.device)], dim=1)
            # a sampled negative that collides with the target is skipped
            # (word2vec.c: `if (target == word) continue`)
            om = torch.cat([ones, (neg != pos[:, None]).to(dt)], dim=1) * rm[:, None]
            u = syn1neg[idx]                            # [B, 1+K, D]
            logit = torch.einsum("bd,bkd->bk", h, u)
            p = torch.sigmoid(logit)
            g = (labels - p) * om
            neu1e = neu1e + torch.einsum("bk,bkd->bd", g, u) * lr
            delta = (g * lr)[..., None] * h[:, None, :]
            if train_words:
                _scatter_clipped(syn1neg, idx.reshape(-1),
                                 delta.reshape(-1, delta.shape[-1]),
                                 om.reshape(-1), max_row_update)
            z = (2.0 * labels - 1.0) * logit
            loss = loss + torch.sum(-F.logsigmoid(z) * om)
            denom = denom + torch.sum(om)

        if train_words:
            upd = neu1e[:, None, :].expand(B, h_idx.shape[1], neu1e.shape[-1])
            _scatter_clipped(syn0, h_idx.reshape(-1),
                             upd.reshape(-1, upd.shape[-1]), hm.reshape(-1),
                             max_row_update)
        if with_doc:
            # doc rows keep SUM semantics (sequential-SGD equivalent): a
            # doc appears at most doc-length times per batch, so the
            # summed update is bounded by lr * len — no hot-row blowup,
            # and the aggregate signal is what makes doc vectors move
            doc.index_add_(0, batch["doc_idx"], neu1e * rm[:, None])
        return loss / torch.clamp_min(denom, 1.0)

    return step


def make_embedding_step(*, use_hs: bool, negative: int, with_doc: bool,
                        train_words: bool = True, max_row_update: float = 0.25):
    """Single-batch update step. Static config: which output objective
    (HS and/or negative sampling), whether a doc row joins the hidden
    mean, and whether word tables train (False for infer_vector).
    max_row_update caps the 2-norm any single row moves per step.

    step(syn0, syn1, syn1neg, doc, batch, lr, unigram=None, generator=None)
    -> (syn0, syn1, syn1neg, doc, loss), the tables updated in place."""
    body = _build_update(
        use_hs=use_hs, negative=negative, with_doc=with_doc,
        train_words=train_words, max_row_update=max_row_update,
    )

    def step(syn0, syn1, syn1neg, doc, batch, lr, unigram=None,
             generator: Optional[torch.Generator] = None):
        if not torch.is_tensor(lr):
            lr = scalar(lr, syn0.device, syn0.dtype)
        loss = body(syn0, syn1, syn1neg, doc, unigram, batch, lr, generator)
        return syn0, syn1, syn1neg, doc, loss

    return step


def make_embedding_scan_step(*, use_hs: bool, negative: int, with_doc: bool,
                             train_words: bool = True, max_row_update: float = 0.25):
    """MULTI-batch step: the update over a stacked group of batches
    ([S, B, ...] leading axis, lrs [S]) in order, the counterpart of the
    JAX package's lax.scan over a group. Its batches are uploaded
    together; each batch's ops are dispatched eagerly.

    step(syn0, syn1, syn1neg, doc, unigram, batches, lrs, generator=None)
    -> (syn0, syn1, syn1neg, doc, mean loss over the S batches)."""
    body = _build_update(
        use_hs=use_hs, negative=negative, with_doc=with_doc,
        train_words=train_words, max_row_update=max_row_update,
    )

    def scan_step(syn0, syn1, syn1neg, doc, unigram, batches, lrs,
                  generator: Optional[torch.Generator] = None):
        if not torch.is_tensor(lrs):
            lrs = to_device(np.asarray(lrs, np.float32), syn0.device)
        losses = []
        for s in range(lrs.shape[0]):
            batch = {k: v[s] for k, v in batches.items()}
            losses.append(body(syn0, syn1, syn1neg, doc, unigram, batch,
                               lrs[s], generator))
        return syn0, syn1, syn1neg, doc, torch.stack(losses).mean()

    return scan_step
