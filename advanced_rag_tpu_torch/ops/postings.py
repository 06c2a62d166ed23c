"""Inverted postings-list BM25: the port of ``advanced_rag_tpu/ops/postings.py``.

Per-term postings padded to a cap L: ``post_rows [V, L]`` i32 (-1 pad) and
``post_tf [V, L]``, with the BM25 tf-weights ``post_tfw [V, L]`` computed
at build time against that build's live average length.  A query touches
only the T * L postings of its terms, not the N * P slots of the compare
scan.  Terms with df > L keep their highest-tf postings, so beyond the cap
the scores are an underestimate, and appends score against the frozen
average length until the next build: at real corpus sizes postings give
other BM25 scores than the compare scan (kernel K3), as in the JAX package.

Two aggregation rungs, both plain PyTorch (the JAX package runs them in
XLA, with no Pallas kernel):

- ``sort``: per query, sort the [T * L] (row, contribution) pairs by row,
  take the segment sums from a cumulative sum and a running maximum of the
  segment ends, then the top-k;
- ``scatter``: accumulate every contribution into a [Q, N] matrix, mask it
  and take the top-k.

The device keeps ``post_tf`` and ``post_tfw`` in bf16, as the JAX package
does; the host-side build functions below return f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dense import NEG_INF, topk_first
from .sparse import idf_weights, live_avg_len

_PAD_KEY = 2 ** 30


def _segment_topk(rows: torch.Tensor, contrib: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows [Q, M] i32 (-1 pad), contrib [Q, M] f32 (>= 0) -> top-k of the
    per-row sums.  Contributions are non-negative, so the cumulative sums
    are monotone and a running maximum recovers each segment's start."""
    key = torch.where(rows < 0, _PAD_KEY, rows)
    sorted_rows, order = torch.sort(key, dim=1, stable=True)
    sorted_c = torch.gather(contrib, 1, order)
    csum = torch.cumsum(sorted_c, dim=1)
    nxt = torch.cat([sorted_rows[:, 1:],
                     torch.full_like(sorted_rows[:, :1], -2)], dim=1)
    is_last = sorted_rows != nxt                        # segment ends
    end_csum = torch.where(is_last, csum, 0.0)
    prev_end = torch.cat([torch.zeros_like(csum[:, :1]), end_csum[:, :-1]], dim=1)
    prev_end = torch.cummax(prev_end, dim=1).values
    seg_sum = csum - prev_end
    ok = is_last & (sorted_rows < _PAD_KEY)
    scores = torch.where(ok, seg_sum, NEG_INF)
    top_s, sel = topk_first(scores, k)
    top_i = torch.where(top_s <= NEG_INF, -1, torch.gather(sorted_rows, 1, sel))
    return top_s, top_i.to(torch.int32)


def postings_topk(
    post_rows: torch.Tensor,   # [V, L] i32 row ids per term (-1 pad)
    post_tf: torch.Tensor,     # [V, L] term frequencies (bf16 on the device)
    doc_len: torch.Tensor,     # [N] f32 (row-indexed)
    df: torch.Tensor,          # [V]
    n_docs: torch.Tensor,      # scalar
    q_idx: torch.Tensor,       # [Q, T] i32 (-1 pad)
    q_tf: torch.Tensor,        # [Q, T] f32
    k: int,
    valid: Optional[torch.Tensor] = None,     # [N] bool (row-indexed)
    avg_len: Optional[torch.Tensor] = None,
    post_tfw: Optional[torch.Tensor] = None,  # [V, L] build-time tf-weights
    *,
    scoring: str = "bm25",
    k1: float = 1.2,
    b: float = 0.75,
    impl: str = "sort",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ops.sparse.sparse_topk, postings-backed."""
    n = doc_len.shape[0]
    dev = doc_len.device
    v = (valid[:n].to(torch.bool) if valid is not None
         else torch.ones(n, dtype=torch.bool, device=dev))
    if avg_len is None:
        avg_len = live_avg_len(doc_len, v)
    avg_len = torch.as_tensor(avg_len, dtype=torch.float32, device=dev)

    q_idx = q_idx.to(dev)
    ok_t = q_idx >= 0
    safe_t = torch.clamp(q_idx, min=0).long()
    if scoring == "bm25":
        q_w = q_tf.float() * torch.where(ok_t, idf_weights(df, n_docs)[safe_t], 0.0)
    elif scoring == "ip":
        q_w = torch.where(ok_t, q_tf.float(), 0.0)
    else:
        raise ValueError(f"unknown scoring: {scoring}")

    def tf_weights(rows: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
        if scoring == "bm25" and post_tfw is not None:
            return post_tfw[terms].float()
        tf = post_tf[terms].float()
        if scoring != "bm25":
            return tf
        dlen = doc_len[torch.clamp(rows, min=0).long()].float()
        denom = tf + k1 * (1.0 - b + b * dlen / torch.clamp(avg_len, min=1.0))
        return tf * (k1 + 1.0) / torch.clamp(denom, min=1e-6)

    if impl == "scatter":
        nq, t_len = q_idx.shape
        acc = torch.zeros((nq, n + 1), dtype=torch.float32, device=dev)
        qrow = torch.arange(nq, device=dev)[:, None]
        for t in range(t_len):
            rows = post_rows[safe_t[:, t]]                      # [Q, L]
            w = q_w[:, t, None] * tf_weights(rows, safe_t[:, t])
            ok = (rows >= 0) & ok_t[:, t, None]
            # row n is the drop slot of absent postings
            acc.index_put_((qrow.expand_as(rows), torch.where(ok, rows, n).long()),
                           torch.where(ok, w, 0.0), accumulate=True)
        acc = torch.where(v[None, :], acc[:, :n], 0.0)
        top_s, top_i = topk_first(acc, k)
        top_i = torch.where(top_s > 0.0, top_i.to(torch.int32), -1)
        top_s = torch.where(top_s > 0.0, top_s, NEG_INF)
        return top_s, top_i
    if impl != "sort":
        raise ValueError(f"unknown postings impl: {impl}")

    rows = torch.where(ok_t[:, :, None], post_rows[safe_t], -1)   # [Q, T, L]
    safe_r = torch.clamp(rows, min=0).long()
    row_ok = (rows >= 0) & v[safe_r]
    tfw = tf_weights(rows, safe_t)
    contrib = torch.where(row_ok, q_w[:, :, None] * tfw, 0.0)
    rows = torch.where(row_ok, rows, -1)
    nq = rows.shape[0]
    return _segment_topk(rows.reshape(nq, -1), contrib.reshape(nq, -1), k)


def postings_tf_weights(post_rows, post_tf, doc_len, avg_len: float,
                        k1: float = 1.2, b: float = 0.75) -> np.ndarray:
    """The BM25 tf-saturation weight of every posting (numpy), with the
    build-time live average length."""
    rows = np.asarray(post_rows)
    tf = np.asarray(post_tf, np.float32)
    dl = np.asarray(doc_len, np.float32)[np.clip(rows, 0, None)]
    denom = tf + k1 * (1.0 - b + b * dl / max(avg_len, 1.0))
    tfw = tf * (k1 + 1.0) / np.maximum(denom, 1e-6)
    tfw[rows < 0] = 0.0
    return tfw.astype(np.float32)


def build_postings(doc_idx, doc_tf, vocab_size: int,
                   cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side build from the slot layout -> (post_rows, post_tf) numpy,
    keeping the highest-tf ``cap`` postings of each term (stable sort by
    (term, -tf), positions by searchsorted)."""
    n, p = doc_idx.shape
    flat_t = np.asarray(doc_idx).reshape(-1)
    flat_tf = np.asarray(doc_tf, np.float32).reshape(-1)
    flat_r = np.repeat(np.arange(n, dtype=np.int32), p)
    keep = flat_t >= 0
    flat_t, flat_tf, flat_r = flat_t[keep], flat_tf[keep], flat_r[keep]
    order = np.lexsort((-flat_tf, flat_t))
    st, stf, sr = flat_t[order], flat_tf[order], flat_r[order]
    first = np.searchsorted(st, np.arange(vocab_size))
    pos = np.arange(len(st), dtype=np.int64) - first[st]
    keep = pos < cap
    post_rows = np.full((vocab_size, cap), -1, np.int32)
    post_tf = np.zeros((vocab_size, cap), np.float32)
    post_rows[st[keep], pos[keep]] = sr[keep]
    post_tf[st[keep], pos[keep]] = stf[keep]
    return post_rows, post_tf


def auto_postings_cap(n_docs: int, doc_nnz: int, vocab_size: int,
                      headroom: float = 8.0, lo: int = 128,
                      hi: int = 16384) -> int:
    """Cap ~ headroom * average postings length, pow2-rounded."""
    avg = max(1.0, n_docs * doc_nnz / max(vocab_size, 1))
    cap = 1
    while cap < avg * headroom:
        cap *= 2
    return max(lo, min(hi, cap))


__all__ = ["postings_topk", "postings_tf_weights", "build_postings",
           "auto_postings_cap"]
