"""Sparse lexical (BM25 / inner-product) scoring and top-k: the port of
``advanced_rag_tpu/ops/sparse.py``.

Every document is a fixed-nnz padded row — ``doc_idx[N, P]`` term ids
(-1 pad) and ``doc_tf[N, P]`` term frequencies — and scoring compares the
doc term ids with the query's at most T term ids, with no gather:

    score[q, d] = sum_t q_w[q, t] * sum_p tfw[d, p] * [doc_idx[d, p] == q_idx[q, t]]

``sparse_topk`` is the plain compare-scan over the doc-major layout, the
counterpart of the JAX function; the serving path scores through kernel K3
(``ops/sparse_kernels.py``) over the term-slot-major [P, N] mirror.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .dense import NEG_INF, reduce_topk


def idf_weights(df: torch.Tensor, n_docs: torch.Tensor) -> torch.Tensor:
    """Robertson-Sparck-Jones idf over the whole vocab: [V] f32,
    ``ln(1 + (N - df + 0.5) / (df + 0.5))``, always positive."""
    df = df.float()
    n = torch.as_tensor(n_docs, dtype=torch.float32, device=df.device)
    return torch.log1p(torch.clamp(n - df + 0.5, min=0.5) / (df + 0.5))


def query_weights(q_idx: torch.Tensor, q_tf: torch.Tensor, df: torch.Tensor,
                  n_docs: torch.Tensor, scoring: str) -> torch.Tensor:
    """[Q, T] f32 query-term weights: tf * idf for BM25, tf for ip, 0 on
    padding terms (one small gather over the query terms only)."""
    ok = q_idx >= 0
    if scoring == "bm25":
        idf = idf_weights(df, n_docs)[torch.clamp(q_idx, min=0).long()]
        return q_tf.float() * torch.where(ok, idf, 0.0)
    if scoring == "ip":
        return torch.where(ok, q_tf.float(), 0.0)
    raise ValueError(f"unknown scoring: {scoring}")


def live_avg_len(doc_len: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean document length over the rows the mask keeps."""
    n = doc_len.shape[0]
    v = (valid[:n].to(torch.bool) if valid is not None
         else torch.ones(n, dtype=torch.bool, device=doc_len.device))
    return (torch.sum(torch.where(v, doc_len.float(), 0.0))
            / torch.clamp(torch.sum(v.float()), min=1.0))


def sparse_topk(
    doc_idx: torch.Tensor,   # [N, P] i32 term ids, -1 pad
    doc_tf: torch.Tensor,    # [N, P] term frequencies
    doc_len: torch.Tensor,   # [N] f32 document lengths (tokens)
    df: torch.Tensor,        # [V] document frequencies
    n_docs: torch.Tensor,    # scalar: live corpus size (for idf)
    q_idx: torch.Tensor,     # [Q, T] i32 query term ids, -1 pad
    q_tf: torch.Tensor,      # [Q, T] f32 query term frequencies
    k: int,
    valid: Optional[torch.Tensor] = None,    # [N] bool
    avg_len: Optional[torch.Tensor] = None,  # scalar; None -> from valid rows
    *,
    scoring: str = "bm25",   # "bm25" | "ip"
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked sparse top-k (plain compare-scan over the doc-major layout).

    Returns ``(scores [Q, k] f32, ids [Q, k] i32)`` with -1/NEG_INF
    padding.  Term ids within one doc row must be distinct (index/text.py
    aggregates tf per term), as in the JAX package.
    """
    n = doc_idx.shape[0]
    if n == 0:
        raise ValueError("sparse_topk: empty corpus")
    q_w = query_weights(q_idx, q_tf, df, n_docs, scoring)
    if avg_len is None:
        avg_len = live_avg_len(doc_len, valid)
    tf = doc_tf.float()
    if scoring == "bm25":
        denom = tf + k1 * (1.0 - b + b * doc_len.float()[:, None]
                           / torch.clamp(avg_len, min=1.0))
        tfw = tf * (k1 + 1.0) / torch.clamp(denom, min=1e-6)
    else:
        tfw = tf
    tfw = torch.where(doc_idx >= 0, tfw, 0.0)                  # [N, P]
    scores = torch.zeros((q_idx.shape[0], n), dtype=torch.float32,
                         device=doc_idx.device)
    for t in range(q_idx.shape[1]):
        eq = doc_idx[None, :, :] == q_idx[:, t, None, None]    # [Q, N, P]
        contrib = torch.sum(torch.where(eq, tfw[None], 0.0), dim=2)
        scores = scores + q_w[:, t, None] * contrib
    if valid is not None:
        scores = torch.where(valid[None, :n].to(torch.bool), scores, NEG_INF)
    return reduce_topk(scores, n, k)


__all__ = ["idf_weights", "query_weights", "live_avg_len", "sparse_topk"]
