"""Exact per-candidate tier rescoring for the rerank stage: the port of
``advanced_rag_tpu/ops/rescore.py``.

Rank-based RRF fusion discards score magnitudes, so the rerank stage
re-scores its k_rerank candidates exactly per tier — a dense dot against
the stored embeddings and a full BM25 against the doc-major term table —
and ranks by a z-normalized blend (``zmix_base``).  Both rescores are
gathers over [Q, K] candidate rows.  ``exact_tier_scores_postings`` takes
the BM25 column from the inverted postings instead of the doc-major table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .sparse import idf_weights, live_avg_len


def _dense_rescore(safe: torch.Tensor, q_dense: torch.Tensor,
                   emb: torch.Tensor,
                   emb_scale: Optional[torch.Tensor]) -> torch.Tensor:
    e = emb[safe].float()                                     # [Q, K, D]
    dense = torch.einsum("qd,qkd->qk", q_dense.float(), e)
    if emb_scale is not None:
        # SQ8 rows: int8 codes * per-row scale (ops/quant.py)
        dense = dense * emb_scale[safe].float()
    return dense


def _live_avg_len(doc_len: torch.Tensor, n_docs: torch.Tensor,
                  valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is not None:
        return live_avg_len(doc_len, valid)
    # appends zero-fill doc_len past the live prefix, so the live average
    # is sum / n_docs (not / capacity)
    return torch.sum(doc_len.float()) / torch.clamp(
        torch.as_tensor(n_docs, dtype=torch.float32, device=doc_len.device),
        min=1.0)


def exact_tier_scores(
    cand: torch.Tensor,          # [Q, K] i32 candidate rows (-1 pad)
    q_dense: torch.Tensor,       # [Q, D] f32 query embeddings
    q_idx: torch.Tensor,         # [Q, T] i32 sparse query terms (-1 pad)
    q_tf: torch.Tensor,          # [Q, T] f32
    emb: torch.Tensor,           # [N, D] stored embeddings (f32/bf16/int8)
    doc_idx: torch.Tensor,       # [N, P] i32 doc-major term table
    doc_tf: torch.Tensor,        # [N, P]
    doc_len: torch.Tensor,       # [N] f32
    df: torch.Tensor,            # [V]
    n_docs: torch.Tensor,        # scalar f32 live corpus size
    valid: Optional[torch.Tensor] = None,      # [N] bool live-row mask
    emb_scale: Optional[torch.Tensor] = None,  # [N] f32 SQ8 row scales
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dense [Q, K], bm25 [Q, K]) exact scores of each candidate.

    Same BM25 weighting as the corpus-wide scan, with the average length
    over the live corpus; padded candidates (row -1) come back as 0.
    """
    safe = torch.clamp(cand, min=0).long()                    # [Q, K]
    dense = _dense_rescore(safe, q_dense, emb, emb_scale)

    q_w = q_tf.float() * torch.where(
        q_idx >= 0, idf_weights(df, n_docs)[torch.clamp(q_idx, min=0).long()],
        0.0)                                                  # [Q, T]
    di = doc_idx[safe]                                        # [Q, K, P]
    dt = doc_tf[safe].float()
    dl = doc_len[safe].float()
    avg_len = _live_avg_len(doc_len, n_docs, valid)
    denom = dt + k1 * (1.0 - b + b * dl[:, :, None]
                       / torch.clamp(avg_len, min=1.0))
    tfw = dt * (k1 + 1.0) / torch.clamp(denom, min=1e-6)      # [Q, K, P]
    tfw = torch.where(di >= 0, tfw, 0.0)
    eq = di[:, :, :, None] == q_idx[:, None, None, :]         # [Q, K, P, T]
    hit = torch.sum(tfw[:, :, :, None] * eq.float(), dim=2)   # [Q, K, T]
    bm25 = torch.sum(hit * q_w[:, None, :], dim=-1)           # [Q, K]

    ok = (cand >= 0).float()
    return dense * ok, bm25 * ok


def exact_tier_scores_postings(
    cand: torch.Tensor,          # [Q, K] i32 candidate rows (-1 pad)
    q_dense: torch.Tensor,       # [Q, D] f32 query embeddings
    q_idx: torch.Tensor,         # [Q, T] i32 sparse query terms (-1 pad)
    q_tf: torch.Tensor,          # [Q, T] f32
    emb: torch.Tensor,           # [N, D] stored embeddings (f32/bf16/int8)
    post_rows: torch.Tensor,     # [V, L] i32 inverted postings (-1 pad)
    post_tf: torch.Tensor,       # [V, L] term frequencies
    doc_len: torch.Tensor,       # [N] f32
    df: torch.Tensor,            # [V]
    n_docs: torch.Tensor,        # scalar f32 live corpus size
    valid: Optional[torch.Tensor] = None,      # [N] bool live-row mask
    emb_scale: Optional[torch.Tensor] = None,  # [N] f32 SQ8 row scales
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``exact_tier_scores``, with each candidate's tf of
    each query term found in that term's postings row.  Equal to it while
    no query term's df exceeds the cap L; beyond the cap a dropped (doc,
    term) slot scores 0, as in the postings scan.  One [Q, L, K] compare a
    query term, never the whole [Q, T, L, K] at once."""
    safe = torch.clamp(cand, min=0).long()                    # [Q, K]
    dense = _dense_rescore(safe, q_dense, emb, emb_scale)

    t_ok = q_idx >= 0
    safe_t = torch.clamp(q_idx, min=0).long()
    q_w = q_tf.float() * torch.where(t_ok, idf_weights(df, n_docs)[safe_t], 0.0)
    rows = torch.where(t_ok[:, :, None], post_rows[safe_t], -1)   # [Q, T, L]
    ptf = post_tf[safe_t].float()
    tf = torch.stack([
        torch.sum(torch.where((rows[:, t, :, None] == safe[:, None, :])
                              & (rows[:, t, :, None] >= 0),
                              ptf[:, t, :, None], 0.0), dim=1)
        for t in range(q_idx.shape[1])], dim=2)               # [Q, K, T]

    dl = doc_len[safe].float()                                # [Q, K]
    avg_len = _live_avg_len(doc_len, n_docs, valid)
    denom = tf + k1 * (1.0 - b + b * dl[:, :, None]
                       / torch.clamp(avg_len, min=1.0))
    tfw = tf * (k1 + 1.0) / torch.clamp(denom, min=1e-6)      # [Q, K, T]
    bm25 = torch.sum(tfw * q_w[:, None, :], dim=-1)           # [Q, K]

    ok = (cand >= 0).float()
    return dense * ok, bm25 * ok


def znorm(x: torch.Tensor, validm: torch.Tensor) -> torch.Tensor:
    """Slate z-score over the valid candidates of each row."""
    nv = torch.clamp(torch.sum(validm, 1, keepdim=True), min=1)
    mean = torch.sum(torch.where(validm, x, 0.0), 1, keepdim=True) / nv
    var = torch.sum(torch.where(validm, (x - mean) ** 2, 0.0),
                    1, keepdim=True) / nv
    return (x - mean) * torch.rsqrt(var + 1e-9)


def zmix_base(dense: torch.Tensor, bm25: torch.Tensor, validm: torch.Tensor,
              mix) -> torch.Tensor:
    """Slate-z-normalized blend: z(mix*z(dense) + (1-mix)*z(bm25))."""
    blend = mix * znorm(dense, validm) + (1.0 - mix) * znorm(bm25, validm)
    return znorm(blend, validm)


__all__ = ["exact_tier_scores", "exact_tier_scores_postings", "zmix_base", "znorm"]
