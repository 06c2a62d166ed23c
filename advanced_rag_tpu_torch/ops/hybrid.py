"""Fused hybrid retrieval: dense + sparse + RRF + MMR, the port of
``advanced_rag_tpu/ops/hybrid.py``.

One function runs the whole query path on the device: masked dense top-k
through kernel K1 (bf16/f32 rows, ``dense_impl="scan"``) or K2 (SQ8 codes,
``dense_impl="sq8"``), masked BM25 top-k through kernel K3 over the
term-slot-major [P, N] mirror, weighted RRF with dedup, the candidate
embedding gather, and greedy MMR.

Conventions: candidate ids are CorpusStore rows, -1 = padding; scores
NEG_INF = absent, as in ops/dense.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .dense import NEG_INF
from .dense_kernels import dense_topk_kernel, dense_topk_sq8_kernel
from .fusion import mmr_select, rrf_fuse
from .sparse_kernels import sparse_topk_kernel

#: dense rungs of the JAX package that belong to later slices of the port
LATER_DENSE_RUNGS = {
    "ivf": "the IVF slice (ops/ivf.py with kernels K4 and K5)",
    "pq": "the PQ and IVF-PQ slice (ops/pq.py with kernel K6)",
}


class HybridResult(NamedTuple):
    ids: torch.Tensor            # [Q, k_out] i32 final ranked rows (-1 pad)
    scores: torch.Tensor         # [Q, k_out] f32 fused RRF scores
    method_counts: torch.Tensor  # [Q, k_out] i32 how many indexes hit each id
    dense_ids: torch.Tensor      # [Q, k_cand] per-index candidates
    dense_scores: torch.Tensor
    sparse_ids: torch.Tensor
    sparse_scores: torch.Tensor


def hybrid_retrieve(
    emb: torch.Tensor,           # [N, D] bf16/f32 rows or int8 codes
    idx_t: torch.Tensor,         # [P, N] i32 term-slot-major ids (-1 pad)
    tf_t: torch.Tensor,          # [P, N] f32
    doc_len: torch.Tensor,       # [N] f32
    df: torch.Tensor,            # [V]
    n_docs: torch.Tensor,        # scalar
    q_dense: torch.Tensor,       # [Q, D] f32 (normalized upstream if cosine)
    q_idx: torch.Tensor,         # [Q, T] i32
    q_tf: torch.Tensor,          # [Q, T] f32
    valid: Optional[torch.Tensor],   # [N] bool row mask (validity AND filters)
    weights: torch.Tensor,       # [2] f32: (dense, sparse)
    mmr_lambda,                  # scalar
    emb_scale: Optional[torch.Tensor] = None,   # [N] f32 when emb is SQ8
    *,
    k_cand: int,
    k_out: int,
    metric: str = "ip",
    scoring: str = "bm25",
    rrf_k: int = 60,
    use_mmr: bool = True,
    enable_sparse: bool = True,
    dense_impl: str = "scan",    # "scan" (K1) | "sq8" (K2)
    k1: float = 1.2,
    b: float = 0.75,
) -> HybridResult:
    """One-pass hybrid search; the counterpart of the JAX function with the
    sparse stage on its compare-scan rung (here kernel K3)."""
    if dense_impl in LATER_DENSE_RUNGS:
        raise NotImplementedError(
            f"dense_impl={dense_impl!r} is ported in "
            f"{LATER_DENSE_RUNGS[dense_impl]}")
    if dense_impl == "sq8":
        if emb_scale is None:
            raise ValueError('dense_impl="sq8" requires emb_scale')
        d_s, d_i = dense_topk_sq8_kernel(emb, emb_scale, q_dense, k_cand,
                                         valid, metric="ip",
                                         normalize_queries=False)
    elif dense_impl == "scan":
        d_s, d_i = dense_topk_kernel(emb, q_dense, k_cand, valid,
                                     metric=metric, normalize_queries=False)
    else:
        raise ValueError(f"unknown dense_impl: {dense_impl}")
    methods_i = [d_i]
    if enable_sparse:
        s_s, s_i = sparse_topk_kernel(idx_t, tf_t, doc_len, df, n_docs,
                                      q_idx, q_tf, k_cand, valid,
                                      scoring=scoring, k1=k1, b=b)
        methods_i.append(s_i)
    else:
        s_s = torch.full_like(d_s, NEG_INF)
        s_i = torch.full_like(d_i, -1)
    cand_ids = torch.stack(methods_i, dim=0)                 # [M, Q, K]
    w = weights[: len(methods_i)]

    # fuse over the full candidate pool; MMR then selects k_out diverse
    # results from the k_cand-deep pool
    fused_s, fused_i, counts = rrf_fuse(cand_ids, w, rrf_k=rrf_k, k_out=k_cand)

    if use_mmr:
        safe = torch.clamp(fused_i, min=0).long()
        cand_emb = emb[safe].float()                         # [Q, k_cand, D]
        if emb_scale is not None:  # dequantize SQ8 codes for cosine-MMR
            cand_emb = cand_emb * emb_scale[safe][..., None]
        pos = mmr_select(cand_emb, fused_s, k_out, mmr_lambda, fused_i >= 0)
        sel_ok = pos >= 0
        safe_pos = torch.clamp(pos, min=0).long()
        out_i = torch.where(sel_ok, torch.gather(fused_i, 1, safe_pos), -1)
        out_s = torch.where(sel_ok, torch.gather(fused_s, 1, safe_pos), NEG_INF)
        out_c = torch.where(sel_ok, torch.gather(counts, 1, safe_pos), 0)
    else:
        out_i = fused_i[:, :k_out]
        out_s = fused_s[:, :k_out]
        out_c = counts[:, :k_out]

    return HybridResult(out_i, out_s, out_c, d_i, d_s, s_i, s_s)


__all__ = ["hybrid_retrieve", "HybridResult"]
