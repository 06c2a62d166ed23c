"""Fused hybrid retrieval: dense + sparse + RRF + MMR, the port of
``advanced_rag_tpu/ops/hybrid.py``.

One function runs the whole query path on the device.  The dense rung is
one of:

- ``scan``: the exact scan of bf16/f32 rows through kernel K1;
- ``sq8``: the exact scan of SQ8 codes through kernel K2;
- ``ivf``: the probed partitions through kernel K5 (``ops/ivf.py``), with
  the rows appended since the IVF build scanned exactly (K1 or K2) and
  merged;
- ``pq``: the PQ codes through kernel K6 (``ops/pq.py``).

The sparse rung is BM25 through kernel K3 over the term-slot-major [P, N]
mirror (``sparse_impl="kernel"``) or the inverted postings
(``"postings"``, ``ops/postings.py``).  The optional domain family
(``domain_emb``, ``q_domain``; both or neither) adds the exact scan of its
rows through K1 as a third list.  Then weighted RRF with dedup, the
candidate embedding gather (PQ candidates decoded from their codes) and
greedy MMR.

Conventions: candidate ids are CorpusStore rows, -1 = padding; scores
NEG_INF = absent, as in ops/dense.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .dense import NEG_INF, merge_topk
from .dense_kernels import dense_topk_kernel, dense_topk_sq8_kernel
from .fusion import mmr_select, rrf_fuse
from .sparse_kernels import sparse_topk_kernel


class HybridResult(NamedTuple):
    ids: torch.Tensor            # [Q, k_out] i32 final ranked rows (-1 pad)
    scores: torch.Tensor         # [Q, k_out] f32 fused RRF scores
    method_counts: torch.Tensor  # [Q, k_out] i32 how many indexes hit each id
    dense_ids: torch.Tensor      # [Q, dense depth] dense candidates
    dense_scores: torch.Tensor   # (deeper than k_cand when PQ over-retrieves)
    sparse_ids: torch.Tensor     # [Q, k_cand]
    sparse_scores: torch.Tensor
    domain_ids: torch.Tensor     # [Q, k_cand] (-1-filled without the domain family)
    domain_scores: torch.Tensor


def hybrid_retrieve(
    emb: torch.Tensor,           # [N, D] bf16/f32 rows, int8 codes or PQ codes [N, m]
    idx_t: torch.Tensor,         # [P, N] i32 term-slot-major ids (-1 pad)
    tf_t: torch.Tensor,          # [P, N] bf16
    doc_len: torch.Tensor,       # [N] f32
    df: torch.Tensor,            # [V]
    n_docs: torch.Tensor,        # scalar
    q_dense: torch.Tensor,       # [Q, D] f32 (normalized upstream if cosine)
    q_idx: torch.Tensor,         # [Q, T] i32
    q_tf: torch.Tensor,          # [Q, T] f32
    valid: Optional[torch.Tensor],   # [N] bool row mask (validity AND filters)
    weights: torch.Tensor,       # [M] f32: (dense, sparse[, domain])
    mmr_lambda,                  # scalar
    emb_scale: Optional[torch.Tensor] = None,   # [N] f32 when emb is SQ8
    post_rows: Optional[torch.Tensor] = None,   # [V, L] (sparse_impl="postings")
    post_tf: Optional[torch.Tensor] = None,     # [V, L]
    post_tfw: Optional[torch.Tensor] = None,    # [V, L] build-time tf-weights
    pq_codebooks: Optional[torch.Tensor] = None,  # [m, c, dsub] (dense_impl="pq")
    ivf_parts=None,              # ops.ivf.IVFPartitions (dense_impl="ivf")
    domain_emb: Optional[torch.Tensor] = None,  # [N, Dd] bf16/f32 domain rows
    q_domain: Optional[torch.Tensor] = None,    # [Q, Dd] f32 (normalized if cosine)
    *,
    k_cand: int,
    k_out: int,
    metric: str = "ip",
    scoring: str = "bm25",
    rrf_k: int = 60,
    use_mmr: bool = True,
    enable_sparse: bool = True,
    dense_impl: str = "scan",    # "scan" (K1) | "sq8" (K2) | "ivf" (K5) | "pq" (K6)
    sparse_impl: str = "kernel",  # "kernel" (K3) | "postings"
    sparse_agg: str = "sort",    # postings aggregation: "sort" | "scatter"
    nprobe: int = 32,            # IVF probes
    ivf_tail_start: int = 0,     # first row appended since the IVF build
    ivf_tail_pad: int = 0,       # pow2-padded tail length; 0 = no tail
    pq_m: int = 0,               # PQ geometry (dense_impl="pq")
    pq_bits: int = 4,
    dense_depth: int = 0,        # dense over-retrieve depth (0 = k_cand)
    k1: float = 1.2,
    b: float = 0.75,
) -> HybridResult:
    """One-pass hybrid search; the counterpart of the JAX function.

    The dense rung retrieves ``max(dense_depth, k_cand)`` candidates
    (returned in ``dense_ids``/``dense_scores``; the PQ tier over-retrieves
    for the manager's exact host refinement); fusion takes the top k_cand.
    """
    depth = max(dense_depth, k_cand)
    if dense_impl == "ivf":
        from .ivf import ivf_topk

        d_s, d_i = ivf_topk(ivf_parts, q_dense, depth, valid, nprobe=nprobe)
        if ivf_tail_pad:
            # rows appended since the build: an exact scan, merged
            end = min(ivf_tail_start + ivf_tail_pad, emb.shape[0])
            t_emb = emb[ivf_tail_start:end]
            t_mask = (valid[ivf_tail_start:end] if valid is not None else None)
            kk = min(depth, ivf_tail_pad)
            if emb_scale is not None:
                ts, ti = dense_topk_sq8_kernel(
                    t_emb, emb_scale[ivf_tail_start:end], q_dense, kk, t_mask,
                    metric="ip", normalize_queries=False)
            else:
                ts, ti = dense_topk_kernel(t_emb, q_dense, kk, t_mask,
                                           metric=metric, normalize_queries=False)
            ti = torch.where(ti >= 0, ti + ivf_tail_start, -1)
            if kk < depth:
                ts = torch.nn.functional.pad(ts, (0, depth - kk), value=NEG_INF)
                ti = torch.nn.functional.pad(ti, (0, depth - kk), value=-1)
            d_s, d_i = merge_topk(d_s, d_i, ts, ti, depth)
            d_i = torch.where(d_s <= NEG_INF, -1, d_i)
    elif dense_impl == "pq":
        from .pq import pq_topk

        d_s, d_i = pq_topk(pq_codebooks, emb, q_dense, depth, valid,
                           m=pq_m, bits=pq_bits)
    elif dense_impl == "sq8":
        if emb_scale is None:
            raise ValueError('dense_impl="sq8" requires emb_scale')
        d_s, d_i = dense_topk_sq8_kernel(emb, emb_scale, q_dense, depth,
                                         valid, metric="ip",
                                         normalize_queries=False)
    elif dense_impl == "scan":
        d_s, d_i = dense_topk_kernel(emb, q_dense, depth, valid,
                                     metric=metric, normalize_queries=False)
    else:
        raise ValueError(f"unknown dense_impl: {dense_impl}")
    methods_i = [d_i[:, :k_cand]]
    if enable_sparse:
        if sparse_impl == "postings":
            from .postings import postings_topk

            s_s, s_i = postings_topk(
                post_rows, post_tf, doc_len, df, n_docs, q_idx, q_tf, k_cand,
                valid[: doc_len.shape[0]] if valid is not None else None,
                post_tfw=post_tfw, scoring=scoring, k1=k1, b=b,
                impl=sparse_agg)
        elif sparse_impl == "kernel":
            s_s, s_i = sparse_topk_kernel(idx_t, tf_t, doc_len, df, n_docs,
                                          q_idx, q_tf, k_cand, valid,
                                          scoring=scoring, k1=k1, b=b)
        else:
            raise ValueError(f"unknown sparse_impl: {sparse_impl}")
        methods_i.append(s_i)
    else:
        s_s = torch.full((d_s.shape[0], k_cand), NEG_INF, dtype=d_s.dtype,
                         device=d_s.device)
        s_i = torch.full((d_i.shape[0], k_cand), -1, dtype=d_i.dtype,
                         device=d_i.device)
    if domain_emb is not None and q_domain is not None:
        dom_s, dom_i = dense_topk_kernel(domain_emb, q_domain, k_cand, valid,
                                         metric=metric, normalize_queries=False)
        methods_i.append(dom_i)
    else:
        dom_s = torch.full((d_s.shape[0], k_cand), NEG_INF, dtype=d_s.dtype,
                           device=d_s.device)
        dom_i = torch.full((d_i.shape[0], k_cand), -1, dtype=d_i.dtype,
                           device=d_i.device)
    cand_ids = torch.stack(methods_i, dim=0)                 # [M, Q, K]
    w = weights[: len(methods_i)]

    # fuse over the full candidate pool; MMR then selects k_out diverse
    # results from the k_cand-deep pool
    fused_s, fused_i, counts = rrf_fuse(cand_ids, w, rrf_k=rrf_k, k_out=k_cand)

    if use_mmr:
        safe = torch.clamp(fused_i, min=0).long()
        if dense_impl == "pq":
            # reconstruct candidates from their PQ codes (a small gather)
            from .pq import PQCodebook, pq_decode

            cand_emb = pq_decode(PQCodebook(pq_codebooks, pq_m, pq_bits),
                                 emb[safe])                  # [Q, k_cand, D]
        else:
            cand_emb = emb[safe].float()                     # [Q, k_cand, D]
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

    return HybridResult(out_i, out_s, out_c, d_i, d_s, s_i, s_s, dom_i, dom_s)


__all__ = ["hybrid_retrieve", "HybridResult"]
