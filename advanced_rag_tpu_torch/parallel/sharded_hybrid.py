"""Sharded fused hybrid retrieval: the port of
``advanced_rag_tpu/parallel/sharded_hybrid.py``.

The fused program of ``ops/hybrid.py`` across the mesh's ``shard`` axis:
per-shard masked dense and BM25 top-k through the port's kernels, the
global top-k merges (only k ids and scores cross between ranks), RRF over
the merged lists (the same on every rank), then MMR, whose candidate
embeddings are assembled with ONE ``all_reduce`` (sum): each rank
contributes the rows it owns, zeros elsewhere.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.dense import NEG_INF
from ..ops.dense_kernels import dense_topk_kernel, dense_topk_sq8_kernel
from ..ops.fusion import mmr_select, rrf_fuse
from ..ops.sparse_kernels import sparse_topk_kernel
from .comm import all_reduce_sum
from .mesh import Mesh
from .sharded_search import _merge, live_avg_len_sharded, to_global

DENSE_IMPLS = ("scan", "sq8", "pq", "ivf", "ivfpq")


def _local_dense(dense_impl, emb, q, kk, valid, *, metric, emb_scale, pq_codebooks,
                 ivfpq_idx, ivf_parts, nprobe, pq_m, pq_bits):
    """The shard's dense top-kk: K1 (scan), K2 (sq8), K6 (pq through
    ``pq_topk``, ivfpq through ``ivfpq_topk``) or K5 (ivf)."""
    if dense_impl == "ivf":
        from ..ops.ivf import ivf_topk

        return ivf_topk(ivf_parts, q, kk, valid, nprobe=nprobe)
    if dense_impl == "ivfpq":
        from ..ops.ivfpq import ivfpq_topk

        return ivfpq_topk(ivfpq_idx, q, kk, valid, nprobe=nprobe,
                          m=int(ivfpq_idx.codebooks.shape[0]), bits=pq_bits)
    if dense_impl == "pq":
        from ..ops.pq import pq_topk

        return pq_topk(pq_codebooks, emb, q, kk, valid, m=pq_m, bits=pq_bits)
    if dense_impl == "sq8":
        return dense_topk_sq8_kernel(emb, emb_scale, q, kk, valid, metric="ip",
                                     normalize_queries=False)
    return dense_topk_kernel(emb, q, kk, valid, metric=metric, normalize_queries=False)


def sharded_hybrid_retrieve(
    emb: torch.Tensor,        # [local_n, D] rows (SQ8 codes; PQ codes [local_n, m])
    idx_t: torch.Tensor,      # [P, local_n] i32 the rank's slot mirror
    tf_t: torch.Tensor,       # [P, local_n] bf16
    doc_len: torch.Tensor,    # [local_n] f32
    df: torch.Tensor,         # [V] whole (global)
    n_docs: torch.Tensor,     # scalar (global)
    q_dense: torch.Tensor,    # [Q, D] whole (normalized upstream)
    q_idx: torch.Tensor,      # [Q, T] whole
    q_tf: torch.Tensor,       # [Q, T] whole
    valid: Optional[torch.Tensor],   # [local_n] bool
    weights: torch.Tensor,    # [2] f32
    mmr_lambda,
    pq_codebooks: Optional[torch.Tensor] = None,  # [m, c, dsub] whole
    emb_scale: Optional[torch.Tensor] = None,     # [local_n] f32 (SQ8)
    # the rank's partitioned structures: build_sharded_ivfpq (with ivfpq,
    # emb holds the rank's FLAT PQ codes, used only for the MMR decode) /
    # build_sharded_ivf
    ivfpq_idx=None,
    ivf_parts=None,
    *,
    mesh: Mesh,
    k_cand: int,
    k_out: int,
    metric: str = "ip",
    scoring: str = "bm25",
    rrf_k: int = 60,
    use_mmr: bool = True,
    shard_axis: str = "shard",
    dense_impl: str = "scan",    # scan | sq8 | pq | ivf | ivfpq
    nprobe: int = 32,
    pq_m: int = 0,
    pq_bits: int = 4,
    dense_depth: int = 0,        # dense over-retrieve depth (0 = k_cand)
):
    """-> (ids [Q, k_out], scores, method_counts)[, dense ids / scores at
    ``dense_depth`` when it is above k_cand], the same on every rank.

    The contract of ``ops.hybrid.hybrid_retrieve`` on the unsharded corpus:
    BM25 from the global df and the summed mean length; RRF and MMR over
    the globally merged candidates.  The weights are cut to the two fused
    lists, as the JAX program cuts them.
    """
    if dense_impl not in DENSE_IMPLS:
        raise ValueError(f"unknown dense_impl: {dense_impl}")
    if dense_impl == "ivf" and ivf_parts is None:
        raise ValueError('dense_impl="ivf" requires ivf_parts (build_sharded_ivf)')
    if dense_impl == "ivfpq" and ivfpq_idx is None:
        raise ValueError('dense_impl="ivfpq" requires ivfpq_idx (build_sharded_ivfpq)')
    if dense_impl == "sq8" and emb_scale is None:
        raise ValueError('dense_impl="sq8" requires emb_scale')
    num_shards = mesh.shape[shard_axis]
    local_n = emb.shape[0]
    offset = mesh.index(shard_axis) * local_n
    depth = max(dense_depth, k_cand)
    kk = min(depth, local_n)
    q = q_dense.float()

    d_s, d_i = _local_dense(dense_impl, emb, q, kk, valid, metric=metric,
                            emb_scale=emb_scale, pq_codebooks=pq_codebooks,
                            ivfpq_idx=ivfpq_idx, ivf_parts=ivf_parts, nprobe=nprobe,
                            pq_m=pq_m, pq_bits=pq_bits)
    if kk < depth:
        d_s = torch.nn.functional.pad(d_s, (0, depth - kk), value=NEG_INF)
        d_i = torch.nn.functional.pad(d_i, (0, depth - kk), value=-1)
    d_s, d_gi = _merge(d_s, to_global(d_i, offset), depth, shard_axis, num_shards, mesh)

    avg_len = live_avg_len_sharded(doc_len, valid, mesh, shard_axis)
    s_s, s_i = sparse_topk_kernel(idx_t, tf_t, doc_len, df, n_docs, q_idx, q_tf, k_cand,
                                  valid, avg_len, scoring=scoring)
    s_s, s_gi = _merge(s_s, to_global(s_i, offset), k_cand, shard_axis, num_shards, mesh)

    fused_s, fused_i, counts = rrf_fuse(torch.stack([d_gi[:, :k_cand], s_gi]),
                                        weights[:2], rrf_k=rrf_k, k_out=k_cand)
    if use_mmr:
        # the [Q, k_cand, D] pool: each rank decodes the rows it owns
        local = fused_i.long() - offset
        own = (local >= 0) & (local < local_n) & (fused_i >= 0)
        safe = torch.clamp(local, 0, local_n - 1)
        if dense_impl in ("pq", "ivfpq"):
            from ..ops.pq import PQCodebook, pq_decode

            ce = pq_decode(PQCodebook(pq_codebooks, pq_m, pq_bits), emb[safe])
        else:
            ce = emb[safe].float()
            if emb_scale is not None:
                ce = ce * emb_scale[safe][..., None]
        ce = all_reduce_sum(torch.where(own[..., None], ce, 0.0), mesh, shard_axis)
        pos = mmr_select(ce, fused_s, k_out, mmr_lambda, fused_i >= 0)
        sel_ok = pos >= 0
        sp = torch.clamp(pos, min=0).long()
        out_i = torch.where(sel_ok, torch.gather(fused_i, 1, sp), -1)
        out_s = torch.where(sel_ok, torch.gather(fused_s, 1, sp), NEG_INF)
        out_c = torch.where(sel_ok, torch.gather(counts, 1, sp), 0)
    else:
        out_i, out_s, out_c = fused_i[:, :k_out], fused_s[:, :k_out], counts[:, :k_out]
    if dense_depth > k_cand:
        return out_i, out_s, out_c, d_gi, d_s
    return out_i, out_s, out_c


__all__ = ["sharded_hybrid_retrieve"]
