"""Sharded retrieve + rerank: the port of ``advanced_rag_tpu/parallel/sharded_e2e.py``.

The program of ``ops/e2e.py`` with the corpus and its token table
row-sharded over the mesh's ``shard`` axis:

1. query embedding: the bi-encoder forward on every rank (small);
2. corpus search: ``sharded_hybrid_retrieve`` (per-shard fused hybrid and
   the top-k merges; only k ids and scores cross between ranks);
3. candidate token gather: one-hot ``all_reduce`` (sum) over the
   row-sharded token table: the rank that owns a row sends its tokens,
   every other rank zeros (Q x K x Ld int32 a hop);
4. rerank, DATA-PARALLEL: the Q * K pairs are padded to a multiple of S,
   each rank scores its slice with the cross-encoder, and an all-gather
   collects the scores.  Search shards by corpus rows, rerank by pairs;
   both ride the one ``shard`` axis, so no weight moves.

As in the port's ``make_retrieve_rerank``, the models carry their own
weights: the program takes no parameter trees.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.dense import topk_first
from ..ops.e2e import E2EResult
from .comm import all_gather, all_reduce_sum
from .mesh import Mesh
from .sharded_hybrid import sharded_hybrid_retrieve


def sharded_token_gather(
    doc_tokens: torch.Tensor,     # [local_n, Ld] the rank's token rows
    cand: torch.Tensor,           # [Q, K] global row ids, whole
    *,
    mesh: Mesh,
    shard_axis: str = "shard",
) -> torch.Tensor:
    """-> [Q, K, Ld] i32 candidate token rows (0 where cand < 0), the same
    on every rank: one shard owns each row, and the sum is the gather."""
    local_n = doc_tokens.shape[0]
    local = cand.long() - mesh.index(shard_axis) * local_n
    ok = (local >= 0) & (local < local_n) & (cand >= 0)
    g = doc_tokens[torch.clamp(local, 0, local_n - 1)].to(torch.int32)
    return all_reduce_sum(torch.where(ok[..., None], g, 0), mesh, shard_axis)


def sharded_ce_scores(
    ce_model: Any,
    pair_ids: torch.Tensor,       # [B, L] whole (B = Q * K)
    pair_mask: torch.Tensor,
    pair_seg: torch.Tensor,
    *,
    mesh: Mesh,
    shard_axis: str = "shard",
) -> torch.Tensor:
    """Data-parallel pair scoring -> [B] f32, the same on every rank."""
    s = mesh.shape[shard_axis]
    b = pair_ids.shape[0]
    pad = (-b) % s
    if pad:
        pair_ids, pair_mask, pair_seg = (F.pad(t, (0, 0, 0, pad))
                                         for t in (pair_ids, pair_mask, pair_seg))
    per = (b + pad) // s
    lo = mesh.index(shard_axis) * per
    mine = ce_model(pair_ids[lo:lo + per], pair_mask[lo:lo + per],
                    pair_seg[lo:lo + per]).float()
    return all_gather(mine, mesh, shard_axis).reshape(-1)[:b]


def make_sharded_retrieve_rerank(
    bi_model: Any,
    ce_model: Any,
    *,
    mesh: Mesh,
    k_cand: int = 40,
    k_out: int = 24,
    k_rerank: int = 16,
    k_final: int = 8,
    pad_id: int = 0,
    sep_id: int = 2,
    metric: str = "ip",
    dense_impl: str = "scan",
    use_mmr: bool = True,
    shard_axis: str = "shard",
    **hybrid_static: Any,
) -> Callable[..., E2EResult]:
    """Build the sharded program (a plain function, as
    ``ops.e2e.make_retrieve_rerank``): ``program(q_ids, q_mask, q_sp_idx,
    q_sp_tf, doc_tokens, emb, idx_t, tf_t, doc_len, df, n_docs, valid,
    weights, mmr_lambda, emb_scale=None) -> E2EResult``, where the corpus
    tensors are the rank's rows and the rest is whole."""
    if k_rerank > k_out or k_final > k_rerank:
        raise ValueError("need k_final <= k_rerank <= k_out")

    @torch.inference_mode()
    def program(
        q_ids: torch.Tensor,
        q_mask: torch.Tensor,
        q_sp_idx: torch.Tensor,
        q_sp_tf: torch.Tensor,
        doc_tokens: torch.Tensor,     # [local_n, Ld]
        emb: torch.Tensor,            # [local_n, D]
        idx_t: torch.Tensor,          # [P, local_n]
        tf_t: torch.Tensor,
        doc_len: torch.Tensor,
        df: torch.Tensor,
        n_docs: torch.Tensor,
        valid: Optional[torch.Tensor],
        weights: torch.Tensor,
        mmr_lambda: torch.Tensor,
        emb_scale: Optional[torch.Tensor] = None,
    ) -> E2EResult:
        q_dense = bi_model(q_ids, q_mask)
        cand_i, cand_s, _ = sharded_hybrid_retrieve(
            emb, idx_t, tf_t, doc_len, df, n_docs, q_dense, q_sp_idx, q_sp_tf,
            valid, weights, mmr_lambda, emb_scale=emb_scale, mesh=mesh,
            k_cand=k_cand, k_out=k_out, metric=metric, dense_impl=dense_impl,
            use_mmr=use_mmr, shard_axis=shard_axis, **hybrid_static)[:3]
        cand = cand_i[:, :k_rerank]
        cand_s = cand_s[:, :k_rerank]
        dtok = sharded_token_gather(doc_tokens, cand, mesh=mesh,
                                    shard_axis=shard_axis).long()   # [Q, K, Ld]

        nq, lq = q_ids.shape
        k = cand.shape[1]
        ld = dtok.shape[-1]
        dev = q_ids.device
        qi = q_ids.long()[:, None, :].expand(nq, k, lq)
        qm = q_mask.float()[:, None, :].expand(nq, k, lq)
        sep = torch.full((nq, k, 1), sep_id, dtype=torch.long, device=dev)
        seq = lq + ld + 1
        pair_ids = torch.cat([qi, dtok, sep], dim=-1).reshape(nq * k, seq)
        pair_mask = torch.cat([qm, (dtok != pad_id).float(),
                               torch.ones((nq, k, 1), device=dev)], dim=-1)
        pair_seg = torch.cat(
            [torch.zeros((nq, k, lq), dtype=torch.long, device=dev),
             torch.ones((nq, k, ld + 1), dtype=torch.long, device=dev)], dim=-1)

        ce = sharded_ce_scores(ce_model, pair_ids, pair_mask.reshape(nq * k, seq),
                               pair_seg.reshape(nq * k, seq), mesh=mesh,
                               shard_axis=shard_axis).reshape(nq, k)
        ce = torch.where(cand >= 0, ce, float("-inf"))
        top_s, top_j = topk_first(ce, k_final)
        final_ids = torch.gather(cand, 1, top_j)
        final_fused = torch.gather(cand_s, 1, top_j)
        final_ids = torch.where(torch.isfinite(top_s), final_ids, -1)
        return E2EResult(final_ids, top_s, final_fused, cand, cand_s, q_dense)

    return program


__all__ = ["make_sharded_retrieve_rerank", "sharded_token_gather", "sharded_ce_scores"]
