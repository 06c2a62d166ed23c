"""Device-resident retrieve: embed -> hybrid -> rerank, the port of
``advanced_rag_tpu/ops/e2e.py``.

    query tokens ──BiEncoder──> q_dense ──hybrid_retrieve──> cand ids
        │                                        │ (device gather)
        └──────────[CLS] q [SEP] doc [SEP] pair build [Q*K, L]
                                  │
                          CrossEncoder ──> top-k_final re-ranked rows

The corpus token table lives on the device next to the index, so the
cross-encoder gathers its candidate documents on the device from the
hybrid search's output; the host sees only the final (ids, scores).

Pair layout: slots are static — [CLS] q-tokens[Lq] [SEP] doc-tokens[Ld]
[SEP] — so a short query leaves masked PAD holes before the doc tokens
instead of shifting them left.  Attention masks hide the holes; position
embeddings see them, and the layout is the one the checkpoints were
trained with, so the port keeps it exactly.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .dense import topk_first
from .hybrid import hybrid_retrieve
from .rescore import (exact_tier_scores, exact_tier_scores_postings, zmix_base,
                      znorm)


class E2EResult(NamedTuple):
    ids: torch.Tensor            # [Q, k_final] i32 reranked rows (-1 pad)
    ce_scores: torch.Tensor      # [Q, k_final] f32 cross-encoder scores
    fused_scores: torch.Tensor   # [Q, k_final] f32 hybrid RRF scores
    cand_ids: torch.Tensor       # [Q, k_rerank] pre-rerank candidates
    cand_scores: torch.Tensor    # [Q, k_rerank]
    q_dense: torch.Tensor        # [Q, D] query embedding


def make_retrieve_rerank(
    bi_model: Any,
    ce_model: Any,
    *,
    k_cand: int = 40,
    k_out: int = 24,
    k_rerank: int = 16,
    k_final: int = 8,
    pad_id: int = 0,
    sep_id: int = 2,
    metric: str = "ip",
    dense_impl: str = "scan",
    sparse_impl: str = "kernel",
    use_mmr: bool = True,
    rrf_k: int = 60,
    rerank_mode: str = "zblend",
    rerank_base: str = "fused",
    doc_dedupe: bool = False,
    **hybrid_static: Any,
) -> Callable[..., E2EResult]:
    """Build the retrieve + rerank program (a plain function; PyTorch runs
    eagerly, so there is nothing to compile).

    ``bi_model``/``ce_model`` are the port's ``BiEncoder``/``CrossEncoder``
    modules.  Returns ``program(q_ids, q_mask, q_sp_idx, q_sp_tf,
    doc_tokens, emb, doc_idx, doc_tf, idx_t, tf_t, doc_len, df, n_docs,
    valid, weights, mmr_lambda, ...) -> E2EResult``.

    ``doc_dedupe=True`` makes the rerank slate doc-distinct: the hybrid
    search over-retrieves a k_out-deep chunk pool and the slate keeps the
    best-ranked chunk per distinct parent document (matched on the
    corpus's ``doc_hash_lo/hi`` device columns).

    ``sparse_impl="postings"`` serves BM25 from the inverted postings
    (``post_rows``/``post_tf``/``post_tfw``); ``rerank_base="exact_postings"``
    then rescores the candidates' BM25 from them too.
    """
    if k_rerank > k_out:
        raise ValueError(f"k_rerank ({k_rerank}) must be <= k_out ({k_out})")
    if k_final > k_rerank:
        raise ValueError(f"k_final ({k_final}) must be <= k_rerank ({k_rerank})")
    if rerank_base == "exact_postings" and sparse_impl != "postings":
        raise ValueError('rerank_base="exact_postings" requires '
                         'sparse_impl="postings"')
    if rerank_base not in ("fused", "exact", "exact_postings"):
        raise ValueError(f"unknown rerank_base: {rerank_base}")
    if rerank_mode not in ("zblend", "residual"):
        raise ValueError(f"unknown rerank_mode: {rerank_mode}")

    @torch.inference_mode()
    def program(
        q_ids: torch.Tensor,        # [Q, Lq] i64/i32 ([CLS] q [SEP] framed)
        q_mask: torch.Tensor,       # [Q, Lq] f32
        q_sp_idx: torch.Tensor,     # [Q, T] i32 sparse query terms
        q_sp_tf: torch.Tensor,      # [Q, T] f32
        doc_tokens: torch.Tensor,   # [N, Ld] token table on the device
        emb: torch.Tensor,
        doc_idx: torch.Tensor,      # [N, P] doc-major (exact rescore)
        doc_tf: torch.Tensor,
        idx_t: torch.Tensor,        # [P, N] slot-major mirror (kernel K3)
        tf_t: torch.Tensor,
        doc_len: torch.Tensor,
        df: torch.Tensor,
        n_docs: torch.Tensor,
        valid: Optional[torch.Tensor],
        weights: torch.Tensor,
        mmr_lambda: torch.Tensor,
        post_rows: Optional[torch.Tensor] = None,  # [V, L] inverted postings
        post_tf: Optional[torch.Tensor] = None,
        post_tfw: Optional[torch.Tensor] = None,
        emb_scale: Optional[torch.Tensor] = None,
        rerank_alpha: Optional[torch.Tensor] = None,
        rescore_mix: Optional[torch.Tensor] = None,
        doc_lo: Optional[torch.Tensor] = None,    # [N] i32 doc-hash cols
        doc_hi: Optional[torch.Tensor] = None,    # (required w/ doc_dedupe)
    ) -> E2EResult:
        # 1. query embedding
        q_dense = bi_model(q_ids, q_mask)                       # [Q, D] f32

        # 2. fused hybrid search
        res = hybrid_retrieve(
            emb, idx_t, tf_t, doc_len, df, n_docs,
            q_dense, q_sp_idx, q_sp_tf, valid, weights, mmr_lambda,
            emb_scale=emb_scale, post_rows=post_rows, post_tf=post_tf,
            post_tfw=post_tfw, k_cand=k_cand, k_out=k_out, metric=metric,
            dense_impl=dense_impl, sparse_impl=sparse_impl, use_mmr=use_mmr,
            rrf_k=rrf_k,
            **hybrid_static,
        )
        if doc_dedupe:
            if doc_lo is None or doc_hi is None:
                raise ValueError(
                    "doc_dedupe=True requires the doc_lo/doc_hi corpus "
                    "hash columns")
            # best-ranked chunk per distinct doc, in rank order, over the
            # full k_out pool (a K0^2 compare, K0 <= a few hundred)
            pool = res.ids                                      # [Q, K0]
            k0 = pool.shape[1]
            pvalid = pool >= 0
            psafe = torch.clamp(pool, min=0).long()
            plo, phi = doc_lo[psafe], doc_hi[psafe]             # [Q, K0]
            same = ((plo[:, :, None] == plo[:, None, :])
                    & (phi[:, :, None] == phi[:, None, :])
                    & pvalid[:, None, :])                       # [Q, K0, K0]
            earlier = torch.tril(torch.ones((k0, k0), dtype=torch.bool,
                                            device=pool.device), diagonal=-1)
            is_dup = torch.any(same & earlier[None], dim=-1)
            keep = pvalid & ~is_dup
            ranks = torch.arange(k0, device=pool.device)[None, :]
            penalty = torch.where(keep, ranks, k0 + ranks)
            # smallest penalties first == keepers in original rank order
            _, sel = topk_first(-penalty.float(), k_rerank)
            cand = torch.gather(pool, 1, sel)
            cand_s = torch.gather(res.scores, 1, sel)
            cand = torch.where(torch.gather(keep, 1, sel), cand, -1)
        else:
            cand = res.ids[:, :k_rerank]                        # [Q, K]
            cand_s = res.scores[:, :k_rerank]

        # 3. device-side candidate document gather
        safe = torch.clamp(cand, min=0).long()
        dtok = doc_tokens[safe].long()                          # [Q, K, Ld]

        # 4. static-slot pair build: [CLS] q [SEP] framed in q_ids; append
        #    the doc tokens and a trailing [SEP]
        nq, lq = q_ids.shape
        k = cand.shape[1]
        ld = dtok.shape[-1]
        dev = q_ids.device
        qi = q_ids.long()[:, None, :].expand(nq, k, lq)
        qm = q_mask.float()[:, None, :].expand(nq, k, lq)
        dmask = (dtok != pad_id).float()
        sep = torch.full((nq, k, 1), sep_id, dtype=torch.long, device=dev)
        pair_ids = torch.cat([qi, dtok, sep], dim=-1)           # [Q, K, L]
        pair_mask = torch.cat(
            [qm, dmask, torch.ones((nq, k, 1), device=dev)], dim=-1)
        pair_seg = torch.cat(
            [torch.zeros((nq, k, lq), dtype=torch.long, device=dev),
             torch.ones((nq, k, ld + 1), dtype=torch.long, device=dev)],
            dim=-1)
        seq = lq + ld + 1

        # 5. cross-encoder over all (query, candidate) pairs in one pass
        ce = ce_model(pair_ids.reshape(nq * k, seq),
                      pair_mask.reshape(nq * k, seq),
                      pair_seg.reshape(nq * k, seq)).reshape(nq, k)
        validm = cand >= 0
        ce = torch.where(validm, ce, float("-inf"))

        # 6. final rank: "zblend" alpha*z(ce) + (1-alpha)*base, or
        #    "residual" base + alpha*ce; base is z(fused RRF score) or the
        #    exact per-tier rescore blend (ops/rescore.py)
        if rerank_alpha is None:
            rank_key = ce
        else:
            if rerank_base == "fused":
                base = znorm(cand_s, validm)
            else:
                # BM25 from the doc-major table ("exact") or the postings
                rescore, sp_a, sp_b = (
                    (exact_tier_scores_postings, post_rows, post_tf)
                    if rerank_base == "exact_postings"
                    else (exact_tier_scores, doc_idx, doc_tf))
                d_ex, s_ex = rescore(cand, q_dense, q_sp_idx, q_sp_tf, emb,
                                     sp_a, sp_b, doc_len, df, n_docs,
                                     valid=valid, emb_scale=emb_scale)
                base = zmix_base(d_ex, s_ex, validm,
                                 0.5 if rescore_mix is None else rescore_mix)
            if rerank_mode == "residual":
                rank_key = base + rerank_alpha * torch.where(validm, ce, 0.0)
            else:
                rank_key = (rerank_alpha * znorm(ce, validm)
                            + (1.0 - rerank_alpha) * base)
            rank_key = torch.where(validm, rank_key, float("-inf"))
        top_s, top_j = topk_first(rank_key, k_final)
        final_ids = torch.gather(cand, 1, top_j)
        final_ce = torch.gather(ce, 1, top_j)
        final_fused = torch.gather(cand_s, 1, top_j)
        final_ids = torch.where(torch.isfinite(top_s), final_ids, -1)

        return E2EResult(final_ids, final_ce, final_fused, cand, cand_s,
                         q_dense)

    return program


__all__ = ["make_retrieve_rerank", "E2EResult"]
