"""Rank fusion and diversification on the device: the port of
``advanced_rag_tpu/ops/fusion.py``.

Weighted reciprocal-rank fusion with dedup (RRF k=60, weights dense 0.7 /
sparse 0.3), MMR diversification on embedding cosine, and the exponential
recency factor ``recency_boost``.  Shapes are
static: every method contributes exactly K candidates (padded with id -1),
and both functions are batched over queries.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .dense import NEG_INF, l2_normalize, topk_first


def rrf_fuse(
    ids: torch.Tensor,       # [M, Q, K] i32 per-method candidate ids (-1 pad)
    weights: torch.Tensor,   # [M] f32 per-method weights
    *,
    rrf_k: int = 60,
    k_out: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted reciprocal-rank fusion with dedup, batched over queries.

    Returns ``(fused_scores [Q, k_out], fused_ids [Q, k_out],
    method_counts [Q, k_out])`` with scores ``sum_m w_m / (rrf_k + rank_m + 1)``.
    """
    m, nq, k = ids.shape
    flat = ids.permute(1, 0, 2).reshape(nq, m * k)                  # [Q, MK]
    dev = ids.device
    ranks = torch.arange(k, device=dev, dtype=torch.float32).repeat(m)
    w = torch.repeat_interleave(weights.float()[:m], k)
    contrib = w / (float(rrf_k) + ranks + 1.0)                      # [MK]
    valid = flat >= 0
    contrib = torch.where(valid, contrib[None, :], 0.0)             # [Q, MK]

    eq = ((flat[:, :, None] == flat[:, None, :])
          & valid[:, :, None] & valid[:, None, :])                  # [Q, MK, MK]
    fused = torch.sum(torch.where(eq, contrib[:, None, :], 0.0), dim=2)
    counts = torch.sum(eq, dim=2)

    pos = torch.arange(m * k, device=dev)
    earlier = eq & (pos[None, None, :] < pos[None, :, None])
    first = ~torch.any(earlier, dim=2) & valid

    masked = torch.where(first, fused, NEG_INF)
    top_s, sel = topk_first(masked, k_out)
    dead = top_s <= NEG_INF
    top_i = torch.where(dead, -1, torch.gather(flat, 1, sel)).to(torch.int32)
    top_c = torch.where(dead, 0, torch.gather(counts, 1, sel)).to(torch.int32)
    top_s = torch.where(dead, NEG_INF, top_s)
    return top_s, top_i, top_c


def mmr_select(
    cand_emb: torch.Tensor,   # [Q, C, D] (or [C, D]) candidate embeddings
    rel: torch.Tensor,        # [Q, C] (or [C]) relevance scores (fused)
    k: int,
    lambda_mult: Union[float, torch.Tensor] = 0.8,
    valid: Optional[torch.Tensor] = None,   # [Q, C] (or [C]) bool
    *,
    normalize: bool = True,
) -> torch.Tensor:
    """Greedy maximal-marginal-relevance selection on embedding cosine.

    ``mmr_i = lambda * rel_i - (1 - lambda) * max_{j in S} sim(i, j)`` with
    ``rel`` min-max scaled to [0, 1] over the valid candidates.  Returns the
    selected candidate positions ``[Q, k] i32`` (``[k]`` for unbatched
    input) in pick order, -1 where fewer than k are valid.
    """
    single = cand_emb.dim() == 2
    if single:
        cand_emb, rel = cand_emb[None], rel[None]
        valid = valid[None] if valid is not None else None
    nq, c, _ = cand_emb.shape
    dev = cand_emb.device
    e = l2_normalize(cand_emb) if normalize else cand_emb.float()
    sim = e @ e.transpose(1, 2)                                     # [Q, C, C]
    ok = (valid.to(torch.bool) if valid is not None
          else torch.ones((nq, c), dtype=torch.bool, device=dev))
    relf = rel.float()
    lo = torch.amin(torch.where(ok, relf, float("inf")), dim=1, keepdim=True)
    hi = torch.amax(torch.where(ok, relf, float("-inf")), dim=1, keepdim=True)
    rel01 = (relf - lo) / torch.clamp(hi - lo, min=1e-12)
    relm = torch.where(ok, rel01, NEG_INF)

    lam = torch.as_tensor(lambda_mult, dtype=torch.float32, device=dev)
    selected = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    max_sim = torch.zeros((nq, c), dtype=torch.float32, device=dev)
    avail = ok.clone()
    iota = torch.arange(c, device=dev)
    rows = torch.arange(nq, device=dev)
    for i in range(k):
        mmr = lam * relm - (1.0 - lam) * max_sim
        mmr = torch.where(avail, mmr, NEG_INF)
        best, pick = torch.max(mmr, dim=1)      # first index among equals
        has_any = best > NEG_INF
        pick = torch.where(has_any, pick, -1)
        selected[:, i] = pick.to(torch.int32)
        safe = torch.clamp(pick, min=0)
        max_sim = torch.where(has_any[:, None],
                              torch.maximum(max_sim, sim[rows, :, safe]),
                              max_sim)
        avail = avail & (iota[None, :] != pick[:, None])
    return selected[0] if single else selected


def recency_boost(
    timestamps: torch.Tensor,               # [K] seconds since the epoch
    now: Union[torch.Tensor, float],        # scalar seconds
    half_life_days: Union[torch.Tensor, float],  # scalar days
) -> torch.Tensor:
    """Exponential recency factor in [0, 1], ``2^(-age_days / half_life)``,
    in f32 as the JAX function computes it (a timestamp near 1.7e9 s is
    then exact to 128 s)."""
    ts = torch.as_tensor(timestamps).to(torch.float32)
    now = torch.as_tensor(now, dtype=torch.float32, device=ts.device)
    half = torch.as_tensor(half_life_days, dtype=torch.float32, device=ts.device)
    age_days = torch.clamp(now - ts, min=0.0) / 86400.0
    return torch.exp2(-age_days / torch.clamp(half, min=1e-6))


__all__ = ["rrf_fuse", "mmr_select", "recency_boost"]
