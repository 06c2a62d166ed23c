"""Dense scoring and masked top-k: the port of ``advanced_rag_tpu/ops/dense.py``.

The corpus is a packed ``emb[N, D]`` tensor on the device (bf16 by
default).  ``dense_topk`` here is the plain PyTorch version of the exact
masked search (the JAX "scan" rung); the serving path scores through the
hand-written kernel of ``ops/dense_kernels.py`` instead.

Conventions shared by every search op of the port: masked or absent rows
score ``<= NEG_INF`` and carry id ``-1``; ``topk_first`` breaks ties toward
the lower index, as ``lax.top_k`` does, so the port returns the same ids as
the JAX package on the same scores.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: Sentinel for masked-out scores.  Finite (not -inf) so that downstream
#: arithmetic never produces NaN.
NEG_INF = -1e30


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12, dim: int = -1) -> torch.Tensor:
    """Row-normalize in f32 (safe for zero rows)."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return x32 / torch.clamp(norm, min=eps)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort like ``x`` (f32) and then by lower index."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    n = x.shape[-1]
    rev = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    return key * (1 << 32) + rev


def topk_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, largest first, ties to the lower index.

    The same (values, indices) as ``lax.top_k``: ``torch.topk`` promises no
    order among equal values, so the f32 values are mapped to int64 keys
    that order by value and then by index, which makes every key distinct.
    """
    if k > x.shape[-1]:
        raise ValueError(f"k ({k}) exceeds the axis length ({x.shape[-1]})")
    _, idx = torch.topk(_order_key(x), k, dim=-1)
    return torch.gather(x, -1, idx), idx


def merge_topk(top_s: torch.Tensor, top_i: torch.Tensor,
               blk_s: torch.Tensor, blk_i: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold candidate (scores, ids) into the running top-k along axis 1."""
    cat_s = torch.cat([top_s, blk_s], dim=1)
    cat_i = torch.cat([top_i, blk_i], dim=1)
    new_s, sel = topk_first(cat_s, k)
    return new_s, torch.gather(cat_i, 1, sel)


def mask_additive(valid: Optional[torch.Tensor], n: int,
                  device: torch.device) -> torch.Tensor:
    """[N] f32 additive row mask: 0 for live rows, NEG_INF for dead ones."""
    if valid is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    v = valid[:n].to(torch.bool)
    return torch.where(v, 0.0, NEG_INF).to(torch.float32)


def reduce_topk(scores: torch.Tensor, n: int,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a [Q, N] score matrix that carries the additive mask.

    ``k > N`` pads with absent slots (score NEG_INF, id -1), as the JAX
    scan does; ids of masked rows become -1.
    """
    if k > scores.shape[1]:
        scores = torch.nn.functional.pad(scores, (0, k - scores.shape[1]),
                                         value=NEG_INF)
    top_s, top_i = topk_first(scores, k)
    top_i = top_i.to(torch.int32)
    top_i = torch.where((top_s <= NEG_INF) | (top_i >= n), -1, top_i)
    return top_s, top_i


def block_scores(e: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """Similarity of corpus rows against the query batch -> [Q, B] f32."""
    if metric == "cosine":
        return q @ l2_normalize(e).T
    if metric == "ip":
        return q @ e.float().T
    if metric == "l2":
        e32 = e.float()
        qe = q @ e32.T
        e_sq = torch.sum(e32 * e32, dim=-1)
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        return 2.0 * qe - e_sq[None, :] - q_sq
    raise ValueError(f"unknown metric: {metric}")


def dense_topk(
    emb: torch.Tensor,                    # [N, D] corpus (any float dtype)
    queries: torch.Tensor,                # [Q, D]
    k: int,
    valid: Optional[torch.Tensor] = None,  # [N] bool; False rows excluded
    *,
    metric: str = "cosine",
    normalize_queries: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k similarity search (plain PyTorch).

    Returns ``(scores [Q, k] f32, ids [Q, k] i32)``; masked or absent rows
    surface as score ``<= NEG_INF`` and id ``-1``.  The counterpart of
    ``advanced_rag_tpu.ops.dense.dense_topk``; this version scores the whole
    corpus at once instead of in blocks, which the result does not see.
    """
    n = emb.shape[0]
    if n == 0:
        raise ValueError("dense_topk: empty corpus")
    q = queries.float()
    if metric == "cosine" and normalize_queries:
        q = l2_normalize(q)
    s = block_scores(emb, q, metric)
    if valid is not None:
        s = torch.where(valid[None, :n].to(torch.bool), s, NEG_INF)
    return reduce_topk(s, n, k)


__all__ = [
    "NEG_INF",
    "cdiv",
    "l2_normalize",
    "topk_first",
    "merge_topk",
    "mask_additive",
    "reduce_topk",
    "block_scores",
    "dense_topk",
]
