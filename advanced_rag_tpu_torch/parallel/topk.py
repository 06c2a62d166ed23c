"""Cross-shard top-k reduction: the port of ``advanced_rag_tpu/parallel/topk.py``.

Each shard computes a local masked top-k; then ONLY k (score, id) pairs
per query cross between ranks, never raw scores or embeddings.  Both
merges are called by every rank of the axis with its own [Q, k] candidates
(global ids, -1 pad) and return the same global top-k on every rank:

- ``gather_merge_topk``: one all-gather of the [Q, k] candidates, then the
  top-k of the [Q, S * k] union (``topk_first``: ties to the lower index,
  as ``lax.top_k``), -1 where the score is NEG_INF;
- ``tree_merge_topk``: log2(S) butterfly rounds, each an exchange with the
  partner ``coordinate ^ step`` and a ``merge_topk``, keeping the payload
  at k per link.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.dense import NEG_INF, merge_topk, topk_first
from .comm import all_gather, exchange
from .mesh import Mesh


def gather_merge_topk(
    scores: torch.Tensor,   # [Q, k] local top-k scores
    ids: torch.Tensor,      # [Q, k] local top-k GLOBAL ids (-1 pad)
    k: int,
    axis_name: str = "shard",
    *,
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather merge; every rank of ``axis_name`` gets the result."""
    q = scores.shape[0]
    all_s = all_gather(scores, mesh, axis_name).transpose(0, 1).reshape(q, -1)
    all_i = all_gather(ids, mesh, axis_name).transpose(0, 1).reshape(q, -1)
    top_s, sel = topk_first(all_s, k)
    top_i = torch.gather(all_i, 1, sel)
    return top_s, torch.where(top_s <= NEG_INF, -1, top_i)


def tree_merge_topk(
    scores: torch.Tensor,
    ids: torch.Tensor,
    k: int,
    axis_name: str,
    num_shards: int,
    *,
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recursive-halving merge: log2(S) exchange rounds, payload k a link.

    ``num_shards`` must be a power of two.  After the last round every rank
    holds the identical global top-k, the contract of ``gather_merge_topk``.
    """
    if num_shards & (num_shards - 1):
        raise ValueError("tree_merge_topk requires a power-of-two shard axis")
    me = mesh.index(axis_name)
    s, i = scores, ids
    step = 1
    while step < num_shards:
        peer = me ^ step
        peer_s = exchange(s, mesh, axis_name, peer)
        peer_i = exchange(i, mesh, axis_name, peer)
        # the lower coordinate's list first, so that ties break alike on
        # both ends of the exchange
        if peer < me:
            s, i, peer_s, peer_i = peer_s, peer_i, s, i
        s, i = merge_topk(s, i, peer_s, peer_i, k)
        step *= 2
    return s, i


__all__ = ["gather_merge_topk", "tree_merge_topk"]
