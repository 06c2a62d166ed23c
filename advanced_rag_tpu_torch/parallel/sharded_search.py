"""Sharded exact search: the port of ``advanced_rag_tpu/parallel/sharded_search.py``.

The corpus lives row-sharded over the mesh's ``shard`` axis: every rank
holds its rows as ordinary tensors on its device and calls the same
function.  Each shard scores its rows through the port's kernel wrappers
(K1 / K2 for dense rows, K3 / K3-ip over the shard's [P, local_n] slot
mirror), turns local rows into global ids by adding ``index * local_n``
(JAX's ``lax.axis_index(shard) * local_n``), and merges the top-k over the
axis (``parallel/topk.py``).

Queries that JAX shards over ``data`` are the rank's own slice here: each
``data`` coordinate's shard group merges its own queries, and a rank
returns the results of the queries it passed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..ops.dense import l2_normalize
from ..ops.dense_kernels import dense_topk_kernel, dense_topk_sq8_kernel
from ..ops.sparse_kernels import sparse_topk_kernel
from .comm import all_reduce_sum
from .mesh import Mesh, corpus_sharding
from .topk import gather_merge_topk, tree_merge_topk

#: From this many shard-axis ranks on, the log-tree merge beats the one-shot
#: all-gather (the payload S * k grows past what one collective carries well).
TREE_MERGE_MIN_SHARDS = 32


def _merge(scores, ids, k, axis_name, num_shards, mesh):
    if num_shards >= TREE_MERGE_MIN_SHARDS and not (num_shards & (num_shards - 1)):
        return tree_merge_topk(scores, ids, k, axis_name, num_shards, mesh=mesh)
    return gather_merge_topk(scores, ids, k, axis_name, mesh=mesh)


def to_global(ids: torch.Tensor, offset: int) -> torch.Tensor:
    """Local row ids -> global ids (-1 stays -1)."""
    return torch.where(ids >= 0, ids + offset, -1)


def live_avg_len_sharded(doc_len: torch.Tensor, valid: Optional[torch.Tensor],
                         mesh: Mesh, axis: str) -> torch.Tensor:
    """BM25's mean live document length over the whole corpus: one
    ``all_reduce`` (sum) of the shard's live length sum and live count."""
    v = (valid.to(torch.float32) if valid is not None
         else torch.ones_like(doc_len, dtype=torch.float32))
    part = torch.stack([torch.sum(doc_len.float() * v), torch.sum(v)])
    tot = all_reduce_sum(part, mesh, axis)
    return tot[0] / torch.clamp(tot[1], min=1.0)


def sharded_dense_topk(
    emb: torch.Tensor,        # [local_n, D] this rank's rows
    queries: torch.Tensor,    # [Q, D] this rank's queries (its slice over `data`)
    k: int,
    valid: Optional[torch.Tensor] = None,      # [local_n] bool
    emb_scale: Optional[torch.Tensor] = None,  # [local_n] f32 (SQ8)
    *,
    mesh: Mesh,
    metric: str = "ip",
    normalize_queries: bool = False,
    shard_axis: str = "shard",
    data_axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked dense top-k over a sharded corpus.

    Returns ``(scores [Q, k], global_ids [Q, k])``, the same on every rank
    of the shard group.  Global ids are row positions in the unsharded
    [N, D] layout; masked or absent -> (NEG_INF, -1), the contract of
    ``ops.dense.dense_topk``.  SQ8: int8 ``emb`` and the rank's
    ``emb_scale`` score through K2; float rows through K1.  ``data_axis``
    names the axis the queries are split over (they arrive split).
    """
    num_shards = mesh.shape[shard_axis]
    local_n = emb.shape[0]
    q = queries.float()
    if normalize_queries:
        q = l2_normalize(q)
    if emb_scale is not None:
        s, i = dense_topk_sq8_kernel(emb, emb_scale, q, k, valid, metric="ip",
                                     normalize_queries=False)
    else:
        s, i = dense_topk_kernel(emb, q, k, valid, metric=metric,
                                 normalize_queries=False)
    gids = to_global(i, mesh.index(shard_axis) * local_n)
    return _merge(s, gids, k, shard_axis, num_shards, mesh)


def sharded_sparse_topk(
    idx_t: torch.Tensor,     # [P, local_n] i32 this rank's slot mirror
    tf_t: torch.Tensor,      # [P, local_n] bf16
    doc_len: torch.Tensor,   # [local_n] f32
    df: torch.Tensor,        # [V] the GLOBAL document frequencies (whole)
    n_docs: torch.Tensor,    # scalar: the global live corpus size
    q_idx: torch.Tensor,     # [Q, T] this rank's queries
    q_tf: torch.Tensor,      # [Q, T]
    k: int,
    valid: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
    scoring: str = "bm25",
    k1: float = 1.2,
    b: float = 0.75,
    shard_axis: str = "shard",
    data_axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded BM25 / ip top-k through K3 (K3-ip for ``scoring="ip"``).

    Scores are those of the unsharded program: idf uses the global
    ``df`` / ``n_docs`` and the mean document length is summed over the
    shards before the weighting."""
    num_shards = mesh.shape[shard_axis]
    local_n = idx_t.shape[1]
    avg_len = live_avg_len_sharded(doc_len, valid, mesh, shard_axis)
    s, i = sparse_topk_kernel(idx_t, tf_t, doc_len, df, n_docs, q_idx, q_tf, k,
                              valid, avg_len, scoring=scoring, k1=k1, b=b)
    gids = to_global(i, mesh.index(shard_axis) * local_n)
    return _merge(s, gids, k, shard_axis, num_shards, mesh)


def shard_corpus_arrays(mesh: Mesh, *arrays, shard_axis: str = "shard",
                        device: DeviceLike = None):
    """This rank's rows of row-aligned global corpus arrays (numpy or
    tensors; pad first with ``parallel.mesh.pad_to_shards``, padded rows
    invalid), as tensors on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    out = []
    for arr in arrays:
        rows = arr[corpus_sharding(mesh, arr.shape[0], shard_axis)]
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.ascontiguousarray(rows))
        out.append(rows.to(dev).contiguous())
    return tuple(out) if len(out) > 1 else out[0]


__all__ = [
    "sharded_dense_topk",
    "sharded_sparse_topk",
    "shard_corpus_arrays",
    "live_avg_len_sharded",
    "TREE_MERGE_MIN_SHARDS",
]
