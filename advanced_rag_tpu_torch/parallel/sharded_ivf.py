"""Sharded partitioned ANN, per-shard IVF / IVF-PQ over the mesh: the port
of ``advanced_rag_tpu/parallel/sharded_ivf.py``.

- **Build**: each rank trains its OWN coarse quantizer over its rows (no
  global k-means sync) with the port's ``ops/ivf.py:build_ivf`` /
  ``ops/ivfpq.py:build_ivfpq``; ``nlist`` defaults to
  ``auto_nlist(local_n)``.  The JAX package pads every shard's structure
  to the largest capacity and tail, since ``shard_map`` needs one static
  shape; separate processes need no common shape, so a rank keeps its own.
  The answers are the same: pad slots carry row id -1 and score nothing.
- **Search**: each rank probes its partitions (K5 through ``ivf_topk``,
  K6 through ``ivfpq_topk``), turns local rows into global ids and
  merges the top-k over the ``shard`` axis (``parallel/topk.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike
from ..ops.ivf import IVFPartitions, auto_nlist, build_ivf, ivf_topk
from ..ops.ivfpq import IVFPQIndex, build_ivfpq, ivfpq_topk
from .mesh import Mesh
from .sharded_search import _merge, to_global


def build_sharded_ivf(
    emb_host: np.ndarray,      # [local_n, D] f32 this rank's rows (normalized)
    mesh: Mesh,
    *,
    nlist: int = 0,
    dtype: str = "bfloat16",
    shard_axis: str = "shard",
    device: DeviceLike = None,
    **build_kw,
) -> IVFPartitions:
    """This rank's IVF partitions over its rows, on ``device`` (the card
    unless ``"cpu"``); row ids are local."""
    del mesh, shard_axis   # every rank builds over its own rows alone
    nlist = nlist or auto_nlist(emb_host.shape[0])
    return build_ivf(emb_host, nlist, dtype=dtype, device=device, **build_kw)


def build_sharded_ivfpq(
    emb_host: np.ndarray,      # [local_n, D] f32 this rank's rows (normalized)
    mesh: Mesh,
    *,
    nlist: int = 0,
    m: int = 0,
    bits: int = 4,
    shard_axis: str = "shard",
    device: DeviceLike = None,
    **build_kw,
) -> IVFPQIndex:
    """This rank's residual IVF-PQ index over its rows, on ``device``."""
    del mesh, shard_axis
    nlist = nlist or auto_nlist(emb_host.shape[0])
    return build_ivfpq(emb_host, nlist, m=m, bits=bits, device=device, **build_kw)


def _check_valid(valid, name):
    if valid is None:
        raise ValueError(f"{name} requires the rank's valid mask (it also carries "
                         "the per-shard row count for id translation)")


def sharded_ivf_topk(
    parts: IVFPartitions,                 # this rank's partitions
    queries: torch.Tensor,                # [Q, D] whole, normalized
    k: int,
    valid: Optional[torch.Tensor] = None,  # [local_n] the rank's rows
    *,
    mesh: Mesh,
    nprobe: int = 32,
    shard_axis: str = "shard",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [Q, k], GLOBAL row ids [Q, k]), the same on every rank."""
    _check_valid(valid, "sharded_ivf_topk")
    s, i = ivf_topk(parts, queries, k, valid, nprobe=nprobe)
    gi = to_global(i, mesh.index(shard_axis) * valid.shape[0])
    return _merge(s, gi, k, shard_axis, mesh.shape[shard_axis], mesh)


def sharded_ivfpq_topk(
    idx: IVFPQIndex,                      # this rank's index
    queries: torch.Tensor,                # [Q, D] whole, normalized
    k: int,
    valid: Optional[torch.Tensor] = None,  # [local_n] the rank's rows
    *,
    mesh: Mesh,
    nprobe: int = 32,
    m: int,
    bits: int,
    shard_axis: str = "shard",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [Q, k], GLOBAL row ids [Q, k]), the same on every rank."""
    _check_valid(valid, "sharded_ivfpq_topk")
    s, i = ivfpq_topk(idx, queries, k, valid, nprobe=nprobe, m=m, bits=bits)
    gi = to_global(i, mesh.index(shard_axis) * valid.shape[0])
    return _merge(s, gi, k, shard_axis, mesh.shape[shard_axis], mesh)


__all__ = [
    "build_sharded_ivf",
    "build_sharded_ivfpq",
    "sharded_ivf_topk",
    "sharded_ivfpq_topk",
]
