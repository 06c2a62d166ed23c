"""Multi-host pod search, a (dcn, shard, data) mesh and the hierarchical
top-k merge: the port of ``advanced_rag_tpu/parallel/multihost.py``.

Between hosts runs a slower interconnect than within one, so the pod mesh
has an explicit ``dcn`` axis (the host) and the merge is hierarchical:
merge within the host over ``shard`` first, then send only the k per-host
survivors across ``dcn``.  A query then crosses hosts with ``hosts * k``
pairs instead of ``ranks * k``.

Launch, one process per rank (each process drives one card):

    JAX_COORDINATOR=host0:1234 NPROC=8 PROC_ID=$i python serve.py
    # inside: advanced_rag_tpu_torch.parallel.distributed_init()
    #         mesh = build_pod_mesh(dcn=2)

The environment is the JAX package's (``scripts/run_multihost.py``), so
one launch line serves both packages.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device
from ..ops.dense import l2_normalize
from ..ops.dense_kernels import dense_topk_kernel
from .mesh import Mesh, init_world, world
from .sharded_search import to_global
from .topk import gather_merge_topk

POD_AXES = ("dcn", "shard", "data")


def distributed_init(device: DeviceLike = None, timeout_s: float = 300.0) -> None:
    """Initialize the default process group from the environment; a no-op
    without ``JAX_COORDINATOR``.

    Env: ``JAX_COORDINATOR`` (host:port), ``NPROC`` and ``PROC_ID``.  NCCL
    when the process runs on the card (it takes card ``PROC_ID`` modulo the
    cards it sees), Gloo for ``device="cpu"``.  Idempotent: a group of
    ``NPROC`` ranks that is already up is kept; one of another size raises.
    """
    coord = os.environ.get("JAX_COORDINATOR")
    if not coord:
        return
    nproc, proc_id = int(os.environ["NPROC"]), int(os.environ["PROC_ID"])
    if dist.is_initialized():
        if dist.get_world_size() != nproc:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is "
                               f"already up, not NPROC={nproc}")
        logging.getLogger(__name__).info("distributed already initialized")
        return
    dev = resolve_device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(proc_id % torch.cuda.device_count())
    init_world(backend, f"tcp://{coord}", proc_id, nproc, timeout_s)


def build_pod_mesh(dcn: int = 0, shard: int = 0, data: int = 1) -> Mesh:
    """The (dcn, shard, data) mesh over the world's ranks.

    Each process is one rank and ranks group on ``dcn`` by process: rank
    ``r`` sits at ``(r // (shard * data), ...)``, so the ranks of one host
    (numbered consecutively, as launchers number them) share a ``dcn``
    coordinate.  ``dcn=0`` means one host; ``shard=0`` takes the rest.
    """
    _, n = world()
    dcn = dcn or 1
    shard = shard or n // (dcn * data)
    if dcn * shard * data != n:
        raise ValueError(f"pod mesh ({dcn}, {shard}, {data}) does not cover {n} ranks")
    return Mesh(np.arange(n).reshape(dcn, shard, data), POD_AXES)


def hierarchical_merge_topk(
    scores: torch.Tensor,   # [Q, k] local top-k
    ids: torch.Tensor,      # [Q, k] local top-k GLOBAL ids
    k: int,
    dcn_axis: str = "dcn",
    ici_axis: str = "shard",
    *,
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge over ``ici_axis`` first, then ``dcn_axis``: only k per-host
    survivors cross hosts.  Every rank of both axes gets the result."""
    s, i = gather_merge_topk(scores, ids, k, ici_axis, mesh=mesh)
    return gather_merge_topk(s, i, k, dcn_axis, mesh=mesh)


def pod_dense_topk(
    emb: torch.Tensor,        # [local_n, D] this rank's rows over (dcn, shard)
    queries: torch.Tensor,    # [Q, D] this rank's queries (its slice over `data`)
    k: int,
    valid: Optional[torch.Tensor] = None,   # [local_n]
    *,
    mesh: Mesh,
    metric: str = "ip",
    normalize_queries: bool = False,
    dcn_axis: str = "dcn",
    shard_axis: str = "shard",
    data_axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked dense top-k (K1) over a pod-sharded corpus: the
    contract of ``sharded_dense_topk``, with rows split over both ``dcn``
    and ``shard`` (host-major) and the merge hierarchical."""
    local_n = emb.shape[0]
    q = queries.float()
    if normalize_queries:
        q = l2_normalize(q)
    s, i = dense_topk_kernel(emb, q, k, valid, metric=metric, normalize_queries=False)
    block = mesh.index(dcn_axis) * mesh.shape[shard_axis] + mesh.index(shard_axis)
    gids = to_global(i, block * local_n)
    return hierarchical_merge_topk(s, gids, k, dcn_axis, shard_axis, mesh=mesh)


__all__ = [
    "POD_AXES",
    "build_pod_mesh",
    "distributed_init",
    "hierarchical_merge_topk",
    "pod_dense_topk",
]
