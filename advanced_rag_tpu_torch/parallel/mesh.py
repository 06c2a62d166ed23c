"""The mesh of ranks for sharded search and training: the port of
``advanced_rag_tpu/parallel/mesh.py``.

Under ``shard_map`` a JAX function sees the global array and XLA inserts
the collectives.  The port runs SPMD with explicit ranks instead: every
rank of the initialized default process group (one process per rank)
calls the same function with its own shard, as ordinary tensors on its
device.  Two axes, as in JAX:

- ``shard``: the corpus axis; a rank holds the rows ``[c * local_n,
  (c + 1) * local_n)`` where ``c`` is its coordinate on the axis, and the
  per-shard top-k results are merged over the axis's group;
- ``data``: the query / batch axis (the trainer's data-parallel axis).

``Mesh`` is a small class of its own rather than
``torch.distributed.device_mesh.DeviceMesh``: the search runs several ranks
on one card over Gloo, a mesh of one rank needs no process group at all,
and what the programs need is only this contract: the axis sizes
(``mesh.shape[axis]``, as JAX reads them), the rank's coordinate on each
axis (``mesh.index(axis)``, JAX's ``lax.axis_index``) and one process
group per axis (``mesh.groups[axis]``; None for an axis of one rank, whose
collectives are the identity).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..config import MeshConfig


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


#: the timeout of the axis groups that a ``Mesh`` makes (``dist.new_group``),
#: set by ``init_world``; None leaves the backend's default of ten or thirty
#: minutes
_group_timeout: Optional[timedelta] = None


def init_world(backend: str, init_method: str, rank: int, world_size: int,
               timeout_s: float) -> None:
    """Initialize the default process group with a ``timeout_s`` timeout,
    which the axis groups of every ``Mesh`` built after it take too, so
    that a collective that waits forever fails instead."""
    global _group_timeout
    _group_timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=_group_timeout)


class Mesh:
    """Ranks laid out on named axes, the counterpart of
    ``jax.sharding.Mesh(devices, axis_names)``: ``ranks`` is an integer
    array holding every rank of the world once.

    Every rank must build the same meshes in the same order: the
    constructor calls ``dist.new_group`` for each line of each axis longer
    than one rank, which is collective over the world.
    """

    def __init__(self, ranks, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-d ranks for axes {tuple(axis_names)}")
        self.rank, size = world()
        if sorted(ranks.ravel().tolist()) != list(range(size)):
            raise ValueError(f"mesh shape {ranks.shape} does not cover {size} ranks")
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        pos = np.argwhere(ranks == self.rank)[0]
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(self.axis_names, pos)}
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        self.group_ranks: Dict[str, List[int]] = {}
        for ax, name in enumerate(self.axis_names):
            if ranks.shape[ax] == 1:
                self.groups[name], self.group_ranks[name] = None, [self.rank]
                continue
            for line in np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax]):
                line = line.tolist()
                group = dist.new_group(line, timeout=_group_timeout)
                if self.rank in line:
                    self.groups[name], self.group_ranks[name] = group, line

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]


def build_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The 2-D (shard, data) mesh over the world's ranks.

    ``mesh_shape=None`` puts every rank on the corpus-shard axis, the
    right default for retrieval, where the corpus outgrows the query
    batch; a shape that does not cover the world raises.
    """
    config = config or MeshConfig()
    _, size = world()
    shape = config.mesh_shape or (size, 1)
    if shape[0] * shape[1] != size:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {size} ranks")
    return Mesh(np.arange(size).reshape(shape), (config.shard_axis, config.data_axis))


def single_device_mesh(axis_names: Sequence[str] = ("shard", "data")) -> Mesh:
    """The 1 x 1 mesh: one code path serves every size.  It needs no
    process group (a world of one rank)."""
    if world()[1] != 1:
        raise ValueError("single_device_mesh needs a world of one rank")
    return Mesh(np.zeros((1,) * len(axis_names), np.int64), axis_names)


def corpus_sharding(mesh: Mesh, n: int, axis: str = "shard") -> slice:
    """The rows of an ``n``-row array split over ``axis`` that this rank
    holds (``NamedSharding(mesh, P(axis, ...))`` in JAX)."""
    s = mesh.shape[axis]
    if n % s:
        raise ValueError(f"corpus rows {n} not divisible by {s} shards")
    c = mesh.index(axis)
    return slice(c * (n // s), (c + 1) * (n // s))


def replicated(mesh: Mesh, n: int) -> slice:
    """The rows of a replicated ``n``-row array that a rank holds: all."""
    return slice(0, n)


def pad_to_shards(arr: np.ndarray, num_shards: int, fill=0) -> np.ndarray:
    """Pad axis 0 so it divides evenly across shards (padding rows are
    masked out by the validity mask, never scored)."""
    n = arr.shape[0]
    rem = (-n) % num_shards
    if rem == 0:
        return arr
    pad = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


__all__ = [
    "Mesh",
    "build_mesh",
    "single_device_mesh",
    "corpus_sharding",
    "replicated",
    "pad_to_shards",
    "world",
    "init_world",
]
