"""The collectives of the sharded programs, over one axis of a ``Mesh``.

The transport follows the axis group's backend (``dist.get_backend``):

- NCCL takes the device tensors as they are;
- Gloo moves host memory, so ``wire`` copies the payload to the CPU and
  the result comes back to the caller's device.  That copy is the wire
  under the collective, not a fallback: the payload is what the merges
  send (the [Q, k] (score, id) pairs, the MMR pool's rows, the gradients),
  and every score, fusion and rerank stays on the caller's device.

An axis of one rank has no group, and each collective over it is the
identity.  Gloo has no reduce-scatter: where one would serve (the
trainer's sliced gradients), the caller takes its slice of an
``all_reduce``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh


def wire(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The tensor handed to the backend: a host copy for Gloo."""
    t = t.contiguous()
    if dist.get_backend(group) == "gloo" and t.device.type != "cpu":
        return t.cpu()
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[S, *t.shape]: every rank's ``t`` along ``axis``, in coordinate order."""
    group = mesh.groups[axis]
    if group is None:
        return t.unsqueeze(0)
    w = wire(t, group)
    parts = [torch.empty_like(w) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, w, group=group)
    return torch.stack(parts).to(t.device)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``axis`` (a new tensor)."""
    group = mesh.groups[axis]
    if group is None:
        return t
    w = wire(t, group)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(t.device)


def exchange(t: torch.Tensor, mesh: Mesh, axis: str, peer: int) -> torch.Tensor:
    """Send ``t`` to the rank at coordinate ``peer`` on ``axis`` and receive
    that rank's tensor of the same shape (one ``batch_isend_irecv``)."""
    group = mesh.groups[axis]
    if group is None:
        return t
    send = wire(t, group)
    recv = torch.empty_like(send)
    dst = mesh.group_ranks[axis][peer]
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                   dist.P2POp(dist.irecv, recv, dst, group)])
    for req in reqs:
        req.wait()
    return recv.to(t.device)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 for a loss that every rank computes alike.

    Each rank then holds the same upstream gradient of the gathered
    tensor, so the backward keeps its own rows and sends nothing.  (The
    usual backward, a reduce-scatter, would sum S equal copies and
    multiply the gradient by S.)"""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.rows, ctx.index = t.shape[0], mesh.index(axis)
        return all_gather(t, mesh, axis).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


def gather_rows(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[S * R, ...]: every rank's [R, ...] rows along ``axis`` in coordinate
    order, differentiable for a loss that every rank of the axis computes
    alike from the gathered rows."""
    if mesh.groups[axis] is None:
        return t
    return _GatherRows.apply(t, mesh, axis)


__all__ = ["wire", "all_gather", "all_reduce_sum", "exchange", "gather_rows"]
