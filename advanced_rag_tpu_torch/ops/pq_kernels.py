"""PQ asymmetric-distance kernel K6: the port of ``pq_scores_pallas`` in
``advanced_rag_tpu/ops/pq.py`` (kernel at :328, pallas_call at :340).

``pq_scores`` (``csrc/pq.cu``) computes ``score[q, n] = sum_m
LUT_bf16[q, m, codes[n, m]]`` with an f32 sum -> [Q, SB] f32, for bits <= 4
(c <= 16 entries a subspace).  The table is rounded to bf16 here, where the
TPU wrapper rounds it.  Bound on the H100: bytes, the N * m code bytes plus
the [Q, N] f32 output.

Two kernels compute it, chosen by the query count of a launch
(``pq_kernel_for``): above ``LOOKUP_MAX_Q`` queries the one-hot kernel, the
TPU kernel's own formulation (a one-hot [rows, m * 16] matrix times the
table [m * 16, Q], on the tensor cores with ``mma.sync``; the wrapper lays
the table out as [m][Q][16] bf16, ``onehot_table``), and at or below it
the lookup kernel (one shared-memory load per row, subspace and query),
which leaves no n8 tile of the tensor cores mostly empty.  This is a shape
dispatch between two kernels: each launch runs its kernel or raises.

``pq_plan`` plans a call's launches by the kernel each runs: the lookup
kernel needs only its table to fit in shared memory; the one-hot kernel
needs its table and two code stages, so where all m subspaces do not fit
(m = 384, ``auto_pq_m`` of the 1536-wide default embedder) it splits them
into groups that do, one launch a group, each adding its f32 partial
scores into the output.

The wrapper serves a CPU tensor with ``pq_scores_xla`` (the JAX package's
one-hot matmul, ``ops/pq.py``); for a CUDA tensor it launches a kernel or
raises.  ``pq_scores.launches`` counts the launches of both kernels and
``pq_scores.onehot_launches`` those of the one-hot kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from .dense import cdiv
from .dense_kernels import QMAX, SCAN_SMEM_MAX, check_cuda, raise_on_error
from .pq import pq_scores_xla

#: The most queries a launch of the lookup kernel takes; more go to the
#: one-hot kernel.  On an H100 at N = 1M, m = 96 the two take about the same
#: time from 5 to 8 queries, the lookup kernel less below, the one-hot
#: kernel less above (chip_smoke.py phase 3; PERF.md § 6).
LOOKUP_MAX_Q = 8
#: Subspaces summed in one fresh tensor-core fragment (``PQ_GROUP``).
GROUP = 8


def onehot_smem_bytes(qc: int, mt: int, m: int) -> int:
    """Shared memory of one one-hot launch, as ``pq_onehot_smem`` in pq.cu
    works it out: the table [m8][qc][32 bytes] and two stages, each the
    codes of 256 * mt rows (16 warps of mt m16 tiles) at a pitch of an odd
    number of 16-byte units or the epilogue's [min(qc, 16)][256 * mt + 4]
    f32, whichever is larger."""
    m8 = -(-m // GROUP) * GROUP
    pitch = 16 * (-(-m // 16) | 1)
    bm = 256 * mt
    stage = max(bm * pitch, min(qc, 16) * (bm + 4) * 4)
    return m8 * qc * 32 + 2 * stage


def onehot_chunk(m: int) -> int:
    """Queries per one-hot launch over all m subspaces: the largest of 32,
    16, 8 whose table fits the 227 KB a block may opt in to (with 256-row
    tiles at the least)."""
    for qc in (QMAX, 16, 8):
        if onehot_smem_bytes(qc, 1, m) <= SCAN_SMEM_MAX:
            return qc
    raise ValueError(f"K6: m={m} subspaces need {onehot_smem_bytes(8, 1, m)} bytes "
                     f"of shared memory for 8 queries, more than {SCAN_SMEM_MAX}")


def onehot_group(nc: int, m: int) -> int:
    """Subspaces per one-hot launch of ``nc`` queries (the kernel stages a
    table of 8, 16 or 32): all m where they fit, else the largest even
    split of m into groups of a multiple of 16 subspaces (so every group
    starts 16-byte aligned) that fits."""
    qc = 8 if nc <= 8 else 16 if nc <= 16 else QMAX
    groups = 1
    while True:
        mg = m if groups == 1 else cdiv(cdiv(m, groups), 16) * 16
        if onehot_smem_bytes(qc, 1, mg) <= SCAN_SMEM_MAX:
            return mg
        if mg <= 16:
            raise ValueError(f"K6: no group of subspaces of m={m} fits shared memory")
        groups += 1


def lookup_chunk(m: int, c: int) -> int:
    """Queries per lookup launch: the largest of 32, 16, 8, 4, 2, 1 whose
    table ([qc, m, c] bf16, the kernel's only shared memory) fits."""
    for qc in (QMAX, 16, 8, 4, 2, 1):
        if qc * m * c * 2 <= SCAN_SMEM_MAX:
            return qc
    raise ValueError(f"K6: the lookup table of one query, m={m} c={c}, exceeds "
                     f"{SCAN_SMEM_MAX} bytes of shared memory")


class Launch(NamedTuple):
    """One K6 launch: queries [q0, q0 + nc) over subspaces [s0, s1)."""
    q0: int
    nc: int
    kind: str      # "lookup" or "onehot"
    s0: int
    s1: int


def pq_plan(nq: int, m: int, c: int, kernel=None) -> List[Launch]:
    """The launches of one K6 call of ``nq`` queries: query chunks of
    ``onehot_chunk(m)`` (32 when the subspaces must be split), each through
    ``kernel`` or ``pq_kernel_for`` of its size; a lookup chunk of more
    queries than ``lookup_chunk`` takes several launches, and a one-hot chunk
    one launch per group of ``onehot_group`` subspaces, in subspace order."""
    try:
        oc = onehot_chunk(m)
    except ValueError:
        oc = QMAX
    lc = lookup_chunk(m, c)
    plan = []
    for q0 in range(0, nq, oc):
        nc = min(oc, nq - q0)
        kind = kernel or pq_kernel_for(nc)
        if kind == "onehot":
            mg = onehot_group(nc, m)
            plan += [Launch(q0, nc, kind, s0, min(s0 + mg, m)) for s0 in range(0, m, mg)]
        else:
            plan += [Launch(q1, min(lc, q0 + nc - q1), kind, 0, m)
                     for q1 in range(q0, q0 + nc, lc)]
    return plan


def pq_kernel_for(nq: int) -> str:
    """The kernel a launch of ``nq`` queries runs: "lookup" or "onehot"."""
    return "lookup" if nq <= LOOKUP_MAX_Q else "onehot"


#: The one-hot kernel's k order inside a subspace: slot k holds code
#: ONEHOT_K[k], so that lane t's slots (2t, 2t + 1, 2t + 8, 2t + 9) hold
#: codes 4t .. 4t + 3 (``onehot_pair`` in pq.cu).
ONEHOT_K = [4 * (k % 8 // 2) + k % 2 + 2 * (k // 8) for k in range(16)]


def onehot_table(lut: torch.Tensor) -> torch.Tensor:
    """The table [Q, m, c] f32 -> [m, Q, 16] bf16 in the kernel's k order
    (``ONEHOT_K``), zero for codes past c: the one-hot kernel's B operand,
    16 entries (32 bytes) of one (subspace, query) contiguous."""
    q, m, c = lut.shape
    t = torch.zeros((m, q, 16), dtype=torch.bfloat16, device=lut.device)
    t[:, :, :c] = lut.to(torch.bfloat16).transpose(0, 1)
    # code 4 t + 2 h + e -> slot 8 h + 2 t + e: a transpose of (t, h)
    return t.view(m, q, 4, 2, 2).transpose(2, 3).reshape(m, q, 16)


def pq_scores(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """K6: codes [SB, m] int8/uint8 (values < c) against the LUT [Q, m, c]
    f32 -> [Q, SB] f32."""
    if codes.device.type == "cpu":
        return pq_scores_xla(codes, lut)
    return pq_scores_by(codes, lut, None)


def pq_scores_by(codes: torch.Tensor, lut: torch.Tensor, kernel) -> torch.Tensor:
    """K6 on the card, every launch through ``kernel`` ("lookup" or
    "onehot"), or through ``pq_kernel_for`` of its query count when
    ``kernel`` is None (what ``pq_scores`` does)."""
    from .. import _build

    sb, m = codes.shape
    nq, m2, c = lut.shape
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"pq_scores_by runs on the card, got codes on {dev}")
    if kernel not in (None, "lookup", "onehot"):
        raise ValueError(f"unknown K6 kernel: {kernel}")
    if m2 != m:
        raise ValueError(f"codes have m={m}, the table m={m2}")
    if c > 16 or c < 2 or c & (c - 1):
        raise ValueError(f"K6 takes 2..16 (a power of two) codes a subspace, got {c}")
    if codes.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"K6 takes int8/uint8 codes, got {codes.dtype}")
    check_cuda("codes", codes, codes.dtype, (sb, m), dev)
    lut_b = lut.to(torch.bfloat16).contiguous()   # rounded where the TPU rounds
    check_cuda("lut", lut_b, torch.bfloat16, (nq, m, c), dev)
    plan = pq_plan(nq, m, c, kernel)
    table = onehot_table(lut) if any(p.kind == "onehot" for p in plan) else None
    lib = _build.load()
    out = torch.empty((nq, sb), dtype=torch.float32, device=dev)
    base = codes.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for p in plan:
            mg = p.s1 - p.s0
            vec = int(m % 16 == 0 and mg % 16 == 0 and (base + p.s0) % 16 == 0)
            if p.kind == "onehot":
                rc = lib.art_pq_onehot(base + p.s0, table[p.s0, p.q0].data_ptr(),
                                       out[p.q0].data_ptr(), p.nc, nq, sb, mg, m, c, vec,
                                       int(p.s0 > 0), stream)
                pq_scores.onehot_launches += 1
            else:
                rc = lib.art_pq_scores(base, lut_b[p.q0].data_ptr(), out[p.q0].data_ptr(),
                                       p.nc, sb, m, c, vec, stream)
            raise_on_error(rc, f"pq_scores (K6, {p.kind})")
            pq_scores.launches += 1
    return out


pq_scores.launches = 0          # every launch of either kernel
pq_scores.onehot_launches = 0   # the launches of the one-hot kernel


__all__ = ["LOOKUP_MAX_Q", "ONEHOT_K", "Launch", "lookup_chunk", "onehot_chunk",
           "onehot_group", "onehot_smem_bytes", "onehot_table", "pq_kernel_for", "pq_plan",
           "pq_scores", "pq_scores_by"]
