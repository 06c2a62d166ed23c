"""IVF slab-scan kernels K5 and K4: the port of
``advanced_rag_tpu/ops/pallas_ivf.py``.

``ivf_scores`` (``csrc/ivf.cu``) scores each query against its own probed
partitions -> [Q, nprobe, cap] f32.  It replaces the kernel of
``ivf_topk_pallas_batch`` (K5, pallas_call at :193) and, as its Q = 1
instance, ``_slab_kernel`` of ``ivf_topk_pallas`` (K4, :36).  Bound on the
H100: bytes, each probed slab read once per batch plus the output.

Two routes, chosen from the launch's shapes (``ivf_route``: a model of
both routes' times, ``route_ms``, over the lists a batch is expected to
share):

- grouped, where the model expects it to be faster: a plan kernel inverts
  ``probes`` on the device (per list the (q, i) pairs that probe it, the
  lists with a pair; ``ivf_probe_groups_plain`` is its plain version), and
  a persistent scan reads each probed slab tile once into shared memory
  (tile copies of the Tensor Memory Accelerator, by a producer warp, into
  a ring of slots) and scores it against every query of the batch that
  probes it, QC at a time, on the tensor cores (``ivf_scores_grouped_plain``
  computes the same scores the same way in PyTorch).  ``grouped_plan``
  mirrors its tile, chunk, block and shared memory,
  ``grouped_workspace_bytes`` its plan buffers.  It takes bf16 and SQ8
  slabs whose rows are 16-byte aligned;
- streaming, elsewhere, for f32 and other slabs and for K4: one block per (row
  tile, probe, query), each streaming its own slab; with a few queries, or
  many lists a batch seldom shares, little is shared, and it pays no plan
  launch.

The wrappers do the rest in PyTorch, as the TPU wrappers do in XLA: the
centroid product and the probe top-k, the ``packed_rows`` gather and mask,
the flat top-k (padded when nprobe * cap < k) and the overflow tail's small
product and merge.  Ties go to the lower index, as ``lax.top_k`` breaks
them.  SQ8 rounds as the Pallas kernel does, ``(s * row_scale) * q_scale``;
the XLA path ``ops/ivf.py:ivf_topk_plain`` rounds ``s * (q_scale *
row_scale)``, so the two may differ by an ulp.

A wrapper serves a CPU tensor with ``ivf_scores_plain``; for a CUDA tensor
it launches a kernel or raises.  ``ivf_scores.launches`` counts every
launch, ``ivf_scores.k4_launches`` those made through the single-query
entry ``ivf_topk_kernel`` (K4) and ``ivf_scores.grouped_launches`` those
of the grouped route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .dense_kernels import SCAN_SMEM_MAX, check_cuda, raise_on_error
from .ivf import IVFPartitions, finish_topk, merge_tail, probe_lists
from .quant import sq8_quantize

_ROW_MODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ITEM = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}

#: The route model per slab type (``route_ms``): the grouped scan's time
#: per byte it reads, in units of the streaming kernel's time per byte it
#: reads, and its fixed cost in ms (the plan launch and the ring's fill).
#: Chosen so that it picks the faster route at every shape where
#: chip_smoke.py phase 3 timed both on an H100 over random probe lists
#: (manager geometry nprobe 32, Q = 1-32; 1M rows nprobe 8 and 32, Q =
#: 8-64) but near-ties (PERF.md § 6).
ROUTE_COST = {torch.bfloat16: (1.10, 0.020), torch.int8: (0.90, 0.007)}
#: The byte rate route_ms converts bytes to ms with (H100 SXM HBM3)
HBM_BYTES_PER_MS = 3.35e9
#: The grouped scan per slab type (``Grouped<KIND>`` in ivf.cu): rows a
#: tile, queries a chunk, query parts (bf16 slabs: the f32 query split into
#: bf16 hi / mid / lo, as K1 splits it).  f32 slabs always stream: a
#: grouped scan of them on the CUDA cores ran 2-4x slower than streaming.
GROUPED = {torch.bfloat16: (64, 32, 3), torch.int8: (128, 32, 1)}
#: Slots of the grouped scan's tile ring (``IVF_RING``): the producer warp
#: streams up to RING tiles ahead of the consumer warps.
RING = 3


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def grouped_plan(dtype: torch.dtype, d: int) -> Tuple[int, int, int, int]:
    """(rows a tile, queries a chunk, threads a block, shared-memory bytes)
    of one grouped scan, as ``Grouped`` and ``grouped_smem`` in ivf.cu work
    them out.  A block is one producer warp and a consumer warp per 16 tile
    rows.  Its shared memory: 1 KB to align the ring, RING slots (the tile
    as boxes of rows x 128 bytes, the Tensor Memory Accelerator's copies,
    enough boxes for a row), 128 bytes of mbarriers and work entries, the
    chunk's pair ids, its query rows per part, each padded to the mma's
    32-byte k step
    plus 16 bytes (an odd number of 16-byte units, so the rows an ldmatrix
    reads fall in distinct banks), and for SQ8 each slot's row scales."""
    bm, qc, parts = GROUPED[dtype]
    kpad = _round_up(d * _ITEM[dtype], 32)
    slot = -(-kpad // 128) * bm * 128
    scales = RING * bm * 4 if dtype == torch.int8 else 0
    return (bm, qc, (bm // 16 + 1) * 32,
            1024 + RING * slot + 128 + qc * 4 + parts * qc * (kpad + 16) + scales)


def grouped_workspace_bytes(dtype: torch.dtype, nq: int, nprobe: int,
                            nlist: int, d: int) -> int:
    """Bytes of the grouped route's plan buffers: int32 offsets [nlist + 1],
    pairs [nq * nprobe], n_work [1], counters [nlist]; then, on 16-byte
    boundaries, the work entries int4 [nlist] (a list, its first pair, its
    end) and, for bf16 slabs, the query parts [3][nq][kpad] bf16 (kpad: D
    rounded up to 16 values)."""
    size = _round_up(4 * (2 * nlist + 2 + nq * nprobe), 16) + 16 * nlist
    if dtype == torch.bfloat16:
        size += 3 * nq * _round_up(2 * d, 32)
    return size


def expected_lists(nq: int, nprobe: int, nlist: int) -> float:
    """The expected number of distinct lists that ``nq`` queries probe when
    each probes ``nprobe`` distinct lists drawn uniformly: the fewest a
    batch shares (real queries cluster and share more)."""
    return nlist * (1.0 - (1.0 - min(nprobe, nlist) / nlist) ** nq)


def route_ms(nq: int, nprobe: int, nlist: int, cap: int, dtype: torch.dtype,
             d: int) -> Tuple[float, float]:
    """(streaming, grouped) estimated device ms of one K5 launch over
    uniformly drawn probe lists: the streaming kernel reads a slab per
    (query, probe), the grouped scan each expected probed list's slab once
    (its rows rounded up to whole tiles) at ROUTE_COST's weight and fixed
    cost."""
    row = d * _ITEM[dtype] + (4 if dtype == torch.int8 else 0)
    weight, fixed = ROUTE_COST[dtype]
    bm = GROUPED[dtype][0]
    stream = nq * min(nprobe, nlist) * cap * row / HBM_BYTES_PER_MS
    grouped = expected_lists(nq, nprobe, nlist) * _round_up(cap, bm) * row / HBM_BYTES_PER_MS
    return stream, fixed + weight * grouped


def ivf_route(nq: int, nprobe: int, nlist: int, cap: int, dtype: torch.dtype, d: int,
              single: bool = False, aligned: bool = True) -> str:
    """The route of a launch of ``nq`` queries, each probing ``nprobe`` of
    ``nlist`` slabs of ``cap`` rows of width ``d``: "stream" for K4, for
    slab rows that are not 16-byte aligned (the grouped scan copies whole
    rows with the Tensor Memory Accelerator), for f32 slabs, where the
    grouped scan's shared memory would not fit, and where ``route_ms``
    expects streaming to be faster (few queries, or lists that a batch
    seldom shares); else "grouped"."""
    if (single or not aligned or dtype not in GROUPED
            or grouped_plan(dtype, d)[3] > SCAN_SMEM_MAX):
        return "stream"
    stream, grouped = route_ms(nq, nprobe, nlist, cap, dtype, d)
    return "grouped" if grouped < stream else "stream"


def ivf_scores_plain(probes: torch.Tensor, q_in: torch.Tensor,
                     packed_emb: torch.Tensor,
                     packed_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[Q, nprobe, cap] f32: the gather + f32 einsum of the XLA path; SQ8
    (int8 ``q_in`` codes): float(integer dot) * row scale, exact in f32
    (D * 127^2 < 2^24), the query scale left to the caller."""
    pr = probes.long()
    s = torch.einsum("qd,qpcd->qpc", q_in.float(), packed_emb[pr].float())
    if packed_scale is not None:
        s = s * packed_scale[pr]
    return s


def ivf_probe_groups_plain(probes: torch.Tensor, nlist: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The grouped route's plan: probes [Q, nprobe] -> (offsets [nlist + 1]
    i32, pairs i32, work i32, n_work).  ``pairs[offsets[l]:offsets[l + 1]]``
    are the pairs that probe list l, each encoded q * nprobe + i (here in
    ascending order; the kernel's order inside a group comes from atomics);
    ``work`` the lists with a pair, ascending.  Pairs whose probe id is
    outside [0, nlist) are in no group."""
    flat = probes.reshape(-1).long()
    ids = torch.nonzero((flat >= 0) & (flat < nlist)).flatten()
    lists, order = torch.sort(flat[ids], stable=True)
    offsets = torch.searchsorted(lists, torch.arange(nlist + 1, device=flat.device))
    work = torch.nonzero(offsets[1:] > offsets[:-1]).flatten()
    return (offsets.to(torch.int32), ids[order].to(torch.int32),
            work.to(torch.int32), int(work.numel()))


def ivf_scores_grouped_plain(probes: torch.Tensor, q_in: torch.Tensor,
                             packed_emb: torch.Tensor,
                             packed_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ivf_scores_plain``'s function computed the grouped route's way: per
    probed list its slab times the gathered queries of its pairs, scattered
    back to [Q, nprobe, cap]; 0.0 for out-of-range probe ids."""
    nq, nprobe = probes.shape
    nlist, cap, _ = packed_emb.shape
    offsets, pairs, work, _ = ivf_probe_groups_plain(probes, nlist)
    out = torch.zeros((nq * nprobe, cap), dtype=torch.float32, device=packed_emb.device)
    for lst in work.tolist():
        grp = pairs[offsets[lst]:offsets[lst + 1]].long()
        s = q_in[grp // nprobe].float() @ packed_emb[lst].float().T      # [g, cap]
        if packed_scale is not None:
            s = s * packed_scale[lst]
        out[grp] = s
    return out.reshape(nq, nprobe, cap)


def ivf_scores(probes: torch.Tensor, q_in: torch.Tensor,
               packed_emb: torch.Tensor,
               packed_scale: Optional[torch.Tensor] = None, *,
               single: bool = False) -> torch.Tensor:
    """K5 (K4 when ``single``): probes [Q, nprobe] i32, queries [Q, D]
    (f32, or int8 codes for SQ8 slabs), packed_emb [nlist, cap, D]
    bf16/f32/int8, packed_scale [nlist, cap] f32 -> [Q, nprobe, cap] f32."""
    if packed_emb.device.type == "cpu":
        return ivf_scores_plain(probes, q_in, packed_emb, packed_scale)
    return ivf_scores_by(probes, q_in, packed_emb, packed_scale, None, single=single)


def ivf_scores_by(probes: torch.Tensor, q_in: torch.Tensor,
                  packed_emb: torch.Tensor, packed_scale: Optional[torch.Tensor],
                  route: Optional[str], *, single: bool = False) -> torch.Tensor:
    """K5 on the card through ``route`` ("stream" or "grouped"), or through
    ``ivf_route`` of its shapes when ``route`` is None (what ``ivf_scores``
    does)."""
    from .. import _build

    nlist, cap, d = packed_emb.shape
    nq, nprobe = probes.shape
    dev = packed_emb.device
    dt = packed_emb.dtype
    if dev.type != "cuda":
        raise ValueError(f"ivf_scores_by runs on the card, got slabs on {dev}")
    if dt not in _ROW_MODE:
        raise TypeError(f"K5 takes bf16, f32 or int8 slabs, got {dt}")
    sq8 = dt == torch.int8
    if sq8 != (packed_scale is not None):
        raise ValueError("int8 slabs need packed_scale, float slabs take none")
    if sq8 and d % 4 != 0:
        raise ValueError(f"K5 on SQ8 slabs needs D divisible by 4, got D={d}")
    if single and (sq8 or nq != 1):
        raise ValueError("K4 is the single-query bf16/f32 instance")
    # 16-byte aligned rows: the kernels' vector loads and tile copies
    vec = int(d * _ITEM[dt] % 16 == 0 and packed_emb.data_ptr() % 16 == 0)
    if route is None:
        route = ivf_route(nq, nprobe, nlist, cap, dt, d, single, bool(vec))
    if route not in ("stream", "grouped") or (single and route != "stream"):
        raise ValueError(f"unknown K5 route {route!r} (K4 streams)")
    if route == "grouped" and (dt not in GROUPED or not vec
                               or grouped_plan(dt, d)[3] > SCAN_SMEM_MAX):
        raise ValueError(f"the grouped K5 scan takes bf16 or int8 slabs with 16-byte "
                         f"aligned rows whose tiles fit {SCAN_SMEM_MAX} bytes of shared "
                         f"memory (D={d}, {dt})")
    check_cuda("packed_emb", packed_emb, dt, (nlist, cap, d), dev)
    check_cuda("probes", probes, torch.int32, (nq, nprobe), dev)
    check_cuda("q_in", q_in, torch.int8 if sq8 else torch.float32, (nq, d), dev)
    if sq8:
        check_cuda("packed_scale", packed_scale, torch.float32, (nlist, cap), dev)
    lib = _build.load()
    out = torch.empty((nq, nprobe, cap), dtype=torch.float32, device=dev)
    scale_ptr = packed_scale.data_ptr() if sq8 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "grouped":
            ws = torch.empty(grouped_workspace_bytes(dt, nq, nprobe, nlist, d),
                             dtype=torch.uint8, device=dev)
            rc = lib.art_ivf_grouped(
                probes.data_ptr(), q_in.data_ptr(), packed_emb.data_ptr(), scale_ptr,
                out.data_ptr(), ws.data_ptr(), _ROW_MODE[dt], nq, nprobe, nlist, cap, d,
                vec, stream)
        else:
            rc = lib.art_ivf_scores(
                probes.data_ptr(), q_in.data_ptr(), packed_emb.data_ptr(), scale_ptr,
                out.data_ptr(), _ROW_MODE[dt], nq, nprobe, nlist, cap, d, vec, stream)
    raise_on_error(rc, "ivf_scores (K4)" if single else f"ivf_scores (K5, {route})")
    ivf_scores.launches += 1
    if single:
        ivf_scores.k4_launches += 1
    if route == "grouped":
        ivf_scores.grouped_launches += 1
    return out


ivf_scores.launches = 0          # every launch of either route
ivf_scores.k4_launches = 0       # the launches through ivf_topk_kernel (K4)
ivf_scores.grouped_launches = 0  # the launches of the grouped route


def ivf_topk_kernel_batch(
    parts: IVFPartitions,
    queries: torch.Tensor,                # [Q, D] f32
    k: int,
    valid: Optional[torch.Tensor] = None,
    *,
    nprobe: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 search -> (scores [Q, k], rows [Q, k]); same contract as
    ``ivf_topk`` (the counterpart of ``ivf_topk_pallas_batch``)."""
    q = queries.float().contiguous()
    nprobe = min(nprobe, parts.packed_emb.shape[0])
    probes = probe_lists(parts, q, nprobe).contiguous()
    if parts.packed_scale is not None:
        # quantize the query as the XLA path does; integer dot in the kernel
        q_codes, q_scale = sq8_quantize(q)
        scores = ivf_scores(probes, q_codes.contiguous(), parts.packed_emb,
                            parts.packed_scale) * q_scale[:, None, None]
        ts = (q_codes.float() @ parts.tail_emb.float().T) * (
            q_scale[:, None] * parts.tail_scale[None, :])
    else:
        scores = ivf_scores(probes, q, parts.packed_emb)
        ts = q @ parts.tail_emb.float().T
    top_s, top_i = finish_topk(scores, probes, parts, k, valid)
    return merge_tail(top_s, top_i, ts, parts, k, valid)


def ivf_topk_kernel(
    parts: IVFPartitions,
    query: torch.Tensor,                  # [D] f32 (one query)
    k: int,
    valid: Optional[torch.Tensor] = None,
    *,
    nprobe: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 search -> (scores [k], rows [k]) for one query over bf16/f32
    slabs (the counterpart of ``ivf_topk_pallas``)."""
    if parts.packed_scale is not None:
        raise ValueError("ivf_topk_kernel (K4) takes bf16/f32 slabs; "
                         "use ivf_topk_kernel_batch for SQ8")
    q = query.float().reshape(1, -1).contiguous()
    nprobe = min(nprobe, parts.packed_emb.shape[0])
    probes = probe_lists(parts, q, nprobe).contiguous()
    scores = ivf_scores(probes, q, parts.packed_emb, single=True)
    top_s, top_i = finish_topk(scores, probes, parts, k, valid)
    top_s, top_i = merge_tail(top_s, top_i, q @ parts.tail_emb.float().T,
                              parts, k, valid)
    return top_s[0], top_i[0]


__all__ = ["GROUPED", "RING", "ROUTE_COST", "expected_lists", "grouped_plan",
           "grouped_workspace_bytes", "ivf_probe_groups_plain", "ivf_route", "route_ms",
           "ivf_scores", "ivf_scores_by",
           "ivf_scores_grouped_plain", "ivf_scores_plain", "ivf_topk_kernel_batch",
           "ivf_topk_kernel"]
