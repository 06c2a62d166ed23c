"""IVF slab-scan kernels K5 and K4: the port of
``advanced_rag_tpu/ops/pallas_ivf.py``.

``ivf_scores`` (``csrc/ivf.cu``) scores each query against its own probed
partitions -> [Q, nprobe, cap] f32.  It replaces the kernel of
``ivf_topk_pallas_batch`` (K5, pallas_call at :193) and, as its Q = 1
instance, ``_slab_kernel`` of ``ivf_topk_pallas`` (K4, :36).  Bound on the
H100: bytes, Q * nprobe * cap * D * itemsize streamed (the source note says
what the design does about it).

The wrappers do the rest in PyTorch, as the TPU wrappers do in XLA: the
centroid product and the probe top-k, the ``packed_rows`` gather and mask,
the flat top-k (padded when nprobe * cap < k) and the overflow tail's small
product and merge.  Ties go to the lower index, as ``lax.top_k`` breaks
them.  SQ8 rounds as the Pallas kernel does, ``(s * row_scale) * q_scale``;
the XLA path ``ops/ivf.py:ivf_topk_plain`` rounds ``s * (q_scale *
row_scale)``, so the two may differ by an ulp.

A wrapper serves a CPU tensor with ``ivf_scores_plain``; for a CUDA tensor
it launches the kernel or raises.  ``ivf_scores.launches`` counts every
launch and ``ivf_scores.k4_launches`` those made through the single-query
entry ``ivf_topk_kernel`` (K4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .dense_kernels import check_cuda, raise_on_error
from .ivf import IVFPartitions, finish_topk, merge_tail, probe_lists
from .quant import sq8_quantize

_ROW_MODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 16}


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


def ivf_scores(probes: torch.Tensor, q_in: torch.Tensor,
               packed_emb: torch.Tensor,
               packed_scale: Optional[torch.Tensor] = None, *,
               single: bool = False) -> torch.Tensor:
    """K5 (K4 when ``single``): probes [Q, nprobe] i32, queries [Q, D]
    (f32, or int8 codes for SQ8 slabs), packed_emb [nlist, cap, D]
    bf16/f32/int8, packed_scale [nlist, cap] f32 -> [Q, nprobe, cap] f32."""
    if packed_emb.device.type == "cpu":
        return ivf_scores_plain(probes, q_in, packed_emb, packed_scale)
    from .. import _build

    nlist, cap, d = packed_emb.shape
    nq, nprobe = probes.shape
    dev = packed_emb.device
    dt = packed_emb.dtype
    if dt not in _ROW_MODE:
        raise TypeError(f"K5 takes bf16, f32 or int8 slabs, got {dt}")
    sq8 = dt == torch.int8
    if sq8 != (packed_scale is not None):
        raise ValueError("int8 slabs need packed_scale, float slabs take none")
    if sq8 and d % 4 != 0:
        raise ValueError(f"K5 on SQ8 slabs needs D divisible by 4, got D={d}")
    if single and (sq8 or nq != 1):
        raise ValueError("K4 is the single-query bf16/f32 instance")
    check_cuda("packed_emb", packed_emb, dt, (nlist, cap, d), dev)
    check_cuda("probes", probes, torch.int32, (nq, nprobe), dev)
    check_cuda("q_in", q_in, torch.int8 if sq8 else torch.float32, (nq, d), dev)
    if sq8:
        check_cuda("packed_scale", packed_scale, torch.float32, (nlist, cap), dev)
    lib = _build.load()
    out = torch.empty((nq, nprobe, cap), dtype=torch.float32, device=dev)
    vec = int(d % _VEC_ELEMS[dt] == 0 and packed_emb.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.art_ivf_scores(
            probes.data_ptr(), q_in.data_ptr(), packed_emb.data_ptr(),
            packed_scale.data_ptr() if sq8 else None, out.data_ptr(),
            _ROW_MODE[dt], nq, nprobe, nlist, cap, d, vec, stream)
    raise_on_error(rc, "ivf_scores (K4)" if single else "ivf_scores (K5)")
    ivf_scores.launches += 1
    if single:
        ivf_scores.k4_launches += 1
    return out


ivf_scores.launches = 0       # every launch of the kernel
ivf_scores.k4_launches = 0    # the launches through ivf_topk_kernel (K4)


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


__all__ = ["ivf_scores", "ivf_scores_plain", "ivf_topk_kernel_batch",
           "ivf_topk_kernel"]
