"""PQ asymmetric-distance kernel K6: the port of ``pq_scores_pallas`` in
``advanced_rag_tpu/ops/pq.py`` (kernel at :328, pallas_call at :340).

``pq_scores`` (``csrc/pq.cu``) computes ``score[q, n] = sum_m
LUT_bf16[q, m, codes[n, m]]`` with an f32 sum -> [Q, SB] f32, for bits <= 4
(c <= 16 entries a subspace).  The table is rounded to bf16 here, where the
TPU wrapper rounds it.  Bound on the H100: bytes, the N * m code bytes plus
the [Q, N] f32 output; the Q * N * m table lookups are counted beside it
(the source note says what the design does about both).

The wrapper serves a CPU tensor with ``pq_scores_xla`` (the JAX package's
one-hot matmul, ``ops/pq.py``); for a CUDA tensor it launches the kernel or
raises.  ``pq_scores.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from .dense_kernels import check_cuda, raise_on_error
from .pq import pq_scores_xla

#: Largest query chunk one launch takes (``PQ_QMAX`` in pq.cu).
QMAX = 32
#: Shared memory a launch may stage its table in (the card allows 227 KB).
SMEM_BYTES = 200 * 1024


def pq_scores(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """K6: codes [SB, m] int8/uint8 (values < c) against the LUT [Q, m, c]
    f32 -> [Q, SB] f32."""
    if codes.device.type == "cpu":
        return pq_scores_xla(codes, lut)
    from .. import _build

    sb, m = codes.shape
    nq, m2, c = lut.shape
    dev = codes.device
    if m2 != m:
        raise ValueError(f"codes have m={m}, the table m={m2}")
    if c > 16 or c < 2 or c & (c - 1):
        raise ValueError(f"K6 takes 2..16 (a power of two) codes a subspace, got {c}")
    if codes.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"K6 takes int8/uint8 codes, got {codes.dtype}")
    check_cuda("codes", codes, codes.dtype, (sb, m), dev)
    lut_b = lut.to(torch.bfloat16).contiguous()   # rounded where the TPU rounds
    check_cuda("lut", lut_b, torch.bfloat16, (nq, m, c), dev)
    per_q = m * c * 2
    chunk = QMAX
    while chunk > 1 and chunk * per_q > SMEM_BYTES:
        chunk //= 2
    if chunk * per_q > SMEM_BYTES:
        raise ValueError(f"one query's table ({per_q} bytes) exceeds "
                         f"{SMEM_BYTES} bytes of shared memory")
    lib = _build.load()
    out = torch.empty((nq, sb), dtype=torch.float32, device=dev)
    vec = int(m % 16 == 0 and codes.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for q0 in range(0, nq, chunk):
            nc = min(chunk, nq - q0)
            rc = lib.art_pq_scores(codes.data_ptr(), lut_b[q0].data_ptr(),
                                   out[q0].data_ptr(), nc, sb, m, c, vec, stream)
            raise_on_error(rc, "pq_scores (K6)")
            pq_scores.launches += 1
    return out


pq_scores.launches = 0


__all__ = ["pq_scores"]
