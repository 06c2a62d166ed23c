"""Dense-scan kernels K1 (bf16/f32 rows) and K2 (SQ8 rows): the port of
``advanced_rag_tpu/ops/pallas_dense.py``.

Each kernel (``csrc/kernels.cu``) writes the [Q, N] f32 score matrix plus
the additive row mask, and the top-k runs outside on that matrix, as in
the TPU wrappers.  Beside each kernel's wrapper sits its plain PyTorch
version.  The wrapper serves a CPU tensor with the plain version; for a
CUDA tensor it launches the kernel or raises.  ``<wrapper>.launches``
counts the kernel's launches.

K1 ``dense_scores`` replaces ``pallas_dense.py:_matmul_kernel`` (pallas_call
at :78).  Bound on the H100: bytes, N * D * itemsize of rows (plus the
[Q, N] output) over 3.35 TB/s; the bf16 tensor cores would do its two
hi/lo passes faster.  Its f32 FMAs on the CUDA cores take longer at Q = 32.
K2 ``sq8_scores`` replaces ``pallas_dense.py:_matmul_sq8_kernel``.  Bound:
bytes, N * D of int8 codes.  The kernels' source notes say what the design
does about each bound.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .dense import NEG_INF, l2_normalize, mask_additive, reduce_topk
from .quant import sq8_quantize

#: Largest query chunk one launch takes (``ART_QMAX`` in kernels.cu).
QMAX = 32
#: Shared memory a launch may use without opting in to more.
SMEM_BYTES = 48 * 1024


def query_chunk(bytes_per_query: int) -> int:
    """Largest power of two <= QMAX whose queries fit SMEM_BYTES."""
    c = QMAX
    while c > 1 and c * bytes_per_query > SMEM_BYTES:
        c //= 2
    if c * bytes_per_query > SMEM_BYTES:
        raise ValueError(
            f"one query needs {bytes_per_query} bytes of shared memory, "
            f"more than the {SMEM_BYTES} a launch takes")
    return c


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")


# -- K1 ----------------------------------------------------------------------

def dense_scores_plain(q: torch.Tensor, rows: torch.Tensor,
                       mask_add: torch.Tensor) -> torch.Tensor:
    """[Q, N] = q @ float(rows).T + mask (f32 dot, the kernel's function)."""
    return q.float() @ rows.float().T + mask_add[None, :]


def dense_scores(q: torch.Tensor, rows: torch.Tensor,
                 mask_add: torch.Tensor) -> torch.Tensor:
    """K1: f32 queries [Q, D] against bf16 or f32 rows [N, D] plus the
    additive mask [N] -> [Q, N] f32."""
    if rows.device.type == "cpu":
        return dense_scores_plain(q, rows, mask_add)
    from .. import _build

    n, d = rows.shape
    nq = q.shape[0]
    dev = rows.device
    if rows.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes bf16 or f32 rows, got {rows.dtype}")
    check_cuda("rows", rows, rows.dtype, (n, d), dev)
    check_cuda("q", q, torch.float32, (nq, d), dev)
    check_cuda("mask_add", mask_add, torch.float32, (n,), dev)
    lib = _build.load()
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    per_vec = 8 if rows.dtype == torch.bfloat16 else 4
    vec = int(d % per_vec == 0 and rows.data_ptr() % 16 == 0)
    chunk = query_chunk(4 * d)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for q0 in range(0, nq, chunk):
            nc = min(chunk, nq - q0)
            rc = lib.art_dense_scores(
                q[q0].data_ptr(), rows.data_ptr(),
                int(rows.dtype == torch.bfloat16), mask_add.data_ptr(),
                out[q0].data_ptr(), nc, n, d, vec, stream)
            raise_on_error(rc, "dense_scores (K1)")
            dense_scores.launches += 1
    return out


dense_scores.launches = 0


def dense_topk_kernel(
    emb: torch.Tensor,                    # [N, D] bf16/f32
    queries: torch.Tensor,                # [Q, D] f32
    k: int,
    valid: Optional[torch.Tensor] = None,
    *,
    metric: str = "ip",
    normalize_queries: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k through K1 (same contract as ops.dense.dense_topk on
    the ip/cosine path; cosine rows are normalized at append)."""
    if metric not in ("ip", "cosine"):
        raise ValueError(f"unsupported metric for the scan kernel: {metric}")
    n = emb.shape[0]
    if n == 0:
        raise ValueError("dense_topk_kernel: empty corpus")
    q = queries.float()
    if metric == "cosine" and normalize_queries:
        q = l2_normalize(q)
    scores = dense_scores(q.contiguous(), emb,
                          mask_additive(valid, n, emb.device))
    return reduce_topk(scores, n, k)


# -- K2 ----------------------------------------------------------------------

def sq8_scores_plain(q_codes: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
    """[Q, N] = float(q_codes . codes) * scale + mask.  The integer dot is
    exact in f32 (|partial sums| < 2^24 for D <= 1024), so the result is
    bit-identical to the kernel's int32 dot."""
    acc = q_codes.float() @ codes.float().T
    return acc * scale[None, :] + mask_add[None, :]


def sq8_scores(q_codes: torch.Tensor, codes: torch.Tensor,
               scale: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
    """K2: int8 query codes [Q, D] against int8 row codes [N, D], times the
    row scale [N], plus the additive mask [N] -> [Q, N] f32."""
    if codes.device.type == "cpu":
        return sq8_scores_plain(q_codes, codes, scale, mask_add)
    from .. import _build

    n, d = codes.shape
    nq = q_codes.shape[0]
    dev = codes.device
    if d % 4 != 0:
        raise ValueError(f"K2 needs D divisible by 4 (dp4a words), got D={d}")
    check_cuda("codes", codes, torch.int8, (n, d), dev)
    check_cuda("q_codes", q_codes, torch.int8, (nq, d), dev)
    check_cuda("scale", scale, torch.float32, (n,), dev)
    check_cuda("mask_add", mask_add, torch.float32, (n,), dev)
    lib = _build.load()
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    vec = int(d % 16 == 0 and codes.data_ptr() % 16 == 0)
    chunk = query_chunk(d)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for q0 in range(0, nq, chunk):
            nc = min(chunk, nq - q0)
            # each chunk's codes start on a 4-byte word (D % 4 == 0)
            rc = lib.art_sq8_scores(
                q_codes[q0].data_ptr(), codes.data_ptr(), scale.data_ptr(),
                mask_add.data_ptr(), out[q0].data_ptr(), nc, n, d, vec, stream)
            raise_on_error(rc, "sq8_scores (K2)")
            sq8_scores.launches += 1
    return out


sq8_scores.launches = 0


def dense_topk_sq8_kernel(
    codes: torch.Tensor,                  # [N, D] int8
    scale: torch.Tensor,                  # [N] f32
    queries: torch.Tensor,                # [Q, D] f32
    k: int,
    valid: Optional[torch.Tensor] = None,
    *,
    metric: str = "ip",
    normalize_queries: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k through K2 (same contract as ops.quant.dense_topk_sq8).

    The query is quantized by the plain ``sq8_quantize``; its scale is
    positive, so it preserves the order and multiplies the k winners only
    (as ``dense_topk_sq8_pallas`` does)."""
    if metric not in ("ip", "cosine"):
        raise ValueError(f"sq8 supports ip/cosine, got: {metric}")
    n = codes.shape[0]
    if n == 0:
        raise ValueError("dense_topk_sq8_kernel: empty corpus")
    q = queries.float()
    if metric == "cosine" and normalize_queries:
        q = l2_normalize(q)
    q_codes, q_scale = sq8_quantize(q)
    scores = sq8_scores(q_codes.contiguous(), codes, scale,
                        mask_additive(valid, n, codes.device))
    top_s, top_i = reduce_topk(scores, n, k)
    top_s = torch.where(top_s <= NEG_INF, top_s, top_s * q_scale[:, None])
    return top_s, top_i


__all__ = [
    "dense_scores",
    "dense_scores_plain",
    "dense_topk_kernel",
    "sq8_scores",
    "sq8_scores_plain",
    "dense_topk_sq8_kernel",
    "query_chunk",
]
