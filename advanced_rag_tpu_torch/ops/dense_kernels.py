"""Dense-scan kernels K1 (bf16/f32 rows) and K2 (SQ8 rows): the port of
``advanced_rag_tpu/ops/pallas_dense.py``.

Each kernel (``csrc/dense_scan.cu``) writes the [Q, N] f32 score matrix
plus the additive row mask, and the top-k runs outside on that matrix, as
in the TPU wrappers.  Beside each kernel's wrapper sits its plain PyTorch
version.  The wrapper serves a CPU tensor with the plain version; for a
CUDA tensor it launches the kernel or raises.  ``<wrapper>.launches``
counts the kernel's launches.

K1 ``dense_scores`` replaces ``pallas_dense.py:_matmul_kernel`` (pallas_call
at :78) and K2 ``sq8_scores`` ``pallas_dense.py:_matmul_sq8_kernel``.  Both
are bound by bytes on the H100: N * D * itemsize of rows plus the [Q, N]
f32 output, over 3.35 TB/s.  Both stream row tiles into shared memory
with asynchronous copies and compute on the tensor cores: K1 on bf16 rows
against the query split into three bf16 parts (``split_query_bf16`` is the
plain version of the kernel's prologue), K2 as an int8 product; K1 on f32
rows uses CUDA-core FMAs on the same staged tiles.  The source note says
more.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .dense import NEG_INF, l2_normalize, mask_additive, reduce_topk
from .quant import sq8_quantize

#: Largest query chunk one launch takes (``ART_QMAX`` in kernels.cu).
QMAX = 32
#: Shared memory a block may opt in to (227 KB), and the bytes of one staged
#: row in the dense scans' ring of row tiles (128 + 16 pad).
SCAN_SMEM_MAX = 232448
SCAN_STAGE_ROW = 144


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def scan_plan(kind: str, qc: int, d: int) -> Tuple[int, int]:
    """(rows per tile, shared-memory bytes) of one dense-scan launch over
    ``qc`` queries, as ``tile_rows`` and ``scan_smem_bytes`` in
    dense_scan.cu work them out: a ring of 4 stages of tile rows x 144
    bytes, then the queries (three bf16 parts for ``kind="bf16"``, int8
    codes for "int8", f32 values for "f32"); 32 bf16 or f32 queries take
    256-row tiles where those fit 227 KB, everything else 128."""
    if kind == "bf16":
        queries = 3 * qc * (2 * _round_up(d, 64) + 16)
    elif kind == "int8":
        queries = qc * (_round_up(d, 128) + 16)
    elif kind == "f32":
        queries = _round_up(d, 32) * qc * 4
    else:
        raise ValueError(f"unknown scan kind: {kind}")
    big = 4 * 256 * SCAN_STAGE_ROW + queries
    if qc == 32 and kind != "int8" and big <= SCAN_SMEM_MAX:
        return 256, big
    return 128, 4 * 128 * SCAN_STAGE_ROW + queries


def scan_chunk(kind: str, d: int) -> int:
    """Queries per dense-scan launch: the largest of 32, 16, 8 whose shared
    memory fits SCAN_SMEM_MAX (a launch of fewer queries rounds up to the
    next of these).  Where not even 8 bf16 or f32 queries fit, 32: such
    rows are scanned in slices of D (``scan_width``), so the rows are read
    once for up to 32 queries.  The SQ8 scan (int8) takes no slices."""
    for qc in (QMAX, 16, 8):
        if scan_plan(kind, qc, d)[1] <= SCAN_SMEM_MAX:
            return qc
    if kind in ("bf16", "f32"):
        return QMAX
    raise ValueError(f"D={d} is too wide for the {kind} dense scan: 8 queries "
                     f"need {scan_plan(kind, 8, d)[1]} bytes of shared "
                     f"memory, more than {SCAN_SMEM_MAX}")


def launch_qc(nq: int) -> int:
    """The query block a launch of ``nq`` queries compiles for (8, 16, 32:
    ``dispatch_scan`` in dense_scan.cu)."""
    return 8 if nq <= 8 else 16 if nq <= 16 else QMAX


def scan_width(kind: str, qc: int, d: int) -> int:
    """Values of each row one launch of a ``qc`` block scans: ``d`` where
    the whole row's queries fit SCAN_SMEM_MAX, else the width of the
    fewest equal slices (whole 128-byte stage rows, 64 bf16 or 32 f32
    values) that fit; the last slice takes the rest."""
    if scan_plan(kind, qc, d)[1] <= SCAN_SMEM_MAX:
        return d
    align = {"bf16": 64, "f32": 32}[kind]
    widest = d // align * align
    while widest > align and scan_plan(kind, qc, widest)[1] > SCAN_SMEM_MAX:
        widest -= align
    slices = -(-d // widest)
    return _round_up(-(-d // slices), align)


def scan_launches(kind: str, nq: int, d: int) -> List[Tuple[int, int, int, int]]:
    """The launches of one K1 call, in order: (first query, queries, first
    value, values) of each; the first launch of a query chunk writes its
    scores plus the mask, a later slice of it adds into them."""
    chunk = scan_chunk(kind, d)
    out = []
    for q0 in range(0, nq, chunk):
        nc = min(chunk, nq - q0)
        width = scan_width(kind, launch_qc(nc), d)
        out += [(q0, nc, k0, min(width, d - k0)) for k0 in range(0, d, width)]
    return out


def aligned_rows(rows: torch.Tensor) -> int:
    """1 when every row starts on 16 bytes (the kernels' cp.async path),
    else 0 (staged by element copies)."""
    return int(rows.shape[1] * rows.element_size() % 16 == 0
               and rows.data_ptr() % 16 == 0)


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


def split_query_bf16(q: torch.Tensor) -> torch.Tensor:
    """f32 [Q, D] -> bf16 [3, Q, D] parts (hi, mid, lo) with
    hi + mid + lo == q to about 2^-24 |q|: the split that K1's prologue
    makes for the tensor cores on bf16 rows (round to nearest even; each
    difference is exact in f32)."""
    q = q.float()
    hi = q.to(torch.bfloat16)
    r1 = q - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return torch.stack((hi, mid, lo))


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
    bf16 = rows.dtype == torch.bfloat16
    vec = aligned_rows(rows)
    item = rows.element_size()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for q0, nc, k0, kw in scan_launches("bf16" if bf16 else "f32", nq, d):
            # a slice starts on a whole stage row, so it keeps the rows'
            # 16-byte alignment
            rc = lib.art_dense_scores(
                q[q0].data_ptr() + 4 * k0, rows.data_ptr() + item * k0, int(bf16),
                mask_add.data_ptr() if k0 == 0 else None, out[q0].data_ptr(), nc, n,
                kw, d, int(k0 > 0), vec, stream)
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
        raise ValueError(f"K2 needs D divisible by 4 (query code words), got D={d}")
    check_cuda("codes", codes, torch.int8, (n, d), dev)
    check_cuda("q_codes", q_codes, torch.int8, (nq, d), dev)
    check_cuda("scale", scale, torch.float32, (n,), dev)
    check_cuda("mask_add", mask_add, torch.float32, (n,), dev)
    lib = _build.load()
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    vec = aligned_rows(codes)
    chunk = scan_chunk("int8", d)
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
    "launch_qc",
    "scan_chunk",
    "scan_launches",
    "scan_plan",
    "scan_width",
    "split_query_bf16",
]
