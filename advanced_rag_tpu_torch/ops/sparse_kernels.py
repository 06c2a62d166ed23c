"""BM25 compare-scan kernel K3 (and its ``ip`` mode, K3-ip): the port of
``advanced_rag_tpu/ops/pallas_sparse.py``.

The kernel (``csrc/kernels.cu``) reads the term-slot-major [P, N] mirror
that ``index/sparse_index.py`` keeps on the device, one thread per row, and
writes the [Q, N] f32 score matrix plus the additive row mask; the top-k
runs outside.  ``bm25_scores`` replaces ``pallas_sparse.py:_bm25_kernel``
and, with ``scoring="ip"``, ``_ip_kernel`` (pallas_call at :164): one
kernel, one flag.  The query weights (``q_tf * idf``) and the average
length are computed by plain PyTorch in the wrapper, as the TPU wrapper
does.  Bound on the H100: see the kernel's source note (bytes at Q = 1,
operations at Q = 32 on the main path's shapes).

The wrapper serves a CPU tensor with ``bm25_scores_plain``; for a CUDA
tensor it launches the kernel or raises.  ``bm25_scores.launches`` counts
the kernel's launches and ``bm25_scores.ip_launches`` those in ip mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .dense import mask_additive, reduce_topk
from .dense_kernels import check_cuda, raise_on_error, query_chunk
from .sparse import live_avg_len, query_weights


def bm25_scores_plain(q_idx: torch.Tensor, q_w: torch.Tensor,
                      idx_t: torch.Tensor, tf_t: torch.Tensor,
                      doc_len: torch.Tensor, mask_add: torch.Tensor,
                      k1: float, b: float, avg_len: float,
                      scoring: str = "bm25") -> torch.Tensor:
    """The kernel's function in plain PyTorch -> [Q, N] f32.

    Per slot ``tfw`` (zero on padding slots), then per query the compare
    sum over its T terms, as ``pallas_sparse.py:_bm25_kernel`` writes it."""
    tf = tf_t.float()
    if scoring == "bm25":
        denom = tf + k1 * (1.0 - b + b * doc_len.float()[None, :]
                           / max(avg_len, 1.0))
        tfw = tf * (k1 + 1.0) / torch.clamp(denom, min=1e-6)
    elif scoring == "ip":
        tfw = tf
    else:
        raise ValueError(f"unknown scoring: {scoring}")
    tfw = torch.where(idx_t >= 0, tfw, 0.0)                     # [P, N]
    out = torch.empty((q_idx.shape[0], idx_t.shape[1]), dtype=torch.float32,
                      device=idx_t.device)
    for q in range(q_idx.shape[0]):
        eq = idx_t[None, :, :] == q_idx[q, :, None, None]       # [T, P, N]
        m = torch.sum(torch.where(eq, q_w[q, :, None, None], 0.0), dim=0)
        out[q] = torch.sum(tfw * m, dim=0) + mask_add
    return out


def bm25_scores(q_idx: torch.Tensor, q_w: torch.Tensor,
                idx_t: torch.Tensor, tf_t: torch.Tensor,
                doc_len: torch.Tensor, mask_add: torch.Tensor,
                k1: float, b: float, avg_len: float,
                scoring: str = "bm25") -> torch.Tensor:
    """K3 / K3-ip: query terms [Q, T] (i32 ids, f32 weights) against the
    [P, N] slot mirror (i32 ids, f32 tf), doc lengths [N] and the additive
    mask [N] -> [Q, N] f32."""
    if idx_t.device.type == "cpu":
        return bm25_scores_plain(q_idx, q_w, idx_t, tf_t, doc_len, mask_add,
                                 k1, b, avg_len, scoring)
    from .. import _build

    if scoring not in ("bm25", "ip"):
        raise ValueError(f"unknown scoring: {scoring}")
    p, n = idx_t.shape
    nq, t = q_idx.shape
    dev = idx_t.device
    check_cuda("idx_t", idx_t, torch.int32, (p, n), dev)
    check_cuda("tf_t", tf_t, torch.float32, (p, n), dev)
    check_cuda("doc_len", doc_len, torch.float32, (n,), dev)
    check_cuda("mask_add", mask_add, torch.float32, (n,), dev)
    check_cuda("q_idx", q_idx, torch.int32, (nq, t), dev)
    check_cuda("q_w", q_w, torch.float32, (nq, t), dev)
    lib = _build.load()
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    chunk = query_chunk(8 * t + 4)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for q0 in range(0, nq, chunk):
            nc = min(chunk, nq - q0)
            rc = lib.art_bm25_scores(
                q_idx[q0].data_ptr(), q_w[q0].data_ptr(), idx_t.data_ptr(),
                tf_t.data_ptr(), doc_len.data_ptr(), mask_add.data_ptr(),
                out[q0].data_ptr(), nc, t, p, n, float(k1), float(b),
                float(avg_len), int(scoring == "ip"), stream)
            raise_on_error(rc, "bm25_scores (K3)")
            bm25_scores.launches += 1
            if scoring == "ip":
                bm25_scores.ip_launches += 1
    return out


bm25_scores.launches = 0       # every launch of the kernel
bm25_scores.ip_launches = 0    # the launches in ip mode (K3-ip)


def sparse_topk_kernel(
    idx_t: torch.Tensor,     # [P, N] i32 term-slot-major ids (-1 pad)
    tf_t: torch.Tensor,      # [P, N] f32
    doc_len: torch.Tensor,   # [N] f32
    df: torch.Tensor,        # [V]
    n_docs: torch.Tensor,    # scalar
    q_idx: torch.Tensor,     # [Q, T] i32 (-1 pad)
    q_tf: torch.Tensor,      # [Q, T] f32
    k: int,
    valid: Optional[torch.Tensor] = None,
    avg_len: Optional[torch.Tensor] = None,
    *,
    scoring: str = "bm25",
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked sparse top-k through K3 (same contract as
    ops.sparse.sparse_topk, over the [P, N] mirror)."""
    n = idx_t.shape[1]
    if n == 0:
        raise ValueError("sparse_topk_kernel: empty corpus")
    q_w = query_weights(q_idx, q_tf, df, n_docs, scoring)
    if avg_len is None:
        avg_len = live_avg_len(doc_len, valid)
    scores = bm25_scores(q_idx.to(torch.int32).contiguous(), q_w.contiguous(),
                         idx_t, tf_t, doc_len,
                         mask_additive(valid, n, idx_t.device),
                         k1, b, float(avg_len), scoring)
    return reduce_topk(scores, n, k)


__all__ = ["bm25_scores", "bm25_scores_plain", "sparse_topk_kernel"]
