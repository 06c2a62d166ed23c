"""SQ8 int8 scalar-quantized dense tier: the port of
``advanced_rag_tpu/ops/quant.py``.

Scheme: symmetric per-row scales.
    scale[i] = max|emb[i, :]| / 127        (f32, one per row)
    codes[i] = round(emb[i] / scale[i])    (int8, round half to even)
    score(q, i) ~= (q_scale * scale[i]) * dot(q_i8, codes[i])

Queries are quantized per row the same way, so the inner product is an
exact integer dot; the only approximation is the two roundings.  The
serving scan is kernel K2 (``ops/dense_kernels.py``); ``dense_topk_sq8``
here is the plain exact version, the counterpart of the JAX one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dense import l2_normalize, reduce_topk, NEG_INF


def sq8_quantize_host(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f32 [N, D] -> (codes int8 [N, D], scale f32 [N]) on the host."""
    emb = np.asarray(emb, np.float32)
    maxabs = np.max(np.abs(emb), axis=1)
    scale = np.maximum(maxabs, 1e-12) / 127.0
    codes = np.clip(np.rint(emb / scale[:, None]), -127, 127).astype(np.int8)
    return codes, scale.astype(np.float32)


def sq8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row quantization on the tensor's device (used for queries and
    appended rows).  ``torch.round`` rounds half to even, as ``jnp.round``
    and ``np.rint`` do."""
    x = x.float()
    maxabs = torch.max(torch.abs(x), dim=-1).values
    scale = torch.clamp(maxabs, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def sq8_block_scores(codes_blk: torch.Tensor, scale_blk: torch.Tensor,
                     q_codes: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    """Exact integer dot (in f32, exact for D <= 1024) -> [Q, B] f32."""
    acc = q_codes.float() @ codes_blk.float().T
    return acc * (q_scale[:, None] * scale_blk[None, :])


def dense_topk_sq8(
    codes: torch.Tensor,                   # [N, D] int8
    scale: torch.Tensor,                   # [N] f32
    queries: torch.Tensor,                 # [Q, D] f32
    k: int,
    valid: Optional[torch.Tensor] = None,  # [N] bool
    *,
    metric: str = "ip",                    # "ip" | "cosine" (rows pre-normalized)
    normalize_queries: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked exact top-k over int8 codes; same contract as dense_topk."""
    n = codes.shape[0]
    if n == 0:
        raise ValueError("dense_topk_sq8: empty corpus")
    if metric not in ("ip", "cosine"):
        raise ValueError(f"sq8 supports ip/cosine, got: {metric}")
    q = queries.float()
    if metric == "cosine" and normalize_queries:
        q = l2_normalize(q)
    q_codes, q_scale = sq8_quantize(q)
    s = sq8_block_scores(codes, scale, q_codes, q_scale)
    if valid is not None:
        s = torch.where(valid[None, :n].to(torch.bool), s, NEG_INF)
    return reduce_topk(s, n, k)


__all__ = [
    "sq8_quantize_host",
    "sq8_quantize",
    "sq8_block_scores",
    "dense_topk_sq8",
]
