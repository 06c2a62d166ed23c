"""Product-quantized (PQ) dense tier: the port of ``advanced_rag_tpu/ops/pq.py``.

D is split into ``m`` contiguous sub-vectors of ``D / m`` dims, each
quantized to its own ``c = 2**bits``-entry codebook; a row is stored as m
one-byte codes (96 bytes a row at D = 384, bits 4).  A query scores the
codes through per-query lookup tables (ADC):

    score(q, n) = sum_m LUT[q, m, codes[n, m]],  LUT[q, m, :] = q_m . codebook_m

The serving scan is kernel K6 (``ops/pq_kernels.py``: the table rounded to
bf16, an f32 sum); ``pq_scores_xla`` here is its plain version, the JAX
package's one-hot matmul.  ``pq_topk`` scans row superblocks with an exact
per-block top-k and ``merge_topk`` (the JAX default ``reduce="approx"`` is
TPU-only and exact on the CPU), so the [Q, N] matrix never exists whole.

Raw PQ ranking is approximate; the index over-retrieves and re-scores the
candidates exactly from the f32 host mirror (``IndexConfig.refine_factor``).

OPQ (``opq_train``) learns an orthogonal rotation R before the codebooks:
rows are encoded as ``x @ R`` and queries score as ``q @ R``, since
``q . x == (q R) . (x R)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .dense import NEG_INF, cdiv, merge_topk, topk_first


class PQCodebook(NamedTuple):
    codebooks: torch.Tensor   # [m, c, dsub] f32
    m: int
    bits: int

    @property
    def c(self) -> int:
        return 1 << self.bits

    @property
    def dsub(self) -> int:
        return int(self.codebooks.shape[-1])

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def auto_pq_m(dim: int, bits: int = 4) -> int:
    """Default geometry: ~1 stored bit per input dim (dsub = 4 at bits 4,
    8 at bits 8), clamped so dim % m == 0."""
    dsub = 4 if bits <= 4 else 8
    while dim % dsub:
        dsub //= 2
    return max(dim // dsub, 1)


def _assign_codes(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """x [m, B, dsub] against cb [m, c, dsub] -> nearest centroid [m, B]:
    argmax of x . cb - ||cb||^2 / 2 (the L2 nearest; ties to the lower)."""
    s = torch.bmm(x, cb.transpose(1, 2))                    # [m, B, c]
    s = s - 0.5 * torch.sum(cb * cb, dim=-1)[:, None, :]
    return torch.argmax(s, dim=-1)


def _pq_kmeans(x: torch.Tensor, init: torch.Tensor, *, c: int,
               iters: int = 12) -> torch.Tensor:
    """Euclidean Lloyd's over all m subspaces at once; empty clusters keep
    their centroid.  x [m, Nt, dsub] f32, init [m, c, dsub] f32."""
    m, nt, dsub = x.shape
    cb = init.float().clone()
    flat_x = x.reshape(m * nt, dsub)
    off = (torch.arange(m, device=x.device) * c)[:, None]
    ones = torch.ones(m * nt, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        a = (_assign_codes(x, cb) + off).reshape(-1)        # [m * Nt]
        sums = torch.zeros(m * c, dsub, device=x.device).index_add_(0, a, flat_x)
        counts = torch.zeros(m * c, device=x.device).index_add_(0, a, ones)
        sums, counts = sums.reshape(m, c, dsub), counts.reshape(m, c)
        cb = torch.where(counts[..., None] > 0,
                         sums / torch.clamp(counts[..., None], min=1.0), cb)
    return cb


def pq_train(
    emb_host: np.ndarray,     # [N, D] f32 (pre-normalized for cosine)
    m: int = 0,
    bits: int = 4,
    *,
    iters: int = 12,
    train_sample: int = 65536,
    seed: int = 0,
    device: DeviceLike = None,
) -> PQCodebook:
    """Train per-subspace codebooks on a sample of the host mirror (the
    sample and the init on the host, Lloyd's on ``device``: the card
    unless the caller passes ``device="cpu"``)."""
    emb_host = np.asarray(emb_host, np.float32)
    n, d = emb_host.shape
    m = m or auto_pq_m(d, bits)
    if d % m:
        raise ValueError(f"dim {d} not divisible by pq_m {m}")
    c = 1 << bits
    x = emb_host
    if n > train_sample:
        sel = np.random.default_rng(seed).choice(n, train_sample, replace=False)
        x = emb_host[sel]
    sub = np.ascontiguousarray(
        x.reshape(x.shape[0], m, d // m).transpose(1, 0, 2))  # [m, Nt, dsub]
    rng = np.random.default_rng(seed)
    pick = rng.choice(sub.shape[1], size=min(c, sub.shape[1]), replace=False)
    init = sub[:, pick]                                      # [m, <=c, dsub]
    if init.shape[1] < c:  # tiny corpora: tile
        reps = -(-c // init.shape[1])
        init = np.tile(init, (1, reps, 1))[:, :c]
    dev = resolve_device(device)
    cb = _pq_kmeans(torch.from_numpy(sub).to(dev),
                    torch.from_numpy(np.ascontiguousarray(init)).to(dev),
                    c=c, iters=iters)
    return PQCodebook(codebooks=cb, m=m, bits=bits)


def pq_encode_device(emb: torch.Tensor, codebooks: torch.Tensor,
                     rotation: Optional[torch.Tensor] = None, *,
                     block: int = 8192) -> torch.Tensor:
    """[N, D] (any float dtype, on its device) -> codes [N, m] int8
    (uint8 when c > 128), a block of rows at a time.  ``rotation`` [D, D]
    (OPQ) rotates each block after its cast to f32, as the JAX package
    does."""
    n, d = emb.shape
    m, c, dsub = codebooks.shape
    out_dt = torch.uint8 if c > 128 else torch.int8
    out = torch.empty((n, m), dtype=out_dt, device=emb.device)
    for s in range(0, n, block):
        xb = emb[s: s + block].float()
        if rotation is not None:
            xb = xb @ rotation
        out[s: s + block] = _assign_codes(xb.reshape(-1, m, dsub).transpose(0, 1),
                                          codebooks).T.to(out_dt)
    return out


def pq_encode(emb_host: np.ndarray, pq: PQCodebook) -> np.ndarray:
    """f32 [N, D] -> codes [N, m] on the host; the rows are rounded to bf16
    first, as the JAX package uploads them."""
    x = torch.from_numpy(np.asarray(emb_host, np.float32)).to(
        pq.codebooks.device).to(torch.bfloat16)
    return pq_encode_device(x, pq.codebooks).cpu().numpy()


def opq_train(
    emb_host: np.ndarray,     # [N, D] f32 (pre-normalized for cosine)
    m: int = 0,
    bits: int = 4,
    *,
    opq_iters: int = 8,
    pq_iters: int = 4,
    final_iters: int = 12,
    train_sample: int = 65536,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, PQCodebook]:
    """OPQ (Ge et al.): an orthogonal rotation R that lowers the PQ
    reconstruction error, and codebooks trained in the rotated space.

    The JAX package's alternation: train codebooks on X R (``pq_iters``
    Lloyd's rounds, seed ``seed + it``), encode and decode to X_hat, then
    solve the orthogonal Procrustes problem min_R ||X R - X_hat|| by
    R = U V^T of the SVD of X^T X_hat (U V^T does not depend on the signs
    the SVD gives its singular vectors).  Returns (R [D, D] f32 on
    ``device``, the codebooks over the rotated space); ``device`` is the
    card unless the caller passes ``device="cpu"``."""
    emb_host = np.asarray(emb_host, np.float32)
    n, d = emb_host.shape
    m = m or auto_pq_m(d, bits)
    x = emb_host
    if n > train_sample:
        sel = np.random.default_rng(seed).choice(n, train_sample, replace=False)
        x = emb_host[sel]
    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    r = torch.eye(d, dtype=torch.float32, device=dev)
    for it in range(opq_iters):
        xr = (xt @ r).cpu().numpy()
        pq = pq_train(xr, m, bits, iters=pq_iters, train_sample=train_sample,
                      seed=seed + it, device=dev)
        xhat = pq_decode(pq, torch.from_numpy(pq_encode(xr, pq)).to(dev))   # [Nt, D]
        u, _, vt = torch.linalg.svd(xt.T @ xhat, full_matrices=False)
        r = u @ vt
    pq = pq_train((xt @ r).cpu().numpy(), m, bits, iters=final_iters,
                  train_sample=train_sample, seed=seed, device=dev)
    return r, pq


def pq_decode(pq: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """codes [..., m] -> reconstructed vectors [..., D] f32."""
    sub = pq.codebooks[torch.arange(pq.m, device=codes.device),
                       codes.long() & (pq.c - 1)]             # [..., m, dsub]
    return sub.reshape(*codes.shape[:-1], pq.dim)


def pq_lut(pq: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """Per-query inner-product lookup tables -> [Q, m, c] f32."""
    q = queries.float()
    q_sub = q.reshape(q.shape[0], pq.m, pq.dsub)
    return torch.einsum("qmd,mcd->qmc", q_sub, pq.codebooks)


def pq_scores_xla(codes_blk: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The plain ADC: [B, m] codes x [Q, m, c] LUT -> [Q, B] f32, as the
    JAX package's one-hot matmul (bf16 operands, f32 accumulation)."""
    q, m, c = lut.shape
    b = codes_blk.shape[0]
    oh = torch.nn.functional.one_hot(codes_blk.long() & (c - 1), c).to(torch.float32)
    lut_b = lut.reshape(q, m * c).to(torch.bfloat16).float()
    return lut_b @ oh.reshape(b, m * c).T


def pq_topk(
    codebooks: torch.Tensor,              # [m, c, dsub] f32
    codes: torch.Tensor,                  # [N, m] int8/uint8
    queries: torch.Tensor,                # [Q, D] f32 (normalized upstream)
    k: int,
    valid: Optional[torch.Tensor] = None,  # [N] bool
    *,
    m: int,
    bits: int,
    block_size: int = 262144,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over PQ codes; same contract as dense_topk.

    Superblocks of rows (a multiple of 1024): score -> mask -> exact block
    top-k -> merge.  Bits <= 4 score through kernel K6 on the card
    (``pq_kernels.pq_scores``), bits 8 through the plain one-hot version, as
    in the JAX package."""
    from .pq_kernels import pq_scores

    pq = PQCodebook(codebooks=codebooks, m=m, bits=bits)
    n = codes.shape[0]
    if n == 0:
        raise ValueError("pq_topk: empty corpus")
    q = queries.float()
    lut = pq_lut(pq, q)                                      # [Q, m, c]
    inner = 1024
    bsz = min(block_size, max(inner, n))
    bsz = cdiv(bsz, inner) * inner
    nblocks = cdiv(n, bsz)
    dev = codes.device
    v = (valid[:n].to(torch.bool) if valid is not None
         else torch.ones(n, dtype=torch.bool, device=dev))
    num_q = q.shape[0]
    top_s = torch.full((num_q, k), NEG_INF, dtype=torch.float32, device=dev)
    top_i = torch.full((num_q, k), -1, dtype=torch.int32, device=dev)
    kk = min(k, bsz)
    for blk in range(nblocks):
        start = blk * bsz
        c_blk = codes[start: start + bsz]
        nb = c_blk.shape[0]
        s = pq_scores(c_blk, lut) if bits <= 4 else pq_scores_xla(c_blk, lut)
        ids = torch.arange(start, start + nb, dtype=torch.int32, device=dev)
        keep = v[start: start + nb]
        s = torch.where(keep[None, :], s, NEG_INF)
        blk_ids = torch.where(keep, ids, -1)
        if nb < bsz:   # the last superblock: padded rows score NEG_INF, id -1
            s = torch.nn.functional.pad(s, (0, bsz - nb), value=NEG_INF)
            blk_ids = torch.nn.functional.pad(blk_ids, (0, bsz - nb), value=-1)
        bs, sel = topk_first(s, kk)
        bi = blk_ids[sel]
        if kk < k:
            bs = torch.nn.functional.pad(bs, (0, k - kk), value=NEG_INF)
            bi = torch.nn.functional.pad(bi, (0, k - kk), value=-1)
        top_s, top_i = merge_topk(top_s, top_i, bs, bi, k)
    top_i = torch.where(top_s <= NEG_INF, -1, top_i)
    return top_s, top_i


__all__ = [
    "PQCodebook",
    "auto_pq_m",
    "pq_train",
    "opq_train",
    "pq_encode",
    "pq_encode_device",
    "pq_decode",
    "pq_lut",
    "pq_scores_xla",
    "pq_topk",
]
