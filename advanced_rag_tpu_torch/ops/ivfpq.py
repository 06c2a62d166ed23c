"""IVF-PQ: coarse k-means partitions plus product-quantized residuals.
The port of ``advanced_rag_tpu/ops/ivfpq.py``.

The top rung of the dense capacity ladder (bf16 -> SQ8 -> flat PQ ->
IVF-PQ).  A query scores ``nprobe`` of ``nlist`` partitions instead of
every code, and the codes quantize the residual ``r = x - centroid[p]`` of
each row's partition ``p`` rather than ``x``, so the same bits spend their
resolution on what the coarse quantizer left.  The score decomposes
exactly for inner product (cosine rows are normalized upstream):

    q . x  =  q . centroid[p]  +  q . r

so a query costs one centroid product (which probe selection needs anyway)
plus the ADC of its residual lookup table over the probed partitions'
codes.  The ADC is kernel K6's function, ``sum_m LUT_bf16[q, m,
code[n, m]]`` in f32, and one table per query serves every partition: on
the card it runs through K6 (``ops/pq_kernels.py``), on the CPU through the
plain one-hot version (``ops/pq.py:pq_scores_xla``), in row blocks so that
the one-hot transient stays bounded.  Bits 8 (256 codes a subspace, beyond
K6) take the plain version on the card too, as flat PQ does.

K6 takes the probed partitions grouped: the batch's distinct probed
partitions are scored once, for every query of the batch (one K6 call over
their codes, gathered unless every partition is probed), and each query
then takes its own probes' scores, the grouping of K5's grouped route.
One K6 call a query over its own probed partitions was level with it at
Q = 1 and slower at Q = 8 and 32 on the H100 at 1M rows (PERF.md § 6).

Appends stay in the same geometry: new rows are assigned and residual-
encoded on the device into a flat tail (codes, row ids and partitions)
that every query scores with the same ADC plus its partition term; a
maintenance rebuild re-packs the tail into the partitions.

Layout (the JAX package's):
- ``centroids``    [nlist, D] f32
- ``codebooks``    [m, c, dsub] f32 (residual codebooks, shared)
- ``packed_codes`` [nlist, cap, m] int8 (cap = factor * N / nlist, code 0
  in padding slots)
- ``packed_rows``  [nlist, cap] i32, -1 = padding
- ``tail_codes``   [Tcap, m] int8, ``tail_rows`` [Tcap] i32 (-1 = free),
  ``tail_assign``  [Tcap] i32

Codes are int8 at every ``bits``, as in JAX: codes of 128 and more (bits 8)
wrap, and the ADC reads them back masked to ``c - 1``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .dense import NEG_INF, merge_topk, topk_first
from .ivf import kmeans_fit, kmeans_init
from .pq import PQCodebook, _assign_codes, _pq_kmeans, auto_pq_m, pq_lut, pq_scores_xla

#: Rows of codes one plain-version ADC block scores: its one-hot operand is
#: [rows, m * c] f32, about 512 MB at the most.
PLAIN_ONEHOT_ELEMS = 1 << 27


class IVFPQIndex(NamedTuple):
    centroids: torch.Tensor      # [nlist, D] f32
    codebooks: torch.Tensor      # [m, c, dsub] f32 residual codebooks
    packed_codes: torch.Tensor   # [nlist, cap, m] int8
    packed_rows: torch.Tensor    # [nlist, cap] i32, -1 = pad
    tail_codes: torch.Tensor     # [Tcap, m] int8 (appended rows)
    tail_rows: torch.Tensor      # [Tcap] i32, -1 = free slot
    tail_assign: torch.Tensor    # [Tcap] i32 partition of each tail row


# -- fused assign + residual encode ---------------------------------------------

def _assign_encode_block(xb: torch.Tensor, centroids: torch.Tensor,
                         codebooks: torch.Tensor, nlist: int, *,
                         c_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb [B, D] (any float dtype) against the zero-padded centroids
    [nlist_pad, D] f32 -> (partition [B] i32, residual codes [B, m] int8).

    A running argmax over centroid chunks of ``c_chunk`` (columns past
    ``nlist`` masked to -inf; a later chunk wins only when strictly better,
    so ties keep the first maximum), then the nearest residual
    sub-centroids."""
    b = xb.shape[0]
    m, c, dsub = codebooks.shape
    x = xb.float()
    best_s = torch.full((b,), float("-inf"), device=x.device)
    best_i = torch.zeros(b, dtype=torch.int64, device=x.device)
    for j in range(0, centroids.shape[0], c_chunk):
        s = x @ centroids[j: j + c_chunk].T
        col = torch.arange(j, j + s.shape[1], device=x.device)
        s = torch.where(col[None, :] < nlist, s, float("-inf"))
        val, loc = torch.max(s, dim=1)
        better = val > best_s
        best_s = torch.where(better, val, best_s)
        best_i = torch.where(better, loc + j, best_i)
    r = x - centroids[best_i]
    codes = _assign_codes(r.reshape(b, m, dsub).transpose(0, 1), codebooks).T
    return best_i.to(torch.int32), codes.to(torch.int8)


def _pad_centroids(cent: np.ndarray, c_chunk: int) -> np.ndarray:
    nlist = cent.shape[0]
    c_pad = -(-nlist // c_chunk) * c_chunk
    return np.pad(cent, ((0, c_pad - nlist), (0, 0)))


def _c_chunk(nlist: int) -> int:
    return min(2048, max(8, nlist))


# -- build ---------------------------------------------------------------------

def build_ivfpq(
    emb_host: np.ndarray,       # [N, D] f32 (pre-normalized for cosine)
    nlist: int,
    *,
    m: int = 0,
    bits: int = 4,
    kmeans_iters: int = 16,
    pq_iters: int = 12,
    train_sample: int = 262144,
    capacity_factor: float = 2.0,
    tail_capacity: int = 8192,
    seed: int = 0,
    centroids: Optional[np.ndarray] = None,     # skip the coarse training
    codebooks=None,                             # skip the residual training
    device: DeviceLike = None,
) -> IVFPQIndex:
    """Coarse k-means -> residual PQ codebooks -> encode on ``device`` (the
    card unless the caller passes ``device="cpu"``) -> partition packing.
    Rows past a partition's cap land in the tail, residual-coded and scored
    every query.  ``centroids`` / ``codebooks`` re-pack with fixed
    quantizers (a checkpoint restore: the codes stay comparable)."""
    dev = resolve_device(device)
    emb_host = np.asarray(emb_host, np.float32)
    n, d = emb_host.shape
    m = m or auto_pq_m(d, bits)
    if d % m:
        raise ValueError(f"dim {d} not divisible by pq_m {m}")
    c = 1 << bits
    # one generator serves the sample choice, then the codebooks' initial pick
    rng = np.random.default_rng(seed)

    x = emb_host
    if n > train_sample:
        sel = rng.choice(n, train_sample, replace=False)
        x = emb_host[sel]
    x_dev = None
    if centroids is not None:
        cent = np.array(centroids, np.float32)
        nlist = cent.shape[0]
    else:
        x_dev = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        cent = kmeans_fit(x_dev, torch.from_numpy(kmeans_init(x, nlist, seed)).to(dev),
                          nlist=nlist, iters=kmeans_iters).cpu().numpy()

    c_chunk = _c_chunk(nlist)
    cent_pad = torch.from_numpy(_pad_centroids(cent, c_chunk)).to(dev)

    if codebooks is None:
        # residual codebooks, trained on the sample's residuals (formed on
        # the device: the same f32 subtraction as the host's)
        if x_dev is None:
            x_dev = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        s_assign, _ = _assign_encode_block(x_dev, cent_pad,
                                           torch.zeros((m, c, d // m), device=dev), nlist,
                                           c_chunk=c_chunk)
        sub = (x_dev - cent_pad[s_assign.long()]).reshape(-1, m, d // m).transpose(0, 1)
        sub = sub.contiguous()                                 # [m, Nt, dsub]
        pick = rng.choice(sub.shape[1], size=min(c, sub.shape[1]), replace=False)
        init = sub[:, torch.from_numpy(pick).to(dev)]
        if init.shape[1] < c:
            reps = -(-c // init.shape[1])
            init = init.repeat(1, reps, 1)[:, :c]
        codebooks = _pq_kmeans(sub, init, c=c, iters=pq_iters)
        del sub
    else:
        codebooks = (codebooks if torch.is_tensor(codebooks)
                     else torch.from_numpy(np.array(codebooks, np.float32))).float().to(dev)

    # assign and encode every row on the device, a block at a time (the
    # sub-centroid scores of a block, [m, block, c] f32, held to 1 GiB); the
    # partitions and codes come back to the host for the packing
    assign = np.zeros((n,), np.int32)
    codes = np.zeros((n, m), np.int8)
    block = max(1024, min(262144, (1 << 28) // (m * c)))
    for start in range(0, n, block):
        xb = torch.from_numpy(emb_host[start: start + block]).to(dev)
        a_b, c_b = _assign_encode_block(xb, cent_pad, codebooks, nlist, c_chunk=c_chunk)
        assign[start: start + block] = a_b.cpu().numpy()
        codes[start: start + block] = c_b.cpu().numpy()

    # vectorized packing, as ops/ivf.py build_ivf (cap not rounded here)
    cap = max(8, int(np.ceil(capacity_factor * n / nlist)))
    packed_rows = np.full((nlist, cap), -1, np.int32)
    order = np.argsort(assign, kind="stable").astype(np.int64)
    sorted_c = assign[order]
    first = np.searchsorted(sorted_c, np.arange(nlist))
    pos = np.arange(n, dtype=np.int64) - first[sorted_c]
    keep = pos < cap
    packed_rows[sorted_c[keep], pos[keep]] = order[keep].astype(np.int32)
    over = order[~keep].astype(np.int32)

    gather = np.where(packed_rows >= 0, packed_rows, 0)
    packed_codes = codes[gather.reshape(-1)].reshape(nlist, cap, m)
    packed_codes[packed_rows < 0] = 0

    t_cap = max(tail_capacity, 1 << max(int(len(over)) - 1, 0).bit_length())
    tail_codes = np.zeros((t_cap, m), np.int8)
    tail_rows = np.full((t_cap,), -1, np.int32)
    tail_assign = np.zeros((t_cap,), np.int32)
    if len(over):
        tail_codes[: len(over)] = codes[over]
        tail_rows[: len(over)] = over
        tail_assign[: len(over)] = assign[over]

    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return IVFPQIndex(centroids=up(cent), codebooks=codebooks,
                      packed_codes=up(packed_codes), packed_rows=up(packed_rows),
                      tail_codes=up(tail_codes), tail_rows=up(tail_rows),
                      tail_assign=up(tail_assign))


# -- streaming appends -------------------------------------------------------------

def ivfpq_append_tail(idx: IVFPQIndex, vectors: torch.Tensor, row_ids: torch.Tensor,
                      tail_fill: int) -> IVFPQIndex:
    """Assign and residual-encode ``vectors`` [B, D] (on the index's
    device) and write them into the tail at ``tail_fill``; the tail doubles
    while it is too small.  Returns the index (the caller tracks
    ``tail_fill + B``)."""
    b = vectors.shape[0]
    t_cap = idx.tail_codes.shape[0]
    need = tail_fill + b
    if need > t_cap:
        new_cap = t_cap
        while new_cap < need:
            new_cap *= 2
        grow = new_cap - t_cap
        pad = torch.nn.functional.pad
        idx = idx._replace(
            tail_codes=pad(idx.tail_codes, (0, 0, 0, grow)),
            tail_rows=pad(idx.tail_rows, (0, grow), value=-1),
            tail_assign=pad(idx.tail_assign, (0, grow)))
    nlist = idx.centroids.shape[0]
    c_chunk = _c_chunk(nlist)
    c_pad = -(-nlist // c_chunk) * c_chunk
    cent_pad = torch.nn.functional.pad(idx.centroids, (0, 0, 0, c_pad - nlist))
    a_b, c_b = _assign_encode_block(vectors, cent_pad, idx.codebooks, nlist,
                                    c_chunk=c_chunk)
    idx.tail_codes[tail_fill: need] = c_b
    idx.tail_rows[tail_fill: need] = row_ids.to(torch.int32)
    idx.tail_assign[tail_fill: need] = a_b
    return idx


# -- search ------------------------------------------------------------------------

def _adc(codes: torch.Tensor, lut: torch.Tensor, bits: int) -> torch.Tensor:
    """sum_m LUT_bf16[q, m, codes[n, m]] -> [Q, N] f32: K6 on the card
    (bits <= 4), else the plain one-hot version in blocks of rows."""
    from .pq_kernels import pq_scores

    if bits <= 4 and codes.device.type == "cuda":
        return pq_scores(codes, lut)
    fn = pq_scores if bits <= 4 else pq_scores_xla
    q, m, c = lut.shape
    rows = max(1, PLAIN_ONEHOT_ELEMS // (m * c))
    if codes.shape[0] <= rows:
        return fn(codes, lut)
    return torch.cat([fn(codes[s: s + rows], lut) for s in range(0, codes.shape[0], rows)],
                     dim=1)


def _probed_adc(idx: IVFPQIndex, lut: torch.Tensor, probe: torch.Tensor,
                bits: int) -> torch.Tensor:
    """The ADC of each query's probed partitions -> [Q, nprobe, cap] f32,
    each distinct probed partition scored once for the whole batch."""
    nlist, cap, m = idx.packed_codes.shape
    nq, nprobe = probe.shape
    uniq, inv = torch.unique(probe.long(), return_inverse=True)
    if uniq.shape[0] == nlist:       # every partition probed: no gather
        codes = idx.packed_codes.reshape(nlist * cap, m)
    else:
        codes = idx.packed_codes[uniq].reshape(-1, m)
    s = _adc(codes, lut, bits).reshape(nq, uniq.shape[0], cap)
    return torch.gather(s, 1, inv[:, :, None].expand(nq, nprobe, cap))


def ivfpq_topk(
    idx: IVFPQIndex,
    queries: torch.Tensor,                 # [Q, D] f32 (normalized upstream)
    k: int,
    valid: Optional[torch.Tensor] = None,  # [N_capacity] bool, original rows
    *,
    nprobe: int = 32,
    m: int,
    bits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked IVF-PQ top-k -> (scores [Q, k], original row ids [Q, k]).

    score = q . centroid[p] (a plain f32 product) + the ADC of the query's
    residual table, over its ``nprobe`` closest partitions; rows masked by
    ``packed_rows >= 0`` and ``valid``; ties to the lower flat (probe,
    slot) index, as ``lax.top_k``.  The tail goes through the same ADC with
    each row's own partition term and is merged last."""
    q = queries.float()
    nq = q.shape[0]
    nlist, cap, _ = idx.packed_codes.shape
    c_scores = q @ idx.centroids.T                             # [Q, nlist]
    nprobe = min(nprobe, nlist)
    probe_s, probe = topk_first(c_scores, nprobe)              # [Q, nprobe]
    lut = pq_lut(ivfpq_codebook(idx, bits=bits), q)            # [Q, m, c]
    if lut.shape[1] != m:
        raise ValueError(f"the codebooks have m={lut.shape[1]}, not {m}")

    s = _probed_adc(idx, lut, probe, bits) + probe_s[:, :, None]
    pr = idx.packed_rows[probe.long()]                         # [Q, nprobe, cap]
    ok = pr >= 0
    if valid is not None:
        ok = ok & valid.to(torch.bool)[torch.clamp(pr, min=0).long()]
    flat_s = torch.where(ok, s, NEG_INF).reshape(nq, -1)
    flat_r = torch.where(ok, pr, -1).reshape(nq, -1)
    kq = min(k, flat_s.shape[1])
    top_s, sel = topk_first(flat_s, kq)
    top_i = torch.gather(flat_r, 1, sel)
    if kq < k:
        top_s = torch.nn.functional.pad(top_s, (0, k - kq), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, k - kq), value=-1)

    # the tail: the same ADC over the flat appended codes, all queries at once
    t_cap = idx.tail_codes.shape[0]
    ts = _adc(idx.tail_codes, lut, bits) + torch.gather(
        c_scores, 1, torch.clamp(idx.tail_assign, min=0).long()[None, :].expand(nq, t_cap))
    ok = idx.tail_rows >= 0
    if valid is not None:
        ok = ok & valid.to(torch.bool)[torch.clamp(idx.tail_rows, min=0).long()]
    ts = torch.where(ok[None, :], ts, NEG_INF)
    kk = min(k, t_cap)
    tail_s, sel = topk_first(ts, kk)
    tail_i = torch.where(tail_s <= NEG_INF, -1, idx.tail_rows[sel])
    if kk < k:
        tail_s = torch.nn.functional.pad(tail_s, (0, k - kk), value=NEG_INF)
        tail_i = torch.nn.functional.pad(tail_i, (0, k - kk), value=-1)
    top_s, top_i = merge_topk(top_s, top_i, tail_s, tail_i, k)
    return top_s, torch.where(top_s <= NEG_INF, -1, top_i)


def ivfpq_codebook(idx: IVFPQIndex, *, bits: int) -> PQCodebook:
    """The residual codebooks as a PQCodebook (for the tables and decode)."""
    return PQCodebook(codebooks=idx.codebooks, m=int(idx.codebooks.shape[0]), bits=bits)


__all__ = [
    "IVFPQIndex",
    "build_ivfpq",
    "ivfpq_append_tail",
    "ivfpq_topk",
    "ivfpq_codebook",
]
