"""IVF (inverted-file) partitioned search: the port of
``advanced_rag_tpu/ops/ivf.py``.

A k-means coarse quantizer plus packed partitions: a query scores the
``nprobe`` partitions whose centroids it is closest to instead of the whole
corpus.  Layout (the JAX package's, kept exactly so the tests compare like
with like):

- ``centroids [nlist, D]`` f32, trained by Lloyd's iterations;
- ``packed_emb [nlist, cap, D]`` in the storage dtype (bf16, f32 or int8
  codes with ``packed_scale [nlist, cap]``); each partition padded to the
  same capacity (a multiple of 8), zero rows as padding;
- ``packed_rows [nlist, cap]`` i32 original row ids (-1 pad);
- rows that overflow a full partition spill into ``tail_emb``/``tail_rows``,
  scanned exactly every query.

``ivf_topk`` on a CUDA tensor scores the probed slabs through kernel K5
(``ops/ivf_kernels.py``); on a CPU tensor it runs the plain
``[Q, nprobe, cap, D]`` gather version below, the counterpart of the JAX
function.  Validity and filter masks apply through ``valid[packed_rows]``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .dense import NEG_INF, merge_topk, topk_first
from .quant import sq8_quantize, sq8_quantize_host


class IVFPartitions(NamedTuple):
    centroids: torch.Tensor     # [nlist, D] f32
    packed_emb: torch.Tensor    # [nlist, cap, D] bf16/f32/int8
    packed_rows: torch.Tensor   # [nlist, cap] i32, -1 pad
    tail_emb: torch.Tensor      # [T, D] overflow rows (brute-forced)
    tail_rows: torch.Tensor     # [T] i32
    packed_scale: Optional[torch.Tensor] = None  # [nlist, cap] f32 (SQ8)
    tail_scale: Optional[torch.Tensor] = None    # [T] f32 (SQ8)


# -- k-means training -----------------------------------------------------------

def kmeans_fit(x: torch.Tensor, init: torch.Tensor, *, nlist: int,
               iters: int = 16, block: int = 65536) -> torch.Tensor:
    """Lloyd's iterations on inner-product assignment; empty clusters keep
    their centroid.  ``x`` [M, D] f32, ``init`` [nlist, D] f32."""
    x = x.float()
    c = init.float().clone()
    m = x.shape[0]
    for _ in range(iters):
        a = torch.cat([torch.argmax(x[s: s + block] @ c.T, dim=1)
                       for s in range(0, m, block)])
        sums = torch.zeros_like(c).index_add_(0, a, x)
        counts = torch.zeros(nlist, dtype=torch.float32,
                             device=x.device).index_add_(
            0, a, torch.ones(m, dtype=torch.float32, device=x.device))
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts[:, None], min=1.0), c)
    return c


def kmeans_init(x: np.ndarray, nlist: int, seed: int = 0) -> np.ndarray:
    """k-means++-lite init: random distinct points (host-side)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], size=min(nlist, x.shape[0]), replace=False)
    init = x[idx]
    if init.shape[0] < nlist:  # tiny corpora: tile
        reps = -(-nlist // init.shape[0])
        init = np.tile(init, (reps, 1))[:nlist]
    return init.astype(np.float32)


# -- build ------------------------------------------------------------------------

_STORAGE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _assign(x_dev: torch.Tensor, cent: torch.Tensor, nlist: int) -> torch.Tensor:
    """Nearest centroid of every row: a running argmax over centroid chunks
    of 2048 (the [rows, nlist] matrix never exists whole), rows in blocks
    of 262144; a later chunk wins only when strictly better."""
    c_chunk = min(2048, nlist)
    out = []
    for s in range(0, x_dev.shape[0], 262144):
        xb = x_dev[s: s + 262144]
        best_s = torch.full((xb.shape[0],), float("-inf"), device=xb.device)
        best_i = torch.zeros(xb.shape[0], dtype=torch.int64, device=xb.device)
        for j in range(0, nlist, c_chunk):
            val, loc = torch.max(xb @ cent[j: j + c_chunk].T, dim=1)
            better = val > best_s
            best_s = torch.where(better, val, best_s)
            best_i = torch.where(better, loc + j, best_i)
        out.append(best_i)
    return torch.cat(out)


def build_ivf(
    emb_host: np.ndarray,      # [N, D] f32 (pre-normalized for cosine)
    nlist: int,
    *,
    dtype: str = "bfloat16",
    kmeans_iters: int = 16,
    train_sample: int = 262144,
    capacity_factor: float = 2.0,
    seed: int = 0,
    device: DeviceLike = None,
) -> IVFPartitions:
    """Train + pack.  cap = factor * N / nlist rounded up to a multiple of
    8; rows beyond a partition's capacity spill to the exactly scanned
    tail.  k-means and the assignment run on ``device``; the sample, the
    init and the packing run on the host, as in the JAX package."""
    dev = resolve_device(device)
    emb_host = np.asarray(emb_host, np.float32)
    n, d = emb_host.shape
    x = emb_host
    if n > train_sample:
        sel = np.random.default_rng(seed).choice(n, train_sample, replace=False)
        x = emb_host[sel]
    cent = kmeans_fit(torch.from_numpy(np.ascontiguousarray(x)).to(dev),
                      torch.from_numpy(kmeans_init(x, nlist, seed)).to(dev),
                      nlist=nlist, iters=kmeans_iters)
    x_dev = torch.from_numpy(emb_host).to(dev)
    a = _assign(x_dev, cent, nlist).cpu().numpy()

    cap = max(8, int(np.ceil(capacity_factor * n / nlist)))
    cap = -(-cap // 8) * 8
    packed_rows = np.full((nlist, cap), -1, np.int32)
    # vectorized packing: sort rows by cluster, position within the cluster
    # by searchsorted
    order = np.argsort(a, kind="stable").astype(np.int64)
    sorted_c = a[order]
    first = np.searchsorted(sorted_c, np.arange(nlist))
    pos = np.arange(n, dtype=np.int64) - first[sorted_c]
    keep = pos < cap
    packed_rows[sorted_c[keep], pos[keep]] = order[keep].astype(np.int32)
    tail_rows = order[~keep].astype(np.int32)

    gather = torch.from_numpy(np.where(packed_rows >= 0, packed_rows, 0)
                              .reshape(-1).astype(np.int64)).to(dev)
    live = torch.from_numpy(packed_rows >= 0).to(dev)
    n_tail = len(tail_rows)
    tail_gather = torch.from_numpy(tail_rows.astype(np.int64)).to(dev)
    if not n_tail:
        tail_rows = np.full(1, -1, np.int32)
    rows_dev = torch.from_numpy(packed_rows).to(dev)
    tail_rows_dev = torch.from_numpy(tail_rows).to(dev)

    if dtype == "int8":
        # SQ8 tier: quantize once over the original rows, pack codes + scales
        codes, scale = sq8_quantize_host(emb_host)
        codes_d = torch.from_numpy(codes).to(dev)
        scale_d = torch.from_numpy(scale).to(dev)
        packed = codes_d[gather].reshape(nlist, cap, d)
        packed = torch.where(live[:, :, None], packed, torch.zeros_like(packed))
        packed_scale = scale_d[gather].reshape(nlist, cap) * live
        tail_emb = torch.zeros((max(n_tail, 1), d), dtype=torch.int8, device=dev)
        tail_scale = torch.zeros((max(n_tail, 1),), dtype=torch.float32, device=dev)
        if n_tail:
            tail_emb[:n_tail] = codes_d[tail_gather]
            tail_scale[:n_tail] = scale_d[tail_gather]
        return IVFPartitions(cent, packed.contiguous(), rows_dev, tail_emb,
                             tail_rows_dev, packed_scale.contiguous(), tail_scale)

    if dtype not in _STORAGE:
        raise ValueError(f"unsupported IVF storage dtype: {dtype}")
    tdt = _STORAGE[dtype]
    packed = (x_dev[gather].reshape(nlist, cap, d) * live[:, :, None]).to(tdt)
    tail_emb = torch.zeros((max(n_tail, 1), d), dtype=tdt, device=dev)
    if n_tail:
        tail_emb[:n_tail] = x_dev[tail_gather].to(tdt)
    return IVFPartitions(cent, packed.contiguous(), rows_dev, tail_emb,
                         tail_rows_dev)


# -- search -----------------------------------------------------------------------

def probe_lists(parts: IVFPartitions, q: torch.Tensor,
                nprobe: int) -> torch.Tensor:
    """[Q, nprobe] i32 partitions closest to each query (ties to the lower
    list id, as ``lax.top_k``)."""
    c_scores = q @ parts.centroids.T                        # [Q, nlist]
    return topk_first(c_scores, nprobe)[1].to(torch.int32)


def finish_topk(scores: torch.Tensor, probes: torch.Tensor,
                parts: IVFPartitions, k: int,
                valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask [Q, nprobe, cap] slab scores through ``packed_rows`` and the
    row mask, and take the flat top-k (padded when nprobe * cap < k)."""
    nq = scores.shape[0]
    pr = parts.packed_rows[probes.long()]                    # [Q, nprobe, cap]
    ok = pr >= 0
    if valid is not None:
        ok = ok & valid[torch.clamp(pr, min=0).long()].to(torch.bool)
    flat_s = torch.where(ok, scores, NEG_INF).reshape(nq, -1)
    flat_r = torch.where(ok, pr, -1).reshape(nq, -1)
    kq = min(k, flat_s.shape[1])
    top_s, sel = topk_first(flat_s, kq)
    top_r = torch.gather(flat_r, 1, sel)
    if kq < k:
        top_s = torch.nn.functional.pad(top_s, (0, k - kq), value=NEG_INF)
        top_r = torch.nn.functional.pad(top_r, (0, k - kq), value=-1)
    return top_s, top_r


def merge_tail(top_s: torch.Tensor, top_i: torch.Tensor, ts: torch.Tensor,
               parts: IVFPartitions, k: int,
               valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the exact overflow-tail scores ``ts`` [Q, T] into the top-k."""
    ok = parts.tail_rows >= 0
    if valid is not None:
        ok = ok & valid[torch.clamp(parts.tail_rows, min=0).long()].to(torch.bool)
    ts = torch.where(ok[None, :], ts, NEG_INF)
    kk = min(k, parts.tail_emb.shape[0])
    tail_s, sel = topk_first(ts, kk)
    tail_i = torch.where(tail_s <= NEG_INF, -1, parts.tail_rows[sel])
    top_s, top_i = merge_topk(top_s, top_i.to(torch.int32),
                              tail_s, tail_i.to(torch.int32), k)
    top_i = torch.where(top_s <= NEG_INF, -1, top_i)
    return top_s, top_i


def ivf_topk_plain(parts: IVFPartitions, queries: torch.Tensor, k: int,
                   valid: Optional[torch.Tensor] = None, *,
                   nprobe: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX function's arithmetic: the materialized [Q, nprobe, cap, D]
    gather, an f32 einsum (SQ8: integer dot x (q_scale * row_scale)), the
    flat top-k and the tail merge."""
    q = queries.float()
    nlist = parts.packed_emb.shape[0]
    nprobe = min(nprobe, nlist)
    probes = probe_lists(parts, q, nprobe).long()
    pe = parts.packed_emb[probes]                            # [Q, nprobe, cap, D]
    sq8 = parts.packed_scale is not None
    if sq8:
        q_codes, q_scale = sq8_quantize(q)
        acc = torch.einsum("qd,qpcd->qpc", q_codes.float(), pe.float())
        s = acc * (q_scale[:, None, None] * parts.packed_scale[probes])
        ts = (q_codes.float() @ parts.tail_emb.float().T) * (
            q_scale[:, None] * parts.tail_scale[None, :])
    else:
        s = torch.einsum("qd,qpcd->qpc", q, pe.float())
        ts = q @ parts.tail_emb.float().T
    top_s, top_i = finish_topk(s, probes, parts, k, valid)
    return merge_tail(top_s, top_i, ts, parts, k, valid)


def ivf_topk(parts: IVFPartitions, queries: torch.Tensor, k: int,
             valid: Optional[torch.Tensor] = None, *,
             nprobe: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked IVF top-k -> (scores [Q, k] f32, original row ids [Q, k] i32).

    On the card the probed slabs go through kernel K5
    (``ivf_kernels.ivf_topk_kernel_batch``); on the CPU through the plain
    gather version, the JAX function's arithmetic."""
    if parts.packed_emb.device.type == "cpu":
        return ivf_topk_plain(parts, queries, k, valid, nprobe=nprobe)
    from .ivf_kernels import ivf_topk_kernel_batch

    return ivf_topk_kernel_batch(parts, queries, k, valid, nprobe=nprobe)


def auto_nlist(n: int, factor: float = 1.0) -> int:
    """nlist ~ factor * sqrt(N), rounded down to a multiple of 8 (>= 8)."""
    raw = int(factor * np.sqrt(max(n, 1)))
    return max(8, (raw // 8) * 8)


def tune_nprobe(
    parts: IVFPartitions,
    queries: np.ndarray,          # [S, D] held-out sample (normalized upstream)
    oracle_ids: np.ndarray,       # [S, k] exact top-k row ids
    *,
    recall_target: float = 0.95,
    k: int = 10,
    max_nprobe: int = 0,          # 0 -> nlist (full probe)
) -> Tuple[int, float]:
    """Smallest nprobe (doubling from 1) whose mean overlap@k with the exact
    oracle reaches the target -> (nprobe, achieved recall)."""
    nlist = parts.centroids.shape[0]
    hi = min(max_nprobe or nlist, nlist)
    q = torch.as_tensor(np.asarray(queries, np.float32),
                        device=parts.centroids.device)
    oracle_sets = [set(row[row >= 0].tolist()) for row in np.asarray(oracle_ids)]

    def recall_at(npb: int) -> float:
        _, ids = ivf_topk(parts, q, k, nprobe=npb)
        ids = ids.cpu().numpy()
        hits = [len(set(r[r >= 0].tolist()) & o) / max(len(o), 1)
                for r, o in zip(ids, oracle_sets)]
        return float(np.mean(hits))

    npb, best = 1, 0.0
    while npb < hi:
        best = recall_at(npb)
        if best >= recall_target:
            return npb, best
        npb *= 2
    return hi, recall_at(hi)


__all__ = ["IVFPartitions", "build_ivf", "ivf_topk", "ivf_topk_plain",
           "kmeans_fit", "kmeans_init", "auto_nlist", "tune_nprobe",
           "probe_lists", "finish_topk", "merge_tail"]
