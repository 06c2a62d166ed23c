"""Dense vector index: device-resident embedding matrix + kernel search.
The port of ``advanced_rag_tpu/index/dense_index.py``.

The index is the tensor ``emb[capacity, D]`` on the device: bf16 (the
default), f32, the SQ8 tier's int8 codes with per-row f32 scales
(``dtype="int8"``), or the PQ tier's codes (``dtype="pq"``: bf16 rows until
``build_pq`` trains the codebooks and swaps the storage to [capacity, m]
codes).  Rows align 1:1 with CorpusStore rows; the store's validity and
filter masks plug straight into the masked top-k.  Appends write in place;
a numpy f32 mirror serves growth, the IVF and PQ builds and the exact
re-scoring of quantized candidates.

``build_ivf`` adds the IVF tier (``ops/ivf.py``): rows appended after the
build form an exact-scan tail merged at query time.  On a PQ index it
builds IVF-PQ (``ops/ivfpq.py``: partitions of residual codes; appended
rows go to its residual-coded tail).  With ``pq_opq`` the PQ build learns
an OPQ rotation (``ops/pq.py:opq_train``): rows are encoded and queries
scored rotated, and the exact refine stays in the original space; OPQ and
IVF-PQ exclude each other, as in the JAX package.  ``search`` runs, on the
card, through kernel K5 (IVF), K6 (PQ and IVF-PQ), K1 (bf16/f32 rows and
the IVF tail) or K2 (SQ8 rows and tail).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import IndexConfig, Metric
from ..ops.dense import NEG_INF, l2_normalize, merge_topk
from ..ops.dense_kernels import dense_topk_kernel, dense_topk_sq8_kernel
from ..ops.quant import sq8_quantize, sq8_quantize_host
from ..utils.constants import IndexConstants
from .corpus import grow_capacity, next_pow2

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _stable_topk(scores: np.ndarray, k: int) -> np.ndarray:
    """``np.argsort(-scores, axis=1, kind="stable")[:, :k]`` (ties to the
    lower index), without sorting whole rows: every entry at or above a
    row's k-th largest score, ties included, is sorted stably, in index
    order."""
    k = min(k, scores.shape[1])
    neg = -scores
    kth = np.partition(neg, k - 1, axis=1)[:, k - 1]
    out = np.empty((scores.shape[0], k), np.int64)
    for i, (row, t) in enumerate(zip(neg, kth)):
        cand = np.flatnonzero(row <= t)
        out[i] = cand[np.argsort(row[cand], kind="stable")[:k]]
    return out


class DenseIndex:
    """One embedding family (semantic or domain)."""

    #: appended-tail fraction beyond which an IVF rebuild is recommended
    REBUILD_TAIL_FRACTION = 0.2

    def __init__(self, config: IndexConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.dim = config.dim
        self.capacity = int(config.min_capacity)
        self.size = 0
        self._sq8 = config.dtype == "int8"
        # PQ tier: bf16 rows until build_pq swaps the storage to codes
        self._pq_mode = config.dtype == "pq"
        if not (self._sq8 or self._pq_mode) and config.dtype not in _DTYPES:
            raise ValueError(f"unsupported dense dtype: {config.dtype}")
        self._dtype = (torch.int8 if self._sq8 else
                       torch.bfloat16 if self._pq_mode else _DTYPES[config.dtype])
        self._pq = None            # ops.pq.PQCodebook once built
        self._pq_rot = None        # OPQ rotation [D, D] f32 (config.pq_opq)
        self._ivf = None           # ops.ivf.IVFPartitions once built
        self._ivf_size = 0         # rows covered by the last IVF build
        self._ivfpq = None         # ops.ivfpq.IVFPQIndex once built
        self._ivfpq_size = 0       # rows covered by the last IVF-PQ build
        self._ivfpq_fill = 0       # occupied IVF-PQ tail slots
        self._host = np.zeros((self.capacity, self.dim), dtype=np.float32)
        self._upload()

    def _upload(self) -> None:
        """Device storage from the host mirror (construction and growth)."""
        self.emb_scale = None
        if self._pq is not None:
            self._pq_reencode_all()
        elif self._sq8:
            codes, scale = sq8_quantize_host(self._host[: self.size])
            full_c = np.zeros((self.capacity, self.dim), np.int8)
            full_c[: self.size] = codes
            full_s = np.zeros((self.capacity,), np.float32)
            full_s[: self.size] = scale
            self.emb = torch.from_numpy(full_c).to(self.device)
            self.emb_scale = torch.from_numpy(full_s).to(self.device)
        else:
            self.emb = torch.from_numpy(self._host).to(self.device).to(self._dtype)

    def _prepare(self, vectors: np.ndarray, *,
                 pre_normalized: bool = False) -> np.ndarray:
        v = np.asarray(vectors, dtype=np.float32)
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}] vectors, got {v.shape}")
        if self.config.metric == Metric.COSINE and not pre_normalized:
            # store normalized -> search reduces to inner product
            norms = np.linalg.norm(v, axis=1, keepdims=True)
            v = v / np.maximum(norms, 1e-12)
        return v

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = grow_capacity(self.capacity, needed)
        grown = np.zeros((new_cap, self.dim), dtype=np.float32)
        grown[: self.capacity] = self._host
        self._host = grown
        self.capacity = new_cap
        self._upload()

    def prepare_append(self, start: int, vectors: np.ndarray, *,
                       pre_normalized: bool = False) -> Optional[Dict[str, torch.Tensor]]:
        """Host half of an append (mirror write, growth, device values).
        Returns the values for ``commit_append`` or None when empty."""
        v = self._prepare(vectors, pre_normalized=pre_normalized)
        n = v.shape[0]
        if n == 0:
            return None
        self._ensure_capacity(start + next_pow2(n))
        self._host[start: start + n] = v
        dev_v = torch.from_numpy(v).to(self.device)
        if self._pq is not None or self._ivfpq is not None:
            # the rows go up once as bf16; codes and residual codes are
            # computed from them on the device
            staged = dev_v.to(torch.bfloat16)
            if self._pq is not None:
                from ..ops.pq import pq_encode_device

                vals = {"emb": pq_encode_device(staged, self._pq.codebooks, self._pq_rot)}
            else:
                # IVF-PQ without flat codebooks: emb stays the bf16 staging matrix
                vals = {"emb": staged}
            if self._ivfpq is not None:
                # into the IVF-PQ tail whenever the partitions exist, so that
                # appended rows are searched before the next re-pack
                from ..ops.ivfpq import ivfpq_append_tail

                rows = torch.arange(start, start + n, dtype=torch.int32, device=self.device)
                self._ivfpq = ivfpq_append_tail(self._ivfpq, staged, rows, self._ivfpq_fill)
                self._ivfpq_fill += n
        elif self._sq8:
            # quantize on the device: codes and scales never exist on the host
            codes, scale = sq8_quantize(dev_v)
            vals = {"emb": codes, "emb_scale": scale}
        else:
            vals = {"emb": dev_v.to(self._dtype)}
        self.size = max(self.size, start + n)
        return vals

    def commit_append(self, start: int, vals: Dict[str, torch.Tensor]) -> None:
        n = vals["emb"].shape[0]
        self.emb[start: start + n] = vals["emb"]
        if self._sq8:
            self.emb_scale[start: start + n] = vals["emb_scale"]

    def append(self, start: int, vectors: np.ndarray, *,
               pre_normalized: bool = False) -> None:
        """Write vectors at rows [start, start + N); row ids come from the
        CorpusStore so every index family stays aligned.  Rows appended
        after an IVF build form the exactly scanned tail."""
        vals = self.prepare_append(start, vectors, pre_normalized=pre_normalized)
        if vals is not None:
            self.commit_append(start, vals)

    def bulk_load(self, vectors: np.ndarray, *,
                  pre_normalized: bool = False) -> int:
        """Append ``vectors`` at row ``self.size`` and return the start row
        (the raw-embedding import path; under a manager use its ingest so
        the families stay aligned).  ``pre_normalized=True`` skips the host
        normalize pass."""
        start = self.size
        self.append(start, vectors, pre_normalized=pre_normalized)
        return start

    @property
    def search_metric(self) -> str:
        # cosine rows are normalized at append -> ip at query time
        return "ip" if self.config.metric == Metric.COSINE else self.config.metric.value

    # -- tier builds ---------------------------------------------------------------

    def build_ivf(self, nlist: int = 0, *, train_sample: int = 262144,
                  seed: int = 0) -> None:
        """Train the coarse quantizer and pack the partitions from the host
        mirror (``ops/ivf.py``); later appends form the exact-scan tail."""
        from ..ops.ivf import auto_nlist, build_ivf

        if self.size == 0:
            raise ValueError("cannot build IVF over an empty index")
        if self._pq_mode:
            # the PQ tier's "IVF" is the residual IVF-PQ structure
            self.build_ivfpq(nlist, train_sample=train_sample, seed=seed)
            return
        nlist = nlist or self.config.nlist or auto_nlist(
            self.size, IndexConstants.IVF_NLIST_FACTOR)
        nlist = min(nlist, self.size)
        self._ivf = build_ivf(
            self._host[: self.size], nlist, dtype=self.config.dtype,
            kmeans_iters=self.config.kmeans_iters, train_sample=train_sample,
            seed=seed, device=self.device)
        self._ivf_size = self.size

    def build_ivfpq(self, nlist: int = 0, *, train_sample: int = 262144,
                    seed: int = 0, centroids: Optional[np.ndarray] = None,
                    codebooks=None) -> None:
        """Coarse partitions plus PQ-coded residuals (``ops/ivfpq.py``), the
        nprobe-bounded tier on top of ``dtype="pq"``, built from the f32 host
        rows.  ``centroids`` / ``codebooks`` skip the training (a checkpoint
        restore re-packs with the saved quantizers)."""
        from ..ops.ivf import auto_nlist
        from ..ops.ivfpq import build_ivfpq

        if self.size == 0:
            raise ValueError("cannot build IVF-PQ over an empty index")
        if not self._pq_mode:
            raise ValueError('build_ivfpq requires dtype="pq"')
        if self._pq_rot is not None:
            raise ValueError(
                "OPQ (pq_opq) applies to the flat-PQ tier only: IVF-PQ "
                "residuals are near-isotropic and rotate-invariant")
        nlist = nlist or self.config.nlist or auto_nlist(
            self.size, IndexConstants.IVF_NLIST_FACTOR)
        nlist = min(nlist, self.size)
        self._ivfpq = build_ivfpq(
            self._host[: self.size], nlist, m=self.config.pq_m, bits=self.config.pq_bits,
            kmeans_iters=self.config.kmeans_iters, train_sample=train_sample, seed=seed,
            centroids=centroids, codebooks=codebooks, device=self.device)
        self._ivfpq_size = self.size
        self._ivfpq_fill = int((self._ivfpq.tail_rows >= 0).sum())

    def build_pq(self, m: int = 0, bits: int = 0, *,
                 train_sample: int = 65536, seed: int = 0) -> None:
        """Train PQ codebooks (with ``config.pq_opq``, an OPQ rotation and
        codebooks in the rotated space) on the host mirror and swap the
        device storage from bf16 rows to codes (build-then-swap).  The whole
        capacity is encoded on the device; rows past ``size`` hold the codes
        of zero rows, which search masks out."""
        from ..ops.pq import opq_train, pq_encode_device, pq_train

        if self.size == 0:
            raise ValueError("cannot build PQ over an empty index")
        if not self._pq_mode:
            raise ValueError('build_pq requires dtype="pq"')
        if self.config.pq_opq:
            rot, pq = opq_train(self._host[: self.size], m or self.config.pq_m,
                                bits or self.config.pq_bits, train_sample=train_sample,
                                seed=seed, device=self.device)
            self._pq_rot = rot
        else:
            pq = pq_train(self._host[: self.size], m or self.config.pq_m,
                          bits or self.config.pq_bits, train_sample=train_sample,
                          seed=seed, device=self.device)
        codes = pq_encode_device(self.emb, pq.codebooks, self._pq_rot)
        self.emb, self._pq = codes, pq  # swap last

    def _pq_reencode_all(self) -> None:
        """Re-encode the f32 mirror after growth or a restore: one bf16
        upload, the encode (and the OPQ rotation) on the device."""
        from ..ops.pq import pq_encode_device

        staged = torch.from_numpy(self._host).to(self.device).to(torch.bfloat16)
        self.emb = pq_encode_device(staged, self._pq.codebooks, self._pq_rot)

    @property
    def has_ivf(self) -> bool:
        return self._ivf is not None

    @property
    def has_pq(self) -> bool:
        return self._pq is not None

    @property
    def has_ivfpq(self) -> bool:
        return self._ivfpq is not None

    @property
    def ivf_tail_rows(self) -> int:
        """Rows appended since the IVF or IVF-PQ build (scanned through the
        exact tail, or the residual-coded tail)."""
        if self._ivf is not None:
            return self.size - self._ivf_size
        if self._ivfpq is not None:
            return self.size - self._ivfpq_size
        return 0

    @property
    def ivf_needs_rebuild(self) -> bool:
        return ((self._ivf is not None or self._ivfpq is not None) and self.size > 0
                and self.ivf_tail_rows / self.size > self.REBUILD_TAIL_FRACTION)

    def _bound(self) -> torch.Tensor:
        """[capacity] bool: the rows below ``size``."""
        return torch.arange(self.capacity, device=self.device) < self.size

    def tune_nprobe(self, recall_target: float = 0.95, *, k: int = 10,
                    sample: int = 64, seed: int = 0,
                    queries: Optional[np.ndarray] = None) -> Tuple[int, float]:
        """Pick ``config.nprobe`` for a recall@k target against the exact
        scan (K1 or K2) of the stored rows; returns (nprobe, recall) and
        sets the config.  ``queries``: held-out real queries [S, D]
        (normalized); otherwise sampled stored rows.  The IVF-PQ tier sweeps
        against the host's exact f32 scan (``_tune_nprobe_ivfpq``)."""
        from ..ops.ivf import tune_nprobe as _tune

        if self._ivf is None and self._ivfpq is None:
            raise ValueError("tune_nprobe requires a built IVF index")
        if queries is not None:
            q = np.asarray(queries, np.float32)[: max(sample, 1)]
        else:
            rng = np.random.default_rng(seed)
            rows = rng.integers(0, self.size, size=min(sample, self.size))
            q = self._host[rows]
        if self._ivfpq is not None:
            return self._tune_nprobe_ivfpq(q, recall_target, k)
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        if self._sq8:
            _, oracle = dense_topk_sq8_kernel(self.emb, self.emb_scale, qt, k,
                                              self._bound(), metric="ip",
                                              normalize_queries=False)
        else:
            _, oracle = dense_topk_kernel(self.emb, qt, k, self._bound(),
                                          metric=self.search_metric,
                                          normalize_queries=False)
        npb, rec = _tune(self._ivf, q, oracle.cpu().numpy(),
                         recall_target=recall_target, k=k)
        self.config.nprobe = npb
        return npb, rec

    def _tune_nprobe_ivfpq(self, q: np.ndarray, recall_target: float,
                           k: int) -> Tuple[int, float]:
        """The IVF-PQ tier's doubling sweep.  The oracle is the exact f32
        top-k of the host mirror (a stable argsort of a host product), and
        recall is measured at the tier's operating point: does the candidate
        set of the refine depth (``min(k * refine, size, 1024)``) at this
        nprobe hold the true top-k.  The probe runs 8 queries at a time."""
        from ..ops.ivfpq import ivfpq_topk

        idx = self._ivfpq
        nlist = int(idx.centroids.shape[0])
        m = int(idx.codebooks.shape[0])
        bits = self.config.pq_bits
        qt = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(self.device)
        refine = int(self.config.refine_factor) or 32
        depth = int(min(max(k * max(refine, 1), k), self.size, 1024))
        host_scores = np.asarray(q, np.float32) @ self._host[: self.size].T
        oracle_sets = [set(r.tolist()) for r in _stable_topk(host_scores, k)]

        def recall_at(npb: int) -> float:
            hits = []
            for s0 in range(0, qt.shape[0], 8):
                _, ids = ivfpq_topk(idx, qt[s0: s0 + 8], depth, nprobe=npb, m=m, bits=bits)
                hits += [len(set(r[r >= 0].tolist()) & o) / max(len(o), 1)
                         for r, o in zip(ids.cpu().numpy(), oracle_sets[s0: s0 + 8])]
            return float(np.mean(hits))

        npb, best = 1, 0.0
        while npb < nlist:
            best = recall_at(npb)
            if best >= recall_target:
                break
            npb *= 2
        else:
            npb, best = nlist, recall_at(nlist)
        self.config.nprobe = npb
        return npb, best

    # -- search --------------------------------------------------------------------

    def search(
        self,
        queries,                             # [Q, D] or [D], numpy or tensor
        k: int,
        mask: Optional[torch.Tensor] = None,  # [capacity] bool (valid + filters)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked top-k -> (scores [Q, k] f32, rows [Q, k] i32).

        The IVF (or IVF-PQ) tier when built, the exact scan otherwise.
        Quantized tiers (SQ8, PQ, IVF-PQ) over-retrieve ``refine_factor * k``
        candidates with the codes (default 2 for SQ8, 32 for PQ) and
        re-score them exactly from the f32 host mirror, in the original
        space under OPQ too."""
        q = (queries if torch.is_tensor(queries)
             else torch.from_numpy(np.asarray(queries, np.float32)))
        q = q.to(self.device).float()
        if q.ndim == 1:
            q = q[None, :]
        if self.config.metric == Metric.COSINE:
            q = l2_normalize(q)
        if mask is None:
            # rows past `size` are padding (zero rows; garbage codes on PQ)
            mask = self._bound()
        pq_tier = self._pq is not None or self._ivfpq is not None
        refine = int(self.config.refine_factor) if (self._sq8 or pq_tier) else 1
        if refine == 0:  # auto: deep for PQ (1 bit a dim), shallow for SQ8
            refine = 32 if pq_tier else 2
        if refine > 1 and self.size > 0:
            k2 = min(max(k * refine, k), self.capacity, 1024)
            _, i2 = self._search_device(q, k2, mask)
            return self._refine_exact(q, i2, k)
        return self._search_device(q, k, mask)

    def _refine_exact_host(self, q: np.ndarray, cand: np.ndarray,
                           k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Re-score candidate rows with exact f32 dots from the host mirror
        and re-rank (stable, so ties keep the candidate order) -> numpy
        (scores [Q, k], rows [Q, k])."""
        ids = np.asarray(cand)                       # [Q, k2]
        qh = np.asarray(q, np.float32)               # [Q, D] (normalized)
        vecs = self._host[np.clip(ids, 0, None)]     # [Q, k2, D]
        scores = np.einsum("qd,qkd->qk", qh, vecs).astype(np.float32)
        scores[ids < 0] = float(NEG_INF)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        out_s = np.take_along_axis(scores, order, axis=1)
        out_i = np.take_along_axis(ids, order, axis=1).astype(np.int32)
        out_i[out_s <= float(NEG_INF)] = -1
        return out_s, out_i

    def _refine_exact(self, q: torch.Tensor, cand: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        out_s, out_i = self._refine_exact_host(q.cpu().numpy(),
                                               cand.cpu().numpy(), k)
        return (torch.from_numpy(out_s).to(self.device),
                torch.from_numpy(out_i).to(self.device))

    def _search_device(self, q: torch.Tensor, k: int,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k of pre-normalized queries on the index's own tier."""
        if self._ivf is not None:
            from ..ops.ivf import ivf_topk

            npb = min(self.config.nprobe, self._ivf.centroids.shape[0])
            s, i = ivf_topk(self._ivf, q, k, mask, nprobe=npb)
            tail = self.size - self._ivf_size
            if tail > 0:
                # exact scan over the appended rows, ids offset back
                t0 = self._ivf_size
                t1 = min(t0 + next_pow2(tail), self.capacity)
                t_mask = torch.arange(t1 - t0, device=self.device) < tail
                if mask is not None:
                    t_mask = t_mask & mask[t0:t1].to(torch.bool)
                kk = min(k, next_pow2(tail))
                if self._sq8:
                    ts, ti = dense_topk_sq8_kernel(
                        self.emb[t0:t1], self.emb_scale[t0:t1], q, kk, t_mask,
                        metric="ip", normalize_queries=False)
                else:
                    ts, ti = dense_topk_kernel(self.emb[t0:t1], q, kk, t_mask,
                                               metric=self.search_metric,
                                               normalize_queries=False)
                ti = torch.where(ti >= 0, ti + t0, -1)
                s, i = merge_topk(s, i, ts, ti, k)
                i = torch.where(s <= NEG_INF, -1, i)
            return s, i
        if self._ivfpq is not None:
            from ..ops.ivfpq import ivfpq_topk

            # packed and tail rows are all real rows; the mask removes deletes
            return ivfpq_topk(self._ivfpq, q, k, mask, nprobe=self.config.nprobe,
                              m=int(self._ivfpq.codebooks.shape[0]),
                              bits=self.config.pq_bits)
        if self._pq is not None:
            from ..ops.pq import pq_topk

            if self._pq_rot is not None:     # OPQ: q . x == (q R) . (x R)
                q = q @ self._pq_rot
            # rows past `size` hold real codes of zero rows: bound them
            bound = self._bound()
            mask = bound if mask is None else (mask.to(torch.bool) & bound)
            return pq_topk(self._pq.codebooks, self.emb, q, k, mask,
                           m=self._pq.m, bits=self._pq.bits)
        if self._sq8:
            return dense_topk_sq8_kernel(self.emb, self.emb_scale, q, k, mask,
                                         metric="ip", normalize_queries=False)
        return dense_topk_kernel(self.emb, q, k, mask, metric=self.search_metric,
                                 normalize_queries=False)

    def get_vectors(self, rows: np.ndarray) -> np.ndarray:
        """Host-side gather of stored (normalized) vectors."""
        return self._host[np.asarray(rows, dtype=np.int64)]

    def memory_bytes(self) -> int:
        total = 0
        if self._ivfpq is not None:
            total += sum(t.numel() * t.element_size() for t in self._ivfpq)
        if self._pq is not None:
            cb = self._pq.codebooks
            return (total + self.capacity * self._pq.m * self.emb.element_size()
                    + cb.numel() * 4)
        scale_b = self.capacity * 4 if self._sq8 else 0
        return total + self.capacity * self.dim * self.emb.element_size() + scale_b


__all__ = ["DenseIndex"]
