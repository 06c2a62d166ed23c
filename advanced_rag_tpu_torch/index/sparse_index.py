"""Sparse lexical index: fixed-nnz padded rows + device BM25 scoring.
The port of ``advanced_rag_tpu/index/sparse_index.py``.

The index keeps, on the device, the doc-major arrays ``doc_idx [N, P]``
(i32, -1 pad), ``doc_tf [N, P]`` (bf16, as the JAX package stores it: a
chunk's tf above 256 rounds, 257 -> 256) and ``doc_len [N]`` (f32) that the
exact rescore gathers candidate rows from, plus their term-slot-major
mirror ``idx_t [P, N]``, ``tf_t [P, N]`` that kernel K3 scans (a warp reads
32 consecutive rows of one slot).  Appends write both in place; the f32
host mirrors serve growth, the df table and the postings build.

Inverted postings (``ops/postings.py``): ``build_postings`` makes the
per-term lists from the host mirror, and appends maintain them.  The
managers switch BM25 to them once the corpus reaches
``POSTINGS_AUTO_THRESHOLD`` rows (or once they exist); below that the
compare-scan kernel K3 serves BM25.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import IndexConfig
from ..ops.postings import (auto_postings_cap, build_postings,
                            postings_tf_weights, postings_topk)
from ..ops.sparse_kernels import sparse_topk_kernel
from .corpus import grow_capacity, next_pow2
from .text import encode_queries, remove_documents_df


class SparseIndex:
    """BM25/IP lexical index over hashed terms."""

    def __init__(self, config: IndexConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        self.vocab_size = config.vocab_size
        self.doc_nnz = config.doc_nnz
        self.capacity = int(config.min_capacity)
        self.size = 0
        self.n_docs = 0
        self._host_idx = np.full((self.capacity, self.doc_nnz), -1, np.int32)
        self._host_tf = np.zeros((self.capacity, self.doc_nnz), np.float32)
        self._host_len = np.zeros((self.capacity,), np.float32)
        self._df = np.zeros((self.vocab_size,), np.int64)
        self._upload()
        self._upload_df()
        # inverted postings (build_postings): [V, L] rows i32, tf and
        # build-time tf-weights in bf16, the build's live average length,
        # and the deleted rows still in the lists
        self.post_rows: Optional[torch.Tensor] = None
        self.post_tf: Optional[torch.Tensor] = None
        self.post_tfw: Optional[torch.Tensor] = None
        self.post_avg_len: Optional[float] = None
        self.postings_stale = 0

    def _upload(self) -> None:
        dev = self.device
        self.doc_idx = torch.from_numpy(self._host_idx).to(dev)
        self.doc_tf = torch.from_numpy(self._host_tf).to(torch.bfloat16).to(dev)
        self.doc_len = torch.from_numpy(self._host_len).to(dev)
        self.idx_t = self.doc_idx.T.contiguous()
        self.tf_t = self.doc_tf.T.contiguous()

    def _upload_df(self) -> None:
        self.df = torch.from_numpy(
            np.minimum(self._df, 2**31 - 1).astype(np.int32)).to(self.device)

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = grow_capacity(self.capacity, needed)
        grown_idx = np.full((new_cap, self.doc_nnz), -1, np.int32)
        grown_idx[: self.capacity] = self._host_idx
        grown_tf = np.zeros((new_cap, self.doc_nnz), np.float32)
        grown_tf[: self.capacity] = self._host_tf
        grown_len = np.zeros((new_cap,), np.float32)
        grown_len[: self.capacity] = self._host_len
        self._host_idx, self._host_tf, self._host_len = grown_idx, grown_tf, grown_len
        self.capacity = new_cap
        self._upload()

    def prepare_append_encoded(
        self,
        start: int,
        idx: np.ndarray,
        tf: np.ndarray,
        lens: np.ndarray,
        df_delta: np.ndarray,
    ) -> Optional[Dict[str, torch.Tensor]]:
        """Host half of an append; returns the device values for
        ``commit_append`` or None when empty."""
        n = idx.shape[0]
        if n == 0:
            return None
        self._ensure_capacity(start + next_pow2(n))
        self._host_idx[start: start + n] = idx
        self._host_tf[start: start + n] = tf
        self._host_len[start: start + n] = lens
        self._df += df_delta.astype(np.int64)
        self._upload_df()
        self.size = max(self.size, start + n)
        self.n_docs += n
        if self.has_postings:
            self._postings_append(start, idx, tf)
        dev = self.device
        return {"doc_idx": torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev),
                "doc_tf": torch.from_numpy(np.ascontiguousarray(tf, np.float32))
                .to(torch.bfloat16).to(dev),
                "doc_len": torch.from_numpy(np.ascontiguousarray(lens, np.float32)).to(dev)}

    def commit_append(self, start: int, vals: Dict[str, torch.Tensor]) -> None:
        n = vals["doc_idx"].shape[0]
        self.doc_idx[start: start + n] = vals["doc_idx"]
        self.doc_tf[start: start + n] = vals["doc_tf"]
        self.doc_len[start: start + n] = vals["doc_len"]
        self.idx_t[:, start: start + n] = vals["doc_idx"].T
        self.tf_t[:, start: start + n] = vals["doc_tf"].T

    def append_encoded(self, start: int, idx: np.ndarray, tf: np.ndarray,
                       lens: np.ndarray, df_delta: np.ndarray) -> None:
        """Write encoded rows at [start, start + N) (postings included)."""
        vals = self.prepare_append_encoded(start, idx, tf, lens, df_delta)
        if vals is not None:
            self.commit_append(start, vals)

    # -- inverted postings (ops/postings.py) ------------------------------------

    #: corpus size from which the managers build and serve postings (the
    #: compare scan reads N * P slots a query; postings read T * cap)
    POSTINGS_AUTO_THRESHOLD = 50_000

    @property
    def has_postings(self) -> bool:
        return self.post_rows is not None

    def _upload_postings(self) -> None:
        dev = self.device
        self.post_rows = torch.from_numpy(self._host_post_rows).to(dev)
        self.post_tf = torch.from_numpy(self._host_post_tf).to(dev).to(torch.bfloat16)
        self.post_tfw = torch.from_numpy(self._host_post_tfw).to(dev).to(torch.bfloat16)

    def build_postings(self, cap: int = 0,
                       valid: Optional[np.ndarray] = None) -> None:
        """Build the inverted layout from the host slot mirror; later
        appends maintain it.  ``valid`` (bool [size]) drops deleted rows'
        postings (compaction); without it dead rows stay in the lists and
        are masked at query time.  The tf-weights use this build's live
        average length until the next build."""
        cap = cap or auto_postings_cap(max(self.n_docs, 1), self.doc_nnz,
                                       self.vocab_size)
        src_idx = self._host_idx[: self.size]
        lens = self._host_len[: self.size]
        if valid is not None:
            live = np.asarray(valid[: self.size], bool)
            src_idx = np.where(live[:, None], src_idx, -1)
            self.post_avg_len = float(lens[live].mean()) if live.any() else 1.0
        else:
            self.post_avg_len = float(lens.mean()) if self.size else 1.0
        rows, tf = build_postings(src_idx, self._host_tf[: self.size],
                                  self.vocab_size, cap)
        self.postings_stale = 0
        self._post_cap = cap
        self._host_post_rows = rows
        self._host_post_tf = tf
        self._post_fill = (rows >= 0).sum(axis=1).astype(np.int64)
        self._host_post_tfw = postings_tf_weights(
            rows, tf, lens, self.post_avg_len,
            k1=self.config.bm25_k1, b=self.config.bm25_b)
        self._upload_postings()

    def _postings_append(self, start: int, idx: np.ndarray,
                         tf: np.ndarray) -> None:
        """Add the postings of newly appended rows; doubles the cap (one
        full upload) while a touched term is full, up to 16384, and drops
        postings beyond that.  Otherwise only the new slots are written on
        the device."""
        flat_t = idx.reshape(-1)
        keep = flat_t >= 0
        flat_t = flat_t[keep]
        flat_tf = tf.reshape(-1)[keep].astype(np.float32)
        flat_r = np.repeat(np.arange(idx.shape[0], dtype=np.int32) + start,
                           idx.shape[1])[keep]
        incoming = np.bincount(flat_t, minlength=self.vocab_size)
        grew = False
        while ((self._post_fill + incoming) > self._post_cap).any() \
                and self._post_cap < 16384:
            new_cap = self._post_cap * 2
            grown_r = np.full((self.vocab_size, new_cap), -1, np.int32)
            grown_r[:, : self._post_cap] = self._host_post_rows
            grown_t = np.zeros((self.vocab_size, new_cap), np.float32)
            grown_t[:, : self._post_cap] = self._host_post_tf
            grown_w = np.zeros((self.vocab_size, new_cap), np.float32)
            grown_w[:, : self._post_cap] = self._host_post_tfw
            self._host_post_rows, self._host_post_tf = grown_r, grown_t
            self._host_post_tfw = grown_w
            self._post_cap = new_cap
            grew = True
        # each posting's slot: the term's fill plus its rank among the new
        # postings of that term (sort by term, searchsorted offsets)
        order = np.argsort(flat_t, kind="stable")
        st, sr, stf = flat_t[order], flat_r[order], flat_tf[order]
        first = np.searchsorted(st, np.arange(self.vocab_size))
        within = np.arange(len(st), dtype=np.int64) - first[st]
        pos = self._post_fill[st] + within
        ok = pos < self._post_cap
        t_new, p_new, r_new, tf_new = st[ok], pos[ok], sr[ok], stf[ok]
        self._host_post_rows[t_new, p_new] = r_new
        self._host_post_tf[t_new, p_new] = tf_new
        # per-row length is exact; the average stays the build's
        dl_new = self._host_len[r_new].astype(np.float32)
        k1, b = self.config.bm25_k1, self.config.bm25_b
        avg = max(self.post_avg_len or 1.0, 1.0)
        denom = tf_new + k1 * (1.0 - b + b * dl_new / avg)
        tfw_new = (tf_new * (k1 + 1.0) / np.maximum(denom, 1e-6)).astype(np.float32)
        self._host_post_tfw[t_new, p_new] = tfw_new
        np.add.at(self._post_fill, t_new, 1)
        if grew:
            self._upload_postings()
            return
        if len(t_new) == 0:
            return
        dev = self.device
        ti = torch.from_numpy(t_new.astype(np.int64)).to(dev)
        pi = torch.from_numpy(p_new.astype(np.int64)).to(dev)
        self.post_rows[ti, pi] = torch.from_numpy(r_new).to(dev)
        self.post_tf[ti, pi] = torch.from_numpy(tf_new).to(dev).to(torch.bfloat16)
        self.post_tfw[ti, pi] = torch.from_numpy(tfw_new).to(dev).to(torch.bfloat16)

    def search_postings(
        self,
        q_idx: np.ndarray,
        q_tf: np.ndarray,
        k: int,
        mask: Optional[torch.Tensor] = None,
        *,
        scoring: str = "bm25",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Postings-backed top-k (builds the postings on first use).  The
        scatter rung serves one or two queries over >= 4M rows on the card,
        the sort rung everything else."""
        if not self.has_postings:
            self.build_postings()
        q_n = np.asarray(q_idx).shape[0]
        impl = ("scatter"
                if (self.device.type == "cuda" and q_n <= 2
                    and self.doc_len.shape[0] >= 4_000_000
                    and scoring == "bm25")
                else "sort")
        dev = self.device
        return postings_topk(
            self.post_rows, self.post_tf, self.doc_len, self.df,
            torch.tensor(float(max(self.n_docs, 1)), device=dev),
            torch.from_numpy(np.asarray(q_idx, np.int32)).to(dev),
            torch.from_numpy(np.asarray(q_tf, np.float32)).to(dev), k,
            mask[: self.doc_len.shape[0]] if mask is not None else None,
            post_tfw=self.post_tfw if scoring == "bm25" else None,
            scoring=scoring, k1=self.config.bm25_k1, b=self.config.bm25_b,
            impl=impl)

    @property
    def postings_stale_fraction(self) -> float:
        """Deleted-row postings still in the lists, over the live rows (0
        without postings)."""
        if not self.has_postings:
            return 0.0
        return self.postings_stale / max(self.n_docs, 1)

    def remove_rows(self, rows: Sequence[int]) -> None:
        """df bookkeeping for deletes (validity masking happens upstream)."""
        rows = [r for r in rows if 0 <= r < self.size]
        if not rows:
            return
        df_delta = remove_documents_df(self._host_idx[np.asarray(rows)],
                                       self.vocab_size)
        self._df = np.maximum(self._df - df_delta.astype(np.int64), 0)
        self._upload_df()
        self.n_docs = max(self.n_docs - len(rows), 0)
        if self.has_postings:
            self.postings_stale += len(rows)

    def encode_query(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        return encode_queries(list(texts), self.vocab_size,
                              self.config.query_nnz,
                              drop_ratio=self.config.drop_ratio)

    def search(
        self,
        q_idx: np.ndarray,
        q_tf: np.ndarray,
        k: int,
        mask: Optional[torch.Tensor] = None,
        *,
        scoring: str = "bm25",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compare-scan top-k over the [P, N] mirror through kernel K3."""
        dev = self.device
        return sparse_topk_kernel(
            self.idx_t, self.tf_t, self.doc_len, self.df,
            torch.tensor(float(max(self.n_docs, 1)), device=dev),
            torch.from_numpy(np.asarray(q_idx, np.int32)).to(dev),
            torch.from_numpy(np.asarray(q_tf, np.float32)).to(dev), k, mask,
            scoring=scoring, k1=self.config.bm25_k1, b=self.config.bm25_b)

    def search_texts(
        self,
        texts: Sequence[str],
        k: int,
        mask: Optional[torch.Tensor] = None,
        *,
        scoring: str = "bm25",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        q_idx, q_tf = self.encode_query(texts)
        return self.search(q_idx, q_tf, k, mask, scoring=scoring)

    def memory_bytes(self) -> int:
        # i32 ids + bf16 tf per slot, twice (doc-major and the [P, N] mirror),
        # plus the f32 length per row
        return self.capacity * self.doc_nnz * 12 + self.capacity * 4


__all__ = ["SparseIndex"]
