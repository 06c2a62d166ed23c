"""Sparse lexical index: fixed-nnz padded rows + device BM25 scoring.
The port of ``advanced_rag_tpu/index/sparse_index.py``.

The index keeps, on the device, the doc-major arrays ``doc_idx [N, P]``
(i32, -1 pad), ``doc_tf [N, P]`` (f32) and ``doc_len [N]`` that the exact
rescore gathers candidate rows from, plus their term-slot-major mirror
``idx_t [P, N]``, ``tf_t [P, N]`` that kernel K3 scans (a warp reads 32
consecutive rows of one slot).  Appends write both in place; host mirrors
serve growth and the df table.

Inverted postings (``ops/postings.py`` in the JAX package) come with the
next slice of the port; below the JAX package's auto-threshold, and in
the port's fused path at every size, the compare-scan serves BM25.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import IndexConfig
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

    def _upload(self) -> None:
        dev = self.device
        self.doc_idx = torch.from_numpy(self._host_idx).to(dev)
        self.doc_tf = torch.from_numpy(self._host_tf).to(dev)
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
        dev = self.device
        return {"doc_idx": torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev),
                "doc_tf": torch.from_numpy(np.ascontiguousarray(tf, np.float32)).to(dev),
                "doc_len": torch.from_numpy(np.ascontiguousarray(lens, np.float32)).to(dev)}

    def commit_append(self, start: int, vals: Dict[str, torch.Tensor]) -> None:
        n = vals["doc_idx"].shape[0]
        self.doc_idx[start: start + n] = vals["doc_idx"]
        self.doc_tf[start: start + n] = vals["doc_tf"]
        self.doc_len[start: start + n] = vals["doc_len"]
        self.idx_t[:, start: start + n] = vals["doc_idx"].T
        self.tf_t[:, start: start + n] = vals["doc_tf"].T

    # -- inverted postings: the next slice --------------------------------------

    has_postings = False

    def build_postings(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "inverted postings (ops/postings.py) are ported in the next slice; "
            "the fused path serves BM25 with the compare-scan kernel K3")

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

    def encode_query(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        return encode_queries(list(texts), self.vocab_size,
                              self.config.query_nnz,
                              drop_ratio=self.config.drop_ratio)

    def memory_bytes(self) -> int:
        # i32 ids + f32 tf per slot, twice (doc-major and the [P, N] mirror),
        # plus the f32 length per row
        return self.capacity * self.doc_nnz * 16 + self.capacity * 4


__all__ = ["SparseIndex"]
