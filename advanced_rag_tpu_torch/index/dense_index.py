"""Dense vector index: device-resident embedding matrix + kernel search.
The port of ``advanced_rag_tpu/index/dense_index.py``, flat tiers only.

The index is the tensor ``emb[capacity, D]`` on the device: bf16 (the
default), f32, or the SQ8 tier's int8 codes with per-row f32 scales
(``dtype="int8"``).  Rows align 1:1 with CorpusStore rows; the store's
validity and filter masks plug straight into the masked top-k.  Appends
write in place; a numpy f32 mirror serves growth.  The fused retrieve
(ops/hybrid.py) scans ``emb`` with kernel K1 or K2; the index's own
search methods come with the non-fused search slice.

The IVF and PQ tiers come with later slices of the port and raise here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import IndexConfig, Metric
from ..ops.quant import sq8_quantize, sq8_quantize_host
from .corpus import grow_capacity, next_pow2

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_LATER = {"pq": "the PQ and IVF-PQ slice (kernel K6)"}


class DenseIndex:
    """One embedding family (semantic or domain)."""

    def __init__(self, config: IndexConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.dim = config.dim
        self.capacity = int(config.min_capacity)
        self.size = 0
        if config.dtype in _LATER:
            raise NotImplementedError(
                f"dtype={config.dtype!r} is ported in {_LATER[config.dtype]}")
        if config.index_kind != "flat":
            raise NotImplementedError(
                f"index_kind={config.index_kind!r} is ported in the IVF "
                "slice (kernels K4 and K5)")
        self._sq8 = config.dtype == "int8"
        if not self._sq8 and config.dtype not in _DTYPES:
            raise ValueError(f"unsupported dense dtype: {config.dtype}")
        self._dtype = torch.int8 if self._sq8 else _DTYPES[config.dtype]
        self._host = np.zeros((self.capacity, self.dim), dtype=np.float32)
        self._upload()

    # the fused path selects its rungs on these, as the JAX manager does
    has_ivf = False
    has_pq = False
    has_ivfpq = False
    _pq_mode = False

    def _upload(self) -> None:
        """Device storage from the host mirror (construction and growth)."""
        if self._sq8:
            codes, scale = sq8_quantize_host(self._host[: self.size])
            full_c = np.zeros((self.capacity, self.dim), np.int8)
            full_c[: self.size] = codes
            full_s = np.zeros((self.capacity,), np.float32)
            full_s[: self.size] = scale
            self.emb = torch.from_numpy(full_c).to(self.device)
            self.emb_scale = torch.from_numpy(full_s).to(self.device)
        else:
            self.emb = torch.from_numpy(self._host).to(self.device).to(self._dtype)
            self.emb_scale = None

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
        if self._sq8:
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

    @property
    def search_metric(self) -> str:
        # cosine rows are normalized at append -> ip at query time
        return "ip" if self.config.metric == Metric.COSINE else self.config.metric.value

    def memory_bytes(self) -> int:
        scale_b = self.capacity * 4 if self._sq8 else 0
        return self.capacity * self.dim * self.emb.element_size() + scale_b


__all__ = ["DenseIndex"]
