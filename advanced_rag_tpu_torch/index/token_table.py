"""Device-resident token table: the text column of the corpus on the
device.  The port of ``advanced_rag_tpu/index/token_table.py``.

The fused retrieve program (ops/e2e.py) gathers its candidates' tokens
from here for the cross-encoder, so rerank costs no host round trip.
Storage is [capacity, max_len] int32 ([CLS] body [SEP], pad-padded), rows
aligned 1:1 with the CorpusStore, with a host mirror for growth.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .corpus import grow_capacity, next_pow2


class TokenTable:
    def __init__(self, tokenizer, *, max_len: int = 48,
                 min_capacity: int = 1024, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.max_len = int(max_len)
        self.capacity = int(min_capacity)
        self.size = 0
        self._host = np.zeros((self.capacity, self.max_len), np.int32)
        self.tokens = torch.from_numpy(self._host).to(self.device)

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        ids, _ = self.tokenizer.encode_batch(list(texts), self.max_len)
        return ids.astype(np.int32)

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = grow_capacity(self.capacity, needed)
        grown = np.zeros((new_cap, self.max_len), np.int32)
        grown[: self.capacity] = self._host
        self._host = grown
        self.capacity = new_cap
        self.tokens = torch.from_numpy(grown).to(self.device)

    def prepare_append(self, start: int,
                       texts: Sequence[str]) -> Optional[Dict[str, torch.Tensor]]:
        ids = self._encode(texts)
        n = ids.shape[0]
        if n == 0:
            return None
        self._ensure_capacity(start + next_pow2(n))
        self._host[start: start + n] = ids
        self.size = max(self.size, start + n)
        return {"tok": torch.from_numpy(ids).to(self.device)}

    def commit_append(self, start: int, vals: Dict[str, torch.Tensor]) -> None:
        n = vals["tok"].shape[0]
        self.tokens[start: start + n] = vals["tok"]

    def rebuild(self, contents: Sequence[Optional[str]]) -> None:
        """Checkpoint restore: re-tokenize the corpus (tokens are
        deterministic given the contents, so checkpoints do not persist the
        table) and upload it in one put.  A forgotten row (None content)
        tokenizes as the empty text."""
        texts = ["" if c is None else c for c in contents]
        self.size = 0
        self._ensure_capacity(next_pow2(max(len(texts), 1)))
        self._host[:] = 0
        if texts:
            self._host[: len(texts)] = self._encode(texts)
            self.size = len(texts)
        self.tokens = torch.from_numpy(self._host).to(self.device)

    def memory_bytes(self) -> int:
        return self.capacity * self.max_len * 4


__all__ = ["TokenTable"]
