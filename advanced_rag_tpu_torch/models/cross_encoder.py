"""Cross-encoder reranker on the device: the port of
``advanced_rag_tpu/models/cross_encoder.py``.

[CLS] query [SEP] doc [SEP] through the shared trunk and a scalar head,
batched over (query, candidate) pairs, in the static-slot pair layout that
the fused retrieve program (``ops/e2e.py``) builds on the device.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .encoder import CrossEncoder, EncoderConfig, init_weights
from .tokenizer import HashingTokenizer, TokenizerConfig


class CrossEncoderReranker:
    """Pairwise scorer on one device, in batches of ``max_batch`` pairs."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        state_dict: Optional[Mapping[str, Any]] = None,
        tokenizer: Optional[HashingTokenizer] = None,
        seed: int = 0,
        max_batch: int = 64,
        max_len: int = 128,
        q_len: Optional[int] = None,
        d_len: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.config = config or EncoderConfig(max_len=max_len)
        self.q_len = q_len if q_len is not None else min(
            32, self.config.max_len // 3)
        self.d_len = d_len if d_len is not None else (
            self.config.max_len - self.q_len - 1)
        if self.q_len + self.d_len + 1 > self.config.max_len:
            raise ValueError(
                f"pair length {self.q_len}+{self.d_len}+1 exceeds "
                f"encoder max_len {self.config.max_len}")
        self.tokenizer = tokenizer or HashingTokenizer(
            TokenizerConfig(vocab_size=self.config.vocab_size,
                            max_len=self.config.max_len))
        model = CrossEncoder(self.config)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(dict(state_dict))
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch

    def score(self, query: str, documents: Sequence[str]) -> np.ndarray:
        """Relevance scores [len(documents)] f32 for one query."""
        return self.score_pairs([query] * len(documents), list(documents))

    @torch.inference_mode()
    def score_pairs(self, queries: Sequence[str],
                    documents: Sequence[str]) -> np.ndarray:
        if len(queries) != len(documents):
            raise ValueError("queries and documents must align")
        n = len(queries)
        out = np.zeros((n,), np.float32)
        for pos in range(0, n, self.max_batch):
            ids, mask, segs = self.tokenizer.encode_pairs_static(
                list(queries[pos: pos + self.max_batch]),
                list(documents[pos: pos + self.max_batch]),
                self.q_len, self.d_len)
            s = self.model(*(torch.from_numpy(a).to(self.device)
                             for a in (ids, mask, segs)))
            out[pos: pos + len(ids)] = s.cpu().numpy()
        return out


__all__ = ["CrossEncoderReranker"]
