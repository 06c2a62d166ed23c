"""HF-checkpoint cross-encoder reranker: the port of
``advanced_rag_tpu/models/hf_cross_encoder.py``.

A local BERT sequence-classification checkpoint (e.g.
``cross-encoder/ms-marco-MiniLM-L-6-v2``) scores (query, document) pairs
on the card with the ``score`` / ``score_pairs`` surface of
``models/cross_encoder.py``, so it drops into the retriever's rerank stage
(``RAG_RERANKER=hf:<path>``).  Pairs are ``[CLS] q [SEP] d [SEP]``
truncated ``longest_first`` to ``max_len``; the score is the first logit
in f32 (the relevance convention of one-label heads).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .hf_bert import BertForSequenceClassification
from .hf_checkpoint import load_checkpoint
from .hf_embedder import _bucket, check_max_len
from .hf_tokenizer import WordPieceTokenizer


class HFCrossEncoder:
    """Pairwise relevance scorer from a local HF checkpoint; ``dtype`` is
    the compute dtype (weights stay f32)."""

    def __init__(self, path, *, max_len: int = 256, max_batch: int = 64,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tokenizer = WordPieceTokenizer.from_pretrained(path)
        config, state = load_checkpoint(path, head=True)
        check_max_len(max_len, config.max_position_embeddings, path)
        model = BertForSequenceClassification(config, dtype=dtype)
        model.load_state_dict(state)
        self.model = model.to(self.device).eval()
        self.max_len = max_len
        self.max_batch = max_batch

    def _tokenize(self, queries: Sequence[str], documents: Sequence[str],
                  batch: int):
        enc = self.tokenizer(list(queries), list(documents),
                             max_length=self.max_len)
        arrays = [enc[k] for k in ("input_ids", "attention_mask", "token_type_ids")]
        if arrays[0].shape[0] < batch:
            pad = ((0, batch - arrays[0].shape[0]), (0, 0))
            arrays = [np.pad(a, pad) for a in arrays]
        return arrays

    @torch.inference_mode()
    def score_pairs(self, queries: Sequence[str],
                    documents: Sequence[str]) -> np.ndarray:
        if len(queries) != len(documents):
            raise ValueError("queries and documents must align")
        n = len(queries)
        out = np.zeros((n,), np.float32)
        for pos in range(0, n, self.max_batch):
            q_chunk = list(queries[pos: pos + self.max_batch])
            d_chunk = list(documents[pos: pos + self.max_batch])
            b = _bucket(len(q_chunk), self.max_batch)
            logits = self.model(*(torch.from_numpy(a).to(self.device)
                                  for a in self._tokenize(q_chunk, d_chunk, b)))
            out[pos: pos + len(q_chunk)] = \
                logits[: len(q_chunk), 0].float().cpu().numpy()
        return out

    def score(self, query: str, documents: Sequence[str]) -> np.ndarray:
        return self.score_pairs([query] * len(documents), list(documents))


__all__ = ["HFCrossEncoder"]
