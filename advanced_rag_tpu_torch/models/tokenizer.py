"""Deterministic hashing tokenizer for the models (a copy of
``advanced_rag_tpu/models/tokenizer.py``: the same words map to the same
ids in both packages, so converted checkpoints see the same inputs).

The reference delegates tokenization to whatever embedding API is
plugged in (indexing.py:580-587) and ships random-vector placeholders.
Here the models are real jitted transformers, so they need a real
tokenizer with zero external downloads: words map to stable blake2b
buckets in a fixed-size vocab, with reserved special tokens.  When a
local HuggingFace checkpoint is supplied (models/embedder.py
``from_hf``), its own tokenizer is used instead; this one is the
self-contained default.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


@dataclass(frozen=True)
class TokenizerConfig:
    vocab_size: int = 32768
    max_len: int = 128
    # reserved ids
    pad_id: int = 0
    cls_id: int = 1
    sep_id: int = 2
    unk_id: int = 3
    num_reserved: int = 8


class HashingTokenizer:
    """Stable word -> id tokenizer producing fixed-length padded batches."""

    def __init__(self, config: TokenizerConfig | None = None):
        self.config = config or TokenizerConfig()
        # word -> id memo: corpora are Zipf-distributed, so the blake2b
        # per word OCCURRENCE (~8M calls per 40k-chunk ingest) collapses
        # to one per DISTINCT word.  Bounded by the corpus vocabulary;
        # dict get/set is GIL-atomic, safe under the threaded warm-up.
        self._memo: dict = {}

    def _word_id(self, word: str) -> int:
        wid = self._memo.get(word)
        if wid is None:
            cfg = self.config
            h = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
            wid = cfg.num_reserved + int.from_bytes(h, "little") % (
                cfg.vocab_size - cfg.num_reserved)
            if len(self._memo) < 2_000_000:
                self._memo[word] = wid
        return wid

    def tokenize(self, text: str) -> List[int]:
        wid = self._word_id
        return [wid(w) for w in _WORD_RE.findall(text.lower())]

    def encode_batch(
        self, texts: Sequence[str], max_len: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, L] i32, mask [B, L] f32) with [CLS] ... [SEP] framing."""
        cfg = self.config
        L = max_len or cfg.max_len
        ids = np.full((len(texts), L), cfg.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.float32)
        for row, text in enumerate(texts):
            toks = [cfg.cls_id] + self.tokenize(text)[: L - 2] + [cfg.sep_id]
            ids[row, : len(toks)] = toks
            mask[row, : len(toks)] = 1.0
        return ids, mask

    def encode_pairs_static(
        self,
        queries: Sequence[str],
        docs: Sequence[str],
        q_len: int,
        d_len: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Static-slot cross-encoder input — the SERVING layout.

        Reproduces exactly what the fused one-dispatch program builds on
        device (ops/e2e.py: q frame ``[CLS] q [SEP]`` padded to
        ``q_len`` slots, then the token-table row ``[CLS] d [SEP]``
        padded to ``d_len`` slots, then a trailing ``[SEP]``; segments 0
        for the q frame, 1 for the doc part).  A short query leaves
        masked PAD holes before the doc instead of shifting it left.
        Training with this layout removes the train/serve position-id
        mismatch that the packed :meth:`encode_pairs` layout causes for
        checkpoints served through the fused path.
        """
        cfg = self.config
        n = len(queries)
        q_ids, q_mask = self.encode_batch(list(queries), q_len)
        d_ids, d_mask = self.encode_batch(list(docs), d_len)
        sep = np.full((n, 1), cfg.sep_id, np.int32)
        ids = np.concatenate([q_ids, d_ids, sep], axis=1)
        mask = np.concatenate(
            [q_mask, d_mask, np.ones((n, 1), np.float32)], axis=1)
        segments = np.concatenate(
            [np.zeros((n, q_len), np.int32),
             np.ones((n, d_len + 1), np.int32)], axis=1)
        return ids, mask, segments

    def encode_pairs(
        self,
        queries: Sequence[str],
        docs: Sequence[str],
        max_len: int | None = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Cross-encoder input: [CLS] q [SEP] d [SEP] with segment ids."""
        cfg = self.config
        L = max_len or cfg.max_len
        n = len(queries)
        ids = np.full((n, L), cfg.pad_id, dtype=np.int32)
        mask = np.zeros((n, L), dtype=np.float32)
        segments = np.zeros((n, L), dtype=np.int32)
        for row, (q, d) in enumerate(zip(queries, docs)):
            q_toks = self.tokenize(q)[: max(1, (L - 3) // 3)]
            d_budget = L - 3 - len(q_toks)
            d_toks = self.tokenize(d)[:d_budget]
            toks = [cfg.cls_id] + q_toks + [cfg.sep_id] + d_toks + [cfg.sep_id]
            ids[row, : len(toks)] = toks
            mask[row, : len(toks)] = 1.0
            segments[row, len(q_toks) + 2 : len(toks)] = 1
        return ids, mask, segments


__all__ = ["HashingTokenizer", "TokenizerConfig"]
