"""Adaptive chunker: diagnostics-informed variable-granularity chunking.

A copy of ``advanced_rag_tpu/pipeline/chunking.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with reference chunking.py:13-367 — base 512 / max
1024 / min 128 tokens with 15% sentence overlap, size heuristics
(entropy>0.8 -> x1.3, <0.4 -> x0.8; redundancy>0.6 -> x0.7;
domain_density>0.3 -> x0.85; coherence<0.3 -> x0.75 — chunking.py:
167-201), sentence-boundary packing with sentence-level overlap
(:203-263), fixed-window fallback (:265-296), per-chunk quick
entropy/redundancy (:298-326), and SHA-256 content-hash doc/chunk ids
(:357-364) that make re-ingest idempotent.

Chunking is host-side text processing by design (SURVEY.md §5 "long
context": the device-side scale axis is the corpus, not the sequence).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .. import native
from ..utils.constants import ChunkingConstants as CC
from .diagnostics import DiagnosticMetrics, split_sentences, tokenize_words


@dataclass
class ChunkMetadata:
    """Reference chunking.py:13-54."""

    chunk_id: str
    doc_id: str
    chunk_index: int
    start_char: int
    end_char: int
    token_count: int
    entropy: float = 0.0
    redundancy: float = 0.0
    domain_density: float = 0.0
    source: str = ""
    timestamp: float = field(default_factory=time.time)
    version: int = 1
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Chunk:
    """Reference chunking.py:56-72."""

    content: str
    metadata: ChunkMetadata

    @property
    def chunk_id(self) -> str:
        return self.metadata.chunk_id

    @property
    def doc_id(self) -> str:
        return self.metadata.doc_id


def content_hash(text: str) -> str:
    """SHA-256 id (reference chunking.py:357-364)."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


class AdaptiveChunker:
    """Diagnostic-informed chunker (reference chunking.py:74-296)."""

    def __init__(
        self,
        base_chunk_size: int = CC.BASE_CHUNK_SIZE,
        max_chunk_size: int = CC.MAX_CHUNK_SIZE,
        min_chunk_size: int = CC.MIN_CHUNK_SIZE,
        overlap_ratio: float = CC.OVERLAP_RATIO,
        strategy: str = "sentence",
    ):
        """``strategy="sentence"`` (default): diagnostics-sized
        sentence packing (reference chunking.py:203-263).
        ``strategy="window"``: fixed word windows of exactly
        ``base_chunk_size`` words with ``overlap_ratio`` overlap —
        the geometry the retrieval-quality protocol indexes
        (stride = base*(1-overlap)); measured +0.01-0.02 R@10 over
        sentence packing on the real-text bench
        (artifacts/ABLATE_SERVICE.json: windows vs AdaptiveChunker
        rows), because window boundaries never split a relevant span
        without a covering neighbor."""
        if strategy not in ("sentence", "window"):
            raise ValueError(f"unknown chunking strategy: {strategy}")
        self.base_chunk_size = base_chunk_size
        self.max_chunk_size = max_chunk_size
        self.min_chunk_size = min_chunk_size
        self.overlap_ratio = overlap_ratio
        self.strategy = strategy

    # -- sizing ----------------------------------------------------------------

    def target_chunk_size(self, metrics: Optional[DiagnosticMetrics]) -> int:
        """Size heuristics (reference chunking.py:167-201)."""
        size = float(self.base_chunk_size)
        if metrics is not None:
            if metrics.entropy > CC.HIGH_ENTROPY_THRESHOLD:
                size *= CC.HIGH_ENTROPY_MULTIPLIER
            elif metrics.entropy < CC.LOW_ENTROPY_THRESHOLD:
                size *= CC.LOW_ENTROPY_MULTIPLIER
            if metrics.redundancy > CC.HIGH_REDUNDANCY_THRESHOLD:
                size *= CC.REDUNDANCY_MULTIPLIER
            if metrics.domain_density > CC.DOMAIN_DENSITY_THRESHOLD:
                size *= CC.DOMAIN_DENSITY_MULTIPLIER
            if metrics.coherence < CC.LOW_COHERENCE_THRESHOLD:
                size *= CC.LOW_COHERENCE_MULTIPLIER
        return int(max(self.min_chunk_size, min(self.max_chunk_size, size)))

    # -- chunking ---------------------------------------------------------------

    def chunk_document(
        self,
        text: str,
        doc_id: Optional[str] = None,
        metrics: Optional[DiagnosticMetrics] = None,
        source: str = "",
        extra: Optional[Dict[str, Any]] = None,
    ) -> List[Chunk]:
        """Sentence-boundary chunking with fixed-window fallback
        (reference chunking.py:102-165)."""
        if not text or not text.strip():
            return []
        doc_id = doc_id or content_hash(text)
        if self.strategy == "window":
            # fixed geometry: the encoder-window protocol; diagnostics
            # sizing heuristics deliberately do not apply
            pieces = self._fixed_chunks(text, self.base_chunk_size)
            return self._finalize(pieces, doc_id, metrics, source, extra)
        target = self.target_chunk_size(metrics)
        # C++ fast path: sentences and per-sentence token counts in one
        # pass (per-sentence python tokenize calls dominate bulk ingest).
        # ASCII only: the python regexes treat unicode whitespace
        # differently.
        sent_counts = None
        if native.enabled() and text.isascii():
            sentences, sent_counts = native.split_sentences_native(text)
        else:
            sentences = split_sentences(text)
        if len(sentences) >= 2:
            pieces = self._semantic_chunks(text, sentences, target, sent_counts)
        else:
            pieces = self._fixed_chunks(text, target)
        return self._finalize(pieces, doc_id, metrics, source, extra)

    def _finalize(self, pieces, doc_id, metrics, source, extra) -> List[Chunk]:
        chunks: List[Chunk] = []
        for idx, (content, start, end) in enumerate(pieces):
            # per-chunk stats without materializing token strings
            # (art_quick_stats follows tokenize_words' rule exactly)
            if native.enabled() and content.isascii():
                ntok, entropy, distinct = native.quick_stats_native(content)
                redundancy = (1.0 - distinct / ntok) if ntok else 0.0
            else:
                tokens = tokenize_words(content)
                ntok = len(tokens)
                entropy, redundancy = self._quick_stats(tokens)
            meta = ChunkMetadata(
                chunk_id=content_hash(f"{doc_id}:{content}"),
                doc_id=doc_id,
                chunk_index=idx,
                start_char=start,
                end_char=end,
                token_count=ntok,
                entropy=entropy,
                redundancy=redundancy,
                domain_density=metrics.domain_density if metrics else 0.0,
                source=source,
                extra=dict(extra or {}),
            )
            chunks.append(Chunk(content=content, metadata=meta))
        return chunks

    def _semantic_chunks(
        self, text: str, sentences: List[str], target: int,
        sent_tokens: Optional[List[int]] = None,
    ) -> List[tuple[str, int, int]]:
        """Pack sentences up to the target size; overlap by trailing
        sentences covering ~overlap_ratio of the target
        (reference chunking.py:203-263)."""
        if sent_tokens is None:
            sent_tokens = [len(tokenize_words(s)) for s in sentences]
        overlap_budget = int(target * self.overlap_ratio)
        out: List[tuple[str, int, int]] = []
        i, cursor = 0, 0
        while i < len(sentences):
            total, j = 0, i
            while j < len(sentences) and (total == 0 or total + sent_tokens[j] <= target):
                total += min(sent_tokens[j], CC.MAX_SENTENCE_TOKENS)
                j += 1
            content = " ".join(sentences[i:j])
            start = text.find(sentences[i][:48], cursor)
            if start < 0:
                start = cursor
            end = start + len(content)
            out.append((content, start, min(end, len(text))))
            cursor = max(start, cursor)
            if j >= len(sentences):
                break
            # overlap: step back whole sentences worth <= overlap budget
            back, used = 0, 0
            while back < (j - i - 1) and used + sent_tokens[j - 1 - back] <= overlap_budget:
                used += sent_tokens[j - 1 - back]
                back += 1
            i = j - back
        return out

    def _fixed_chunks(self, text: str, target: int) -> List[tuple[str, int, int]]:
        """Word-window fallback (reference chunking.py:265-296)."""
        words = text.split()
        if not words:
            return []
        step = max(1, int(round(target * (1 - self.overlap_ratio))))
        out: List[tuple[str, int, int]] = []
        pos = 0
        for start_w in range(0, len(words), step):
            piece = " ".join(words[start_w : start_w + target])
            start = text.find(words[start_w][:48], pos)
            if start < 0:
                start = pos
            out.append((piece, start, min(start + len(piece), len(text))))
            pos = start + 1
            if start_w + target >= len(words):
                break
        return out

    @staticmethod
    def _quick_stats(tokens: List[str]) -> tuple[float, float]:
        """Cheap per-chunk entropy/redundancy (reference chunking.py:298-326)."""
        from .diagnostics import DocumentDiagnostics

        if not tokens:
            return 0.0, 0.0
        entropy = DocumentDiagnostics.shannon_entropy(tokens)
        redundancy = 1.0 - len(set(tokens)) / len(tokens)
        return entropy, redundancy


__all__ = ["AdaptiveChunker", "Chunk", "ChunkMetadata", "content_hash"]
