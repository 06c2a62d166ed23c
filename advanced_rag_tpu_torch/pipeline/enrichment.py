"""Ingest-time semantic enrichment: entities + topics per chunk.

A copy of ``advanced_rag_tpu/pipeline/enrichment.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with reference semantic_enrichment.py:18-104 —
capitalized-token entity extraction and frequency-based topic
extraction, attached to chunk metadata at ingest (pipeline.py:183-187).
Host-side text processing by design.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List

_CAP_RE = re.compile(r"\b[A-Z][a-zA-Z0-9_-]+\b")
_WORD_RE = re.compile(r"[a-zA-Z]{3,}")

_STOPWORDS = frozenset(
    "the and for with that this from are was were has have had been will"
    " would could should can may might must not all any each into over"
    " under about after before between during than then they them their"
    " there here where when what which while who whom whose".split()
)


@dataclass
class EnrichmentResult:
    """Reference semantic_enrichment.py:18-35."""

    entities: List[str] = field(default_factory=list)
    topics: List[str] = field(default_factory=list)
    keyword_scores: Dict[str, float] = field(default_factory=dict)


class SemanticEnricher:
    """Reference semantic_enrichment.py:38-104."""

    def __init__(self, max_entities: int = 10, max_topics: int = 5):
        self.max_entities = max_entities
        self.max_topics = max_topics

    def enrich(self, text: str) -> EnrichmentResult:
        if not text:
            return EnrichmentResult()
        # entities: capitalized tokens not at sentence start when possible
        caps = [w for w in _CAP_RE.findall(text) if w.lower() not in _STOPWORDS]
        entities = [w for w, _ in Counter(caps).most_common(self.max_entities)]
        # topics: frequent non-stopword lowercase terms
        words = [w.lower() for w in _WORD_RE.findall(text)]
        freq = Counter(w for w in words if w not in _STOPWORDS)
        total = sum(freq.values()) or 1
        topics = [w for w, _ in freq.most_common(self.max_topics)]
        scores = {w: c / total for w, c in freq.most_common(self.max_topics)}
        return EnrichmentResult(entities=entities, topics=topics,
                                keyword_scores=scores)


__all__ = ["SemanticEnricher", "EnrichmentResult"]
