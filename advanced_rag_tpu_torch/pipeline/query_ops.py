"""Query-side text transforms: rewriting, decomposition, classification.

A copy of ``advanced_rag_tpu/pipeline/query_ops.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with:
- reference query_rewriting.py:16-63 — deterministic abbreviation
  expansion applied pre-retrieval (pipeline.py:236-237);
- reference decomposition.py:15-55 — heuristic sub-query splitting for
  plan-and-execute;
- reference retrieval.py:22-67 — QueryClassifier heuristic routing into
  troubleshooting/summary/faq/analysis/default profiles.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class QueryRewriterConfig:
    """Reference query_rewriting.py:16-38."""

    enabled: bool = True
    expansions: Dict[str, str] = field(default_factory=lambda: {
        "rag": "retrieval augmented generation",
        "llm": "large language model",
        "ann": "approximate nearest neighbor",
        "ml": "machine learning",
        "api": "application programming interface",
    })


class QueryRewriter:
    """Reference query_rewriting.py:41-60."""

    def __init__(self, config: QueryRewriterConfig | None = None):
        self.config = config or QueryRewriterConfig()

    def rewrite(self, query: str) -> str:
        if not self.config.enabled or not query:
            return query
        out = []
        for word in query.split():
            key = word.lower().strip(".,!?")
            expansion = self.config.expansions.get(key)
            out.append(expansion if expansion else word)
        return " ".join(out)


@dataclass
class DecompositionResult:
    """Reference decomposition.py:15-34."""

    original: str
    sub_queries: List[str]
    is_complex: bool


class QueryDecomposer:
    """Reference decomposition.py:37-55: short queries stay single;
    conjunctions split on ' and ' / '; ' / ', and '."""

    def __init__(self, min_complex_words: int = 6):
        self.min_complex_words = min_complex_words

    def decompose(self, query: str) -> DecompositionResult:
        query = (query or "").strip()
        if len(query.split()) < self.min_complex_words:
            return DecompositionResult(query, [query] if query else [], False)
        parts = re.split(r"\s+and\s+|;\s*|,\s*and\s+", query)
        parts = [p.strip() for p in parts if len(p.strip().split()) >= 2]
        if len(parts) <= 1:
            return DecompositionResult(query, [query], False)
        return DecompositionResult(query, parts, True)


class QueryClassifier:
    """Heuristic query-class routing (reference retrieval.py:22-67)."""

    TROUBLESHOOT = ("error", "fail", "failure", "broken", "fix", "debug",
                    "crash", "issue", "problem", "not working", "exception")
    SUMMARY = ("summarize", "summary", "overview", "tl;dr", "brief",
               "main points")
    FAQ = ("what is", "what are", "how do", "how to", "can i", "does",
           "why is", "when should")
    ANALYSIS_MIN_CHARS = 200

    def classify(self, query: str) -> str:
        q = (query or "").lower()
        if not q:
            return "default"
        if any(t in q for t in self.TROUBLESHOOT):
            return "troubleshooting"
        if any(t in q for t in self.SUMMARY):
            return "summary"
        if len(q) >= self.ANALYSIS_MIN_CHARS:
            return "analysis"
        if any(q.startswith(t) or f" {t}" in q for t in self.FAQ):
            return "faq"
        return "default"


__all__ = [
    "QueryRewriter",
    "QueryRewriterConfig",
    "QueryDecomposer",
    "DecompositionResult",
    "QueryClassifier",
]
