"""Document diagnostics: statistics that drive adaptive chunk sizing.

A copy of ``advanced_rag_tpu/pipeline/diagnostics.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with reference diagnostics.py:16-321 — Shannon entropy
normalized by log2(vocab) (:113-135), n-gram redundancy weighted
0.4/0.35/0.25 over 1/2/3-grams (:137-174), domain density against four
built-in lexicons (:176-199, :293-321), type-token vocabulary diversity
(:201-218), adjacent-sentence Jaccard coherence (:220-244), and a
composite complexity score.

This is host-side text analytics feeding the (host-side) chunker, so it
stays numpy-vectorized rather than device code (SURVEY.md §7 B6); the
per-token Python loops of the reference collapse into Counter/array ops.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

import numpy as np

from .. import native

_WORD_RE = re.compile(r"[a-zA-Z0-9']+")
_SENT_RE = re.compile(r"(?<=[.!?])\s+|\n\n+")

#: Built-in domain lexicons (reference diagnostics.py:293-321).
DOMAIN_LEXICONS: Dict[str, frozenset] = {
    "technical": frozenset(
        "algorithm api architecture backend binary cache compiler compute"
        " concurrency cpu database deployment encryption framework gpu"
        " infrastructure kernel latency memory network protocol query runtime"
        " scalability schema server software throughput".split()
    ),
    "medical": frozenset(
        "acute antibody cardiac chronic clinical diagnosis disease dose"
        " immune infection inflammation lesion oncology patient pathology"
        " prognosis surgery symptom syndrome therapy treatment tumor vaccine".split()
    ),
    "financial": frozenset(
        "asset audit bond capital credit debt derivative dividend equity"
        " fiscal hedge interest investment leverage liability liquidity"
        " margin market portfolio revenue securities stock yield".split()
    ),
    "legal": frozenset(
        "appeal attorney breach clause compliance contract counsel court"
        " damages defendant jurisdiction liability litigation plaintiff"
        " precedent regulation statute subpoena tort verdict waiver".split()
    ),
}


@dataclass
class DiagnosticMetrics:
    """Per-document statistics (reference diagnostics.py:16-61)."""

    entropy: float = 0.0
    redundancy: float = 0.0
    domain_density: float = 0.0
    vocabulary_diversity: float = 0.0
    coherence: float = 0.0
    complexity: float = 0.0
    token_count: int = 0
    sentence_count: int = 0
    token_distribution: Dict[str, int] = field(default_factory=dict)
    ngram_redundancy: Dict[int, float] = field(default_factory=dict)
    domain_scores: Dict[str, float] = field(default_factory=dict)


def tokenize_words(text: str) -> List[str]:
    return [w.lower() for w in _WORD_RE.findall(text)]


def split_sentences(text: str) -> List[str]:
    return [s.strip() for s in _SENT_RE.split(text) if s.strip()]


class DocumentDiagnostics:
    """Analyzer producing DiagnosticMetrics (reference diagnostics.py:63-99)."""

    def __init__(self, extra_lexicons: Dict[str, Sequence[str]] | None = None):
        self.lexicons: Dict[str, frozenset] = dict(DOMAIN_LEXICONS)
        for name, words in (extra_lexicons or {}).items():
            self.lexicons[name] = frozenset(w.lower() for w in words)

    # -- individual metrics --------------------------------------------------

    @staticmethod
    def shannon_entropy(tokens: List[str]) -> float:
        """Token entropy normalized by log2(vocab) -> [0, 1]
        (reference diagnostics.py:113-135)."""
        if not tokens:
            return 0.0
        counts = np.asarray(list(Counter(tokens).values()), np.float64)
        if counts.size <= 1:
            return 0.0
        p = counts / counts.sum()
        h = -np.sum(p * np.log2(p))
        return float(h / math.log2(counts.size))

    @staticmethod
    def ngram_redundancy(tokens: List[str], n: int) -> float:
        """1 - unique/total n-grams (reference diagnostics.py:137-174)."""
        if len(tokens) < n:
            return 0.0
        total = len(tokens) - n + 1
        unique = len({tuple(tokens[i : i + n]) for i in range(total)})
        return 1.0 - unique / total

    def redundancy(self, tokens: List[str]) -> tuple[float, Dict[int, float]]:
        parts = {n: self.ngram_redundancy(tokens, n) for n in (1, 2, 3)}
        combined = 0.4 * parts[1] + 0.35 * parts[2] + 0.25 * parts[3]
        return combined, parts

    def domain_density(self, tokens: List[str]) -> tuple[float, Dict[str, float]]:
        """Max lexicon hit-rate + per-domain scores
        (reference diagnostics.py:176-199)."""
        if not tokens:
            return 0.0, {k: 0.0 for k in self.lexicons}
        tokset = Counter(tokens)
        total = len(tokens)
        scores = {
            name: sum(c for w, c in tokset.items() if w in lex) / total
            for name, lex in self.lexicons.items()
        }
        return max(scores.values()), scores

    @staticmethod
    def vocabulary_diversity(tokens: List[str]) -> float:
        """Type-token ratio (reference diagnostics.py:201-218)."""
        if not tokens:
            return 0.0
        return len(set(tokens)) / len(tokens)

    @staticmethod
    def coherence(sentences: List[str]) -> float:
        """Mean adjacent-sentence Jaccard similarity
        (reference diagnostics.py:220-244)."""
        if len(sentences) < 2:
            return 1.0
        sets = [set(tokenize_words(s)) for s in sentences]
        sims = []
        for a, b in zip(sets, sets[1:]):
            union = a | b
            sims.append(len(a & b) / len(union) if union else 0.0)
        return float(np.mean(sims))

    # -- top level ------------------------------------------------------------

    def analyze_document(self, text: str) -> DiagnosticMetrics:
        # C++ fast path (text_native.cpp art_analyze_document): tokens,
        # entropy, n-grams, lexicons, coherence and the top 20 in two C
        # passes, no python token strings.  ASCII only: the python regexes
        # treat unicode whitespace and word characters differently
        # (hash-based grouping collides with probability ~n^2/2^64).
        if native.enabled() and text.isascii():
            return self._metrics_from_native(
                native.analyze_document_native(text, self.lexicons))
        return self._analyze_python(text)

    def _metrics_from_native(self, nat: Dict[str, Any]) -> DiagnosticMetrics:
        ngrams = nat["ngrams"]
        redundancy = (0.4 * ngrams[1] + 0.35 * ngrams[2]
                      + 0.25 * ngrams[3])
        n_tok = nat["token_count"]
        n_sent = nat["sentence_count"]
        diversity = (nat["distinct"] / n_tok) if n_tok else 0.0
        density = max(nat["domain_scores"].values(), default=0.0)
        avg_sent_len = (n_tok / n_sent) if n_sent else 0.0
        complexity = float(np.clip(
            0.4 * nat["entropy"] + 0.3 * diversity
            + 0.3 * min(avg_sent_len / 40.0, 1.0), 0.0, 1.0))
        return DiagnosticMetrics(
            entropy=nat["entropy"],
            redundancy=redundancy,
            domain_density=density,
            vocabulary_diversity=diversity,
            coherence=nat["coherence"] if n_sent >= 2 else 1.0,
            complexity=complexity,
            token_count=n_tok,
            sentence_count=n_sent,
            token_distribution=nat["token_distribution"],
            ngram_redundancy=ngrams,
            domain_scores=nat["domain_scores"],
        )

    def _analyze_python(self, text: str) -> DiagnosticMetrics:
        """Pure-python reference implementation (source of truth)."""
        tokens = tokenize_words(text)
        sentences = split_sentences(text)
        entropy = self.shannon_entropy(tokens)
        redundancy, ngrams = self.redundancy(tokens)
        density, domain_scores = self.domain_density(tokens)
        diversity = self.vocabulary_diversity(tokens)
        coherence = self.coherence(sentences)
        # Composite complexity: high entropy + diverse vocab + long
        # sentences read as "complex" (reference blends the same inputs).
        avg_sent_len = (len(tokens) / len(sentences)) if sentences else 0.0
        complexity = float(np.clip(
            0.4 * entropy + 0.3 * diversity + 0.3 * min(avg_sent_len / 40.0, 1.0),
            0.0, 1.0,
        ))
        top = Counter(tokens).most_common(20)
        return DiagnosticMetrics(
            entropy=entropy,
            redundancy=redundancy,
            domain_density=density,
            vocabulary_diversity=diversity,
            coherence=coherence,
            complexity=complexity,
            token_count=len(tokens),
            sentence_count=len(sentences),
            token_distribution=dict(top),
            ngram_redundancy=ngrams,
            domain_scores=domain_scores,
        )


__all__ = [
    "DiagnosticMetrics",
    "DocumentDiagnostics",
    "DOMAIN_LEXICONS",
    "tokenize_words",
    "split_sentences",
]
