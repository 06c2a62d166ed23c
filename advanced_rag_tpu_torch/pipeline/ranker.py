"""Learned rankers: linear feedback ranker + hybrid-weight adapter.

A copy of ``advanced_rag_tpu/pipeline/ranker.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with:
- reference ranker.py:18-128 — deterministic linear feature ranker
  (base_score, method_count, recency) updated from thumbs feedback;
- reference learned_adapter.py:4-55 — dense/sparse weight adaptation
  from per-method success rates and query-length heuristics.

Featurization is vectorized numpy over the candidate batch (the
reference loops per-result in Python); scoring stays host-side because
it consumes hydrated results, not device arrays.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class LearnedRankerConfig:
    """Reference ranker.py:18-41."""

    base_weight: float = 1.0
    method_bonus: float = 0.1
    recency_weight: float = 0.05
    learning_rate: float = 0.05
    recency_half_life_days: float = 30.0


@dataclass
class FeedbackExample:
    """Reference ranker.py stores (features, label) pairs (:80-107)."""

    features: Tuple[float, float, float]
    label: float
    timestamp: float = field(default_factory=time.time)


class LearnedRanker:
    """Reference ranker.py:43-128."""

    def __init__(self, config: LearnedRankerConfig | None = None):
        self.config = config or LearnedRankerConfig()
        self.weights = np.asarray(
            [self.config.base_weight, self.config.method_bonus,
             self.config.recency_weight],
            np.float64,
        )
        self.examples: List[FeedbackExample] = []

    def featurize(self, result: Dict[str, Any],
                  now: float | None = None) -> Tuple[float, float, float]:
        """(base_score, method_count, recency) — reference ranker.py:57-77."""
        now = now or time.time()
        base = float(result.get("score", 0.0))
        methods = float(result.get("method_count",
                                   len(result.get("methods", [])) or 1))
        ts = float(result.get("timestamp", now))
        age_days = max(now - ts, 0.0) / 86400.0
        recency = float(2.0 ** (-age_days / self.config.recency_half_life_days))
        return (base, methods, recency)

    def update_from_feedback(
        self, result: Dict[str, Any], positive: bool
    ) -> None:
        """One SGD step on the linear weights (reference ranker.py:80-107)."""
        feats = np.asarray(self.featurize(result), np.float64)
        label = 1.0 if positive else 0.0
        pred = 1.0 / (1.0 + np.exp(-feats @ self.weights))
        grad = (pred - label) * feats
        self.weights -= self.config.learning_rate * grad
        self.examples.append(FeedbackExample(tuple(feats.tolist()), label))
        if len(self.examples) > 10_000:
            self.examples = self.examples[-10_000:]

    async def score(self, query: str,
                    results: Sequence[Dict[str, Any]]) -> List[float]:
        """Batch scoring (reference ranker.py:109-128; async for parity)."""
        return self.score_sync(results)

    def score_sync(self, results: Sequence[Dict[str, Any]]) -> List[float]:
        if not results:
            return []
        now = time.time()
        feats = np.asarray([self.featurize(r, now) for r in results], np.float64)
        return (feats @ self.weights).tolist()


class LearnedHybridAdapter:
    """Adaptive dense/sparse weights (reference learned_adapter.py:4-55)."""

    def __init__(self, min_weight: float = 0.1, max_weight: float = 0.9):
        self.min_weight = min_weight
        self.max_weight = max_weight
        self.dense_success = 1.0
        self.dense_trials = 2.0
        self.sparse_success = 1.0
        self.sparse_trials = 2.0

    def fit_from_feedback(
        self, feedback: Sequence[Tuple[str, bool]]
    ) -> None:
        """feedback: (method, positive) pairs
        (reference learned_adapter.py:19-29)."""
        for method, positive in feedback:
            if method in ("semantic", "dense", "hybrid"):
                self.dense_trials += 1
                self.dense_success += 1 if positive else 0
            if method in ("sparse", "hybrid"):
                self.sparse_trials += 1
                self.sparse_success += 1 if positive else 0

    def __call__(self, query: str, dense_weight: float,
                 sparse_weight: float) -> Tuple[float, float]:
        """Success-rate + query-length adjustment, normalized and clamped
        (reference learned_adapter.py:31-55)."""
        d_rate = self.dense_success / self.dense_trials
        s_rate = self.sparse_success / self.sparse_trials
        d = dense_weight * (0.5 + d_rate)
        s = sparse_weight * (0.5 + s_rate)
        # short keyword-ish queries lean lexical; long ones lean semantic
        n_words = len((query or "").split())
        if n_words <= 3:
            s *= 1.2
        elif n_words >= 12:
            d *= 1.2
        total = d + s
        if total <= 0:
            return dense_weight, sparse_weight
        d, s = d / total, s / total
        d = min(max(d, self.min_weight), self.max_weight)
        return d, 1.0 - d


__all__ = [
    "LearnedRanker",
    "LearnedRankerConfig",
    "FeedbackExample",
    "LearnedHybridAdapter",
]
