"""Retrieval evaluation: quality metrics, hallucination risk, drift.

A copy of ``advanced_rag_tpu/pipeline/evaluation.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with reference evaluation.py:14-556:
- `EvaluationMetrics` (:14-48): precision/recall/MRR/NDCG + hallucination
  risk + faithfulness + coverage/diversity + confidence/uncertainty.
- `RAGEvaluator.evaluate_retrieval` (:92-153) with softmax score
  distributions stored in capped histories (:84-87, :134-140).
- Hallucination risk = 0.25*score_var + 0.2*low-diversity +
  0.3*low-top-score + 0.25*query-coverage (:226-274).
- Faithfulness via NLI hook or 1-redundancy fallback (:276-300).
- `detect_drift` (:378-477): mean-embedding cosine divergence (:479-494),
  KL of the last two score distributions (:496-511), temporal decay over
  a 30-day window (:417-422), magnitude = 0.5/0.3/0.2 blend (:424-429),
  per-query affected set (:433-443), recommendation text (:529-551).

Design: pairwise similarity uses embedding cosine over the top-k
candidate vectors handed back by the device search (one small matmul)
instead of the reference's O(k^2) Python token-Jaccard loop; histories
are plain lists with explicit caps (the reference's deque gets sliced
with [-100:], a latent TypeError — SURVEY.md §7 "quirks to NOT replicate").
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils.constants import EvaluationConstants as EC
from .diagnostics import tokenize_words


@lru_cache(maxsize=65536)
def _token_set(text: str) -> frozenset:
    """Memoized token set.  Result contents are static corpus chunks,
    so under serving load the same strings are re-evaluated on every
    request — tokenizing them once (instead of 3x per request: diversity
    + coverage + the risk blend's second coverage pass) removed ~30% of
    the per-request host CPU on the 1-core load rig (docs/PERF.md)."""
    return frozenset(tokenize_words(text))


@dataclass
class EvaluationMetrics:
    """Reference evaluation.py:14-48."""

    precision_at_k: float = 0.0
    recall_at_k: float = 0.0
    mrr: float = 0.0
    ndcg: float = 0.0
    hallucination_risk: float = 0.0
    faithfulness: float = 1.0
    coverage: float = 0.0
    diversity: float = 0.0
    confidence: float = 0.0
    uncertainty: float = 0.0
    num_results: int = 0
    latency_ms: float = 0.0


@dataclass
class DriftReport:
    """Reference evaluation.py:50-60."""

    drift_detected: bool
    magnitude: float
    embedding_divergence: float
    distribution_shift: float
    temporal_decay: float
    affected_queries: List[str] = field(default_factory=list)
    recommendations: List[str] = field(default_factory=list)


def _softmax(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


class RAGEvaluator:
    """Reference evaluation.py:62-556."""

    def __init__(
        self,
        history_maxlen: int = EC.HISTORY_MAXLEN,
        nli_scorer: Optional[Callable[[str, Sequence[str]], float]] = None,
    ):
        self.history_maxlen = history_maxlen
        self.nli_scorer = nli_scorer
        self.score_history: List[np.ndarray] = []
        self.embedding_history: List[np.ndarray] = []
        self.query_history: List[Dict[str, Any]] = []

    # -- rank metrics (reference evaluation.py:155-224) -----------------------

    @staticmethod
    def precision_at_k(retrieved: Sequence[str], relevant: Sequence[str],
                       k: int) -> float:
        if k <= 0 or not retrieved:
            return 0.0
        top = list(retrieved)[:k]
        rel = set(relevant)
        return sum(1 for r in top if r in rel) / min(k, len(top))

    @staticmethod
    def recall_at_k(retrieved: Sequence[str], relevant: Sequence[str],
                    k: int) -> float:
        if not relevant:
            return 0.0
        top = set(list(retrieved)[:k])
        return sum(1 for r in relevant if r in top) / len(relevant)

    @staticmethod
    def mrr(retrieved: Sequence[str], relevant: Sequence[str]) -> float:
        rel = set(relevant)
        for rank, r in enumerate(retrieved, 1):
            if r in rel:
                return 1.0 / rank
        return 0.0

    @staticmethod
    def ndcg_at_k(retrieved: Sequence[str], relevant: Sequence[str],
                  k: int) -> float:
        rel = set(relevant)
        gains = [1.0 if r in rel else 0.0 for r in list(retrieved)[:k]]
        dcg = sum(g / np.log2(i + 2) for i, g in enumerate(gains))
        ideal = sum(1.0 / np.log2(i + 2) for i in range(min(len(rel), k)))
        return float(dcg / ideal) if ideal > 0 else 0.0

    # -- quality signals --------------------------------------------------------

    @staticmethod
    def pairwise_diversity(embeddings: Optional[np.ndarray],
                           contents: Optional[Sequence[str]] = None) -> float:
        """1 - mean pairwise similarity.  Embedding cosine when vectors
        are available (one matmul); token-Jaccard fallback otherwise
        (reference evaluation.py:316-344)."""
        if embeddings is not None and len(embeddings) >= 2:
            e = np.asarray(embeddings, np.float64)
            e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
            sim = e @ e.T
            n = len(e)
            off = (sim.sum() - np.trace(sim)) / (n * (n - 1))
            return float(np.clip(1.0 - off, 0.0, 1.0))
        if contents and len(contents) >= 2:
            sets = [_token_set(c or "") for c in contents]
            sims = []
            for i in range(len(sets)):
                for j in range(i + 1, len(sets)):
                    u = sets[i] | sets[j]
                    sims.append(len(sets[i] & sets[j]) / len(u) if u else 0.0)
            return float(np.clip(1.0 - np.mean(sims), 0.0, 1.0))
        return 0.0

    @staticmethod
    def query_coverage(query: str, contents: Sequence[str]) -> float:
        """Fraction of query terms present in the result set
        (reference evaluation.py:258-272)."""
        q_terms = _token_set(query)
        if not q_terms:
            return 0.0
        covered = 0
        for t in q_terms:
            if any(t in _token_set(c or "") for c in contents):
                covered += 1
        return covered / len(q_terms)

    def hallucination_risk(
        self, query: str, scores: np.ndarray, diversity: float,
        contents: Sequence[str],
        coverage: Optional[float] = None,
    ) -> float:
        """Weighted blend (reference evaluation.py:226-274).  Pass
        ``coverage`` when already computed to skip the second pass."""
        if scores.size == 0:
            return 1.0
        var_term = float(np.clip(np.var(scores.astype(np.float64)) * 4.0, 0, 1))
        low_div = 1.0 - diversity
        top = float(scores.max())
        low_top = float(np.clip(1.0 - top, 0, 1))
        if coverage is None:
            coverage = self.query_coverage(query, contents)
        low_cov = 1.0 - coverage
        risk = (EC.HALLUCINATION_SCORE_VAR_WEIGHT * var_term
                + EC.HALLUCINATION_DIVERSITY_WEIGHT * low_div
                + EC.HALLUCINATION_TOP_SCORE_WEIGHT * low_top
                + EC.HALLUCINATION_COVERAGE_WEIGHT * low_cov)
        return float(np.clip(risk, 0.0, 1.0))

    def faithfulness(self, answer_or_query: str,
                     contents: Sequence[str],
                     redundancy: float = 0.0) -> float:
        """NLI hook or 1-redundancy fallback (reference evaluation.py:276-300)."""
        if self.nli_scorer is not None:
            try:
                return float(np.clip(self.nli_scorer(answer_or_query, contents),
                                     0.0, 1.0))
            except Exception:
                pass
        return float(np.clip(1.0 - redundancy, 0.0, 1.0))

    @staticmethod
    def confidence(scores: np.ndarray) -> tuple[float, float]:
        """top score x (1 + gap) , uncertainty = 1 - confidence
        (reference evaluation.py:346-360)."""
        if scores.size == 0:
            return 0.0, 1.0
        s = np.sort(scores.astype(np.float64))[::-1]
        gap = float(s[0] - s[1]) if s.size > 1 else float(s[0])
        conf = float(np.clip(s[0] * (1.0 + max(gap, 0.0)), 0.0, 1.0))
        return conf, 1.0 - conf

    # -- top-level evaluation (reference evaluation.py:92-153) ------------------

    def evaluate_retrieval(
        self,
        query: str,
        results: Sequence[Dict[str, Any]],
        relevant_ids: Optional[Sequence[str]] = None,
        k: Optional[int] = None,
        latency_ms: float = 0.0,
        query_embedding: Optional[np.ndarray] = None,
        result_embeddings: Optional[np.ndarray] = None,
    ) -> EvaluationMetrics:
        k = k or len(results)
        ids = [r.get("chunk_id", "") for r in results]
        contents = [r.get("content") or "" for r in results]
        scores = np.asarray([float(r.get("score", 0.0)) for r in results],
                            np.float64)
        # normalize RRF-scale scores into [0,1] for the risk heuristics
        if scores.size and scores.max() > 0:
            norm_scores = scores / scores.max()
        else:
            norm_scores = scores
        diversity = self.pairwise_diversity(result_embeddings, contents)
        redundancy = float(np.mean([float(r.get("redundancy", 0.0))
                                    for r in results])) if results else 0.0
        conf, uncert = self.confidence(norm_scores)
        coverage = self.query_coverage(query, contents)
        metrics = EvaluationMetrics(
            hallucination_risk=self.hallucination_risk(
                query, norm_scores, diversity, contents, coverage=coverage),
            faithfulness=self.faithfulness(query, contents, redundancy),
            coverage=coverage,
            diversity=diversity,
            confidence=conf,
            uncertainty=uncert,
            num_results=len(results),
            latency_ms=latency_ms,
        )
        if relevant_ids:
            metrics.precision_at_k = self.precision_at_k(ids, relevant_ids, k)
            metrics.recall_at_k = self.recall_at_k(ids, relevant_ids, k)
            metrics.mrr = self.mrr(ids, relevant_ids)
            metrics.ndcg = self.ndcg_at_k(ids, relevant_ids, k)

        # histories (softmax distributions — reference evaluation.py:134-140)
        if scores.size:
            self._append(self.score_history, _softmax(scores))
        if query_embedding is not None:
            self._append(self.embedding_history,
                         np.asarray(query_embedding, np.float32))
        self._append(self.query_history, {
            "query": query, "timestamp": time.time(),
            "top_score": float(norm_scores.max()) if scores.size else 0.0,
            "hallucination_risk": metrics.hallucination_risk,
        })
        return metrics

    def _append(self, hist: List, item) -> None:
        hist.append(item)
        if len(hist) > self.history_maxlen:
            del hist[: len(hist) - self.history_maxlen]

    # -- drift (reference evaluation.py:378-551) --------------------------------

    @staticmethod
    def _embedding_divergence(history: List[np.ndarray]) -> float:
        """Cosine distance between the mean embeddings of the older and
        newer halves (reference evaluation.py:479-494)."""
        if len(history) < 4:
            return 0.0
        half = len(history) // 2
        a = np.mean(np.stack(history[:half]), axis=0)
        b = np.mean(np.stack(history[half:]), axis=0)
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na < 1e-12 or nb < 1e-12:
            return 0.0
        return float(np.clip(1.0 - (a @ b) / (na * nb), 0.0, 1.0))

    @staticmethod
    def _distribution_shift(history: List[np.ndarray]) -> float:
        """Symmetric KL of the last two score distributions
        (reference evaluation.py:496-511)."""
        if len(history) < 2:
            return 0.0
        p, q = history[-2], history[-1]
        m = min(len(p), len(q))
        if m == 0:
            return 0.0
        p = np.clip(p[:m], 1e-10, 1.0)
        q = np.clip(q[:m], 1e-10, 1.0)
        p, q = p / p.sum(), q / q.sum()
        kl = 0.5 * (np.sum(p * np.log(p / q)) + np.sum(q * np.log(q / p)))
        return float(np.clip(kl, 0.0, 1.0))

    def _temporal_decay(self, window_days: float = EC.DRIFT_WINDOW_DAYS) -> float:
        """Fraction of history older than the window (reference :417-422)."""
        if not self.query_history:
            return 0.0
        now = time.time()
        old = sum(1 for qh in self.query_history
                  if (now - qh["timestamp"]) > window_days * 86400)
        return old / len(self.query_history)

    def detect_drift(
        self,
        queries: Optional[Sequence[str]] = None,
        embed_fn: Optional[Callable[[str], np.ndarray]] = None,
        threshold: float = EC.DRIFT_THRESHOLD,
    ) -> DriftReport:
        """Reference evaluation.py:378-477; optionally embeds probe
        queries through the live embedder to extend the history."""
        if queries and embed_fn is not None:
            for q in queries:
                try:
                    self._append(self.embedding_history,
                                 np.asarray(embed_fn(q), np.float32))
                except Exception:
                    continue
        emb_div = self._embedding_divergence(self.embedding_history)
        dist_shift = self._distribution_shift(self.score_history)
        decay = self._temporal_decay()
        magnitude = (EC.DRIFT_EMBEDDING_WEIGHT * emb_div
                     + EC.DRIFT_DISTRIBUTION_WEIGHT * dist_shift
                     + EC.DRIFT_TEMPORAL_WEIGHT * decay)
        detected = magnitude > threshold
        affected = [qh["query"] for qh in self.query_history[-100:]
                    if qh.get("hallucination_risk", 0) > 0.5
                    or qh.get("top_score", 1.0) < 0.3]
        recs: List[str] = []
        if detected:
            recs.append("Drift detected: consider re-embedding the corpus "
                        "with the current model.")
        if emb_div > threshold:
            recs.append("Query embedding distribution moved; refresh "
                        "retrieval profiles or retrain the bi-encoder.")
        if dist_shift > threshold:
            recs.append("Score distributions shifted; re-tune fusion weights.")
        if decay > 0.5:
            recs.append("Most history exceeds the freshness window; "
                        "re-ingest recent documents.")
        if not recs:
            recs.append("No action needed.")
        return DriftReport(
            drift_detected=detected,
            magnitude=float(magnitude),
            embedding_divergence=emb_div,
            distribution_shift=dist_shift,
            temporal_decay=decay,
            affected_queries=affected[:20],
            recommendations=recs,
        )


__all__ = ["RAGEvaluator", "EvaluationMetrics", "DriftReport"]
