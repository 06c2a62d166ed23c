"""Hybrid retriever: profile routing, fused device search, reranking.

The port of ``advanced_rag_tpu/pipeline/retrieval.py``: the same
profiles, budgets, micro-batching and rerank keys over the port's
``MultiIndexManager``.

Capability parity with reference retrieval.py:104-681:
- per-class retrieval profiles tuning top_k / MMR / rerank (:142-213);
- `retrieve` with an end-to-end timeout budget and graceful
  degrade-to-empty (:215-247);
- query classification -> profile select (:270-284), adaptive
  dense/sparse weights hook (:308-320);
- over-retrieval 2x per index (:351, :384) and RRF fusion k=60 with
  method weights (:421-491) — executed INSIDE the fused device program
  (ops/hybrid.py) instead of asyncio fan-out + CPU loops;
- recency annotation from chunk timestamps (:472-483);
- `rerank` with learned-ranker / cross-encoder / score passthrough
  (:518-563) — the passthrough is deterministic, not the reference's
  score+noise placeholder;
- metadata filters: the typed spec compiled to a device mask
  (CorpusStore.build_filter_mask) replaces the string `expr` builder
  (:566-632).

The timeout uses a worker thread (the search itself is a chain of
device launches that cannot be interrupted; on timeout the result is
discarded on arrival, matching the reference's degrade-to-empty
contract).
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import RetrievalConfig
from ..index.manager import MultiIndexManager
from ..utils.constants import RetrievalConstants as RC
from ..utils.exceptions import IndexingError, ValidationError
from .query_ops import QueryClassifier
from .ranker import LearnedHybridAdapter, LearnedRanker

logger = logging.getLogger(__name__)


def _freeze(value: Any) -> Any:
    """Hashable view of a filter spec for the micro-batch key."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


@dataclass(frozen=True)
class RetrievalProfile:
    """Per-query-class knobs (reference retrieval.py:142-213)."""

    top_k: int = RC.DEFAULT_TOP_K
    use_mmr: bool = True
    mmr_lambda: float = RC.MMR_LAMBDA
    use_reranking: bool = True
    dense_weight: float = RC.DENSE_WEIGHT
    sparse_weight: float = RC.SPARSE_WEIGHT
    over_retrieve: int = RC.OVER_RETRIEVE_FACTOR


DEFAULT_PROFILES: Dict[str, RetrievalProfile] = {
    # troubleshooting: precision over diversity, lexical matters (errors
    # quote exact strings) — reference retrieval.py:150-162
    "troubleshooting": RetrievalProfile(top_k=15, use_mmr=False,
                                        dense_weight=0.55, sparse_weight=0.45),
    # summary: broad and diverse — reference :164-175
    "summary": RetrievalProfile(top_k=30, use_mmr=True, mmr_lambda=0.6,
                                use_reranking=False),
    # faq: small, rerank hard — reference :177-188
    "faq": RetrievalProfile(top_k=10, use_mmr=False, use_reranking=True),
    # analysis: deep pull — reference :190-201
    "analysis": RetrievalProfile(top_k=25, use_mmr=True, mmr_lambda=0.75),
    "default": RetrievalProfile(),
}


class HybridRetriever:
    """Reference retrieval.py:104-563, device-resident."""

    def __init__(
        self,
        index_manager: MultiIndexManager,
        config: Optional[RetrievalConfig] = None,
        profiles: Optional[Dict[str, RetrievalProfile]] = None,
        classifier: Optional[QueryClassifier] = None,
        learned_ranker: Optional[LearnedRanker] = None,
        reranker: Any = None,                 # CrossEncoderReranker-like
        weight_adapter: Optional[LearnedHybridAdapter] = None,
        *,
        device: DeviceLike = None,
    ):
        """``device`` is where the retriever's models run: the manager's
        device unless given, and it must be the manager's.  Models the
        service wires in later (``CrossEncoderReranker``) are built there.
        """
        self.device = resolve_device(
            device if device is not None
            else getattr(index_manager, "device", None))
        for what, obj in (("manager", index_manager), ("reranker", reranker)):
            dev = getattr(obj, "device", None)
            if dev is not None and torch.device(dev) != self.device:
                raise ValueError(f"the {what} is on {dev}, the retriever "
                                 f"on {self.device}")
        self.index_manager = index_manager
        self.config = config or RetrievalConfig()
        self.profiles = dict(DEFAULT_PROFILES)
        if profiles:
            self.profiles.update(profiles)
        self.classifier = classifier or QueryClassifier()
        self.learned_ranker = learned_ranker
        self.reranker = reranker
        self.weight_adapter = weight_adapter
        # 2x the batch width: micro-batch FOLLOWERS block inside their
        # executor slot while the leader runs the fused dispatch, so one
        # batch consumes micro_batch_size workers — the second batch's
        # worth of slots lets the next wave coalesce while the current
        # one is on the device (queue wait is budgeted; see retrieve_sync)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(8, 4 * self.config.micro_batch_size),
            thread_name_prefix="retrieve",
        )
        self.last_profile: Optional[str] = None
        self._warm_keys: set = set()
        #: (k-bucket, mmr) -> {pow2 batch buckets that have run}
        self._warm_buckets: Dict[tuple, set] = {}
        from .batcher import MicroBatcher

        self._batcher = MicroBatcher(
            self._run_batch,
            max_batch=self.config.micro_batch_size,
            max_wait_s=self.config.micro_batch_wait_ms / 1e3,
        ) if self.config.enable_micro_batching else None

    #: budget until the first successful search of a signature has run:
    #: the first use builds the CUDA kernels (one nvcc call, about half a
    #: minute on an H100 host) and each shape's first launches cost more
    #: than steady state (tens of ms) — the strict budget applies once warm.
    COLD_BUDGET_S = 120.0

    # -- profile selection -------------------------------------------------------

    def profile_for(self, query: str) -> Tuple[str, RetrievalProfile]:
        """Classify + per-REQUEST profile (no shared-config mutation —
        the reference mutates self.config per request, a documented race
        it acknowledges at service.py:166-168)."""
        cls = self.classifier.classify(query)
        return cls, self.profiles.get(cls, self.profiles["default"])

    # -- retrieval ------------------------------------------------------------------

    def retrieve_sync(
        self,
        query: str,
        top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        timeout_s: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Hybrid retrieve with budget + degrade-to-empty
        (reference retrieval.py:215-247)."""
        hits, _ = self.retrieve_sync_ex(query, top_k, filters, timeout_s)
        return hits

    def retrieve_sync_ex(
        self,
        query: str,
        top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        timeout_s: Optional[float] = None,
    ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
        """-> (hits, degraded_reason).  ``degraded_reason`` is None on a
        real result, else "timeout"/"error" — an empty-but-200 response
        is a FAILURE to the user and must be countable against a shed
        budget (rag_shed_total), not invisible inside the error SLO
        (the reference's degrade path has the same blind spot:
        retrieval.py:230-247 returns [] with no accounting)."""
        budget = timeout_s if timeout_s is not None else self.config.timeout_seconds
        key = self._program_key(query, top_k)
        if not self.is_warm(query, top_k):
            budget = max(budget, self.COLD_BUDGET_S)
        future = self._executor.submit(self._retrieve_inner, query, top_k, filters)
        try:
            result = future.result(timeout=budget)
            self._warm_keys.add(key)
            return result, None
        except concurrent.futures.TimeoutError:
            logger.warning("retrieve timed out after %.0f ms; degrading to []",
                           budget * 1e3)
            future.cancel()
            return [], "timeout"
        except ValidationError:
            raise  # client error (bad filter/k) — not a degradation case
        except Exception:
            logger.exception("retrieve failed; degrading to []")
            return [], "error"

    async def retrieve(self, query: str, top_k: Optional[int] = None,
                       filters: Optional[Dict[str, Any]] = None,
                       timeout_s: Optional[float] = None) -> List[Dict[str, Any]]:
        import asyncio

        return await asyncio.to_thread(
            self.retrieve_sync, query, top_k, filters, timeout_s
        )

    def is_warm(self, query: str, top_k: Optional[int] = None) -> bool:
        """Has EVERY program shape this query can hit run once yet?

        A query's device work is keyed by (k-bucket, mmr) AND the
        micro-batch bucket it lands in (pow2 up to micro_batch_size) —
        the bucket depends on concurrent arrivals, so the strict latency
        budget is safe only once every bucket for this key has run.
        Before that, a burst can route a request into a shape whose
        first use builds the kernels or pays first launches, which would
        eat the 300 ms budget and degrade the whole wave to empty.
        """
        key = self._program_key(query, top_k)
        if key not in self._warm_keys:
            return False
        if self._batcher is None:
            return True
        top = self._pow2(self.config.micro_batch_size)
        buckets = self._warm_buckets.get(key, set())
        need = 1
        while need <= top:
            if need not in buckets:
                return False
            need *= 2
        return True

    @staticmethod
    def _pow2(n: int) -> int:
        """Smallest power of two >= n (the manager pads query batches to
        this bucket, so it is the unit of program shapes)."""
        return 1 if n <= 1 else 1 << (n - 1).bit_length()

    def _program_key(self, query: str, top_k: Optional[int]) -> tuple:
        """Static signature of the device work a query will hit: each
        distinct (k, use_mmr) pair pays its first use once, so the strict
        latency budget applies only after that signature has run."""
        _, profile = self.profile_for(query)
        k = min(top_k or profile.top_k, self.config.max_top_k)
        return (-(-k // 8) * 8, profile.use_mmr and self.config.use_mmr)

    def _retrieve_inner(
        self,
        query: str,
        top_k: Optional[int],
        filters: Optional[Dict[str, Any]],
    ) -> List[Dict[str, Any]]:
        """Reference retrieval.py:249-339 collapsed onto the fused program."""
        if not query or not query.strip():
            return []
        cls, profile = self.profile_for(query)
        self.last_profile = cls
        k = min(top_k or profile.top_k, self.config.max_top_k)

        dense_w, sparse_w = profile.dense_weight, profile.sparse_weight
        if (dense_w, sparse_w) == (RC.DENSE_WEIGHT, RC.SPARSE_WEIGHT):
            # profiles that don't specialize the fusion weights follow
            # the deployment's configured operating point (RAG_DENSE_/
            # SPARSE_WEIGHT env -> RetrievalConfig); previously the
            # class constants silently overrode the config and the
            # dev-picked weights never reached the search
            dense_w = self.config.dense_weight
            sparse_w = self.config.sparse_weight
        if self.weight_adapter is not None and self.config.adaptive_weights:
            dense_w, sparse_w = self.weight_adapter(query, dense_w, sparse_w)

        knobs = dict(
            filters=filters,
            dense_weight=dense_w,
            sparse_weight=sparse_w,
            domain_weight=self.config.domain_weight,
            rrf_k=self.config.rrf_k,
            use_mmr=profile.use_mmr and self.config.use_mmr,
            mmr_lambda=profile.mmr_lambda,
            over_retrieve=profile.over_retrieve,
        )
        if self._batcher is not None:
            batch_key = (k, _freeze(filters), dense_w, sparse_w,
                         knobs["use_mmr"], profile.mmr_lambda,
                         profile.over_retrieve)
            hits = self._batcher.submit(batch_key, query, k=k, **knobs)
        else:
            hits = self.index_manager.hybrid_search_sync(query, k, **knobs)
        now = time.time()
        for h in hits:
            h["query_class"] = cls
            h["methods"] = ["hybrid"] * max(int(h.get("method_count", 1)), 1)
            age_days = max(now - float(h.get("timestamp", now)), 0.0) / 86400.0
            h["recency"] = float(
                2.0 ** (-age_days / max(self.config.recency_half_life_days, 1e-6))
            )
        return hits

    def _run_batch(self, queries: List[str], k: int, **knobs: Any):
        """MicroBatcher callback -> per-query hit lists."""
        out = self.index_manager.hybrid_search_batch_sync(queries, k, **knobs)
        # record the (key, batch-bucket) pair that has run, for is_warm
        bucket = min(self._pow2(len(queries)),
                     self._pow2(self.config.micro_batch_size))
        ck = (-(-min(k, self.config.max_top_k) // 8) * 8,
              bool(knobs.get("use_mmr", True)))
        self._warm_buckets.setdefault(ck, set()).add(bucket)
        return out

    def warm_up(self, top_k: Optional[int] = None,
                parallel: bool = False) -> None:
        """Deterministically run every program shape live traffic can
        hit once: each DISTINCT (k-bucket, candidate depth, mmr)
        signature across the configured profiles (the shape-relevant
        knobs of ops/hybrid.py; fusion weights are tensors and change no
        shape), times each pow2 micro-batch bucket up to
        ``micro_batch_size``.  Deployments call this at boot or after
        bulk ingest (POST /admin/warmup) so the strict latency budget
        is in force from the first real request; without it, the first
        use (the kernels' build, each shape's first launches) happens
        under traffic with the cold budget, and continuous batching
        makes WHICH batch buckets form load-dependent.

        ``parallel=True`` runs the distinct shapes from a small thread
        pool (the kernels' launchers keep per-thread caches)."""
        seen: set = set()
        top = self._pow2(self.config.micro_batch_size)
        tasks = []
        for profile in self.profiles.values():
            k = min(top_k or profile.top_k, self.config.max_top_k)
            use_mmr = profile.use_mmr and self.config.use_mmr
            sig = (-(-k // 8) * 8, profile.over_retrieve, use_mmr)
            if sig in seen:
                continue
            seen.add(sig)
            knobs = dict(
                filters=None,
                dense_weight=profile.dense_weight,
                sparse_weight=profile.sparse_weight,
                domain_weight=self.config.domain_weight,
                rrf_k=self.config.rrf_k,
                use_mmr=use_mmr,
                mmr_lambda=profile.mmr_lambda,
                over_retrieve=profile.over_retrieve,
            )
            bucket = 1
            while bucket <= top:
                tasks.append((sig, use_mmr, k, min(
                    bucket, self.config.micro_batch_size), knobs))
                bucket *= 2
        if parallel and len(tasks) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=4) as pool:
                list(pool.map(
                    lambda t: self._run_batch(["warm up"] * t[3],
                                              t[2], **t[4]),
                    tasks))
        else:
            for t in tasks:
                self._run_batch(["warm up"] * t[3], t[2], **t[4])
        for sig, use_mmr, *_ in tasks:
            self._warm_keys.add((sig[0], use_mmr))

    # -- rerank (reference retrieval.py:518-563) ------------------------------------

    def _combine_rerank_key(
        self,
        query: str,
        results: List[Dict[str, Any]],
        ce: np.ndarray,
    ) -> np.ndarray:
        """Host-path rerank key — same family as the fused program
        (ops/e2e.py): ``residual`` base + alpha*CE, ``zblend``, or
        ``replace`` (CE alone).  Base = exact per-tier rescore of the
        candidates (ops/rescore.py) when the manager supports it, else
        the fused retrieval score.  A CE ranking slates alone caps
        BELOW the retrieval order it reranks (it reads d_len tokens of
        a body BM25 scored in full) — measured -0.25 R@10 in round 2;
        the residual key is how the trained objective serves."""
        pc = getattr(self.index_manager, "config", None)
        mode = getattr(pc, "rerank_mode", "residual") if pc else "residual"
        if mode == "replace" or len(results) < 2:
            return ce

        def _z(v):
            v = np.asarray(v, np.float64)
            s = v.std()
            return (v - v.mean()) / (s if s > 1e-9 else 1.0)

        base_kind = getattr(pc, "rerank_base", "exact") if pc else "exact"
        alpha = float(getattr(pc, "rerank_alpha", 0.5)) if pc else 0.5
        mix = float(getattr(pc, "rescore_mix", 0.5)) if pc else 0.5
        base = None
        if base_kind == "exact" and self.index_manager is not None:
            rows = np.asarray([[int(r.get("row", -1)) for r in results]],
                              np.int32)
            if (rows >= 0).all():
                try:
                    d_ex, s_ex = self.index_manager.rescore_candidates_sync(
                        [query], rows)
                    base = _z(mix * _z(d_ex[0]) + (1.0 - mix) * _z(s_ex[0]))
                except IndexingError:
                    base = None    # PQ tier: fused fallback
        if base is None:
            base = _z([float(r.get("score", 0.0)) for r in results])
        if mode == "zblend":
            return alpha * _z(ce) + (1.0 - alpha) * base
        return base + alpha * ce

    def rerank_sync(
        self,
        query: str,
        results: List[Dict[str, Any]],
        top_k: int,
    ) -> List[Dict[str, Any]]:
        if not results:
            return []
        cls, profile = self.profile_for(query)
        if not (profile.use_reranking and self.config.use_reranking):
            return results[:top_k]
        if self.learned_ranker is not None:
            scores = self.learned_ranker.score_sync(results)
        elif self.reranker is not None:
            ce = np.asarray(self.reranker.score(
                query, [r.get("content") or "" for r in results]),
                np.float64)
            scores = self._combine_rerank_key(query, results, ce).tolist()
        else:
            # deterministic passthrough (the reference adds noise here,
            # retrieval.py:549-553 — a quirk we do not replicate)
            scores = [float(r.get("score", 0.0)) for r in results]
        order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
        out = []
        for rank, idx in enumerate(order[:top_k]):
            r = dict(results[int(idx)])
            r["rerank_score"] = float(scores[int(idx)])
            r["rerank_position"] = rank
            out.append(r)
        return out

    async def rerank(self, query: str, results: List[Dict[str, Any]],
                     top_k: int) -> List[Dict[str, Any]]:
        import asyncio

        return await asyncio.to_thread(self.rerank_sync, query, results, top_k)

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
        self._executor.shutdown(wait=False)


__all__ = ["HybridRetriever", "RetrievalProfile", "DEFAULT_PROFILES"]
