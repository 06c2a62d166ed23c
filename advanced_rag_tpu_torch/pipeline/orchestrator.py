"""AdvancedRAGPipeline: the end-to-end orchestrator.

The port of ``advanced_rag_tpu/pipeline/orchestrator.py`` over the port's
manager and models; it runs on the CUDA card unless ``device="cpu"``.

Capability parity with reference pipeline.py:26-448:
- `PipelineStage` enum (:26) and per-stage latency telemetry with a
  rolling 1000-sample window + P50/P95/P99 report (:116-118, :365-412);
- `ingest_documents` (:120-215): diagnostics -> data-quality flags
  (:414-442) -> adaptive chunking -> enrichment -> indexing ->
  compliance logging;
- `retrieve` (:217-309): rewrite -> hybrid retrieve -> rerank ->
  evaluate -> compliance log -> RetrievalResult, with SLA check vs
  target_latency_ms (:306-308);
- `plan_and_execute` (:311-348): decompose -> per-sub-query retrieve ->
  merged unique results;
- `detect_drift` (:350-363) and `get_performance_report` (:365-412).

Device design: ingest embeds in one batched forward; retrieve is one
fused pass over the device (ops/e2e.py or ops/hybrid.py) + the optional
cross-encoder.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import PipelineConfig
from ..index.corpus import ChunkRecord
from ..index.manager import MultiIndexManager
from ..models.encoder import CrossEncoder
from ..utils.constants import PerformanceConstants as PC
from .chunking import AdaptiveChunker, content_hash
from .compliance import ComplianceManager
from .diagnostics import DocumentDiagnostics
from .enrichment import SemanticEnricher
from .evaluation import DriftReport, RAGEvaluator
from .query_ops import QueryDecomposer, QueryRewriter
from .retrieval import HybridRetriever

logger = logging.getLogger(__name__)


class PipelineStage(str, Enum):
    """Reference pipeline.py:26-35."""

    DIAGNOSTICS = "diagnostics"
    CHUNKING = "chunking"
    ENRICHMENT = "enrichment"
    INDEXING = "indexing"
    QUERY_REWRITE = "query_rewrite"
    RETRIEVAL = "retrieval"
    RERANKING = "reranking"
    EVALUATION = "evaluation"
    COMPLIANCE = "compliance"


@dataclass
class RetrievalResult:
    """Reference pipeline.py:60-70."""

    chunk_id: str
    doc_id: str
    content: Optional[str]
    score: float
    metadata: Dict[str, Any] = field(default_factory=dict)


class AdvancedRAGPipeline:
    """Reference pipeline.py:72-448, device-resident index + models.

    ``device`` is where the default manager and its default models run:
    the CUDA card unless ``device="cpu"``; without a card it raises.  A
    given ``index_manager`` or ``retriever`` must be on that device.
    """

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        index_manager: Optional[MultiIndexManager] = None,
        retriever: Optional[HybridRetriever] = None,
        evaluator: Optional[RAGEvaluator] = None,
        compliance: Optional[ComplianceManager] = None,
        *,
        connect_to_milvus: bool = True,  # accepted for API parity; no-op
        device: DeviceLike = None,
    ):
        self.device = resolve_device(
            device if device is not None
            else getattr(index_manager, "device", None))
        self.config = config or PipelineConfig()
        self.diagnostics = DocumentDiagnostics()
        self.chunker = AdaptiveChunker(
            base_chunk_size=self.config.chunk_base_size,
            max_chunk_size=self.config.chunk_max_size,
            min_chunk_size=self.config.chunk_min_size,
            overlap_ratio=self.config.chunk_overlap,
            strategy=self.config.chunk_strategy,
        )
        self.enricher = SemanticEnricher()
        self.rewriter = QueryRewriter()
        self.decomposer = QueryDecomposer()
        self.index_manager = index_manager or MultiIndexManager(
            self.config,
            enable_sparse=self.config.enable_sparse,
            enable_domain=self.config.enable_domain,
            device=self.device,
        )
        if torch.device(self.index_manager.device) != self.device:
            raise ValueError(f"the manager is on {self.index_manager.device}, "
                             f"the pipeline on {self.device}")
        self.retriever = retriever or HybridRetriever(
            self.index_manager, self.config.retrieval, device=self.device
        )
        self.evaluator = evaluator or RAGEvaluator()
        self.compliance = compliance or ComplianceManager(
            tenant=self.config.compliance_tenant,
            retention_days=self.config.retention_days,
            index_deleter=self._forget_doc_rows,
        )
        self._stage_latencies: Dict[str, List[float]] = {
            s.value: [] for s in PipelineStage
        }
        self._retrieve_latencies: List[float] = []
        self._sla_met = 0
        self._sla_total = 0
        # fused program shapes run so far: {(k_out, k_rerank) ->
        # shape-relevant state fingerprint}.  The service's strict
        # latency budget must not apply to a signature whose fused
        # program has not run yet — its first use builds the kernels
        # and pays first launches, and retriever.is_warm only tracks the
        # UNFUSED shapes.  The fingerprint invalidates warmth when the
        # program's next call runs at new shapes or through other
        # kernels: reranker rewired, capacity doubling (emb shape), or a
        # storage-tier flip.
        self._fused_warm: Dict[tuple, tuple] = {}
        # fused-path micro-batcher (lazy): the fused program costs far
        # less per query at batch 8-16 than at batch 1, so concurrent
        # fused retrieves coalesce through the same continuous-batching
        # MicroBatcher the unfused path uses (pipeline/batcher.py),
        # keyed by (k-statics, filter spec) so semantics equal
        # unbatched execution.
        self._fused_batcher = None
        self._fused_batcher_lock = threading.Lock()

    def _fused_run_batch(self, queries: List[str], *, k_out: int,
                         k_rerank: int, filters=None) -> List[Any]:
        return self.index_manager.fused_retrieve_batch_sync(
            queries, k_out, filters,
            reranker=self.retriever.reranker,
            k_rerank=k_rerank,
            dense_weight=self.config.retrieval.dense_weight,
            sparse_weight=self.config.retrieval.sparse_weight,
            use_mmr=self.config.retrieval.use_mmr,
            mmr_lambda=self.config.retrieval.mmr_lambda,
            rerank_alpha=(None if self.config.rerank_mode == "replace"
                          else self.config.rerank_alpha),
            rerank_mode=self.config.rerank_mode,
            rerank_base=self.config.rerank_base,
            rescore_mix=self.config.rescore_mix,
            doc_dedupe=self.config.fused_doc_dedupe)

    def _fused_dispatch(self, query: str, k_out: int, k_rerank: int,
                        filters) -> List[Dict[str, Any]]:
        """One fused retrieve, micro-batched when enabled."""
        if not self.config.retrieval.enable_micro_batching:
            return self._fused_run_batch([query], k_out=k_out,
                                         k_rerank=k_rerank,
                                         filters=filters)[0]
        if self._fused_batcher is None:
            with self._fused_batcher_lock:
                if self._fused_batcher is None:
                    from .batcher import MicroBatcher

                    self._fused_batcher = MicroBatcher(
                        self._fused_run_batch,
                        max_batch=self.config.retrieval.micro_batch_size,
                        max_wait_s=(
                            self.config.retrieval.micro_batch_wait_ms
                            / 1e3),
                    )
        import json as _json

        fkey = (_json.dumps(filters, sort_keys=True, default=str)
                if filters else None)
        return self._fused_batcher.submit(
            (k_out, k_rerank, fkey), query,
            k_out=k_out, k_rerank=k_rerank, filters=filters)

    def _fused_state(self) -> tuple:
        """Shape-relevant state of the fused program: a change in any
        element sends its next call through new shapes or other kernels
        (first launches), so warmth recorded under the old state must
        not carry over (a strict budget would 504 that query)."""
        sem = self.index_manager.semantic
        return (id(self.retriever.reranker), sem.capacity,
                sem.has_ivf, sem._pq_mode, sem._sq8)

    def _use_fused_path(self) -> bool:
        """One-dispatch retrieve+rerank is used when configured AND all
        its pieces are live: a token table, a neural embedder, and a
        neural cross-encoder reranker on the retriever (bf16/f32/SQ8
        tiers).  The reranker must be the fused program's own
        (``models/encoder.py``); an HF embedder gets no token table.  HF
        checkpoints (``hf_embedder.py``, ``hf_cross_encoder.py``) thus take
        the default path, where JAX's gate sends them into a program that
        fails on them."""
        return (self.config.fused_rerank
                and self.config.enable_reranking
                and self.index_manager.token_table is not None
                and hasattr(self.index_manager.embedder, "model")
                and isinstance(getattr(self.retriever.reranker, "model", None),
                               CrossEncoder)
                and not self.index_manager.semantic.has_ivf
                and not self.index_manager.semantic._pq_mode)

    def _fused_sig(self, top_k: Optional[int]) -> tuple:
        """(k_out, k_rerank) shape statics for a retrieve request.

        An EXPLICIT top_k is honored in the response (the reference
        service returns the requested top_k, service.py:378-426);
        without one the pipeline serves its configured rerank_top_k.
        k-shapes bucket to multiples of 8 so distinct requests share
        program shapes."""
        if top_k is not None:
            k_out = max(1, min(int(top_k),
                               self.config.retrieval.max_top_k))
            k_rerank = -(-max(k_out, 16) // 8) * 8
        else:
            k_out = self.config.rerank_top_k
            k_rerank = min(self.config.top_k, 16)
        return k_out, k_rerank

    def is_warm(self, query: str, top_k: Optional[int] = None) -> bool:
        """Service-facing warm check covering the path retrieve() will
        actually take: the fused program's signature in
        fused mode, the retriever's program shapes otherwise."""
        if self._use_fused_path():
            return (self._fused_warm.get(self._fused_sig(top_k))
                    == self._fused_state())
        return self.retriever.is_warm(query, top_k)

    # -- telemetry ---------------------------------------------------------------

    def _record(self, stage: PipelineStage, t0: float) -> None:
        """Rolling window per stage (reference pipeline.py:406-412)."""
        lat = (time.perf_counter() - t0) * 1e3
        window = self._stage_latencies[stage.value]
        window.append(lat)
        if len(window) > PC.LATENCY_WINDOW:
            del window[: len(window) - PC.LATENCY_WINDOW]

    # -- ingest (reference pipeline.py:120-215) --------------------------------------

    def ingest_documents(
        self,
        documents: Sequence[Any],
        source: str = "",
        user: Optional[str] = None,
    ) -> Dict[str, Any]:
        """documents: strings or {'content': ..., 'doc_id': ..., 'metadata': ...}."""
        all_records: List[ChunkRecord] = []
        quality_flags: List[Dict[str, Any]] = []
        doc_chunk_counts: Dict[str, int] = {}
        doc_contents: Dict[str, str] = {}
        for doc in documents:
            if isinstance(doc, str):
                content, doc_id, extra = doc, None, {}
            else:
                content = doc.get("content", "")
                doc_id = doc.get("doc_id")
                extra = dict(doc.get("metadata") or {})
            if not content or not content.strip():
                quality_flags.append({"doc_id": doc_id, "flag": "empty_document"})
                continue
            doc_id = doc_id or content_hash(content)

            t0 = time.perf_counter()
            metrics = self.diagnostics.analyze_document(content)
            self._record(PipelineStage.DIAGNOSTICS, t0)
            quality_flags.extend(self._assess_data_quality(doc_id, metrics))

            t0 = time.perf_counter()
            chunks = self.chunker.chunk_document(
                content, doc_id=doc_id, metrics=metrics, source=source, extra=extra
            )
            self._record(PipelineStage.CHUNKING, t0)

            if self.config.enable_enrichment:
                t0 = time.perf_counter()
                for chunk in chunks:
                    enr = self.enricher.enrich(chunk.content)
                    chunk.metadata.extra["entities"] = enr.entities
                    chunk.metadata.extra["topics"] = enr.topics
                self._record(PipelineStage.ENRICHMENT, t0)

            for chunk in chunks:
                all_records.append(ChunkRecord(
                    chunk_id=chunk.chunk_id,
                    doc_id=chunk.doc_id,
                    content=chunk.content,
                    chunk_index=chunk.metadata.chunk_index,
                    token_count=chunk.metadata.token_count,
                    entropy=chunk.metadata.entropy,
                    redundancy=chunk.metadata.redundancy,
                    domain_density=chunk.metadata.domain_density,
                    timestamp=chunk.metadata.timestamp,
                    metadata=chunk.metadata.extra,
                ))
            doc_chunk_counts[doc_id] = len(chunks)
            doc_contents[doc_id] = content

        t0 = time.perf_counter()
        report = self.index_manager.index_chunks(all_records)
        self._record(PipelineStage.INDEXING, t0)

        if self.config.enable_compliance:
            t0 = time.perf_counter()
            for doc_id, n in doc_chunk_counts.items():
                self.compliance.log_ingestion(doc_id, n, user=user)
                self.compliance.create_version(doc_id, doc_contents[doc_id])
            self._record(PipelineStage.COMPLIANCE, t0)

        report["documents"] = len(doc_chunk_counts)
        report["quality_flags"] = quality_flags
        return report

    def _assess_data_quality(self, doc_id: str, metrics) -> List[Dict[str, Any]]:
        """Reference pipeline.py:414-442."""
        flags = []
        if metrics.token_count < 10:
            flags.append({"doc_id": doc_id, "flag": "very_short_document"})
        if metrics.redundancy > 0.8:
            flags.append({"doc_id": doc_id, "flag": "high_redundancy"})
        if metrics.entropy < 0.2 and metrics.token_count > 50:
            flags.append({"doc_id": doc_id, "flag": "low_information_density"})
        if metrics.vocabulary_diversity < 0.1 and metrics.token_count > 50:
            flags.append({"doc_id": doc_id, "flag": "low_vocabulary_diversity"})
        return flags

    # -- retrieve (reference pipeline.py:217-309) --------------------------------------

    def retrieve(
        self,
        query: str,
        top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        relevant_ids: Optional[Sequence[str]] = None,
        user: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Returns {'results': [RetrievalResult...], 'metrics': EvaluationMetrics,
        'latency_ms': float, 'sla_met': bool, 'rewritten_query': str}."""
        start = time.perf_counter()
        k_out, k_rerank = self._fused_sig(top_k)
        top_k = top_k or self.config.top_k

        t0 = time.perf_counter()
        rewritten = (self.rewriter.rewrite(query)
                     if self.config.enable_query_rewriting else query)
        self._record(PipelineStage.QUERY_REWRITE, t0)

        degraded: Optional[str] = None
        if self._use_fused_path():
            # fused retrieve+rerank (ops/e2e.py): embed, hybrid search,
            # and the cross-encoder run as one device program with one
            # host round trip — retrieval + reranking
            # stages collapse into one timed record each side.
            # Concurrent requests coalesce into one program call
            # (_fused_dispatch -> MicroBatcher).
            t0 = time.perf_counter()
            hits = self._fused_dispatch(rewritten, k_out, k_rerank,
                                        filters)
            self._fused_warm[(k_out, k_rerank)] = self._fused_state()
            self._record(PipelineStage.RETRIEVAL, t0)
            self._record(PipelineStage.RERANKING, t0)
        else:
            t0 = time.perf_counter()
            hits, degraded = self.retriever.retrieve_sync_ex(
                rewritten, max(top_k, k_out), filters)
            self._record(PipelineStage.RETRIEVAL, t0)

            if self.config.enable_reranking and hits:
                t0 = time.perf_counter()
                hits = self.retriever.rerank_sync(rewritten, hits, k_out)
                self._record(PipelineStage.RERANKING, t0)

        t0 = time.perf_counter()
        latency_ms = (time.perf_counter() - start) * 1e3
        result_emb = None
        rows = [h["row"] for h in hits if h.get("row", -1) >= 0]
        if rows:
            result_emb = self.index_manager.semantic.get_vectors(np.asarray(rows))
        metrics = self.evaluator.evaluate_retrieval(
            rewritten, hits, relevant_ids=relevant_ids, k=top_k,
            latency_ms=latency_ms, result_embeddings=result_emb,
        )
        self._record(PipelineStage.EVALUATION, t0)

        if self.config.enable_compliance:
            t0 = time.perf_counter()
            self.compliance.log_retrieval(
                query, [h["doc_id"] for h in hits], user=user
            )
            self._record(PipelineStage.COMPLIANCE, t0)

        latency_ms = (time.perf_counter() - start) * 1e3
        sla_met = latency_ms <= self.config.target_latency_ms
        self._retrieve_latencies.append(latency_ms)
        if len(self._retrieve_latencies) > PC.LATENCY_WINDOW:
            del self._retrieve_latencies[: len(self._retrieve_latencies)
                                         - PC.LATENCY_WINDOW]
        self._sla_total += 1
        self._sla_met += int(sla_met)

        results = [
            RetrievalResult(
                chunk_id=h["chunk_id"],
                doc_id=h["doc_id"],
                content=h.get("content"),
                score=float(h.get("rerank_score", h.get("score", 0.0))),
                metadata={k: v for k, v in h.items()
                          if k not in ("chunk_id", "doc_id", "content", "score")},
            )
            for h in hits
        ]
        return {
            "results": results,
            "metrics": metrics,
            "latency_ms": latency_ms,
            "sla_met": sla_met,
            "rewritten_query": rewritten,
            # non-None when the retrieval stage shed this request
            # (degrade-to-empty); the service counts it against the
            # shed budget and can convert it to 429 (RAG_SHED_POLICY)
            "degraded": degraded,
        }

    # -- plan & execute (reference pipeline.py:311-348) -----------------------------------

    def plan_and_execute(
        self, query: str, top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        plan = self.decomposer.decompose(query)
        seen: Dict[str, RetrievalResult] = {}
        sub_reports = []
        for sub in (plan.sub_queries or [query]):
            rep = self.retrieve(sub, top_k=top_k, filters=filters)
            sub_reports.append({"query": sub, "latency_ms": rep["latency_ms"],
                                "num_results": len(rep["results"])})
            for r in rep["results"]:
                if r.chunk_id not in seen:
                    seen[r.chunk_id] = r
        merged = sorted(seen.values(), key=lambda r: -r.score)
        return {
            "original_query": query,
            "is_complex": plan.is_complex,
            "sub_queries": plan.sub_queries,
            "sub_reports": sub_reports,
            "results": merged[: (top_k or self.config.top_k)],
        }

    def warm_up(self, top_k: Optional[int] = None,
                parallel: bool = False) -> None:
        """Run every retrieval program shape (all micro-batch buckets)
        once before taking traffic — see HybridRetriever.warm_up.
        Warms both k-buckets the serving path can hit: the retrieve
        ``top_k`` and the rerank depth.  ``parallel=True`` runs the
        signatures from a thread pool."""
        if self.index_manager.store.size == 0:
            return
        ks = {top_k or self.config.top_k, self.config.rerank_top_k}
        for k in sorted(ks):
            self.retriever.warm_up(k, parallel=parallel)
        if self._use_fused_path():
            # run the fused serving programs once: the default
            # signature (no explicit top_k) and each warmed k as an
            # explicit request — these are the exact statics retrieve()
            # derives, so the strict budget holds from the first query
            sigs = []
            for sig_k in [None] + sorted(ks):
                sig = self._fused_sig(sig_k)
                if (sig in sigs
                        or self._fused_warm.get(sig)
                        == self._fused_state()):
                    continue
                sigs.append(sig)

            def _warm_sig(sig):
                k_out, k_rerank = sig
                # run every pow2 query-batch bucket the fused
                # micro-batcher can form (mirrors the unfused
                # warm_up's bucket coverage)
                top = (self.config.retrieval.micro_batch_size
                       if self.config.retrieval.enable_micro_batching
                       else 1)
                b = 1
                while b <= top:
                    self._fused_run_batch(["warm up"] * b, k_out=k_out,
                                          k_rerank=k_rerank)
                    b *= 2
                self._fused_warm[sig] = self._fused_state()

            if parallel and len(sigs) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=4) as pool:
                    list(pool.map(_warm_sig, sigs))
            else:
                for sig in sigs:
                    _warm_sig(sig)

    # -- drift & report ---------------------------------------------------------------------

    def detect_drift(self, queries: Optional[Sequence[str]] = None) -> DriftReport:
        """Reference pipeline.py:350-363."""
        return self.evaluator.detect_drift(
            queries=queries,
            embed_fn=lambda q: self.index_manager.generate_semantic_embedding(q),
            threshold=self.config.drift_threshold,
        )

    @property
    def sla_compliance(self) -> float:
        """Rolling share of retrieves meeting target_latency_ms."""
        return self._sla_met / self._sla_total if self._sla_total else 1.0

    def get_performance_report(self) -> Dict[str, Any]:
        """P50/P95/P99 per stage + SLA compliance (reference pipeline.py:365-412)."""
        def pcts(vals: List[float]) -> Dict[str, float]:
            if not vals:
                return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "count": 0}
            arr = np.asarray(vals)
            return {
                "p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
                "p99": float(np.percentile(arr, 99)),
                "count": len(vals),
            }

        report = {
            "stages_ms": {s: pcts(v) for s, v in self._stage_latencies.items()},
            "retrieve_ms": pcts(self._retrieve_latencies),
            "target_latency_ms": self.config.target_latency_ms,
            "sla_compliance": self.sla_compliance,
            "index": self.index_manager.get_collection_stats(),
        }
        batcher = getattr(self.retriever, "_batcher", None)
        if batcher is not None:
            report["micro_batcher"] = dict(batcher.stats)
        if self._fused_batcher is not None:
            report["fused_micro_batcher"] = dict(self._fused_batcher.stats)
        return report

    # -- admin -------------------------------------------------------------------------------

    def _forget_doc_rows(self, doc_id: str) -> int:
        return self.index_manager.delete_by_filter(
            {"doc_id": doc_id}, forget_content=True
        )

    def forget_document(self, doc_id: str, user: Optional[str] = None) -> int:
        """Right-to-forget through compliance (legal holds enforced)."""
        return self.compliance.forget_document(doc_id, user=user)

    def close(self) -> None:
        """Reference pipeline.py:444-448."""
        if self._fused_batcher is not None:
            self._fused_batcher.close()
        self.retriever.close()
        self.index_manager.close()


__all__ = [
    "AdvancedRAGPipeline",
    "PipelineStage",
    "RetrievalResult",
]
