"""HTTP service: the L5 API surface on aiohttp.

The port of ``advanced_rag_tpu/service/app.py``: the same routes, knobs
and responses over the port's pipeline, on the CUDA card unless
``create_app(device="cpu")``.  ``RAG_EMBEDDER=ckpt:<dir>`` and
``RAG_RERANKER=ckpt:<dir>`` serve encoders saved in the port's format
(``train/loop.py``; ``scripts/torch_convert_checkpoints.py`` converts the
JAX package's orbax ones); ``/admin/index/checkpoint`` saves and restores
the index (``utils/checkpoint.py``, the JAX package's format) and a boot
with ``RAG_CHECKPOINT_DIR`` restores it, raising if that fails (the JAX
service logs and starts empty); ``/admin/index/maintain`` runs the
manager's maintenance pass.  ``RAG_RERANKER=hf:<dir>`` serves a local
BERT-family sequence-classification checkpoint (``models/hf_cross_encoder.py``,
read without ``transformers``).

Capability parity with reference service.py (FastAPI, 799 LoC):
- request-ID middleware (:97-105), API-key auth (:275-280),
  token-bucket rate limits per route (slowapi equivalents :368/:379/:644),
  circuit breaker + concurrency semaphore around retrieval (:141-149,
  :387-409), timeout -> HTTP 504 (:393-405), SIGTERM graceful drain
  (:87-94, :429-444);
- endpoints: /healthz (:312), /ingest (:367), /retrieve (:378),
  /feedback (:451), /metrics (:474), /chat + /chat/stream SSE +
  session management (:586-751), /etl/run (:753), /eval/run (:780);
- Prometheus counters/histograms/gauges (:128-132), OTel tracing
  best-effort (:298-309);
- chat persistence in SQLite/Postgres via DatabasePool (:200-272,
  :479-555); extractive answers from top-3 chunks with citations
  (:610-623) and templated suggestions (:626-640);
- per-request epsilon-greedy experiment variants (:152-183) — passed as
  per-request overrides, NOT by mutating the shared retriever config
  (the reference's documented race, service.py:166-168);
- the reference's /chat/stream NameError on undefined _cb_* helpers
  (:711-725) is a quirk we do not replicate: the breaker wraps the
  stream path through the same helpers as /retrieve.

aiohttp provides the reference's FastAPI surface.  The retrieval
pipeline itself is synchronous device code, so endpoints hop to a thread
via asyncio.to_thread under the semaphore.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import signal
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from aiohttp import web

from .. import DeviceLike, resolve_device
from ..config import PipelineConfig
from ..pipeline import AdvancedRAGPipeline, ExperimentManager
from ..utils.circuit_breaker import CircuitBreaker, CircuitBreakerConfig
from ..utils.constants import APIConstants as API
from ..utils.constants import PerformanceConstants as PC
from ..utils.db_pool import DatabasePool, initialize_pool
from ..utils.rate_limit import RateLimiter

logger = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).parent / "static"

# -- Prometheus metrics (reference service.py:128-132) -----------------------
# Collectors live in service/metrics.py, which executes once per process
# even when THIS module is executed twice (runpy __main__ + package
# import) — registration is idempotent with no private-API fallback.
from .metrics import (  # noqa: E402
    ACTIVE_REQUESTS,
    CONTENT_TYPE_LATEST,
    DRIFT_MAGNITUDE,
    EMBED_LATENCY,
    ERRORS_TOTAL,
    HALLUCINATION_RISK,
    PROM as _PROM,
    REQUESTS_TOTAL,
    RETRIEVE_LATENCY,
    SHED_TOTAL,
    SLA_COMPLIANCE,
    generate_latest,
)


def _json_error(status: int, message: str, request_id: str = "") -> web.Response:
    return web.json_response(
        {"error": message, "request_id": request_id}, status=status
    )


class ServiceState:
    """Everything the handlers share; built at startup."""

    def __init__(self, config: Optional[PipelineConfig] = None,
                 pipeline: Optional[AdvancedRAGPipeline] = None,
                 db: Optional[DatabasePool] = None, *,
                 device: DeviceLike = None):
        # The JAX service turns on XLA's persistent compile cache here
        # (RAG_COMPILE_CACHE); the port compiles nothing per shape: its
        # CUDA kernels are built once into build/kernels/ by _build.py.
        self.config = config or self._config_from_env()
        rk_env = os.environ.get("RAG_RERANKER", "")
        dev = resolve_device(device) if pipeline is None else pipeline.device
        # Preload a ckpt reranker before the manager builds the device
        # token table: the table truncates every chunk to fused_token_len
        # tokens, so it must cover the checkpoint's trained doc window
        # (pair_d_len).
        self._preloaded_reranker = None
        if (pipeline is None and self.config.fused_rerank
                and rk_env.lower().startswith("ckpt:")):
            self._preloaded_reranker = self._load_reranker(rk_env[5:], dev)
            d_len = self._preloaded_reranker.d_len
            if not os.environ.get("RAG_FUSED_TOKEN_LEN"):
                self.config.fused_token_len = max(
                    self.config.fused_token_len, int(d_len))
        if os.environ.get("RAG_FUSED_TOKEN_LEN"):
            self.config.fused_token_len = int(
                os.environ["RAG_FUSED_TOKEN_LEN"])
        if pipeline is not None and device is not None \
                and pipeline.device != resolve_device(device):
            raise ValueError(f"the pipeline is on {pipeline.device}, "
                             f"create_app was asked for {device}")
        self.pipeline = pipeline or AdvancedRAGPipeline(
            self.config, index_manager=self._make_manager(dev), device=dev)
        self.device = self.pipeline.device
        self._wire_rerankers()
        self.db = db or initialize_pool(
            os.environ.get("DATABASE_URL", ""),
            os.environ.get("CHAT_DB_PATH", "chat.db"),
        )
        self.api_key = os.environ.get("API_KEY", "")
        self.max_concurrency = int(os.environ.get(
            "RAG_MAX_CONCURRENCY", PC.MAX_CONCURRENT_REQUESTS))
        self.semaphore = asyncio.Semaphore(self.max_concurrency)
        # Admission control (shed budget, docs/SLO.md): requests beyond
        # max_concurrency in flight + max_queue waiting are rejected
        # with 429 instead of queueing into certain timeout.  Policy for
        # retrieval-stage degradation: "empty" serves the reference's
        # degrade-to-empty 200 (counted in rag_shed_total), "reject"
        # turns it into a 429 so clients can retry against a replica.
        self.max_queue = int(os.environ.get(
            "RAG_MAX_QUEUE", 4 * self.max_concurrency))
        self.waiting = 0
        self.shed_policy = os.environ.get("RAG_SHED_POLICY", "empty").lower()
        # endpoint wait = internal degrade budget + 100 ms headroom, so
        # the normal shed path is the accounted degrade-to-empty (shed
        # counters + alert), not an unaccounted 504 (_apply_env note)
        self.retrieve_timeout_s = (float(
            os.environ.get("RAG_RETRIEVE_TIMEOUT_MS",
                           PC.ENDPOINT_LATENCY_SLO_MS)) + 100.0) / 1e3
        self.breaker = CircuitBreaker(
            CircuitBreakerConfig(
                failure_threshold=int(os.environ.get("RAG_CB_FAILURES", 5)),
                timeout_seconds=float(os.environ.get("RAG_CB_TIMEOUT_S", 60)),
                success_threshold=int(os.environ.get("RAG_CB_SUCCESSES", 2)),
            ),
            name="retrieve",
        )
        self.experiments = ExperimentManager(
            epsilon=float(os.environ.get("EXPERIMENT_EPSILON", 0.1)))
        self.experiments.register("baseline", {})
        self.experiments.register("lexical_lean",
                                  {"dense_weight": 0.55, "sparse_weight": 0.45})
        # per-route token buckets; RAG_*_RPM envs let a deployment pick
        # its own admission points (e.g. raise ingest for a bulk load,
        # then roll back to the default for steady-state serving)
        self.limiters = {
            "ingest": RateLimiter(int(os.environ.get(
                "RAG_INGEST_RPM", API.INGEST_RATE_LIMIT_PER_MIN))),
            "retrieve": RateLimiter(int(os.environ.get(
                "RAG_RETRIEVE_RPM", API.RETRIEVE_RATE_LIMIT_PER_MIN))),
            "chat": RateLimiter(int(os.environ.get(
                "RAG_CHAT_RPM", API.CHAT_RATE_LIMIT_PER_MIN))),
        }
        self.draining = False
        self._init_db()
        if _PROM:
            # a prometheus Gauge exports 0 until first .set(); a fresh
            # or idle service would otherwise trip the critical
            # RagSlaComplianceLow alert (0 < 0.95 for 10m) before it has
            # served a single retrieve
            SLA_COMPLIANCE.set(1.0)

    @staticmethod
    def _load_reranker(path: str, device: torch.device):
        """A ``save_reranker`` checkpoint as the service's reranker, its
        pair layout restored from the checkpoint itself."""
        from ..models.cross_encoder import CrossEncoderReranker
        from ..train.rerank import load_reranker

        ce_cfg, model, layout = load_reranker(path, device)
        return CrossEncoderReranker(config=ce_cfg, state_dict=model.state_dict(),
                                    device=device, **layout)

    def _make_manager(self, device: torch.device):
        """RAG_EMBEDDER=ckpt:<dir>: serve a saved bi-encoder
        (``train/loop.py:save_biencoder``) instead of the default embedder.
        Unset -> None (the pipeline builds the default manager)."""
        kind = os.environ.get("RAG_EMBEDDER", "")
        if not kind.startswith("ckpt:"):
            return None
        from ..index.manager import MultiIndexManager
        from ..models.embedder import NeuralEmbedder
        from ..models.tokenizer import HashingTokenizer, TokenizerConfig
        from ..train.loop import load_biencoder

        enc_cfg, out_dim, model = load_biencoder(kind[5:], device)
        tok = HashingTokenizer(TokenizerConfig(
            vocab_size=enc_cfg.vocab_size, max_len=enc_cfg.max_len))
        emb = NeuralEmbedder(dim=out_dim, config=enc_cfg,
                             state_dict=model.state_dict(), tokenizer=tok,
                             device=device)
        self.config.semantic_dim = out_dim
        logger.info("embedder from checkpoint %s (dim %d)", kind[5:], out_dim)
        return MultiIndexManager(
            self.config, embedder=emb,
            enable_sparse=self.config.enable_sparse,
            enable_domain=self.config.enable_domain, device=device)

    @staticmethod
    def _config_from_env() -> PipelineConfig:
        """Env feature flags.  The reference DOCUMENTS ENABLE_MMR /
        ENABLE_ADAPTIVE_WEIGHTS (README.md:84-87) but never reads them
        (SURVEY.md §5); here they work."""
        def flag(name: str, default: bool) -> bool:
            val = os.environ.get(name)
            if val is None:
                return default
            return val.lower() not in ("0", "false", "no", "off")

        cfg = PipelineConfig()
        cfg.enable_sparse = flag("ENABLE_SPARSE", cfg.enable_sparse)
        cfg.enable_mmr = flag("ENABLE_MMR", cfg.enable_mmr)
        cfg.retrieval.enable_sparse = cfg.enable_sparse
        cfg.retrieval.use_mmr = cfg.enable_mmr
        cfg.retrieval.adaptive_weights = flag("ENABLE_ADAPTIVE_WEIGHTS",
                                              cfg.retrieval.adaptive_weights)
        # RAG_FUSED_E2E=1: fused retrieve+rerank (ops/e2e.py) —
        # neural bi-encoder + device token table + in-program
        # cross-encoder (the reranker is wired in _wire_rerankers)
        cfg.fused_rerank = flag("RAG_FUSED_E2E", cfg.fused_rerank)
        # doc-distinct rerank slates in the fused program (on by
        # default; RAG_FUSED_DOC_DEDUPE=0 restores chunk-row slates)
        cfg.fused_doc_dedupe = flag("RAG_FUSED_DOC_DEDUPE",
                                    cfg.fused_doc_dedupe)
        # rerank-key knobs (config.py PipelineConfig; pick alpha/mix on
        # a dev split — scripts/bench_quality_real.py prints them)
        cfg.rerank_mode = os.environ.get("RAG_RERANK_MODE",
                                         cfg.rerank_mode)
        cfg.rerank_base = os.environ.get("RAG_RERANK_BASE",
                                         cfg.rerank_base)
        if os.environ.get("RAG_RERANK_ALPHA"):
            cfg.rerank_alpha = float(os.environ["RAG_RERANK_ALPHA"])
        if os.environ.get("RAG_RESCORE_MIX"):
            cfg.rescore_mix = float(os.environ["RAG_RESCORE_MIX"])
        # fusion operating point (RetrievalConfig defaults 0.7/0.3 are
        # dense-leaning; the quality bench picks the corpus's weights on
        # a dev split — scripts/bench_quality_real.py prints them)
        if os.environ.get("RAG_DENSE_WEIGHT"):
            cfg.retrieval.dense_weight = float(
                os.environ["RAG_DENSE_WEIGHT"])
        if os.environ.get("RAG_SPARSE_WEIGHT"):
            cfg.retrieval.sparse_weight = float(
                os.environ["RAG_SPARSE_WEIGHT"])
        # ingest chunk window (word tokens) — size to the serving
        # encoder's window so the dense tier ranks the text it can read
        if os.environ.get("RAG_CHUNK_BASE"):
            cfg.chunk_base_size = int(os.environ["RAG_CHUNK_BASE"])
        if os.environ.get("RAG_CHUNK_MAX"):
            cfg.chunk_max_size = int(os.environ["RAG_CHUNK_MAX"])
        if os.environ.get("RAG_CHUNK_MIN"):
            cfg.chunk_min_size = int(os.environ["RAG_CHUNK_MIN"])
        # sliding-window ingest geometry (the quality protocol's):
        # RAG_CHUNK_STRATEGY=window + RAG_CHUNK_OVERLAP=0.27 indexes
        # base-size word windows at stride base*(1-overlap)
        if os.environ.get("RAG_CHUNK_STRATEGY"):
            cfg.chunk_strategy = os.environ["RAG_CHUNK_STRATEGY"]
        if os.environ.get("RAG_CHUNK_OVERLAP"):
            cfg.chunk_overlap = float(os.environ["RAG_CHUNK_OVERLAP"])
        # RAG_MICRO_BATCH: device query-batch cap for continuous
        # batching (pow2; warm-up runs each bucket once)
        mb = os.environ.get("RAG_MICRO_BATCH")
        if mb:
            cfg.retrieval.micro_batch_size = max(1, int(mb))
        # RAG_RETRIEVE_TIMEOUT_MS is the ONE latency-budget knob: it
        # sets the retriever's internal degrade budget here, and the
        # endpoint wait (ServiceState.retrieve_timeout_s) sits 100 ms
        # above it so degrade-to-empty — the accounted shed path
        # (rag_shed_total) — fires before a 504.  The endpoint SLO is
        # P95-based (docs/SLO.md): a budget above 300 ms trades tail
        # latency against shed rate without touching the P95 target.
        rt = os.environ.get("RAG_RETRIEVE_TIMEOUT_MS")
        if rt:
            cfg.retrieval.timeout_seconds = float(rt) / 1e3
        return cfg

    def _wire_rerankers(self) -> None:
        """RAG_RERANKER env: cross_encoder | ckpt:<dir> | hf:<dir> |
        learned | passthrough."""
        kind = os.environ.get("RAG_RERANKER", "").lower()
        retriever = self.pipeline.retriever
        if (self.config.fused_rerank and not kind
                and retriever.reranker is None):
            # the fused path scores pairs in-program; it needs the
            # cross-encoder even when RAG_RERANKER was not set
            kind = "cross_encoder"
        if kind == "cross_encoder" and retriever.reranker is None:
            from ..models.cross_encoder import CrossEncoderReranker

            retriever.reranker = CrossEncoderReranker(device=self.device)
        elif kind.startswith("ckpt:") and retriever.reranker is None:
            # preloaded in __init__ to size the token table, else loaded here
            retriever.reranker = (self._preloaded_reranker
                                  or self._load_reranker(
                                      os.environ["RAG_RERANKER"][5:], self.device))
        elif kind.startswith("hf:") and retriever.reranker is None:
            from ..models.hf_cross_encoder import HFCrossEncoder

            # a local ms-marco-class checkpoint (JAX app.py:333-338)
            retriever.reranker = HFCrossEncoder(
                os.environ["RAG_RERANKER"][3:], device=self.device)
        elif kind == "learned" and retriever.learned_ranker is None:
            from ..pipeline.ranker import LearnedRanker

            retriever.learned_ranker = LearnedRanker()
        if (self.config.retrieval.adaptive_weights
                and retriever.weight_adapter is None):
            from ..pipeline.ranker import LearnedHybridAdapter

            retriever.weight_adapter = LearnedHybridAdapter()

    # -- chat schema (reference service.py:200-272) ---------------------------

    def _init_db(self) -> None:
        with self.db.get_connection() as conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS sessions ("
                "id TEXT PRIMARY KEY, title TEXT, created_at REAL)")
            conn.execute(
                "CREATE TABLE IF NOT EXISTS messages ("
                "id INTEGER PRIMARY KEY AUTOINCREMENT, session_id TEXT,"
                "role TEXT, content TEXT, created_at REAL)")
            conn.execute(
                "CREATE TABLE IF NOT EXISTS feedback ("
                "id INTEGER PRIMARY KEY AUTOINCREMENT, session_id TEXT,"
                "message_id INTEGER, positive INTEGER, comment TEXT,"
                "created_at REAL)")
            conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_messages_session"
                " ON messages(session_id)")

    def append_message(self, session_id: str, role: str, content: str) -> int:
        with self.db.get_connection() as conn:
            conn.execute(
                "INSERT OR IGNORE INTO sessions (id, title, created_at)"
                " VALUES (?, ?, ?)",
                (session_id, content[:48], time.time()))
            cur = conn.execute(
                "INSERT INTO messages (session_id, role, content, created_at)"
                " VALUES (?, ?, ?, ?)",
                (session_id, role, content, time.time()))
            return int(cur.lastrowid)


# -- middlewares ---------------------------------------------------------------

@web.middleware
async def request_id_middleware(request: web.Request, handler):
    """X-Request-ID propagation (reference service.py:97-105)."""
    rid = request.headers.get("X-Request-ID", uuid.uuid4().hex)
    request["request_id"] = rid
    try:
        if _PROM:
            ACTIVE_REQUESTS.inc()
        response = await handler(request)
    except web.HTTPException as exc:
        exc.headers["X-Request-ID"] = rid
        if _PROM:
            REQUESTS_TOTAL.labels(request.path, str(exc.status)).inc()
        raise
    except Exception:
        logger.exception("unhandled error (request %s)", rid)
        if _PROM:
            ERRORS_TOTAL.labels("internal").inc()
            REQUESTS_TOTAL.labels(request.path, "500").inc()
        return _json_error(500, "internal error", rid)
    finally:
        if _PROM:
            ACTIVE_REQUESTS.dec()
    response.headers["X-Request-ID"] = rid
    if _PROM:
        REQUESTS_TOTAL.labels(request.path, str(response.status)).inc()
    return response


def _auth_ok(state: ServiceState, request: web.Request) -> bool:
    """API-key auth when configured (reference service.py:275-280)."""
    if not state.api_key:
        return True
    return request.headers.get("X-API-Key", "") == state.api_key


def _client_key(request: web.Request) -> str:
    peer = request.headers.get("X-Forwarded-For", "")
    if not peer and request.transport is not None:
        info = request.transport.get_extra_info("peername")
        peer = info[0] if info else "local"
    return peer or "local"


def _rate_limited(state: ServiceState, name: str,
                  request: web.Request) -> Optional[web.Response]:
    limiter = state.limiters[name]
    key = _client_key(request)
    if not limiter.allow(key):
        if _PROM:
            ERRORS_TOTAL.labels("rate_limit").inc()
        return web.json_response(
            {"error": "rate limit exceeded",
             "retry_after_s": round(limiter.retry_after(key), 2)},
            status=429)
    return None


# -- handlers --------------------------------------------------------------------

async def healthz(request: web.Request) -> web.Response:
    """Per-dependency health (reference service.py:312-360)."""
    state: ServiceState = request.app["state"]
    stats = state.pipeline.index_manager.get_collection_stats()
    try:
        with state.db.get_connection() as conn:
            conn.execute("SELECT 1")
        db_ok = True
    except Exception:
        db_ok = False
    status = "draining" if state.draining else "ok"
    return web.json_response({
        "status": status,
        "dependencies": {
            "index": {"status": "ok", "rows": stats["store"]["valid"]},
            "database": {"status": "ok" if db_ok else "error",
                         "backend": state.db.backend},
            "devices": [torch.cuda.get_device_name(state.device)
                        if state.device.type == "cuda" else str(state.device)],
        },
        "circuit_breaker": state.breaker.get_stats(),
    })


async def ingest(request: web.Request) -> web.Response:
    """Reference service.py:367-375 (10/min, auth, 1MB doc cap)."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    limited = _rate_limited(state, "ingest", request)
    if limited:
        return limited
    body = await request.json()
    documents = body.get("documents", [])
    if not isinstance(documents, list) or not documents:
        return _json_error(400, "documents must be a non-empty list",
                           request["request_id"])
    for doc in documents:
        content = doc.get("content", "") if isinstance(doc, dict) else str(doc)
        if len(content.encode("utf-8", "ignore")) > API.MAX_DOCUMENT_BYTES:
            return _json_error(413, "document exceeds 1MB cap",
                               request["request_id"])
    t0 = time.perf_counter()
    report = await asyncio.to_thread(state.pipeline.ingest_documents, documents)
    if _PROM:
        EMBED_LATENCY.observe(time.perf_counter() - t0)
    return web.json_response({
        "indexed": report["indexed"],
        "documents": report["documents"],
        "errors": report["errors"],
        "quality_flags": report["quality_flags"],
        "elapsed_ms": report["elapsed_ms"],
    })


def _variant_overrides(state: ServiceState) -> tuple[str, Dict[str, Any]]:
    """Per-request experiment variant as overrides (NOT shared mutation)."""
    name = state.experiments.choose_variant() or "baseline"
    return name, dict(state.experiments.variants[name].config)


async def _guarded_retrieve(state: ServiceState, query: str,
                            top_k: Optional[int],
                            filters: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Breaker + admission bound + semaphore + timeout (reference
    service.py:384-409, plus the shed budget the reference lacks)."""
    from ..utils.exceptions import CircuitBreakerOpenError, OverloadError

    if state.breaker.is_open():
        raise CircuitBreakerOpenError("retrieval circuit open")
    if state.waiting >= state.max_queue:
        # reject at admission instead of queueing into certain timeout
        if _PROM:
            SHED_TOTAL.labels("admission").inc()
        raise OverloadError("request queue full")
    variant, _overrides = _variant_overrides(state)
    # strict budget only once THIS query's program signature has run
    # (its first use builds the kernels and pays first launches; in
    # fused mode the fused program's (k_out, k_rerank) statics are the
    # key)
    warm = state.pipeline.is_warm(query, top_k)
    state.waiting += 1
    in_queue = True
    try:
        async with state.semaphore:
            state.waiting -= 1
            in_queue = False
            try:
                out = await asyncio.wait_for(
                    asyncio.to_thread(state.pipeline.retrieve, query,
                                      top_k, filters),
                    timeout=(max(state.retrieve_timeout_s, 1e-3)
                             if warm else None),
                )
            except asyncio.TimeoutError:
                if _PROM:
                    SHED_TOTAL.labels("timeout").inc()
                state.breaker.record_failure()
                raise
            except Exception:
                state.breaker.record_failure()
                raise
    finally:
        if in_queue:
            state.waiting -= 1
    if out.get("degraded"):
        # degrade-to-empty 200: invisible to the 5xx error SLO, so it
        # gets explicit shed accounting (VERDICT r2 weak #5)
        if _PROM:
            SHED_TOTAL.labels(str(out["degraded"])).inc()
        if state.shed_policy == "reject":
            raise OverloadError("retrieval shed under load")
    state.breaker.record_success()
    out["experiment_variant"] = variant
    state.experiments.record_outcome(variant, bool(out["results"]),
                                     reward=1.0 if out["sla_met"] else 0.5)
    return out


def _result_payload(out: Dict[str, Any]) -> Dict[str, Any]:
    m = out["metrics"]
    return {
        "results": [
            {"chunk_id": r.chunk_id, "doc_id": r.doc_id, "content": r.content,
             "score": r.score,
             "metadata": {k: v for k, v in r.metadata.items()
                          if isinstance(v, (str, int, float, bool, list))}}
            for r in out["results"]
        ],
        "metrics": {
            "hallucination_risk": m.hallucination_risk,
            "faithfulness": m.faithfulness,
            "coverage": m.coverage,
            "diversity": m.diversity,
            "confidence": m.confidence,
            "num_results": m.num_results,
        },
        "latency_ms": out["latency_ms"],
        "sla_met": out["sla_met"],
        "rewritten_query": out["rewritten_query"],
        "experiment_variant": out.get("experiment_variant", "baseline"),
    }


async def retrieve(request: web.Request) -> web.Response:
    """Reference service.py:378-426."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    limited = _rate_limited(state, "retrieve", request)
    if limited:
        return limited
    body = await request.json()
    query = (body.get("query") or "").strip()
    if not query or len(query) > API.MAX_QUERY_CHARS:
        return _json_error(400, "query must be 1..4096 chars",
                           request["request_id"])
    from ..utils.exceptions import (
        CircuitBreakerOpenError, OverloadError, ValidationError)

    t0 = time.perf_counter()
    try:
        out = await _guarded_retrieve(state, query, body.get("top_k"),
                                      body.get("filters"))
    except CircuitBreakerOpenError:
        return _json_error(503, "service temporarily unavailable (breaker open)",
                           request["request_id"])
    except OverloadError:
        resp = _json_error(429, "overloaded — retry shortly",
                           request["request_id"])
        resp.headers["Retry-After"] = "1"
        return resp
    except asyncio.TimeoutError:
        if _PROM:
            ERRORS_TOTAL.labels("timeout").inc()
        return _json_error(504, "retrieval timed out", request["request_id"])
    except ValidationError as exc:
        return _json_error(400, str(exc), request["request_id"])
    if _PROM:
        RETRIEVE_LATENCY.observe((time.perf_counter() - t0) * 1e3)
        # quality gauges for the alert rules (ref ARCHITECTURE.md:369-373)
        HALLUCINATION_RISK.set(out["metrics"].hallucination_risk)
        SLA_COMPLIANCE.set(state.pipeline.sla_compliance)
    return web.json_response(_result_payload(out))


async def feedback(request: web.Request) -> web.Response:
    """Reference service.py:451-472: persist thumbs + update rankers
    (auth-guarded there via _auth_or_401 at :454)."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    body = await request.json()
    positive = bool(body.get("positive", True))
    with state.db.get_connection() as conn:
        conn.execute(
            "INSERT INTO feedback (session_id, message_id, positive, comment,"
            " created_at) VALUES (?, ?, ?, ?, ?)",
            (body.get("session_id", ""), body.get("message_id", 0),
             int(positive), body.get("comment", ""), time.time()))
    retriever = state.pipeline.retriever
    if retriever.learned_ranker is not None and body.get("result"):
        retriever.learned_ranker.update_from_feedback(body["result"], positive)
    if retriever.weight_adapter is not None:
        retriever.weight_adapter.fit_from_feedback(
            [(body.get("method", "hybrid"), positive)])
    return web.json_response({"status": "recorded"})


async def metrics(request: web.Request) -> web.Response:
    """Prometheus exposition (reference service.py:474-476)."""
    if not _PROM:
        return _json_error(501, "prometheus_client unavailable")
    return web.Response(body=generate_latest(),
                        content_type=CONTENT_TYPE_LATEST.split(";")[0])


# -- chat (reference service.py:586-751) ------------------------------------------

def _make_answer(query: str, results) -> tuple[str, list]:
    """Extractive answer from top-3 chunks + citations (reference :610-623)."""
    top = [r for r in results[:3] if r.content]
    if not top:
        return ("I could not find relevant context for that question.", [])
    snippets, citations = [], []
    for r in top:
        first = r.content.split(". ")[0].strip()
        snippets.append(first if first.endswith(".") else first + ".")
        citations.append({"doc_id": r.doc_id, "chunk_id": r.chunk_id,
                          "score": r.score})
    return (" ".join(snippets), citations)


def _suggestions(query: str) -> list:
    """Templated follow-ups (reference service.py:626-640)."""
    q = query.rstrip("?. ")
    return [
        f"Summarize the documents about {q}",
        f"What are common issues with {q}?",
        f"Compare approaches to {q}",
        f"Show recent updates on {q}",
    ]


async def chat(request: web.Request) -> web.Response:
    """Reference service.py:643-696."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    limited = _rate_limited(state, "chat", request)
    if limited:
        return limited
    body = await request.json()
    query = (body.get("message") or body.get("query") or "").strip()
    if not query:
        return _json_error(400, "message required", request["request_id"])
    session_id = body.get("session_id") or uuid.uuid4().hex
    await asyncio.to_thread(state.append_message, session_id, "user", query)
    from ..utils.exceptions import CircuitBreakerOpenError, OverloadError

    try:
        out = await _guarded_retrieve(state, query, None, body.get("filters"))
    except CircuitBreakerOpenError:
        return _json_error(503, "service temporarily unavailable",
                           request["request_id"])
    except OverloadError:
        resp = _json_error(429, "overloaded — retry shortly",
                           request["request_id"])
        resp.headers["Retry-After"] = "1"
        return resp
    except asyncio.TimeoutError:
        return _json_error(504, "retrieval timed out", request["request_id"])
    answer, citations = _make_answer(query, out["results"])
    message_id = await asyncio.to_thread(
        state.append_message, session_id, "assistant", answer)
    return web.json_response({
        "session_id": session_id,
        "message_id": message_id,
        "answer": answer,
        "citations": citations,
        "suggestions": _suggestions(query),
        "metrics": _result_payload(out)["metrics"],
        "latency_ms": out["latency_ms"],
    })


async def chat_stream(request: web.Request) -> web.StreamResponse:
    """SSE token streaming (reference service.py:703-751).  Unlike the
    reference, the breaker path here uses real helpers (the reference
    calls undefined _cb_* and NameErrors — SURVEY.md §7)."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    limited = _rate_limited(state, "chat", request)
    if limited:
        return limited
    query = (request.query.get("message") or request.query.get("q") or "").strip()
    session_id = request.query.get("session_id") or uuid.uuid4().hex
    if not query:
        return _json_error(400, "message required", request["request_id"])

    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Connection": "keep-alive",
    })
    await resp.prepare(request)

    async def send(event: str, data: Any) -> None:
        await resp.write(
            f"event: {event}\ndata: {json.dumps(data)}\n\n".encode())

    await asyncio.to_thread(state.append_message, session_id, "user", query)
    from ..utils.exceptions import CircuitBreakerOpenError, OverloadError

    try:
        out = await _guarded_retrieve(state, query, None, None)
    except (CircuitBreakerOpenError, OverloadError,
            asyncio.TimeoutError) as exc:
        await send("error", {"error": str(exc) or "unavailable"})
        await resp.write_eof()
        return resp
    answer, citations = _make_answer(query, out["results"])
    for token in answer.split(" "):
        await send("token", {"token": token + " "})
        await asyncio.sleep(API.STREAM_TOKEN_INTERVAL_S)
    message_id = await asyncio.to_thread(
        state.append_message, session_id, "assistant", answer)
    await send("done", {
        "session_id": session_id,
        "message_id": message_id,
        "citations": citations,
        "suggestions": _suggestions(query),
        "metrics": _result_payload(out)["metrics"],
    })
    await resp.write_eof()
    return resp


async def chat_sessions(request: web.Request) -> web.Response:
    state: ServiceState = request.app["state"]
    with state.db.get_connection() as conn:
        rows = conn.execute(
            "SELECT id, title, created_at FROM sessions"
            " ORDER BY created_at DESC LIMIT 50").fetchall()
    return web.json_response({"sessions": [dict(r) for r in rows]})


async def chat_history(request: web.Request) -> web.Response:
    state: ServiceState = request.app["state"]
    session_id = request.match_info["session_id"]
    with state.db.get_connection() as conn:
        rows = conn.execute(
            "SELECT id, role, content, created_at FROM messages"
            " WHERE session_id = ? ORDER BY id", (session_id,)).fetchall()
    return web.json_response({"session_id": session_id,
                              "messages": [dict(r) for r in rows]})


async def chat_clear(request: web.Request) -> web.Response:
    state: ServiceState = request.app["state"]
    session_id = request.match_info["session_id"]
    with state.db.get_connection() as conn:
        conn.execute("DELETE FROM messages WHERE session_id = ?", (session_id,))
        conn.execute("DELETE FROM sessions WHERE id = ?", (session_id,))
    return web.json_response({"status": "cleared"})


async def etl_run(request: web.Request) -> web.Response:
    """Filesystem ETL of .txt/.md under a root (reference service.py:753-778)."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    body = await request.json()
    root = Path(body.get("root", "."))
    if not root.is_dir():
        return _json_error(400, f"not a directory: {root}",
                           request["request_id"])
    docs = []
    for path in sorted(root.rglob("*")):
        if path.suffix.lower() in (".txt", ".md") and path.is_file():
            try:
                docs.append({"doc_id": str(path), "content":
                             path.read_text("utf-8", errors="ignore")})
            except OSError:
                continue
    if not docs:
        return web.json_response({"indexed": 0, "documents": 0})
    report = await asyncio.to_thread(state.pipeline.ingest_documents, docs)
    return web.json_response({"indexed": report["indexed"],
                              "documents": report["documents"]})


async def eval_run(request: web.Request) -> web.Response:
    """Batch eval aggregating metrics (reference service.py:780-798)."""
    state: ServiceState = request.app["state"]
    body = await request.json()
    cases = body.get("cases", [])
    if not cases:
        return _json_error(400, "cases required", request["request_id"])
    agg: Dict[str, list] = {"precision_at_k": [], "recall_at_k": [],
                            "mrr": [], "ndcg": [], "latency_ms": []}
    for case in cases:
        out = await asyncio.to_thread(
            state.pipeline.retrieve, case.get("query", ""),
            case.get("top_k"), case.get("filters"),
            case.get("relevant_ids"))
        m = out["metrics"]
        agg["precision_at_k"].append(m.precision_at_k)
        agg["recall_at_k"].append(m.recall_at_k)
        agg["mrr"].append(m.mrr)
        agg["ndcg"].append(m.ndcg)
        agg["latency_ms"].append(out["latency_ms"])
    mean = {k: (sum(v) / len(v) if v else 0.0) for k, v in agg.items()}
    return web.json_response({"cases": len(cases), "mean": mean})


async def drift(request: web.Request) -> web.Response:
    state: ServiceState = request.app["state"]
    body = await request.json() if request.can_read_body else {}
    rep = await asyncio.to_thread(state.pipeline.detect_drift,
                                  body.get("queries"))
    if _PROM:
        DRIFT_MAGNITUDE.set(rep.magnitude)
    return web.json_response({
        "drift_detected": rep.drift_detected,
        "magnitude": rep.magnitude,
        "embedding_divergence": rep.embedding_divergence,
        "distribution_shift": rep.distribution_shift,
        "recommendations": rep.recommendations,
    })


async def perf_report(request: web.Request) -> web.Response:
    state: ServiceState = request.app["state"]
    return web.json_response(state.pipeline.get_performance_report())


async def index_stats(request: web.Request) -> web.Response:
    """Index geometry + IVF/rebuild state (reference indexing.py:678)."""
    state: ServiceState = request.app["state"]
    return web.json_response(
        state.pipeline.index_manager.get_collection_stats())


async def index_checkpoint(request: web.Request) -> web.Response:
    """Persist or restore the full index state (``utils/checkpoint.py``).
    Body: {"dir": "/path", "action": "save"|"load"}.  A restore needs an
    empty manager (a fresh boot), as ``load_index`` does; every tier the
    JAX package saves, OPQ and IVF-PQ included, restores."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    body = await request.json() if request.can_read_body else {}
    ckpt_dir = body.get("dir") or os.environ.get("RAG_CHECKPOINT_DIR")
    if not ckpt_dir:
        return _json_error(400, "dir required (or RAG_CHECKPOINT_DIR)",
                           request["request_id"])
    # Path confinement: the API key is shared across routes, and an
    # arbitrary body dir would grant arbitrary file writes ("save") and
    # reads ("load").  Only RAG_CHECKPOINT_ROOT or the exact
    # RAG_CHECKPOINT_DIR.
    root = os.environ.get("RAG_CHECKPOINT_ROOT")
    fixed = os.environ.get("RAG_CHECKPOINT_DIR")
    resolved = Path(ckpt_dir).resolve()
    allowed = (
        (root and Path(root).resolve() in [resolved, *resolved.parents])
        or (fixed and resolved == Path(fixed).resolve())
    )
    if not allowed:
        return _json_error(
            403, "dir outside RAG_CHECKPOINT_ROOT", request["request_id"])
    action = body.get("action", "save")
    mgr = state.pipeline.index_manager
    from ..utils.checkpoint import load_index, save_index

    # the write lock is taken inside the worker thread, never on the loop
    def _save():
        with mgr._write_cv:
            # a lock-only snapshot is not consistent: an ingest claims rows
            # and releases the lock to embed, so wait until none is in flight
            while mgr._inflight_rows:
                mgr._write_cv.wait(timeout=60.0)
            return save_index(mgr, ckpt_dir)

    def _load():
        with mgr._write_lock, torch.inference_mode():
            if mgr.store.size != 0:
                # refused before anything is touched, so not rolled back:
                # the JAX app's rollback here empties the serving index
                raise ValueError("load_index requires a fresh manager")
            try:
                load_index(mgr, ckpt_dir)
            except Exception:
                # load_index fills the store before the dense files stream
                # in: roll back so the manager is not torn and a retry works
                mgr.reset_state()
                raise
            return mgr.store.size

    try:
        if action == "save":
            manifest = await asyncio.to_thread(_save)
            return web.json_response({"saved": True,
                                      "rows": manifest["size"]})
        if action == "load":
            rows = await asyncio.to_thread(_load)
            return web.json_response({"loaded": True, "rows": rows})
        return _json_error(400, f"unknown action {action!r}",
                           request["request_id"])
    except (ValueError, FileNotFoundError) as exc:
        return _json_error(409, str(exc), request["request_id"])


def _maintain(state: "ServiceState", body: Dict[str, Any]) -> Dict[str, Any]:
    """``/admin/index/maintain``'s work in one worker thread: the requested
    tier builds, one maintenance pass, then the optional nprobe tuning."""
    mgr = state.pipeline.index_manager
    sem = mgr.semantic
    with torch.inference_mode():
        # builds and maintenance take the manager's write lock: they swap
        # semantic.emb, which must not race an ingest's commit
        out = mgr.build_semantic(pq=bool(body.get("build_pq")),
                                 ivf=bool(body.get("build_ivf")))
        out.update(mgr.maintenance_tick())
        target = body.get("tune_recall")
        if target and (sem.has_ivf or sem.has_ivfpq):
            out["nprobe"], out["tuned_recall"] = sem.tune_nprobe(float(target))
    return out


async def index_maintain(request: web.Request) -> web.Response:
    """One maintenance pass now (build-then-swap IVF build or rebuild,
    postings compaction); body {"build_ivf": true} forces a first build,
    {"tune_recall": 0.95} tunes nprobe after."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    body = await request.json() if request.can_read_body else {}
    return web.json_response(await asyncio.to_thread(_maintain, state, body))


async def admin_warmup(request: web.Request) -> web.Response:
    """Deterministically run every retrieval program shape once — each
    (k-bucket, mmr) x pow2 micro-batch bucket — for the given top_k
    values (body ``{"top_k": [5, 20]}``; default = configured
    top_k/rerank depth).  Call after bulk ingest or an index rebuild:
    shapes depend on the corpus capacity, and HTTP-burst "warming" is
    nondeterministic (continuous batching coalesces arbitrary sizes, so
    a never-formed bucket pays its first use under live traffic)."""
    state: ServiceState = request.app["state"]
    if not _auth_ok(state, request):
        return _json_error(401, "invalid API key", request["request_id"])
    body = await request.json() if request.can_read_body else {}
    ks = body.get("top_k") or [None]
    if not isinstance(ks, list):
        ks = [ks]
    t0 = time.perf_counter()
    for k in ks:
        await asyncio.to_thread(state.pipeline.warm_up,
                                int(k) if k is not None else None)
    if os.environ.get("RAG_GC_TUNE", "1") != "0":
        # The steady-state object graph (models, index handles, corpus
        # metadata — hundreds of MB after bulk ingest) is permanent;
        # without this, full gen-2 collections re-scan all of it under
        # load and show up as ~0.5% of requests stalling past even a
        # 750 ms budget.  freeze() moves everything reachable NOW into
        # the permanent generation; the raised gen-0 threshold batches
        # the churn of request handling.
        import gc

        gc.collect()
        gc.freeze()
        gc.set_threshold(200_000, 50, 100)
    return web.json_response({
        "warmed_top_k": [k if k is not None
                         else state.pipeline.config.top_k for k in ks],
        "seconds": round(time.perf_counter() - t0, 2),
    })


async def index_page(request: web.Request) -> web.Response:
    return web.FileResponse(STATIC_DIR / "index.html")


# -- app factory --------------------------------------------------------------------

def create_app(config: Optional[PipelineConfig] = None,
               pipeline: Optional[AdvancedRAGPipeline] = None,
               db: Optional[DatabasePool] = None, *,
               device: DeviceLike = None) -> web.Application:
    """The service on ``device`` (the CUDA card unless ``"cpu"``; without
    a card it raises), or on the given pipeline's device.

    When ``RAG_CHECKPOINT_DIR`` holds a saved index and the manager is
    empty, the index is restored before the app takes traffic.  A failed
    restore is rolled back and raises: the JAX service logs and starts
    empty, which would serve an empty corpus in place of the saved one."""
    app = web.Application(middlewares=[request_id_middleware],
                          client_max_size=16 * 1024 * 1024)
    state = ServiceState(config, pipeline, db, device=device)
    app["state"] = state

    ckpt_dir = os.environ.get("RAG_CHECKPOINT_DIR")
    if ckpt_dir and (Path(ckpt_dir) / "manifest.json").exists():
        mgr = state.pipeline.index_manager
        if mgr.store.size == 0:
            from ..utils.checkpoint import load_index

            try:
                with torch.inference_mode():
                    load_index(mgr, ckpt_dir)
            except Exception:
                mgr.reset_state()  # roll back the partial load
                state.pipeline.close()
                state.db.close()
                raise
            logger.info("restored %d rows from %s", mgr.store.size, ckpt_dir)

    # RAG_WARMUP=1: run every retrieval program shape once (all pow2
    # micro-batch buckets) before taking traffic, so the strict latency
    # budget is in force from the first request after a rolling restart
    if os.environ.get("RAG_WARMUP", "0") == "1" \
            and state.pipeline.index_manager.store.size > 0:
        try:
            # RAG_WARMUP_PARALLEL=0 opts out of the threaded warm-up
            state.pipeline.warm_up(parallel=os.environ.get(
                "RAG_WARMUP_PARALLEL", "1") != "0")
            logger.info("retrieval programs warmed")
        except Exception:
            logger.exception("warm-up failed; shapes warm under traffic")

    # best-effort OTel (reference service.py:298-309)
    with contextlib.suppress(Exception):
        from opentelemetry import trace
        from opentelemetry.sdk.trace import TracerProvider

        trace.set_tracer_provider(TracerProvider())

    app.router.add_get("/healthz", healthz)
    app.router.add_post("/ingest", ingest)
    app.router.add_post("/retrieve", retrieve)
    app.router.add_post("/feedback", feedback)
    app.router.add_get("/metrics", metrics)
    app.router.add_post("/chat", chat)
    app.router.add_get("/chat/stream", chat_stream)
    app.router.add_get("/chat/sessions", chat_sessions)
    app.router.add_get("/chat/history/{session_id}", chat_history)
    app.router.add_delete("/chat/clear/{session_id}", chat_clear)
    app.router.add_post("/etl/run", etl_run)
    app.router.add_post("/eval/run", eval_run)
    app.router.add_post("/drift", drift)
    app.router.add_get("/perf", perf_report)
    app.router.add_get("/admin/index/stats", index_stats)
    app.router.add_post("/admin/index/maintain", index_maintain)
    app.router.add_post("/admin/index/checkpoint", index_checkpoint)
    app.router.add_post("/admin/warmup", admin_warmup)
    if STATIC_DIR.is_dir():
        app.router.add_get("/", index_page)
        app.router.add_static("/static", STATIC_DIR)

    async def on_startup(app: web.Application) -> None:
        # asyncio.to_thread rides the loop's default executor, whose
        # default size is min(32, cpus+4) — on small hosts that caps
        # in-flight requests below the semaphore (observed: 5 threads on
        # a 1-cpu host capped micro-batch coalescing at 5 and service
        # throughput at ~52 QPS).  Size it to the concurrency limit: the
        # threads mostly block on device dispatches (GIL released).
        import concurrent.futures as _cf

        executor = _cf.ThreadPoolExecutor(
            max_workers=state.max_concurrency + 8,
            thread_name_prefix="svc")
        asyncio.get_running_loop().set_default_executor(executor)

    async def on_shutdown(app: web.Application) -> None:
        state.draining = True
        state.pipeline.close()
        state.db.close()

    app.on_startup.append(on_startup)
    app.on_shutdown.append(on_shutdown)
    return app


def main() -> None:  # pragma: no cover - manual entry point
    import argparse

    from .. import __version__

    parser = argparse.ArgumentParser(
        prog="advanced-rag-tpu-torch",
        description="RAG API service on the CUDA card (aiohttp)")
    parser.add_argument("--host", default=os.environ.get("HOST", "0.0.0.0"))
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("PORT", 8000)))
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--version", action="version", version=__version__)
    args = parser.parse_args()
    os.environ["HOST"], os.environ["PORT"] = args.host, str(args.port)

    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    app = create_app(device=args.device)

    # SIGTERM graceful drain (reference service.py:87-94, :429-444)
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)

    def _drain(*_: Any) -> None:
        app["state"].draining = True
    with contextlib.suppress(ValueError):
        signal.signal(signal.SIGTERM, _drain)

    web.run_app(app, host=os.environ.get("HOST", "0.0.0.0"),
                port=int(os.environ.get("PORT", 8000)), loop=loop)


if __name__ == "__main__":  # pragma: no cover
    main()
