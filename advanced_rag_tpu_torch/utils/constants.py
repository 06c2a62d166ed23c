"""Centralized tunables of the PyTorch port (a copy of
``advanced_rag_tpu/utils/constants.py``, kept so the port never imports
the JAX package).

Capability parity with reference constants.py:6-252, re-expressed for a
device-resident index: Milvus HNSW knobs become IVF / brute-force scan
knobs with equivalent recall targets, and thread-pool sizes become batch
sizes for jitted programs.
"""

from __future__ import annotations


class ChunkingConstants:
    """Adaptive chunking (reference constants.py:6-43, chunking.py:74-101)."""

    BASE_CHUNK_SIZE = 512          # tokens
    MAX_CHUNK_SIZE = 1024
    MIN_CHUNK_SIZE = 128
    OVERLAP_RATIO = 0.15
    HIGH_ENTROPY_THRESHOLD = 0.8
    LOW_ENTROPY_THRESHOLD = 0.4
    HIGH_ENTROPY_MULTIPLIER = 1.3
    LOW_ENTROPY_MULTIPLIER = 0.8
    HIGH_REDUNDANCY_THRESHOLD = 0.6
    REDUNDANCY_MULTIPLIER = 0.7
    DOMAIN_DENSITY_THRESHOLD = 0.3
    DOMAIN_DENSITY_MULTIPLIER = 0.85
    LOW_COHERENCE_THRESHOLD = 0.3
    LOW_COHERENCE_MULTIPLIER = 0.75
    MAX_SENTENCE_TOKENS = 256


class RetrievalConstants:
    """Hybrid retrieval (reference constants.py:44-72, retrieval.py:70-101)."""

    DEFAULT_TOP_K = 20
    MAX_TOP_K = 100                # pad target for static-shape top-k
    DENSE_WEIGHT = 0.7
    SPARSE_WEIGHT = 0.3
    DOMAIN_WEIGHT = 0.2
    TIMEOUT_SECONDS = 0.3          # degrade-to-empty budget
    RRF_K = 60
    MMR_LAMBDA = 0.80
    OVER_RETRIEVE_FACTOR = 2       # fetch 2x top_k per index before fusion
    RECENCY_HALF_LIFE_DAYS = 30.0


class EvaluationConstants:
    """Evaluation metrics (reference constants.py:73-92, evaluation.py)."""

    HISTORY_MAXLEN = 1000
    HALLUCINATION_SCORE_VAR_WEIGHT = 0.25
    HALLUCINATION_DIVERSITY_WEIGHT = 0.20
    HALLUCINATION_TOP_SCORE_WEIGHT = 0.30
    HALLUCINATION_COVERAGE_WEIGHT = 0.25
    DRIFT_EMBEDDING_WEIGHT = 0.5
    DRIFT_DISTRIBUTION_WEIGHT = 0.3
    DRIFT_TEMPORAL_WEIGHT = 0.2
    DRIFT_WINDOW_DAYS = 30.0
    DRIFT_THRESHOLD = 0.15


class PerformanceConstants:
    """Latency/throughput targets (reference constants.py:93-111)."""

    TARGET_LATENCY_MS = 80.0       # p99 SLA for retrieve (pipeline.py:40)
    ENDPOINT_LATENCY_SLO_MS = 300.0
    MAX_CONCURRENT_REQUESTS = 64
    EMBED_BATCH_SIZE = 32
    INDEX_BATCH_SIZE = 128
    QUERY_BATCH_SIZE = 16          # device micro-batch cap for the search
    # program: continuous batching fills it under load
    LATENCY_WINDOW = 1000          # rolling samples per stage


class CircuitBreakerConstants:
    """Breaker defaults (reference constants.py:112-131)."""

    FAILURE_THRESHOLD = 5
    TIMEOUT_SECONDS = 60.0
    SUCCESS_THRESHOLD = 2


class DatabaseConstants:
    """Relational store (reference constants.py:132-148)."""

    MIN_POOL_SIZE = 1
    MAX_POOL_SIZE = 10
    CONNECT_TIMEOUT_SECONDS = 10.0
    DEFAULT_SQLITE_PATH = "chat.db"


class APIConstants:
    """Service limits (reference constants.py:149-169)."""

    MAX_DOCUMENT_BYTES = 1_048_576     # 1 MB per document
    INGEST_RATE_LIMIT_PER_MIN = 10
    RETRIEVE_RATE_LIMIT_PER_MIN = 60
    CHAT_RATE_LIMIT_PER_MIN = 30
    MAX_QUERY_CHARS = 4096
    STREAM_TOKEN_INTERVAL_S = 0.01


class IndexConstants:
    """Device index geometry (replaces reference MilvusConstants :170-192).

    Dims follow the reference schemas (indexing.py:92-94): semantic 1536,
    sparse vocab 10k (we use a power-of-two hashed vocab), domain 768.
    HNSW M=16/efConstruction=200/ef=64 maps to an IVF recall target:
    nprobe/nlist tuned so recall@10 >= HNSW at equal memory.
    """

    SEMANTIC_DIM = 1536
    SPARSE_VOCAB_SIZE = 16384      # hashed vocab (>= reference's 10000)
    DOMAIN_DIM = 768
    NUM_SHARDS = 4                 # reference num_shards=4 -> mesh data shards
    DEFAULT_METRIC = "cosine"
    # nlist ~ factor * sqrt(N).  Factor 4 over-fragments clustered data
    # at the 10M tier (measured recall@10 0.65 at nprobe=64 with 12648
    # lists vs 0.975 at 1M with sqrt-scale lists); sqrt(N) lists plus a
    # tuned nprobe (tune_nprobe) is the better recall/latency frontier.
    IVF_NLIST_FACTOR = 1.0
    IVF_NPROBE = 32
    IVF_KMEANS_ITERS = 16
    # maintenance auto-builds the IVF quantizer once the corpus crosses
    # this (exact scan stays optimal below; Milvus builds HNSW always —
    # brute force simply IS the better index at small N on this hardware)
    IVF_AUTO_THRESHOLD = 200_000
    SPARSE_DOC_NNZ = 256           # fixed nnz padding per doc row
    SPARSE_QUERY_NNZ = 32
    SPARSE_DROP_RATIO = 0.2        # drop lowest-weight query terms (parity)
    BM25_K1 = 1.2
    BM25_B = 0.75
    SEARCH_TIMEOUT_SECONDS = 5.0
    SEARCH_MAX_RETRIES = 3
    MIN_CAPACITY = 1024            # smallest device array allocation
    GROWTH_FACTOR = 2              # capacity doubling on append overflow
    SCAN_BLOCK_SIZE = 65536        # corpus rows per scan block in dense topk


class ComplianceConstants:
    """Audit/retention (reference constants.py:193-199)."""

    DEFAULT_RETENTION_DAYS = 365
    AUDIT_LOG_MAXLEN = 100_000


class LoggingConstants:
    """Logging defaults (reference constants.py:200-206)."""

    LOG_LEVEL = "INFO"
    LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


class EmbeddingConstants:
    """Embedding cache / model (reference constants.py:207-222)."""

    CACHE_CAPACITY = 10_000
    CACHE_TTL_SECONDS = 3600.0
    MODEL_MAX_TOKENS = 512
    DEFAULT_DTYPE = "bfloat16"


class IndexingConstants:
    """Ingest path (reference constants.py:223-236)."""

    EMBED_BATCH = 128              # replaces ThreadPoolExecutor(8) with batching
    MAX_RETRIES = 3
    RETRY_BACKOFF_BASE_S = 0.1


class RateLimitConstants:
    """Token-bucket rate limiter (reference constants.py:237-244)."""

    WINDOW_SECONDS = 60.0
    BURST_FACTOR = 1.0


class MetricsConstants:
    """Prometheus histogram buckets (reference constants.py:245-252)."""

    LATENCY_BUCKETS_MS = (1, 2, 5, 10, 20, 40, 80, 160, 300, 600, 1200, 2400)


__all__ = [
    "ChunkingConstants",
    "RetrievalConstants",
    "EvaluationConstants",
    "PerformanceConstants",
    "CircuitBreakerConstants",
    "DatabaseConstants",
    "APIConstants",
    "IndexConstants",
    "ComplianceConstants",
    "LoggingConstants",
    "EmbeddingConstants",
    "IndexingConstants",
    "RateLimitConstants",
    "MetricsConstants",
]
