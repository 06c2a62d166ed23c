"""Pipeline layer of the port: orchestration, text analytics, evaluation,
compliance (the JAX package's ``pipeline/`` over the port's device
index)."""

from .chunking import AdaptiveChunker, Chunk, ChunkMetadata, content_hash
from .compliance import AuditEventType, AuditLog, ComplianceManager, DocumentVersion
from .diagnostics import DiagnosticMetrics, DocumentDiagnostics
from .enrichment import EnrichmentResult, SemanticEnricher
from .evaluation import DriftReport, EvaluationMetrics, RAGEvaluator
from .experiments import ExperimentManager, VariantStats
from .orchestrator import AdvancedRAGPipeline, PipelineStage, RetrievalResult
from .query_ops import (
    DecompositionResult,
    QueryClassifier,
    QueryDecomposer,
    QueryRewriter,
    QueryRewriterConfig,
)
from .ranker import (
    FeedbackExample,
    LearnedHybridAdapter,
    LearnedRanker,
    LearnedRankerConfig,
)
from .retrieval import DEFAULT_PROFILES, HybridRetriever, RetrievalProfile

__all__ = [
    "AdaptiveChunker",
    "AdvancedRAGPipeline",
    "AuditEventType",
    "AuditLog",
    "Chunk",
    "ChunkMetadata",
    "ComplianceManager",
    "DecompositionResult",
    "DEFAULT_PROFILES",
    "DiagnosticMetrics",
    "DocumentDiagnostics",
    "DocumentVersion",
    "DriftReport",
    "EnrichmentResult",
    "EvaluationMetrics",
    "ExperimentManager",
    "FeedbackExample",
    "HybridRetriever",
    "LearnedHybridAdapter",
    "LearnedRanker",
    "LearnedRankerConfig",
    "PipelineStage",
    "QueryClassifier",
    "QueryDecomposer",
    "QueryRewriter",
    "QueryRewriterConfig",
    "RAGEvaluator",
    "RetrievalProfile",
    "RetrievalResult",
    "SemanticEnricher",
    "VariantStats",
    "content_hash",
]
