"""advanced_rag_tpu_torch: the PyTorch and CUDA port of advanced_rag_tpu.

The package mirrors the JAX package's module paths (``ops/dense.py`` here
is the counterpart of ``advanced_rag_tpu/ops/dense.py``) and never imports
JAX or the JAX package.  Every entry point takes a ``device``: it runs on
the CUDA card unless the caller passes ``device="cpu"``, and it raises when
no card is present rather than moving to the CPU.

Hand-written CUDA kernels live in ``csrc/`` and are built by ``_build.py``
on first use; each kernel module keeps a plain PyTorch version of the same
function, which serves CPU tensors and is what the kernels are tested
against.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card.  Without a card that raises: a caller who
    wants the CPU says ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "advanced_rag_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


# The submodules import resolve_device/DeviceLike from this package, so
# they are defined above, before any submodule is imported.
from .config import (  # noqa: E402
    IndexConfig,
    IndexType,
    MeshConfig,
    Metric,
    PipelineConfig,
    RetrievalConfig,
    load_component_configs,
    load_pipeline_config,
    load_yaml_config,
)
from .index import (  # noqa: E402
    ChunkRecord,
    CorpusStore,
    DenseIndex,
    MultiIndexManager,
    SparseIndex,
)
from .models.cross_encoder import CrossEncoderReranker  # noqa: E402
from .pipeline import (  # noqa: E402
    AdaptiveChunker,
    AdvancedRAGPipeline,
    ComplianceManager,
    DocumentDiagnostics,
    ExperimentManager,
    HybridRetriever,
    LearnedHybridAdapter,
    LearnedRanker,
    QueryClassifier,
    QueryDecomposer,
    QueryRewriter,
    RAGEvaluator,
    RetrievalResult,
    SemanticEnricher,
)
from .pipeline.chunking import Chunk, ChunkMetadata  # noqa: E402
from .pipeline.compliance import (  # noqa: E402
    AuditEventType,
    AuditLog,
    DocumentVersion,
)
from .pipeline.diagnostics import DiagnosticMetrics  # noqa: E402
from .pipeline.enrichment import EnrichmentResult  # noqa: E402
from .pipeline.evaluation import DriftReport, EvaluationMetrics  # noqa: E402
from .pipeline.orchestrator import PipelineStage  # noqa: E402
from .pipeline.query_ops import DecompositionResult  # noqa: E402
from .pipeline.ranker import LearnedRankerConfig  # noqa: E402
from .utils.exceptions import AdvancedRAGException, RAGException  # noqa: E402

# Migration alias, as in the JAX package: the reference exposes its index
# layer as ``MilvusIndexManager`` (indexing.py:80).
MilvusIndexManager = MultiIndexManager

__all__ = [
    "__version__",
    "DeviceLike",
    "resolve_device",
    "AdaptiveChunker",
    "AuditEventType",
    "AuditLog",
    "Chunk",
    "ChunkMetadata",
    "CrossEncoderReranker",
    "DecompositionResult",
    "DiagnosticMetrics",
    "DocumentVersion",
    "DriftReport",
    "EnrichmentResult",
    "EvaluationMetrics",
    "LearnedRankerConfig",
    "MilvusIndexManager",
    "PipelineStage",
    "AdvancedRAGException",
    "AdvancedRAGPipeline",
    "ChunkRecord",
    "ComplianceManager",
    "CorpusStore",
    "DenseIndex",
    "DocumentDiagnostics",
    "ExperimentManager",
    "HybridRetriever",
    "IndexConfig",
    "IndexType",
    "LearnedHybridAdapter",
    "LearnedRanker",
    "MeshConfig",
    "Metric",
    "MultiIndexManager",
    "PipelineConfig",
    "QueryClassifier",
    "QueryDecomposer",
    "QueryRewriter",
    "RAGEvaluator",
    "RAGException",
    "RetrievalConfig",
    "RetrievalResult",
    "SemanticEnricher",
    "SparseIndex",
    "load_component_configs",
    "load_pipeline_config",
    "load_yaml_config",
]
