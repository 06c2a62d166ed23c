"""Exception hierarchy of the PyTorch port (a copy of
``advanced_rag_tpu/utils/exceptions.py``).

Capability parity with the reference's 17-class hierarchy under
``AdvancedRAGException`` (reference: exceptions.py:10-87).  The two
Milvus-specific classes map onto index-backend equivalents here (the
backend is a device-resident JAX index, not an external server), with
back-compat aliases kept so the public surface is a superset.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class AdvancedRAGException(Exception):
    """Base class for every framework error (reference: exceptions.py:10)."""

    def __init__(self, message: str, details: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.message = message
        self.details = details or {}

    def __str__(self) -> str:  # pragma: no cover - trivial
        if self.details:
            return f"{self.message} ({self.details})"
        return self.message


#: Short alias, mirrors reference exceptions.py:15.
RAGException = AdvancedRAGException


class ValidationError(AdvancedRAGException):
    """Invalid user input (bad top_k, empty query, oversized doc)."""


class EmbeddingError(AdvancedRAGException):
    """Embedding model failed or returned a malformed vector."""


class IndexingError(AdvancedRAGException):
    """Failure while inserting chunks into a device index."""


class RetrievalError(AdvancedRAGException):
    """Failure during hybrid retrieval."""


class DatabaseError(AdvancedRAGException):
    """Relational-store failure (chat sessions / feedback)."""


class CircuitBreakerOpenError(AdvancedRAGException):
    """Raised when a call is rejected because the breaker is OPEN."""


class ConfigurationError(AdvancedRAGException):
    """Bad or inconsistent configuration."""


class TimeoutError(AdvancedRAGException):  # noqa: A001 - parity with reference
    """Operation exceeded its latency budget."""


class CacheError(AdvancedRAGException):
    """Embedding-cache failure."""


class AuthenticationError(AdvancedRAGException):
    """Missing/invalid API key."""


class RateLimitError(AdvancedRAGException):
    """Per-client rate limit exceeded."""


class OverloadError(AdvancedRAGException):
    """Admission control shed: the service-wide wait queue is full.

    Distinct from :class:`RateLimitError` (a per-client budget) — this
    is the global backpressure signal; the endpoint maps it to 429 and
    it is counted in the ``rag_shed_total{reason="admission"}`` budget
    (docs/SLO.md)."""


class ChunkingError(AdvancedRAGException):
    """Document chunking failed."""


class EvaluationError(AdvancedRAGException):
    """Evaluation / drift computation failed."""


class ComplianceError(AdvancedRAGException):
    """Audit/versioning/legal-hold violation."""


class IndexConnectionError(AdvancedRAGException):
    """Device index backend unavailable (reference: MilvusConnectionError)."""


class IndexOperationError(AdvancedRAGException):
    """Device index operation failed (reference: MilvusOperationError)."""


# Back-compat aliases so code written against the reference's API keeps working.
MilvusConnectionError = IndexConnectionError
MilvusOperationError = IndexOperationError


__all__ = [
    "AdvancedRAGException",
    "RAGException",
    "ValidationError",
    "EmbeddingError",
    "IndexingError",
    "RetrievalError",
    "DatabaseError",
    "CircuitBreakerOpenError",
    "ConfigurationError",
    "TimeoutError",
    "CacheError",
    "AuthenticationError",
    "RateLimitError",
    "OverloadError",
    "ChunkingError",
    "EvaluationError",
    "ComplianceError",
    "IndexConnectionError",
    "IndexOperationError",
    "MilvusConnectionError",
    "MilvusOperationError",
]
