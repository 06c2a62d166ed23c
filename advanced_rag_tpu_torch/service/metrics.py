"""Prometheus collectors for the port's API service (reference
service.py:128-132).

The same metric names as ``advanced_rag_tpu/service/metrics.py``, in the
port's own ``CollectorRegistry`` (``REGISTRY``): the JAX module registers
its collectors in prometheus' default registry, and one process may load
both services (a parity test does), which would otherwise raise
"Duplicated timeseries".  ``/metrics`` emits this registry.

Lives in its OWN module so collector registration runs exactly once per
process: ``python -m advanced_rag_tpu_torch.service.app`` executes app.py
twice (once via the package import in service/__init__.py, once as
__main__ by runpy), but runpy only re-executes the target module — its
imports, this module included, stay cached in sys.modules.
"""

from __future__ import annotations

from ..utils.constants import MetricsConstants

try:
    from prometheus_client import (  # noqa: F401  (re-exported)
        CONTENT_TYPE_LATEST,
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
    )
    from prometheus_client import generate_latest as _generate_latest

    PROM = True
    REGISTRY = CollectorRegistry()

    def generate_latest() -> bytes:
        """The exposition of the port's registry."""
        return _generate_latest(REGISTRY)

    REQUESTS_TOTAL = Counter("rag_api_requests_total", "API requests",
                             ["endpoint", "status"], registry=REGISTRY)
    RETRIEVE_LATENCY = Histogram(
        "rag_retrieve_latency_ms", "Retrieve latency (ms)",
        buckets=MetricsConstants.LATENCY_BUCKETS_MS, registry=REGISTRY)
    ERRORS_TOTAL = Counter("rag_errors_total", "Errors", ["error_type"],
                           registry=REGISTRY)
    ACTIVE_REQUESTS = Gauge("rag_active_requests", "In-flight requests",
                            registry=REGISTRY)
    EMBED_LATENCY = Histogram("rag_embedding_latency_seconds",
                              "Embedding latency (s)", registry=REGISTRY)
    # quality gauges backing the alert thresholds the reference
    # documents but never exports (ref ARCHITECTURE.md:369-373):
    # observability/alerts/rag_alerts.yaml fires on these
    HALLUCINATION_RISK = Gauge(
        "rag_hallucination_risk",
        "Hallucination risk of the most recent evaluated retrieve",
        registry=REGISTRY)
    DRIFT_MAGNITUDE = Gauge(
        "rag_drift_magnitude", "Magnitude from the last drift check",
        registry=REGISTRY)
    SLA_COMPLIANCE = Gauge(
        "rag_sla_compliance_ratio",
        "Rolling share of retrieves meeting the latency target",
        registry=REGISTRY)
    # shed accounting: degrade-to-empty 200s and admission rejections
    # are failures to the user that the 5xx error SLO cannot see; they
    # get their own budget (docs/SLO.md) and alert
    SHED_TOTAL = Counter(
        "rag_shed_total",
        "Requests shed (admission 429, degraded-empty, or timeout)",
        ["reason"], registry=REGISTRY)
except ImportError:  # pragma: no cover - prometheus may be absent
    PROM = False
    REGISTRY = None
    CONTENT_TYPE_LATEST = "text/plain"

    def generate_latest(*_a, **_k):  # type: ignore[misc]
        return b""


__all__ = [
    "PROM", "REGISTRY", "CONTENT_TYPE_LATEST", "generate_latest",
    "REQUESTS_TOTAL", "RETRIEVE_LATENCY", "ERRORS_TOTAL", "ACTIVE_REQUESTS",
    "EMBED_LATENCY", "HALLUCINATION_RISK", "DRIFT_MAGNITUDE",
    "SLA_COMPLIANCE", "SHED_TOTAL",
]
