"""Compliance: audit log, versioning, lineage, retention, legal hold,
right-to-forget.

A copy of ``advanced_rag_tpu/pipeline/compliance.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with reference compliance.py:15-514 — 8 audit event
types, SHA-256 content-hash document versions (v1, v2, ...), per-tenant
legal holds blocking deletion, forget-document with redaction audit,
lineage graph with tree queries, filterable audit queries, compliance
reports, integrity verification, and retention pruning on every store.

Host-side by design; the device-index addition is that `forget_document` also
drives the device index (validity-mask delete + host content drop)
through an injected deleter callback, so "forgotten" rows can never be
returned by a kernel.
"""

from __future__ import annotations

import hashlib
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from ..utils.constants import ComplianceConstants as CC
from ..utils.exceptions import ComplianceError


class AuditEventType(str, Enum):
    """Reference compliance.py:15-25."""

    INGESTION = "ingestion"
    RETRIEVAL = "retrieval"
    VERSION_CREATED = "version_created"
    LEGAL_HOLD_APPLIED = "legal_hold_applied"
    LEGAL_HOLD_RELEASED = "legal_hold_released"
    DOCUMENT_FORGOTTEN = "document_forgotten"
    REDACTION = "redaction"
    RETENTION_PRUNED = "retention_pruned"


@dataclass
class AuditLog:
    """Reference compliance.py:27-60."""

    event_id: str
    event_type: AuditEventType
    timestamp: float
    tenant: str
    doc_id: Optional[str] = None
    user: Optional[str] = None
    details: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DocumentVersion:
    """Reference compliance.py:62-83."""

    doc_id: str
    version: int
    content_hash: str
    timestamp: float
    classification: str = "internal"
    retention_until: Optional[float] = None
    metadata: Dict[str, Any] = field(default_factory=dict)


class ComplianceManager:
    """Reference compliance.py:85-514."""

    # Retention is measured in DAYS; sweeping every audit event is an
    # O(corpus) scan per request (measured ~18% of the serving core at
    # 160 QPS).  The sweep runs at most once per interval; per-doc reads
    # (get_versions) stay exact regardless.
    PRUNE_INTERVAL_S = 30.0

    def __init__(
        self,
        tenant: str = "default",
        retention_days: int = CC.DEFAULT_RETENTION_DAYS,
        index_deleter: Optional[Callable[[str], int]] = None,
    ):
        self.tenant = tenant
        self.retention_days = retention_days
        self.audit_logs: List[AuditLog] = []
        self.versions: Dict[str, List[DocumentVersion]] = {}
        self.legal_holds: Dict[str, set] = {}          # tenant -> doc_ids
        self.lineage: Dict[str, List[str]] = {}        # child -> parents
        self.forgotten: set = set()
        self._index_deleter = index_deleter
        self._last_prune = 0.0

    # -- audit ------------------------------------------------------------------

    def _audit(self, event_type: AuditEventType, doc_id: Optional[str] = None,
               tenant: Optional[str] = None, user: Optional[str] = None,
               **details: Any) -> AuditLog:
        entry = AuditLog(
            event_id=uuid.uuid4().hex,
            event_type=event_type,
            timestamp=time.time(),
            tenant=tenant or self.tenant,
            doc_id=doc_id,
            user=user,
            details=details,
        )
        self.audit_logs.append(entry)
        if len(self.audit_logs) > CC.AUDIT_LOG_MAXLEN:
            del self.audit_logs[: len(self.audit_logs) - CC.AUDIT_LOG_MAXLEN]
        if entry.timestamp - self._last_prune >= self.PRUNE_INTERVAL_S:
            self._sweep_now()
        return entry

    def _sweep_now(self) -> None:
        """Run the retention sweep immediately and reset the throttle.
        Rare whole-store readers (reports, integrity checks) call this
        so they never observe versions expired between throttled sweeps."""
        self._last_prune = time.time()
        self._prune_retention()

    def log_ingestion(self, doc_id: str, num_chunks: int,
                      user: Optional[str] = None,
                      classification: str = "internal") -> AuditLog:
        """Reference compliance.py:124-155."""
        return self._audit(AuditEventType.INGESTION, doc_id, user=user,
                           num_chunks=num_chunks, classification=classification)

    def log_retrieval(self, query: str, doc_ids: List[str],
                      user: Optional[str] = None) -> AuditLog:
        """Reference compliance.py:157-190."""
        return self._audit(AuditEventType.RETRIEVAL, user=user,
                           query_hash=hashlib.sha256(query.encode()).hexdigest()[:16],
                           doc_ids=doc_ids[:20], num_results=len(doc_ids))

    # -- versioning (reference compliance.py:192-257) -----------------------------

    def create_version(self, doc_id: str, content: str,
                       classification: str = "internal",
                       parents: Optional[List[str]] = None,
                       **metadata: Any) -> DocumentVersion:
        versions = self.versions.setdefault(doc_id, [])
        version = DocumentVersion(
            doc_id=doc_id,
            version=len(versions) + 1,
            content_hash=hashlib.sha256(content.encode("utf-8")).hexdigest(),
            timestamp=time.time(),
            classification=classification,
            retention_until=time.time() + self.retention_days * 86400,
            metadata=metadata,
        )
        versions.append(version)
        if parents:
            self.lineage.setdefault(doc_id, []).extend(parents)
        self._audit(AuditEventType.VERSION_CREATED, doc_id,
                    version=version.version, content_hash=version.content_hash)
        return version

    def get_versions(self, doc_id: str) -> List[DocumentVersion]:
        """Per-doc read is retention-exact even between throttled sweeps."""
        versions = self.versions.get(doc_id, [])
        if versions and not self.has_legal_hold(doc_id):
            now = time.time()
            versions = [v for v in versions
                        if v.retention_until is None or v.retention_until > now]
        return list(versions)

    # -- legal hold (reference compliance.py:259-270) -----------------------------

    def apply_legal_hold(self, doc_id: str, tenant: Optional[str] = None) -> None:
        t = tenant or self.tenant
        self.legal_holds.setdefault(t, set()).add(doc_id)
        self._audit(AuditEventType.LEGAL_HOLD_APPLIED, doc_id, tenant=t)

    def release_legal_hold(self, doc_id: str, tenant: Optional[str] = None) -> None:
        t = tenant or self.tenant
        self.legal_holds.get(t, set()).discard(doc_id)
        self._audit(AuditEventType.LEGAL_HOLD_RELEASED, doc_id, tenant=t)

    def has_legal_hold(self, doc_id: str, tenant: Optional[str] = None) -> bool:
        return doc_id in self.legal_holds.get(tenant or self.tenant, set())

    # -- right to forget (reference compliance.py:272-329) -------------------------

    def forget_document(self, doc_id: str, tenant: Optional[str] = None,
                        user: Optional[str] = None) -> int:
        """Erase a document; blocked by legal hold (:281-288); emits a
        redaction audit (:292-310).  Returns rows removed from the index."""
        if self.has_legal_hold(doc_id, tenant):
            raise ComplianceError(
                f"document {doc_id!r} is under legal hold; cannot forget"
            )
        removed = 0
        if self._index_deleter is not None:
            removed = self._index_deleter(doc_id)
        self.versions.pop(doc_id, None)
        self.lineage.pop(doc_id, None)
        self.forgotten.add(doc_id)
        self._audit(AuditEventType.DOCUMENT_FORGOTTEN, doc_id, tenant=tenant,
                    user=user, rows_removed=removed)
        self._audit(AuditEventType.REDACTION, doc_id, tenant=tenant,
                    reason="right_to_forget")
        return removed

    # -- lineage (reference compliance.py:331-369) ----------------------------------

    def add_lineage(self, child_doc: str, parent_docs: List[str]) -> None:
        self.lineage.setdefault(child_doc, []).extend(parent_docs)

    def get_lineage_tree(self, doc_id: str, max_depth: int = 10) -> Dict[str, Any]:
        def walk(d: str, depth: int) -> Dict[str, Any]:
            if depth >= max_depth:
                return {"doc_id": d, "parents": []}
            return {
                "doc_id": d,
                "parents": [walk(p, depth + 1)
                            for p in self.lineage.get(d, [])],
            }
        return walk(doc_id, 0)

    # -- queries & reports (reference compliance.py:371-442) -------------------------

    def query_audit_logs(
        self,
        event_type: Optional[AuditEventType] = None,
        doc_id: Optional[str] = None,
        tenant: Optional[str] = None,
        since: Optional[float] = None,
        until: Optional[float] = None,
        limit: int = 1000,
    ) -> List[AuditLog]:
        out = []
        for entry in reversed(self.audit_logs):
            if event_type and entry.event_type != event_type:
                continue
            if doc_id and entry.doc_id != doc_id:
                continue
            if tenant and entry.tenant != tenant:
                continue
            if since and entry.timestamp < since:
                continue
            if until and entry.timestamp > until:
                continue
            out.append(entry)
            if len(out) >= limit:
                break
        return out

    def generate_compliance_report(self) -> Dict[str, Any]:
        """Reference compliance.py:402-442."""
        self._sweep_now()   # report counts must be retention-exact
        by_type: Dict[str, int] = {}
        for entry in self.audit_logs:
            by_type[entry.event_type.value] = by_type.get(entry.event_type.value, 0) + 1
        return {
            "tenant": self.tenant,
            "generated_at": time.time(),
            "total_audit_events": len(self.audit_logs),
            "events_by_type": by_type,
            "documents_versioned": len(self.versions),
            "total_versions": sum(len(v) for v in self.versions.values()),
            "active_legal_holds": {t: sorted(h) for t, h in
                                   self.legal_holds.items() if h},
            "forgotten_documents": len(self.forgotten),
            "retention_days": self.retention_days,
        }

    def verify_data_integrity(self, doc_id: str, content: str) -> bool:
        """Latest version hash matches content (reference compliance.py:444-455)."""
        versions = self.get_versions(doc_id)   # retention-exact view
        if not versions:
            return False
        expected = hashlib.sha256(content.encode("utf-8")).hexdigest()
        return versions[-1].content_hash == expected

    def _prune_retention(self) -> None:
        """Drop expired versions (reference compliance.py:457-480); held
        documents are exempt."""
        now = time.time()
        for doc_id, versions in list(self.versions.items()):
            if self.has_legal_hold(doc_id):
                continue
            kept = [v for v in versions
                    if v.retention_until is None or v.retention_until > now]
            if len(kept) != len(versions):
                self.versions[doc_id] = kept
                if not kept:
                    del self.versions[doc_id]


__all__ = [
    "ComplianceManager",
    "AuditEventType",
    "AuditLog",
    "DocumentVersion",
]
