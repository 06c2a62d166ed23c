"""Device-resident corpus store: packed metadata columns + host records.
The port of ``advanced_rag_tpu/index/corpus.py``.

- device columns (i32/f32 tensors, power-of-two capacity, appended in
  place) for everything a filter or scoring op touches;
- host records (chunk_id/doc_id/content/metadata) for what only the
  response needs.

Metadata filtering is a typed dict spec compiled to a boolean mask on the
device: the field and operator whitelists are enforced here, and there is
no string expression to inject into.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..utils.constants import IndexConstants
from ..utils.exceptions import ValidationError

#: Fields a filter may reference.
FILTERABLE_FIELDS = frozenset(
    {
        "doc_id",
        "chunk_id",
        "chunk_index",
        "token_count",
        "entropy",
        "redundancy",
        "domain_density",
        "timestamp",
    }
)

#: Operators a filter may use.
FILTER_OPERATORS = frozenset({"eq", "ne", "in", "gt", "gte", "lt", "lte"})

_MAX_IN_TERMS = 16


def stable_hash64(text: str) -> int:
    """Stable 63-bit string hash for device-side id comparisons."""
    h = hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "little") & 0x7FFF_FFFF_FFFF_FFFF


@dataclass
class ChunkRecord:
    """One indexed chunk (host view)."""

    chunk_id: str
    doc_id: str
    content: str
    chunk_index: int = 0
    token_count: int = 0
    entropy: float = 0.0
    redundancy: float = 0.0
    domain_density: float = 0.0
    timestamp: float = field(default_factory=time.time)
    metadata: Dict[str, Any] = field(default_factory=dict)


# Device columns are 32-bit, as in the JAX package; 64-bit string hashes
# are split into two 31-bit halves compared jointly.
_COLUMN_SPECS = {
    "doc_hash_lo": np.int32,
    "doc_hash_hi": np.int32,
    "chunk_hash_lo": np.int32,
    "chunk_hash_hi": np.int32,
    "chunk_index": np.int32,
    "token_count": np.int32,
    "entropy": np.float32,
    "redundancy": np.float32,
    "domain_density": np.float32,
    "timestamp": np.float32,
}

#: string-id fields -> (lo, hi) column pair
_HASH_FIELDS = {
    "doc_id": ("doc_hash_lo", "doc_hash_hi"),
    "chunk_id": ("chunk_hash_lo", "chunk_hash_hi"),
}

_FIELD_TO_COLUMN = {
    "chunk_index": "chunk_index",
    "token_count": "token_count",
    "entropy": "entropy",
    "redundancy": "redundancy",
    "domain_density": "domain_density",
    "timestamp": "timestamp",
}


def split_hash64(h: int) -> tuple[int, int]:
    return h & 0x7FFF_FFFF, (h >> 31) & 0x7FFF_FFFF


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def grow_capacity(capacity: int, needed: int) -> int:
    """Smallest capacity * 2^j >= needed."""
    while capacity < needed:
        capacity *= IndexConstants.GROWTH_FACTOR
    return capacity


class CorpusStore:
    """Append-only chunk store with device metadata columns.

    Row ids are stable positions; deletes flip the validity mask (the
    right-to-forget path also drops host content).  Capacity grows by
    powers of two; every device column keeps a numpy mirror, so growth
    re-uploads exactly.  Appends write the device columns in place.
    """

    def __init__(self, min_capacity: int = IndexConstants.MIN_CAPACITY,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.capacity = int(min_capacity)
        self.size = 0
        self._host_cols: Dict[str, np.ndarray] = {
            name: np.zeros(self.capacity, dtype=dt)
            for name, dt in _COLUMN_SPECS.items()
        }
        self._host_valid = np.zeros(self.capacity, dtype=bool)
        self._upload()
        self.chunk_ids: List[str] = []
        self.doc_ids: List[str] = []
        self.contents: List[Optional[str]] = []
        self.metadata: List[Dict[str, Any]] = []
        self._chunk_row: Dict[str, int] = {}

    def _upload(self) -> None:
        self._dev_cols = {name: torch.from_numpy(col).to(self.device)
                          for name, col in self._host_cols.items()}
        self._dev_valid = torch.from_numpy(self._host_valid).to(self.device)

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = grow_capacity(self.capacity, needed)
        for name, col in self._host_cols.items():
            grown = np.zeros(new_cap, dtype=col.dtype)
            grown[: self.capacity] = col
            self._host_cols[name] = grown
        grown_valid = np.zeros(new_cap, dtype=bool)
        grown_valid[: self.capacity] = self._host_valid
        self._host_valid = grown_valid
        self.capacity = new_cap
        self._upload()

    # -- append / delete ----------------------------------------------------

    def prepare_append(
        self, records: Sequence[ChunkRecord]
    ) -> Tuple[List[int], Optional[Tuple[int, Dict[str, np.ndarray]]]]:
        """Host half of an append: dedupe, grow capacity, update host
        mirrors and records, and build the column values.

        Returns ``(rows, pending)``; ``pending = (start, vals)`` goes to
        ``commit_append`` once every family of the manager has prepared
        its rows, or is None when every record was an idempotent duplicate.
        """
        fresh: List[ChunkRecord] = []
        pending: Dict[str, int] = {}  # chunk_id -> index into fresh
        rows: List[int] = []
        for rec in records:
            existing = self._chunk_row.get(rec.chunk_id)
            if existing is not None and self._host_valid[existing]:
                rows.append(existing)
            elif rec.chunk_id in pending:
                rows.append(-2 - pending[rec.chunk_id])  # placeholder
            else:
                pending[rec.chunk_id] = len(fresh)
                fresh.append(rec)
                rows.append(-2 - pending[rec.chunk_id])
        if not fresh:
            return rows, None

        start = self.size
        n = len(fresh)
        self._ensure_capacity(start + next_pow2(n))
        doc_h = [split_hash64(stable_hash64(r.doc_id)) for r in fresh]
        chunk_h = [split_hash64(stable_hash64(r.chunk_id)) for r in fresh]
        cols = {
            "doc_hash_lo": np.array([h[0] for h in doc_h], np.int32),
            "doc_hash_hi": np.array([h[1] for h in doc_h], np.int32),
            "chunk_hash_lo": np.array([h[0] for h in chunk_h], np.int32),
            "chunk_hash_hi": np.array([h[1] for h in chunk_h], np.int32),
            "chunk_index": np.array([r.chunk_index for r in fresh], np.int32),
            "token_count": np.array([r.token_count for r in fresh], np.int32),
            "entropy": np.array([r.entropy for r in fresh], np.float32),
            "redundancy": np.array([r.redundancy for r in fresh], np.float32),
            "domain_density": np.array([r.domain_density for r in fresh], np.float32),
            "timestamp": np.array([r.timestamp for r in fresh], np.float32),
        }
        for name, vals in cols.items():
            self._host_cols[name][start: start + n] = vals
        self._host_valid[start: start + n] = True
        for offset, rec in enumerate(fresh):
            self.chunk_ids.append(rec.chunk_id)
            self.doc_ids.append(rec.doc_id)
            self.contents.append(rec.content)
            self.metadata.append(dict(rec.metadata))
            self._chunk_row[rec.chunk_id] = start + offset
        rows = [r if r >= 0 else start + (-2 - r) for r in rows]
        self.size = start + n
        return rows, (start, cols)

    def commit_append(self, start: int, cols: Dict[str, np.ndarray]) -> None:
        """Write prepared rows into the device columns (in place) and make
        them valid."""
        n = 0
        for name, vals in cols.items():
            n = len(vals)
            self._dev_cols[name][start: start + n] = torch.from_numpy(vals).to(self.device)
        self._dev_valid[start: start + n] = True

    def delete_rows(self, rows: Iterable[int], *, forget_content: bool = False) -> int:
        rows = [r for r in rows if 0 <= r < self.size and self._host_valid[r]]
        if not rows:
            return 0
        idx = np.asarray(rows, dtype=np.int64)
        self._host_valid[idx] = False
        self._dev_valid[torch.from_numpy(idx).to(self.device)] = False
        if forget_content:
            for r in rows:
                self.contents[r] = None
                self.metadata[r] = {}
        return len(rows)

    # -- filters ----------------------------------------------------------------

    def _hash_eq_mask(self, fld: str, value: Any) -> torch.Tensor:
        if not isinstance(value, str):
            raise ValidationError(f"filter on {fld} requires a string")
        lo_col, hi_col = _HASH_FIELDS[fld]
        lo, hi = split_hash64(stable_hash64(value))
        return (self._dev_cols[lo_col] == lo) & (self._dev_cols[hi_col] == hi)

    @staticmethod
    def _numeric_value(fld: str, value: Any) -> Any:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValidationError(f"filter on {fld} requires a number")
        return value

    @staticmethod
    def _in_values(value: Any) -> Sequence[Any]:
        if not isinstance(value, (list, tuple)) or not value:
            raise ValidationError("'in' requires a non-empty list")
        if len(value) > _MAX_IN_TERMS:
            raise ValidationError(f"'in' supports at most {_MAX_IN_TERMS} values")
        return value

    def build_filter_mask(
        self, filters: Optional[Dict[str, Any]]
    ) -> Optional[torch.Tensor]:
        """Compile a typed filter spec to a device boolean mask [capacity].

        Spec: ``{"doc_id": "d1"}``, ``{"doc_id": {"in": [...]}}``,
        ``{"domain_density": {"gte": 0.2, "lt": 0.8}}``, ...  Unknown
        fields or operators raise ValidationError.
        """
        if not filters:
            return None
        mask = self._dev_valid.clone()
        for fld, cond in filters.items():
            if fld not in FILTERABLE_FIELDS:
                raise ValidationError(f"field not filterable: {fld!r}")
            if not isinstance(cond, dict):
                cond = {"eq": cond}
            for op, value in cond.items():
                if op not in FILTER_OPERATORS:
                    raise ValidationError(f"operator not allowed: {op!r}")
                if fld in _HASH_FIELDS:
                    if op == "eq":
                        m = self._hash_eq_mask(fld, value)
                    elif op == "ne":
                        m = ~self._hash_eq_mask(fld, value)
                    elif op == "in":
                        vals = self._in_values(value)
                        m = self._hash_eq_mask(fld, vals[0])
                        for v in vals[1:]:
                            m = m | self._hash_eq_mask(fld, v)
                    else:
                        raise ValidationError(
                            f"operator {op!r} not valid for string field {fld!r}")
                else:
                    col = self._dev_cols[_FIELD_TO_COLUMN[fld]]
                    if op == "in":
                        terms = torch.tensor(
                            [self._numeric_value(fld, v)
                             for v in self._in_values(value)],
                            dtype=col.dtype, device=col.device)
                        m = torch.any(col[:, None] == terms[None, :], dim=1)
                    else:
                        v = torch.tensor(self._numeric_value(fld, value),
                                         dtype=col.dtype, device=col.device)
                        m = {
                            "eq": col == v,
                            "ne": col != v,
                            "gt": col > v,
                            "gte": col >= v,
                            "lt": col < v,
                            "lte": col <= v,
                        }[op]
                mask = mask & m
        return mask

    # -- views --------------------------------------------------------------------

    @property
    def valid_mask(self) -> torch.Tensor:
        return self._dev_valid

    @property
    def device_columns(self) -> Dict[str, torch.Tensor]:
        return dict(self._dev_cols)

    def n_valid(self) -> int:
        return int(self._host_valid[: self.size].sum())

    def hit(self, row: int, score: float, **extra: Any) -> Dict[str, Any]:
        """Materialize one search hit (host record + scalar columns)."""
        rec = {
            "row": row,
            "chunk_id": self.chunk_ids[row],
            "doc_id": self.doc_ids[row],
            "content": self.contents[row],
            "score": float(score),
            "chunk_index": int(self._host_cols["chunk_index"][row]),
            "token_count": int(self._host_cols["token_count"][row]),
            "entropy": float(self._host_cols["entropy"][row]),
            "redundancy": float(self._host_cols["redundancy"][row]),
            "domain_density": float(self._host_cols["domain_density"][row]),
            "timestamp": float(self._host_cols["timestamp"][row]),
            "metadata": self.metadata[row],
        }
        rec.update(extra)
        return rec

    def stats(self) -> Dict[str, Any]:
        return {
            "size": self.size,
            "valid": self.n_valid(),
            "capacity": self.capacity,
            "num_docs": len(set(self.doc_ids)),
        }


__all__ = [
    "ChunkRecord",
    "CorpusStore",
    "FILTERABLE_FIELDS",
    "FILTER_OPERATORS",
    "stable_hash64",
    "next_pow2",
]
