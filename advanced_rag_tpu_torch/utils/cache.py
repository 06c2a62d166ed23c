"""Thread-safe TTL + capacity embedding cache (sync/async dual API).

A copy of ``advanced_rag_tpu/utils/cache.py`` for the PyTorch port.

Capability parity with reference embedding_cache.py:38-285: SHA-256
text keys, TTL eviction on access, FIFO capacity eviction, stats, and
module-level singletons for the semantic/sparse/domain families.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Awaitable, Callable, Dict, Optional, Union

import numpy as np

from .constants import EmbeddingConstants


@dataclass
class CacheStats:
    """Mirror of reference CacheStats (embedding_cache.py:24-36)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    expirations: int = 0
    size: int = 0
    capacity: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class EmbeddingCache:
    """RLock-guarded cache of text -> embedding (reference :38-246)."""

    def __init__(
        self,
        capacity: int = EmbeddingConstants.CACHE_CAPACITY,
        ttl_seconds: float = EmbeddingConstants.CACHE_TTL_SECONDS,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.ttl_seconds = ttl_seconds
        self._clock = clock
        self._lock = threading.RLock()
        self._store: "OrderedDict[str, tuple[float, np.ndarray]]" = OrderedDict()
        self._stats = CacheStats(capacity=capacity)

    @staticmethod
    def make_key(text: str, namespace: str = "") -> str:
        """SHA-256 content key (reference embedding_cache.py:74-87)."""
        h = hashlib.sha256()
        if namespace:
            h.update(namespace.encode("utf-8"))
            h.update(b"\x00")
        h.update(text.encode("utf-8"))
        return h.hexdigest()

    # -- sync core ---------------------------------------------------------

    def get_sync(self, text: str, namespace: str = "") -> Optional[np.ndarray]:
        key = self.make_key(text, namespace)
        now = self._clock()
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                self._stats.misses += 1
                return None
            ts, value = entry
            if now - ts > self.ttl_seconds:
                del self._store[key]
                self._stats.expirations += 1
                self._stats.misses += 1
                self._stats.size = len(self._store)
                return None
            self._stats.hits += 1
            return value

    def put_sync(self, text: str, value: np.ndarray, namespace: str = "") -> None:
        key = self.make_key(text, namespace)
        with self._lock:
            if key not in self._store and len(self._store) >= self.capacity:
                self._store.popitem(last=False)  # FIFO eviction (:125-133)
                self._stats.evictions += 1
            self._store[key] = (self._clock(), np.asarray(value))
            self._stats.size = len(self._store)

    def get_or_compute_sync(
        self,
        text: str,
        compute: Callable[[str], np.ndarray],
        namespace: str = "",
    ) -> np.ndarray:
        cached = self.get_sync(text, namespace)
        if cached is not None:
            return cached
        value = compute(text)
        self.put_sync(text, value, namespace)
        return value

    # -- awaitable wrappers (reference :138-214) ---------------------------

    async def get(self, text: str, namespace: str = "") -> Optional[np.ndarray]:
        return self.get_sync(text, namespace)

    async def put(self, text: str, value: np.ndarray, namespace: str = "") -> None:
        self.put_sync(text, value, namespace)

    async def get_or_compute(
        self,
        text: str,
        compute: Union[Callable[[str], np.ndarray],
                       Callable[[str], Awaitable[np.ndarray]]],
        namespace: str = "",
    ) -> np.ndarray:
        cached = self.get_sync(text, namespace)
        if cached is not None:
            return cached
        value = compute(text)
        if hasattr(value, "__await__"):
            value = await value  # type: ignore[misc]
        self.put_sync(text, value, namespace)  # type: ignore[arg-type]
        return value  # type: ignore[return-value]

    # -- maintenance -------------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._stats.size = 0

    def get_stats(self) -> CacheStats:
        with self._lock:
            self._stats.size = len(self._store)
            return CacheStats(**vars(self._stats))


# Module-level singletons, one per index family (reference :248-285).
semantic_cache = EmbeddingCache()
sparse_cache = EmbeddingCache()
domain_cache = EmbeddingCache()


def get_cache(family: str) -> EmbeddingCache:
    caches: Dict[str, EmbeddingCache] = {
        "semantic": semantic_cache,
        "sparse": sparse_cache,
        "domain": domain_cache,
    }
    try:
        return caches[family]
    except KeyError:
        raise KeyError(f"unknown cache family: {family}") from None


__all__ = [
    "CacheStats",
    "EmbeddingCache",
    "semantic_cache",
    "sparse_cache",
    "domain_cache",
    "get_cache",
]
