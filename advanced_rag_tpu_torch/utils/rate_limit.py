"""Token-bucket rate limiter (replaces the reference's slowapi
per-route limits — service.py:368/:379/:644 "10/min" style strings).

A copy of ``advanced_rag_tpu/utils/rate_limit.py`` in the PyTorch port, which never
imports the JAX package.

Thread-safe; keys are (route, client) pairs.  Injectable clock for
deterministic tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Tuple

from .constants import RateLimitConstants as RL


class RateLimiter:
    """Per-key token bucket: `limit` tokens per `window_seconds`."""

    def __init__(self, limit: int, window_seconds: float = RL.WINDOW_SECONDS,
                 burst_factor: float = RL.BURST_FACTOR,
                 clock: Callable[[], float] = time.monotonic):
        self.limit = limit
        self.window = window_seconds
        self.capacity = max(1.0, limit * burst_factor)
        self.rate = limit / window_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, Tuple[float, float]] = {}  # key -> (tokens, ts)

    def allow(self, key: str = "") -> bool:
        now = self._clock()
        with self._lock:
            tokens, ts = self._buckets.get(key, (self.capacity, now))
            tokens = min(self.capacity, tokens + (now - ts) * self.rate)
            if tokens >= 1.0:
                self._buckets[key] = (tokens - 1.0, now)
                return True
            self._buckets[key] = (tokens, now)
            return False

    def retry_after(self, key: str = "") -> float:
        with self._lock:
            tokens, _ = self._buckets.get(key, (self.capacity, self._clock()))
        deficit = max(1.0 - tokens, 0.0)
        return deficit / self.rate if self.rate > 0 else self.window


__all__ = ["RateLimiter"]
