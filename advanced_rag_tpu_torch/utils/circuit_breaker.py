"""Circuit breaker: CLOSED -> OPEN -> HALF_OPEN -> CLOSED.

A copy of ``advanced_rag_tpu/utils/circuit_breaker.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with reference circuit_breaker.py:19-255: state enum,
config with failure/success thresholds + timeout (and the reference's
legacy alias kwargs), thread-safe state machine where OPEN flips to
HALF_OPEN after the timeout, a HALF_OPEN failure re-opens, N HALF_OPEN
successes close, stats, and a decorator for sync/async callables.
"""

from __future__ import annotations

import asyncio
import functools
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Optional

from .constants import CircuitBreakerConstants as CB
from .exceptions import CircuitBreakerOpenError


class CircuitState(str, Enum):
    """Reference circuit_breaker.py:19-25."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


@dataclass
class CircuitBreakerConfig:
    """Reference circuit_breaker.py:27-64 (incl. legacy aliases)."""

    failure_threshold: int = CB.FAILURE_THRESHOLD
    timeout_seconds: float = CB.TIMEOUT_SECONDS
    success_threshold: int = CB.SUCCESS_THRESHOLD

    @classmethod
    def from_kwargs(cls, **kwargs: Any) -> "CircuitBreakerConfig":
        """Accept legacy alias names (reference :43-59)."""
        mapped = {
            "failure_threshold": kwargs.get(
                "failure_threshold", kwargs.get("max_failures",
                                                CB.FAILURE_THRESHOLD)),
            "timeout_seconds": kwargs.get(
                "timeout_seconds", kwargs.get("reset_timeout",
                                              CB.TIMEOUT_SECONDS)),
            "success_threshold": kwargs.get(
                "success_threshold", kwargs.get("half_open_successes",
                                                CB.SUCCESS_THRESHOLD)),
        }
        return cls(**mapped)


class CircuitBreaker:
    """Reference circuit_breaker.py:66-212."""

    def __init__(self, config: Optional[CircuitBreakerConfig] = None,
                 name: str = "default", **kwargs: Any):
        self.config = config or CircuitBreakerConfig.from_kwargs(**kwargs)
        self.name = name
        self._lock = threading.RLock()
        self._state = CircuitState.CLOSED
        self._failure_count = 0
        self._success_count = 0
        self._opened_at = 0.0
        self._stats = {"calls": 0, "failures": 0, "successes": 0,
                       "rejections": 0, "state_changes": 0}

    @property
    def state(self) -> CircuitState:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _set_state(self, state: CircuitState) -> None:
        if state != self._state:
            self._state = state
            self._stats["state_changes"] += 1

    def _maybe_half_open(self) -> None:
        """OPEN -> HALF_OPEN after timeout (reference :124-131)."""
        if (self._state == CircuitState.OPEN
                and time.monotonic() - self._opened_at >= self.config.timeout_seconds):
            self._set_state(CircuitState.HALF_OPEN)
            self._success_count = 0

    def is_open(self) -> bool:
        """Reference circuit_breaker.py:116-133."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CircuitState.OPEN:
                self._stats["rejections"] += 1
                return True
            return False

    def record_failure(self) -> None:
        """Reference circuit_breaker.py:135-159."""
        with self._lock:
            self._stats["failures"] += 1
            self._maybe_half_open()
            if self._state == CircuitState.HALF_OPEN:
                # a probe failure re-opens (reference :150-153)
                self._set_state(CircuitState.OPEN)
                self._opened_at = time.monotonic()
                self._failure_count = 0
                return
            self._failure_count += 1
            if self._failure_count >= self.config.failure_threshold:
                self._set_state(CircuitState.OPEN)
                self._opened_at = time.monotonic()
                self._failure_count = 0

    def record_success(self) -> None:
        """Reference circuit_breaker.py:161-185."""
        with self._lock:
            self._stats["successes"] += 1
            self._maybe_half_open()
            if self._state == CircuitState.HALF_OPEN:
                self._success_count += 1
                if self._success_count >= self.config.success_threshold:
                    self._set_state(CircuitState.CLOSED)
                    self._failure_count = 0
                    self._success_count = 0
            elif self._state == CircuitState.CLOSED:
                self._failure_count = 0

    def reset(self) -> None:
        with self._lock:
            self._set_state(CircuitState.CLOSED)
            self._failure_count = 0
            self._success_count = 0

    def get_stats(self) -> Dict[str, Any]:
        """Reference circuit_breaker.py:192-212."""
        with self._lock:
            return {
                "name": self.name,
                "state": self._state.value,
                "failure_count": self._failure_count,
                **self._stats,
            }


def with_circuit_breaker(
    breaker: CircuitBreaker,
) -> Callable[[Callable], Callable]:
    """Decorator for sync/async callables (reference :214-255)."""

    def decorate(fn: Callable) -> Callable:
        if asyncio.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def async_wrapper(*args: Any, **kwargs: Any) -> Any:
                if breaker.is_open():
                    raise CircuitBreakerOpenError(
                        f"circuit {breaker.name!r} is open")
                breaker._stats["calls"] += 1
                try:
                    result = await fn(*args, **kwargs)
                except Exception:
                    breaker.record_failure()
                    raise
                breaker.record_success()
                return result
            return async_wrapper

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if breaker.is_open():
                raise CircuitBreakerOpenError(
                    f"circuit {breaker.name!r} is open")
            breaker._stats["calls"] += 1
            try:
                result = fn(*args, **kwargs)
            except Exception:
                breaker.record_failure()
                raise
            breaker.record_success()
            return result
        return wrapper

    return decorate


__all__ = [
    "CircuitBreaker",
    "CircuitBreakerConfig",
    "CircuitState",
    "with_circuit_breaker",
]
