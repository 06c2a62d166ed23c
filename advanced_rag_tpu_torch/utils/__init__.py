"""Host-side utilities copied from the JAX package: constants, exceptions,
the embedding cache, the circuit breaker, the database pool and the rate
limiter."""

from .circuit_breaker import (
    CircuitBreaker,
    CircuitBreakerConfig,
    CircuitState,
    with_circuit_breaker,
)
from .db_pool import DatabasePool, close_pool, get_pool, initialize_pool
from .rate_limit import RateLimiter

__all__ = [
    "CircuitBreaker",
    "CircuitBreakerConfig",
    "CircuitState",
    "DatabasePool",
    "RateLimiter",
    "close_pool",
    "get_pool",
    "initialize_pool",
    "with_circuit_breaker",
]
