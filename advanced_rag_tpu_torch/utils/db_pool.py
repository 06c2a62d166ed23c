"""Relational store: SQLite (per-thread connections) or Postgres pool.

A copy of ``advanced_rag_tpu/utils/db_pool.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with reference db_pool.py:29-203 — backend switch on
the ``DATABASE_URL`` prefix, `get_connection()` context manager with
commit/rollback, stats, and a module-level singleton.  psycopg2 is
optional (gated import); SQLite is the default and what tests/CI use,
exactly like the reference.
"""

from __future__ import annotations

import contextlib
import sqlite3
import threading
from typing import Any, Dict, Iterator, Optional

from .constants import DatabaseConstants as DB
from .exceptions import DatabaseError


class DatabasePool:
    """Reference db_pool.py:29-151."""

    def __init__(self, database_url: str = "", sqlite_path: str = DB.DEFAULT_SQLITE_PATH,
                 min_size: int = DB.MIN_POOL_SIZE, max_size: int = DB.MAX_POOL_SIZE):
        self._lock = threading.RLock()
        self._stats = {"connections_served": 0, "commits": 0, "rollbacks": 0}
        self.backend = "postgres" if database_url.startswith(
            ("postgres://", "postgresql://")) else "sqlite"
        if self.backend == "postgres":
            try:
                from psycopg2.pool import ThreadedConnectionPool  # type: ignore
            except ImportError as exc:  # pragma: no cover - optional dep
                raise DatabaseError(
                    "DATABASE_URL is postgres but psycopg2 is unavailable"
                ) from exc
            self._pg_pool = ThreadedConnectionPool(min_size, max_size,
                                                   dsn=database_url)
            self._local = None
        else:
            self.sqlite_path = (database_url.replace("sqlite:///", "", 1)
                                if database_url.startswith("sqlite:///")
                                else sqlite_path)
            self._pg_pool = None
            self._local = threading.local()

    def _sqlite_conn(self) -> sqlite3.Connection:
        """Per-thread SQLite connections (reference db_pool.py:100-112)."""
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.sqlite_path,
                                   timeout=DB.CONNECT_TIMEOUT_SECONDS)
            conn.row_factory = sqlite3.Row
            conn.execute("PRAGMA journal_mode=WAL")
            self._local.conn = conn
        return conn

    @contextlib.contextmanager
    def get_connection(self) -> Iterator[Any]:
        """Commit on success, rollback on error (reference :75-119)."""
        with self._lock:
            self._stats["connections_served"] += 1
        if self.backend == "postgres":
            conn = self._pg_pool.getconn()
            try:
                yield conn
                conn.commit()
                self._stats["commits"] += 1
            except Exception:
                conn.rollback()
                self._stats["rollbacks"] += 1
                raise
            finally:
                self._pg_pool.putconn(conn)
        else:
            conn = self._sqlite_conn()
            try:
                yield conn
                conn.commit()
                self._stats["commits"] += 1
            except Exception:
                conn.rollback()
                self._stats["rollbacks"] += 1
                raise

    def get_stats(self) -> Dict[str, Any]:
        """Reference db_pool.py:134-151."""
        with self._lock:
            return {"backend": self.backend, **self._stats}

    def close(self) -> None:
        if self.backend == "postgres" and self._pg_pool is not None:
            self._pg_pool.closeall()
        elif self._local is not None:
            conn = getattr(self._local, "conn", None)
            if conn is not None:
                conn.close()
                self._local.conn = None


_pool: Optional[DatabasePool] = None
_pool_lock = threading.Lock()


def initialize_pool(database_url: str = "",
                    sqlite_path: str = DB.DEFAULT_SQLITE_PATH) -> DatabasePool:
    """Module-level singleton (reference db_pool.py:154-203)."""
    global _pool
    with _pool_lock:
        if _pool is not None:
            _pool.close()
        _pool = DatabasePool(database_url, sqlite_path)
        return _pool


def get_pool() -> DatabasePool:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = DatabasePool()
        return _pool


def close_pool() -> None:
    global _pool
    with _pool_lock:
        if _pool is not None:
            _pool.close()
            _pool = None


__all__ = ["DatabasePool", "initialize_pool", "get_pool", "close_pool"]
