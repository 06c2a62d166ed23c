"""ctypes wrapper over native/hnsw_native.cpp (clean-room HNSW, CPU).

Mirrors the hnswlib surface the reference's Milvus deployment implies:
build(M, ef_construction) + search(k, ef), inner-product metric over
pre-normalized vectors (cosine).  The library builds at first use with
the text fast path's ``native.build_library`` into
``build/native/``, with ``-march=native -fopenmp``; its name holds the
host CPU's key too, so a library built on one host is never loaded on
another.  A failed build raises: the baseline has no Python path.

Graphs saved through ``cache_path`` use the JAX package's format
(``ARTHNSW1``): either package loads the other's files.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from .. import native

FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.art_hnsw_build.argtypes = [p, i64, i32, i32, i32, ctypes.c_uint64]
    lib.art_hnsw_build.restype = p
    lib.art_hnsw_search.argtypes = [p, p, i64, i32, i32, p, p]
    lib.art_hnsw_search.restype = None
    lib.art_hnsw_memory_bytes.argtypes = [p]
    lib.art_hnsw_memory_bytes.restype = i64
    lib.art_hnsw_max_level.argtypes = [p]
    lib.art_hnsw_max_level.restype = i32
    lib.art_hnsw_rows.argtypes = [p]
    lib.art_hnsw_rows.restype = i64
    lib.art_hnsw_dim.argtypes = [p]
    lib.art_hnsw_dim.restype = i32
    lib.art_hnsw_free.argtypes = [p]
    lib.art_hnsw_free.restype = None
    lib.art_hnsw_save.argtypes = [p, ctypes.c_char_p]
    lib.art_hnsw_save.restype = i32
    lib.art_hnsw_load.argtypes = [ctypes.c_char_p]
    lib.art_hnsw_load.restype = p


def _lib() -> ctypes.CDLL:
    return native.load("hnsw_native", FLAGS, _bind, key=native.host_key())


def available() -> bool:
    """True once the library is built and loaded; a failed build raises
    with the compiler's command and output."""
    return _lib() is not None


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


class HNSWBaseline:
    """Build-once / search-many HNSW graph over normalized vectors.

    Knobs default to the reference's semantic collection
    (indexing.py:150-153): M=16, ef_construction=200, search ef=64.
    With ``cache_path``, a graph saved there is loaded instead of built
    (it must hold as many rows, as wide, as ``vectors``), and a graph
    built is saved there.
    """

    def __init__(self, vectors: np.ndarray, *, M: int = 16,
                 ef_construction: int = 200, seed: int = 0,
                 normalize: bool = True, cache_path=None):
        lib = _lib()
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        if normalize:
            v = np.ascontiguousarray(_unit(v), dtype=np.float32)
        self.n, self.dim = v.shape
        self.M = M
        self._lib = lib
        self._idx = None
        if cache_path is not None and Path(cache_path).exists():
            self._idx = lib.art_hnsw_load(str(cache_path).encode())
            if not self._idx:
                raise RuntimeError(f"not an HNSW graph file: {cache_path}")
            shape = (int(lib.art_hnsw_rows(self._idx)), int(lib.art_hnsw_dim(self._idx)))
            if shape != (self.n, self.dim):
                lib.art_hnsw_free(self._idx)
                self._idx = None
                raise ValueError(f"the graph in {cache_path} holds {shape[0]} rows "
                                 f"{shape[1]} wide, the vectors are {self.n} x {self.dim}")
            return
        self._idx = lib.art_hnsw_build(v.ctypes.data, self.n, self.dim, M,
                                       ef_construction, seed)
        if cache_path is not None and lib.art_hnsw_save(self._idx,
                                                        str(cache_path).encode()) != 0:
            raise RuntimeError(f"saving the HNSW graph to {cache_path} failed")

    def search(self, queries: np.ndarray, k: int, *, ef: int = 64,
               normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k] f32, ids [Q, k] i32); -1 ids past the graph."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise ValueError(f"queries are {q.shape[1]} wide, the graph {self.dim}")
        if normalize:
            q = np.ascontiguousarray(_unit(q), dtype=np.float32)
        nq = q.shape[0]
        ids = np.empty((nq, k), np.int32)
        scores = np.empty((nq, k), np.float32)
        self._lib.art_hnsw_search(self._idx, q.ctypes.data, nq, k, max(ef, k),
                                  ids.ctypes.data, scores.ctypes.data)
        return scores, ids

    def graph_bytes(self) -> int:
        """Graph-only memory (links + levels), excluding raw vectors."""
        return int(self._lib.art_hnsw_memory_bytes(self._idx))

    def memory_bytes(self) -> int:
        """Equal-memory accounting: f32 vectors + graph (what an HNSW
        deployment holds resident; hnswlib stores both)."""
        return self.n * self.dim * 4 + self.graph_bytes()

    @property
    def max_level(self) -> int:
        return int(self._lib.art_hnsw_max_level(self._idx))

    def __del__(self):
        idx = getattr(self, "_idx", None)
        if idx:
            self._lib.art_hnsw_free(idx)
            self._idx = None


__all__ = ["HNSWBaseline", "available", "FLAGS"]
