"""Device-resident index layer of the port: corpus store, dense and
sparse indexes, token table and the manager."""

from .corpus import (
    FILTER_OPERATORS,
    FILTERABLE_FIELDS,
    ChunkRecord,
    CorpusStore,
    stable_hash64,
)
from .dense_index import DenseIndex
from .manager import MultiIndexManager
from .sparse_index import SparseIndex

__all__ = [
    "ChunkRecord",
    "CorpusStore",
    "DenseIndex",
    "FILTERABLE_FIELDS",
    "FILTER_OPERATORS",
    "MultiIndexManager",
    "SparseIndex",
    "stable_hash64",
]
