"""Host-side lexical analysis for the sparse (BM25) index.

Replaces the reference's hashed-bag sparse embedding generator
(indexing.py:629-654, 10k-dim scipy CSR) with a stable-hash vocabulary
and the fixed-nnz padded layout ``ops/sparse.py`` consumes.  Tokenizing
stays on the host (it is string work); everything numeric happens on
device.

This is the PyTorch port's copy of ``advanced_rag_tpu/index/text.py``.
It keeps the pure-Python path only: the JAX package's optional C++ fast
path lives in that package, which the port never imports, and both
paths give the same arrays.
``hash_term`` memoizes per distinct term, since corpora repeat words.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import re
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")

#: Tiny English stopword list — enough to keep BM25 df tables sane
#: without an external dependency.
STOPWORDS = frozenset(
    """a an and are as at be by for from has he in is it its of on that the
    to was were will with this those these you your i we they them then than
    or not no but if so do does did done""".split()
)


def tokenize(text: str, *, drop_stopwords: bool = True) -> List[str]:
    """Lowercase word tokenizer (host)."""
    toks = _TOKEN_RE.findall(text.lower())
    if drop_stopwords:
        toks = [t for t in toks if t not in STOPWORDS]
    return toks


@functools.lru_cache(maxsize=1 << 20)
def hash_term(term: str, vocab_size: int) -> int:
    """Stable (process-independent) term -> bucket hash.

    Python's builtin ``hash`` is salted per process; blake2b is stable,
    which matters because df tables and doc rows persist across restarts
    (checkpoint/resume of index shards).
    """
    h = hashlib.blake2b(term.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "little") % vocab_size


def encode_documents(
    texts: Sequence[str],
    vocab_size: int,
    doc_nnz: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Encode documents into the fixed-nnz padded sparse layout.

    Returns ``(doc_idx [N, P] i32, doc_tf [N, P] f32, doc_len [N] f32,
    df_delta [V] i32)``.  Terms beyond ``doc_nnz`` distinct hashes are
    dropped lowest-tf-first (the analogue of Milvus's index-time
    truncation).  ``df_delta`` counts one per (doc, distinct-term) for
    the corpus document-frequency table.
    """
    n = len(texts)
    doc_idx = np.full((n, doc_nnz), -1, dtype=np.int32)
    doc_tf = np.zeros((n, doc_nnz), dtype=np.float32)
    doc_len = np.zeros((n,), dtype=np.float32)
    kept: List[int] = []          # every row's distinct kept terms, for df
    for row, text in enumerate(texts):
        toks = tokenize(text)
        doc_len[row] = float(len(toks))
        counts: Counter[int] = Counter(map(hash_term, toks,
                                           itertools.repeat(vocab_size)))
        items = counts.most_common(doc_nnz)
        if items:
            ids, tfs = zip(*items)
            doc_idx[row, : len(ids)] = ids
            doc_tf[row, : len(ids)] = tfs
            kept.extend(ids)
    df_delta = np.bincount(np.asarray(kept, dtype=np.int64),
                           minlength=vocab_size).astype(np.int32)
    return doc_idx, doc_tf, doc_len, df_delta


def encode_queries(
    texts: Sequence[str],
    vocab_size: int,
    query_nnz: int,
    *,
    drop_ratio: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode queries into padded ``(q_idx [Q, T] i32, q_tf [Q, T] f32)``.

    ``drop_ratio`` prunes the lowest-tf fraction of query terms — parity
    with Milvus ``drop_ratio_search=0.2`` (reference retrieval.py:97-101).
    """
    q = len(texts)
    q_idx = np.full((q, query_nnz), -1, dtype=np.int32)
    q_tf = np.zeros((q, query_nnz), dtype=np.float32)
    for row, text in enumerate(texts):
        counts = Counter(hash_term(t, vocab_size) for t in tokenize(text))
        items = counts.most_common()
        if drop_ratio > 0.0 and len(items) > 1:
            keep = max(1, int(round(len(items) * (1.0 - drop_ratio))))
            items = items[:keep]
        for j, (term_id, tf) in enumerate(items[:query_nnz]):
            q_idx[row, j] = term_id
            q_tf[row, j] = float(tf)
    return q_idx, q_tf


def remove_documents_df(
    doc_idx_rows: np.ndarray, vocab_size: int
) -> np.ndarray:
    """df_delta to SUBTRACT when rows are deleted (right-to-forget path)."""
    df_delta = np.zeros((vocab_size,), dtype=np.int32)
    flat = doc_idx_rows.reshape(-1)
    flat = flat[flat >= 0]
    np.add.at(df_delta, flat, 1)
    return df_delta


__all__ = [
    "tokenize",
    "hash_term",
    "encode_documents",
    "encode_queries",
    "remove_documents_df",
    "STOPWORDS",
]
