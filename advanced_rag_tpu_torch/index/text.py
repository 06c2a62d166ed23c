"""Host-side lexical analysis for the sparse (BM25) index.

Replaces the reference's hashed-bag sparse embedding generator
(indexing.py:629-654, 10k-dim scipy CSR) with a stable-hash vocabulary
and the fixed-nnz padded layout ``ops/sparse.py`` consumes.  Tokenizing
stays on the host (it is string work); everything numeric happens on
device.

This is the PyTorch port's copy of ``advanced_rag_tpu/index/text.py``.
ASCII text goes through the C++ fast path (``native/text_native.cpp``),
which gives the same arrays as the Python rule here; other text goes
through the Python rule, row by row, because ``str.lower()`` maps a few
non-ASCII letters to ASCII and the C++ path treats every non-ASCII byte
as a separator.  ``ADVANCED_RAG_TPU_NO_NATIVE=1`` selects the Python rule
for every row.  ``hash_term`` memoizes per distinct term, since corpora
repeat words.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import re
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

from .. import native
from ..utils.profiling import annotate

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


@annotate("encode_documents")
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
    if not native.enabled():
        return _encode_documents_python(texts, vocab_size, doc_nnz)
    rows, ascii_texts = _split_ascii(texts)
    doc_idx, doc_tf, doc_len, df_delta = native.encode_documents_native(
        ascii_texts, vocab_size, doc_nnz)
    if rows:
        py_idx, py_tf, py_len, py_df = _encode_documents_python(
            [texts[i] for i in rows], vocab_size, doc_nnz)
        doc_idx[rows], doc_tf[rows], doc_len[rows] = py_idx, py_tf, py_len
        df_delta += py_df
    return doc_idx, doc_tf, doc_len, df_delta


def _split_ascii(texts: Sequence[str]) -> Tuple[List[int], Sequence[str]]:
    """(rows of the non-ASCII texts, ``texts`` with those rows emptied):
    the C++ path encodes the second, the Python rule the rows."""
    rows = [i for i, t in enumerate(texts) if not t.isascii()]
    if not rows:
        return rows, texts
    blank = list(texts)
    for i in rows:
        blank[i] = ""
    return rows, blank


def _encode_documents_python(
    texts: Sequence[str], vocab_size: int, doc_nnz: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
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


@annotate("encode_queries")
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
    if not native.enabled():
        return _encode_queries_python(texts, vocab_size, query_nnz, drop_ratio)
    rows, ascii_texts = _split_ascii(texts)
    q_idx, q_tf = native.encode_queries_native(ascii_texts, vocab_size, query_nnz,
                                               drop_ratio)
    if rows:
        q_idx[rows], q_tf[rows] = _encode_queries_python(
            [texts[i] for i in rows], vocab_size, query_nnz, drop_ratio)
    return q_idx, q_tf


def _encode_queries_python(
    texts: Sequence[str], vocab_size: int, query_nnz: int, drop_ratio: float,
) -> Tuple[np.ndarray, np.ndarray]:
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
