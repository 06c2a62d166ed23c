"""Host C++ fast path for the text hot loops, loaded through ctypes.

``text_native.cpp`` tokenizes, hashes and counts terms for
``index/text.py`` (``encode_documents``, ``encode_queries``), splits
sentences and counts their tokens for the chunker, and analyzes a whole
document for ``pipeline/diagnostics.py``, with the Python modules' rule
on ASCII text.  The callers send it ASCII text only: it treats every
non-ASCII byte as a separator, where Python's ``str.lower()`` maps a few
non-ASCII letters to ASCII (U+212A KELVIN SIGN becomes ``k``).

The library builds at first use with g++ into ``build/native/`` at the
root of the checkout (git-ignored), named by a hash of the source, the
flags and any extra key (the HNSW baseline adds the host CPU, since it
builds with ``-march=native``); the compiler writes a temporary name that
is then renamed into place, so two processes building at once cannot
leave a torn file.  A failed build raises with the command and the
compiler's output: there is no silent fallback.  The one switch that
selects the Python rule is ``ADVANCED_RAG_TPU_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build" / "native"
CXX = "g++"
TEXT_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
SWITCH = "ADVANCED_RAG_TPU_NO_NATIVE"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library's g++ call took in this process (absent when the
#: library was already built); chip_smoke.py prints them
build_seconds: Dict[str, float] = {}


def enabled() -> bool:
    """False when ``ADVANCED_RAG_TPU_NO_NATIVE`` is set: the callers then
    run the Python rule."""
    return not os.environ.get(SWITCH)


def host_key() -> str:
    """The machine and the CPU's feature flags: a library built with
    ``-march=native`` on one host may hold instructions another lacks."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    except OSError:
        pass
    return f"{platform.machine()}|{flags.strip()}"


def library_path(src: Path, flags: Sequence[str], key: str = "") -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join([*flags, key]).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build_library(src: Path, flags: Sequence[str], key: str = "") -> Path:
    """Compile ``src`` with ``CXX`` and ``flags`` unless the library for
    this source, these flags and ``key`` exists; raise if the compiler
    fails or is missing."""
    out = library_path(src, flags, key)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp.so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *flags, str(src), "-o", tmp]
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[src.stem] = time.perf_counter() - t0
    return out


def load(name: str, flags: Sequence[str], bind, key: str = "") -> ctypes.CDLL:
    """The library of ``SRC_DIR/<name>.cpp``, built on first use, with
    ``bind(lib)`` setting its argtypes."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(SRC_DIR / f"{name}.cpp", flags, key)))
            bind(lib)
            _libs[name] = lib
        return lib


def _bind_text(lib: ctypes.CDLL) -> None:
    p, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    lib.art_encode_documents.argtypes = [ctypes.c_char_p, p, i64, i32, i32, p, p, p, p]
    lib.art_encode_documents.restype = None
    lib.art_encode_queries.argtypes = [ctypes.c_char_p, p, i64, i32, i32, f64, p, p]
    lib.art_encode_queries.restype = None
    lib.art_text_stats.argtypes = [ctypes.c_char_p, i64, i32, p]
    lib.art_text_stats.restype = None
    lib.art_split_sentences.argtypes = [ctypes.c_char_p, i64, p, p, p, i32]
    lib.art_split_sentences.restype = i32
    lib.art_quick_stats.argtypes = [ctypes.c_char_p, i64, p]
    lib.art_quick_stats.restype = None
    lib.art_analyze_document.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p, p, i64,
                                         p, i32, p, p, p, p]
    lib.art_analyze_document.restype = None


def text_lib() -> ctypes.CDLL:
    return load("text_native", TEXT_FLAGS, _bind_text)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _pack(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    encoded = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def encode_documents_native(
    texts: Sequence[str], vocab_size: int, doc_nnz: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``index.text.encode_documents`` of ASCII ``texts`` in C++."""
    lib = text_lib()
    buf, offsets = _pack(texts)
    n = len(texts)
    doc_idx = np.full((n, doc_nnz), -1, np.int32)
    doc_tf = np.zeros((n, doc_nnz), np.float32)
    doc_len = np.zeros((n,), np.float32)
    df_delta = np.zeros((vocab_size,), np.int32)
    if n:
        lib.art_encode_documents(buf, _ptr(offsets), n, vocab_size, doc_nnz, _ptr(doc_idx),
                                 _ptr(doc_tf), _ptr(doc_len), _ptr(df_delta))
    return doc_idx, doc_tf, doc_len, df_delta


def encode_queries_native(
    texts: Sequence[str], vocab_size: int, query_nnz: int, drop_ratio: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """``index.text.encode_queries`` of ASCII ``texts`` in C++."""
    lib = text_lib()
    buf, offsets = _pack(texts)
    n = len(texts)
    q_idx = np.full((n, query_nnz), -1, np.int32)
    q_tf = np.zeros((n, query_nnz), np.float32)
    if n:
        lib.art_encode_queries(buf, _ptr(offsets), n, vocab_size, query_nnz,
                               float(drop_ratio), _ptr(q_idx), _ptr(q_tf))
    return q_idx, q_tf


def text_stats_native(text: str, drop_stopwords: bool = False) -> Tuple[float, ...]:
    """(tokens, entropy, r1, r2, r3, distinct) of ``index.text.tokenize``'s
    tokens: the entropy normalized by log2(distinct), r_g the share of
    repeated g-grams."""
    data = text.encode("utf-8")
    out = np.zeros(6, np.float64)
    text_lib().art_text_stats(data, len(data), int(drop_stopwords), _ptr(out))
    return tuple(out.tolist())


def split_sentences_native(text: str) -> Tuple[List[str], List[int]]:
    """``diagnostics.split_sentences(text)`` and each sentence's
    ``len(tokenize_words(s))`` in one pass, for ASCII ``text``."""
    lib = text_lib()
    raw = text.encode("utf-8")
    if not raw:
        return [], []
    # realistic sentences are tens of bytes; start with a modest cap (a
    # len // 2 bound would allocate ~10x the text in scratch) and retry
    # with the worst case only if it fills up
    cap, worst = min(len(raw) // 8 + 16, len(raw) // 2 + 1), len(raw) // 2 + 1
    while True:
        starts = np.zeros(cap, np.int64)
        ends = np.zeros(cap, np.int64)
        counts = np.zeros(cap, np.int32)
        n = lib.art_split_sentences(raw, len(raw), _ptr(starts), _ptr(ends), _ptr(counts), cap)
        if n < cap or cap >= worst:
            break
        cap = worst
    sentences = [raw[starts[i]:ends[i]].decode("utf-8") for i in range(n)]
    return sentences, counts[:n].tolist()


def quick_stats_native(text: str) -> Tuple[int, float, int]:
    """(token count, normalized entropy, distinct tokens) of
    ``tokenize_words(text)``, for the chunker's per-chunk stats."""
    data = text.encode("utf-8")
    out = np.zeros(3, np.float64)
    text_lib().art_quick_stats(data, len(data), _ptr(out))
    return int(out[0]), float(out[1]), int(out[2])


def analyze_document_native(text: str, lexicons: Mapping[str, Sequence[str]]) -> dict:
    """One-pass document diagnostics of ASCII ``text``: token_count,
    entropy, ngrams {1, 2, 3}, distinct, sentence_count, coherence, the
    hit rate of each lexicon (in iteration order) and the top-20 token
    distribution."""
    lib = text_lib()
    raw = text.encode("utf-8")
    names = list(lexicons)
    words = [w.encode("utf-8") for name in names for w in lexicons[name]]
    ids = np.asarray([li for li, name in enumerate(names) for _ in lexicons[name]], np.int32)
    lex_off = np.zeros(len(words) + 1, np.int64)
    np.cumsum([len(w) for w in words], out=lex_off[1:])
    out = np.zeros(8 + len(names), np.float64)
    top_off = np.zeros(20, np.int64)
    top_len = np.zeros(20, np.int64)
    top_cnt = np.zeros(20, np.int64)
    lib.art_analyze_document(raw, len(raw), b"".join(words), _ptr(lex_off), len(words),
                             _ptr(ids), len(names), _ptr(out), _ptr(top_off), _ptr(top_len),
                             _ptr(top_cnt))
    dist = {}
    for k in range(20):
        if top_off[k] < 0 or top_cnt[k] == 0:
            break
        word = raw[top_off[k]:top_off[k] + top_len[k]].decode("utf-8").lower()
        dist[word] = int(top_cnt[k])
    return {
        "token_count": int(out[0]),
        "entropy": float(out[1]),
        "ngrams": {1: float(out[2]), 2: float(out[3]), 3: float(out[4])},
        "distinct": int(out[5]),
        "sentence_count": int(out[6]),
        "coherence": float(out[7]),
        "domain_scores": {name: float(out[8 + i]) for i, name in enumerate(names)},
        "token_distribution": dist,
    }


__all__ = [
    "enabled", "host_key", "library_path", "build_library", "load", "text_lib",
    "encode_documents_native", "encode_queries_native", "text_stats_native",
    "split_sentences_native", "quick_stats_native", "analyze_document_native",
    "BUILD_DIR", "CXX", "SWITCH",
]
