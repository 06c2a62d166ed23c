"""The port's C++ text fast path (advanced_rag_tpu_torch/native) against the
JAX package's C++ path and its Python rule.

- The six C entry points give the JAX package's arrays exactly, and its
  floats within 1e-12, on the texts of tests/test_native.py and on 300
  seeded ASCII documents; each also equals the Python rule it stands in
  for (``ADVANCED_RAG_TPU_NO_NATIVE=1`` on the JAX side, the Python
  formula in this file for ``art_text_stats``, which has none there).
- The ASCII gate: text holding U+212A KELVIN SIGN gives the Python rule's
  terms (``str.lower()`` maps it to ``k``), not the JAX package's C++
  path's, which reads every non-ASCII byte as a separator.  Query pruning
  rounds half to even as Python's ``round`` (drop_ratio 0.1, 15 terms: 14
  kept), where the JAX package's C++ path rounds half away (13).
- The chunker and the diagnostics equal the JAX package's, with the C++
  path and with the switch on both sides.
- A failed build raises with the command; no Python answer comes back.
- The query and per-document calls keep the interpreter lock;
  ``encode_documents`` releases it.
"""

import ctypes
import math
from collections import Counter

import numpy as np
import pytest

from advanced_rag_tpu import native as j_native
from advanced_rag_tpu.index import text as j_text
from advanced_rag_tpu.pipeline import chunking as j_chunking
from advanced_rag_tpu.pipeline import diagnostics as j_diag
from advanced_rag_tpu_torch import native as t_native
from advanced_rag_tpu_torch.index import text as t_text
from advanced_rag_tpu_torch.pipeline import chunking as t_chunking
from advanced_rag_tpu_torch.pipeline import diagnostics as t_diag

#: tests/test_native.py's texts and sentence / analysis cases
TEXTS = [
    "The Quick Brown Fox jumps over the lazy dog!  Again: quick, quick.",
    "alpha beta GAMMA delta alpha beta alpha 42 numbers 42 too",
    "",
    "stopwords the and of in a an should vanish from this text",
]
SENTENCE_CASES = [
    "Simple one. And two! Then three? Done.",
    "No terminal punctuation here",
    "Para one line.\n\nPara two starts here. And ends.",
    "Trailing spaces.   \n\n   Leading spaces after blank.",
    "Mixed \n \n no split on broken blank line",
    "a.b stays joined. but this splits.  Double-space delim.",
    "Ends with punct and space. ",
    "  leading ws then text. second piece.",
    "don't drop apostrophes. can't count wrong.",
    "newline run\n\n\n\nmany blanks",
    "ascii separators a.\x1cb split. like\x1d python? whitespace\x1e!",
    "end.\x1d start again.",
    "   ",
]
ANALYSIS_CASES = [
    "The quick brown fox jumps over the lazy dog. " * 20,
    "Algorithm api architecture! Database deployment encryption. "
    "Patient therapy treatment?",
    "One sentence only without punctuation",
    "Para one.\n\nPara two here. Three! Four? " * 10,
    "don't can't won't isn't. apostrophes count once.",
    "Repeat repeat repeat repeat. Repeat repeat repeat.",
    "asset audit bond capital. appeal attorney breach clause!",
]
WORDS = ("the dense sparse fusion rank vector token query index shard cache "
         "filter chunk model score merge tier scan kernel batch recall latency "
         "corpus embed rerank bucket hash table slot weight drift metric "
         "algorithm api patient court market Don't it's GPU Kernel BM25 "
         "of and a to in is").split()
KELVIN = "\u212aelvin scale temperature"
UNICODE = "unicode caf\u00e9 na\u00efve \u00fcber tokens split on non-ascii"


def seeded_documents(seed=0, n=300):
    """ASCII documents of seeded words, terminators and separators."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sents = []
        for _ in range(int(rng.integers(1, 25))):
            s = " ".join(rng.choice(WORDS, size=int(rng.integers(2, 30))))
            sents.append(s[0].upper() + s[1:] + str(rng.choice([".", "!", "?", ";", ""])))
        seps = rng.choice([" ", "  ", "\n", "\n\n", " \t", "\n\n\n"], size=len(sents))
        out.append("".join(a + b for a, b in zip(sents, seps)))
    return out


DOCS = seeded_documents()
ALL_TEXTS = TEXTS + SENTENCE_CASES + ANALYSIS_CASES + DOCS


@pytest.fixture
def python_rule(monkeypatch):
    """A context in which both packages run their Python rule."""
    class Switch:
        def __enter__(self):
            monkeypatch.setenv("ADVANCED_RAG_TPU_NO_NATIVE", "1")

        def __exit__(self, *exc):
            monkeypatch.delenv("ADVANCED_RAG_TPU_NO_NATIVE")

    monkeypatch.delenv("ADVANCED_RAG_TPU_NO_NATIVE", raising=False)
    assert j_native.get_lib() is not None, "the JAX package's C++ path did not build"
    return Switch()


def assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("vocab,nnz", [(4096, 16), (16384, 64)])
def test_encode_documents(python_rule, vocab, nnz):
    got = t_native.encode_documents_native(ALL_TEXTS, vocab, nnz)
    assert_arrays_equal(got, j_native.encode_documents_native(ALL_TEXTS, vocab, nnz))
    assert_arrays_equal(t_text.encode_documents(ALL_TEXTS, vocab, nnz), got)
    with python_rule:
        want = j_text.encode_documents(ALL_TEXTS, vocab, nnz)
        mixed = j_text.encode_documents(ALL_TEXTS + [UNICODE], vocab, nnz)
        assert_arrays_equal(t_text.encode_documents(ALL_TEXTS, vocab, nnz), want)
    assert_arrays_equal(got, want)
    # a non-ASCII row goes through the Python rule, the rest through C++
    assert_arrays_equal(t_text.encode_documents(ALL_TEXTS + [UNICODE], vocab, nnz), mixed)


@pytest.mark.parametrize("drop_ratio", [0.0, 0.2])
def test_encode_queries(python_rule, drop_ratio):
    queries = ["Quick fox QUERY", "alpha beta alpha beta gamma delta x y z w", ""] + [
        d[:200] for d in DOCS]
    got = t_native.encode_queries_native(queries, 4096, 32, drop_ratio)
    assert_arrays_equal(got, j_native.encode_queries_native(queries, 4096, 32, drop_ratio))
    assert_arrays_equal(t_text.encode_queries(queries, 4096, 32, drop_ratio=drop_ratio), got)
    with python_rule:
        want = j_text.encode_queries(queries, 4096, 32, drop_ratio=drop_ratio)
    assert_arrays_equal(got, want)


def python_text_stats(text, drop_stopwords):
    toks = t_text.tokenize(text, drop_stopwords=drop_stopwords)
    n = len(toks)
    if n == 0:
        return (0.0,) * 6
    counts = Counter(toks)
    entropy = 0.0
    if len(counts) > 1:
        entropy = -sum(c / n * math.log2(c / n) for c in counts.values())
        entropy /= math.log2(len(counts))
    reds = [1.0 - len(set(zip(*[toks[i:] for i in range(g)]))) / (n - g + 1)
            if n >= g else 0.0 for g in (1, 2, 3)]
    return (float(n), entropy, *reds, float(len(counts)))


@pytest.mark.parametrize("drop_stopwords", [False, True])
def test_text_stats(drop_stopwords):
    for text in ALL_TEXTS:
        got = t_native.text_stats_native(text, drop_stopwords)
        assert got == j_native.text_stats_native(text, drop_stopwords), text
        np.testing.assert_allclose(got, python_text_stats(text, drop_stopwords),
                                   rtol=0, atol=1e-12, err_msg=text)
    tokens, entropy, r1, _, _, distinct = t_native.text_stats_native(
        "one two three one two one")
    assert (tokens, distinct, r1) == (6, 3, 0.5) and 0 < entropy <= 1


def test_split_sentences(python_rule):
    for text in SENTENCE_CASES + ANALYSIS_CASES + DOCS:
        sents, counts = t_native.split_sentences_native(text)
        assert (sents, counts) == j_native.split_sentences_native(text), text
        assert sents == j_diag.split_sentences(text), text
        assert counts == [len(j_diag.tokenize_words(s)) for s in sents], text
    assert t_native.split_sentences_native("") == ([], [])


def test_quick_stats():
    for text in ALL_TEXTS:
        ntok, entropy, distinct = t_native.quick_stats_native(text)
        assert (ntok, entropy, distinct) == j_native.quick_stats_native(text), text
        tokens = t_diag.tokenize_words(text)
        want_entropy, want_red = t_chunking.AdaptiveChunker._quick_stats(tokens)
        assert (ntok, distinct) == (len(tokens), len(set(tokens))), text
        assert abs(entropy - want_entropy) <= 1e-12, text
        assert abs(((1.0 - distinct / ntok) if ntok else 0.0) - want_red) <= 1e-12, text


def metrics_close(got, want, tol=1e-12):
    assert got.token_count == want.token_count
    assert got.sentence_count == want.sentence_count
    for f in ("entropy", "redundancy", "domain_density", "vocabulary_diversity",
              "coherence", "complexity"):
        assert abs(getattr(got, f) - getattr(want, f)) <= tol, f
    assert got.token_distribution == want.token_distribution
    assert got.domain_scores == want.domain_scores
    for g in (1, 2, 3):
        assert abs(got.ngram_redundancy[g] - want.ngram_redundancy[g]) <= tol, g


def test_analyze_document(python_rule):
    lexicons = t_diag.DocumentDiagnostics().lexicons
    for text in ANALYSIS_CASES + DOCS + [""]:
        got = t_native.analyze_document_native(text, lexicons)
        assert got == j_native.analyze_document_native(text, lexicons), text
        with python_rule:
            want = j_diag.DocumentDiagnostics().analyze_document(text)
        metrics_close(t_diag.DocumentDiagnostics()._metrics_from_native(got), want)


def test_kelvin_sign_takes_the_python_rule(python_rule):
    """U+212A lowers to 'k' in Python; the C++ path would split on it."""
    vocab, nnz = 16384, 8
    texts = ["plain ascii text here", KELVIN, "more ascii words"]
    got = t_text.encode_documents(texts, vocab, nnz)
    jax_cpp = j_native.encode_documents_native(texts, vocab, nnz)
    with python_rule:
        want = j_text.encode_documents(texts, vocab, nnz)
    assert_arrays_equal(got, want)
    assert got[0][1, 0] == t_text.hash_term("kelvin", vocab)
    assert jax_cpp[0][1, 0] == t_text.hash_term("elvin", vocab)
    assert not np.array_equal(jax_cpp[0], want[0])
    assert not np.array_equal(jax_cpp[3], want[3])
    q_got = t_text.encode_queries([KELVIN, "ascii query"], vocab, 8, drop_ratio=0.2)
    with python_rule:
        q_want = j_text.encode_queries([KELVIN, "ascii query"], vocab, 8, drop_ratio=0.2)
    assert_arrays_equal(q_got, q_want)


def test_query_pruning_rounds_half_to_even(python_rule):
    query = [" ".join(f"w{i}" for i in range(15))]
    got = t_text.encode_queries(query, 4096, 32, drop_ratio=0.1)
    with python_rule:
        want = j_text.encode_queries(query, 4096, 32, drop_ratio=0.1)
    assert_arrays_equal(got, want)
    assert int((got[0] >= 0).sum()) == 14             # round(13.5) == 14
    jax_cpp = j_native.encode_queries_native(query, 4096, 32, drop_ratio=0.1)
    assert int((jax_cpp[0] >= 0).sum()) == 13


def run_chunker(chunking, diag, texts):
    out = []
    for t in texts:
        metrics = diag.DocumentDiagnostics().analyze_document(t)
        chunker = chunking.AdaptiveChunker(base_chunk_size=40, max_chunk_size=80,
                                           min_chunk_size=10)
        out.append([(c.content, c.metadata.chunk_id, c.metadata.start_char,
                     c.metadata.end_char, c.metadata.token_count, c.metadata.entropy,
                     c.metadata.redundancy) for c in chunker.chunk_document(t, doc_id="d")])
    return out


@pytest.mark.parametrize("switch", [False, True], ids=["cpp", "python"])
def test_chunker_and_diagnostics_match_jax(python_rule, monkeypatch, switch):
    texts = DOCS[:80] + ANALYSIS_CASES + [
        "The quick brown fox jumps. " * 40 + "\n\nSecond paragraph here! " * 30]
    if switch:
        monkeypatch.setenv("ADVANCED_RAG_TPU_NO_NATIVE", "1")
    got = run_chunker(t_chunking, t_diag, texts)
    want = run_chunker(j_chunking, j_diag, texts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c[:5] for c in g] == [c[:5] for c in w]
        np.testing.assert_allclose([c[5:] for c in g], [c[5:] for c in w],
                                   rtol=0, atol=1e-12)
    for t in texts:
        metrics_close(t_diag.DocumentDiagnostics().analyze_document(t),
                      j_diag.DocumentDiagnostics().analyze_document(t))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("ADVANCED_RAG_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(t_native, "_libs", {})
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        t_text.encode_documents(["an ascii text"], 64, 4)
    with pytest.raises(RuntimeError, match="native build failed"):
        t_diag.DocumentDiagnostics().analyze_document("An ascii text. Two sentences.")
    assert not list(tmp_path.glob("*.so"))
    # the switch is the one way to the Python rule
    monkeypatch.setenv("ADVANCED_RAG_TPU_NO_NATIVE", "1")
    idx, _, _, _ = t_text.encode_documents(["an ascii text"], 64, 4)
    assert (idx >= 0).sum() == 2          # "ascii", "text"; "an" is a stopword


def test_library_is_keyed_by_source_flags_and_host(tmp_path):
    src = t_native.SRC_DIR / "text_native.cpp"
    base = t_native.library_path(src, t_native.TEXT_FLAGS)
    assert base.parent == t_native.BUILD_DIR
    assert base.parent.parent.name == "build" and base.name.startswith("text_native_")
    assert t_native.library_path(src, t_native.TEXT_FLAGS + ["-g"]) != base
    assert t_native.library_path(src, t_native.TEXT_FLAGS, key="other cpu") != base
    copy = tmp_path / "text_native.cpp"
    copy.write_text(src.read_text() + "\n// edited\n")
    assert t_native.library_path(copy, t_native.TEXT_FLAGS).name != base.name
    assert t_native.host_key()


def test_one_library_handle_serves_every_entry_point(monkeypatch):
    """The text library loads once, as one ``ctypes.CDLL`` (as the JAX
    package loads it), and every entry point calls through that handle."""
    monkeypatch.delenv("ADVANCED_RAG_TPU_NO_NATIVE", raising=False)
    lib = t_native.text_lib()
    assert type(lib) is ctypes.CDLL and t_native.text_lib() is lib
    calls = []
    real = t_native.text_lib

    def spy():
        calls.append(1)
        return real()

    monkeypatch.setattr(t_native, "text_lib", spy)
    t_text.encode_queries(["alpha beta"], 4096, 8)
    t_text.encode_documents(["alpha beta"], 4096, 8)
    t_native.split_sentences_native("One. Two.")
    t_native.quick_stats_native("one two")
    t_native.text_stats_native("one two")
    t_native.analyze_document_native("One. Two.", t_diag.DocumentDiagnostics().lexicons)
    assert len(calls) == 6
    assert [k for k in t_native._libs if k.startswith("text_native")] == ["text_native"]
