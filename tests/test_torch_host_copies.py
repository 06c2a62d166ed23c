"""The port's copies of the JAX package's host-only modules against the
originals, on the same seeded inputs.

Each case runs one module's public surface in both packages and compares
what comes out.  Bounds: exact for ids, strings, counts and states; the
diagnostics and chunk statistics within 1e-12 absolute (both packages
compute them for ASCII text in C++, and in Python under
ADVANCED_RAG_TPU_NO_NATIVE=1, the "-python" cases; when the port ran
Python against the JAX package's C++, 300 seeded documents differed by
at most 7e-16); numpy float results of the
evaluator and rankers within 1e-12 relative.  Timestamps, uuids and
other clock-dependent fields are left out of the comparison.
"""

import concurrent.futures
import dataclasses
import enum
import os
import random

import numpy as np
import pytest

from advanced_rag_tpu.pipeline import batcher as j_batcher
from advanced_rag_tpu.pipeline import chunking as j_chunking
from advanced_rag_tpu.pipeline import compliance as j_compliance
from advanced_rag_tpu.pipeline import diagnostics as j_diagnostics
from advanced_rag_tpu.pipeline import enrichment as j_enrichment
from advanced_rag_tpu.pipeline import evaluation as j_evaluation
from advanced_rag_tpu.pipeline import experiments as j_experiments
from advanced_rag_tpu.pipeline import query_ops as j_query_ops
from advanced_rag_tpu.pipeline import ranker as j_ranker
from advanced_rag_tpu.utils import circuit_breaker as j_breaker
from advanced_rag_tpu.utils import rate_limit as j_rate_limit
from advanced_rag_tpu_torch.pipeline import batcher as t_batcher
from advanced_rag_tpu_torch.pipeline import chunking as t_chunking
from advanced_rag_tpu_torch.pipeline import compliance as t_compliance
from advanced_rag_tpu_torch.pipeline import diagnostics as t_diagnostics
from advanced_rag_tpu_torch.pipeline import enrichment as t_enrichment
from advanced_rag_tpu_torch.pipeline import evaluation as t_evaluation
from advanced_rag_tpu_torch.pipeline import experiments as t_experiments
from advanced_rag_tpu_torch.pipeline import query_ops as t_query_ops
from advanced_rag_tpu_torch.pipeline import ranker as t_ranker
from advanced_rag_tpu_torch.utils import circuit_breaker as t_breaker
from advanced_rag_tpu_torch.utils import rate_limit as t_rate_limit

WORDS = ("the dense sparse fusion rank vector token query index shard cache "
         "filter chunk model score merge tier scan kernel batch recall latency "
         "corpus embed rerank bucket hash table slot weight drift metric "
         "algorithm api patient court market Don't it's GPU Kernel BM25").split()
#: fields that depend on the clock or on uuid4, not on the inputs
VOLATILE = {"timestamp", "event_id", "generated_at", "latency_ms",
            "retention_until"}


def document(rng, nonascii=False):
    """Sentences of seeded words with mixed terminators and separators;
    ``nonascii`` adds accented words (the JAX package's C++ path then
    stands aside, and both run Python)."""
    sents = []
    for _ in range(int(rng.integers(2, 30))):
        words = list(rng.choice(WORDS, size=int(rng.integers(3, 25))))
        if nonascii and rng.random() < 0.3:
            words.insert(1, "café naïve")
        s = " ".join(words)
        sents.append(s[0].upper() + s[1:] + str(rng.choice([".", "!", "?", ";"])))
    seps = rng.choice([" ", "  ", "\n", "\n\n", " \t"], size=len(sents))
    return "".join(a + b for a, b in zip(sents, seps))


def plain(x):
    """Dataclasses, enums and numpy values as plain Python, volatile
    fields dropped."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name not in VOLATILE}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def assert_same(got, want, rel=0.0, abs_=0.0, path="out"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_same(got[k], want[k], rel, abs_, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, rel, abs_, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rel, abs=abs_), (path, got, want)
    else:
        assert got == want, (path, got, want)


def docs(seed, n, nonascii=False):
    rng = np.random.default_rng(seed)
    return [document(rng, nonascii) for _ in range(n)]


def run_chunker(mod_c, mod_d, strategy, texts):
    out = []
    for t in texts:
        metrics = mod_d.DocumentDiagnostics().analyze_document(t)
        chunker = mod_c.AdaptiveChunker(base_chunk_size=40, max_chunk_size=80,
                                        min_chunk_size=10, strategy=strategy)
        out.append([(c.content, plain(c.metadata))
                    for c in chunker.chunk_document(t, metrics=metrics, source="s",
                                                    extra={"k": 1})])
    return out


def run_diagnostics(mod, texts):
    return [plain(mod.DocumentDiagnostics().analyze_document(t)) for t in texts]


def python_rule(runner):
    """``runner`` under ADVANCED_RAG_TPU_NO_NATIVE=1: both packages run
    their Python rule instead of their C++ fast path."""
    def run(*args):
        before = os.environ.get("ADVANCED_RAG_TPU_NO_NATIVE")
        os.environ["ADVANCED_RAG_TPU_NO_NATIVE"] = "1"
        try:
            return runner(*args)
        finally:
            if before is None:
                del os.environ["ADVANCED_RAG_TPU_NO_NATIVE"]
            else:
                os.environ["ADVANCED_RAG_TPU_NO_NATIVE"] = before
    return run


QUERIES = [
    "how do I fix error 404 in the api?", "summarize the q3 report",
    "what is BM25", "compare dense and sparse retrieval and explain why RRF helps",
    "why does the kernel crash when the cache is full; also how to reset it",
    "ML vs NLP for k8s deployment", "analyze latency trends across shards",
    "what's the difference between IVF and PQ tiers, and which is faster?",
]


def run_query_ops(mod, _):
    rw, dc, cl = mod.QueryRewriter(), mod.QueryDecomposer(), mod.QueryClassifier()
    return [(rw.rewrite(q), plain(dc.decompose(q)), cl.classify(q)) for q in QUERIES]


def run_enrichment(mod, texts):
    return [plain(mod.SemanticEnricher().enrich(t)) for t in texts]


def run_evaluator(mod, texts):
    rng = np.random.default_rng(3)
    ev = mod.RAGEvaluator()
    out = []
    for i in range(6):
        n = int(rng.integers(1, 9))
        hits = [{"chunk_id": f"c{j}", "doc_id": f"d{j // 2}", "content": texts[j],
                 "score": float(s)}
                for j, s in enumerate(np.sort(rng.random(n))[::-1])]
        emb = rng.standard_normal((n, 16)).astype(np.float32)
        m = ev.evaluate_retrieval(QUERIES[i], hits, relevant_ids=["c0", f"c{n}", "d1"],
                                  k=5, latency_ms=1.0, result_embeddings=emb)
        out.append(plain(m))
    table = {q: rng.standard_normal(16).astype(np.float32) for q in QUERIES}
    drift = ev.detect_drift(queries=QUERIES, embed_fn=lambda q: table[q],
                            threshold=0.15)
    out.append(plain(drift))
    return out


def run_compliance(mod, texts):
    forgotten = []
    cm = mod.ComplianceManager(tenant="t", retention_days=30,
                               index_deleter=lambda d: forgotten.append(d) or 3)
    for i, t in enumerate(texts[:4]):
        cm.log_ingestion(f"d{i}", i + 1, user="u")
        cm.create_version(f"d{i}", t, parents=[f"d{i - 1}"] if i else None)
    cm.create_version("d0", texts[0] + " v2")
    cm.log_retrieval("query", ["d0", "d1"], user="u")
    cm.apply_legal_hold("d1")
    out = {"held_refused": False}
    try:
        cm.forget_document("d1")
    except Exception as exc:
        out["held_refused"] = type(exc).__name__
    out["forget"] = cm.forget_document("d2", user="u")
    cm.release_legal_hold("d1")
    out["versions"] = [plain(v) for v in cm.get_versions("d0")]
    out["lineage"] = cm.get_lineage_tree("d3")
    out["audit"] = [plain(e) for e in cm.query_audit_logs(limit=50)]
    out["audit_d0"] = len(cm.query_audit_logs(doc_id="d0"))
    out["report"] = plain(cm.generate_compliance_report())
    out["integrity"] = [cm.verify_data_integrity("d0", texts[0] + " v2"),
                        cm.verify_data_integrity("d0", texts[0])]
    out["deleted"] = forgotten
    return out


def run_ranker(mod, _):
    rng = np.random.default_rng(5)
    results = [{"score": float(s), "method_count": int(c)}
               for s, c in zip(rng.random(12), rng.integers(1, 4, 12))]
    lr = mod.LearnedRanker()
    before = lr.score_sync(results)
    for r, pos in zip(results, rng.random(12) > 0.5):
        lr.update_from_feedback(r, bool(pos))
    ad = mod.LearnedHybridAdapter()
    ad.fit_from_feedback([("hybrid", True), ("sparse", False), ("dense", True)])
    return [before, lr.score_sync(results), lr.weights,
            [ad(q, 0.7, 0.3) for q in QUERIES]]


def run_experiments(mod, _):
    em = mod.ExperimentManager(epsilon=0.3, rng=random.Random(11))
    em.register("baseline", {})
    em.register("lexical_lean", {"dense_weight": 0.55})
    picks = []
    for i in range(40):
        name = em.choose_variant()
        picks.append(name)
        em.record_outcome(name, i % 3 != 0, reward=1.0 if i % 2 else 0.5)
    return [picks, em.report()]


def run_batcher(mod, _):
    calls = []

    def batch_fn(queries, k):
        calls.append(len(queries))
        return [f"{q}|{k}|{len(q)}" for q in queries]

    mb = mod.MicroBatcher(batch_fn, max_batch=4)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(mb.submit, ("k", i % 2), f"q{i}", k=i % 2)
                    for i in range(24)]
            out = [f.result() for f in futs]
    finally:
        mb.close()
    assert sum(calls) == 24 and max(calls) <= 4
    return out


def run_breaker(mod, _):
    cb = mod.CircuitBreaker(mod.CircuitBreakerConfig(
        failure_threshold=3, timeout_seconds=0.0, success_threshold=2), name="x")
    states = []
    for op in ["f", "f", "s", "f", "f", "f", "o", "s", "s", "f", "f", "f", "s", "s"]:
        if op == "f":
            cb.record_failure()
        elif op == "s":
            cb.record_success()
        else:
            cb.is_open()
        states.append(cb.state.value)
    held = mod.CircuitBreaker(failure_threshold=2, timeout_seconds=60.0)
    for _ in range(3):
        held.record_failure()
        states.append((held.state.value, held.is_open()))
    return [states, cb.get_stats(), held.get_stats()]


def run_rate_limit(mod, _):
    now = [0.0]
    rl = mod.RateLimiter(limit=5, window_seconds=10.0, clock=lambda: now[0])
    out = []
    for step in range(30):
        now[0] += 0.7 if step % 4 else 0.1
        key = "a" if step % 3 else "b"
        out.append((rl.allow(key), round(rl.retry_after(key), 12)))
    return out


CASES = {
    # name: (runner, jax modules, port modules, inputs, (rel, abs))
    "chunker-ascii": (lambda m, t: run_chunker(*m, "sentence", t),
                      (j_chunking, j_diagnostics), (t_chunking, t_diagnostics),
                      docs(0, 40), (0.0, 1e-12)),
    "chunker-nonascii": (lambda m, t: run_chunker(*m, "sentence", t),
                         (j_chunking, j_diagnostics), (t_chunking, t_diagnostics),
                         docs(1, 30, nonascii=True), (0.0, 1e-12)),
    "chunker-window": (lambda m, t: run_chunker(*m, "window", t),
                       (j_chunking, j_diagnostics), (t_chunking, t_diagnostics),
                       docs(2, 20), (0.0, 1e-12)),
    "diagnostics-ascii": (run_diagnostics, j_diagnostics, t_diagnostics,
                          docs(3, 40), (0.0, 1e-12)),
    "diagnostics-nonascii": (run_diagnostics, j_diagnostics, t_diagnostics,
                             docs(4, 20, nonascii=True), (0.0, 1e-12)),
    "chunker-python": (python_rule(lambda m, t: run_chunker(*m, "sentence", t)),
                       (j_chunking, j_diagnostics), (t_chunking, t_diagnostics),
                       docs(8, 30), (0.0, 1e-12)),
    "diagnostics-python": (python_rule(run_diagnostics), j_diagnostics, t_diagnostics,
                           docs(9, 30), (0.0, 1e-12)),
    "query-ops": (run_query_ops, j_query_ops, t_query_ops, None, (0.0, 0.0)),
    "enrichment": (run_enrichment, j_enrichment, t_enrichment, docs(5, 20),
                   (0.0, 0.0)),
    "evaluator": (run_evaluator, j_evaluation, t_evaluation, docs(6, 10),
                  (1e-12, 0.0)),
    "compliance": (run_compliance, j_compliance, t_compliance, docs(7, 4),
                   (0.0, 0.0)),
    "ranker": (run_ranker, j_ranker, t_ranker, None, (1e-12, 0.0)),
    "experiments": (run_experiments, j_experiments, t_experiments, None, (0.0, 0.0)),
    "batcher": (run_batcher, j_batcher, t_batcher, None, (0.0, 0.0)),
    "breaker": (run_breaker, j_breaker, t_breaker, None, (0.0, 0.0)),
    "rate-limit": (run_rate_limit, j_rate_limit, t_rate_limit, None, (1e-12, 0.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_host_copy_matches_jax(name):
    runner, jmod, tmod, inputs, (rel, abs_) = CASES[name]
    want = plain(runner(jmod, inputs))
    got = plain(runner(tmod, inputs))
    assert_same(got, want, rel=rel, abs_=abs_)


def test_chunk_ids_are_content_hashes_of_the_doc():
    """The port's chunk ids are sha256 content hashes of doc id and
    content, as the JAX package's are, so re-ingest stays idempotent."""
    text = docs(8, 1)[0]
    chunks = t_chunking.AdaptiveChunker(base_chunk_size=20, min_chunk_size=5,
                                        max_chunk_size=40).chunk_document(text, "dx")
    assert len(chunks) >= 2
    for c in chunks:
        assert c.chunk_id == j_chunking.content_hash(f"dx:{c.content}")


@pytest.mark.parametrize("max_inflight", [1, 2])
def test_batcher_dispatchers_sleep_until_work_and_serve_an_aged_queue(max_inflight):
    """The port's dispatchers wait for a submit, a finished dispatch or the
    oldest queued request's age deadline instead of polling: with a
    dispatch in flight, a partial batch behind it still goes out once its
    head is max_age_s old (two dispatchers), and an idle batcher serves
    the next submit at once."""
    import threading
    import time

    release = threading.Event()
    calls = []

    def batch_fn(queries, slow):
        calls.append(list(queries))
        if slow:
            release.wait(10.0)
        return [q.upper() for q in queries]

    mb = t_batcher.MicroBatcher(batch_fn, max_batch=4, max_inflight=max_inflight,
                                max_age_s=0.05)
    default = t_batcher.MicroBatcher(batch_fn)
    assert len(default._threads) == 1     # the port's batch is host-bound
    default.close()
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            slow = pool.submit(mb.submit, "slow", "s", slow=True)
            while not calls:
                time.sleep(0.001)
            t0 = time.monotonic()
            fast = pool.submit(mb.submit, "fast", "f", slow=False)
            if max_inflight == 2:
                assert fast.result(timeout=5.0) == "F"
                assert 0.04 <= time.monotonic() - t0 < 2.0
                assert not slow.done()
            release.set()
            assert slow.result(timeout=5.0) == "S"
            assert fast.result(timeout=5.0) == "F"
        time.sleep(0.05)
        t0 = time.monotonic()
        assert mb.submit("idle", "i", slow=False) == "I"
        assert time.monotonic() - t0 < 0.5
    finally:
        release.set()
        mb.close()
