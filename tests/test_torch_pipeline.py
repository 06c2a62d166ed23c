"""The port's AdvancedRAGPipeline against the JAX package's, with
converted weights, and the manager repairs the orchestrator needs.

Configurations, as the service starts them:

- fused (``fused_rerank``): f32 ``NeuralEmbedder`` and cross-encoder with
  the same weights (``params_from_jax``), on the f32 and int8 tiers;
- default: the ``HashingEmbedder`` with the JAX embedder's projection
  (``hashing_from_numpy``) on the bf16 tier, reranked by the host
  passthrough, and the same with a cross-encoder on the retriever (the
  host ``rerank_sync`` over ``rescore_candidates_sync``) on the f32 tier.

Bounds: ingest reports, chunk ids and quality flags equal; result chunk
ids equal where the reference scores are distinct, as sets within runs of
equal scores; scores within 1e-4 relative and 1e-6 absolute (fused: the
cross-encoder's f32 sums run in another order, as in
tests/test_torch_manager.py), 1e-6 relative (default: RRF and the
passthrough) or 1e-4 relative and 1e-5 absolute (the host rerank key:
z-scored blends of order 1, which cross zero); ``EvaluationMetrics`` within
1e-4 relative, ``latency_ms`` left out.  Both sides get the same generous
``RetrievalConfig.timeout_seconds`` (60 s), so the 300 ms degrade budget
cannot empty a slow CPU retrieve on either side.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.models.cross_encoder import CrossEncoderReranker as JReranker
from advanced_rag_tpu.models.embedder import HashingEmbedder as JHashing
from advanced_rag_tpu.models.embedder import NeuralEmbedder as JEmbedder
from advanced_rag_tpu.models.encoder import EncoderConfig as JEncoderConfig
from advanced_rag_tpu.models.tokenizer import HashingTokenizer as JTokenizer
from advanced_rag_tpu.models.tokenizer import TokenizerConfig as JTokConfig
from advanced_rag_tpu.pipeline import AdvancedRAGPipeline as JPipeline
from advanced_rag_tpu_torch.config import PipelineConfig
from advanced_rag_tpu_torch.index.corpus import ChunkRecord
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.convert import hashing_from_numpy, params_from_jax
from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
from advanced_rag_tpu_torch.models.embedder import HashingEmbedder, NeuralEmbedder
from advanced_rag_tpu_torch.models.encoder import EncoderConfig
from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline
from advanced_rag_tpu_torch.utils.exceptions import IndexingError

D = 32
GEOM = dict(vocab_size=2048, hidden_dim=32, num_layers=1, num_heads=4, mlp_dim=64,
            max_len=96)
WORDS = ("dense sparse fusion rank vector token query index shard cache filter "
         "chunk model score merge tier scan kernel batch recall latency corpus "
         "embed rerank bucket hash table slot weight drift metric").split()


def document(rng, nonascii=False):
    sents = []
    for _ in range(int(rng.integers(3, 12))):
        words = list(rng.choice(WORDS, size=int(rng.integers(4, 14))))
        if nonascii and rng.random() < 0.4:
            words.insert(2, "café")
        s = " ".join(words)
        sents.append(s[0].upper() + s[1:] + ".")
    return " ".join(sents)


def corpus():
    """24 seeded documents (every fourth with accented words), one short
    one (a quality flag), one empty one (a quality flag, not indexed)."""
    rng = np.random.default_rng(0)
    docs = [{"doc_id": f"doc{i}", "content": document(rng, nonascii=i % 4 == 3),
             "metadata": {"group": i % 3}} for i in range(24)]
    docs.append({"doc_id": "short", "content": "tiny kernel note."})
    docs.append({"doc_id": "blank", "content": "   "})
    return docs


QUERIES = ["dense sparse fusion rank", "how does the kernel scan the cache",
           "summarize recall latency drift", "token query index shard",
           "what is the hash table slot weight"]


def configs(fused, tier):
    out = []
    for cls in (JConfig, PipelineConfig):
        cfg = cls(fused_rerank=fused, semantic_dtype=tier, chunk_base_size=24,
                  chunk_max_size=48, chunk_min_size=8)
        cfg.semantic_dim = D
        cfg.retrieval.timeout_seconds = 60.0
        out.append(cfg)
    return out


def neural_models():
    """JAX and port f32 bi-encoder and cross-encoder with the same weights."""
    jcfg = JEncoderConfig(**GEOM, lexical_pool=True, dtype=jnp.float32)
    ccfg = dataclasses.replace(jcfg, lexical_pool=False, lexical_match=True)
    tcfg = EncoderConfig(**GEOM, lexical_pool=True, dtype=torch.float32)
    tccfg = dataclasses.replace(tcfg, lexical_pool=False, lexical_match=True)
    jemb = JEmbedder(dim=D, config=jcfg,
                     tokenizer=JTokenizer(JTokConfig(vocab_size=2048, max_len=32)))
    jrr = JReranker(config=ccfg, seed=3)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    temb = NeuralEmbedder(dim=D, config=tcfg,
                          state_dict=params_from_jax(to_np(jemb.params)),
                          tokenizer=HashingTokenizer(TokenizerConfig(vocab_size=2048,
                                                                     max_len=32)),
                          device="cpu")
    trr = CrossEncoderReranker(config=tccfg,
                               state_dict=params_from_jax(to_np(jrr.params)),
                               device="cpu")
    return jemb, jrr, temb, trr


def build(kind, ingest=True):
    """(jax pipeline, port pipeline, ingest reports or None) for one of the
    configurations named in the module docstring."""
    if kind in ("fused-f32", "fused-int8"):
        jcfg, tcfg = configs(True, "float32" if kind == "fused-f32" else "int8")
        jemb, jrr, temb, trr = neural_models()
        jpipe = JPipeline(jcfg, index_manager=JManager(jcfg, embedder=jemb))
        tpipe = AdvancedRAGPipeline(
            tcfg, index_manager=MultiIndexManager(tcfg, embedder=temb, device="cpu"))
        jpipe.retriever.reranker, tpipe.retriever.reranker = jrr, trr
        assert jpipe._use_fused_path() and tpipe._use_fused_path()
    elif kind == "default-bf16":
        jcfg, tcfg = configs(False, "bfloat16")
        jpipe = JPipeline(jcfg)
        assert isinstance(jpipe.index_manager.embedder, JHashing)
        temb = hashing_from_numpy(np.asarray(jpipe.index_manager.embedder._proj),
                                  device="cpu")
        tpipe = AdvancedRAGPipeline(
            tcfg, index_manager=MultiIndexManager(tcfg, embedder=temb, device="cpu"))
    else:                               # "default-ce": host rerank_sync
        jcfg, tcfg = configs(False, "float32")
        jemb, jrr, temb, trr = neural_models()
        jpipe = JPipeline(jcfg, index_manager=JManager(jcfg, embedder=jemb))
        tpipe = AdvancedRAGPipeline(
            tcfg, index_manager=MultiIndexManager(tcfg, embedder=temb, device="cpu"))
        jpipe.retriever.reranker, tpipe.retriever.reranker = jrr, trr
        assert not jpipe._use_fused_path() and not tpipe._use_fused_path()
    if not ingest:
        return jpipe, tpipe, None
    docs = corpus()
    return jpipe, tpipe, (jpipe.ingest_documents(docs, source="t", user="u"),
                          tpipe.ingest_documents(docs, source="t", user="u"))


KINDS = ["fused-f32", "fused-int8", "default-bf16", "default-ce"]


@pytest.fixture(scope="module", params=KINDS)
def pipelines(request):
    jpipe, tpipe, reports = build(request.param)
    yield request.param, jpipe, tpipe, reports
    jpipe.close()
    tpipe.close()


def test_ingest_matches_jax(pipelines):
    kind, jpipe, tpipe, (jrep, trep) = pipelines
    for key in ("total", "indexed", "errors", "rows", "documents", "quality_flags"):
        assert trep[key] == jrep[key], key
    assert trep["indexed"] > 30            # several chunks per document
    assert {"doc_id": "blank", "flag": "empty_document"} in trep["quality_flags"]
    jstore, tstore = jpipe.index_manager.store, tpipe.index_manager.store
    rows = range(jstore.size)
    assert [tstore.hit(r, 0.0)["chunk_id"] for r in rows] == \
        [jstore.hit(r, 0.0)["chunk_id"] for r in rows]
    for r in rows:
        jh, th = jstore.hit(r, 0.0), tstore.hit(r, 0.0)
        for key in ("doc_id", "content", "chunk_index", "token_count"):
            assert th[key] == jh[key], key
        for key in ("entropy", "redundancy", "domain_density"):
            assert th[key] == pytest.approx(jh[key], abs=1e-6), key
    assert [v.content_hash for v in tpipe.compliance.get_versions("doc3")] == \
        [v.content_hash for v in jpipe.compliance.get_versions("doc3")]


def ranked(out):
    ids = [r.chunk_id for r in out["results"]]
    return ids, np.asarray([r.score for r in out["results"]], np.float64)


#: (rtol, atol) of the result scores, by configuration (module docstring)
SCORE_TOL = {"fused-f32": (1e-4, 1e-6), "fused-int8": (1e-4, 1e-6),
             "default-bf16": (1e-6, 0.0), "default-ce": (1e-4, 1e-5)}


def assert_same_ranking(got, want, rtol, atol):
    (g_ids, g_s), (w_ids, w_s) = got, want
    assert len(g_ids) == len(w_ids)
    np.testing.assert_allclose(g_s, w_s, rtol=rtol, atol=atol)
    start = 0
    while start < len(w_ids):              # runs of equal reference scores
        end = start + 1
        while end < len(w_ids) and (abs(w_s[end] - w_s[end - 1])
                                    <= rtol * abs(w_s[end]) + atol):
            end += 1
        assert set(g_ids[start:end]) == set(w_ids[start:end]), (g_ids, w_ids)
        start = end


@pytest.mark.parametrize("call", [dict(), dict(top_k=7),
                                  dict(filters={"chunk_index": {"in": [0, 1]}})])
def test_retrieve_matches_jax(pipelines, call):
    kind, jpipe, tpipe, _ = pipelines
    for q in QUERIES[:3]:
        want = jpipe.retrieve(q, relevant_ids=["doc1", "doc2"], **call)
        got = tpipe.retrieve(q, relevant_ids=["doc1", "doc2"], **call)
        assert got["degraded"] is None and want["degraded"] is None
        assert got["results"], q
        assert got["rewritten_query"] == want["rewritten_query"]
        assert_same_ranking(ranked(got), ranked(want), *SCORE_TOL[kind])
        for a, b in zip(got["results"], want["results"]):
            assert a.metadata["method"] == b.metadata["method"]
        gm, wm = dataclasses.asdict(got["metrics"]), dataclasses.asdict(want["metrics"])
        assert gm.pop("latency_ms") >= 0 and wm.pop("latency_ms") >= 0
        assert gm == pytest.approx(wm, rel=1e-4, abs=1e-6)
        if "filters" in call:
            assert all(r.metadata["chunk_index"] in (0, 1) for r in got["results"])


def test_plan_forget_and_report_match_jax(pipelines):
    kind, jpipe, tpipe, _ = pipelines
    q = "dense sparse fusion and how does the kernel scan the cache"
    jp, tp = jpipe.plan_and_execute(q, top_k=6), tpipe.plan_and_execute(q, top_k=6)
    assert tp["sub_queries"] == jp["sub_queries"] and tp["is_complex"] == jp["is_complex"]
    assert [r.chunk_id for r in tp["results"]] == [r.chunk_id for r in jp["results"]]
    jr, tr = jpipe.get_performance_report(), tpipe.get_performance_report()
    assert set(tr) == set(jr)
    assert set(tr["stages_ms"]) == set(jr["stages_ms"])
    assert tr["index"]["store"] == jr["index"]["store"]
    assert tpipe.forget_document("doc5") == jpipe.forget_document("doc5") > 0
    assert all(r.doc_id != "doc5" for r in tpipe.retrieve(QUERIES[0])["results"])
    assert tpipe.compliance.forgotten == jpipe.compliance.forgotten


def test_retrieve_in_a_worker_thread_builds_no_autograd_graph():
    """The service calls the pipeline from executor threads, where grad
    mode is on: no model forward may record a graph there, and nothing the
    pipeline keeps may require grad."""
    jemb, jrr, temb, trr = neural_models()
    outs = []
    for fused in (True, False):
        cfg = configs(fused, "float32")[1]
        pipe = AdvancedRAGPipeline(
            cfg, index_manager=MultiIndexManager(cfg, embedder=temb, device="cpu"))
        pipe.retriever.reranker = trr
        hooks = [m.register_forward_hook(
            lambda mod, args, out: outs.append(bool(out.requires_grad)))
            for model in (temb.model, trr.model) for m in model.modules()]
        try:
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                assert torch.is_grad_enabled()
                assert pool.submit(torch.is_grad_enabled).result()
                pool.submit(pipe.ingest_documents, corpus()[:6]).result()
                res = pool.submit(pipe.retrieve, QUERIES[1]).result()
        finally:
            for h in hooks:
                h.remove()
        assert res["results"] and outs
        mgr = pipe.index_manager
        held = [v for obj in (mgr, mgr.semantic, mgr.sparse, mgr.store,
                              mgr.token_table) if obj is not None
                for v in vars(obj).values() if isinstance(v, torch.Tensor)]
        held += list(mgr._dev_scalars.values())
        assert held and not any(t.requires_grad for t in held)
        pipe.close()
    assert not any(outs), "a model forward recorded an autograd graph"
    for p in list(temb.model.parameters()) + list(trr.model.parameters()):
        assert p.grad is None


# -- the manager repairs the orchestrator needs ------------------------------


def test_hybrid_search_takes_domain_weight_unused_while_domain_is_off():
    mgr = MultiIndexManager(PipelineConfig(), device="cpu")
    mgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id="d", content=t)
                      for i, t in enumerate(["dense kernel scan", "sparse bm25 terms",
                                             "fusion of ranks"])])
    a = mgr.hybrid_search_batch_sync(["kernel scan"], 3, domain_weight=0.2)
    b = mgr.hybrid_search_batch_sync(["kernel scan"], 3, domain_weight=0.9)
    assert a and [h["chunk_id"] for h in a[0]] == [h["chunk_id"] for h in b[0]]
    assert [h["score"] for h in a[0]] == [h["score"] for h in b[0]]


def test_unfused_default_manager_is_the_hashing_embedder_and_matches_jax():
    """No embedder and no fused_rerank: the hashing projection, as in the
    JAX manager; with the JAX projection carried over, the same hybrid
    results (bf16 tier)."""
    jmgr = JManager(JConfig())
    tmgr = MultiIndexManager(PipelineConfig(), device="cpu")
    assert isinstance(tmgr.embedder, HashingEmbedder)
    assert tmgr.embedder.dim == jmgr.embedder.dim == PipelineConfig().semantic_dim
    tmgr = MultiIndexManager(
        PipelineConfig(), embedder=hashing_from_numpy(np.asarray(jmgr.embedder._proj),
                                                      device="cpu"), device="cpu")
    rng = np.random.default_rng(4)
    texts = [document(rng) for _ in range(40)]
    from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
    jmgr.index_chunks([JRecord(chunk_id=f"c{i}", doc_id=f"d{i}", content=t)
                       for i, t in enumerate(texts)])
    tmgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i}", content=t)
                       for i, t in enumerate(texts)])
    want = jmgr.hybrid_search_batch_sync(QUERIES, 8)
    got = tmgr.hybrid_search_batch_sync(QUERIES, 8)
    assert [[h["chunk_id"] for h in hits] for hits in got] == \
        [[h["chunk_id"] for h in hits] for hits in want]


def test_hashing_embedder_takes_the_jax_projection():
    """``HashingEmbedder(proj=...)`` and ``hashing_from_numpy`` embed as the
    JAX embedder with that projection does (f32, within 1e-6)."""
    jemb = JHashing(dim=48, vocab_size=512, seed=5)
    proj = np.asarray(jemb._proj)
    temb = hashing_from_numpy(proj, device="cpu")
    assert (temb.dim, temb.vocab_size) == (48, 512)
    texts = ["dense sparse fusion", "kernel scan of the cache", "", "café naïve"]
    np.testing.assert_allclose(temb.encode(texts), jemb.encode(texts), atol=1e-6)
    again = HashingEmbedder(dim=48, vocab_size=512, proj=proj, device="cpu")
    np.testing.assert_array_equal(again.encode(texts), temb.encode(texts))
    assert again.cache_tag != HashingEmbedder(dim=48, vocab_size=512, seed=5,
                                              device="cpu").cache_tag
    with pytest.raises(ValueError):
        HashingEmbedder(dim=48, vocab_size=256, proj=proj, device="cpu")


@pytest.mark.parametrize("tier", ["float32", "int8", "bfloat16"])
def test_rescore_candidates_matches_jax(tier):
    jemb, _, temb, _ = neural_models()
    jcfg, tcfg = configs(False, tier)
    jmgr = JManager(jcfg, embedder=jemb)
    tmgr = MultiIndexManager(tcfg, embedder=temb, device="cpu")
    rng = np.random.default_rng(6)
    texts = [document(rng) for _ in range(30)]
    from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
    jmgr.index_chunks([JRecord(chunk_id=f"c{i}", doc_id=f"d{i}", content=t)
                       for i, t in enumerate(texts)])
    tmgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i}", content=t)
                       for i, t in enumerate(texts)])
    rows = rng.integers(0, 30, size=(3, 7)).astype(np.int32)
    rows[1, 5:] = -1
    jd, js = jmgr.rescore_candidates_sync(QUERIES[:3], rows)
    td, ts = tmgr.rescore_candidates_sync(QUERIES[:3], rows)
    assert td.shape == ts.shape == (3, 7) and td.dtype == np.float32
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    assert (ts[1, 5:] == 0).all() and (td[1, 5:] == 0).all()


def test_rescore_candidates_raises_on_a_pq_tier_as_jax_does():
    mgr = MultiIndexManager(PipelineConfig(semantic_dtype="pq"), device="cpu")
    with pytest.raises(IndexingError, match="full-precision"):
        mgr.rescore_candidates_sync(["q"], np.zeros((1, 2), np.int32))
    jmgr = JManager(JConfig(semantic_dtype="pq"))
    with pytest.raises(Exception, match="full-precision"):
        jmgr.rescore_candidates_sync(["q"], np.zeros((1, 2), np.int32))


@pytest.mark.parametrize("error", [IndexingError, RuntimeError])
def test_rerank_key_falls_back_to_the_fused_score_on_the_pq_refusal_only(error):
    """The host rerank key takes the fused retrieval score as its base
    only where the manager refuses to rescore (a PQ tier's IndexingError);
    any other failure of the rescore reaches the caller."""
    from advanced_rag_tpu_torch.pipeline import HybridRetriever

    mgr = MultiIndexManager(PipelineConfig(), device="cpu")
    retriever = HybridRetriever(mgr, device="cpu")

    def refuse(queries, rows):
        raise error("no rescore")

    mgr.rescore_candidates_sync = refuse
    results = [{"row": 0, "score": 3.0}, {"row": 1, "score": 1.0}]
    ce = np.array([0.0, 1.0])
    if error is IndexingError:
        key = retriever._combine_rerank_key("q", results, ce)
        np.testing.assert_allclose(key, np.array([1.0, -1.0]) + 0.5 * ce)
    else:
        with pytest.raises(RuntimeError, match="no rescore"):
            retriever._combine_rerank_key("q", results, ce)


def test_config_names_the_ported_pq_tier():
    """The semantic_dtype comment of the port's config says where the PQ
    tier lives, not that it is missing."""
    import inspect

    import advanced_rag_tpu_torch.config as cfg

    src = inspect.getsource(cfg)
    assert "product-quantized tier, ops/pq.py" in src
    assert "not ported yet" not in src
