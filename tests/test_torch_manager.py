"""The port's MultiIndexManager against the JAX package's on the same chunks
and converted weights, built as tests/test_fused_manager.py builds it.

Both managers ingest the same chunks through ``index_chunks`` and serve
the same queries through ``fused_retrieve_batch_sync`` with the repo's
serving knobs, with and without a filter.  Bounds: with f32 encoders the
f32 tier's fused top-k ids are equal, and so are the SQ8 tier's (the
codes are the same; scores differ in the last bits only).  The bf16 tier
runs bf16 encoders, whose activations round at other places in the two
frameworks (tests/test_torch_encoder.py), so its top-k ids must overlap
by at least 0.8 on average.
"""

import dataclasses

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.models.cross_encoder import CrossEncoderReranker as JReranker
from advanced_rag_tpu.models.embedder import NeuralEmbedder as JEmbedder
from advanced_rag_tpu.models.encoder import EncoderConfig as JEncoderConfig
from advanced_rag_tpu.models.tokenizer import HashingTokenizer as JTokenizer
from advanced_rag_tpu.models.tokenizer import TokenizerConfig as JTokConfig
from advanced_rag_tpu_torch.config import PipelineConfig
from advanced_rag_tpu_torch.index.corpus import ChunkRecord
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.convert import params_from_jax
from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
from advanced_rag_tpu_torch.models.encoder import EncoderConfig
from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from advanced_rag_tpu_torch.utils.exceptions import IndexingError

GEOM = dict(vocab_size=2048, hidden_dim=32, num_layers=1, num_heads=4, mlp_dim=64,
            max_len=96)
KNOBS = dict(k_final=5, k_rerank=16, rerank_alpha=0.5, rerank_mode="residual",
             rerank_base="exact", rescore_mix=0.65)
WORDS = ("dense sparse fusion rank vector token query index shard cache filter "
         "chunk model score merge tier scan kernel batch recall latency corpus "
         "embed rerank bucket hash table slot weight drift metric").split()


def texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(6, 16))))
            for _ in range(n)]


def models_and_managers(tier):
    """Empty JAX and port managers of ``tier`` with the same converted
    weights, and their rerankers: (jmgr, jrr, tmgr, trr)."""
    enc_f32 = tier != "bfloat16"
    jcfg = JEncoderConfig(**GEOM, lexical_pool=True,
                          **({"dtype": jnp.float32} if enc_f32 else {}))
    ccfg = dataclasses.replace(jcfg, lexical_pool=False, lexical_match=True)
    tcfg = EncoderConfig(**GEOM, lexical_pool=True,
                         **({"dtype": torch.float32} if enc_f32 else {}))
    tccfg = dataclasses.replace(tcfg, lexical_pool=False, lexical_match=True)

    jemb = JEmbedder(dim=32, config=jcfg,
                     tokenizer=JTokenizer(JTokConfig(vocab_size=2048, max_len=32)))
    jrr = JReranker(config=ccfg, seed=3)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    temb = NeuralEmbedder(dim=32, config=tcfg,
                          state_dict=params_from_jax(to_np(jemb.params)),
                          tokenizer=HashingTokenizer(TokenizerConfig(vocab_size=2048,
                                                                     max_len=32)),
                          device="cpu")
    trr = CrossEncoderReranker(config=tccfg, state_dict=params_from_jax(to_np(jrr.params)),
                               device="cpu")

    jc = JConfig(fused_rerank=True, semantic_dtype=tier)
    jc.semantic_dim = 32
    tc = PipelineConfig(fused_rerank=True, semantic_dtype=tier)
    tc.semantic_dim = 32
    return (JManager(jc, embedder=jemb), jrr,
            MultiIndexManager(tc, embedder=temb, device="cpu"), trr)


def build(tier):
    jmgr, jrr, tmgr, trr = models_and_managers(tier)
    docs = texts(96, 0)
    for lo in (0, 60):                 # two ingest batches, one growth-free
        jrep = jmgr.index_chunks([JRecord(chunk_id=f"c{i}", doc_id=f"d{i // 3}",
                                          content=t, chunk_index=i % 3)
                                  for i, t in enumerate(docs[lo:lo + 60], lo)])
        trep = tmgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i // 3}",
                                              content=t, chunk_index=i % 3)
                                  for i, t in enumerate(docs[lo:lo + 60], lo)])
        assert trep["indexed"] == jrep["indexed"]
        assert trep["rows"] == jrep["rows"]
    return jmgr, jrr, tmgr, trr


@pytest.fixture(scope="module", params=["float32", "int8", "bfloat16"])
def managers(request):
    return request.param, build(request.param)


def served(mgr, rr, queries, **kw):
    out = mgr.fused_retrieve_batch_sync(queries, reranker=rr, **KNOBS, **kw)
    return [[h["chunk_id"] for h in hits] for hits in out], out


@pytest.mark.parametrize("filters", [None, {"chunk_index": {"in": [0, 2]}},
                                     {"doc_id": {"ne": "d4"}}])
def test_fused_retrieve_matches_jax_manager(managers, filters):
    tier, (jmgr, jrr, tmgr, trr) = managers
    queries = texts(6, 1) + ["dense sparse fusion"]
    want, jout = served(jmgr, jrr, queries, filters=filters)
    got, tout = served(tmgr, trr, queries, filters=filters)
    if tier == "bfloat16":
        overlap = np.mean([len(set(a) & set(b)) / max(len(b), 1)
                           for a, b in zip(got, want)])
        assert overlap >= 0.8, (got, want)
    else:
        assert got == want
        for th, jh in zip(tout, jout):
            for a, b in zip(th, jh):
                assert a["rerank_score"] == pytest.approx(b["rerank_score"],
                                                          rel=1e-4, abs=1e-5)
                assert set(a) == set(b)
    if filters and "chunk_index" in filters:
        assert all(h["chunk_index"] in (0, 2) for hits in tout for h in hits)


def test_stats_and_delete_match_jax(managers):
    tier, (jmgr, jrr, tmgr, trr) = managers
    js, ts = jmgr.get_collection_stats(), tmgr.get_collection_stats()
    assert ts["store"] == js["store"]
    assert ts["semantic"]["rows"] == js["semantic"]["rows"]
    assert ts["sparse"]["rows"] == js["sparse"]["rows"]
    flt = {"doc_id": {"in": ["d1", "d2"]}}
    assert tmgr.delete_by_filter(flt) == jmgr.delete_by_filter(flt) == 6
    assert tmgr.get_collection_stats()["store"] == jmgr.get_collection_stats()["store"]
    got, _ = served(tmgr, trr, ["dense sparse fusion rank"])
    assert not {f"c{i}" for i in range(3, 9)} & set(got[0])


def test_fused_retrieve_serves_the_reranker_it_is_given(managers):
    """Two rerankers of different weights, one after the other, the first
    dropped before the second exists: the second one's weights rerank, and
    the manager keeps no hold on the first one's model."""
    import gc
    import weakref

    tier, (jmgr, _, tmgr, trr) = managers
    query = ["dense sparse fusion rank"]
    jrr = JReranker(config=dataclasses.replace(
        jmgr.embedder.config, lexical_pool=False, lexical_match=True), seed=5)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jrr.params))
    first = CrossEncoderReranker(config=trr.model.config, seed=11, device="cpu")
    before = [h["rerank_score"] for h in tmgr.fused_retrieve_batch_sync(
        query, reranker=first, **KNOBS)[0]]
    first_model = weakref.ref(first.model)
    del first
    gc.collect()
    assert first_model() is None
    second = CrossEncoderReranker(config=trr.model.config, state_dict=state,
                                  device="cpu")
    got, tout = served(tmgr, second, query)
    want, jout = served(jmgr, jrr, query)
    after = [h["rerank_score"] for h in tout[0]]
    assert before != after
    if tier != "bfloat16":
        assert got == want
        assert after == pytest.approx([h["rerank_score"] for h in jout[0]],
                                      rel=1e-4, abs=1e-5)


def test_fused_retrieve_guards():
    tc = PipelineConfig(fused_rerank=False)
    tc.semantic_dim = 32
    emb = NeuralEmbedder(dim=32, config=EncoderConfig(**GEOM), device="cpu")
    mgr = MultiIndexManager(tc, embedder=emb, device="cpu")
    with pytest.raises(IndexingError):
        mgr.fused_retrieve_batch_sync(["q"])
    mgr = MultiIndexManager(PipelineConfig(fused_rerank=True), embedder=emb, device="cpu")
    assert mgr.fused_retrieve_batch_sync([]) == []
    assert mgr.fused_retrieve_batch_sync(["q"]) == [[]]     # empty corpus
    mgr.close()
    with pytest.raises(IndexingError):
        mgr.fused_retrieve_batch_sync(["q"])
    # IVF and PQ corpora are served by hybrid_search_batch_sync, as in JAX
    pq_cfg = PipelineConfig(fused_rerank=True, semantic_dtype="pq")
    pq_cfg.semantic_dim = 32
    pq_mgr = MultiIndexManager(pq_cfg, embedder=emb, device="cpu")
    pq_mgr.index_chunks([ChunkRecord(chunk_id="c0", doc_id="d0", content="a b c")])
    with pytest.raises(IndexingError, match="hybrid_search_batch_sync"):
        pq_mgr.fused_retrieve_batch_sync(["q"])


def test_dense_only_manager_matches_jax(monkeypatch):
    """enable_sparse=False: the fused path runs with the dense family alone.

    The JAX manager builds its program without ``enable_sparse`` and runs
    BM25 over empty placeholder arrays, which ranks the lowest live rows
    (all scoring 0) into RRF at weight 0.3 (ROADMAP.md § D).  The port
    leaves the sparse family out, which is what the JAX program computes
    with ``enable_sparse=False``; the reference is built that way here."""
    import functools

    from advanced_rag_tpu.ops import e2e as je2e

    monkeypatch.setattr(je2e, "make_retrieve_rerank", functools.partial(
        je2e.make_retrieve_rerank, enable_sparse=False))
    jcfg = JEncoderConfig(**GEOM, lexical_pool=True, dtype=jnp.float32)
    tcfg = EncoderConfig(**GEOM, lexical_pool=True, dtype=torch.float32)
    jemb = JEmbedder(dim=32, config=jcfg,
                     tokenizer=JTokenizer(JTokConfig(vocab_size=2048, max_len=32)))
    jrr = JReranker(config=dataclasses.replace(jcfg, lexical_match=True), seed=3)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    temb = NeuralEmbedder(dim=32, config=tcfg, state_dict=params_from_jax(to_np(jemb.params)),
                          tokenizer=HashingTokenizer(TokenizerConfig(vocab_size=2048,
                                                                     max_len=32)),
                          device="cpu")
    trr = CrossEncoderReranker(config=dataclasses.replace(tcfg, lexical_match=True),
                               state_dict=params_from_jax(to_np(jrr.params)), device="cpu")
    jc = JConfig(fused_rerank=True, semantic_dtype="float32")
    jc.semantic_dim = 32
    tc = PipelineConfig(fused_rerank=True, semantic_dtype="float32")
    tc.semantic_dim = 32
    jmgr = JManager(jc, embedder=jemb, enable_sparse=False)
    tmgr = MultiIndexManager(tc, embedder=temb, enable_sparse=False, device="cpu")
    docs = texts(40, 3)
    jmgr.index_chunks([JRecord(chunk_id=f"c{i}", doc_id=f"d{i}", content=t)
                       for i, t in enumerate(docs)])
    tmgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i}", content=t)
                       for i, t in enumerate(docs)])
    queries = texts(4, 4)
    assert served(tmgr, trr, queries)[0] == served(jmgr, jrr, queries)[0]


def test_fused_retrieve_tf_above_256_matches_jax():
    """BM25 term frequencies are bf16 on the device in both packages, so a
    chunk's tf of 257 is served as 256 by the fused path's BM25 rung and
    its exact rescore alike (tests/test_torch_sparse.py holds search_texts).
    At these lengths the two chunks' order on "alpha" turns on that
    rounding: tf 257 kept in f32 would put c1 first."""
    jmgr, jrr, tmgr, trr = models_and_managers("float32")
    docs = ["alpha " * 300 + "zeta " * 18, "alpha " * 257 + "delta"]
    jmgr.index_chunks([JRecord(chunk_id=f"c{i}", doc_id=f"d{i}", content=t)
                       for i, t in enumerate(docs)])
    tmgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i}", content=t)
                       for i, t in enumerate(docs)])
    queries = ["alpha", "alpha delta", "delta"]
    want, jout = served(jmgr, jrr, queries)
    got, tout = served(tmgr, trr, queries)
    assert got == want
    assert got[0] == ["c0", "c1"]
    for th, jh in zip(tout, jout):
        for a, b in zip(th, jh):
            for key in ("score", "rerank_score"):
                assert a[key] == pytest.approx(b[key], rel=1e-5), key
