"""The port's non-fused search path against the JAX package's on the CPU:
``DenseIndex.search`` on the IVF, SQ8-IVF and PQ tiers, and the manager's
``search_sync``, ``hybrid_search_batch_sync`` and (with postings built)
``fused_retrieve_batch_sync``.

Index state is carried over (built in JAX, converted by
``models/convert.py``), so k-means drift between the frameworks cannot
change the partitions or codes; rows appended after the build go through
each package's own append.  The managers embed with f32 encoders of
converted weights, as tests/test_torch_manager.py builds them.

Tolerances: f32 scores within rtol 1e-5 / atol 1e-6.  The IVF-SQ8 tail
scan rounds its scale product in another order than the JAX XLA scan (a
1-ulp difference, ROADMAP.md § D), and the quantized tiers' final scores
are the exact re-scores from the f32 host mirror in both.  Ids are equal
where the reference scores are distinct and equal as sets within ties;
hybrid results (RRF ranks, no scores of their own to tie on) are equal
lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.config import IndexConfig as JIndexConfig
from advanced_rag_tpu.config import IndexType as JIndexType
from advanced_rag_tpu.config import Metric as JMetric
from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
from advanced_rag_tpu.index.dense_index import DenseIndex as JDense
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.index.sparse_index import SparseIndex as JSparse
from advanced_rag_tpu.models.embedder import NeuralEmbedder as JEmbedder
from advanced_rag_tpu.models.encoder import EncoderConfig as JEncoderConfig
from advanced_rag_tpu.models.tokenizer import HashingTokenizer as JTokenizer
from advanced_rag_tpu.models.tokenizer import TokenizerConfig as JTokConfig
from advanced_rag_tpu_torch.config import IndexConfig, IndexType, Metric, PipelineConfig
from advanced_rag_tpu_torch.index.corpus import ChunkRecord
from advanced_rag_tpu_torch.index.dense_index import DenseIndex
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.index.sparse_index import SparseIndex
from advanced_rag_tpu_torch.models.convert import (ivf_partitions_from_numpy,
                                                   params_from_jax, pq_from_numpy)
from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
from advanced_rag_tpu_torch.models.encoder import EncoderConfig
from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from advanced_rag_tpu_torch.ops import postings as tpost_mod
from advanced_rag_tpu_torch.utils.exceptions import IndexingError

from test_torch_ivf import clustered
from test_torch_manager import GEOM, KNOBS, build, texts
from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np

D = 32


def indexes(dtype, **kw):
    jcfg = JIndexConfig(index_type=JIndexType.SEMANTIC, dim=D, metric=JMetric.COSINE,
                        dtype=dtype, **kw)
    tcfg = IndexConfig(index_type=IndexType.SEMANTIC, dim=D, metric=Metric.COSINE,
                       dtype=dtype, **kw)
    return JDense(jcfg), DenseIndex(tcfg, device="cpu")


def carry_ivf(jidx, tidx):
    tidx._ivf = ivf_partitions_from_numpy(jidx._ivf, device="cpu")
    tidx._ivf_size = jidx._ivf_size


def carry_pq(jidx, tidx):
    tidx._pq, tidx.emb = pq_from_numpy(jidx._pq.codebooks, np.asarray(jidx.emb),
                                       m=jidx._pq.m, bits=jidx._pq.bits,
                                       device="cpu")


@pytest.fixture(scope="module")
def vectors():
    rng = np.random.default_rng(3)
    x = clustered(rng, n=1800, d=D)
    q = x[[1, 50, 900, 1700, 1799]] + rng.standard_normal((5, D)).astype(np.float32) * 0.1
    return x, q.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dense_index_ivf_search_matches_jax(vectors, dtype):
    """IVF (f32, bf16) and SQ8-IVF, with 300 rows appended after the build
    (the exact-scan tail) and with and without a row mask."""
    x, q = vectors
    jidx, tidx = indexes(dtype, nprobe=8)
    for idx in (jidx, tidx):
        assert idx.bulk_load(x[:1500]) == 0
    jidx.build_ivf(nlist=24)
    carry_ivf(jidx, tidx)
    jidx.append(1500, x[1500:])
    tidx.append(1500, x[1500:])
    assert tidx.has_ivf and tidx.ivf_tail_rows == jidx.ivf_tail_rows == 300
    assert tidx.ivf_needs_rebuild == jidx.ivf_needs_rebuild
    mask = np.zeros(tidx.capacity, bool)
    mask[::3] = True
    mask[1500::2] = True
    for m in (None, mask):
        js, ji = jidx.search(q, 12, None if m is None else m)
        ts, ti = tidx.search(q, 12, None if m is None else torch.from_numpy(m))
        assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
        assert_ids_tie_aware(ti, ji, js, 1e-6)
        assert (to_np(ti) >= 1500).any()          # the tail is searched
    assert tidx.memory_bytes() == jidx.memory_bytes()


def test_dense_index_pq_search_matches_jax(vectors):
    x, q = vectors
    jidx, tidx = indexes("pq", pq_m=8, pq_bits=4)
    for idx in (jidx, tidx):
        idx.bulk_load(x[:1600])
    jidx.build_pq()
    carry_pq(jidx, tidx)
    # appends after the build are encoded by each package
    jidx.append(1600, x[1600:])
    tidx.append(1600, x[1600:])
    np.testing.assert_array_equal(to_np(tidx.emb)[:1800], np.asarray(jidx.emb)[:1800])
    assert tidx.has_pq and not tidx.has_ivf
    js, ji = jidx.search(q, 10)
    ts, ti = tidx.search(q, 10)
    assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)
    # the refine default: raw codes over-retrieve 32 x k
    d_s, d_i = tidx._search_device(torch.from_numpy(q / np.linalg.norm(
        q, axis=1, keepdims=True)), 320, tidx._bound())
    assert (to_np(d_i) < 1800).all()
    assert tidx.memory_bytes() == jidx.memory_bytes()
    # build_ivf on a PQ index builds IVF-PQ in both packages
    for idx in (jidx, tidx):
        idx.build_ivf(nlist=16)
        assert idx.has_ivfpq and idx.has_pq
    assert tuple(tidx._ivfpq.packed_codes.shape) == jidx._ivfpq.packed_codes.shape
    assert tidx.memory_bytes() == jidx.memory_bytes()


def test_dense_index_tier_builds_run_on_the_port(vectors):
    """The port's own builds: partitions, tune_nprobe, PQ training."""
    x, q = vectors
    _, tidx = indexes("float32")
    tidx.bulk_load(x)
    tidx.build_ivf(nlist=16)
    npb, rec = tidx.tune_nprobe(0.9, k=10, queries=q)
    assert tidx.config.nprobe == npb and rec >= 0.9
    _, pidx = indexes("pq", pq_m=8)
    pidx.bulk_load(x)
    pidx.build_pq()
    assert pidx.emb.shape == (pidx.capacity, 8) and pidx.emb.dtype == torch.int8
    _, ids = pidx.search(q, 5)
    assert (to_np(ids)[:, 0] >= 0).all()


# -- the managers ------------------------------------------------------------------

@pytest.fixture
def low_threshold(monkeypatch):
    monkeypatch.setattr(JSparse, "POSTINGS_AUTO_THRESHOLD", 64)
    monkeypatch.setattr(SparseIndex, "POSTINGS_AUTO_THRESHOLD", 64)


def unfused_managers(tier):
    """JAX and port managers with f32 encoders of the same weights over the
    same 140 chunks (fused_rerank off)."""
    jemb = JEmbedder(dim=D, config=JEncoderConfig(**GEOM, lexical_pool=True,
                                                  dtype=jnp.float32),
                     tokenizer=JTokenizer(JTokConfig(vocab_size=2048, max_len=32)))
    temb = NeuralEmbedder(
        dim=D, config=EncoderConfig(**GEOM, lexical_pool=True, dtype=torch.float32),
        state_dict=params_from_jax(jax.tree_util.tree_map(np.asarray, jemb.params)),
        tokenizer=HashingTokenizer(TokenizerConfig(vocab_size=2048, max_len=32)),
        device="cpu")
    jc = JConfig(semantic_dtype=tier)
    jc.semantic_dim = D
    tc = PipelineConfig(semantic_dtype=tier)
    tc.semantic_dim = D
    jmgr = JManager(jc, embedder=jemb)
    tmgr = MultiIndexManager(tc, embedder=temb, device="cpu")
    ingest(jmgr, tmgr, texts(180, 5), 0, 140)
    return jmgr, tmgr


def ingest(jmgr, tmgr, docs, lo, hi):
    jrep = jmgr.index_chunks([JRecord(chunk_id=f"c{i}", doc_id=f"d{i // 2}",
                                      content=docs[i], chunk_index=i % 2)
                              for i in range(lo, hi)])
    trep = tmgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i // 2}",
                                          content=docs[i], chunk_index=i % 2)
                              for i in range(lo, hi)])
    assert trep["rows"] == jrep["rows"]


def chunk_ids(results):
    return [[h["chunk_id"] for h in hits] for hits in results]


QUERIES = texts(5, 6) + ["dense sparse fusion rank"]


@pytest.mark.parametrize("tier", ["float32", "int8", "pq"])
def test_manager_search_paths_match_jax(tier, low_threshold):
    """build_semantic, then 40 more chunks; search_sync(SEMANTIC/SPARSE) and
    hybrid_search_batch_sync (3 queries: a padded batch bucket) with and
    without a filter.  The corpus is above the lowered postings threshold,
    so the hybrid sparse rung is the inverted postings in both."""
    jmgr, tmgr = unfused_managers(tier)
    if tier == "pq":
        jmgr.build_semantic(pq=True)
        assert tmgr.build_semantic(pq=True) == {"pq_built": True}
        carry_pq(jmgr.semantic, tmgr.semantic)
    else:
        jmgr.build_semantic(ivf=True)
        assert tmgr.build_semantic(ivf=True) == {"ivf_built": True}
        carry_ivf(jmgr.semantic, tmgr.semantic)
    ingest(jmgr, tmgr, texts(180, 5), 140, 180)
    js, ts = jmgr.get_collection_stats(), tmgr.get_collection_stats()
    assert ts["semantic"] == js["semantic"]

    for filters in (None, {"chunk_index": {"in": [1]}}):
        for q in QUERIES[:3]:
            for kind in (IndexType.SEMANTIC, IndexType.SPARSE):
                want = jmgr.search_sync(JIndexType(kind.value), q, 7, filters)
                got = tmgr.search_sync(kind, q, 7, filters)
                w_s = np.asarray([[h["score"] for h in want]])
                assert_scores_close(np.asarray([[h["score"] for h in got]]), w_s,
                                    rtol=1e-5, atol=1e-6)
                assert_ids_tie_aware(
                    np.asarray([[int(h["chunk_id"][1:]) for h in got]]),
                    np.asarray([[int(h["chunk_id"][1:]) for h in want]]), w_s, 1e-6)
        want = jmgr.hybrid_search_batch_sync(QUERIES[:3], 6, filters)
        got = tmgr.hybrid_search_batch_sync(QUERIES[:3], 6, filters)
        assert chunk_ids(got) == chunk_ids(want)
        for gh, wh in zip(got, want):
            for a, b in zip(gh, wh):
                assert a["score"] == pytest.approx(b["score"], rel=1e-6)
                assert a["method_count"] == b["method_count"]
        if filters:
            assert all(h["chunk_index"] == 1 for hits in got for h in hits)
    assert tmgr.sparse.has_postings and jmgr.sparse.has_postings
    one = tmgr.hybrid_search_sync(QUERIES[0], 6)
    assert [h["chunk_id"] for h in one] == chunk_ids(
        jmgr.hybrid_search_batch_sync(QUERIES[:1], 6))[0]


def test_hybrid_below_the_threshold_uses_the_compare_scan():
    jmgr, tmgr = unfused_managers("bfloat16")
    want = jmgr.hybrid_search_batch_sync(QUERIES, 5)
    got = tmgr.hybrid_search_batch_sync(QUERIES, 5)
    assert not tmgr.sparse.has_postings and not jmgr.sparse.has_postings
    # bf16 rows: K1's plain f32 dot and XLA's differ in the last bits only
    overlap = np.mean([len(set(a) & set(b)) / max(len(b), 1)
                       for a, b in zip(chunk_ids(got), chunk_ids(want))])
    assert overlap >= 0.9


def test_fused_path_takes_the_postings_rung_once_built(low_threshold, monkeypatch):
    """After a hybrid call has built the postings (corpus above the lowered
    threshold), the fused path scores BM25 from them, as the JAX manager
    does, with both exact rerank bases."""
    jmgr, jrr, tmgr, trr = build("float32")
    with pytest.raises(IndexingError, match="postings"):
        tmgr.fused_retrieve_batch_sync(["q"], reranker=trr, rerank_alpha=0.5,
                                       rerank_base="exact_postings")
    jmgr.hybrid_search_batch_sync(["dense sparse"], 5)
    tmgr.hybrid_search_batch_sync(["dense sparse"], 5)
    assert tmgr.sparse.has_postings
    calls = []
    real = tpost_mod.postings_topk
    monkeypatch.setattr(tpost_mod, "postings_topk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    queries = texts(5, 7)
    for base in ("exact", "exact_postings"):
        kn = dict(KNOBS, rerank_base=base)
        want = jmgr.fused_retrieve_batch_sync(queries, reranker=jrr, **kn)
        got = tmgr.fused_retrieve_batch_sync(queries, reranker=trr, **kn)
        assert chunk_ids(got) == chunk_ids(want)
    assert len(calls) == 2


def test_ivf_tail_past_the_pow2_padding_is_searched_exactly(vectors):
    """Single-row appends after the build leave capacity below
    ivf_size + next_pow2(tail); the port's tail scan still covers exactly
    rows [ivf_size, size) (the JAX slice clamps its start there, ROADMAP.md
    § D).  At full probe the IVF search equals the exact scan."""
    x, q = vectors
    _, tidx = indexes("float32", nprobe=16)
    tidx.bulk_load(x[:600])
    tidx.build_ivf(nlist=16)
    for r in range(600, 1000):
        tidx.append(r, x[r:r + 1])
    assert tidx.capacity == 1024 and tidx._ivf_size + 512 > tidx.capacity
    ts, ti = tidx.search(q, 10)
    tidx._ivf = None
    es, ei = tidx.search(q, 10)
    assert_scores_close(ts, es, rtol=1e-6, atol=1e-6)
    assert_ids_tie_aware(ti, ei, es, 1e-6)
    assert (to_np(ti) >= 600).any()
