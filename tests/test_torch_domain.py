"""The domain index family and ``recency_boost`` in the port against the
JAX package.

Both managers run ``enable_domain=True`` with the JAX hashing projections
carried over (``hashing_from_numpy``: the semantic one and the domain
family's 768-wide ``HashingEmbedder(seed=17)``) and ingest the same chunks.
Bounds: hybrid results (RRF over dense, BM25 and domain lists) and
``search_sync(DOMAIN)`` give the same chunk ids where the reference scores
are distinct (sets within runs of equal scores), RRF scores within rtol
1e-6, domain cosine scores within 1e-5 / atol 1e-6; ``recency_boost``
within rtol 1e-6 times the exponent (XLA divides by the constant 86400 as
a multiply by its reciprocal, an ulp of the exponent that 2^-e scales by
e ln 2), denormals aside.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.config import IndexType as JIndexType
from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.ops.fusion import recency_boost as j_recency_boost
from advanced_rag_tpu_torch.config import IndexType, PipelineConfig
from advanced_rag_tpu_torch.index.corpus import ChunkRecord
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.convert import hashing_from_numpy
from advanced_rag_tpu_torch.models.embedder import HashingEmbedder
from advanced_rag_tpu_torch.ops.fusion import recency_boost
from advanced_rag_tpu_torch.ops.hybrid import hybrid_retrieve
from advanced_rag_tpu_torch.utils.exceptions import IndexingError

from test_torch_checkpoint import QUERIES, TEXTS, hits, records
from test_torch_pipeline import assert_same_ranking


def managers(tier="bfloat16"):
    jmgr = JManager(JConfig(semantic_dtype=tier), enable_domain=True)
    tmgr = MultiIndexManager(
        PipelineConfig(semantic_dtype=tier),
        embedder=hashing_from_numpy(np.asarray(jmgr.embedder._proj), device="cpu"),
        domain_embedder=hashing_from_numpy(np.asarray(jmgr.domain_embedder._proj),
                                           device="cpu"),
        enable_domain=True, device="cpu")
    for mgr, cls in ((jmgr, JRecord), (tmgr, ChunkRecord)):
        rep = mgr.index_chunks(records(cls))
        assert rep["indexed"] == len(TEXTS)
    return jmgr, tmgr


@pytest.fixture(scope="module", params=["bfloat16", "pq"])
def both(request):
    jmgr, tmgr = managers(request.param)
    if request.param == "pq":
        for mgr in (jmgr, tmgr):
            mgr.build_semantic(pq=True)
        # the JAX codebooks and codes, so the PQ rung ranks alike
        from advanced_rag_tpu_torch.models.convert import pq_from_numpy

        tmgr.semantic._pq, tmgr.semantic.emb = pq_from_numpy(
            jmgr.semantic._pq.codebooks, np.asarray(jmgr.semantic.emb),
            m=jmgr.semantic._pq.m, bits=jmgr.semantic._pq.bits, device="cpu")
    return request.param, jmgr, tmgr


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(domain_weight=0.9, use_mmr=False),
    dict(domain_weight=0.2, filters={"chunk_index": {"in": [0, 2]}}),
])
def test_domain_rung_of_hybrid_search_matches_jax(both, knobs):
    """Q = 1 and a 7-query batch (padded to 8); on the PQ tier the
    domain list also enters the host re-fusion (``_refuse_exact``)."""
    _, jmgr, tmgr = both
    knobs = dict(knobs)
    filters = knobs.pop("filters", None)
    for queries in (QUERIES[:1], QUERIES[:7]):
        got = tmgr.hybrid_search_batch_sync(queries, 10, filters, **knobs)
        want = jmgr.hybrid_search_batch_sync(queries, 10, filters, **knobs)
        for g, w in zip(got, want):
            assert g
            assert_same_ranking(hits(g), hits(w), 1e-6, 0.0)
            assert [h["method_count"] for h in g] == [h["method_count"] for h in w]


def test_domain_weight_changes_the_ranking(both):
    _, _, tmgr = both
    a = tmgr.hybrid_search_batch_sync(QUERIES, 10, domain_weight=0.0)
    b = tmgr.hybrid_search_batch_sync(QUERIES, 10, domain_weight=2.0)
    assert any(hits(x)[1].tolist() != hits(y)[1].tolist() for x, y in zip(a, b))


def test_search_sync_domain_and_stats_match_jax(both):
    tier, jmgr, tmgr = both
    for q in QUERIES:
        got = tmgr.search_sync(IndexType.DOMAIN, q, 8)
        want = jmgr.search_sync(JIndexType.DOMAIN, q, 8)
        assert got and all(h["method"] == "domain" for h in got)
        assert_same_ranking(hits(got), hits(want), 1e-5, 1e-6)
    np.testing.assert_allclose(tmgr.generate_domain_embedding(QUERIES[0]),
                               jmgr.generate_domain_embedding(QUERIES[0]),
                               rtol=1e-5, atol=1e-6)
    tstats, jstats = tmgr.get_collection_stats(), jmgr.get_collection_stats()
    assert tstats["domain"] == jstats["domain"] == {
        "rows": len(TEXTS), "dim": 768, "memory_bytes": 1024 * 768 * 2}
    assert set(tstats) == set(jstats)


def test_sparse_off_domain_on_fuses_the_domain_list_as_jax_does():
    """With the sparse family off, the fusion weights are still cut from
    ``[dense, sparse, domain]`` by the number of lists, so the domain list
    takes ``sparse_weight`` and ``domain_weight`` is unused: a fault of the
    reference (JAX ``ops/hybrid.py:251``), kept for parity."""
    jmgr = JManager(JConfig(), enable_sparse=False, enable_domain=True)
    tmgr = MultiIndexManager(
        PipelineConfig(),
        embedder=hashing_from_numpy(np.asarray(jmgr.embedder._proj), device="cpu"),
        domain_embedder=hashing_from_numpy(np.asarray(jmgr.domain_embedder._proj),
                                           device="cpu"),
        enable_sparse=False, enable_domain=True, device="cpu")
    for mgr, cls in ((jmgr, JRecord), (tmgr, ChunkRecord)):
        assert mgr.index_chunks(records(cls))["indexed"] == len(TEXTS)
    for knobs in (dict(), dict(sparse_weight=2.0), dict(domain_weight=2.0)):
        got = tmgr.hybrid_search_batch_sync(QUERIES, 10, **knobs)
        want = jmgr.hybrid_search_batch_sync(QUERIES, 10, **knobs)
        for g, w in zip(got, want):
            assert g
            assert_same_ranking(hits(g), hits(w), 1e-6, 0.0)
    base = tmgr.hybrid_search_batch_sync(QUERIES, 10, use_mmr=False)
    same = tmgr.hybrid_search_batch_sync(QUERIES, 10, use_mmr=False, domain_weight=5.0)
    moved = tmgr.hybrid_search_batch_sync(QUERIES, 10, use_mmr=False, sparse_weight=5.0)
    assert [hits(x)[0] for x in base] == [hits(x)[0] for x in same]
    assert any(hits(x)[0] != hits(y)[0] for x, y in zip(base, moved))


def test_manager_takes_enable_domain_and_builds_the_family():
    off = MultiIndexManager(PipelineConfig(), enable_domain=False, device="cpu")
    assert off.enable_domain is False and off.domain is None
    assert off.search_sync(IndexType.DOMAIN, "x", 3) == []
    with pytest.raises(IndexingError, match="domain index not enabled"):
        off.generate_domain_embedding("x")
    on = MultiIndexManager(PipelineConfig(), enable_domain=True, device="cpu")
    assert on.enable_domain is True
    assert isinstance(on.domain_embedder, HashingEmbedder)
    assert on.domain.dim == on.domain_embedder.dim == PipelineConfig().domain_dim
    assert on.domain.config.index_type == IndexType.DOMAIN
    on.index_chunks(records(ChunkRecord)[:10])
    assert on.domain.size == on.semantic.size == 10
    assert on.domain.capacity == on.semantic.capacity
    assert on.search_sync(IndexType.DOMAIN, TEXTS[3], 1)[0]["chunk_id"] == "c3"
    on.reset_state()
    assert on.domain.size == 0 and on.domain.config.index_type == IndexType.DOMAIN


def test_hybrid_retrieve_fills_the_domain_lists_without_the_family():
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    none = (None,) * 5
    res = hybrid_retrieve(emb, *none, q, None, None, None, torch.tensor([1.0]),
                          torch.tensor(0.8), k_cand=16, k_out=8, enable_sparse=False)
    assert (res.domain_ids == -1).all() and res.domain_ids.shape == (2, 16)
    dom = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    qd = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    res2 = hybrid_retrieve(emb, *none, q, None, None, None, torch.tensor([1.0, 0.0, 1.0]),
                           torch.tensor(0.8), domain_emb=dom, q_domain=qd,
                           k_cand=16, k_out=8, enable_sparse=False, use_mmr=False)
    want = torch.topk(qd @ dom.T, 16).indices
    assert (res2.domain_ids == want).all()


@pytest.mark.parametrize("half_life", [0.5, 7.0, 0.0])
def test_recency_boost_matches_jax(half_life):
    rng = np.random.default_rng(1)
    now = 1.7e9
    ts = (now - rng.uniform(-3600, 90 * 86400, size=32)).astype(np.float32)
    want = np.asarray(j_recency_boost(jnp.asarray(ts), jnp.float32(now),
                                      jnp.float32(half_life)))
    got = recency_boost(torch.from_numpy(ts), now, half_life).numpy()
    assert got.dtype == np.float32 and ((got >= 0) & (got <= 1)).all()
    # 2^-e carries the exponent's last-bit rounding times e * ln 2, and XLA
    # flushes denormal results to zero (below 1.2e-38)
    e = np.maximum(now - ts.astype(np.float64), 0) / 86400 / max(half_life, 1e-6)
    tol = 1e-6 * np.maximum(e, 1.0) * np.abs(want) + 1.2e-38
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()
