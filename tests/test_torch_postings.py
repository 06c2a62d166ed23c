"""The port's inverted postings (advanced_rag_tpu_torch/ops/postings.py,
index/sparse_index.py, ops/rescore.py) against the JAX package's on the CPU.

Inputs: seeded numpy documents over a small skewed vocabulary, so that some
terms' document frequency exceeds the cap and their lists are truncated.

Tolerances:
- the host builds (``build_postings``, ``postings_tf_weights``, the
  incremental appends of ``SparseIndex``) are numpy copies: equal arrays;
- the device copies round ``post_tf``/``post_tfw`` to bf16 in both;
- the ``sort`` rung's segment sums are differences of running sums over all
  of a query's postings, so they carry the rounding of that running total
  (the two frameworks accumulate it differently): scores within 1e-6 of the
  query's total weight; the ``scatter`` rung and the exact rescore sum
  directly, rtol 1e-5; ids equal where the reference scores are distinct
  and as sets within ties (tie tolerance 1e-5 of the top score).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.config import IndexConfig as JIndexConfig
from advanced_rag_tpu.config import IndexType as JIndexType
from advanced_rag_tpu.index.sparse_index import SparseIndex as JSparse
from advanced_rag_tpu.ops import postings as jpost
from advanced_rag_tpu.ops.rescore import exact_tier_scores_postings as j_rescore
from advanced_rag_tpu_torch.config import IndexConfig, IndexType
from advanced_rag_tpu_torch.index.sparse_index import SparseIndex
from advanced_rag_tpu_torch.index.text import encode_documents
from advanced_rag_tpu_torch.models.convert import postings_from_numpy
from advanced_rag_tpu_torch.ops import postings as tpost
from advanced_rag_tpu_torch.ops.rescore import exact_tier_scores_postings

from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np

V, P, N, T = 256, 12, 600, 8


def corpus(rng, n):
    """[n, P] distinct term ids a row (-1 pad), Zipf-skewed, tf 1..4."""
    p = 1.0 / (np.arange(V) + 3.0)
    p /= p.sum()
    idx = np.full((n, P), -1, np.int32)
    tf = np.zeros((n, P), np.float32)
    for r in range(n):
        k = int(rng.integers(3, P + 1))
        terms = rng.choice(V, size=k, replace=False, p=p)
        idx[r, :k] = terms
        tf[r, :k] = rng.integers(1, 5, size=k)
    return idx, tf, tf.sum(1).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    idx, tf, lens = corpus(rng, N)
    df = np.bincount(idx[idx >= 0], minlength=V).astype(np.int32)
    q_idx = rng.integers(0, 40, size=(5, T)).astype(np.int32)
    q_idx[:, 6:] = -1
    q_idx[4] = -1                      # a query with no terms
    q_tf = np.where(q_idx >= 0, rng.integers(1, 3, size=(5, T)), 0).astype(np.float32)
    valid = rng.random(N) > 0.2
    return idx, tf, lens, df, q_idx, q_tf, valid


@pytest.mark.parametrize("cap", [16, 256])
def test_host_builds_match_jax(data, cap):
    idx, tf, lens, *_ = data
    jr, jt = jpost.build_postings(idx, tf, V, cap)
    tr, tt = tpost.build_postings(idx, tf, V, cap)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(
        tpost.postings_tf_weights(tr, tt, lens, 23.5),
        jpost.postings_tf_weights(jr, jt, lens, 23.5))
    for args in ((600, P, V), (100_000, 256, 16384), (10, 4, 16384)):
        assert tpost.auto_postings_cap(*args) == jpost.auto_postings_cap(*args)


@pytest.mark.parametrize("impl", ["sort", "scatter"])
@pytest.mark.parametrize("scoring,with_tfw", [("bm25", True), ("bm25", False),
                                              ("ip", False)])
@pytest.mark.parametrize("cap", [16, 256])
def test_postings_topk_matches_jax(data, impl, scoring, with_tfw, cap):
    idx, tf, lens, df, q_idx, q_tf, valid = data
    rows, ptf = jpost.build_postings(idx, tf, V, cap)
    avg = float(lens[valid].mean())
    tfw = jpost.postings_tf_weights(rows, ptf, lens, avg)
    # both packages store post_tf / post_tfw in bf16 on the device
    j_rows, j_tf, j_tfw = (jnp.asarray(rows), jnp.asarray(ptf, jnp.bfloat16),
                           jnp.asarray(tfw, jnp.bfloat16))
    t_rows, t_tf, t_tfw = postings_from_numpy(rows, ptf, tfw, device="cpu")
    n_docs = float(valid.sum())
    js, ji = jpost.postings_topk(
        j_rows, j_tf, jnp.asarray(lens), jnp.asarray(df), jnp.float32(n_docs),
        jnp.asarray(q_idx), jnp.asarray(q_tf), 20, jnp.asarray(valid),
        post_tfw=j_tfw if with_tfw else None, scoring=scoring, impl=impl)
    ts, ti = tpost.postings_topk(
        t_rows, t_tf, torch.from_numpy(lens), torch.from_numpy(df),
        torch.tensor(n_docs), torch.from_numpy(q_idx), torch.from_numpy(q_tf), 20,
        torch.from_numpy(valid), post_tfw=t_tfw if with_tfw else None,
        scoring=scoring, impl=impl)
    js, ts = np.asarray(js), to_np(ts)
    if impl == "sort":
        # a query's total weight bounds its running sums
        total = np.maximum(np.where(js > 0, js, 0).sum(1, keepdims=True) * 4, 1.0)
        live = js > -1e29
        assert np.all(np.abs(ts - js)[live] <= 1e-6 * np.broadcast_to(total, js.shape)[live])
        np.testing.assert_array_equal(ts[~live], js[~live])
    else:
        assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
    tie = 1e-5 * max(float(np.abs(js[js > -1e29]).max()), 1.0)
    assert_ids_tie_aware(ti, ji, js, tie)
    got = to_np(ti)
    assert valid[got[got >= 0]].all()
    assert (got[4] == -1).all()


def test_exact_rescore_from_postings_matches_jax(data):
    idx, tf, lens, df, q_idx, q_tf, valid = data
    rng = np.random.default_rng(9)
    rows, ptf = jpost.build_postings(idx, tf, V, 64)
    emb = rng.standard_normal((N, 16)).astype(np.float32)
    q_dense = rng.standard_normal((5, 16)).astype(np.float32)
    cand = rng.integers(0, N, size=(5, 12)).astype(np.int32)
    cand[:, -2:] = -1
    n_docs = float(valid.sum())
    jd, jb = j_rescore(jnp.asarray(cand), jnp.asarray(q_dense), jnp.asarray(q_idx),
                       jnp.asarray(q_tf), jnp.asarray(emb), jnp.asarray(rows),
                       jnp.asarray(ptf, jnp.bfloat16), jnp.asarray(lens),
                       jnp.asarray(df), jnp.float32(n_docs), valid=jnp.asarray(valid))
    t_rows, t_tf, _ = postings_from_numpy(rows, ptf, ptf, device="cpu")
    td, tb = exact_tier_scores_postings(
        torch.from_numpy(cand), torch.from_numpy(q_dense), torch.from_numpy(q_idx),
        torch.from_numpy(q_tf), torch.from_numpy(emb), t_rows, t_tf,
        torch.from_numpy(lens), torch.from_numpy(df), torch.tensor(n_docs),
        valid=torch.from_numpy(valid))
    assert_scores_close(td, jd, rtol=1e-5, atol=1e-6)
    assert_scores_close(tb, jb, rtol=1e-5, atol=1e-6)
    assert float(np.abs(to_np(tb)).sum()) > 0


def test_sparse_index_postings_lifecycle_matches_jax():
    """Build, incremental appends (a cap doubling included), search and
    delete staleness: the same host arrays and the same hits as JAX."""
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(60)]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(4, 12))))
             for _ in range(260)]
    jcfg = JIndexConfig(index_type=JIndexType.SPARSE, vocab_size=512, doc_nnz=16)
    tcfg = IndexConfig(index_type=IndexType.SPARSE, vocab_size=512, doc_nnz=16)
    jsp, tsp = JSparse(jcfg), SparseIndex(tcfg, device="cpu")
    for lo, hi in ((0, 100), (100, 180), (180, 260)):
        enc = encode_documents(texts[lo:hi], 512, 16)
        jsp.append_encoded(lo, *enc)
        tsp.append_encoded(lo, *enc)
        if lo == 0:
            jsp.build_postings(cap=8)
            tsp.build_postings(cap=8)
    assert tsp.has_postings and tsp._post_cap == jsp._post_cap > 8
    np.testing.assert_array_equal(tsp._host_post_rows, jsp._host_post_rows)
    np.testing.assert_array_equal(tsp._host_post_tf, jsp._host_post_tf)
    np.testing.assert_array_equal(tsp._host_post_tfw, jsp._host_post_tfw)
    np.testing.assert_array_equal(to_np(tsp.post_rows), np.asarray(jsp.post_rows))
    np.testing.assert_array_equal(to_np(tsp.post_tfw),
                                  np.asarray(jsp.post_tfw).astype(np.float32))
    assert tsp.post_avg_len == jsp.post_avg_len
    q_idx, q_tf = tsp.encode_query(["w1 w2 w3", "w40 w7", "w59"])
    js, ji = jsp.search_postings(q_idx, q_tf, 10)
    ts, ti = tsp.search_postings(q_idx, q_tf, 10)
    assert_ids_tie_aware(ti, ji, js, 1e-4)
    js, ji = jsp.search_texts(["w1 w2 w3", "w40 w7"], 10)
    ts, ti = tsp.search_texts(["w1 w2 w3", "w40 w7"], 10)
    assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-5)
    jsp.remove_rows([3, 4, 5])
    tsp.remove_rows([3, 4, 5])
    assert tsp.postings_stale_fraction == pytest.approx(jsp.postings_stale_fraction)
    assert tsp.postings_stale_fraction > 0
