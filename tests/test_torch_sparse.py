"""The port's BM25 compare-scan (ops/sparse.py and the plain version behind
kernels K3 / K3-ip in ops/sparse_kernels.py) against the JAX package's
``ops.sparse.sparse_topk`` and the Pallas ``sparse_topk_pallas`` with
``reduce="exact"`` (interpret mode on the CPU).

Doc rows hold distinct term ids (the contract of both packages) with -1
padding slots anywhere in the row; some rows are masked.  The kernel path
reads the term-slot-major [P, N] mirror, so the tests hand it the
transposed arrays.  Tolerance: f32 scores rtol 1e-5 / atol 1e-5 (another
summation order); ids tie-aware (test_torch_parity.py), which matters for
the many rows that score exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.ops import sparse as jsparse
from advanced_rag_tpu.ops.pallas_sparse import sparse_topk_pallas
from advanced_rag_tpu_torch.ops import sparse as tsparse
from advanced_rag_tpu_torch.ops import sparse_kernels as tk
from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np

VOCAB = 300


def sparse_corpus(n, p, t, nq, seed):
    rng = np.random.default_rng(seed)
    idx = np.full((n, p), -1, np.int32)
    tf = np.zeros((n, p), np.float32)
    for r in range(n):
        live = int(rng.integers(1, p + 1))
        slots = rng.choice(p, size=live, replace=False)
        idx[r, slots] = rng.choice(VOCAB, size=live, replace=False)
        tf[r, slots] = rng.integers(1, 6, size=live)
    doc_len = (tf.sum(1) + rng.integers(0, 5, size=n)).astype(np.float32)
    df = np.zeros(VOCAB, np.int32)
    np.add.at(df, idx[idx >= 0], 1)
    q_idx = rng.choice(VOCAB, size=(nq, t)).astype(np.int32)
    q_idx[:, t - 2:] = -1                              # padding terms
    q_tf = np.where(q_idx >= 0, rng.integers(1, 3, size=(nq, t)), 0).astype(np.float32)
    valid = rng.random(n) > 0.3
    return idx, tf, doc_len, df, q_idx, q_tf, valid


def jax_args(idx, tf, doc_len, df, q_idx, q_tf, n_docs):
    return (jnp.asarray(idx), jnp.asarray(tf), jnp.asarray(doc_len), jnp.asarray(df),
            jnp.float32(n_docs), jnp.asarray(q_idx), jnp.asarray(q_tf))


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
@pytest.mark.parametrize("n,p,masked", [(700, 16, True), (700, 16, False),
                                        (129, 40, True)])
def test_k3_plain_matches_jax(scoring, n, p, masked):
    idx, tf, doc_len, df, q_idx, q_tf, valid = sparse_corpus(n, p, 8, 4, n + p)
    v = valid if masked else None
    k = 20
    ws, wi = jsparse.sparse_topk(*jax_args(idx, tf, doc_len, df, q_idx, q_tf, n), k,
                                 None if v is None else jnp.asarray(v),
                                 scoring=scoring, block_size=256)
    gs, gi = tk.sparse_topk_kernel(
        torch.from_numpy(idx.T.copy()), torch.from_numpy(tf.T.copy()),
        torch.from_numpy(doc_len), torch.from_numpy(df), torch.tensor(float(n)),
        torch.from_numpy(q_idx), torch.from_numpy(q_tf), k,
        None if v is None else torch.from_numpy(v), scoring=scoring)
    assert_scores_close(gs, ws, rtol=1e-5, atol=1e-5)
    assert_ids_tie_aware(gi, wi, ws, 1e-5)
    if masked:
        gi = to_np(gi)
        assert not np.isin(gi[gi >= 0], np.nonzero(~valid)[0]).any()


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
def test_k3_plain_matches_pallas_exact(scoring):
    idx, tf, doc_len, df, q_idx, q_tf, valid = sparse_corpus(600, 16, 8, 3, 5)
    ws, wi = sparse_topk_pallas(*jax_args(idx, tf, doc_len, df, q_idx, q_tf, 600),
                                16, jnp.asarray(valid), scoring=scoring,
                                block_size=128, reduce="exact")
    gs, gi = tk.sparse_topk_kernel(
        torch.from_numpy(idx.T.copy()), torch.from_numpy(tf.T.copy()),
        torch.from_numpy(doc_len), torch.from_numpy(df), torch.tensor(600.0),
        torch.from_numpy(q_idx), torch.from_numpy(q_tf), 16,
        torch.from_numpy(valid), scoring=scoring)
    assert_scores_close(gs, ws, rtol=1e-5, atol=1e-5)
    assert_ids_tie_aware(gi, wi, ws, 1e-5)


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
def test_plain_doc_major_matches_jax(scoring):
    idx, tf, doc_len, df, q_idx, q_tf, valid = sparse_corpus(300, 12, 6, 3, 9)
    ws, wi = jsparse.sparse_topk(*jax_args(idx, tf, doc_len, df, q_idx, q_tf, 300),
                                 12, jnp.asarray(valid), scoring=scoring)
    gs, gi = tsparse.sparse_topk(
        torch.from_numpy(idx), torch.from_numpy(tf), torch.from_numpy(doc_len),
        torch.from_numpy(df), torch.tensor(300.0), torch.from_numpy(q_idx),
        torch.from_numpy(q_tf), 12, torch.from_numpy(valid), scoring=scoring)
    assert_scores_close(gs, ws, rtol=1e-5, atol=1e-5)
    assert_ids_tie_aware(gi, wi, ws, 1e-5)


def test_idf_weights_match_jax():
    df = np.array([0, 1, 5, 99, 100, 250], np.int32)
    want = np.asarray(jsparse.idf_weights(jnp.asarray(df), jnp.float32(100.0)))
    got = tsparse.idf_weights(torch.from_numpy(df), torch.tensor(100.0))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    idx, tf, doc_len, df, q_idx, q_tf, valid = sparse_corpus(50, 8, 4, 2, 1)
    before = tk.bm25_scores.launches
    tk.sparse_topk_kernel(torch.from_numpy(idx.T.copy()), torch.from_numpy(tf.T.copy()),
                          torch.from_numpy(doc_len), torch.from_numpy(df),
                          torch.tensor(50.0), torch.from_numpy(q_idx),
                          torch.from_numpy(q_tf), 5)
    assert tk.bm25_scores.launches == before
