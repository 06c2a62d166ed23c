"""K3's table of the batch's query terms (csrc/kernels.cu), through its
plain version in ops/sparse_kernels.py, against the compare loop it
replaced and against the JAX package.

K3 builds, per launch, a table of the chunk's distinct live term ids with
the weight of each id for each query summed in t order from 0.0
(``bm25_query_table``), and looks every live slot up in it once
(``bm25_table_lookup``).  The compare loop sums, per slot and query,
``q_w[j, t]`` over the terms equal to the slot's id in the same t order, so
the two weights are bit-identical (checked here as raw f32 bits); a miss
gives 0.0, the compare loop's weight for an id no query holds.  Scoring
through the table then matches ``bm25_scores_plain`` and the Pallas
``sparse_topk_pallas`` (interpret mode) to rtol 1e-5 / atol 1e-5, the
tolerance of tests/test_torch_sparse.py: the sum over slots runs in
another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.ops.pallas_sparse import sparse_topk_pallas
from advanced_rag_tpu_torch.ops import sparse_kernels as tk
from advanced_rag_tpu_torch.ops.dense import mask_additive, reduce_topk
from advanced_rag_tpu_torch.ops.dense_kernels import SCAN_SMEM_MAX
from advanced_rag_tpu_torch.ops.sparse import live_avg_len, query_weights
from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np
from test_torch_sparse import jax_args, sparse_corpus


def compare_weights(q_idx, q_w, slot_ids):
    """The compare loop's weight of each slot id for each query: m = 0.0,
    then m += q_w[j, t] for t in order where q_idx[j, t] == id (f32)."""
    out = np.zeros((slot_ids.size, q_idx.shape[0]), np.float32)
    for s, sid in enumerate(slot_ids.reshape(-1)):
        for j in range(q_idx.shape[0]):
            m = np.float32(0.0)
            for t in range(q_idx.shape[1]):
                if sid >= 0 and q_idx[j, t] == sid:
                    m = np.float32(m + q_w[j, t])
            out[s, j] = m
    return out


def query_case(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    q_idx = rng.integers(0, 40, size=(6, 12)).astype(np.int32)
    q_w = (rng.random((6, 12)) * 3).astype(np.float32)
    if kind == "duplicates":           # one term several times in a query
        q_idx[0, :5] = 7
        q_idx[1, ::2] = 11
    elif kind == "shared":             # one term in every query
        q_idx[:, 3] = 5
        q_idx[:, 9] = 5
    elif kind == "padding":            # padding terms and all-padding rows
        q_idx[:, 8:] = -1
        q_idx[2] = -1
        q_idx[5] = -1
        q_w[q_idx < 0] = 0.0
    elif kind == "signs":              # negative and zero weights, cancelling
        q_w = (rng.standard_normal((6, 12)) * 2).astype(np.float32)
        q_w[:, ::4] = 0.0
        q_idx[0, :4] = 3
        q_w[0, :4] = [1.5, -1.5, 0.25, -0.25]
        q_idx[1, :3] = 3
        q_w[1, :3] = [-0.0, 0.0, -2.0]
    elif kind == "empty":              # no live term at all
        q_idx[:] = -1
    return q_idx, q_w


@pytest.mark.parametrize("kind", ["duplicates", "shared", "padding", "signs", "empty",
                                  "plain"])
def test_table_weights_are_the_compare_loops_bit_for_bit(kind):
    q_idx, q_w = query_case(kind)
    ids, w = tk.bm25_query_table(torch.from_numpy(q_idx), torch.from_numpy(q_w))
    live = np.unique(q_idx[q_idx >= 0])
    np.testing.assert_array_equal(to_np(ids), live)
    # every id the batch holds, ids it does not hold, and padding slots
    slots = np.concatenate([live, [-1, 0, 39, 41, 1000, 2**31 - 1]]).astype(np.int32)
    got = to_np(tk.bm25_table_lookup(ids, w, torch.from_numpy(slots)))
    want = compare_weights(q_idx, q_w, slots)
    assert got.shape == want.shape == (slots.size, q_idx.shape[0])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
def test_table_scores_match_the_compare_scan(scoring):
    idx, tf, doc_len, df, q_idx, q_tf, valid = sparse_corpus(400, 24, 10, 5, 3)
    q_idx[1, :4] = q_idx[1, 4]                       # duplicates in a query
    q_idx[4] = -1                                    # a padding query
    q_w = query_weights(torch.from_numpy(q_idx), torch.from_numpy(q_tf),
                        torch.from_numpy(df), torch.tensor(400.0), scoring)
    m = mask_additive(torch.from_numpy(valid), 400, torch.device("cpu"))
    args = (torch.from_numpy(q_idx), q_w, torch.from_numpy(idx.T.copy()),
            torch.from_numpy(tf.T.copy()).to(torch.bfloat16),
            torch.from_numpy(doc_len), m, 1.2, 0.75, 41.5, scoring)
    assert_scores_close(tk.bm25_scores_table(*args), tk.bm25_scores_plain(*args),
                        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
def test_table_scores_match_pallas_exact(scoring):
    idx, tf, doc_len, df, q_idx, q_tf, valid = sparse_corpus(600, 16, 8, 3, 5)
    q_idx[0, :3] = q_idx[0, 3]
    ws, wi = sparse_topk_pallas(*jax_args(idx, tf, doc_len, df, q_idx, q_tf, 600),
                                16, jnp.asarray(valid), scoring=scoring,
                                block_size=128, reduce="exact")
    qi = torch.from_numpy(q_idx)
    v = torch.from_numpy(valid)
    dl = torch.from_numpy(doc_len)
    q_w = query_weights(qi, torch.from_numpy(q_tf), torch.from_numpy(df),
                        torch.tensor(600.0), scoring)
    scores = tk.bm25_scores_table(qi, q_w, torch.from_numpy(idx.T.copy()),
                                  torch.from_numpy(tf.T.copy()), dl,
                                  mask_additive(v, 600, torch.device("cpu")),
                                  1.2, 0.75, float(live_avg_len(dl, v)), scoring)
    gs, gi = reduce_topk(scores, 600, 16)
    assert_scores_close(gs, ws, rtol=1e-5, atol=1e-5)
    assert_ids_tie_aware(gi, wi, ws, 1e-5)


def test_chunk_plan_matches_the_kernels_shared_memory():
    # 32 queries x 32 terms: W 1024 x 36 f32, a hash of 2048 (id, row)
    # pairs, 1024 staged ids and weights, the counter
    assert tk.bm25_smem_bytes(32, 32) == 1024 * 36 * 4 + 2048 * 8 + 1024 * 8 + 16
    assert tk.bm25_smem_bytes(2, 5) == 10 * 3 * 4 + 32 * 8 + 10 * 8 + 16
    assert tk.bm25_smem_bytes(1, 1) == 1 * 2 * 4 + 2 * 8 + 8 + 16
    assert ([tk.bm25_chunk(t) for t in (1, 8, 32, 33, 64, 128, 256)]
            == [32, 32, 32, 32, 16, 16, 8])
    for t in (1, 7, 32, 64, 200, 1000, 4000):
        qc = tk.bm25_chunk(t)
        assert tk.bm25_smem_bytes(qc, t) <= SCAN_SMEM_MAX
        assert qc == 32 or tk.bm25_smem_bytes(2 * qc, t) > SCAN_SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        tk.bm25_chunk(20000)


def test_the_wrapper_chunks_by_the_plan_on_the_cpu_too():
    """CPU tensors take bm25_scores_plain whatever the chunk plan, and
    count no launch."""
    idx, tf, doc_len, df, q_idx, q_tf, valid = sparse_corpus(60, 8, 40, 20, 2)
    before = tk.bm25_scores.launches
    args = (torch.from_numpy(q_idx), torch.from_numpy(q_tf),
            torch.from_numpy(idx.T.copy()), torch.from_numpy(tf.T.copy()),
            torch.from_numpy(doc_len), torch.zeros(60), 1.2, 0.75, 30.0, "bm25")
    assert torch.equal(tk.bm25_scores(*args), tk.bm25_scores_plain(*args))
    assert tk.bm25_scores.launches == before
