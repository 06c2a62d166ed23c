"""The port's dense scans (ops/dense.py, ops/quant.py and the plain versions
behind kernels K1 and K2 in ops/dense_kernels.py) against the JAX package:
``ops.dense.dense_topk``, ``ops.quant.dense_topk_sq8`` and the Pallas
``dense_topk_pallas`` / ``dense_topk_sq8_pallas`` with ``reduce="exact"``
(interpret mode on the CPU, as the JAX package's own tests run them).

On the CPU the kernel wrappers serve the tensors with their plain
versions, which is what these tests hold against the reference.
Tolerances: f32 scores rtol 1e-5 / atol 1e-6 (another summation order);
SQ8 scores rtol 1e-6 (the integer dot is exact; the JAX side multiplies
the two scales first, the port applies the query scale last).  Ids are
compared tie-aware (test_torch_parity.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from advanced_rag_tpu.ops import dense as jdense
from advanced_rag_tpu.ops import quant as jquant
from advanced_rag_tpu.ops.pallas_dense import dense_topk_pallas, dense_topk_sq8_pallas
from advanced_rag_tpu_torch.ops import dense as tdense
from advanced_rag_tpu_torch.ops import dense_kernels as tk
from advanced_rag_tpu_torch.ops import quant as tquant
from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np

D = 64


def corpus(n, seed, normalize=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((5, D)).astype(np.float32)
    valid = rng.random(n) > 0.3
    return x, q, valid


def storage(x, dtype):
    if dtype == "bf16":
        return jnp.asarray(x.astype(ml_dtypes.bfloat16)), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,k,masked", [(1000, 10, True), (1000, 10, False),
                                        (300, 7, True), (37, 50, True)])
def test_k1_plain_matches_jax_scan(dtype, n, k, masked):
    """Masks, N not a multiple of the JAX block, and k > n (absent slots)."""
    x, q, valid = corpus(n, n + k)
    jx, tx = storage(x, dtype)
    v = valid if masked else None
    ws, wi = jdense.dense_topk(jx, jnp.asarray(q), k,
                               None if v is None else jnp.asarray(v),
                               metric="ip", block_size=256, normalize_queries=False)
    gs, gi = tk.dense_topk_kernel(tx, torch.from_numpy(q), k,
                                  None if v is None else torch.from_numpy(v),
                                  metric="ip", normalize_queries=False)
    assert_scores_close(gs, ws, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(gi, wi, ws, 1e-6)
    gi = to_np(gi)
    if masked:
        assert not np.isin(gi[gi >= 0], np.nonzero(~valid)[0]).any()
    if k > n:
        assert (gi[:, int(valid.sum()) if masked else n:] == -1).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k1_plain_matches_pallas_exact(dtype):
    x, q, valid = corpus(1000, 3)
    jx, tx = storage(x, dtype)
    ws, wi = dense_topk_pallas(jx, jnp.asarray(q), 16, jnp.asarray(valid),
                               metric="cosine", block_size=256, reduce="exact")
    gs, gi = tk.dense_topk_kernel(tx, torch.from_numpy(q), 16,
                                  torch.from_numpy(valid), metric="cosine")
    assert_scores_close(gs, ws, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(gi, wi, ws, 1e-6)


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_plain_dense_topk_matches_jax(metric):
    x, q, valid = corpus(500, 9, normalize=False)
    ws, wi = jdense.dense_topk(jnp.asarray(x), jnp.asarray(q), 12, jnp.asarray(valid),
                               metric=metric, block_size=128)
    gs, gi = tdense.dense_topk(torch.from_numpy(x), torch.from_numpy(q), 12,
                               torch.from_numpy(valid), metric=metric)
    assert_scores_close(gs, ws, rtol=1e-5, atol=1e-5)
    assert_ids_tie_aware(gi, wi, ws, 1e-5)


@pytest.mark.parametrize("kernel", [True, False])
def test_all_rows_masked_gives_absent_slots(kernel):
    x, q, _ = corpus(64, 1)
    none = np.zeros(64, bool)
    ws, wi = jdense.dense_topk(jnp.asarray(x), jnp.asarray(q), 8, jnp.asarray(none),
                               metric="ip", normalize_queries=False)
    fn = tk.dense_topk_kernel if kernel else tdense.dense_topk
    gs, gi = fn(torch.from_numpy(x), torch.from_numpy(q), 8, torch.from_numpy(none),
                metric="ip", normalize_queries=False)
    np.testing.assert_array_equal(to_np(gi), np.asarray(wi))
    assert (to_np(gi) == -1).all()
    assert (to_np(gs) <= float(jdense.NEG_INF)).all()


def test_sq8_quantize_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((200, D)).astype(np.float32)
    x[0] = 0.0                                     # zero row: scale floor
    x[1, :4] = [0.5, -0.5, 1.5, 2.5]               # exact halves after scaling
    wc, ws = jquant.sq8_quantize(jnp.asarray(x))
    gc, gs = tquant.sq8_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(gc), np.asarray(wc))
    # XLA turns the division by 127 into a multiply by its f32 reciprocal,
    # so the device scales may differ by one ulp (rel 1.2e-7); the port
    # divides, as the JAX package's host quantizer does (equal below)
    np.testing.assert_allclose(to_np(gs), np.asarray(ws), rtol=1.2e-7, atol=0)
    hc, hs = tquant.sq8_quantize_host(x)
    jc, js = jquant.sq8_quantize_host(x)
    np.testing.assert_array_equal(hc, jc)
    np.testing.assert_array_equal(hs, js)


@pytest.mark.parametrize("n,k,masked", [(1000, 10, True), (333, 9, False),
                                        (40, 64, True)])
def test_k2_plain_matches_jax_sq8(n, k, masked):
    x, q, valid = corpus(n, 7 * n)
    codes, scale = jquant.sq8_quantize_host(x)
    v = valid if masked else None
    ws, wi = jquant.dense_topk_sq8(jnp.asarray(codes), jnp.asarray(scale),
                                   jnp.asarray(q), k,
                                   None if v is None else jnp.asarray(v),
                                   metric="ip", block_size=256, normalize_queries=False)
    gs, gi = tk.dense_topk_sq8_kernel(torch.from_numpy(codes), torch.from_numpy(scale),
                                      torch.from_numpy(q), k,
                                      None if v is None else torch.from_numpy(v),
                                      metric="ip", normalize_queries=False)
    assert_scores_close(gs, ws, rtol=1e-6, atol=1e-7)
    assert_ids_tie_aware(gi, wi, ws, 1e-6)
    ps, pi = tquant.dense_topk_sq8(torch.from_numpy(codes), torch.from_numpy(scale),
                                   torch.from_numpy(q), k,
                                   None if v is None else torch.from_numpy(v),
                                   metric="ip", normalize_queries=False)
    assert_scores_close(ps, ws, rtol=1e-6, atol=1e-7)
    assert_ids_tie_aware(pi, wi, ws, 1e-6)


def test_k2_plain_matches_pallas_exact():
    x, q, valid = corpus(1000, 11)
    codes, scale = jquant.sq8_quantize_host(x)
    ws, wi = dense_topk_sq8_pallas(jnp.asarray(codes), jnp.asarray(scale),
                                   jnp.asarray(q), 16, jnp.asarray(valid),
                                   metric="cosine", block_size=256, reduce="exact")
    gs, gi = tk.dense_topk_sq8_kernel(torch.from_numpy(codes), torch.from_numpy(scale),
                                      torch.from_numpy(q), 16, torch.from_numpy(valid),
                                      metric="cosine")
    assert_scores_close(gs, ws, rtol=1e-6, atol=1e-7)
    assert_ids_tie_aware(gi, wi, ws, 1e-6)


def test_cpu_tensors_take_the_plain_version():
    x, q, valid = corpus(100, 2)
    before = (tk.dense_scores.launches, tk.sq8_scores.launches)
    tk.dense_topk_kernel(torch.from_numpy(x), torch.from_numpy(q), 5)
    codes, scale = tquant.sq8_quantize_host(x)
    tk.dense_topk_sq8_kernel(torch.from_numpy(codes), torch.from_numpy(scale),
                             torch.from_numpy(q), 5)
    assert (tk.dense_scores.launches, tk.sq8_scores.launches) == before


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(5)
    a_s = np.sort(rng.integers(0, 5, (3, 6)).astype(np.float32), 1)[:, ::-1].copy()
    b_s = rng.integers(0, 5, (3, 6)).astype(np.float32)
    a_i = rng.integers(0, 100, (3, 6)).astype(np.int32)
    b_i = rng.integers(0, 100, (3, 6)).astype(np.int32)
    ws, wi = jdense.merge_topk(*(jnp.asarray(a) for a in (a_s, a_i, b_s, b_i)), 6)
    gs, gi = tdense.merge_topk(*(torch.from_numpy(a) for a in (a_s, a_i, b_s, b_i)), 6)
    np.testing.assert_array_equal(to_np(gs), np.asarray(ws))
    np.testing.assert_array_equal(to_np(gi), np.asarray(wi))
