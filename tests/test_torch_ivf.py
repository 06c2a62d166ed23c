"""The port's IVF tier (advanced_rag_tpu_torch/ops/ivf.py, ops/ivf_kernels.py)
against the JAX package's ops/ivf.py and ops/pallas_ivf.py on the CPU.

Inputs come from numpy with a seed.  The Pallas kernels K4 and K5 run in
interpret mode, as tests/test_pallas_ivf.py runs them; the port's kernel
wrappers take their plain versions on CPU tensors.

Tolerances:
- builds: k-means sums in another order (``index_add_`` against XLA's
  scatter-add), so centroids agree to rtol 1e-5 and the row assignment to
  at least 99% (here they come out equal);
- searches run on carried-over state (built in JAX, converted by
  ``models/convert.py``): f32 scores within rtol 1e-5 / atol 1e-6, ids
  equal where the reference scores are distinct and as sets within ties;
- SQ8: the XLA path rounds ``s * (q_scale * row_scale)``, the Pallas kernel
  (and K5) ``(s * row_scale) * q_scale``; each port version matches its own
  reference to rtol 1e-6, and the two orders differ by at most 2 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.ops import ivf as jivf
from advanced_rag_tpu.ops.pallas_ivf import ivf_topk_pallas, ivf_topk_pallas_batch
from advanced_rag_tpu_torch.models.convert import ivf_partitions_from_numpy
from advanced_rag_tpu_torch.ops import ivf as tivf
from advanced_rag_tpu_torch.ops import ivf_kernels as tk

from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np

N, D, NLIST = 2048, 32, 32


def clustered(rng, n=N, d=D, n_clusters=48):
    """Mixture of Gaussians, normalized (tests/test_ivf.py's _clustered)."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3
    which = rng.integers(0, n_clusters, n)
    x = centers[which] + rng.standard_normal((n, d)).astype(np.float32) * 0.4
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = clustered(rng)
    q = x[[3, 99, 700, 2040]] + rng.standard_normal((4, D)).astype(np.float32) * 0.05
    valid = rng.random(N) > 0.25
    return x, q.astype(np.float32), valid


@pytest.fixture(scope="module", params=["float32", "bfloat16", "int8"])
def parts(request, data):
    x, _, _ = data
    # capacity_factor < 1 forces a non-trivial overflow tail
    jp = jivf.build_ivf(x, NLIST, kmeans_iters=6, seed=0, dtype=request.param,
                        capacity_factor=0.9)
    return request.param, jp, ivf_partitions_from_numpy(jp, device="cpu")


def test_build_ivf_matches_jax(parts, data):
    dtype, jp, _ = parts
    x, _, _ = data
    tp = tivf.build_ivf(x, NLIST, kmeans_iters=6, seed=0, dtype=dtype,
                        capacity_factor=0.9, device="cpu")
    np.testing.assert_allclose(to_np(tp.centroids), np.asarray(jp.centroids),
                               rtol=1e-5, atol=1e-6)
    jr, tr = np.asarray(jp.packed_rows), to_np(tp.packed_rows)
    assert jr.shape == tr.shape and jr.shape[1] % 8 == 0

    def partition_of(rows, tail):
        out = np.full(N, -1)
        ls, slots = np.nonzero(rows >= 0)
        out[rows[ls, slots]] = ls
        out[tail[tail >= 0]] = NLIST           # the overflow tail
        return out

    agree = np.mean(partition_of(jr, np.asarray(jp.tail_rows))
                    == partition_of(tr, to_np(tp.tail_rows)))
    assert agree >= 0.99
    assert int((np.asarray(jp.tail_rows) >= 0).sum()) > 0
    same = jr == tr
    np.testing.assert_array_equal(to_np(tp.packed_emb)[same],
                                  np.asarray(jp.packed_emb).astype(np.float32)[same])


@pytest.mark.parametrize("masked", [False, True])
def test_ivf_topk_matches_jax_xla_path(parts, data, masked):
    _, jp, tp = parts
    _, q, valid = data
    v = valid if masked else None
    js, ji = jivf.ivf_topk(jp, jnp.asarray(q), 16,
                           None if v is None else jnp.asarray(v), nprobe=8)
    ts, ti = tivf.ivf_topk(tp, torch.from_numpy(q), 16,
                           None if v is None else torch.from_numpy(v), nprobe=8)
    assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)
    if masked:
        got = to_np(ti)
        assert valid[got[got >= 0]].all()


def test_k5_plain_matches_pallas_batch(parts, data):
    _, jp, tp = parts
    _, q, valid = data
    js, ji = ivf_topk_pallas_batch(jp, jnp.asarray(q), 16, jnp.asarray(valid),
                                   nprobe=8)
    ts, ti = tk.ivf_topk_kernel_batch(tp, torch.from_numpy(q), 16,
                                      torch.from_numpy(valid), nprobe=8)
    assert_scores_close(ts, js, rtol=1e-6, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)


def test_k4_plain_matches_pallas_single(parts, data):
    dtype, jp, tp = parts
    _, q, valid = data
    if dtype == "int8":
        with pytest.raises(ValueError):
            tk.ivf_topk_kernel(tp, torch.from_numpy(q[0]), 8, nprobe=4)
        return
    for row in range(len(q)):
        js, ji = ivf_topk_pallas(jp, jnp.asarray(q[row]), 8, jnp.asarray(valid),
                                 nprobe=8)
        ts, ti = tk.ivf_topk_kernel(tp, torch.from_numpy(q[row]), 8,
                                    torch.from_numpy(valid), nprobe=8)
        assert_scores_close(ts, js, rtol=1e-6, atol=1e-6)
        assert_ids_tie_aware(ti[None], np.asarray(ji)[None], np.asarray(js)[None], 1e-6)


def test_sq8_rounding_orders_differ_by_an_ulp_at_most(data):
    """K5's SQ8 scores round (s * row_scale) * q_scale, the XLA path
    s * (q_scale * row_scale); top-k ids agree where scores are distinct."""
    x, q, _ = data
    jp = jivf.build_ivf(x, NLIST, kmeans_iters=6, seed=0, dtype="int8",
                        capacity_factor=0.9)
    tp = ivf_partitions_from_numpy(jp, device="cpu")
    xs, xi = tivf.ivf_topk(tp, torch.from_numpy(q), 32, nprobe=NLIST)
    ks, ki = tk.ivf_topk_kernel_batch(tp, torch.from_numpy(q), 32, nprobe=NLIST)
    live = to_np(xs) > -1e29
    diff = np.abs(to_np(ks)[live].astype(np.float64) - to_np(xs)[live])
    assert (diff <= 2 * np.spacing(np.abs(to_np(xs)[live]))).all()
    assert_ids_tie_aware(ki, xi, xs, 1e-6)


def test_tiny_corpus_pads_past_nprobe_cap(data):
    """k > nprobe * cap: the port pads with NEG_INF / -1 as the XLA path."""
    x, q, _ = data
    jp = jivf.build_ivf(x[:40], 8, kmeans_iters=4, seed=1, dtype="float32")
    tp = ivf_partitions_from_numpy(jp, device="cpu")
    js, ji = jivf.ivf_topk(jp, jnp.asarray(q), 64, nprobe=2)
    for fn in (tivf.ivf_topk, tk.ivf_topk_kernel_batch):
        ts, ti = fn(tp, torch.from_numpy(q), 64, nprobe=2)
        assert_ids_tie_aware(ti, ji, js, 1e-6)
        assert (to_np(ti)[to_np(ts) <= -1e29] == -1).all()


def test_auto_nlist_and_tune_nprobe_match_jax(data):
    x, q, _ = data
    for n in (1, 100, 65_536, 1_000_000):
        assert tivf.auto_nlist(n) == jivf.auto_nlist(n)
    jp = jivf.build_ivf(x, NLIST, kmeans_iters=6, seed=0, dtype="float32")
    tp = ivf_partitions_from_numpy(jp, device="cpu")
    oracle = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :10]
    want = jivf.tune_nprobe(jp, q, oracle, recall_target=0.95, k=10)
    got = tivf.tune_nprobe(tp, q, oracle, recall_target=0.95, k=10)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1])


def test_kmeans_fit_matches_jax(data):
    x, _, _ = data
    init = jivf.kmeans_init(x, 16, seed=3)
    np.testing.assert_array_equal(tivf.kmeans_init(x, 16, seed=3), init)
    want = np.asarray(jivf.kmeans_fit(jnp.asarray(x), jnp.asarray(init),
                                      nlist=16, iters=5, block=500))
    got = tivf.kmeans_fit(torch.from_numpy(x), torch.from_numpy(init), nlist=16,
                          iters=5, block=500)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-6)
