"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py
import them from here), and the tests of the port's tie-breaking top-k.

Inputs are made with numpy from a seed and handed to both packages; the
outputs come back as numpy.  ``lax.top_k`` breaks ties toward the lower
index and the port's ``topk_first`` does the same, but scores computed in
another order can differ in the last bits, so ids are compared tie-aware:
exactly where the reference scores are distinct, as sets within a run of
scores equal to ``tol``, and only by score in a run that the k-th slot cuts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from advanced_rag_tpu_torch.ops.dense import topk_first


def to_np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def assert_ids_tie_aware(got_ids, want_ids, want_scores, tol):
    got_ids, want_ids = to_np(got_ids), to_np(want_ids)
    want_scores = to_np(want_scores).astype(np.float64)
    assert got_ids.shape == want_ids.shape
    for g, w, s in zip(got_ids.reshape(-1, got_ids.shape[-1]),
                       want_ids.reshape(-1, want_ids.shape[-1]),
                       want_scores.reshape(-1, want_scores.shape[-1])):
        k = len(w)
        start = 0
        while start < k:
            end = start + 1
            while end < k and abs(s[end] - s[end - 1]) <= tol:
                end += 1
            if end < k:         # a run the k-th slot does not cut
                assert set(g[start:end].tolist()) == set(w[start:end].tolist()), (
                    g.tolist(), w.tolist())
            start = end


def assert_scores_close(got, want, rtol, atol):
    np.testing.assert_allclose(to_np(got).astype(np.float64),
                               to_np(want).astype(np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_first_breaks_ties_like_lax_top_k(seed):
    rng = np.random.default_rng(seed)
    # few distinct values -> long runs of ties; plus +-inf and the sentinel
    x = rng.choice(np.array([-np.inf, -1e30, -2.5, 0.0, 0.0, 1.0, 3.0, np.inf],
                            np.float32), size=(4, 300))
    for k in (1, 7, 300):
        ws, wi = lax.top_k(jnp.asarray(x), k)
        gs, gi = topk_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(to_np(gi), np.asarray(wi))
        np.testing.assert_array_equal(to_np(gs), np.asarray(ws))


def test_tie_aware_compare_accepts_swaps_within_runs_only():
    s = np.array([[3.0, 2.0, 2.0, 1.0, 0.5, 0.5]])
    want = np.array([[10, 11, 12, 13, 14, 15]])
    assert_ids_tie_aware(np.array([[10, 12, 11, 13, 15, 99]]), want, s, 1e-6)
    with pytest.raises(AssertionError):
        assert_ids_tie_aware(np.array([[10, 11, 13, 12, 14, 15]]), want, s, 1e-6)
