"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: a fixture skips every test here when no CUDA card is
present.  On a machine with the card (which has no JAX, so the repo's
conftest cannot load), run:

    python -m pytest -o addopts= --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerances: K1 and K3 sum in another order than the plain version's
matmul / reductions, so f32 scores agree to 1e-5 relative to the largest
live score of the call (a dot of 384 terms cancels, so a per-element
relative bound would not hold near 0); masked entries are equal.  K2's
integer dot is exact and its scale and mask round separately, so its
scores are bit-identical to the plain version's.
"""

import numpy as np
import pytest
import torch

from advanced_rag_tpu_torch.ops import dense_kernels as dk
from advanced_rag_tpu_torch.ops import sparse_kernels as sk
from advanced_rag_tpu_torch.ops.dense import NEG_INF, mask_additive
from advanced_rag_tpu_torch.ops.quant import sq8_quantize

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100 (see module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_rel_close(got, want, tol=1e-5):
    live = want > NEG_INF / 2
    assert torch.equal(got[~live], want[~live])
    if bool(live.any()):
        scale = max(float(want[live].abs().max()), 1e-30)
        err = float((got[live] - want[live]).abs().max())
        assert err <= tol * scale, (err, scale)


def _mask(n, rng, dev, dead=0.3):
    valid = torch.from_numpy(rng.random(n) > dead).to(dev)
    return mask_additive(valid, n, dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,n,d", [(1, 1000, 384), (3, 4097, 384),
                                    (32, 2000, 384), (40, 777, 384),
                                    (5, 513, 36), (2, 9, 7)])
def test_k1_matches_plain(cuda, dtype, nq, n, d):
    rng = np.random.default_rng(nq * 1000 + n + d)
    rows = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(cuda).to(dtype)
    q = torch.from_numpy(rng.standard_normal((nq, d), np.float32)).to(cuda)
    m = _mask(n, rng, cuda)
    before = dk.dense_scores.launches
    got = dk.dense_scores(q, rows, m)
    torch.cuda.synchronize()
    assert dk.dense_scores.launches > before
    want = dk.dense_scores_plain(q, rows, m)
    assert_rel_close(got, want)


@pytest.mark.parametrize("nq,n,d", [(1, 1000, 384), (8, 4097, 384),
                                    (32, 2000, 384), (33, 100, 384),
                                    (4, 300, 20)])
def test_k2_is_bit_identical_to_plain(cuda, nq, n, d):
    rng = np.random.default_rng(nq + n + d)
    x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(cuda)
    codes, scale = sq8_quantize(x)
    q_codes, _ = sq8_quantize(torch.from_numpy(
        rng.standard_normal((nq, d), np.float32)).to(cuda))
    m = _mask(n, rng, cuda)
    before = dk.sq8_scores.launches
    got = dk.sq8_scores(q_codes, codes, scale, m)
    torch.cuda.synchronize()
    assert dk.sq8_scores.launches > before
    want = dk.sq8_scores_plain(q_codes, codes, scale, m)
    assert torch.equal(got, want)


def test_k2_rejects_d_not_divisible_by_4(cuda):
    codes = torch.zeros((8, 6), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        dk.sq8_scores(codes[:1], codes, torch.ones(8, device=cuda),
                      torch.zeros(8, device=cuda))


def test_k1_rejects_wrong_dtype(cuda):
    rows = torch.zeros((8, 16), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        dk.dense_scores(torch.zeros((1, 16), device=cuda), rows,
                        torch.zeros(8, device=cuda))


def _sparse_inputs(rng, nq, t, p, n, vocab, dev):
    idx = rng.integers(0, vocab, size=(p, n)).astype(np.int32)
    idx[rng.random((p, n)) < 0.5] = -1          # padding slots anywhere
    tf = rng.integers(1, 5, size=(p, n)).astype(np.float32)
    q_idx = rng.integers(0, vocab, size=(nq, t)).astype(np.int32)
    q_idx[:, t // 2:] = -1
    q_w = np.where(q_idx >= 0, rng.random((nq, t)), 0.0).astype(np.float32)
    dlen = rng.integers(1, 200, size=n).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return to(q_idx), to(q_w), to(idx), to(tf), to(dlen)


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
@pytest.mark.parametrize("nq,t,p,n", [(1, 32, 256, 3000), (32, 32, 64, 1000),
                                      (40, 8, 16, 257), (3, 1, 1, 5)])
def test_k3_matches_plain(cuda, scoring, nq, t, p, n):
    rng = np.random.default_rng(nq + t + p + n)
    q_idx, q_w, idx, tf, dlen = _sparse_inputs(rng, nq, t, p, n, 64, cuda)
    m = _mask(n, rng, cuda)
    before = sk.bm25_scores.launches
    got = sk.bm25_scores(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75, 73.5, scoring)
    torch.cuda.synchronize()
    assert sk.bm25_scores.launches > before
    want = sk.bm25_scores_plain(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75,
                                73.5, scoring)
    assert_rel_close(got, want)


def test_topk_wrappers_match_plain_ids(cuda):
    rng = np.random.default_rng(7)
    n, d = 5000, 384
    x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((4, d), np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random(n) > 0.5).to(cuda)
    s, i = dk.dense_topk_kernel(x.to(torch.bfloat16), q, 10, valid)
    ps, pi = dk.dense_topk_kernel(x.to(torch.bfloat16).cpu(), q.cpu(), 10,
                                  valid.cpu())
    assert_rel_close(s.cpu(), ps)
    assert torch.equal(i.cpu(), pi)
    assert bool((s > NEG_INF).all())
