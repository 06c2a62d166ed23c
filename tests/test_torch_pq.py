"""The port's PQ tier (advanced_rag_tpu_torch/ops/pq.py, ops/pq_kernels.py)
against the JAX package's ops/pq.py on the CPU.

Inputs come from numpy with a seed.  The JAX ``pq_topk`` runs with
``reduce="exact"`` and both ADC implementations: ``impl="xla"`` (the
one-hot matmul) and ``impl="pallas"`` (kernel K6 in interpret mode); the
port's ``pq_scores`` wrapper takes its plain version, the one-hot matmul,
on CPU tensors.

Tolerances:
- training: Lloyd's sums in another order (``index_add_`` against XLA's
  one-hot einsum), so codebooks agree to rtol 1e-5 / atol 1e-6 and the
  codes each package's own codebooks give agree on at least 99% of the
  (row, subspace) pairs;
- searches on carried-over state (codebooks and codes built in JAX): the
  table is rounded to bf16 at the same place in both, and the f32 sums of
  m terms run in another order, so scores agree to atol 1e-6 and ids are
  equal where the reference scores are distinct, as sets within ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.ops import pq as jpq
from advanced_rag_tpu_torch.models.convert import pq_from_numpy
from advanced_rag_tpu_torch.ops import pq as tpq
from advanced_rag_tpu_torch.ops import pq_kernels as tpk

from test_torch_ivf import clustered
from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np

N, D, M = 3000, 32, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    x = clustered(rng, n=N, d=D)
    q = x[[0, 17, 1500, 2999, 42]] + rng.standard_normal((5, D)).astype(np.float32) * 0.05
    valid = rng.random(N) > 0.2
    jcb = jpq.pq_train(x, M, 4, iters=6, seed=0)
    codes = jpq.pq_encode(x, jcb)
    return x, q.astype(np.float32), valid, jcb, codes


def test_pq_train_and_encode_match_jax(data):
    x, _, _, jcb, jcodes = data
    tcb = tpq.pq_train(x, M, 4, iters=6, seed=0, device="cpu")
    assert (tcb.m, tcb.bits, tcb.c, tcb.dsub, tcb.dim) == (M, 4, 16, D // M, D)
    np.testing.assert_allclose(to_np(tcb.codebooks), np.asarray(jcb.codebooks),
                               rtol=1e-5, atol=1e-6)
    assert np.mean(tpq.pq_encode(x, tcb) == jcodes) >= 0.99
    # on the same codebooks the codes are equal (rows rounded to bf16 first)
    same_cb, _ = pq_from_numpy(jcb.codebooks, jcodes, m=M, bits=4, device="cpu")
    np.testing.assert_array_equal(tpq.pq_encode(x, same_cb), jcodes)
    for dim, bits in ((384, 4), (384, 8), (36, 4), (10, 4)):
        assert tpq.auto_pq_m(dim, bits) == jpq.auto_pq_m(dim, bits)


def test_pq_train_runs_on_the_card_unless_told(data, monkeypatch):
    """pq_train is an entry point: without a card it raises, as every entry
    point does, unless the caller passes device="cpu"."""
    x, _, _, jcb, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpq.pq_train(x, M, 4, iters=6, seed=0)
    tcb = tpq.pq_train(x, M, 4, iters=6, seed=0, device="cpu")
    assert tcb.codebooks.device.type == "cpu"
    np.testing.assert_allclose(to_np(tcb.codebooks), np.asarray(jcb.codebooks),
                               rtol=1e-5, atol=1e-6)


def test_lut_and_decode_match_jax(data):
    _, q, _, jcb, jcodes = data
    cb, codes = pq_from_numpy(jcb.codebooks, jcodes, m=M, bits=4, device="cpu")
    assert_scores_close(tpq.pq_lut(cb, torch.from_numpy(q)),
                        jpq.pq_lut(jcb, jnp.asarray(q)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(to_np(tpq.pq_decode(cb, codes[:50])),
                                  np.asarray(jpq.pq_decode(jcb, jnp.asarray(jcodes[:50]))))
    lut = tpq.pq_lut(cb, torch.from_numpy(q))
    assert_scores_close(tpk.pq_scores(codes[:1024], lut),
                        jpq.pq_scores_xla(jnp.asarray(jcodes[:1024]),
                                          jpq.pq_lut(jcb, jnp.asarray(q))),
                        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_pq_topk_matches_jax(data, impl, masked):
    _, q, valid, jcb, jcodes = data
    cb, codes = pq_from_numpy(jcb.codebooks, jcodes, m=M, bits=4, device="cpu")
    v = valid if masked else None
    # block_size 2048: two superblocks, the second one ragged
    js, ji = jpq.pq_topk(jcb.codebooks, jnp.asarray(jcodes), jnp.asarray(q), 40,
                         None if v is None else jnp.asarray(v), m=M, bits=4,
                         block_size=2048, impl=impl, reduce="exact")
    ts, ti = tpq.pq_topk(cb.codebooks, codes, torch.from_numpy(q), 40,
                         None if v is None else torch.from_numpy(v), m=M, bits=4,
                         block_size=2048)
    assert_scores_close(ts, js, rtol=0, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)
    if masked:
        got = to_np(ti)
        assert valid[got[got >= 0]].all()


def test_pq_topk_pads_past_the_corpus(data):
    _, q, _, jcb, jcodes = data
    cb, codes = pq_from_numpy(jcb.codebooks, jcodes[:30], m=M, bits=4, device="cpu")
    js, ji = jpq.pq_topk(jcb.codebooks, jnp.asarray(jcodes[:30]), jnp.asarray(q), 48,
                         m=M, bits=4, impl="xla", reduce="exact")
    ts, ti = tpq.pq_topk(cb.codebooks, codes, torch.from_numpy(q), 48, m=M, bits=4)
    assert_ids_tie_aware(ti, ji, js, 1e-6)
    assert (to_np(ti)[:, 30:] == -1).all()
