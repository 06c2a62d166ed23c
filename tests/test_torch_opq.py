"""The port's OPQ (advanced_rag_tpu_torch/ops/pq.py:opq_train, the rotation
in DenseIndex, the manager's hybrid PQ rung and build_semantic, and
utils/checkpoint.py) against the JAX package's on the CPU, on the same
seeded numpy inputs.

``opq_train`` alternates Lloyd's k-means and a Procrustes solve, and the
port's Lloyd's sums run in another order (``index_add_`` against XLA's
one-hot einsum; codebooks agree to rtol 1e-5 and codes on 99% of the
pairs, tests/test_torch_pq.py), so after a few rounds the two rotations
are different solutions of the same problem.  After one round they are
not yet: there the port's distortion is held to JAX's within 1e-3 relative
(seeds 0-3 read 2e-7 to 1.9e-5 apart).  After six rounds the port's
rotation is held to orthogonality (atol 1e-4), to JAX's distortion within
1e-2 relative (seeds 0-3 read 2.4e-4, 3.8e-3, 4.8e-4 and 8.1e-4 apart),
and to beating flat PQ by the margin the JAX test asks.  Everything after training runs on the
JAX rotation and codebooks carried over, and must then match exactly: the
rotated codes equal, scores to rtol 1e-5 / atol 1e-6, ids tie-aware, hybrid
rankings equal (tests/test_torch_pipeline.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.config import IndexConfig as JIndexConfig
from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
from advanced_rag_tpu.index.dense_index import DenseIndex as JDense
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.ops import pq as jpq
from advanced_rag_tpu.utils import checkpoint as jckpt
from advanced_rag_tpu_torch.config import IndexConfig, IndexType, PipelineConfig
from advanced_rag_tpu_torch.index.corpus import ChunkRecord
from advanced_rag_tpu_torch.index.dense_index import DenseIndex
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.convert import hashing_from_numpy, pq_from_numpy
from advanced_rag_tpu_torch.ops import pq as tpq
from advanced_rag_tpu_torch.utils import checkpoint as tckpt

from test_torch_checkpoint import QUERIES, TEXTS, assert_same_files, hits
from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np
from test_torch_pipeline import assert_same_ranking

DIM = 64


def anisotropic(seed, n=4000, d=DIM):
    """Correlated rows (a projection with decaying column scales), as the
    JAX test's: the geometry where a rotation pays."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((d, d)).astype(np.float32) * (0.9 ** np.arange(d))[None, :]
    x = rng.standard_normal((n, d)).astype(np.float32) @ proj
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def distortion(rot, cb, x):
    xr = x @ rot
    codes = torch.from_numpy(tpq.pq_encode(xr, cb))
    return float(np.mean((to_np(tpq.pq_decode(cb, codes)) - xr) ** 2))


def opq_distortions(x, opq_iters):
    """(the port's, JAX's) distortion of their own opq_train on ``x``."""
    jr, jcb = jpq.opq_train(x, bits=4, train_sample=4000, seed=1, opq_iters=opq_iters)
    tr, tcb = tpq.opq_train(x, bits=4, train_sample=4000, seed=1, opq_iters=opq_iters,
                            device="cpu")
    jcb_t, _ = pq_from_numpy(jcb.codebooks, np.zeros((1, jcb.m), np.int8), m=jcb.m,
                             bits=4, device="cpu")
    return distortion(to_np(tr), tcb, x), distortion(np.asarray(jr), jcb_t, x)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_opq_one_round_distortion_matches_jax(seed):
    """One alternation round, where the two have not yet drifted apart."""
    e_port, e_jax = opq_distortions(anisotropic(seed), 1)
    assert abs(e_port - e_jax) <= 1e-3 * e_jax, (e_port, e_jax)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_opq_train_matches_jax(seed):
    x = anisotropic(seed)
    jr, jcb = jpq.opq_train(x, bits=4, train_sample=4000, seed=1, opq_iters=6)
    tr, tcb = tpq.opq_train(x, bits=4, train_sample=4000, seed=1, opq_iters=6, device="cpu")
    r = to_np(tr)
    assert r.shape == (DIM, DIM) and (tcb.m, tcb.bits) == (jcb.m, 4)
    np.testing.assert_allclose(r @ r.T, np.eye(DIM), atol=1e-4)
    jcb_t, _ = pq_from_numpy(jcb.codebooks, np.zeros((1, jcb.m), np.int8), m=jcb.m,
                             bits=4, device="cpu")
    e_port, e_jax = distortion(r, tcb, x), distortion(np.asarray(jr), jcb_t, x)
    assert abs(e_port - e_jax) <= 1e-2 * e_jax, (e_port, e_jax)
    flat = tpq.pq_train(x, bits=4, train_sample=4000, seed=1, device="cpu")
    assert e_port < distortion(np.eye(DIM, dtype=np.float32), flat, x) * 0.85


def test_opq_train_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpq.opq_train(anisotropic(0, n=300), opq_iters=1)


def indexes():
    return (JDense(JIndexConfig(dim=DIM, dtype="pq", min_capacity=64, pq_opq=True)),
            DenseIndex(IndexConfig(dim=DIM, dtype="pq", min_capacity=64, pq_opq=True),
                       device="cpu"))


def carry(jsem, tsem):
    """JAX's rotation, codebooks and codes into the port's index."""
    tsem._pq, tsem.emb = pq_from_numpy(jsem._pq.codebooks, np.asarray(jsem.emb),
                                       m=jsem._pq.m, bits=jsem._pq.bits, device="cpu")
    tsem._pq_rot = torch.from_numpy(np.array(jsem._pq_rot, np.float32))


def test_rotated_encode_and_search_match_jax():
    """The port's own build trains a rotation and swaps to rotated codes;
    with JAX's rotation and codebooks carried over, the port re-encodes
    the same codes (the block rotated in f32 after the bf16 staging),
    encodes appended rows alike, and searches as JAX (q R for the codes,
    the exact refine in the original space)."""
    x = anisotropic(5, n=600)
    q = x[[3, 100, 599]] + np.random.default_rng(1).standard_normal((3, DIM)).astype(
        np.float32) * 0.05
    jidx, tidx = indexes()
    for idx in (jidx, tidx):
        idx.append(0, x[:500])
        idx.build_pq()
    assert tidx._pq_rot is not None and tidx.emb.shape == (tidx.capacity, tidx._pq.m)
    assert tidx.emb.dtype == torch.int8
    carry(jidx, tidx)
    codes = np.asarray(jidx.emb)
    tidx._pq_reencode_all()
    np.testing.assert_array_equal(to_np(tidx.emb)[:500], codes[:500])
    want = jpq.pq_encode_device(jnp.asarray(x[:64], jnp.bfloat16), jidx._pq.codebooks,
                                jidx._pq_rot)
    got = tpq.pq_encode_device(torch.from_numpy(x[:64]).to(torch.bfloat16),
                               tidx._pq.codebooks, tidx._pq_rot)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    for idx in (jidx, tidx):
        idx.append(500, x[500:])
    np.testing.assert_array_equal(to_np(tidx.emb)[:600], np.asarray(jidx.emb)[:600])
    for k in (1, 10):
        js, ji = jidx.search(q, k)
        ts, ti = tidx.search(q, k)
        assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
        assert_ids_tie_aware(ti, ji, js, 1e-6)
    # the raw rotated-code ranks (no refine) too
    jidx.config.refine_factor = tidx.config.refine_factor = 1
    js, ji = jidx.search(q, 10)
    ts, ti = tidx.search(q, 10)
    assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)
    assert tidx.memory_bytes() == jidx.memory_bytes()


def managers():
    cfg = dict(semantic_dtype="pq", semantic_opq=True, semantic_dim=DIM)
    jmgr = JManager(JConfig(**cfg))
    tmgr = MultiIndexManager(
        PipelineConfig(**cfg),
        embedder=hashing_from_numpy(np.asarray(jmgr.embedder._proj), device="cpu"),
        device="cpu")
    return jmgr, tmgr


def fill(jmgr, tmgr):
    for mgr, cls in ((jmgr, JRecord), (tmgr, ChunkRecord)):
        rep = mgr.index_chunks([cls(chunk_id=f"c{i}", doc_id=f"d{i // 4}", content=t)
                                for i, t in enumerate(TEXTS)])
        assert rep["indexed"] == len(TEXTS)


def test_hybrid_pq_rung_under_opq_and_the_build_semantic_skip():
    """build_semantic(pq, ivf) trains the rotated codes and skips IVF-PQ in
    both managers; the hybrid PQ rung scores q R, while the cached query,
    the exact re-scores and MMR keep the original space."""
    jmgr, tmgr = managers()
    fill(jmgr, tmgr)
    want = jmgr.build_semantic(pq=True, ivf=True)
    assert tmgr.build_semantic(pq=True, ivf=True) == want == {
        "pq_built": True, "ivf_skipped": "opq rotation active"}
    assert tmgr.semantic._pq_rot is not None and not tmgr.semantic.has_ivfpq
    carry(jmgr.semantic, tmgr.semantic)
    # the default deep refine re-scores exactly; refine 1 fuses the raw
    # rotated-code ranks, which only q R gets right
    for refine in (0, 1):
        for mgr in (jmgr, tmgr):
            mgr.semantic.config.refine_factor = refine
        got = tmgr.hybrid_search_batch_sync(QUERIES, 10)
        for g, w in zip(got, jmgr.hybrid_search_batch_sync(QUERIES, 10)):
            assert g
            assert_same_ranking(hits(g), hits(w), 1e-6, 0.0)
    # the cache holds the normalized query itself, not q R
    cached = tmgr._semantic_cache.get_sync(QUERIES[0], tmgr._sem_ns)
    q0 = to_np(tmgr.embedder.encode_device([QUERIES[0]]))[0]
    np.testing.assert_allclose(cached, q0 / np.linalg.norm(q0), rtol=0, atol=1e-6)
    for qt in QUERIES[:4]:
        a = tmgr.search_sync(IndexType.SEMANTIC, qt, 8)
        b = jmgr.search_sync("semantic", qt, 8)
        assert a
        assert_same_ranking(hits(a), hits(b), 1e-5, 1e-6)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_opq_checkpoint_loads_both_ways(tmp_path, direction):
    """The rotation travels as dense_semantic_opq.npy with "opq": true; the
    loader re-encodes through it and searches as the saver; written back
    by the port, the files are the ones JAX writes."""
    jmgr, tmgr = managers()
    fill(jmgr, tmgr)
    fresh_j, fresh_t = managers()
    if direction == "jax->port":
        jmgr.build_semantic(pq=True)
        jckpt.save_index(jmgr, tmp_path / "a")
        tckpt.load_index(fresh_t, tmp_path / "a")
        port, jax = fresh_t, jmgr
        assert port.semantic._pq_rot is not None
        np.testing.assert_array_equal(to_np(port.semantic._pq_rot),
                                      np.asarray(jmgr.semantic._pq_rot))
        np.testing.assert_array_equal(to_np(port.semantic.emb), np.asarray(jmgr.semantic.emb))
    else:
        tmgr.build_semantic(pq=True)
        manifest = tckpt.save_index(tmgr, tmp_path / "a")
        assert manifest["dense"]["semantic"]["pq"]["opq"] is True
        jckpt.load_index(fresh_j, tmp_path / "a")
        port, jax = tmgr, fresh_j
        np.testing.assert_array_equal(np.asarray(jax.semantic._pq_rot),
                                      to_np(tmgr.semantic._pq_rot))
    for a, b in zip(port.hybrid_search_batch_sync(QUERIES, 10),
                    jax.hybrid_search_batch_sync(QUERIES, 10)):
        assert_same_ranking(hits(a), hits(b), 1e-6, 0.0)
    for qt in QUERIES[:4]:
        assert_same_ranking(hits(port.search_sync(IndexType.SEMANTIC, qt, 8)),
                            hits(jax.search_sync("semantic", qt, 8)), 1e-5, 1e-6)
    tckpt.save_index(port, tmp_path / "b")
    jckpt.save_index(jax, tmp_path / "c")
    assert_same_files(tmp_path / "b", tmp_path / "c")
