"""The port's IVF-PQ tier (advanced_rag_tpu_torch/ops/ivfpq.py, the IVF-PQ
branches of index/dense_index.py, the PQ branch of the manager's
maintenance tick, the IVF-PQ state of utils/checkpoint.py) against the JAX
package's on the CPU: one test for each of tests/test_ivfpq.py's, on the
same seeded numpy inputs.

Searches run on state the JAX package built, carried over by
``models/convert.py:ivfpq_from_numpy``, so that k-means drift between the
frameworks cannot change partitions or codes; a build's own state is held
to the JAX build's: centroids to rtol 1e-5 (Lloyd's sums in another order),
and with the JAX quantizers given, the packing and the codes exactly.  On
the CPU the ADC (kernel K6's function) is the plain one-hot version, and
the grouping of the probed partitions (each distinct one scored once for
the batch) is held against a per-query gather at several nprobe.

Tolerances: the ADC sums the same bf16 table entries in f32 in another
order, and the centroid term is an f32 product, so scores agree to rtol 1e-5
/ atol 1e-6; ids are equal where the reference scores are distinct and as
sets within ties (tests/test_torch_parity.py).  The maintenance guardrail's
recall, measured on each package's own build, agrees within 0.05, as
tests/test_torch_maintenance.py asks of the IVF tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advanced_rag_tpu.utils.constants as jconst
import advanced_rag_tpu_torch.utils.constants as tconst
from advanced_rag_tpu.config import IndexConfig as JIndexConfig
from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
from advanced_rag_tpu.index.dense_index import DenseIndex as JDense
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.ops import ivfpq as jiv
from advanced_rag_tpu.ops import pq as jpq
from advanced_rag_tpu.ops.dense import dense_topk
from advanced_rag_tpu.utils import checkpoint as jckpt
from advanced_rag_tpu_torch.config import IndexConfig, IndexType, PipelineConfig
from advanced_rag_tpu_torch.index.corpus import ChunkRecord
from advanced_rag_tpu_torch.index.dense_index import DenseIndex
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.convert import (hashing_from_numpy, ivfpq_from_numpy,
                                                   pq_from_numpy)
from advanced_rag_tpu_torch.ops import ivfpq as tiv
from advanced_rag_tpu_torch.ops import pq as tpq
from advanced_rag_tpu_torch.utils import checkpoint as tckpt

from test_torch_checkpoint import QUERIES, hits
from test_torch_parity import assert_ids_tie_aware, assert_scores_close, to_np
from test_torch_pipeline import assert_same_ranking

NLIST, M = 128, 16


def clustered(rng, n=6000, d=64, n_clusters=512, noise=0.05):
    """Many tight clusters (more than one 16-entry codebook spans): the
    JAX tests' corpus, where flat PQ starves and residual codes do not."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    pts = centers[rng.integers(0, n_clusters, n)] + \
        noise * rng.standard_normal((n, d)).astype(np.float32)
    return (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    pts = clustered(rng)
    q = pts[rng.integers(0, len(pts), 8)] + \
        0.05 * rng.standard_normal((8, pts.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jidx = jiv.build_ivfpq(pts, nlist=NLIST, train_sample=6000, seed=1)
    return pts, q.astype(np.float32), jidx, ivfpq_from_numpy(jidx, device="cpu")


def both(jidx, tidx, q, k, valid=None, *, nprobe, m=M):
    """The JAX and the port's search on the same state -> numpy pairs."""
    js, ji = jiv.ivfpq_topk(jidx, jnp.asarray(q), k,
                            None if valid is None else jnp.asarray(valid),
                            nprobe=nprobe, m=m, bits=4)
    ts, ti = tiv.ivfpq_topk(tidx, torch.from_numpy(q), k,
                            None if valid is None else torch.from_numpy(valid),
                            nprobe=nprobe, m=m, bits=4)
    assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)
    return (to_np(ts), to_np(ti)), (np.asarray(js), np.asarray(ji))


def recall(got, want, k):
    return np.mean([len(set(g[g >= 0]) & set(w)) / k for g, w in zip(got, want)])


def test_build_matches_jax(built):
    """The port's own build: centroids and residual codebooks as JAX's
    (rtol 1e-5); with JAX's centroids, its residual codebooks from the same
    generator; with both quantizers given, the same packing and codes."""
    pts, _, jidx, _ = built
    tidx = tiv.build_ivfpq(pts, nlist=NLIST, train_sample=6000, seed=1, device="cpu")
    np.testing.assert_allclose(to_np(tidx.centroids), np.asarray(jidx.centroids),
                               rtol=1e-5, atol=1e-6)
    cb = tiv.build_ivfpq(pts, nlist=NLIST, train_sample=6000, seed=1, device="cpu",
                         centroids=np.asarray(jidx.centroids)).codebooks
    np.testing.assert_allclose(to_np(cb), np.asarray(jidx.codebooks), rtol=1e-5, atol=1e-6)
    same = tiv.build_ivfpq(pts, nlist=NLIST, seed=1, device="cpu",
                           centroids=np.asarray(jidx.centroids),
                           codebooks=np.asarray(jidx.codebooks))
    for name in jiv.IVFPQIndex._fields:
        np.testing.assert_array_equal(to_np(getattr(same, name)),
                                      np.asarray(getattr(jidx, name)), err_msg=name)
    assert same.packed_codes.dtype == torch.int8
    assert same.packed_rows.shape[1] == max(8, int(np.ceil(2.0 * len(pts) / NLIST)))


def test_full_probe_candidate_recall(built):
    pts, q, jidx, tidx = built
    _, ei = dense_topk(jnp.asarray(pts), jnp.asarray(q), 10, metric="ip")
    (_, ti), _ = both(jidx, tidx, q, 40, nprobe=NLIST)
    assert recall(ti, np.asarray(ei), 10) >= 0.95


def test_residual_beats_flat_pq(built):
    pts, q, jidx, tidx = built
    _, ei = dense_topk(jnp.asarray(pts), jnp.asarray(q), 10, metric="ip")
    flat = tpq.pq_train(pts, bits=4, train_sample=4096, seed=1, device="cpu")
    fcodes = torch.from_numpy(tpq.pq_encode(pts, flat))
    _, fi = tpq.pq_topk(flat.codebooks, fcodes, torch.from_numpy(q), 10, m=flat.m, bits=4)
    (_, ri), _ = both(jidx, tidx, q, 10, nprobe=NLIST)
    r_flat, r_res = recall(to_np(fi), np.asarray(ei), 10), recall(ri, np.asarray(ei), 10)
    assert r_res > r_flat, (r_res, r_flat)
    assert r_res >= 0.85, r_res


def test_nprobe_bounds_work(built):
    pts, q, jidx, tidx = built
    _, ei = dense_topk(jnp.asarray(pts), jnp.asarray(q), 10, metric="ip")
    (_, small), _ = both(jidx, tidx, q, 10, nprobe=4)
    (_, full), _ = both(jidx, tidx, q, 10, nprobe=NLIST)
    assert recall(full, np.asarray(ei), 10) >= recall(small, np.asarray(ei), 10)
    assert recall(small, np.asarray(ei), 10) > 0.2


@pytest.mark.parametrize("nprobe", [1, 4, 32, NLIST])
def test_grouped_adc_is_each_querys_own_probes(built, nprobe):
    """The ADC of the batch's distinct probed partitions, gathered back
    per query (the whole packed table when every partition is probed), is
    the ADC of each query's own probes in its probe order, to f32
    rounding (a one-row product may sum in another order)."""
    _, q, _, tidx = built
    qt = torch.from_numpy(q)
    _, probe = tiv.topk_first(qt @ tidx.centroids.T, nprobe)
    lut = tpq.pq_lut(tiv.ivfpq_codebook(tidx, bits=4), qt)
    got = tiv._probed_adc(tidx, lut, probe, 4)
    cap = tidx.packed_codes.shape[1]
    for i in range(q.shape[0]):
        own = tidx.packed_codes[probe[i].long()].reshape(nprobe * cap, M)
        want = tpq.pq_scores_xla(own, lut[i: i + 1])[0].reshape(nprobe, cap)
        torch.testing.assert_close(got[i], want, rtol=1e-6, atol=1e-6)


def test_score_decomposition_exact(built):
    """A packed row's score is q . (centroid + decoded residual), the
    table rounded to bf16 (within 1e-2, as the JAX test), and the port's
    score is JAX's."""
    pts, q, jidx, tidx = built
    (s, i), _ = both(jidx, tidx, q, 5, nprobe=NLIST)
    cent, cbs = to_np(tidx.centroids), to_np(tidx.codebooks)
    pc, prows = to_np(tidx.packed_codes), to_np(tidx.packed_rows)
    where = {int(r): (p, sl) for p in range(prows.shape[0])
             for sl, r in enumerate(prows[p]) if r >= 0}
    checked = 0
    for qi in range(2):
        for j in range(3):
            if int(i[qi, j]) not in where:
                continue
            p, sl = where[int(i[qi, j])]
            rec = cbs[np.arange(M), pc[p, sl].astype(int)].reshape(-1)
            assert abs(float(q[qi] @ (cent[p] + rec)) - s[qi, j]) < 1e-2
            checked += 1
    assert checked


def test_validity_mask(built):
    pts, q, jidx, tidx = built
    (_, i_all), _ = both(jidx, tidx, q, 5, nprobe=NLIST)
    banned = set(i_all.reshape(-1).tolist()) - {-1}
    valid = np.ones((len(pts),), bool)
    valid[list(banned)] = False
    (_, i), _ = both(jidx, tidx, q, 5, valid, nprobe=NLIST)
    assert (set(i.reshape(-1).tolist()) - {-1}).isdisjoint(banned)


def test_all_masked_returns_minus_one(built):
    pts, q, jidx, tidx = built
    valid = np.zeros((len(pts),), bool)
    (s, i), _ = both(jidx, tidx, q, 5, valid, nprobe=8)
    assert np.all(i == -1)


def test_append_tail_searchable(built):
    """Appended rows are assigned and residual-encoded as JAX encodes them
    (the same tail), and a query at a fresh vector finds it."""
    pts, q, jidx, tidx = built
    rng = np.random.default_rng(7)
    fresh = clustered(rng, n=32)
    rows = np.arange(len(pts), len(pts) + 32, dtype=np.int32)
    fill = int((to_np(tidx.tail_rows) >= 0).sum())
    j2 = jiv.ivfpq_append_tail(jidx, jnp.asarray(fresh), jnp.asarray(rows), fill)
    t2 = tiv.ivfpq_append_tail(ivfpq_from_numpy(jidx, device="cpu"), torch.from_numpy(fresh),
                               torch.from_numpy(rows), fill)
    for name in ("tail_codes", "tail_rows", "tail_assign"):
        np.testing.assert_array_equal(to_np(getattr(t2, name)), np.asarray(getattr(j2, name)))
    (_, i), _ = both(j2, t2, fresh[:4], 3, nprobe=NLIST)
    for r in range(4):
        assert rows[r] in i[r], (rows[r], i[r])


def test_append_tail_growth():
    rng = np.random.default_rng(3)
    pts = clustered(rng, n=500, d=32, n_clusters=8)
    jidx = jiv.build_ivfpq(pts, nlist=8, train_sample=500, tail_capacity=8)
    tidx = tiv.build_ivfpq(pts, nlist=8, train_sample=500, tail_capacity=8, device="cpu",
                           centroids=np.asarray(jidx.centroids),
                           codebooks=np.asarray(jidx.codebooks))
    fill = int((to_np(tidx.tail_rows) >= 0).sum())
    assert fill == int(np.sum(np.asarray(jidx.tail_rows) >= 0))
    fresh = rng.standard_normal((64, 32)).astype(np.float32)
    fresh /= np.linalg.norm(fresh, axis=1, keepdims=True)
    rows = np.arange(1000, 1064, dtype=np.int32)
    j2 = jiv.ivfpq_append_tail(jidx, jnp.asarray(fresh), jnp.asarray(rows), fill)
    t2 = tiv.ivfpq_append_tail(tidx, torch.from_numpy(fresh), torch.from_numpy(rows), fill)
    assert t2.tail_codes.shape[0] == j2.tail_codes.shape[0] >= fill + 64   # doubled
    np.testing.assert_array_equal(to_np(t2.tail_rows), np.asarray(j2.tail_rows))
    (_, i), _ = both(j2, t2, fresh[:2], 2, nprobe=8, m=8)
    assert rows[0] in i[0]


def test_tiny_corpus_k_exceeds_rows():
    rng = np.random.default_rng(4)
    pts = clustered(rng, n=20, d=16, n_clusters=2)
    jidx = jiv.build_ivfpq(pts, nlist=2, train_sample=20)
    (s, i), _ = both(jidx, ivfpq_from_numpy(jidx, device="cpu"), pts[:2], 50,
                     nprobe=2, m=4)
    assert np.sum(i[0] >= 0) == 20 and len(set(i[0][i[0] >= 0].tolist())) == 20
    assert (i[:, 20:] == -1).all()


# -- DenseIndex / manager / checkpoint ------------------------------------------------

def dense_indexes(**kw):
    return (JDense(JIndexConfig(dim=32, dtype="pq", min_capacity=64, **kw)),
            DenseIndex(IndexConfig(dim=32, dtype="pq", min_capacity=64, **kw), device="cpu"))


def carry(jsem, tsem):
    """The JAX index's PQ and IVF-PQ state into the port's index."""
    if jsem._pq is not None:
        tsem._pq, tsem.emb = pq_from_numpy(jsem._pq.codebooks, np.asarray(jsem.emb),
                                           m=jsem._pq.m, bits=jsem._pq.bits, device="cpu")
    tsem._ivfpq = None if jsem._ivfpq is None else ivfpq_from_numpy(jsem._ivfpq,
                                                                     device="cpu")
    tsem._ivfpq_size, tsem._ivfpq_fill = jsem._ivfpq_size, jsem._ivfpq_fill
    tsem.config.nprobe = jsem.config.nprobe


def assert_same_search(jidx, tidx, q, k):
    js, ji = jidx.search(q, k)
    ts, ti = tidx.search(q, k)
    assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)
    return to_np(ti)


@pytest.mark.parametrize("flat", [True, False])
def test_dense_index_ivfpq_lifecycle(flat):
    """build_pq (or not) + build_ivf -> IVF-PQ; search with the exact
    refine; appends land in the residual-coded tail from the bf16-staged
    rows, as JAX's do.  ``flat=False`` is JAX's test of IVF-PQ reached
    without flat codebooks: appends must still be searched."""
    rng = np.random.default_rng(11 if flat else 17)
    pts = clustered(rng, n=800, d=32, n_clusters=64)
    jidx, tidx = dense_indexes()
    for idx in (jidx, tidx):
        idx.append(0, pts)
        if flat:
            idx.build_pq()
    jidx.build_ivf(nlist=32)
    tidx.build_ivf(nlist=32)
    assert tidx.has_ivfpq and tidx.has_pq == flat
    assert tuple(tidx._ivfpq.packed_codes.shape) == jidx._ivfpq.packed_codes.shape
    jidx.config.nprobe = 32
    carry(jidx, tidx)
    i = assert_same_search(jidx, tidx, pts[:4], 5)
    assert (i[:, 0] == np.arange(4)).all()
    fresh = rng.standard_normal((16, 32)).astype(np.float32)
    for idx in (jidx, tidx):
        idx.append(800, fresh)
    assert tidx._ivfpq_fill == jidx._ivfpq_fill >= 16
    np.testing.assert_array_equal(to_np(tidx._ivfpq.tail_codes),
                                  np.asarray(jidx._ivfpq.tail_codes))
    i2 = assert_same_search(jidx, tidx, fresh[:2], 3)
    assert i2[0, 0] == 800 and i2[1, 0] == 801
    assert tidx.ivf_tail_rows == jidx.ivf_tail_rows == 16
    assert tidx.ivf_needs_rebuild == jidx.ivf_needs_rebuild
    assert tidx.memory_bytes() == jidx.memory_bytes()


def test_tune_nprobe_ivfpq():
    rng = np.random.default_rng(12)
    pts = clustered(rng, n=2000, d=32, n_clusters=128)
    jidx, tidx = dense_indexes()
    for idx in (jidx, tidx):
        idx.append(0, pts)
        idx.build_pq()
    jidx.build_ivfpq(nlist=64)
    tidx.build_ivfpq(nlist=64)
    carry(jidx, tidx)
    want = jidx.tune_nprobe(recall_target=0.9, k=5, sample=32)
    got = tidx.tune_nprobe(recall_target=0.9, k=5, sample=32)
    assert got[0] == want[0] == tidx.config.nprobe
    assert got[1] == pytest.approx(want[1], abs=1e-9)
    assert got[1] >= 0.9 or got[0] == 64


def test_build_ivfpq_refuses_opq_and_other_tiers():
    rng = np.random.default_rng(5)
    pts = clustered(rng, n=200, d=32, n_clusters=16)
    _, opq = dense_indexes(pq_opq=True)
    opq.append(0, pts)
    opq.build_pq()
    with pytest.raises(ValueError, match="OPQ"):
        opq.build_ivfpq(nlist=8)
    flat = DenseIndex(IndexConfig(dim=32, dtype="bfloat16", min_capacity=64), device="cpu")
    flat.append(0, pts)
    with pytest.raises(ValueError, match='dtype="pq"'):
        flat.build_ivfpq(nlist=8)


# -- the manager: maintenance and checkpoints, as tests/test_torch_maintenance.py ---

def managers(monkeypatch, threshold, n, **cfg):
    for mod in (jconst, tconst):
        monkeypatch.setattr(mod.IndexConstants, "IVF_AUTO_THRESHOLD", threshold)
    jmgr = JManager(JConfig(semantic_dtype="pq", **cfg))
    tmgr = MultiIndexManager(
        PipelineConfig(semantic_dtype="pq", **cfg),
        embedder=hashing_from_numpy(np.asarray(jmgr.embedder._proj), device="cpu"),
        device="cpu")
    texts = [f"chunk {j} about tpu sharding topic {j % 7} row {j % 11}" for j in range(n)]
    for mgr, cls in ((jmgr, JRecord), (tmgr, ChunkRecord)):
        assert mgr.index_chunks([cls(chunk_id=f"c{j}", doc_id=f"d{j % 3}", content=t)
                                 for j, t in enumerate(texts)])["indexed"] == n
    return jmgr, tmgr


def test_manager_maintenance_builds_ivfpq(monkeypatch):
    jmgr, tmgr = managers(monkeypatch, 32, 48)
    got, want = tmgr.maintenance_tick(), jmgr.maintenance_tick()
    assert got.pop("demotion_recall") == pytest.approx(want.pop("demotion_recall"), abs=0.05)
    assert got == want == {"ivf_rebuilt": False, "pq_built": True}
    assert tmgr.semantic.has_pq and tmgr.semantic.has_ivfpq
    assert tmgr.semantic._ivfpq.codebooks.shape == jmgr.semantic._ivfpq.codebooks.shape
    carry(jmgr.semantic, tmgr.semantic)
    a = tmgr.search_sync(IndexType.SEMANTIC, "tpu sharding topic 3", 5)
    b = jmgr.search_sync("semantic", "tpu sharding topic 3", 5)
    assert a
    assert_same_ranking(hits(a), hits(b), 1e-5, 1e-6)
    # past 0.2 of the rows appended: re-packed at the same nlist
    more = [f"appended chunk {j} on topic {j % 5}" for j in range(16)]
    for mgr, cls in ((jmgr, JRecord), (tmgr, ChunkRecord)):
        mgr.index_chunks([cls(chunk_id=f"m{j}", doc_id="d9", content=t)
                          for j, t in enumerate(more)])
    np.testing.assert_array_equal(to_np(tmgr.semantic._ivfpq.tail_codes),
                                  np.asarray(jmgr.semantic._ivfpq.tail_codes))
    assert tmgr.semantic.ivf_needs_rebuild and jmgr.semantic.ivf_needs_rebuild
    nlist = tmgr.semantic._ivfpq.centroids.shape[0]
    got, want = tmgr.maintenance_tick(), jmgr.maintenance_tick()
    assert got == want == {"ivf_rebuilt": True, "ivf_rows": 64}
    assert tmgr.semantic._ivfpq.centroids.shape[0] == nlist
    assert tmgr.semantic.ivf_tail_rows == 0


def test_maintenance_opq_skips_ivfpq(monkeypatch):
    jmgr, tmgr = managers(monkeypatch, 16, 24, semantic_opq=True)
    got, want = tmgr.maintenance_tick(), jmgr.maintenance_tick()
    assert got == want == {"ivf_rebuilt": False, "pq_built": True}
    assert tmgr.semantic.has_pq and tmgr.semantic._pq_rot is not None
    assert not tmgr.semantic.has_ivfpq
    assert tmgr.maintenance_tick() == jmgr.maintenance_tick() == {"ivf_rebuilt": False}
    h = tmgr.hybrid_search_batch_sync(["chunk 7 about tpu sharding topic 0"], 3)[0]
    assert any(x["chunk_id"] == "c7" for x in h)


def test_maintenance_demotion_blocked_on_adversarial_recall(monkeypatch):
    """8 subspaces over 1536 dims at 4 bits and no refine cannot reach
    recall@10 0.999: both ticks refuse, restore every saved field (the bf16
    staging tensor itself) and keep serving; a relaxed target demotes."""
    jmgr, tmgr = managers(monkeypatch, 32, 64)
    for mgr in (jmgr, tmgr):
        sem = mgr.semantic
        sem.config.pq_m, sem.config.refine_factor = 8, 1
        sem.config.demote_recall_target = 0.999
    staged, nprobe = tmgr.semantic.emb, tmgr.semantic.config.nprobe
    got, want = tmgr.maintenance_tick(), jmgr.maintenance_tick()
    assert got["demotion_blocked"]["tier"] == want["demotion_blocked"]["tier"] == "pq+ivfpq"
    assert got["demotion_blocked"]["recall"] < 0.999 and not got.get("pq_built")
    sem = tmgr.semantic
    assert not sem.has_pq and not sem.has_ivfpq and sem._pq_rot is None
    assert sem.emb is staged and sem.config.nprobe == nprobe and sem._ivfpq_size == 0
    assert tmgr.search_sync(IndexType.SEMANTIC, "tpu sharding topic 3", 3)
    sem.config.demote_recall_target = 0.0
    assert tmgr.maintenance_tick().get("pq_built") and sem.has_pq and sem.has_ivfpq


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_checkpoint_roundtrip_ivfpq(monkeypatch, tmp_path, direction):
    """PQ + IVF-PQ saved by either package and loaded by the other: the
    same quantizers, the re-packed partitions, the same search; and written
    back by the port, the same files (manifest, every array)."""
    from test_torch_checkpoint import assert_same_files

    jmgr, tmgr = managers(monkeypatch, 10 ** 9, 40)
    fresh_j, fresh_t = managers(monkeypatch, 10 ** 9, 0)
    if direction == "jax->port":
        saver, loader, save, load = jmgr, fresh_t, jckpt.save_index, tckpt.load_index
        port, jax = loader, saver
    else:
        saver, loader, save, load = tmgr, fresh_j, tckpt.save_index, jckpt.load_index
        port, jax = saver, loader
    saver.semantic.build_pq()
    saver.semantic.build_ivfpq(nlist=8)
    save(saver, tmp_path / "a")
    load(loader, tmp_path / "a")
    assert loader.semantic.has_pq and loader.semantic.has_ivfpq
    np.testing.assert_allclose(to_np(loader.semantic._ivfpq.centroids),
                               to_np(saver.semantic._ivfpq.centroids), rtol=1e-6)
    for name in ("packed_rows", "packed_codes", "tail_rows"):
        np.testing.assert_array_equal(to_np(getattr(loader.semantic._ivfpq, name)),
                                      to_np(getattr(saver.semantic._ivfpq, name)))
    for qt in QUERIES[:3] + ["chunk 7 about tpu sharding topic 0"]:
        a = port.search_sync(IndexType.SEMANTIC, qt, 3)
        b = jax.search_sync("semantic", qt, 3)
        assert a
        assert_same_ranking(hits(a), hits(b), 1e-5, 1e-6)
    tckpt.save_index(port, tmp_path / "b")
    jckpt.save_index(jax, tmp_path / "c")
    assert_same_files(tmp_path / "b", tmp_path / "c")


def test_checkpoint_restore_overrides_config_pq_geometry(monkeypatch, tmp_path):
    """Saved at pq_bits 8 (m 8) by JAX, restored under a pq_bits 4 config:
    the port writes the saved geometry into its config and searches with
    all 256 codes a subspace (the plain ADC; K6 takes 16), as JAX does."""
    jmgr, _ = managers(monkeypatch, 10 ** 9, 300)
    jmgr.semantic.config.pq_bits, jmgr.semantic.config.pq_m = 8, 8
    jmgr.semantic.build_pq()
    jmgr.semantic.build_ivfpq(nlist=8)
    jckpt.save_index(jmgr, tmp_path)
    _, tmgr = managers(monkeypatch, 10 ** 9, 0)
    assert tmgr.semantic.config.pq_bits == 4
    tckpt.load_index(tmgr, tmp_path)
    assert (tmgr.semantic.config.pq_bits, tmgr.semantic.config.pq_m) == (8, 8)
    q = tmgr.semantic._host[5][None, :]
    js, ji = jmgr.semantic.search(q, 3)
    ts, ti = tmgr.semantic.search(q, 3)
    assert to_np(ti)[0, 0] == 5
    assert_scores_close(ts, js, rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)
    # the raw ADC over 256 codes a subspace, codes of 128 and more included
    raw_j = jiv.ivfpq_topk(jmgr.semantic._ivfpq, jnp.asarray(q), 10, nprobe=8, m=8, bits=8)
    raw_t = tiv.ivfpq_topk(tmgr.semantic._ivfpq, torch.from_numpy(q), 10, nprobe=8, m=8,
                           bits=8)
    assert (to_np(tmgr.semantic._ivfpq.packed_codes) < 0).any()
    assert_scores_close(raw_t[0], raw_j[0], rtol=1e-5, atol=1e-6)
    assert_ids_tie_aware(raw_t[1], raw_j[1], raw_j[0], 1e-6)
