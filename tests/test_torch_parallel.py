"""The port's mesh, merges and sharded exact search
(advanced_rag_tpu_torch/parallel/{mesh,comm,topk,sharded_search}.py)
against the JAX package on the virtual CPU mesh.

The JAX references run in this process on ``jax.devices()[:4]`` (a (4, 1)
and a (2, 2) (shard, data) mesh); the port runs on four Gloo ranks on the
CPU (tests/torch_dist_worker.py, one spawn for the module) and at one rank
in this process.  Tolerances: ids exact, compared as sets where scores tie
(rows sorted by (-score, id)); f32 scores within 1e-5 relative (the same
arithmetic in another order; BM25 from bf16 term frequencies, which are
small integers and exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist_worker as worker
from advanced_rag_tpu import parallel as jp
from advanced_rag_tpu.config import MeshConfig as JMeshConfig
from advanced_rag_tpu.index.text import encode_documents, encode_queries
from advanced_rag_tpu.ops.quant import sq8_quantize_host
from advanced_rag_tpu_torch.config import MeshConfig
from advanced_rag_tpu_torch.parallel import comm, mesh as tmesh
from advanced_rag_tpu_torch.parallel import (gather_merge_topk, shard_corpus_arrays,
                                             sharded_dense_topk, sharded_sparse_topk,
                                             tree_merge_topk)

K = 10


def sorted_rows(scores, ids):
    """Canonical tie order: each row sorted by (-score, id)."""
    scores, ids = np.asarray(scores), np.asarray(ids)
    order = np.lexsort((ids, -scores), axis=-1)
    return np.take_along_axis(scores, order, -1), np.take_along_axis(ids, order, -1)


def assert_topk_equal(got, want, rtol=1e-5):
    gs, gi = sorted_rows(*[np.asarray(x) for x in got])
    ws, wi = sorted_rows(*[np.asarray(x) for x in want])
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=rtol * np.abs(ws[ws > -1e29]).max())
    np.testing.assert_array_equal(gi, wi)


def jmesh(shape):
    return jp.build_mesh(JMeshConfig(mesh_shape=shape), jax.devices()[:4])


def sparse_corpus():
    docs = [f"the quick brown fox {w} jumps over the lazy dog number {i}"
            for i, w in enumerate(["alpha", "beta", "gamma", "delta", "epsilon", "zeta"] * 20)]
    doc_idx, doc_tf, doc_len, df = encode_documents(docs, 4096, 32)
    q_idx, q_tf = encode_queries(["quick gamma fox", "lazy delta dog"], 4096, 16)
    return doc_idx, doc_tf, doc_len, df, q_idx, q_tf, len(docs)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = {"k": K, "mk": 6}
    d["emb"] = rng.standard_normal((1024, 32)).astype(np.float32)
    d["q"] = rng.standard_normal((4, 32)).astype(np.float32)
    d["valid"] = np.ones(1024, bool)
    d["valid"][100:200] = False
    unit = d["emb"] / np.linalg.norm(d["emb"], axis=1, keepdims=True)
    d["codes"], d["scale"] = sq8_quantize_host(unit)
    d["q_sq8"] = unit[rng.integers(0, 1024, 3)]
    d["emb22"] = rng.standard_normal((512, 16)).astype(np.float32)
    d["q22"] = rng.standard_normal((8, 16)).astype(np.float32)
    doc_idx, doc_tf, doc_len, df, q_idx, q_tf, n = sparse_corpus()
    d.update(doc_idx=doc_idx, doc_tf=doc_tf, doc_len=doc_len, df=df, q_idx=q_idx, q_tf=q_tf,
             n_docs=np.float32(n), sp_valid=np.ones(n, bool))
    d["m_scores"] = rng.standard_normal((4, 3, 6)).astype(np.float32)
    d["m_ids"] = rng.permutation(10_000)[:72].reshape(4, 3, 6).astype(np.int32)

    mesh4, mesh22 = jmesh((4, 1)), jmesh((2, 2))
    want = {}
    emb_s, valid_s = jp.shard_corpus_arrays(mesh4, d["emb"], d["valid"])
    want["dense"] = jp.sharded_dense_topk(emb_s, jnp.asarray(d["q"]), K, valid_s,
                                          mesh=mesh4, metric="ip")
    want["masked"] = jp.sharded_dense_topk(
        emb_s, jnp.asarray(d["q"][:1]), 5,
        jp.shard_corpus_arrays(mesh4, np.zeros(1024, bool)), mesh=mesh4, metric="ip")
    c_s, s_s = jp.shard_corpus_arrays(mesh4, d["codes"], d["scale"])
    want["sq8"] = jp.sharded_dense_topk(c_s, jnp.asarray(d["q_sq8"]), K, None, s_s,
                                        mesh=mesh4, metric="ip")
    want["dense22"] = jp.sharded_dense_topk(jp.shard_corpus_arrays(mesh22, d["emb22"]),
                                            jnp.asarray(d["q22"]), K, None, mesh=mesh22,
                                            metric="ip")
    arrs = jp.shard_corpus_arrays(mesh4, doc_idx, doc_tf, doc_len, d["sp_valid"])
    for scoring in ("bm25", "ip"):
        want[scoring] = jp.sharded_sparse_topk(*arrs[:3], jnp.asarray(df), jnp.float32(n),
                                               jnp.asarray(q_idx), jnp.asarray(q_tf), K,
                                               arrs[3], mesh=mesh4, scoring=scoring)

    def merged(merge):
        fn = shard_map(lambda s, i: merge(s[0], i[0]), mesh=mesh4,
                       in_specs=(P("shard"), P("shard")),
                       out_specs=(P(None, None), P(None, None)), check_vma=False)
        return fn(jnp.asarray(d["m_scores"]), jnp.asarray(d["m_ids"]))

    want["gather"] = merged(lambda s, i: jp.gather_merge_topk(s, i, 6, "shard"))
    want["tree"] = merged(lambda s, i: jp.tree_merge_topk(s, i, 6, "shard", 4))
    want = {k: tuple(np.asarray(x) for x in v) for k, v in want.items()}
    got = worker.run_ranks("parallel", 4, d, tmp_path_factory.mktemp("parallel"))
    return d, want, got


def test_ranks_sit_on_the_mesh_as_jax_devices(case):
    _, _, got = case
    assert [g["coords4"] for g in got] == [{"shard": r, "data": 0} for r in range(4)]
    # np.arange(4).reshape(2, 2), as JAX lays devices out
    assert [g["coords22"] for g in got] == [{"shard": r // 2, "data": r % 2}
                                            for r in range(4)]


def test_dense_matches_jax_and_one_rank(case):
    d, want, got = case
    for g in got:                       # every rank of the shard axis, one answer
        assert_topk_equal(g["dense"], want["dense"])
    one = sharded_dense_topk(torch.from_numpy(d["emb"]), torch.from_numpy(d["q"]), K,
                             torch.from_numpy(d["valid"]), mesh=tmesh.single_device_mesh())
    assert_topk_equal(got[0]["dense"], one)
    assert not np.isin(np.asarray(got[0]["dense"][1]), np.arange(100, 200)).any()


def test_dense_all_masked(case):
    _, want, got = case
    assert (np.asarray(got[0]["masked"][1]) == -1).all()
    assert (want["masked"][1] == -1).all()


def test_sq8_matches_jax(case):
    d, want, got = case
    gs, gi = got[0]["sq8"]
    np.testing.assert_allclose(np.asarray(gs), want["sq8"][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(np.asarray(gi), want["sq8"][1]):
        assert len(set(a.tolist()) & set(b.tolist())) >= K - 1    # integer-dot ties
    one = sharded_dense_topk(torch.from_numpy(d["codes"]), torch.from_numpy(d["q_sq8"]), K,
                             None, torch.from_numpy(d["scale"]),
                             mesh=tmesh.single_device_mesh())
    for x, y in zip(got[0]["sq8"], one):
        assert torch.equal(x, y)


def test_queries_split_over_data_match_jax(case):
    """(shard 2, data 2): each data coordinate's shard group answers its
    own half of the queries."""
    _, want, got = case
    halves = {g["coords22"]["data"]: g["dense22"] for g in got}
    s = np.concatenate([np.asarray(halves[j][0]) for j in (0, 1)])
    i = np.concatenate([np.asarray(halves[j][1]) for j in (0, 1)])
    assert_topk_equal((s, i), want["dense22"])


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
def test_sparse_matches_jax_and_one_rank(case, scoring):
    d, want, got = case
    for g in got:
        assert_topk_equal(g[scoring], want[scoring])
    mirror = worker.mirror(torch.from_numpy(d["doc_idx"]), torch.from_numpy(d["doc_tf"]))
    one = sharded_sparse_topk(*mirror, torch.from_numpy(d["doc_len"]),
                              torch.from_numpy(d["df"]), torch.tensor(d["n_docs"]),
                              torch.from_numpy(d["q_idx"]), torch.from_numpy(d["q_tf"]), K,
                              None, mesh=tmesh.single_device_mesh(), scoring=scoring)
    assert_topk_equal(got[0][scoring], one)


@pytest.mark.parametrize("merge", ["gather", "tree"])
def test_merges_match_jax(case, merge):
    _, want, got = case
    for g in got:
        for x, y in zip(g[merge], got[0][merge]):
            assert torch.equal(x, y)    # the same on every rank, tie order included
        np.testing.assert_array_equal(np.asarray(g[merge][0]), want[merge][0])
        np.testing.assert_array_equal(np.asarray(g[merge][1]), want[merge][1])


def test_mesh_helpers():
    """Without a process group the world is one rank."""
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.build_mesh(MeshConfig(mesh_shape=(3, 2)))
    mesh = tmesh.build_mesh(MeshConfig(mesh_shape=None))
    assert mesh.shape == {"shard": 1, "data": 1} == tmesh.single_device_mesh().shape
    assert mesh.groups == {"shard": None, "data": None}
    assert tmesh.corpus_sharding(mesh, 10) == slice(0, 10) == tmesh.replicated(mesh, 10)
    arr = np.ones((16, 3), np.float32)
    assert tmesh.pad_to_shards(arr, 8) is arr
    padded = tmesh.pad_to_shards(np.ones((10, 3), np.float32), 8, fill=-1)
    assert padded.shape == (16, 3) and (padded[10:] == -1).all()
    rows = shard_corpus_arrays(mesh, np.arange(6), device="cpu")
    assert rows.tolist() == list(range(6))
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.corpus_sharding(type("M", (), {"shape": {"shard": 4}})(), 10)


def test_one_rank_collectives_are_the_identity():
    mesh = tmesh.single_device_mesh()
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(comm.all_gather(x, mesh, "shard"), x[None])
    assert torch.equal(comm.all_reduce_sum(x, mesh, "shard"), x)
    assert torch.equal(comm.exchange(x, mesh, "shard", 0), x)
    assert torch.equal(comm.gather_rows(x, mesh, "shard"), x)
    s, i = x, torch.arange(6, dtype=torch.int32).reshape(2, 3)
    for a, b in zip(gather_merge_topk(s, i, 2, mesh=mesh), (x[:, [2, 1]], i[:, [2, 1]])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="power-of-two"):
        tree_merge_topk(s, i, 2, "shard", 3, mesh=mesh)
