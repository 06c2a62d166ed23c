"""The port's sharded fused hybrid, sharded IVF / IVF-PQ and sharded retrieve
+ rerank (advanced_rag_tpu_torch/parallel/sharded_{hybrid,ivf,e2e}.py)
against the JAX package on the virtual CPU mesh.

The JAX references run in this process on a (4, 1) (shard, data) mesh of
``jax.devices()[:4]``; the port runs on four Gloo ranks on the CPU
(tests/torch_dist_worker.py, one spawn for the module) and at one rank in
this process.  The IVF and IVF-PQ programs search the JAX package's
per-shard structures, carried over shard by shard (``models/convert.py``),
so both search the same state; the port's own per-rank builds are held to
the recall bounds of tests/test_sharded_ivf.py.  Tolerances: ids exact
(sets where scores tie); f32 scores within 1e-5 relative; RRF scores and
method counts exact up to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from advanced_rag_tpu import parallel as jp
from advanced_rag_tpu.config import MeshConfig as JMeshConfig
from advanced_rag_tpu.index.text import encode_documents, encode_queries
from advanced_rag_tpu.models import encoder as jenc
from advanced_rag_tpu.models.tokenizer import HashingTokenizer, TokenizerConfig
from advanced_rag_tpu.ops.dense import dense_topk as jdense_topk
from advanced_rag_tpu.ops.pq import pq_encode, pq_train
from advanced_rag_tpu.ops.quant import sq8_quantize_host
from advanced_rag_tpu_torch.models.convert import params_from_jax
from advanced_rag_tpu_torch.ops.e2e import make_retrieve_rerank
from advanced_rag_tpu_torch.parallel import build_sharded_ivf, sharded_hybrid_retrieve
from advanced_rag_tpu_torch.parallel import sharded_ivf_topk
from advanced_rag_tpu_torch.parallel.mesh import single_device_mesh

E2E_ENC = dict(vocab_size=1024, hidden_dim=32, num_layers=1, num_heads=4, mlp_dim=64,
               max_len=64)
E2E_KW = dict(k_cand=16, k_out=16, k_rerank=8, k_final=4, dense_impl="scan", use_mmr=False)
IVF_FIELDS = ("centroids", "packed_emb", "packed_rows", "tail_emb", "tail_rows",
              "packed_scale", "tail_scale")
IVFPQ_FIELDS = ("centroids", "codebooks", "packed_codes", "packed_rows", "tail_codes",
                "tail_rows", "tail_assign")


def stacked(struct, fields):
    return {f: (None if getattr(struct, f) is None else np.asarray(getattr(struct, f)))
            for f in fields}


def texts_for(n, seed, words):
    rng = np.random.default_rng(seed)
    return [f"doc {i} " + " ".join(rng.choice(words, 6 if len(words) == 4 else 8).tolist())
            for i in range(n)]


def hybrid_case(mesh):
    """tests/test_sharded_hybrid.py's corpus: 512 rows, D 32, two queries."""
    rng = np.random.default_rng(0)
    n, d = 512, 32
    texts = [f"doc {i} " + " ".join(rng.choice(
        ["alpha", "beta", "gamma", "delta", "fox", "query"], 8).tolist()) for i in range(n)]
    doc_idx, doc_tf, doc_len, df = encode_documents(texts, 2048, 24)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((2, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_idx, q_tf = encode_queries(["alpha fox", "gamma delta query"], 2048, 16)
    valid = np.ones(n, bool)
    valid[7] = False
    codes, scale = sq8_quantize_host(emb)
    pq = pq_train(emb, bits=4, train_sample=512, seed=2)
    h = dict(emb=emb, codes=codes, scale=scale, pq_codes=np.array(pq_encode(emb, pq)),
             pq_cb=np.array(pq.codebooks), pq_m=pq.m, doc_idx=doc_idx, doc_tf=doc_tf,
             doc_len=doc_len, df=df, n_docs=np.float32(n), q=q, q_idx=q_idx, q_tf=q_tf,
             valid=valid, w=np.asarray([0.7, 0.3], np.float32), lam=np.float32(0.8))
    corpus = jp.shard_corpus_arrays(mesh, doc_idx, doc_tf, doc_len, valid)
    common = (*corpus[:3], jnp.asarray(df), jnp.float32(n), jnp.asarray(q),
              jnp.asarray(q_idx), jnp.asarray(q_tf), corpus[3], jnp.asarray(h["w"]),
              jnp.float32(0.8))
    rows = lambda a: jp.shard_corpus_arrays(mesh, a)  # noqa: E731
    kw = dict(mesh=mesh, k_cand=24, k_out=8)
    want = {f"scan-{m}": jp.sharded_hybrid_retrieve(rows(emb), *common, use_mmr=m, **kw)
            for m in (False, True)}
    want["sq8"] = jp.sharded_hybrid_retrieve(rows(codes), *common, None, rows(scale),
                                             dense_impl="sq8", **kw)
    want["pq"] = jp.sharded_hybrid_retrieve(rows(h["pq_codes"]), *common, pq.codebooks,
                                            dense_impl="pq", pq_m=pq.m, pq_bits=4,
                                            pq_impl="xla", dense_depth=96, **kw)
    return h, want


def ivf_case(mesh):
    """tests/test_sharded_ivf.py's clustered corpus: 2048 rows, D 32."""
    rng = np.random.default_rng(0)
    n, d = 2048, 32
    centers = rng.standard_normal((64, d)).astype(np.float32)
    emb = centers[rng.integers(0, 64, n)] + 0.1 * rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.integers(0, n, 4)] + 0.03 * rng.standard_normal((4, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    valid[5] = False
    texts = texts_for(n, 2, ["alpha", "beta", "gamma", "delta"])
    doc_idx, doc_tf, doc_len, df = encode_documents(texts, 2048, 16)
    q_idx, q_tf = encode_queries(["alpha beta", "gamma delta", "alpha", "delta beta"], 2048, 8)
    codes, scale = sq8_quantize_host(emb)
    flat = pq_train(emb, bits=4, train_sample=2048, seed=3)
    f = dict(emb=emb, codes=codes, scale=scale, pq_codes=np.array(pq_encode(emb, flat)),
             pq_cb=np.array(flat.codebooks), pq_m=flat.m, doc_idx=doc_idx, doc_tf=doc_tf,
             doc_len=doc_len, df=df, n_docs=np.float32(n), q=q, q_idx=q_idx, q_tf=q_tf,
             valid=valid, w=np.asarray([0.7, 0.3], np.float32), lam=np.float32(0.8))
    _, oracle = jdense_topk(jnp.asarray(emb), jnp.asarray(q), 10, jnp.asarray(valid),
                            metric="ip")
    f["oracle"] = np.asarray(oracle)
    v_s = jp.shard_corpus_arrays(mesh, valid)
    corpus = jp.shard_corpus_arrays(mesh, doc_idx, doc_tf, doc_len)
    common = (*corpus, jnp.asarray(df), jnp.float32(n), jnp.asarray(q), jnp.asarray(q_idx),
              jnp.asarray(q_tf), v_s, jnp.asarray(f["w"]), jnp.float32(0.8))
    rows = lambda a: jp.shard_corpus_arrays(mesh, a)  # noqa: E731
    kw = dict(mesh=mesh, k_cand=16, k_out=8, use_mmr=True, nprobe=16)
    want = {}
    for dtype in ("bfloat16", "int8"):
        parts = jp.build_sharded_ivf(emb, mesh, nlist=16, dtype=dtype, train_sample=2048)
        f[f"parts_{dtype}"] = stacked(parts, IVF_FIELDS)
        sq8 = dtype == "int8"
        want[f"ivf-{dtype}"] = jp.sharded_hybrid_retrieve(
            rows(codes if sq8 else emb), *common, None, rows(scale) if sq8 else None, None,
            parts, dense_impl="ivf", dense_depth=40, **kw)
        want[f"ivf_topk-{dtype}"] = jp.sharded_ivf_topk(parts, jnp.asarray(q), 10, v_s,
                                                        mesh=mesh, nprobe=16)
    sidx = jp.build_sharded_ivfpq(emb, mesh, nlist=16, train_sample=2048)
    f["sidx"] = stacked(sidx, IVFPQ_FIELDS)
    want["ivfpq"] = jp.sharded_hybrid_retrieve(
        rows(f["pq_codes"]), *common, flat.codebooks, None, sidx, dense_impl="ivfpq",
        pq_m=flat.m, pq_bits=4, dense_depth=64, **kw)
    want["ivfpq_topk"] = jp.sharded_ivfpq_topk(sidx, jnp.asarray(q), 40, v_s, mesh=mesh,
                                               nprobe=16, m=int(sidx.codebooks.shape[1]),
                                               bits=4)
    return f, want


def e2e_case(mesh):
    """tests/test_sharded_e2e.py's corpus and models, in f32."""
    cfg = jenc.EncoderConfig(dtype=jnp.float32, **E2E_ENC)
    tok = HashingTokenizer(TokenizerConfig(vocab_size=1024, max_len=16))
    bi, p_bi = jenc.init_bi_encoder(cfg, out_dim=16, seed=0)
    ce, p_ce = jenc.init_cross_encoder(cfg, seed=1)
    rng = np.random.default_rng(0)
    n, vocab, nnz = 64, 512, 8
    texts = [f"document number {i} about topic {i % 7}" for i in range(n)]
    tok_ids, _ = tok.encode_batch(texts)
    emb = np.asarray(bi.apply(p_bi, jnp.asarray(tok_ids),
                              jnp.asarray((tok_ids != 0).astype(np.float32))))
    e = dict(enc={**E2E_ENC, "dtype": torch.float32}, out=16, kw=E2E_KW,
             bi_state=params_from_jax(jax.tree_util.tree_map(np.asarray, p_bi)),
             ce_state=params_from_jax(jax.tree_util.tree_map(np.asarray, p_ce)),
             tok_ids=tok_ids.astype(np.int32), emb=emb.astype(np.float32),
             doc_idx=rng.integers(4, vocab, (n, nnz)).astype(np.int32),
             doc_tf=np.ones((n, nnz), np.float32), doc_len=np.full((n,), float(nnz), np.float32),
             df=np.ones((vocab,), np.int32), n_docs=np.float32(n), valid=np.ones((n,), bool),
             w=np.asarray([0.7, 0.3], np.float32), lam=np.float32(0.8),
             cand=np.asarray([[0, 5, 63, -1], [17, 17, 2, 40]], np.int32))
    q_ids, q_mask = tok.encode_batch(["document number three", "topic five material"])
    qrng = np.random.default_rng(3)
    e["queries"] = (q_ids, q_mask, qrng.integers(4, vocab, (2, 4)).astype(np.int32),
                    np.ones((2, 4), np.float32))
    arrs = jp.shard_corpus_arrays(mesh, e["tok_ids"], e["emb"], e["doc_idx"], e["doc_tf"],
                                  e["doc_len"], e["valid"])
    prog = jp.make_sharded_retrieve_rerank(bi, ce, mesh=mesh, **E2E_KW)
    want = prog(p_bi, p_ce, *(jnp.asarray(a) for a in e["queries"]), *arrs[:2],
                *arrs[2:5], jnp.asarray(e["df"]), jnp.float32(n), arrs[5],
                jnp.asarray(e["w"]), jnp.float32(0.8))
    gather = jp.sharded_token_gather(arrs[0], jnp.asarray(e["cand"]), mesh=mesh)
    return e, {"e2e": want, "token_gather": np.asarray(gather)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    mesh = jp.build_mesh(JMeshConfig(mesh_shape=(4, 1)), jax.devices()[:4])
    h, want_h = hybrid_case(mesh)
    f, want_f = ivf_case(mesh)
    e, want_e = e2e_case(mesh)
    want = {**want_h, **want_f, **want_e}
    got = worker.run_ranks("sharded", 4, {"hybrid": h, "ivf": f, "e2e": e},
                           tmp_path_factory.mktemp("sharded"))
    return {"hybrid": h, "ivf": f, "e2e": e}, want, got


def np_all(xs):
    return [np.asarray(x) for x in xs]


def assert_hybrid_equal(got, want):
    """ids and method counts exact, fused scores within 1e-6; the deep dense
    lists (when returned) as sets within ties, scores 1e-5 relative."""
    got, want = np_all(got), np_all(want)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    if len(got) == 5:
        np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-5)
        for a, b in zip(got[3], want[3]):
            assert len(set(a.tolist()) & set(b.tolist())) >= int(0.9 * len(set(b.tolist())))


def one_rank_hybrid(h, impl, **kw):
    t = torch.from_numpy
    mirror = worker.mirror(t(h["doc_idx"]), t(h["doc_tf"]))
    rows = {"scan": h["emb"], "sq8": h["codes"], "pq": h["pq_codes"]}[impl]
    return sharded_hybrid_retrieve(
        t(rows), *mirror, t(h["doc_len"]), t(h["df"]), torch.tensor(h["n_docs"]), t(h["q"]),
        t(h["q_idx"]), t(h["q_tf"]), t(h["valid"]), t(h["w"]), torch.tensor(h["lam"]),
        t(h["pq_cb"]) if impl == "pq" else None, t(h["scale"]) if impl == "sq8" else None,
        mesh=single_device_mesh(), k_cand=24, k_out=8, dense_impl=impl, **kw)


@pytest.mark.parametrize("rung", ["scan-False", "scan-True", "sq8", "pq"])
def test_hybrid_matches_jax_and_one_rank(case, rung):
    data, want, got = case
    for g in got:
        assert_hybrid_equal(g[rung], want[rung])
    impl = rung.split("-")[0]
    kw = (dict(use_mmr=rung == "scan-True") if impl == "scan" else
          dict(pq_m=data["hybrid"]["pq_m"], pq_bits=4, dense_depth=96) if impl == "pq"
          else {})
    assert_hybrid_equal(got[0][rung], one_rank_hybrid(data["hybrid"], impl, **kw))
    assert 7 not in np.asarray(got[0][rung][0])       # the masked row never surfaces


@pytest.mark.parametrize("rung", ["ivf-bfloat16", "ivf-int8", "ivfpq"])
def test_partitioned_hybrid_matches_jax(case, rung):
    data, want, got = case
    for g in got:
        assert_hybrid_equal(g[rung], want[rung])
    assert 5 not in np.asarray(got[0][rung][0])


@pytest.mark.parametrize("name", ["ivf_topk-bfloat16", "ivf_topk-int8", "ivfpq_topk"])
def test_sharded_ivf_search_matches_jax(case, name):
    _, want, got = case
    for g in got:
        gs, gi = np_all(g[name])
        ws, wi = np_all(want[name])
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
        for a, b in zip(gi, wi):
            assert set(a.tolist()) == set(b.tolist())


def recall(got, want):
    got = np.asarray(got)
    return np.mean([len(set(got[i][got[i] >= 0]) & set(want[i])) / want.shape[1]
                    for i in range(len(want))])


@pytest.mark.parametrize("name,bound", [("own_ivf-bfloat16", 0.95), ("own_ivf-int8", 0.9),
                                        ("own_ivfpq", 0.9)])
def test_own_builds_reach_the_jax_recall(case, name, bound):
    """Each rank's own k-means and packing (per-rank shapes), at full probe."""
    data, _, got = case
    f = data["ivf"]
    ids = np.asarray(got[0][name][1])
    assert recall(ids, f["oracle"]) >= bound
    assert 5 not in ids
    for row in ids:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live) and (live < len(f["emb"])).all()
    if name == "own_ivf-bfloat16":
        # at full probe the scan is exact over the bf16 rows, so one rank's
        # build over every row answers alike
        one = build_sharded_ivf(f["emb"], single_device_mesh(), nlist=16,
                                train_sample=2048, device="cpu")
        s1, i1 = sharded_ivf_topk(one, torch.from_numpy(f["q"]), 10,
                                  torch.from_numpy(f["valid"]), mesh=single_device_mesh(),
                                  nprobe=16)
        np.testing.assert_allclose(np.asarray(got[0][name][0]), s1.numpy(), rtol=1e-5)
        for a, b in zip(ids, i1.numpy()):
            assert set(a.tolist()) == set(b.tolist())


def test_token_gather_matches_jax(case):
    data, want, got = case
    e = data["e2e"]
    expect = np.where(e["cand"][..., None] >= 0, e["tok_ids"][np.clip(e["cand"], 0, None)], 0)
    np.testing.assert_array_equal(want["token_gather"], expect)
    for g in got:
        np.testing.assert_array_equal(g["token_gather"].numpy(), expect)


def test_retrieve_rerank_matches_jax_and_one_rank(case):
    data, want, got = case
    e = data["e2e"]
    w = want["e2e"]
    bi, ce = worker.e2e_models(e)
    t = torch.from_numpy
    one = make_retrieve_rerank(bi, ce, **E2E_KW)(
        *(t(a) for a in e["queries"]), t(e["tok_ids"]), t(e["emb"]), t(e["doc_idx"]),
        t(e["doc_tf"]), *worker.mirror(t(e["doc_idx"]), t(e["doc_tf"])), t(e["doc_len"]),
        t(e["df"]), torch.tensor(e["n_docs"]), t(e["valid"]), t(e["w"]),
        torch.tensor(e["lam"]))
    for g in got:
        r = g["e2e"]
        np.testing.assert_array_equal(r.ids.numpy(), np.asarray(w.ids))
        np.testing.assert_array_equal(r.cand_ids.numpy(), np.asarray(w.cand_ids))
        scale = np.abs(np.asarray(w.ce_scores)).max()
        np.testing.assert_allclose(r.ce_scores.numpy(), np.asarray(w.ce_scores), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_array_equal(r.ids.numpy(), one.ids.numpy())
        np.testing.assert_allclose(r.ce_scores.numpy(), one.ce_scores.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(r.q_dense.numpy(), np.asarray(w.q_dense), rtol=1e-5,
                                   atol=1e-6)


def test_hybrid_refuses_a_missing_structure():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="ivf_parts"):
        sharded_hybrid_retrieve(x, *(None,) * 10, torch.ones(2), 0.5,
                                mesh=single_device_mesh(), k_cand=2, k_out=1,
                                dense_impl="ivf")
    with pytest.raises(ValueError, match="unknown dense_impl"):
        sharded_hybrid_retrieve(x, *(None,) * 10, torch.ones(2), 0.5,
                                mesh=single_device_mesh(), k_cand=2, k_out=1,
                                dense_impl="hnsw")
