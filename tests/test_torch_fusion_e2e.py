"""The port's fusion, rescore and one-pass retrieve + rerank program against
the JAX package on the same arrays and converted weights.

``make_retrieve_rerank`` runs with f32 encoders on both sides (the JAX
program on its CPU rungs: dense "scan"/"sq8", sparse "xla"; the port's
through the plain versions of kernels K1/K2/K3).  Tolerances: RRF scores
rtol 2.4e-7 (XLA folds the constant rank denominators and multiplies by
their reciprocals, the port divides: at most two ulps apart); MMR picks,
RRF ids and counts exact; rescores rtol 1e-5; cross-encoder scores rtol
1e-4 / atol 1e-5; final and candidate ids must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.models import encoder as jenc
from advanced_rag_tpu.ops import e2e as je2e
from advanced_rag_tpu.ops import fusion as jfusion
from advanced_rag_tpu.ops import quant as jquant
from advanced_rag_tpu.ops import rescore as jrescore
from advanced_rag_tpu_torch.models import encoder as tenc
from advanced_rag_tpu_torch.models.convert import params_from_jax
from advanced_rag_tpu_torch.ops import e2e as te2e
from advanced_rag_tpu_torch.ops import fusion as tfusion
from advanced_rag_tpu_torch.ops import rescore as trescore
from test_torch_parity import to_np

T = torch.from_numpy


def random_candidates(rng, m, q, k, pool):
    ids = rng.integers(0, pool, size=(m, q, k)).astype(np.int32)
    ids[rng.random((m, q, k)) < 0.2] = -1
    return ids


@pytest.mark.parametrize("seed", [0, 1])
def test_rrf_fuse_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ids = random_candidates(rng, 2, 4, 16, 30)
    w = np.array([0.7, 0.3], np.float32)
    ws, wi, wc = jfusion.rrf_fuse(jnp.asarray(ids), jnp.asarray(w), rrf_k=60, k_out=20)
    gs, gi, gc = tfusion.rrf_fuse(T(ids), T(w), rrf_k=60, k_out=20)
    np.testing.assert_allclose(to_np(gs), np.asarray(ws), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(to_np(gi), np.asarray(wi))
    np.testing.assert_array_equal(to_np(gc), np.asarray(wc))


@pytest.mark.parametrize("lam", [0.8, 0.3])
def test_mmr_select_matches_jax(lam):
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((3, 24, 16)).astype(np.float32)
    emb[:, 5] = emb[:, 4]                               # a duplicate pair
    rel = rng.random((3, 24)).astype(np.float32)
    ok = rng.random((3, 24)) > 0.2
    ok[2, 3:] = False                                   # fewer valid than k
    got = to_np(tfusion.mmr_select(T(emb), T(rel), 10, lam, T(ok)))
    for qi in range(3):
        want = np.asarray(jfusion.mmr_select(jnp.asarray(emb[qi]), jnp.asarray(rel[qi]),
                                             10, lam, jnp.asarray(ok[qi])))
        np.testing.assert_array_equal(got[qi], want)
        single = tfusion.mmr_select(T(emb[qi]), T(rel[qi]), 10, lam, T(ok[qi]))
        np.testing.assert_array_equal(to_np(single), want)


def corpus_arrays(rng, n=200, d=16, p=10, vocab=64, ld=12, tok_vocab=256):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = np.full((n, p), -1, np.int32)
    tf = np.zeros((n, p), np.float32)
    for r in range(n):
        live = int(rng.integers(1, p + 1))
        idx[r, :live] = rng.choice(vocab, size=live, replace=False)
        tf[r, :live] = rng.integers(1, 4, size=live)
    doc_len = tf.sum(1).astype(np.float32)
    df = np.zeros(vocab, np.int32)
    np.add.at(df, idx[idx >= 0], 1)
    valid = rng.random(n) > 0.15
    tokens = rng.integers(8, tok_vocab, size=(n, ld)).astype(np.int32)
    lens = rng.integers(3, ld + 1, size=n)
    tokens[np.arange(ld)[None, :] >= lens[:, None]] = 0
    tokens[:, 0] = 1
    doc_lo = (np.arange(n) // 3).astype(np.int32)          # 3 chunks per doc
    doc_hi = np.zeros(n, np.int32)
    return dict(emb=emb, idx=idx, tf=tf, doc_len=doc_len, df=df, valid=valid,
                tokens=tokens, doc_lo=doc_lo, doc_hi=doc_hi)


def query_arrays(rng, q=3, lq=8, t=5, vocab=64, tok_vocab=256):
    q_ids = rng.integers(8, tok_vocab, size=(q, lq)).astype(np.int32)
    q_mask = np.ones((q, lq), np.float32)
    q_mask[0, 5:] = 0.0
    q_ids[0, 5:] = 0
    q_ids[:, 0] = 1
    sp_idx = rng.choice(vocab, size=(q, t)).astype(np.int32)
    sp_idx[:, -1] = -1
    sp_tf = np.where(sp_idx >= 0, 1.0, 0.0).astype(np.float32)
    return q_ids, q_mask, sp_idx, sp_tf


def test_exact_tier_scores_and_zmix_match_jax():
    rng = np.random.default_rng(3)
    c = corpus_arrays(rng)
    q_ids, q_mask, sp_idx, sp_tf = query_arrays(rng)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    cand = rng.integers(0, 200, size=(3, 8)).astype(np.int32)
    cand[1, 6:] = -1
    codes, scale = jquant.sq8_quantize_host(c["emb"])
    for emb, esc in ((c["emb"], None), (codes, scale)):
        wd, wb = jrescore.exact_tier_scores(
            jnp.asarray(cand), jnp.asarray(q), jnp.asarray(sp_idx), jnp.asarray(sp_tf),
            jnp.asarray(emb), jnp.asarray(c["idx"]), jnp.asarray(c["tf"]),
            jnp.asarray(c["doc_len"]), jnp.asarray(c["df"]), jnp.float32(200.0),
            valid=jnp.asarray(c["valid"]),
            emb_scale=None if esc is None else jnp.asarray(esc))
        gd, gb = trescore.exact_tier_scores(
            T(cand), T(q), T(sp_idx), T(sp_tf), T(emb), T(c["idx"]), T(c["tf"]),
            T(c["doc_len"]), T(c["df"]), torch.tensor(200.0), valid=T(c["valid"]),
            emb_scale=None if esc is None else T(esc))
        np.testing.assert_allclose(to_np(gd), np.asarray(wd), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(to_np(gb), np.asarray(wb), rtol=1e-5, atol=1e-6)
    validm = cand >= 0
    wz = jrescore.zmix_base(wd, wb, jnp.asarray(validm), jnp.float32(0.65))
    gz = trescore.zmix_base(gd, gb, T(validm), torch.tensor(0.65))
    np.testing.assert_allclose(to_np(gz)[validm], np.asarray(wz)[validm],
                               rtol=1e-4, atol=1e-5)


CFG = dict(vocab_size=256, hidden_dim=32, num_layers=1, num_heads=4, mlp_dim=64,
           max_len=40)


@pytest.fixture(scope="module")
def models():
    jbi, pbi = jenc.init_bi_encoder(
        jenc.EncoderConfig(dtype=jnp.float32, lexical_pool=True, **CFG), 16, seed=1)
    jce, pce = jenc.init_cross_encoder(
        jenc.EncoderConfig(dtype=jnp.float32, lexical_match=True, **CFG), seed=2)
    tbi = tenc.BiEncoder(tenc.EncoderConfig(dtype=torch.float32, lexical_pool=True,
                                            **CFG), 16)
    tbi.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, pbi)))
    tce = tenc.CrossEncoder(tenc.EncoderConfig(dtype=torch.float32, lexical_match=True,
                                               **CFG))
    tce.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, pce)))
    return jbi, pbi, jce, pce, tbi.eval(), tce.eval()


@pytest.mark.parametrize("tier,doc_dedupe,mode,base,alpha", [
    ("f32", False, "zblend", "fused", 0.5),
    ("f32", True, "residual", "exact", 0.5),
    ("f32", False, "residual", "exact", 0.5),
    ("f32", True, "zblend", "fused", 0.3),
    ("f32", False, "zblend", "fused", None),
    ("sq8", False, "residual", "exact", 0.5),
])
def test_retrieve_rerank_matches_jax(models, tier, doc_dedupe, mode, base, alpha):
    jbi, pbi, jce, pce, tbi, tce = models
    rng = np.random.default_rng(7)
    c = corpus_arrays(rng)
    q_ids, q_mask, sp_idx, sp_tf = query_arrays(rng)
    emb, esc = c["emb"], None
    if tier == "sq8":
        emb, esc = jquant.sq8_quantize_host(c["emb"])
    ks = dict(k_cand=32, k_out=16, k_rerank=8, k_final=4, rerank_mode=mode,
              rerank_base=base, doc_dedupe=doc_dedupe,
              dense_impl="sq8" if tier == "sq8" else "scan")
    jprog = je2e.make_retrieve_rerank(jbi, jce, sparse_impl="xla", **ks)
    extra = {}
    if alpha is not None:
        extra = dict(rerank_alpha=jnp.float32(alpha), rescore_mix=jnp.float32(0.65))
    want = jprog(pbi, pce, jnp.asarray(q_ids), jnp.asarray(q_mask), jnp.asarray(sp_idx),
                 jnp.asarray(sp_tf), jnp.asarray(c["tokens"]), jnp.asarray(emb),
                 jnp.asarray(c["idx"]), jnp.asarray(c["tf"]), jnp.asarray(c["doc_len"]),
                 jnp.asarray(c["df"]), jnp.float32(200.0), jnp.asarray(c["valid"]),
                 jnp.asarray([0.7, 0.3], jnp.float32), jnp.float32(0.8),
                 emb_scale=None if esc is None else jnp.asarray(esc),
                 doc_lo=jnp.asarray(c["doc_lo"]), doc_hi=jnp.asarray(c["doc_hi"]),
                 **extra)
    tprog = te2e.make_retrieve_rerank(tbi, tce, **ks)
    textra = {k: torch.tensor(float(v)) for k, v in extra.items()}
    got = tprog(T(q_ids), T(q_mask), T(sp_idx), T(sp_tf), T(c["tokens"]), T(emb),
                T(c["idx"]), T(c["tf"]), T(c["idx"].T.copy()), T(c["tf"].T.copy()),
                T(c["doc_len"]), T(c["df"]), torch.tensor(200.0), T(c["valid"]),
                torch.tensor([0.7, 0.3]), torch.tensor(0.8),
                emb_scale=None if esc is None else T(esc),
                doc_lo=T(c["doc_lo"]), doc_hi=T(c["doc_hi"]), **textra)
    np.testing.assert_allclose(to_np(got.q_dense), np.asarray(want.q_dense),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(to_np(got.cand_ids), np.asarray(want.cand_ids))
    np.testing.assert_allclose(to_np(got.cand_scores), np.asarray(want.cand_scores),
                               rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(to_np(got.ids), np.asarray(want.ids))
    live = np.asarray(want.ids) >= 0
    np.testing.assert_allclose(to_np(got.ce_scores)[live],
                               np.asarray(want.ce_scores)[live], rtol=1e-4, atol=1e-5)
    if doc_dedupe:
        for row in to_np(got.cand_ids):
            docs = c["doc_lo"][row[row >= 0]]
            assert len(set(docs.tolist())) == len(docs)
