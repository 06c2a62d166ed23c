"""The port's cross-encoder training (advanced_rag_tpu_torch/train/rerank.py,
train/distill.py) against the JAX package on the same inputs, from the
same (converted) initial weights.

Geometry: tests/test_train.py's TINY cross-encoder (vocab 512, H 32, 2
layers, 4 heads, MLP 64, max_len 16) with the lexical-match channel, f32
activations, dropout 0 (each framework draws its own dropout masks; the
masks' placement is held against Flax in tests/test_torch_encoder_train.py).
The slates are tests/test_train.py's: 48 (question, document) pairs over
four topics, six random negatives each, q_len 6, d_len 9.

Tolerances: batches, labels, z-normalized base scores and teacher inputs
are equal; losses, accuracies, agreements, eval numbers and teacher scores
agree to rtol 2e-5 (f32, another summation order); parameters after the
steps to atol 2e-5, but the attention key biases and the score bias, whose
true gradient is zero (softmax ignores the first, the listwise losses a
shift of every score), to atol 3 * lr: Adam turns each framework's
rounding noise there into steps of up to lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from advanced_rag_tpu.models import encoder as jenc
from advanced_rag_tpu.models.tokenizer import HashingTokenizer as JTokenizer
from advanced_rag_tpu.models.tokenizer import TokenizerConfig as JTokConfig
from advanced_rag_tpu.train import contrastive as jc
from advanced_rag_tpu.train import distill as jd
from advanced_rag_tpu.train import rerank as jr
from advanced_rag_tpu_torch.models import encoder as tenc
from advanced_rag_tpu_torch.models.convert import params_from_jax
from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from advanced_rag_tpu_torch.parallel.mesh import single_device_mesh
from advanced_rag_tpu_torch.train import contrastive as tc
from advanced_rag_tpu_torch.train import distill as td
from advanced_rag_tpu_torch.train import rerank as tr

TINY = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
            max_len=16)
JCFG = jenc.EncoderConfig(dtype=jnp.float32, lexical_match=True, **TINY)
TCFG = tenc.EncoderConfig(dtype=torch.float32, lexical_match=True, **TINY)
LAYOUT = dict(q_len=6, d_len=9)
TRAIN = dict(learning_rate=3e-3, warmup_steps=1, total_steps=120)
LR = TRAIN["learning_rate"]


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def slates():
    """tests/test_train.py's pairs and negatives, with seeded base scores."""
    rng = np.random.default_rng(3)
    topics = ["alpha kernels", "beta retrieval", "gamma sharding", "delta caching"]
    pairs = [(f"question about {topics[i % 4]} item {i}",
              f"document on {topics[i % 4]} item {i} body text") for i in range(48)]
    negatives = [[pairs[j][1] for j in rng.integers(0, 48, 6) if j != i]
                 for i in range(48)]
    base = [(float(rng.normal()), [float(x) for x in rng.normal(size=len(n))])
            for n in negatives]
    return pairs, negatives, base


PAIRS, NEGATIVES, BASE = slates()
TEXTS = [d for _, d in PAIRS]


def tokenizers():
    cfg = dict(vocab_size=TINY["vocab_size"], max_len=TINY["max_len"])
    return JTokenizer(JTokConfig(**cfg)), HashingTokenizer(TokenizerConfig(**cfg))


def canonical_opt_state(opt, mesh):
    """The optimizer state as the JAX step returns it, so that the step
    compiles once, not once more at its second call."""
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, NamedSharding(mesh, P())),
                                  opt)


#: parameters whose true gradient is zero: softmax ignores the attention key
#: biases, and the listwise losses ignore a shift of every score
ZERO_GRADIENT = ("attn.key.bias", "score.bias")


def assert_params_close(got, want, lr=LR):
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 3 * lr if k.endswith(ZERO_GRADIENT) else 2e-5
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)


def converted(jparams):
    def init(config, seed=0, device=None):
        assert config == TCFG
        model = tenc.CrossEncoder(config)
        model.load_state_dict(params_from_jax(numpy_tree(jparams)))
        return model.to(device), model.state_dict()
    return init


# ---- batches and filters ---------------------------------------------------

def test_token_jaccard_and_filter_match_jax():
    pos = "compute the singular value decomposition of a matrix"
    cands = [pos + ".", "open a file descriptor and buffer reads", pos,
             "Compute THE singular value decomposition", "", "x"]
    for a in [pos, "", "x y", "Matrix, matrix; 3 by 3"]:
        for b in cands:
            assert tr.token_jaccard(a, b) == jr.token_jaccard(a, b)
    for t in (0.5, 0.8, 0.95):
        assert tr.filter_false_negatives(pos, cands, t) == \
            jr.filter_false_negatives(pos, cands, t)
    assert pos + "." not in tr.filter_false_negatives(pos, cands)


@pytest.mark.parametrize("with_base", [False, True])
def test_make_rerank_batch_matches_jax(with_base):
    jtok, ttok = tokenizers()
    cfg = dict(queries_per_batch=8, candidates_per_query=4, **LAYOUT)
    base = BASE if with_base else None
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        want = jr.make_rerank_batch(jtok, PAIRS, NEGATIVES[:40], jr.RerankTrainConfig(**cfg),
                                    rj, base_scores=base)
        got = tr.make_rerank_batch(ttok, PAIRS, NEGATIVES[:40], tr.RerankTrainConfig(**cfg),
                                   rt, base_scores=base, device="cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got["ids"].shape == (32, 16) and got["label"].dtype == torch.int32


def test_make_rerank_batch_guards():
    """Degenerate pair lists raise; negatives equal to the positive are
    never used."""
    _, tok = tokenizers()
    cfg = tr.RerankTrainConfig(queries_per_batch=2, candidates_per_query=3, q_len=5,
                               d_len=10)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        tr.make_rerank_batch(tok, [("q", "d")], [[]], cfg, rng, device="cpu")
    same = [("q1", "dup"), ("q2", "dup"), ("q3", "dup")]
    with pytest.raises(ValueError, match="cannot assemble"):
        tr.make_rerank_batch(tok, same, [[], [], []], cfg, rng, device="cpu")


def test_make_distill_batch_matches_jax():
    jtok, ttok = tokenizers()
    cfg = dict(queries_per_batch=4, candidates_per_query=3)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        want, wq, wd = jd.make_distill_batch(jtok, TEXTS, jd.DistillConfig(**cfg), rj, 16)
        got, gq, gd = td.make_distill_batch(ttok, TEXTS, td.DistillConfig(**cfg), rt, 16,
                                            device="cpu")
        assert (gq, gd) == (wq, wd)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# ---- warm start ------------------------------------------------------------

@pytest.fixture(scope="module")
def bi_params():
    """A bi-encoder (seed 0) in JAX's params and the port's state dict."""
    _, params = jenc.init_bi_encoder(dataclasses.replace(JCFG, lexical_match=False),
                                     out_dim=16, seed=0)
    return params, params_from_jax(numpy_tree(params))


@pytest.mark.parametrize("ce_len", [16, 24])
def test_warm_start_matches_jax_and_copies(bi_params, ce_len):
    jbi, tbi = bi_params
    jce_cfg = dataclasses.replace(JCFG, max_len=ce_len)
    _, jce = jenc.init_cross_encoder(jce_cfg, seed=1)
    want = params_from_jax(numpy_tree(jr.warm_start_cross_encoder(jce, jbi)))
    ce = params_from_jax(numpy_tree(jce))
    fresh = {k: v.clone() for k, v in ce.items()}
    before = {k: v.clone() for k, v in tbi.items()}
    got = tr.warm_start_cross_encoder(ce, tbi)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in tbi.items():
        if k.startswith("trunk."):
            assert got[k].data_ptr() != v.data_ptr(), k       # copied, not aliased
    for k in ("trunk.seg_embed.weight", "match_embed.weight", "pool.weight", "score.bias"):
        assert torch.equal(got[k], fresh[k]), k                  # fresh init kept
    for v in got.values():
        v.add_(1.0)
    for k, v in tbi.items():
        assert torch.equal(v, before[k]), k
    model = tenc.BiEncoder(dataclasses.replace(TCFG, lexical_match=False), out_dim=16)
    model.load_state_dict(tbi)
    from_module = tr.warm_start_cross_encoder(ce, model)
    assert torch.equal(from_module["trunk.tok_embed.weight"], tbi["trunk.tok_embed.weight"])


# ---- the rerank step -------------------------------------------------------

VARIANTS = {"plain": dict(residual=False, label_smoothing=0.0),
            "residual_smoothing": dict(residual=True, label_smoothing=0.05)}
RCFG = dict(queries_per_batch=8, candidates_per_query=4, **LAYOUT)


def run_jax_rerank(variant, n_steps=3):
    rcfg = jr.RerankTrainConfig(**RCFG, **VARIANTS[variant])
    student, params = jenc.init_cross_encoder(JCFG, seed=2)
    init = params_from_jax(numpy_tree(params))
    tcfg = jc.TrainConfig(**TRAIN)
    mesh = jc.build_train_mesh(1)
    step, eval_fn, p, o = jr.make_rerank_step(student, jc.make_optimizer(tcfg), tcfg, mesh,
                                              params, rcfg)
    o = canonical_opt_state(o, mesh)
    jtok, _ = tokenizers()
    rng = np.random.default_rng(4)
    batches, metrics = [], []
    for _ in range(n_steps):
        batch = {k: np.asarray(v) for k, v in jr.make_rerank_batch(
            jtok, PAIRS, NEGATIVES, rcfg, rng, base_scores=BASE).items()}
        p, o, m = step(p, o, batch, jax.random.PRNGKey(0))
        batches.append(batch)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = [float(x) for x in eval_fn(p, batches[0])]
    return init, batches, metrics, ev, params_from_jax(numpy_tree(p))


@pytest.fixture(scope="module")
def jax_rerank():
    return {v: run_jax_rerank(v) for v in VARIANTS}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rerank_step_matches_jax(jax_rerank, variant):
    init, batches, want, want_eval, want_params = jax_rerank[variant]
    rcfg = tr.RerankTrainConfig(**RCFG, **VARIANTS[variant])
    cfg = tc.TrainConfig(**TRAIN)
    student = tenc.CrossEncoder(TCFG)
    step, eval_fn, params, opt = tr.make_rerank_step(
        student, tc.make_optimizer(cfg), cfg, None, init, rcfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for batch, w in zip(batches, want):
        params, opt, got = step(params, opt, to_torch(batch), gen)
        assert student.training
        for k in w:
            np.testing.assert_allclose(float(got[k]), w[k], rtol=2e-5, err_msg=k)
    ev = eval_fn(params, to_torch(batches[0]))
    np.testing.assert_allclose([float(x) for x in ev], want_eval, rtol=2e-5)
    assert not student.training
    assert_params_close(params, want_params)


def test_train_reranker_matches_jax(monkeypatch):
    """Residual listwise training with label smoothing and early stopping on
    the held-out split: the same history, the same best step, and the best
    snapshot as the returned (host) weights."""
    rcfg = dict(steps=12, log_every=2, eval_frac=0.2, early_stop_patience=2, seed=0,
                residual=True, label_smoothing=0.05, **RCFG)
    train = jc.TrainConfig(learning_rate=3e-2, warmup_steps=1, total_steps=12)
    _, jparams = jenc.init_cross_encoder(JCFG, seed=0)
    _, want_params, want = jr.train_reranker(
        PAIRS, NEGATIVES, encoder_config=JCFG, train_config=train,
        rerank_config=jr.RerankTrainConfig(**rcfg), mesh=jc.build_train_mesh(1),
        base_scores=BASE)
    monkeypatch.setattr(tr, "init_cross_encoder", converted(jparams))
    model, params, got = tr.train_reranker(
        PAIRS, NEGATIVES, encoder_config=TCFG,
        train_config=tc.TrainConfig(**dataclasses.asdict(train)),
        rerank_config=tr.RerankTrainConfig(**rcfg), base_scores=BASE, device="cpu")
    assert want[-1].get("early_stopped") == 1.0 and "best_step" in want[-1]
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k != "elapsed_s":
                np.testing.assert_allclose(g[k], w[k], rtol=2e-5, err_msg=k)
    assert got[-1]["best_step"] == want[-1]["best_step"]
    assert all(v.device.type == "cpu" for v in params.values())
    assert_params_close(params, params_from_jax(want_params), lr=train.learning_rate)
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k


def test_train_reranker_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="base_scores"):
        tr.train_reranker(PAIRS, NEGATIVES, encoder_config=TCFG, device="cpu",
                          rerank_config=tr.RerankTrainConfig(residual=True, **LAYOUT))
    with pytest.raises(ValueError, match="max_len"):
        tr.train_reranker(PAIRS, NEGATIVES, encoder_config=TCFG, device="cpu")
    # a mesh lacking the train config's axes
    with pytest.raises(ValueError, match="lack"):
        tr.train_reranker(PAIRS, NEGATIVES, encoder_config=TCFG, mesh=single_device_mesh(),
                          rerank_config=tr.RerankTrainConfig(**LAYOUT), device="cpu")


# ---- distillation ----------------------------------------------------------

DCFG = dict(queries_per_batch=4, candidates_per_query=3)


def test_distill_step_and_teacher_match_jax(bi_params):
    """The teacher's scores (no gradient, numpy), three KL steps and the
    eval function."""
    jbi, tbi = bi_params
    bcfg = dataclasses.replace(JCFG, lexical_match=False)
    jtok, ttok = tokenizers()
    jteacher = jd.make_teacher_fn(jenc.BiEncoder(bcfg, out_dim=16), jbi, jtok, 16, 0.05)
    teacher_model = tenc.BiEncoder(dataclasses.replace(TCFG, lexical_match=False),
                                   out_dim=16)
    tteacher = td.make_teacher_fn(teacher_model, tbi, ttok, 16, 0.05)
    student, params = jenc.init_cross_encoder(JCFG, seed=3)
    init = params_from_jax(numpy_tree(params))
    train = jc.TrainConfig(**TRAIN)
    mesh = jc.build_train_mesh(1)
    jstep, jeval, p, o = jd.make_distill_step(student, jc.make_optimizer(train), train,
                                              mesh, params, jd.DistillConfig(**DCFG))
    o = canonical_opt_state(o, mesh)
    cfg = tc.TrainConfig(**TRAIN)
    tstep, teval, tp, to = td.make_distill_step(
        tenc.CrossEncoder(TCFG), tc.make_optimizer(cfg), cfg, None, init,
        td.DistillConfig(**DCFG), device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(3):
        batch, queries, docs = jd.make_distill_batch(jtok, TEXTS, jd.DistillConfig(**DCFG),
                                                     rng, 16)
        want_t = jteacher(queries, docs)
        got_t = tteacher(queries, docs)
        assert isinstance(got_t, np.ndarray) and got_t.shape == (4, 3)
        np.testing.assert_allclose(got_t, want_t, rtol=2e-5, atol=1e-5)
        batch = {k: np.asarray(v) for k, v in batch.items()}
        batch["teacher"] = want_t
        p, o, want = jstep(p, o, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, to, got = tstep(tp, to, to_torch(batch))
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5, err_msg=k)
    np.testing.assert_allclose([float(x) for x in teval(tp, to_torch(batch))],
                               [float(x) for x in jeval(p, batch)], rtol=2e-5)
    assert_params_close(tp, params_from_jax(numpy_tree(p)))
    assert not teacher_model.state_dict()["trunk.pos_embed"].any()   # never loaded


def test_distill_cross_encoder_matches_jax(bi_params, monkeypatch):
    jbi, tbi = bi_params
    bcfg = dataclasses.replace(JCFG, lexical_match=False)
    dcfg = dict(steps=4, log_every=2, **DCFG)
    train = jc.TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=60)
    _, jparams = jenc.init_cross_encoder(JCFG, seed=0)
    _, want_params, want = jd.distill_cross_encoder(
        TEXTS, jenc.BiEncoder(bcfg, out_dim=16), jbi, encoder_config=JCFG,
        train_config=train, distill_config=jd.DistillConfig(**dcfg),
        mesh=jc.build_train_mesh(1))
    monkeypatch.setattr(td, "init_cross_encoder", converted(jparams))
    teacher = tenc.BiEncoder(dataclasses.replace(TCFG, lexical_match=False), out_dim=16)
    teacher.load_state_dict(tbi)
    model, params, got = td.distill_cross_encoder(
        TEXTS, teacher, None, encoder_config=TCFG,
        train_config=tc.TrainConfig(**dataclasses.asdict(train)),
        distill_config=td.DistillConfig(**dcfg), device="cpu")
    assert [h["step"] for h in got] == [h["step"] for h in want] == [2, 4]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k != "elapsed_s":
                np.testing.assert_allclose(g[k], w[k], rtol=2e-5, err_msg=k)
    assert_params_close(params, params_from_jax(numpy_tree(want_params)),
                        lr=train.learning_rate)
    assert not model.training
