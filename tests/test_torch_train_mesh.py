"""The port's training mesh (advanced_rag_tpu_torch/train/contrastive.py:
build_train_mesh, param_partition_spec, the data- and tensor-parallel
step; the rerank and distillation steps and train_biencoder on a mesh)
against the JAX package.

The port runs on four Gloo ranks on the CPU (tests/torch_dist_worker.py,
one spawn for the module) on the (data 2, model 2) mesh that
``build_train_mesh(4)`` makes.  JAX runs ``make_train_step``,
``make_rerank_step``, ``make_distill_step`` and ``train_biencoder`` on
``build_train_mesh(4)`` over ``jax.devices()[:4]``, in f32, from the same
(converted) initial weights and batches; the cross-encoder there has no
dropout (each framework draws its own masks).  Tolerances: loss 1e-5 and
gradient norm 1e-4 relative per step; each tensor's first-step gradient
within 1e-4 of its norm (plus 1e-7 for the attention key biases, whose
true gradient is zero); the rerank and distillation metrics and the
loop's history 2e-5 relative (its gradient norm 1e-4); the parameters
after the updates as tests/test_torch_train.py holds the unsharded step
(atol 2e-5; the key biases and, under the listwise loss, the score bias 3
* lr, since a softmax is invariant to them).  Each is also held to the
port on one rank in this process, and so is the reranker with attention
dropout drawn from a generator seeded alike on every rank (metrics 1e-5
relative, parameters as above).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from advanced_rag_tpu.models import encoder as jenc
from advanced_rag_tpu.models.tokenizer import HashingTokenizer as JTokenizer
from advanced_rag_tpu.models.tokenizer import TokenizerConfig as JTokConfig
from advanced_rag_tpu.train import contrastive as jc
from advanced_rag_tpu.train import distill as jd
from advanced_rag_tpu.train import loop as jloop
from advanced_rag_tpu.train import rerank as jr
from advanced_rag_tpu_torch.models import encoder as tenc
from advanced_rag_tpu_torch.models.convert import params_from_jax
from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from advanced_rag_tpu_torch.train import contrastive as tc
from advanced_rag_tpu_torch.train import distill as td
from advanced_rag_tpu_torch.train import loop as tloop
from advanced_rag_tpu_torch.train import rerank as tr

TINY = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
            max_len=16, lexical_pool=True)
OUT = 16
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, temperature=0.1)
TEXTS = [f"document {i} concerns subject {i % 13} with detail token tok{i} "
         f"tok{i + 1} tok{i + 2} extra words here" for i in range(64)]
CE = dict(TINY, lexical_match=True, dropout=0.1)
CE_JAX = dict(CE, dropout=0.0)
RERANK = dict(queries_per_batch=4, candidates_per_query=3, q_len=6, d_len=9)
DISTILL = dict(queries_per_batch=4, candidates_per_query=3)
LOOP = dict(steps=2, batch_size=8, eval_every=2, eval_pairs=4, log_every=1)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_contrastive_inputs():
    """The bi-encoder's init (seed 0, the loop's too) and two batches, the
    second with hard negatives."""
    cfg = jenc.EncoderConfig(dtype=jnp.float32, **TINY)
    model, params = jenc.init_bi_encoder(cfg, out_dim=OUT, seed=0)
    rng = np.random.default_rng(0)
    batches = [{k: np.asarray(v) for k, v in
                jc.synthetic_pair_batch(jax_tokenizer(), TEXTS, 16, rng, max_len=16).items()}
               for _ in range(2)]
    batches[1]["n_ids"] = batches[1]["d_ids"][::-1].copy()
    batches[1]["n_mask"] = batches[1]["d_mask"][::-1].copy()
    return dict(model=model, jparams=params, init=params_from_jax(numpy_tree(params)),
                batches=batches)


def jax_contrastive(inp):
    """JAX's step on build_train_mesh(4): two updates; and its gradient at
    the first batch."""
    model, params, batches = inp["model"], inp["jparams"], inp["batches"]
    tcfg = jc.TrainConfig(**TRAIN)

    def loss(p, b):
        q = model.apply(p, b["q_ids"], b["q_mask"])
        d = model.apply(p, b["d_ids"], b["d_mask"])
        return jc._info_nce(q, d, tcfg.temperature)[0]

    grads = params_from_jax(numpy_tree(jax.grad(loss)(params, batches[0])))
    mesh = jc.build_train_mesh(4)
    assert mesh.shape == {"data": 2, "model": 2}
    step, p, o = jc.make_train_step(model, jc.make_optimizer(tcfg), tcfg, mesh,
                                    jax.tree_util.tree_map(jnp.array, params))
    metrics = []
    for b in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(grads=grads, metrics=metrics, params=params_from_jax(numpy_tree(p)))


def torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def jax_tokenizer():
    return JTokenizer(JTokConfig(vocab_size=TINY["vocab_size"], max_len=TINY["max_len"]))


PAIRS = [(f"question {i} subject {i % 5}", TEXTS[i]) for i in range(12)]
NEGATIVES = [[TEXTS[(i + j + 1) % 64] for j in range(3)] for i in range(12)]


def cross_batches():
    """Two listwise batches and two distillation batches (random teacher
    scores), drawn by the JAX functions."""
    tok, rng = jax_tokenizer(), np.random.default_rng(5)
    rcfg = jr.RerankTrainConfig(**RERANK)
    rerank = [{k: np.asarray(v) for k, v in
               jr.make_rerank_batch(tok, PAIRS, NEGATIVES, rcfg, rng).items()}
              for _ in range(2)]
    distill = []
    for _ in range(2):
        batch, _, _ = jd.make_distill_batch(tok, TEXTS, jd.DistillConfig(**DISTILL), rng, 16)
        batch = {k: np.asarray(v) for k, v in batch.items()}
        batch["teacher"] = rng.standard_normal((4, 3)).astype(np.float32) * 3
        distill.append(batch)
    return rerank, distill


def jax_cross_init():
    """The cross-encoder (no dropout) and its init."""
    return jenc.init_cross_encoder(jenc.EncoderConfig(dtype=jnp.float32, **CE_JAX), seed=3)


def jax_cross(student, params, rerank, distill):
    """JAX's rerank and distillation steps on build_train_mesh(4), two each,
    from one cross-encoder init (no dropout)."""
    tcfg = jc.TrainConfig(**TRAIN)
    out = {}
    for kind, batches in (("rerank", rerank), ("distill", distill)):
        mesh = jc.build_train_mesh(4)
        p0 = jax.tree_util.tree_map(jnp.array, params)
        if kind == "rerank":
            step, _, p, o = jr.make_rerank_step(student, jc.make_optimizer(tcfg), tcfg, mesh,
                                                p0, jr.RerankTrainConfig(**RERANK))
            run = lambda p, o, b: step(p, o, b, jax.random.PRNGKey(0))  # noqa: E731
        else:
            step, _, p, o = jd.make_distill_step(student, jc.make_optimizer(tcfg), tcfg, mesh,
                                                 p0, jd.DistillConfig(**DISTILL))
            run = step
        metrics = []
        for b in batches:
            p, o, m = run(p, o, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[kind] = dict(metrics=metrics, params=params_from_jax(numpy_tree(p)))
    return out


def jax_loop():
    """JAX's train_biencoder on build_train_mesh(4): history and weights."""
    cfg = jenc.EncoderConfig(dtype=jnp.float32, **TINY)
    _, params, hist = jloop.train_biencoder(
        TEXTS, encoder_config=cfg, out_dim=OUT, train_config=jc.TrainConfig(**TRAIN),
        loop_config=jloop.TrainLoopConfig(**LOOP), mesh=jc.build_train_mesh(4))
    return dict(history=hist, params=params_from_jax(numpy_tree(params)))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The ranks run in a thread while this process computes JAX's side."""
    inp = jax_contrastive_inputs()
    rerank, distill = cross_batches()
    student, jce = jax_cross_init()
    init_ce = params_from_jax(numpy_tree(jce))
    init_drop = tenc.init_cross_encoder(tenc.EncoderConfig(**CE), seed=3, device="cpu")[1]
    enc = dict(TINY, dtype=torch.float32)
    ce = dict(CE_JAX, dtype=torch.float32)
    d = {"contrastive": dict(enc=enc, out=OUT, train=TRAIN, init=inp["init"],
                             batches=[torch_batch(b) for b in inp["batches"]]),
         "train": TRAIN,
         "rerank": dict(enc=ce, init=init_ce, cfg=RERANK,
                        batches=[torch_batch(b) for b in rerank]),
         "rerank_dropout": dict(enc=dict(CE, dtype=torch.float32),
                                init={k: v.clone() for k, v in init_drop.items()},
                                cfg=RERANK, batches=[torch_batch(b) for b in rerank]),
         "distill": dict(enc=ce, init=init_ce, cfg=DISTILL,
                         batches=[torch_batch(b) for b in distill]),
         "loop": dict(texts=TEXTS, loop=LOOP)}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(worker.run_ranks, "train_mesh", 4, d,
                            tmp_path_factory.mktemp("train_mesh"))
        want = jax_contrastive(inp)
        want.update(jax_cross(student, jce, rerank, distill))
        want["loop"] = jax_loop()
        got = ranks.result()
    return d, want, got


#: parameters a softmax is invariant to (the attention key biases; the
#: score bias under the listwise loss over each slate): their true gradient
#: is zero, and Adam turns each run's rounding noise into steps of up to lr
SOFTMAX_INVARIANT = ("attn.key.bias", "score.bias")


def assert_params_close(got, want, lr=TRAIN["learning_rate"]):
    assert set(got) == set(want)
    for k, v in want.items():
        atol = 3 * lr if k.endswith(SOFTMAX_INVARIANT) else 2e-5
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def test_train_mesh_rule(case):
    _, _, got = case
    assert all(g["shape"] == {"data": 2, "model": 2} for g in got)
    assert tc.build_train_mesh().shape == {"data": 1, "model": 1}
    cfg = tc.TrainConfig(data_axis="batch", model_axis="tensor")
    assert tc.build_train_mesh(1, cfg).axis_names == ("batch", "tensor")


@pytest.mark.parametrize("shipped", ["bi-encoder", "reranker"])
def test_partition_spec_names_the_jax_weights_and_axes(shipped):
    """At the shipped geometry and model axis 2: each Flax leaf filled with
    its coordinate along the axis JAX shards, converted by
    ``params_from_jax``, varies along exactly the torch dim the port names
    (and along none where JAX replicates)."""
    tcfg = tenc.SHIPPED_BIENCODER if shipped == "bi-encoder" else tenc.SHIPPED_RERANKER
    jcfg = jenc.EncoderConfig(**{f.name: getattr(tcfg, f.name) for f in
                                 dataclasses.fields(jenc.EncoderConfig)
                                 if f.name != "dtype" and hasattr(tcfg, f.name)})
    key = jax.random.PRNGKey(0)
    ids = jnp.zeros((1, jcfg.max_len), jnp.int32)
    mask = jnp.ones((1, jcfg.max_len), jnp.float32)
    if shipped == "bi-encoder":
        jmodel = jenc.BiEncoder(jcfg, out_dim=tenc.SHIPPED_BIENCODER_OUT_DIM)
        shapes = jax.eval_shape(jmodel.init, key, ids, mask)
    else:
        jmodel = jenc.CrossEncoder(jcfg)
        shapes = jax.eval_shape(jmodel.init, key, ids, mask, jnp.zeros_like(ids))
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    jspec = jc.param_partition_spec(shapes, mesh, "model")

    def marked(shape, spec):
        axis = [a for a, name in enumerate(spec) if name == "model"]
        if not axis:
            return np.zeros(shape.shape, np.float32)
        coord = np.arange(shape.shape[axis[0]], dtype=np.float32)
        view = [1] * len(shape.shape)
        view[axis[0]] = -1
        return np.broadcast_to(coord.reshape(view), shape.shape)

    marks = params_from_jax(jax.tree_util.tree_map(
        marked, shapes, jspec, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
    with torch.device("meta"):
        module = (tenc.BiEncoder(tcfg, out_dim=tenc.SHIPPED_BIENCODER_OUT_DIM)
                  if shipped == "bi-encoder" else tenc.CrossEncoder(tcfg))
    spec = tc.param_partition_spec(dict(module.named_parameters()), mesh, "model",
                                   num_heads=tcfg.num_heads)
    assert set(spec) == set(marks)
    sharded = 0
    for name, m in marks.items():
        varies = [d for d in range(m.dim()) if m.shape[d] > 1
                  and not torch.equal(m, m.select(d, 0).unsqueeze(d).expand_as(m))]
        assert spec[name] == (varies[0] if varies else None), name
        assert len(varies) <= 1, name
        sharded += spec[name] is not None
    assert sharded >= 6 * tcfg.num_layers     # q, k, v, out, mlp_in, mlp_out per block


def test_step_matches_jax_on_data2_model2(case):
    d, want, got = case
    for g in got:
        for m, w in zip(g["metrics"], want["metrics"]):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=1e-4)
            np.testing.assert_allclose(m["accuracy"], w["accuracy"], rtol=1e-5)
        assert_params_close(g["params"], want["params"])
    for k, v in got[0]["params"].items():       # every rank holds the same weights
        assert all(torch.equal(g["params"][k], v) for g in got), k


def whole_grads(got):
    """The first-step gradient of each tensor, whole: its slices from the
    ranks at data 0 (model 0, then 1) joined along the sharded dim.  The
    ranks at data 1 hold the same slices (the gradients summed over
    data)."""
    by = {(g["coords"]["data"], g["coords"]["model"]): g for g in got}
    out = {}
    for name, dim in got[0]["sliced"].items():
        parts = [by[(0, m)]["grads"][name] for m in range(2)]
        for m in range(2):
            assert torch.equal(by[(1, m)]["grads"][name], parts[m]), name
        out[name] = parts[0] if dim is None else torch.cat(parts, dim)
    return out


def test_first_step_gradient_matches_jax(case):
    _, want, got = case
    grads = whole_grads(got)
    for name, w in want["grads"].items():
        assert grads[name].shape == w.shape, name
        err = float(torch.linalg.vector_norm(grads[name] - w))
        floor = 1e-7 if name.endswith("attn.key.bias") else 0.0
        assert err <= 1e-4 * float(torch.linalg.vector_norm(w)) + floor, name


def test_weights_and_optimizer_state_are_sliced(case):
    """Between steps each model rank holds 1/2 of every sharded weight, of
    its gradient and of its AdamW moments (the module's own parameters),
    the rest whole; ``full_params`` gathers the whole weights."""
    d, _, got = case
    init = d["contrastive"]["init"]
    full = sum(v.numel() for v in init.values())
    sliced = sum(init[n].numel() for n, dim in got[0]["sliced"].items() if dim is not None)
    assert sliced > full // 2
    held = full - sliced // 2
    for g in got:
        assert g["held"] == dict(params=held, grads=held, adam=2 * held)
        assert g["whole"] == full


def one_rank_steps(kind, d):
    c = d[kind]
    student = tenc.CrossEncoder(tenc.EncoderConfig(**c["enc"]))
    tcfg = tc.TrainConfig(**TRAIN)
    if kind == "distill":
        step, _, params, opt = td.make_distill_step(student, tc.make_optimizer(tcfg), tcfg,
                                                    None, c["init"],
                                                    td.DistillConfig(**c["cfg"]), device="cpu")
        run = step
    else:
        step, _, params, opt = tr.make_rerank_step(student, tc.make_optimizer(tcfg), tcfg, None,
                                                   c["init"], tr.RerankTrainConfig(**c["cfg"]),
                                                   device="cpu")
        gen = torch.Generator().manual_seed(7)
        run = lambda p, o, b: step(p, o, b, gen)  # noqa: E731
    metrics = []
    for b in c["batches"]:
        params, opt, m = run(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params


@pytest.mark.parametrize("kind", ["rerank", "distill", "rerank_dropout"])
def test_rerank_and_distill_steps_take_the_mesh(case, kind):
    """On (data 2, model 2) against JAX's steps on build_train_mesh(4)
    (without dropout) and against the port on one rank (with dropout
    too)."""
    d, want, got = case
    refs = [(one_rank_steps(kind, d), 1e-5)]
    if kind in want:
        refs.append(((want[kind]["metrics"], want[kind]["params"]), 2e-5))
    for (want_m, want_p), rtol in refs:
        for g in got:
            for m, w in zip(g[kind], want_m):
                assert set(m) == set(w)
                for k in w:
                    np.testing.assert_allclose(m[k], w[k], rtol=rtol, err_msg=k)
            assert_params_close(g[f"{kind}_params"], want_p)


def test_train_biencoder_on_the_mesh(case):
    """The loop on (data 2, model 2) against JAX's train_biencoder on
    build_train_mesh(4) and the port's on one rank, from the same init:
    the history and the trained weights."""
    d, want, got = case

    def converted_init(config, out_dim, seed=0, device=None):
        model = tenc.BiEncoder(config, out_dim=out_dim)
        model.load_state_dict(d["contrastive"]["init"])
        return model.to(device), model.state_dict()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "init_bi_encoder", converted_init)
        _, one_params, one = tloop.train_biencoder(
            TEXTS, encoder_config=tenc.EncoderConfig(**d["contrastive"]["enc"]), out_dim=OUT,
            train_config=tc.TrainConfig(**TRAIN), loop_config=tloop.TrainLoopConfig(**LOOP),
            device="cpu")
    for ref, ref_params in ((want["loop"]["history"], want["loop"]["params"]),
                            (one, one_params)):
        assert [h["step"] for h in ref] == [1, 2]
        for g in got:
            assert [h["step"] for h in g["loop"]] == [1, 2]
            for gh, w in zip(g["loop"], ref):
                assert set(gh) == set(w) - {"elapsed_s"}
                for k in gh:
                    rtol = 1e-4 if k == "grad_norm" else 2e-5
                    np.testing.assert_allclose(gh[k], w[k], rtol=rtol, err_msg=k)
            assert_params_close(g["loop_params"], ref_params)
