"""The port's bi-encoder training (advanced_rag_tpu_torch/train/contrastive.py,
train/loop.py) and the encoder's train mode (models/encoder.py) against the
JAX package on the same inputs, from the same (converted) initial weights.

Geometry: tests/test_train.py's TINY (vocab 512, H 32, 2 layers, 4 heads,
MLP 64, max_len 16) with the lexical channel, out_dim 16.

Tolerances:
- f32 activations: loss, accuracy and the pre-clip gradient norm per step
  agree to rtol 2e-5 (the same arithmetic in another summation order).
  Parameters after the steps agree to atol 2e-5, except the attention key
  biases: softmax is invariant to them, so their true gradient is zero and
  Adam turns the rounding noise of each framework into steps of up to lr;
  they agree to atol 3 * lr.
- bf16 activations: both round activations to 8 mantissa bits at slightly
  different places, and JAX scatter-adds the token embedding's gradient in
  bf16 (``nn.Embed(dtype=bf16)`` promotes the table) where the port adds it
  in f32 after the gather; loss agrees to rtol 5e-3, the gradient norm to
  rtol 3e-2, the parameters to atol 8 * lr, and the total update (params
  after less params before, all tensors) has cosine >= 0.99 with JAX's.
- optimizer: the learning rate per count equals optax's schedule (which
  runs in f32) to rtol 1e-6 and atol 1e-7 * peak; the clip and AdamW
  updates equal optax's to rtol 1e-5.

The JAX side runs once per configuration, in module-scoped fixtures (its
first step compiles in about 5 s here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from advanced_rag_tpu.models import encoder as jenc
from advanced_rag_tpu.models.tokenizer import HashingTokenizer as JTokenizer
from advanced_rag_tpu.models.tokenizer import TokenizerConfig as JTokConfig
from advanced_rag_tpu.train import contrastive as jc
from advanced_rag_tpu.train import loop as jloop
from advanced_rag_tpu_torch.models import encoder as tenc
from advanced_rag_tpu_torch.models.convert import params_from_jax
from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from advanced_rag_tpu_torch.parallel.mesh import Mesh, single_device_mesh
from advanced_rag_tpu_torch.train import contrastive as tc
from advanced_rag_tpu_torch.train import loop as tloop

TINY = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
            max_len=16, lexical_pool=True)
OUT = 16
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, temperature=0.1)
TEXTS = [f"document {i} concerns subject {i % 13} with detail token tok{i} "
         f"tok{i + 1} tok{i + 2} extra words here" for i in range(64)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(dtype, **kw):
    jd, td = DTYPES[dtype]
    return (jenc.EncoderConfig(dtype=jd, **{**TINY, **kw}),
            tenc.EncoderConfig(dtype=td, **{**TINY, **kw}))


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def jax_batch_to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def with_negatives(batch):
    """Hard negatives for a batch: every document, in reverse order."""
    out = dict(batch)
    out["n_ids"] = np.asarray(batch["d_ids"])[::-1].copy()
    out["n_mask"] = np.asarray(batch["d_mask"])[::-1].copy()
    return out


def run_jax_steps(dtype, params, n_steps=5):
    """JAX's step over n_steps synthetic batches from seed 0 (even steps with
    hard negatives) from ``params`` -> (init params, batches, metrics,
    final params)."""
    jcfg, _ = configs(dtype)
    model = jenc.BiEncoder(jcfg, out_dim=OUT)
    init = params_from_jax(numpy_tree(params))
    cfg = jc.TrainConfig(**TRAIN)
    mesh = jc.build_train_mesh(1)
    step, p, o = jc.make_train_step(model, jc.make_optimizer(cfg), cfg, mesh, params)
    # the optimizer state as the step returns it, so that the step compiles
    # once per program (with and without negatives), not once more
    o = jax.tree_util.tree_map(lambda x: jax.device_put(x, NamedSharding(mesh, P())), o)
    tok = JTokenizer(JTokConfig(vocab_size=TINY["vocab_size"], max_len=TINY["max_len"]))
    rng = np.random.default_rng(0)
    batches, metrics = [], []
    for i in range(n_steps):
        batch = {k: np.asarray(v) for k, v in
                 jc.synthetic_pair_batch(tok, TEXTS, 16, rng, max_len=16).items()}
        if i % 2:
            batch = with_negatives(batch)
        batches.append(batch)
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, batches, metrics, params_from_jax(numpy_tree(p))


@pytest.fixture(scope="module")
def jax_steps():
    # the activation dtype does not change the init (parameters are f32)
    _, params = jenc.init_bi_encoder(configs("f32")[0], out_dim=OUT, seed=0)
    # (each run gets its own copy: the JAX step donates its params)
    return {dtype: run_jax_steps(dtype, jax.tree_util.tree_map(jnp.array, params))
            for dtype in DTYPES}


def test_synthetic_pair_batch_draws_as_jax(jax_steps):
    _, batches, _, _ = jax_steps["f32"]
    tok = HashingTokenizer(TokenizerConfig(vocab_size=TINY["vocab_size"],
                                           max_len=TINY["max_len"]))
    rng = np.random.default_rng(0)
    for want in batches:
        got = tc.synthetic_pair_batch(tok, TEXTS, 16, rng, max_len=16, device="cpu")
        assert set(got) == {"q_ids", "q_mask", "d_ids", "d_mask"}
        for k, v in got.items():
            assert v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), want[k])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_step_matches_jax(jax_steps, dtype):
    init, batches, want, want_params = jax_steps[dtype]
    _, tcfg = configs(dtype)
    model = tenc.BiEncoder(tcfg, out_dim=OUT)
    cfg = tc.TrainConfig(**TRAIN)
    step, params, opt = tc.make_train_step(model, tc.make_optimizer(cfg), cfg, None,
                                           init, device="cpu")
    assert params["trunk.pos_embed"].data_ptr() == model.trunk.pos_embed.data_ptr()
    tol = dict(loss=2e-5, accuracy=2e-5, grad_norm=2e-5) if dtype == "f32" else \
        dict(loss=5e-3, accuracy=0.0, grad_norm=3e-2)
    for batch, w in zip(batches, want):
        params, opt, got = step(params, opt, jax_batch_to_torch(batch))
        for k, rtol in tol.items():
            np.testing.assert_allclose(float(got[k]), w[k], rtol=rtol, err_msg=k)
    assert opt.count == len(batches)
    lr = TRAIN["learning_rate"]
    for k, v in want_params.items():
        atol = (3 * lr if k.endswith("attn.key.bias") else 2e-5) if dtype == "f32" \
            else 8 * lr
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    got_upd = torch.cat([(params[k] - init[k]).flatten() for k in init])
    want_upd = torch.cat([(want_params[k] - init[k]).flatten() for k in init])
    assert float(torch.nn.functional.cosine_similarity(got_upd, want_upd, dim=0)) >= 0.99
    # the first update has lr 0: a later one must have moved every weight matrix
    assert float((got_upd).abs().max()) > lr


def test_schedule_matches_optax():
    for kw in (dict(learning_rate=1e-3, warmup_steps=2, total_steps=50),
               dict(learning_rate=5e-4, warmup_steps=50, total_steps=3000),
               dict(learning_rate=3e-4, warmup_steps=10, total_steps=4),
               dict(learning_rate=2e-5, warmup_steps=0, total_steps=20)):
        cfg = tc.TrainConfig(**kw)
        want = optax.warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(cfg.total_steps, cfg.warmup_steps + 1))
        sched = tc.warmup_cosine_decay(cfg)
        counts = range(0, max(cfg.total_steps, cfg.warmup_steps + 1) + 5)
        np.testing.assert_allclose([sched(c) for c in counts],
                                   [float(want(c)) for c in counts], rtol=1e-6,
                                   atol=1e-7 * cfg.learning_rate, err_msg=str(kw))
        assert sched(0) == (0.0 if cfg.warmup_steps else cfg.learning_rate)


def test_optimizer_state_matches_optax():
    """Clip and AdamW against optax's chain, three updates of random
    gradients (one above the clip norm, two below): the learning rate at
    each count, the pre-clip norm, and every parameter, biases and ones
    included (weight decay on every parameter, as mask=None)."""
    cfg = tc.TrainConfig(learning_rate=1e-2, weight_decay=0.1, warmup_steps=1,
                         total_steps=10, max_grad_norm=1.0)
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 3), "b": (3,), "scale": (4,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    init["scale"][:] = 1.0
    tx = jc.make_optimizer(jc.TrainConfig(**dataclasses.asdict(cfg)))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jo = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = tc.make_optimizer(cfg).init(tp.values())
    for scale in (3.0, 0.1, 0.2):
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        assert opt.lr == pytest.approx(opt.schedule(opt.count), rel=1e-12)
        upd, jo = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jo, jp)
        jp = optax.apply_updates(jp, upd)
        for k, g in grads.items():
            tp[k].grad = torch.from_numpy(g.copy())
        norm = opt.update()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert opt.count == 3
    # decay reached the ones: AdamW moved them off 1 by more than the decay alone
    assert not np.allclose(tp["scale"].detach().numpy(), 1.0)


@pytest.mark.parametrize("scale", [0.05, 10.0])
def test_clip_is_optax_clip_by_global_norm(scale):
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn(7, generator=gen) * scale, torch.randn(3, 2, generator=gen) * scale]
    jgrads = [jnp.asarray(g.numpy().copy()) for g in grads]
    want, _ = optax.clip_by_global_norm(1.0).update(jgrads, None)
    norm = tc.clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(jgrads)), rtol=1e-6)
    assert (float(norm) < 1.0) == (scale < 1)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_train_biencoder_matches_jax(jax_steps, tmp_path, monkeypatch):
    """The loop: history (loss, accuracy, grad_norm, eval_recall_at_1) per
    logged step and the step checkpoint, from the converted JAX init (the
    loop's seed 0, as the fixture's)."""
    jcfg, tcfg = configs("f32")
    train = jc.TrainConfig(learning_rate=2e-3, warmup_steps=2, total_steps=60,
                           temperature=0.1)
    loop = dict(steps=6, batch_size=16, eval_every=3, eval_pairs=16, log_every=3)
    init = jax_steps["f32"][0]
    _, _, want = jloop.train_biencoder(
        TEXTS, encoder_config=jcfg, out_dim=OUT, train_config=train,
        loop_config=jloop.TrainLoopConfig(**loop), mesh=jc.build_train_mesh(1))

    def converted_init(config, out_dim, seed=0, device=None):
        assert (config, out_dim, seed) == (tcfg, OUT, 0)
        model = tenc.BiEncoder(config, out_dim=out_dim)
        model.load_state_dict(init)
        return model.to(device), model.state_dict()

    monkeypatch.setattr(tloop, "init_bi_encoder", converted_init)
    model, params, got = tloop.train_biencoder(
        TEXTS, encoder_config=tcfg, out_dim=OUT,
        train_config=tc.TrainConfig(**dataclasses.asdict(train)),
        loop_config=tloop.TrainLoopConfig(**loop, checkpoint_dir=str(tmp_path)),
        device="cpu")
    assert [h["step"] for h in got] == [h["step"] for h in want] == [3, 6]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "accuracy", "grad_norm", "eval_recall_at_1"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, err_msg=k)
    cfg, out_dim, loaded = tloop.load_biencoder(tmp_path / "step_6", device="cpu")
    assert (dataclasses.replace(cfg, dtype=tcfg.dtype), out_dim) == (tcfg, OUT)
    assert not model.training
    for k, v in params.items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("axes", [dict(data_axis="batch"), dict(model_axis="tensor")])
def test_mesh_axes_are_refused(axes):
    """The axis names name the training mesh's axes: a mesh that lacks one
    is refused, and one built with those names is taken."""
    _, tcfg = configs("f32")
    cfg = tc.TrainConfig(**axes)
    model = tenc.BiEncoder(tcfg, out_dim=OUT)
    with pytest.raises(ValueError, match="lack"):
        tc.make_train_step(model, tc.make_optimizer(cfg), cfg, tc.build_train_mesh(),
                           None, device="cpu")
    mesh = tc.build_train_mesh(config=cfg)
    assert mesh.axis_names == (cfg.data_axis, cfg.model_axis)
    assert mesh.shape == {cfg.data_axis: 1, cfg.model_axis: 1}
    tc.make_train_step(model, tc.make_optimizer(cfg), cfg, mesh, None, device="cpu")


def test_mesh_is_refused():
    """Without a process group the world is one rank: a mesh of more ranks,
    or one lacking the config's axes, is refused by the step and the loop."""
    _, tcfg = configs("f32")
    model = tenc.BiEncoder(tcfg, out_dim=OUT)
    cfg = tc.TrainConfig()
    with pytest.raises(ValueError, match="does not cover"):
        tc.build_train_mesh(2)
    with pytest.raises(ValueError, match="does not cover"):
        Mesh(np.arange(2).reshape(2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="lack"):
        tc.make_train_step(model, tc.make_optimizer(cfg), cfg, single_device_mesh(), None,
                           device="cpu")
    with pytest.raises(ValueError, match="lack"):
        tloop.train_biencoder(TEXTS, encoder_config=tcfg, mesh=single_device_mesh(),
                              device="cpu")


def test_one_rank_mesh_answers_as_no_mesh(jax_steps):
    """The 1 x 1 train mesh, given explicitly, takes the same steps as
    ``mesh=None``; its partition rule shards nothing."""
    init, batches, _, _ = jax_steps["f32"]
    _, tcfg = configs("f32")
    cfg = tc.TrainConfig(**TRAIN)
    runs = []
    for mesh in (None, tc.build_train_mesh(1)):
        model = tenc.BiEncoder(tcfg, out_dim=OUT)
        step, params, opt = tc.make_train_step(model, tc.make_optimizer(cfg), cfg, mesh,
                                               init, device="cpu")
        metrics = [step(params, opt, jax_batch_to_torch(b))[2] for b in batches[:3]]
        runs.append(([{k: float(v) for k, v in m.items()} for m in metrics],
                     {k: v.clone() for k, v in params.items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    spec = tc.param_partition_spec(init, tc.build_train_mesh(1), "model",
                                   num_heads=TINY["num_heads"])
    assert set(spec) == set(init) and set(spec.values()) == {None}
