"""The port's encoders in train mode (advanced_rag_tpu_torch/models/encoder.py)
against Flax: the attention dropout and the initializers of
``init_bi_encoder`` / ``init_cross_encoder``.

Each framework draws its own random numbers, so the dropout parity test
feeds both the same keep masks (through the frameworks' own draw
functions, patched for the test) and compares the cross-encoder scores:
f32 to rtol 1e-4 / atol 1e-5, bf16 to atol 5e-2 (the bf16 tolerance of
tests/test_torch_encoder.py).  The initializers are compared by their
distributions (per-tensor std, truncation), not by their numbers.
Geometry: tests/test_train.py's TINY for dropout, a medium width (H 128)
for the initializers, so that the tensors are large enough for a 3%
standard-deviation comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.models import encoder as jenc
from advanced_rag_tpu_torch.models import encoder as tenc
from advanced_rag_tpu_torch.models.convert import params_from_jax

TINY = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
            max_len=16)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(dtype, **kw):
    jd, td = DTYPES[dtype]
    return (jenc.EncoderConfig(dtype=jd, **{**TINY, **kw}),
            tenc.EncoderConfig(dtype=td, **{**TINY, **kw}))


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, 1.109375),
                                        (torch.float32, np.float32(1) / np.float32(0.9))])
def test_dropout_multiplier(dtype, want):
    gen = torch.Generator().manual_seed(0)
    m = tenc.dropout_multiplier(64, 0.1, dtype, gen)
    assert m.shape == (1, 1, 64, 64) and m.dtype == dtype
    values = set(m.unique().float().tolist())
    assert values == {0.0, float(want)}
    keep = float((m > 0).float().mean())
    assert 0.88 < keep < 0.92
    again = tenc.dropout_multiplier(64, 0.1, dtype, torch.Generator().manual_seed(0))
    assert torch.equal(m, again)


def tokens(rng, b, length, vocab):
    ids = rng.integers(8, vocab, size=(b, length)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.ones((b, length), np.float32)
    mask[1, length - 3:] = 0.0
    return ids, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dropout_matches_flax_for_one_mask(dtype, monkeypatch):
    """Given the same keep masks, Flax's attention dropout and the port's
    give the same cross-encoder scores: the mask lands on the softmaxed
    weights before V, one [1, 1, L, L] mask per block, and the multiplier
    is rounded as Flax rounds it.  (Each framework draws its own masks.)"""
    rate, length = 0.3, 12
    jcfg, tcfg = configs(dtype, dropout=rate, lexical_match=True)
    model, params = jenc.init_cross_encoder(jcfg, seed=4)
    rng = np.random.default_rng(5)
    ids, mask = tokens(rng, 3, length, TINY["vocab_size"])
    segs = (np.arange(length)[None, :] >= 5).astype(np.int32).repeat(3, 0)
    keeps = [rng.random((1, 1, length, length)) < 1 - rate for _ in range(TINY["num_layers"])]
    calls = {"jax": 0, "torch": 0}

    def fake_bernoulli(key, p, shape):
        assert tuple(shape) == (1, 1, length, length) and p == pytest.approx(1 - rate)
        calls["jax"] += 1
        return jnp.asarray(keeps[calls["jax"] - 1])

    monkeypatch.setattr(jax.random, "bernoulli", fake_bernoulli)
    want = np.asarray(model.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                  jnp.asarray(segs), deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)}))
    real_rand = torch.rand

    def fake_rand(shape, generator=None, device=None):
        assert tuple(shape) == (1, 1, length, length) and generator is not None
        calls["torch"] += 1
        return torch.from_numpy(np.where(keeps[calls["torch"] - 1], 0.0, 1.0)
                                .astype(np.float32))

    tmodel = tenc.CrossEncoder(tcfg)
    tmodel.load_state_dict(params_from_jax(numpy_tree(params)))
    args = [torch.from_numpy(a) for a in (ids, mask, segs)]
    monkeypatch.setattr(torch, "rand", fake_rand)
    with torch.no_grad():
        got = tmodel.train()(*args, generator=torch.Generator()).numpy()
    monkeypatch.setattr(torch, "rand", real_rand)
    assert calls == {"jax": 2, "torch": 2}
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "f32" else dict(rtol=0, atol=5e-2)
    np.testing.assert_allclose(got, want, **tol)
    with torch.no_grad():
        plain = tmodel.eval()(*args).numpy()
    assert np.abs(plain - want).max() > 1e-3        # the masks did act


def test_dropout_is_seeded_broadcast_and_off_in_eval():
    """In train() mode with a generator: the same seed gives the same
    output, another seed another, and identical rows of a batch stay
    identical (one mask across the batch).  eval(), and train() without a
    generator, are bit-identical to the model built without dropout."""
    _, tcfg = configs("bf16", dropout=0.1, lexical_match=True)
    model = tenc.init_flax(tenc.CrossEncoder(tcfg), torch.Generator().manual_seed(0))
    plain = tenc.CrossEncoder(dataclasses.replace(tcfg, dropout=0.0))
    plain.load_state_dict(model.state_dict())
    ids, mask = tokens(np.random.default_rng(1), 2, 14, TINY["vocab_size"])
    ids, mask = np.repeat(ids[:1], 3, 0), np.ones((3, 14), np.float32)
    args = [torch.from_numpy(a) for a in
            (ids, mask, (np.arange(14)[None, :] >= 6).astype(np.int32).repeat(3, 0))]
    with torch.no_grad():
        want = plain.eval()(*args)
        assert torch.equal(model.eval()(*args), want)
        assert torch.equal(model.train()(*args), want)
        a = model(*args, generator=torch.Generator().manual_seed(7))
        b = model(*args, generator=torch.Generator().manual_seed(7))
        c = model(*args, generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, want)
    assert torch.equal(a[0], a[1]) and torch.equal(a[0], a[2])


def test_init_distributions_match_flax():
    """init_bi_encoder / init_cross_encoder against Flax's initializers at a
    medium width: per-tensor std within 3% of Flax's for tensors of at
    least 16,384 entries (smaller ones within 5 standard errors of the
    expected std), dense kernels truncated at two standard deviations, the
    embeddings not, biases 0 and scales 1."""
    geo = dict(vocab_size=2048, hidden_dim=128, num_layers=1, num_heads=4,
               mlp_dim=512, max_len=128, lexical_pool=True)
    jcfg = jenc.EncoderConfig(**geo)
    tcfg = tenc.EncoderConfig(**geo)
    cases = [(jenc.init_bi_encoder(jcfg, 384, seed=0)[1],
              tenc.init_bi_encoder(tcfg, 384, seed=0, device="cpu")[1])]
    jce = dataclasses.replace(jcfg, lexical_match=True, lexical_pool=False)
    tce = dataclasses.replace(tcfg, lexical_match=True, lexical_pool=False)
    cases.append((jenc.init_cross_encoder(jce, seed=1)[1],
                  tenc.init_cross_encoder(tce, seed=1, device="cpu")[1]))
    for jparams, got in cases:
        want = params_from_jax(numpy_tree(jparams))
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape and g.dtype == torch.float32, k
            if k.endswith("bias"):
                assert not g.any(), k
                continue
            if k.endswith(("scale", "lex_scale")):
                assert torch.all(g == 1.0), k
                continue
            gs, ws = float(g.std()), float(w.std())
            if "embed" in k and not k.endswith(("pos_embed", "match_embed.weight")):
                law, cut = 1.0 / np.sqrt(g.shape[1]), None       # nn.Embed default
            elif k.endswith(("pos_embed", "match_embed.weight")):
                law, cut = 0.02, None
            else:
                law = 1.0 / np.sqrt(g.shape[1])                  # lecun, fan_in
                cut = 2.0 * law / tenc.TRUNC_NORMAL_STD
            if g.numel() >= 16384:
                assert abs(gs / ws - 1) < 0.03, (k, gs, ws)
            else:
                assert abs(gs / law - 1) < 5 / np.sqrt(2 * g.numel()), (k, gs, law)
            if cut is not None:
                assert float(g.abs().max()) <= cut * (1 + 1e-6), k
                assert float(np.abs(w.numpy()).max()) <= cut * (1 + 1e-6), k
                if g.numel() >= 16384:
                    assert float(g.abs().max()) > 0.97 * cut, k
            elif g.numel() >= 16384:
                assert float(g.abs().max()) > 3.5 * law, k      # not truncated
