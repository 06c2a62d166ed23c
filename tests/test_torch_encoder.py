"""The port's encoders (advanced_rag_tpu_torch/models/encoder.py) against
the Flax modules on the same inputs and converted weights.

Inputs come from numpy with a seed and reach both packages as numpy.
Tolerances: in f32 the two frameworks run the same arithmetic in another
summation order, rtol 1e-4 / atol 1e-5.  In bf16 both round activations
to 8 mantissa bits at slightly different places (PyTorch's softmax and
GELU round once, JAX's per operation), so unit-norm embeddings agree to
atol 2e-2 and cross-encoder logits to atol 5e-2 at these widths.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.models import encoder as jenc
from advanced_rag_tpu_torch.models import encoder as tenc
from advanced_rag_tpu_torch.models.convert import (
    encoder_config_from_meta, load_orbax_numpy, params_from_jax)

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
SMALL = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=4,
             mlp_dim=64, max_len=40)


def configs(dtype, **kw):
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    return (jenc.EncoderConfig(dtype=jd, **SMALL, **kw),
            tenc.EncoderConfig(dtype=td, **SMALL, **kw))


def tokens(rng, b, length, vocab):
    ids = rng.integers(0, vocab, size=(b, length)).astype(np.int32)
    lens = rng.integers(3, length + 1, size=b)
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    ids[:, 0] = 1                                   # [CLS]
    mask[-1] = 0.0                                  # a fully padded row
    ids[-1] = 0
    return ids, mask


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


TOL = {"f32": dict(rtol=1e-4, atol=1e-5),
       "bf16": dict(rtol=0.0, atol=2e-2)}
CE_TOL = {"f32": dict(rtol=1e-4, atol=1e-5),
          "bf16": dict(rtol=0.0, atol=5e-2)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lexical_pool", [False, True])
def test_biencoder_matches_flax(dtype, lexical_pool):
    jcfg, tcfg = configs(dtype, lexical_pool=lexical_pool)
    model, params = jenc.init_bi_encoder(jcfg, out_dim=24, seed=3)
    rng = np.random.default_rng(0)
    ids, mask = tokens(rng, 6, 24, SMALL["vocab_size"])
    want = np.asarray(model.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    tmodel = tenc.BiEncoder(tcfg, out_dim=24)
    tmodel.load_state_dict(params_from_jax(numpy_tree(params)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_cross_segment_match_matches_flax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 20, size=(5, 30)).astype(np.int32)
    mask = (rng.random((5, 30)) > 0.2).astype(np.float32)
    segs = (np.arange(30)[None, :] >= rng.integers(5, 25, size=5)[:, None]).astype(np.int32)
    want = np.asarray(jenc.cross_segment_match(jnp.asarray(ids), jnp.asarray(mask),
                                               jnp.asarray(segs), 8))
    got = tenc.cross_segment_match(torch.from_numpy(ids), torch.from_numpy(mask),
                                   torch.from_numpy(segs), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lexical_match", [False, True])
def test_cross_encoder_matches_flax(dtype, lexical_match):
    jcfg, tcfg = configs(dtype, lexical_match=lexical_match)
    model, params = jenc.init_cross_encoder(jcfg, seed=5)
    rng = np.random.default_rng(2)
    ids, mask = tokens(rng, 6, 30, SMALL["vocab_size"])
    segs = (np.arange(30)[None, :] >= 12).astype(np.int32).repeat(6, 0)
    want = np.asarray(model.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                  jnp.asarray(segs)))
    tmodel = tenc.CrossEncoder(tcfg)
    tmodel.load_state_dict(params_from_jax(numpy_tree(params)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask),
                     torch.from_numpy(segs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **CE_TOL[dtype])


@pytest.fixture(scope="module")
def shipped():
    return (load_orbax_numpy(ARTIFACTS / "biencoder_ckpt"),
            load_orbax_numpy(ARTIFACTS / "reranker_ckpt"))


def test_shipped_presets_match_checkpoint_geometry(shipped):
    bi, ce = shipped
    assert encoder_config_from_meta(bi["encoder_config"]) == tenc.SHIPPED_BIENCODER
    assert int(bi["encoder_config"]["out_dim"]) == tenc.SHIPPED_BIENCODER_OUT_DIM
    assert encoder_config_from_meta(ce["encoder_config"]) == tenc.SHIPPED_RERANKER


def test_shipped_checkpoints_match_flax(shipped):
    """The repo's real checkpoints, converted, give Flax's embeddings and
    cross-encoder logits on a few short inputs (f32 activations: rtol 1e-4,
    atol 1e-4 over 6 layers)."""
    from advanced_rag_tpu.models.tokenizer import HashingTokenizer, TokenizerConfig

    texts = ["how does reciprocal rank fusion merge lists",
             "sparse retrieval weighs rare terms",
             "checkpoint restore rebuilds the token table"]
    tok = HashingTokenizer(TokenizerConfig(vocab_size=32768, max_len=256))

    bi, ce = shipped
    jcfg = dataclasses.replace(
        jenc.EncoderConfig(**{k: v for k, v in dataclasses.asdict(
            encoder_config_from_meta(bi["encoder_config"])).items() if k != "dtype"}),
        dtype=jnp.float32)
    tcfg = dataclasses.replace(encoder_config_from_meta(bi["encoder_config"]),
                               dtype=torch.float32)
    ids, mask = tok.encode_batch(texts, 32)
    want = np.asarray(jenc.BiEncoder(jcfg, out_dim=384).apply(
        bi["params"], jnp.asarray(ids), jnp.asarray(mask)))
    tmodel = tenc.BiEncoder(tcfg, out_dim=384)
    tmodel.load_state_dict(params_from_jax(bi["params"]))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    jcfg = dataclasses.replace(
        jenc.EncoderConfig(**{k: v for k, v in dataclasses.asdict(
            encoder_config_from_meta(ce["encoder_config"])).items() if k != "dtype"}),
        dtype=jnp.float32)
    tcfg = dataclasses.replace(encoder_config_from_meta(ce["encoder_config"]),
                               dtype=torch.float32)
    pids, pmask, psegs = tok.encode_pairs_static(texts, texts[::-1], 32, 48)
    want = np.asarray(jenc.CrossEncoder(jcfg).apply(
        ce["params"], jnp.asarray(pids), jnp.asarray(pmask),
        jnp.asarray(psegs)))
    tmodel = tenc.CrossEncoder(tcfg)
    tmodel.load_state_dict(params_from_jax(ce["params"]))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pids), torch.from_numpy(pmask),
                     torch.from_numpy(psegs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
