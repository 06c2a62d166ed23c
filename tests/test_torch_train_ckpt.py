"""Encoder checkpoints in the port's format (``train/loop.py``,
``train/rerank.py``: ``config.json`` plus one f32 state dict, no orbax),
and the repo's shipped orbax pair converted to it by
``scripts/torch_convert_checkpoints.py``.

Round trips are exact: the loaded module's state dict and its outputs
equal the saved one's.  The shipped pair, converted, against the JAX
package's ``load_biencoder`` / ``load_reranker`` models on 16 texts:
both run the checkpoints' own geometry, with bf16 activations, so
embeddings agree to atol 2e-2 and cross-encoder scores to atol 5e-2, the
bf16 tolerances of tests/test_torch_encoder.py.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from advanced_rag_tpu.models.cross_encoder import CrossEncoderReranker as JReranker
from advanced_rag_tpu.models.embedder import NeuralEmbedder as JEmbedder
from advanced_rag_tpu.models.tokenizer import HashingTokenizer as JTokenizer
from advanced_rag_tpu.models.tokenizer import TokenizerConfig as JTokConfig
from advanced_rag_tpu.train.loop import load_biencoder as j_load_biencoder
from advanced_rag_tpu.train.rerank import load_reranker as j_load_reranker
from advanced_rag_tpu_torch.models import encoder as tenc
from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from advanced_rag_tpu_torch.train import (load_biencoder, load_params, load_reranker,
                                          save_biencoder, save_reranker)

from test_torch_encoder import ARTIFACTS, convert_script

SMALL = tenc.EncoderConfig(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=4,
                           mlp_dim=64, max_len=40, lexical_pool=True)
TEXTS = [f"{a} {b} of the index tier"
         for a in ("how does", "why would", "when can", "what makes")
         for b in ("reciprocal rank fusion merge lists", "sparse retrieval weigh terms",
                   "a checkpoint restore rebuild tokens", "the kernel scan rows")]


def random_module(cls, cfg, seed, **kw):
    return tenc.init_weights(cls(cfg, **kw), torch.Generator().manual_seed(seed)).eval()


def test_biencoder_round_trip(tmp_path):
    model = random_module(tenc.BiEncoder, SMALL, 0, out_dim=24)
    save_biencoder(model, SMALL, 24, tmp_path)
    meta = json.loads((tmp_path / "config.json").read_text())
    want_keys = {f.name for f in dataclasses.fields(tenc.EncoderConfig)} - {"dtype"}
    assert set(meta) == want_keys | {"out_dim"} and meta["out_dim"] == 24
    cfg, out_dim, loaded = load_biencoder(tmp_path, device="cpu")
    assert cfg == SMALL and out_dim == 24 and not loaded.training
    sd, want = loaded.state_dict(), model.state_dict()
    assert sd.keys() == want.keys()
    for k in want:
        assert sd[k].dtype == torch.float32
        assert torch.equal(sd[k], want[k]), k
    ids = torch.randint(0, 512, (3, 16), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 16)
    with torch.no_grad():
        assert torch.equal(loaded(ids, mask), model(ids, mask))
    blob = load_params(tmp_path, device="cpu")
    assert blob["encoder_config"] == meta and blob["params"].keys() == want.keys()


@pytest.mark.parametrize("layout", [dict(q_len=12, d_len=20), dict()])
def test_reranker_round_trip_keeps_the_pair_layout(tmp_path, layout):
    cfg = dataclasses.replace(SMALL, lexical_pool=False, lexical_match=True)
    model = random_module(tenc.CrossEncoder, cfg, 2)
    save_reranker(model.state_dict(), cfg, tmp_path, **layout)
    meta = json.loads((tmp_path / "config.json").read_text())
    assert ("pair_q_len" in meta) == bool(layout)
    got_cfg, loaded, got_layout = load_reranker(tmp_path, device="cpu")
    assert got_cfg == cfg and got_layout == layout
    rr = CrossEncoderReranker(config=got_cfg, state_dict=loaded.state_dict(),
                              device="cpu", **got_layout)
    want = CrossEncoderReranker(config=cfg, state_dict=model.state_dict(), device="cpu",
                                **layout)
    np.testing.assert_array_equal(rr.score_pairs(TEXTS[:4], TEXTS[4:8]),
                                  want.score_pairs(TEXTS[:4], TEXTS[4:8]))


def test_load_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    save_biencoder(random_module(tenc.BiEncoder, SMALL, 0, out_dim=8), SMALL, 8, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_biencoder(tmp_path)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    out = Path(tmp_path_factory.mktemp("quality"))
    conv = convert_script()
    bcfg, out_dim = conv.convert_biencoder(ARTIFACTS / "biencoder_ckpt", out / "biencoder")
    ccfg, layout = conv.convert_reranker(ARTIFACTS / "reranker_ckpt", out / "reranker")
    assert bcfg == tenc.SHIPPED_BIENCODER and out_dim == tenc.SHIPPED_BIENCODER_OUT_DIM
    assert ccfg == tenc.SHIPPED_RERANKER and layout == {"q_len": 32, "d_len": 216}
    return out


def test_converted_shipped_biencoder_matches_jax(converted):
    jcfg, jdim, jparams = j_load_biencoder(ARTIFACTS / "biencoder_ckpt")
    cfg, out_dim, model = load_biencoder(converted / "biencoder", device="cpu")
    assert out_dim == jdim == 384 and model.lex_scale.dtype == torch.float32
    jemb = JEmbedder(dim=jdim, config=jcfg, params=jparams,
                     tokenizer=JTokenizer(JTokConfig(vocab_size=jcfg.vocab_size,
                                                     max_len=jcfg.max_len)))
    temb = NeuralEmbedder(dim=out_dim, config=cfg, state_dict=model.state_dict(),
                          tokenizer=HashingTokenizer(TokenizerConfig(
                              vocab_size=cfg.vocab_size, max_len=cfg.max_len)),
                          device="cpu")
    got, want = temb.encode(TEXTS), np.asarray(jemb.encode(TEXTS))
    assert got.shape == (16, 384) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=2e-2)


def test_converted_shipped_reranker_matches_jax(converted):
    jcfg, jparams, jlayout = j_load_reranker(ARTIFACTS / "reranker_ckpt")
    cfg, model, layout = load_reranker(converted / "reranker", device="cpu")
    assert layout == jlayout
    jrr = JReranker(config=jcfg, params=jparams, **jlayout)
    trr = CrossEncoderReranker(config=cfg, state_dict=model.state_dict(), device="cpu",
                               **layout)
    queries, docs = TEXTS, TEXTS[::-1]
    got, want = trr.score_pairs(queries, docs), np.asarray(jrr.score_pairs(queries, docs))
    assert got.shape == (16,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=5e-2)
