"""The port's GPT-family embedders (``models/hf_gpt2.py``,
``hf_bloom.py``, ``hf_xglm.py`` behind ``HFEmbedder``) against the JAX
package's ``HFEmbedder`` (``FlaxAutoModel`` from the PyTorch weights) on
the same checkpoint directory, for ``gpt2``, ``gpt-sw3``, ``gpt_neo``,
``gptj``, ``bloom`` and ``xglm``.

Each checkpoint is tiny (2 layers, 32 wide, 4 heads, 64 positions) and
written by transformers' PyTorch classes with every weight moved off its
initial value, beside the family's tokenizer
(``test_torch_hf_gpt_tokenizer``: GPT-2's byte-level BPE with
``<|endoftext|>`` as the pad token, BLOOM's, XGLM's Unigram):

- GPT-2 as a bare ``GPT2Model`` (no prefix), GPT-SW3 (``model_type``
  gpt-sw3, whose own tokenizer needs sentencepiece, so its
  ``tokenizer_class`` names GPT-2's) as ``GPT2LMHeadModel``;
- GPT-Neo with one global and one local layer at ``window_size`` 4, so
  the window bites on every text past four tokens;
- GPT-J with ``rotary_dim`` 4 of the 8-wide heads, as ``GPTJForCausalLM``;
- BLOOM with the residuals taken before and after the LayerNorms
  (``apply_residual_connection_post_layernorm``);
- XGLM as ``XGLMForCausalLM`` (``model.`` prefix).

Bounds: f32 within 1e-5 absolute on the unit embeddings; bf16 within 1e-2
(as tests/test_torch_hf_decoders.py), each padded on the right and on the
left."""

from __future__ import annotations

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers as tf

from advanced_rag_tpu.models.hf_cross_encoder import HFCrossEncoder as JCross
from advanced_rag_tpu.models.hf_embedder import HFEmbedder as JEmbedder
from advanced_rag_tpu_torch.models import HFEmbedder
from advanced_rag_tpu_torch.models.hf_checkpoint import (GPT, load_checkpoint, read_config,
                                                         read_safetensors)
from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
from advanced_rag_tpu_torch.models.hf_embedder import build_trunk
from test_torch_hf_gpt_tokenizer import write_bloom_dir, write_gpt2_dir, write_xglm_dir

D = 32
F32_TOL = 1e-5
BF16_TOL = 1e-2
MAX_LEN = 24
#: case -> (config class, model class, config extras, tokenizer writer)
CASES = {
    "gpt2": (tf.GPT2Config, tf.GPT2Model,
             dict(n_embd=D, n_layer=2, n_head=4, n_positions=64), write_gpt2_dir),
    "gpt-sw3": (tf.GPT2Config, tf.GPT2LMHeadModel,
                dict(n_embd=D, n_layer=2, n_head=4, n_positions=64, n_inner=48),
                write_gpt2_dir),
    "gpt_neo": (tf.GPTNeoConfig, tf.GPTNeoForCausalLM,
                dict(hidden_size=D, num_layers=2, num_heads=4, window_size=4,
                     attention_types=[[["global", "local"], 1]], max_position_embeddings=64),
                write_gpt2_dir),
    "gptj": (tf.GPTJConfig, tf.GPTJForCausalLM,
             dict(n_embd=D, n_layer=2, n_head=4, rotary_dim=4, n_positions=64),
             write_gpt2_dir),
    "bloom": (tf.BloomConfig, tf.BloomModel, dict(hidden_size=D, n_layer=2, n_head=4),
              write_bloom_dir),
    "bloom-post-ln": (tf.BloomConfig, tf.BloomForCausalLM,
                      dict(hidden_size=D, n_layer=2, n_head=4,
                           apply_residual_connection_post_layernorm=True), write_bloom_dir),
    "xglm": (tf.XGLMConfig, tf.XGLMForCausalLM,
             dict(d_model=D, num_layers=2, attention_heads=4, ffn_dim=64,
                  max_position_embeddings=64), write_xglm_dir),
}
TEXTS = ["dense sparse fusion rank vector token query index shard cache",
         "How does the KERNEL scan the cache?", "", "café naïve résumé 猫",
         "rerank bucket hash table slot weight drift metric " * 3, "a b",
         "emoji \U0001F600 and more words to pass the window of four", "x"]


def write_gpt(path, case, *, seed=0, **extra):
    """A tiny checkpoint of ``case`` (a key of CASES) and its tokenizer."""
    cfg_cls, model_cls, kw, write_tokenizer = CASES[case]
    n = write_tokenizer(path)
    pad = tf.AutoTokenizer.from_pretrained(str(path), local_files_only=True).pad_token_id
    cfg = cfg_cls(vocab_size=n, pad_token_id=pad, **{**kw, **extra})
    torch.manual_seed(seed)
    model = model_cls(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model.save_pretrained(path)
    if case == "gpt-sw3":
        cfg = json.loads((path / "config.json").read_text())
        (path / "config.json").write_text(json.dumps(dict(cfg, model_type="gpt-sw3")))
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt")
    return {case: write_gpt(root / case, case, seed=i) for i, case in enumerate(CASES)}


def padded(dirs, case, side, tmp_path):
    """``case``'s directory, padding on ``side`` (a copy where its
    tokenizer_config.json says the other)."""
    path = dirs[case]
    cfg = json.loads((path / "tokenizer_config.json").read_text())
    if cfg.get("padding_side", "right") == side:
        return path
    shutil.copytree(path, tmp_path / case)
    (tmp_path / case / "tokenizer_config.json").write_text(
        json.dumps(dict(cfg, padding_side=side)))
    return tmp_path / case


def assert_unit_rows(emb, texts, got):
    """Unit rows, but for a text without tokens (GPT-2's and BLOOM's
    tokenizers add none, so an empty text pools nothing: a zero row, as in
    JAX)."""
    tokens = emb.tokenizer(list(texts), max_length=MAX_LEN)["attention_mask"].sum(1)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), (tokens > 0).astype(float),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("case", list(CASES))
def test_embedder_matches_jax(dirs, case, side, tmp_path):
    path = padded(dirs, case, side, tmp_path)
    jemb = JEmbedder(str(path), max_len=MAX_LEN, max_batch=8)
    emb = HFEmbedder(path, max_len=MAX_LEN, max_batch=8, device="cpu")
    assert emb.tokenizer.padding_side == jemb.tokenizer.padding_side == side
    assert emb.dim == jemb.dim == D
    assert emb.model.config.model_type == case.removesuffix("-post-ln")
    want, got = jemb.encode(TEXTS), emb.encode(TEXTS)
    assert got.shape == (len(TEXTS), D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert_unit_rows(emb, TEXTS, got)
    # three texts make a bucket of four: its last row is all padding
    np.testing.assert_allclose(emb.encode(TEXTS[:3]), jemb.encode(TEXTS[:3]), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("case", list(CASES))
def test_embedder_bf16_matches_jax(dirs, case, side, tmp_path):
    path = padded(dirs, case, side, tmp_path)
    jemb = JEmbedder(str(path), max_len=MAX_LEN, max_batch=8, dtype=jnp.bfloat16)
    emb = HFEmbedder(path, max_len=MAX_LEN, max_batch=8, dtype=torch.bfloat16,
                     device="cpu")
    got = emb.encode(TEXTS)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jemb.encode(TEXTS), rtol=0, atol=BF16_TOL)
    assert_unit_rows(emb, TEXTS, got)


def test_gpt_neo_window_bites(dirs):
    """The local layer's window of 4 changes the embeddings: the same
    weights with a window of 64 (the local layer then sees every earlier
    key) give others."""
    config, state = load_checkpoint(dirs["gpt_neo"], head=False, pooler=False)
    assert config.attention_layers == ("global", "local") and config.window_size == 4
    emb = HFEmbedder(dirs["gpt_neo"], max_len=MAX_LEN, device="cpu")
    wide = build_trunk(config.__class__(**{**config.__dict__, "window_size": 64}),
                       torch.float32)
    wide.load_state_dict(state)
    narrow = emb.encode(TEXTS[:2])
    emb.model = wide
    assert np.abs(emb.encode(TEXTS[:2]) - narrow).max() > 1e-3


@pytest.mark.parametrize("family", GPT)
def test_reranker_is_refused(dirs, family):
    """None of the six has a Flax sequence classifier: JAX's class raises
    ValueError at construction, and so does the port, naming why."""
    path = dirs[family]
    with pytest.raises(ValueError, match="Unrecognized configuration class"):
        JCross(str(path), max_len=MAX_LEN)
    with pytest.raises(ValueError, match="has no class for it"):
        HFCrossEncoder(path, max_len=MAX_LEN, device="cpu")


REFUSALS = [
    ("gpt2", dict(scale_attn_weights=False), "scale_attn_weights false"),
    ("gpt2", dict(scale_attn_by_inverse_layer_idx=True),
     "scale_attn_by_inverse_layer_idx true"),
    ("bloom", dict(slow_but_exact=True, pretraining_tp=2), "slow_but_exact true"),
]


@pytest.mark.parametrize("family,extra,match", REFUSALS)
def test_fields_flax_ignores_are_refused(tmp_path, family, extra, match):
    """Each field makes PyTorch's eager model compute another model than
    Flax's, which reads none of them: the reference and the checkpoint
    disagree by more than 1e-2 on live tokens, and read_config raises
    naming the field."""
    cfg_cls, _, kw, _ = CASES[family]
    cfg = cfg_cls(vocab_size=64, **{**kw, **extra})
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = (tf.GPT2Model if family == "gpt2" else tf.BloomModel)(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model.save_pretrained(tmp_path)
    ids = np.array([[5, 6, 7, 8, 9, 10, 11, 2]])
    flax = tf.FlaxAutoModel.from_pretrained(str(tmp_path), from_pt=True,
                                            local_files_only=True)
    want = np.asarray(flax(input_ids=ids, attention_mask=np.ones_like(ids)).last_hidden_state)
    with torch.no_grad():
        got = model(input_ids=torch.from_numpy(ids)).last_hidden_state.numpy()
    assert float(np.abs(got - want).max()) > 1e-2
    with pytest.raises(ValueError, match=match):
        read_config(tmp_path)


def test_config_refusals(tmp_path):
    """A BLOOM head count that is not a power of two (Flax's ALiBi calls
    jnp.cat: AttributeError), GPT-J's rotary_dim null (a table as wide as
    the model rotates each head), attention_types that do not cover the
    layers and an activation the port does not run raise, naming what."""
    cases = [("bloom", dict(n_head=6, hidden_size=48), "n_head 6"),
             ("gptj", dict(rotary_dim=None), "rotary_dim null"),
             ("gpt_neo", dict(num_layers=3, attention_types=[[["global", "local"], 1]]),
              "attention_types"),
             ("xglm", dict(activation_function="quick_gelu"),
              "activation_function 'quick_gelu'")]
    for family, extra, match in cases:
        (tmp_path / "config.json").write_text(json.dumps({"model_type": family, **extra}))
        with pytest.raises(ValueError, match=match):
            read_config(tmp_path)
    cfg = tf.BloomConfig(vocab_size=64, hidden_size=48, n_layer=1, n_head=6)
    torch.manual_seed(0)
    tf.BloomModel(cfg).save_pretrained(tmp_path / "bloom6")
    with pytest.raises(AttributeError, match="has no attribute 'cat'"):
        tf.FlaxAutoModel.from_pretrained(str(tmp_path / "bloom6"), from_pt=True,
                                         local_files_only=True)


def test_checkpoint_buffers_are_dropped_and_missing_weights_raise(dirs, tmp_path):
    """Old GPT-2 checkpoints carry h.N.attn.bias / masked_bias buffers:
    the port drops them and answers as from the checkpoint without them;
    a weight the checkpoint lacks still raises."""
    from safetensors.torch import save_file

    src = dirs["gpt2"]
    state = read_safetensors(src / "model.safetensors")
    old = dict(state)
    for i in range(2):
        old[f"h.{i}.attn.bias"] = torch.tril(torch.ones(1, 1, 64, 64))
        old[f"h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    for name, states in (("old", old), ("short", {k: v for k, v in state.items()
                                                  if k != "h.1.mlp.c_fc.weight"})):
        shutil.copytree(src, tmp_path / name)
        save_file({k: v.contiguous() for k, v in states.items()},
                  str(tmp_path / name / "model.safetensors"), metadata={"format": "pt"})
    want = HFEmbedder(src, max_len=MAX_LEN, device="cpu").encode(TEXTS[:3])
    got = HFEmbedder(tmp_path / "old", max_len=MAX_LEN, device="cpu").encode(TEXTS[:3])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="h.1.mlp.c_fc.weight"):
        HFEmbedder(tmp_path / "short", max_len=MAX_LEN, device="cpu")


def test_pad_token_and_tokenizer_refusals(dirs, tmp_path):
    """A GPT-2 checkpoint without a pad token (GPT-2 ships none) raises at
    construction (JAX's class at its first encode), and a GPT-SW3 one
    whose tokenizer is its own (sentencepiece) raises naming it."""
    shutil.copytree(dirs["gpt2"], tmp_path / "nopad")
    cfg = json.loads((tmp_path / "nopad" / "tokenizer_config.json").read_text())
    cfg.pop("pad_token")
    (tmp_path / "nopad" / "tokenizer_config.json").write_text(json.dumps(cfg))
    (tmp_path / "nopad" / "special_tokens_map.json").unlink()
    with pytest.raises(ValueError, match="padding token"):
        JEmbedder(str(tmp_path / "nopad"), max_len=MAX_LEN).encode(["a"])
    with pytest.raises(ValueError, match="no pad_token"):
        HFEmbedder(tmp_path / "nopad", max_len=MAX_LEN, device="cpu")
    shutil.copytree(dirs["gpt-sw3"], tmp_path / "sw3")
    (tmp_path / "sw3" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "GPTSw3Tokenizer"}))
    with pytest.raises(ValueError, match="sentencepiece"):
        HFEmbedder(tmp_path / "sw3", max_len=MAX_LEN, device="cpu")


def test_max_len_past_the_positions_is_refused(dirs):
    for case in ("gpt2", "gpt_neo", "gptj", "xglm"):
        with pytest.raises(ValueError, match="exceeds the 64 positions"):
            HFEmbedder(dirs[case], max_len=65, device="cpu")
    # BLOOM's ALiBi has no table
    HFEmbedder(dirs["bloom"], max_len=96, device="cpu")


def test_families_read_their_defaults(tmp_path):
    """A config.json with model_type alone takes the family's class
    defaults (transformers' config classes), under each family's names."""
    classes = {"gpt2": tf.GPT2Config, "gpt-sw3": tf.GPT2Config, "gpt_neo": tf.GPTNeoConfig,
               "gptj": tf.GPTJConfig, "bloom": tf.BloomConfig, "xglm": tf.XGLMConfig}
    assert set(classes) == set(GPT)
    for family, cls in classes.items():
        (tmp_path / "config.json").write_text(json.dumps({"model_type": family}))
        c, d = read_config(tmp_path), cls()
        inner = (4 * d.hidden_size if family in ("gpt_neo", "bloom")
                 else d.ffn_dim if family == "xglm" else d.n_inner or 4 * d.hidden_size)
        assert (c.vocab_size, c.hidden_size, c.num_hidden_layers, c.num_attention_heads,
                c.intermediate_size) == (d.vocab_size, d.hidden_size, d.num_hidden_layers,
                                         d.num_attention_heads, inner), family
        if family != "bloom":
            assert c.max_position_embeddings == d.max_position_embeddings, family
            assert c.hidden_act == d.activation_function, family
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "bloom", "n_embed": 1024, "n_head": 16}))
    assert read_config(tmp_path).hidden_size == 1024
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt_neo"}))
    assert read_config(tmp_path).attention_layers == ("global", "local") * 12


@pytest.mark.parametrize("case", ["gpt2", "gptj", "bloom", "xglm"])
def test_flax_only_export(dirs, tmp_path, case):
    """A Flax-only checkpoint (flax_model.msgpack alone) of GPT-2 (its
    Conv1D kernels), GPT-J, BLOOM (the fused QKV) or XGLM, converted by
    scripts/torch_export_hf.py, embeds as JAX's class does on the
    PyTorch checkpoint it came from."""
    from test_torch_hf_models import load_export_script

    src = dirs[case]
    flax = tf.FlaxAutoModel.from_pretrained(str(src), from_pt=True, local_files_only=True)
    shutil.copytree(src, tmp_path / case, ignore=shutil.ignore_patterns("model.safetensors"))
    flax.save_pretrained(tmp_path / case)
    with pytest.raises(ValueError, match="torch_export_hf.py"):
        HFEmbedder(tmp_path / case, max_len=MAX_LEN, device="cpu")
    assert load_export_script().export(tmp_path / case) == tmp_path / case / "model.safetensors"
    want = JEmbedder(str(src), max_len=MAX_LEN).encode(TEXTS)
    got = HFEmbedder(tmp_path / case, max_len=MAX_LEN, device="cpu").encode(TEXTS)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
