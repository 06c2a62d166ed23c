"""The port's decoder-only HF embedders (``models/hf_llama.py`` behind
``HFEmbedder``, ``hf_checkpoint.py``'s Llama / Mistral / Gemma configs and
names, ``hf_spbpe.py``'s tokenizer) against the JAX package's
``HFEmbedder`` (``FlaxAutoModel`` from the PyTorch weights) on the same
checkpoint directory.

Each checkpoint is tiny (2 layers, 32 wide, 4 heads, FFN 64, 64 positions:
JAX's Flax side builds a [max_pos, max_pos] mask per layer) and written by
transformers' PyTorch classes with every weight moved off its initial
value, beside a SentencePiece BPE ``tokenizer.json``
(``test_torch_hf_spbpe.write_spbpe_dir``):

- Llama with multi-head attention (4 KV heads), saved as
  ``LlamaForCausalLM`` (its ``lm_head`` left out as FlaxAutoModel leaves
  it), and with grouped-query attention (2 KV heads);
- Mistral with ``sliding_window`` 4 at ``max_len`` 16, so the window hides
  keys that the causal mask alone would show;
- Gemma with multi-query attention (1 KV head) and ``head_dim`` 16, not
  hidden / heads = 8.

Bounds: f32 within 1e-5 absolute on the unit embeddings; bf16 within 1e-2
(as tests/test_torch_hf_families.py).  The texts differ in length, so
every batch is padded, on the tokenizer's default left or on the right."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import (GemmaConfig, GemmaModel, LlamaConfig, LlamaForCausalLM,
                          LlamaModel, MistralConfig, MistralModel)

from advanced_rag_tpu.models.hf_embedder import HFEmbedder as JEmbedder
from advanced_rag_tpu_torch.models import HFEmbedder
from advanced_rag_tpu_torch.models.hf_checkpoint import read_config, read_state_dict
from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
from test_torch_hf_spbpe import write_spbpe_dir

D = 32
F32_TOL = 1e-5
BF16_TOL = 1e-2
GEOMETRY = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=64, rms_norm_eps=1e-5)
CASES = {
    "llama-mha": (LlamaConfig, LlamaForCausalLM, dict(num_key_value_heads=4)),
    "llama-gqa": (LlamaConfig, LlamaModel, dict(num_key_value_heads=2)),
    "mistral": (MistralConfig, MistralModel, dict(num_key_value_heads=2, sliding_window=4)),
    "gemma": (GemmaConfig, GemmaModel, dict(num_key_value_heads=1, head_dim=16)),
}
WEIGHTS = {"safetensors": "model.safetensors", "bin": "pytorch_model.bin",
           "sharded-bin": "pytorch_model.bin.index.json",
           "sharded-safetensors": "model.safetensors.index.json"}
TEXTS = ["dense sparse fusion rank vector token query index shard cache",
         "How does the KERNEL scan the cache?", "", "café naïve résumé 猫",
         "rerank bucket hash table slot weight drift metric " * 3, "a b",
         "emoji \U0001F600 and more words to pass the window of four"] * 2


def write_decoder(path, case, *, fmt="safetensors", seed=0, padding_side=None,
                  dtype=torch.float32, **extra):
    """A tiny checkpoint of ``case`` (a key of CASES) and its tokenizer,
    its weights stored in ``dtype``."""
    cfg_cls, model_cls, kw = CASES[case]
    layout = "gemma" if case == "gemma" else "legacy"
    n = write_spbpe_dir(path, layout, config={"padding_side": padding_side}
                        if padding_side else None)
    cfg = cfg_cls(vocab_size=n, **{**GEOMETRY, **kw, **extra})
    torch.manual_seed(seed)
    model = model_cls(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.add_((0.3 if "norm" in name else 0.05) * torch.randn_like(p))
    model.to(dtype).save_pretrained(path, safe_serialization=fmt.endswith("safetensors"),
                          **({"max_shard_size": "20KB"} if fmt.startswith("sharded") else {}))
    assert (path / WEIGHTS[fmt]).exists() and not (path / "flax_model.msgpack").exists()
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("decoders")
    return {case: write_decoder(root / case, case) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("padding_side", [None, "right"])
def test_embedder_matches_jax(tmp_path, ckpts, case, padding_side):
    path = ckpts[case] if padding_side is None else write_decoder(
        tmp_path, case, padding_side=padding_side)
    max_len = 16 if case == "mistral" else 24
    jemb = JEmbedder(str(path), max_len=max_len, max_batch=8)
    emb = HFEmbedder(path, max_len=max_len, max_batch=8, device="cpu")
    assert emb.dim == jemb.dim == D
    assert emb.tokenizer.padding_side == (padding_side or "left")
    want, got = jemb.encode(TEXTS), emb.encode(TEXTS)
    assert got.shape == (len(TEXTS), D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(np.linalg.norm(got[[0, 1, 3, 4]], axis=1), 1.0, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_embedder_bf16_matches_jax(ckpts, case):
    path = ckpts[case]
    jemb = JEmbedder(str(path), max_len=24, max_batch=8, dtype=jnp.bfloat16)
    emb = HFEmbedder(path, max_len=24, max_batch=8, dtype=torch.bfloat16, device="cpu")
    assert emb.model.layers[0].mlp.up_proj.weight.dtype == torch.bfloat16
    assert emb.model.norm.weight.dtype == torch.float32
    got = emb.encode(TEXTS)
    np.testing.assert_allclose(got, jemb.encode(TEXTS), rtol=0, atol=BF16_TOL)
    np.testing.assert_allclose(np.linalg.norm(got[:2], axis=1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt", ["bin", "sharded-bin", "sharded-safetensors"])
def test_weight_files_match_jax(tmp_path, fmt):
    """pytorch_model.bin and sharded indexes of either kind; the sharded
    safetensors in bf16, as a 7B model ships (shards of half-precision
    tensors).  Flax's from_pt reads no sharded safetensors, so JAX reads
    that one's weights from a whole bf16 file written from the same seed."""
    half = fmt == "sharded-safetensors"
    dtype = torch.bfloat16 if half else torch.float32
    path = write_decoder(tmp_path / fmt, "llama-gqa", fmt=fmt, seed=2, dtype=dtype)
    if fmt.startswith("sharded"):
        index = json.loads((path / WEIGHTS[fmt]).read_text())
        assert len(set(index["weight_map"].values())) > 2
    if half:
        assert {t.dtype for t in read_state_dict(path).values()} == {torch.bfloat16}
    ref = (path if not half
           else write_decoder(tmp_path / "whole", "llama-gqa", seed=2, dtype=dtype))
    emb = HFEmbedder(path, max_len=24, max_batch=8, device="cpu")
    want = JEmbedder(str(ref), max_len=24, max_batch=8).encode(TEXTS)
    np.testing.assert_allclose(emb.encode(TEXTS), want, rtol=0, atol=F32_TOL)


def test_mistral_window_bites(tmp_path, ckpts):
    """Window 4 at 16 tokens: the same weights read with a window of 64
    (every key the causal mask shows) embed long texts otherwise."""
    path = ckpts["mistral"]
    wide = tmp_path / "wide"
    wide.mkdir()
    for f in path.iterdir():
        (wide / f.name).write_bytes(f.read_bytes())
    cfg = json.loads((wide / "config.json").read_text())
    cfg["sliding_window"] = 64
    (wide / "config.json").write_text(json.dumps(cfg))
    narrow = HFEmbedder(path, max_len=16, device="cpu").encode(TEXTS[:1])
    full = HFEmbedder(wide, max_len=16, device="cpu").encode(TEXTS[:1])
    assert float(np.abs(narrow - full).max()) > 1e-3
    np.testing.assert_allclose(
        full, JEmbedder(str(wide), max_len=16).encode(TEXTS[:1]), rtol=0, atol=F32_TOL)


def test_checkpoint_names_and_config(ckpts):
    """The decoders' names load without their ``model.`` prefix, the LM head
    and the rotary buffers left out; the config takes each family's fields."""
    raw = read_state_dict(ckpts["llama-mha"])
    assert "lm_head.weight" in raw and "model.norm.weight" in raw
    cfg = read_config(ckpts["gemma"])
    assert (cfg.head_dim, cfg.num_key_value_heads, cfg.hidden_act) == (16, 1,
                                                                      "gelu_pytorch_tanh")
    cfg = read_config(ckpts["mistral"])
    assert (cfg.sliding_window, cfg.head_dim, cfg.hidden_act) == (4, 8, "silu")
    emb = HFEmbedder(ckpts["llama-mha"], max_len=8, device="cpu")
    assert set(emb.model.state_dict()) == {k[len("model."):] for k in raw
                                          if k.startswith("model.")}


REFUSALS = [
    ("llama-gqa", dict(rope_theta=500000.0), "rope_theta"),
    ("llama-gqa", dict(rope_scaling={"rope_type": "linear", "factor": 2.0}), "rope_scaling"),
    ("mistral", dict(sliding_window=None), "sliding_window"),
    ("llama-mha", dict(head_dim=16), "head_dim"),
    ("mistral", dict(head_dim=16), "head_dim"),
    ("llama-gqa", dict(mlp_bias=True), "mlp_bias"),
    ("gemma", dict(max_position_embeddings=24), "max_position_embeddings"),
]


@pytest.mark.parametrize("case,extra,field", REFUSALS)
def test_configs_the_reference_computes_otherwise_are_refused(tmp_path, case, extra, field):
    """Flax's modules hard-code rotary theta 10000 and no scaling, let each
    token see only itself when Mistral's window is null, take hidden / heads
    for a Llama or Mistral head, have no MLP biases and cut their sin/cos
    table to max_position_embeddings columns: the port refuses, naming the
    field."""
    path = write_decoder(tmp_path, case, **extra)
    with pytest.raises(ValueError, match=field):
        read_config(path)
    with pytest.raises(ValueError, match=field):
        HFEmbedder(path, max_len=8, device="cpu")


def test_flax_sliding_window_null_is_self_attention_only(tmp_path, ckpts):
    """The evidence for the Mistral refusal: with ``sliding_window`` null,
    JAX's embedder computes what a window of 0 computes (each token sees
    only itself: Flax masks with ``triu(causal, -(window or 0))``), not the
    model with a window (the same weights, window 4)."""
    null = write_decoder(tmp_path / "null", "mistral", sliding_window=None)
    zero = write_decoder(tmp_path / "zero", "mistral", sliding_window=0)
    want = JEmbedder(str(null), max_len=16).encode(TEXTS[:5])
    got = HFEmbedder(zero, max_len=16, device="cpu").encode(TEXTS[:5])
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    window = HFEmbedder(ckpts["mistral"], max_len=16, device="cpu").encode(TEXTS[:5])
    assert float(np.abs(window - want).max()) > 1e-3


def test_embedder_and_cross_encoder_refusals(tmp_path, ckpts):
    """No pad token: JAX raises at its first encode, the port at
    construction.  max_len past max_position_embeddings raises.  No decoder
    serves as a cross-encoder (JAX's FlaxAutoModelForSequenceClassification
    has no class for them)."""
    nopad = write_decoder(tmp_path / "nopad", "llama-gqa")
    cfg = json.loads((nopad / "tokenizer_config.json").read_text())
    cfg["pad_token"] = None
    (nopad / "tokenizer_config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="padding token"):
        JEmbedder(str(nopad), max_len=8).encode(["a", "b c"])
    with pytest.raises(ValueError, match="pad_token"):
        HFEmbedder(nopad, max_len=8, device="cpu")
    HFEmbedder(ckpts["llama-gqa"], max_len=64, device="cpu")
    with pytest.raises(ValueError, match="exceeds the 64 positions"):
        HFEmbedder(ckpts["llama-gqa"], max_len=65, device="cpu")
    from transformers import FlaxAutoModelForSequenceClassification

    for case, path in ckpts.items():
        with pytest.raises(ValueError, match="cross-encoder"):
            HFCrossEncoder(path, max_len=16, device="cpu")
        with pytest.raises(ValueError, match="Unrecognized configuration class"):
            FlaxAutoModelForSequenceClassification.from_pretrained(str(path), from_pt=True)


@pytest.mark.parametrize("case", ["llama-gqa", "mistral", "gemma"])
def test_flax_only_checkpoints_convert_and_match_jax(tmp_path, case):
    """A Flax-only directory of each family (flax_model.msgpack written by
    transformers' Flax class): the port refuses it naming
    scripts/torch_export_hf.py; after the script it matches JAX's class on
    the original msgpack."""
    import transformers as tf

    from test_torch_hf_models import load_export_script

    path = write_decoder(tmp_path / "pt", case)
    cfg = tf.AutoConfig.from_pretrained(path, local_files_only=True)
    flax_dir = tmp_path / "flax"
    flax_dir.mkdir()
    for f in path.iterdir():
        if f.suffix == ".json" and f.name not in ("config.json",) and "index" not in f.name:
            (flax_dir / f.name).write_bytes(f.read_bytes())
    tf.FlaxAutoModel.from_config(cfg, seed=3).save_pretrained(flax_dir)
    with pytest.raises(ValueError, match="torch_export_hf.py"):
        HFEmbedder(flax_dir, max_len=16, device="cpu")
    assert load_export_script().export(flax_dir) == flax_dir / "model.safetensors"
    want = JEmbedder(str(flax_dir), max_len=16).encode(TEXTS[:7])
    got = HFEmbedder(flax_dir, max_len=16, device="cpu").encode(TEXTS[:7])
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
