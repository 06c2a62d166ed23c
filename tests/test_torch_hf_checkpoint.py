"""The port's HF checkpoint reader (``models/hf_checkpoint.py``) against
transformers' PyTorch classes: the state it reads equals the model's
``state_dict`` bit for bit (``torch.equal``), whatever form the weights were
written in, and what it does not support raises naming it."""

from __future__ import annotations

import json

import pytest
import torch
from safetensors.torch import save_file
from transformers import BertConfig, BertForSequenceClassification, BertModel
from transformers import FlaxBertModel

from advanced_rag_tpu_torch.models.hf_bert import BertForSequenceClassification as TCls
from advanced_rag_tpu_torch.models.hf_bert import BertModel as TModel
from advanced_rag_tpu_torch.models.hf_checkpoint import (load_checkpoint, read_config,
                                                         read_safetensors,
                                                         read_state_dict)


def tiny_config(**kw):
    return BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=32,
                      max_position_embeddings=40, num_labels=1, **kw)


def perturbed(cls, cfg, seed=0):
    torch.manual_seed(seed)
    model = cls(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def write_as(model, path, form):
    """``model`` saved in one of the forms the reader takes; returns the
    state dict the port must read back (named for the model's own class)."""
    state = model.state_dict()
    if form in ("safetensors", "bin"):
        model.save_pretrained(path, safe_serialization=form == "safetensors")
    elif form in ("safetensors-2-shards", "bin-2-shards"):
        model.save_pretrained(path, safe_serialization=form.startswith("safe"),
                              max_shard_size="10KB")
        index = "model.safetensors.index.json" if form.startswith("safe") \
            else "pytorch_model.bin.index.json"
        assert len(set(json.loads((path / index).read_text())["weight_map"].values())) >= 2
    else:
        model.config.save_pretrained(path)
        if form == "bert-prefix":
            # a trunk saved under a pretraining model's names, with its MLM
            # head and the position_ids buffer the reader drops
            raw = {f"bert.{k}": v for k, v in state.items()}
            raw["cls.predictions.bias"] = torch.zeros(64)
            raw["bert.embeddings.position_ids"] = torch.arange(40)[None]
        elif form == "no-prefix":
            # a classifier whose trunk was saved without the prefix
            raw = {k.removeprefix("bert."): v for k, v in state.items()}
        else:                                          # "gamma-beta"
            raw = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
                    .replace("LayerNorm.bias", "LayerNorm.beta"): v
                   for k, v in state.items()}
        torch.save(raw, path / "pytorch_model.bin")
    return state


FORMS = [("safetensors", False), ("bin", False), ("safetensors-2-shards", False),
         ("bin-2-shards", True), ("bert-prefix", False), ("no-prefix", True),
         ("gamma-beta", False), ("gamma-beta", True), ("safetensors", True)]


@pytest.mark.parametrize("form,head", FORMS, ids=[f"{f}-{'cls' if h else 'base'}"
                                                  for f, h in FORMS])
def test_reader_matches_the_state_dict(tmp_path, form, head):
    model = perturbed(BertForSequenceClassification if head else BertModel,
                      tiny_config())
    want = write_as(model, tmp_path, form)
    config, got = load_checkpoint(tmp_path, head=head)
    assert_states_equal(got, want)
    assert (config.hidden_size, config.num_hidden_layers, config.num_labels) == (16, 2, 1)
    # and the port's module takes the state under its own names
    (TCls(config) if head else TModel(config)).load_state_dict(got)


def test_base_model_reads_a_classifier_checkpoint(tmp_path):
    """BertModel from a classification checkpoint: the trunk, unprefixed,
    and nothing of the head; without the pooler for the embedder."""
    model = perturbed(BertForSequenceClassification, tiny_config())
    model.save_pretrained(tmp_path)
    _, got = load_checkpoint(tmp_path, head=False, pooler=False)
    want = {k.removeprefix("bert."): v for k, v in model.state_dict().items()
            if k.startswith("bert.") and not k.startswith("bert.pooler.")}
    assert_states_equal(got, want)


def test_safetensors_dtypes_and_malformed_files(tmp_path):
    tensors = {"f32": torch.randn(3, 4), "f16": torch.randn(5).half(),
               "bf16": torch.randn(2, 2).bfloat16(), "i64": torch.arange(7),
               "empty": torch.zeros(0, 3)}
    save_file(tensors, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    assert_states_equal(read_safetensors(tmp_path / "a.safetensors"), tensors)
    save_file({"x": torch.zeros(2, dtype=torch.int8)}, str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="dtype I8"):
        read_safetensors(tmp_path / "b.safetensors")
    raw = (tmp_path / "a.safetensors").read_bytes()
    (tmp_path / "c.safetensors").write_bytes(raw[:-8])
    with pytest.raises(ValueError, match="does not hold"):
        read_safetensors(tmp_path / "c.safetensors")
    (tmp_path / "d.safetensors").write_bytes((10 ** 9).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="overruns"):
        read_safetensors(tmp_path / "d.safetensors")


@pytest.mark.parametrize("change,match", [
    ({"model_type": "roberta"}, "model_type 'roberta'"),
    ({"model_type": "xlm-roberta"}, "model_type 'xlm-roberta'"),
    ({"hidden_act": "silu"}, "hidden_act 'silu'"),
    ({"position_embedding_type": "relative_key"}, "relative_key"),
    ({"is_decoder": True}, "decoder"),
])
def test_unsupported_configs_raise_naming_what(tmp_path, change, match):
    tiny_config().save_pretrained(tmp_path)
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg.update(change)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=match):
        read_config(tmp_path)


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "gelu_pytorch_tanh", "relu"])
def test_supported_activations_match_transformers(tmp_path, act):
    """The forward of each activation the reader takes against
    transformers' PyTorch BertModel, f32, within 1e-5."""
    model = perturbed(BertModel, tiny_config(hidden_act=act))
    model.save_pretrained(tmp_path)
    config, state = load_checkpoint(tmp_path, head=False)
    port = TModel(config)
    port.load_state_dict(state)
    ids = torch.randint(5, 64, (3, 12))
    mask = torch.ones(3, 12, dtype=torch.long)
    mask[1, 7:] = 0
    types = torch.zeros_like(ids)
    types[:, 6:] = 1
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask, token_type_ids=types)
        got, pooled = port(ids, mask, types)
    torch.testing.assert_close(got, want.last_hidden_state, rtol=0, atol=1e-5)
    torch.testing.assert_close(pooled, want.pooler_output, rtol=0, atol=1e-5)


def test_flax_only_and_empty_directories_raise(tmp_path):
    FlaxBertModel(tiny_config(), seed=0).save_pretrained(tmp_path / "flax")
    with pytest.raises(ValueError, match="scripts/torch_export_hf.py"):
        read_state_dict(tmp_path / "flax")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no model.safetensors"):
        read_state_dict(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="not a checkpoint directory"):
        read_state_dict(tmp_path / "nowhere")


def test_missing_weights_raise(tmp_path):
    """A weight the module needs and the checkpoint lacks raises (Flax's
    from_pretrained draws it at random): a base model read as a
    classifier, and a trunk without its last layer."""
    from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder
    from transformers import BertTokenizerFast

    model = perturbed(BertModel, tiny_config())
    model.save_pretrained(tmp_path)
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(59)]))
    BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt")).save_pretrained(tmp_path)
    HFEmbedder(tmp_path, max_len=16, device="cpu")
    with pytest.raises(RuntimeError, match="classifier.weight"):
        HFCrossEncoder(tmp_path, max_len=16, device="cpu")
    state = {k: v for k, v in model.state_dict().items() if ".layer.1." not in k}
    (tmp_path / "model.safetensors").unlink()
    torch.save(state, tmp_path / "pytorch_model.bin")
    with pytest.raises(RuntimeError, match="encoder.layer.1"):
        HFEmbedder(tmp_path, max_len=16, device="cpu")
