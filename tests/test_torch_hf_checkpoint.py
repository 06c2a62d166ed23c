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
    # the families the port reads name themselves in what they refuse
    ({"model_type": "roberta", "position_embedding_type": "relative_key"},
     "model_type 'roberta'"),
    ({"model_type": "xlm-roberta", "is_decoder": True}, "model_type 'xlm-roberta'"),
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


# -- the other families -----------------------------------------------------------

def family_model(family, head, **extra):
    """A tiny transformers PyTorch model of ``family``: the trunk, or with
    ``head`` its sequence classifier, or with ``head="pretraining"`` the
    pretraining model whose head from_pretrained drops."""
    import transformers as tf

    geo = dict(vocab_size=64, max_position_embeddings=40, num_labels=1)
    kinds = {
        "roberta": (tf.RobertaConfig, tf.RobertaModel, tf.RobertaForSequenceClassification,
                    tf.RobertaForMaskedLM, dict(pad_token_id=1, type_vocab_size=1)),
        "xlm-roberta": (tf.XLMRobertaConfig, tf.XLMRobertaModel,
                        tf.XLMRobertaForSequenceClassification, tf.XLMRobertaForMaskedLM,
                        dict(pad_token_id=1, type_vocab_size=1)),
        "electra": (tf.ElectraConfig, tf.ElectraModel, tf.ElectraForSequenceClassification,
                    tf.ElectraForPreTraining, dict(embedding_size=8)),
        "distilbert": (tf.DistilBertConfig, tf.DistilBertModel,
                       tf.DistilBertForSequenceClassification, tf.DistilBertForMaskedLM,
                       dict(dim=16, hidden_dim=32, n_layers=2, n_heads=2)),
    }
    cfg_cls, base, cls_head, pre, fam = kinds[family]
    if family != "distilbert":
        fam = dict(fam, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=32)
    cfg = cfg_cls(**geo, **fam, **extra)
    model_cls = {False: base, True: cls_head, "pretraining": pre}[head]
    return perturbed(model_cls, cfg)


def port_module(config, head):
    from advanced_rag_tpu_torch.models.hf_cross_encoder import build_classifier
    from advanced_rag_tpu_torch.models.hf_embedder import build_trunk

    return build_classifier(config, torch.float32) if head else \
        build_trunk(config, torch.float32)


PREFIX = {"roberta": "roberta.", "xlm-roberta": "roberta.", "electra": "electra.",
          "distilbert": "distilbert."}
CASES = [(f, h) for f in ("roberta", "xlm-roberta", "electra", "distilbert")
         for h in (False, True, "pretraining") if not (f == "distilbert" and h is True)]


@pytest.mark.parametrize("family,head", CASES, ids=[f"{f}-{h}" for f, h in CASES])
def test_family_renamer(tmp_path, family, head):
    """Each family's checkpoint read under the port's names: the trunk of
    a base, classifier or pretraining model without its prefix, the pooler
    and the MLM / discriminator heads left out; a classifier whole, with
    its dense / out_proj head.  The port's module takes the state exactly
    (load_state_dict is strict)."""
    model = family_model(family, head)
    model.save_pretrained(tmp_path)
    want = model.state_dict()
    if head is not True:
        pre = PREFIX[family]
        want = {k.removeprefix(pre): v for k, v in want.items()}
        want = {k: v for k, v in want.items()
                if k.startswith(("embeddings.", "embeddings_project.", "encoder.",
                                 "transformer."))
                and not k.endswith("position_ids")}
    else:
        want = {k: v for k, v in want.items() if not k.endswith("position_ids")}
    config, got = load_checkpoint(tmp_path, head=head is True, pooler=False)
    assert config.model_type == family
    assert_states_equal(got, want)
    port_module(config, head is True).load_state_dict(got)


@pytest.mark.parametrize("family", ["roberta", "xlm-roberta", "electra", "distilbert"])
def test_family_forward_matches_transformers(tmp_path, family):
    """The port's trunk against transformers' PyTorch model, f32, within
    1e-5, with padding (RoBERTa's pad positions) and token types."""
    model = family_model(family, False)
    model.save_pretrained(tmp_path)
    config, state = load_checkpoint(tmp_path, head=False, pooler=False)
    port = port_module(config, False)
    port.load_state_dict(state)
    ids = torch.randint(5, 64, (3, 12))
    mask = torch.ones(3, 12, dtype=torch.long)
    mask[1, 7:] = 0
    pad = 1 if "roberta" in family else 0
    ids[1, 7:] = pad
    types = torch.zeros_like(ids)
    if family == "electra":
        types[:, 6:] = 1
    kw = {} if family == "distilbert" else {"token_type_ids": types}
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask, **kw).last_hidden_state
        got, _ = port(ids, mask, types)
    keep = mask.bool()
    torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=1e-5)


def test_family_configs_read_as_transformers_reads_them(tmp_path):
    """DistilBERT's own names, ELECTRA's embedding_size, RoBERTa's pad id
    and position offset, and a family's class defaults where the file
    leaves a key out."""
    import transformers as tf

    tf.DistilBertConfig(dim=24, hidden_dim=40, n_layers=3, n_heads=4,
                        activation="relu", sinusoidal_pos_embds=True).save_pretrained(tmp_path)
    c = read_config(tmp_path)
    assert (c.hidden_size, c.intermediate_size, c.num_hidden_layers,
            c.num_attention_heads, c.hidden_act, c.sinusoidal_pos_embds,
            c.layer_norm_eps, c.position_offset) == (24, 40, 3, 4, "relu", True, 1e-12, 0)
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "electra"}))
    c = read_config(tmp_path)
    d = tf.ElectraConfig()
    assert (c.embedding_size, c.hidden_size, c.num_attention_heads, c.intermediate_size) \
        == (d.embedding_size, d.hidden_size, d.num_attention_heads, d.intermediate_size)
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "xlm-roberta", "layer_norm_eps": 1e-5}))
    c = read_config(tmp_path)
    assert (c.pad_token_id, c.position_offset, c.layer_norm_eps) == (1, 2, 1e-5)


@pytest.mark.parametrize("model_type", ["t5", "opt", "gpt2", "bloom", None])
def test_other_families_raise_naming_them(tmp_path, model_type):
    tiny_config().save_pretrained(tmp_path)
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg["model_type"] = model_type
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=f"model_type {model_type!r} is not supported"):
        read_config(tmp_path)


def test_distilbert_reranker_and_spm_model_refused(tmp_path):
    """A DistilBERT classifier as HFCrossEncoder (the JAX reference raises
    TypeError at its first score) and an XLM-R directory with only
    sentencepiece.bpe.model each raise ValueError naming what is missing."""
    from transformers import DistilBertTokenizerFast

    from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    # a DistilBERT classifier serves as an embedder: its trunk, without
    # pre_classifier and classifier (load_state_dict is strict)
    family_model("distilbert", True).save_pretrained(tmp_path / "d")
    (tmp_path / "d" / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(59)]))
    DistilBertTokenizerFast(vocab_file=str(tmp_path / "d" / "vocab.txt")).save_pretrained(
        tmp_path / "d")
    HFEmbedder(tmp_path / "d", max_len=16, device="cpu")
    with pytest.raises(ValueError, match="DistilBERT checkpoint does not serve as a "
                                         "cross-encoder"):
        HFCrossEncoder(tmp_path / "d", max_len=16, device="cpu")
    family_model("xlm-roberta", True).save_pretrained(tmp_path / "x")
    (tmp_path / "x" / "sentencepiece.bpe.model").write_bytes(b"\x00" * 16)
    for cls in (HFEmbedder, HFCrossEncoder):
        with pytest.raises(ValueError, match="no tokenizer.json"):
            cls(tmp_path / "x", max_len=16, device="cpu")
