"""The port's SentencePiece-style BPE tokenizer (``models/hf_spbpe.py``)
against ``LlamaTokenizerFast`` and ``GemmaTokenizerFast``, which JAX's
``AutoTokenizer`` loads for a Llama, Mistral or Gemma checkpoint, on the
same ``tokenizer.json``.  ``input_ids`` and ``attention_mask`` must match
exactly (tolerance 0), called as JAX's ``HFEmbedder`` calls the tokenizer
(``padding="max_length"``, ``truncation=True``).

Each ``tokenizer.json`` is a BPE model trained by the ``tokenizers`` crate
with ``byte_fallback`` and ``fuse_unk``, ``<unk> <s> </s>`` (Gemma: ``<pad>
<eos> <bos> <unk>``) and the 256 ``<0xXX>`` byte pieces in the vocabulary
(added tokens only for the specials, as Llama's file has them), in one of
three layouts:

- ``legacy``: Llama-2's and Mistral's, normalizer ``Prepend("▁")`` +
  ``Replace(" ", "▁")``, no pre-tokenizer;
- ``metaspace``: the newer Llama layout, no normalizer, ``Metaspace``
  (prepend_scheme "first", split false);
- ``gemma``: Gemma's, normalizer ``Replace(" ", "▁")`` alone."""

from __future__ import annotations

import json

import numpy as np
import pytest
from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers
from transformers import AutoTokenizer, GemmaTokenizerFast, LlamaTokenizerFast

from advanced_rag_tpu_torch.models.hf_spbpe import SentencePieceBPETokenizer
from advanced_rag_tpu_torch.models.hf_tokenizer import load_tokenizer
from test_torch_hf_bpe import CORPUS
from test_torch_pipeline import WORDS

LAYOUTS = ["legacy", "metaspace", "gemma"]
BYTES = [f"<0x{b:02X}>" for b in range(256)]
SPECIALS = {"llama": ["<unk>", "<s>", "</s>"], "gemma": ["<pad>", "<eos>", "<bos>", "<unk>"]}
TEXTS = ["dense sparse fusion rank", "How does the KERNEL scan the cache?", "",
         "café naïve résumé", "东京 tokens 猫", "a" * 41, "  two  spaces  ",
         "emoji \U0001F600 and K", "Hello <s>. x </s>", "tab\tnew\nline",
         "rerank bucket hash table slot weight drift metric " * 4, "<unk><pad>"]


def write_spbpe_dir(path, layout="legacy", *, config=None, model=None, drop=(),
                    added=(), vocab_size=420, by_word=False):
    """A tokenizer directory of ``layout``: tokenizer.json built by the
    crate and tokenizer_config.json (``config`` merged into the class's
    own); ``model`` overrides keys of the BPE model, ``drop`` removes pieces
    from its vocabulary, ``added`` appends added-token dicts.  ``by_word``:
    trained on words split at each "▁" (as SentencePiece splits by
    whitespace), so no merge crosses into a following "▁"; otherwise the
    crate merges across words ("▁hello▁wor")."""
    family = "gemma" if layout == "gemma" else "llama"
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    if by_word:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always",
                                                     split=True)
        tok.train_from_iterator(
            CORPUS + [" ".join(WORDS[i:] + WORDS[:i]) for i in range(20)],
            trainers.BpeTrainer(vocab_size=vocab_size, show_progress=False,
                                special_tokens=SPECIALS[family] + BYTES))
        tok.pre_tokenizer = None
    if layout == "legacy":
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
    elif layout == "metaspace":
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first",
                                                     split=False)
    else:
        tok.normalizer = normalizers.Replace(" ", "▁")
    if not by_word:
        tok.train_from_iterator(
            CORPUS + [" ".join(WORDS[i:] + WORDS[:i]) for i in range(20)],
            trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=SPECIALS[family] + BYTES,
                                show_progress=False))
    tj = json.loads(tok.to_str())
    tj["added_tokens"] = [t for t in tj["added_tokens"] if t["content"] not in BYTES]
    tj["added_tokens"] += list(added)
    tj["model"].update(model or {})
    for piece in drop:
        del tj["model"]["vocab"][piece]
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False), encoding="utf-8")
    cfg = ({"tokenizer_class": "LlamaTokenizer", "pad_token": "</s>"} if family == "llama"
           else {"tokenizer_class": "GemmaTokenizer"})
    cfg.update(config or {})
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))
    return len(tj["model"]["vocab"]) + sum(t["id"] >= len(tj["model"]["vocab"])
                                           for t in tj["added_tokens"])


def assert_same(path, texts, max_length=24):
    ref = AutoTokenizer.from_pretrained(str(path))
    ours = load_tokenizer(path)
    assert isinstance(ours, SentencePieceBPETokenizer)
    want = ref(list(texts), padding="max_length", truncation=True, max_length=max_length,
               return_tensors="np")
    got = ours(list(texts), max_length=max_length)
    assert set(got) == {"input_ids", "attention_mask"}
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    return ref, got


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("padding_side", [None, "right"])
@pytest.mark.parametrize("truncation_side", [None, "left"])
def test_ids_and_masks_match_the_fast_tokenizer(tmp_path, layout, padding_side,
                                                truncation_side):
    config = {k: v for k, v in (("padding_side", padding_side),
                                ("truncation_side", truncation_side)) if v}
    write_spbpe_dir(tmp_path, layout, config=config)
    ref, got = assert_same(tmp_path, TEXTS, max_length=16)
    assert isinstance(ref, GemmaTokenizerFast if layout == "gemma" else LlamaTokenizerFast)
    assert ref.padding_side == (padding_side or "left")
    # rows were padded and truncated both
    assert got["attention_mask"].sum(1).min() < 16 == got["attention_mask"].sum(1).max()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bos,eos", [(True, True), (False, False), (False, True),
                                     (None, True)])
def test_add_bos_and_eos_token_overrides(tmp_path, layout, bos, eos):
    """The template comes from tokenizer_config.json's add_bos_token /
    add_eos_token (update_post_processor), whatever tokenizer.json says."""
    config = {"add_eos_token": eos}
    if bos is not None:
        config["add_bos_token"] = bos
    write_spbpe_dir(tmp_path, layout, config=config)
    assert_same(tmp_path, TEXTS, max_length=12)
    assert_same(tmp_path, ["x"], max_length=2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_byte_fallback_and_unknowns(tmp_path, layout):
    """Characters outside the vocabulary take their UTF-8 bytes' pieces;
    where a byte piece is missing too, <unk>, runs of it fused."""
    write_spbpe_dir(tmp_path / "bytes", layout)
    ref, got = assert_same(tmp_path / "bytes", ["猫 \U0001F600 é", "☃☃"])
    toks = ref.convert_ids_to_tokens(ref("猫")["input_ids"])
    assert "<0xE7>" in toks and "<0x8C>" in toks and "<0xAB>" in toks
    unk = ref.convert_tokens_to_ids("<unk>")
    for fuse in (True, False):
        path = tmp_path / f"unk-{fuse}"
        write_spbpe_dir(path, layout, model={"fuse_unk": fuse}, drop=["<0xE2>", "<0xE7>"])
        _, got = assert_same(path, ["☃☃ x ☃", "猫☃a\U0001F600☃"])
        assert (got["input_ids"] == unk).sum() >= 2
        path = tmp_path / f"nofallback-{fuse}"
        write_spbpe_dir(path, layout, model={"fuse_unk": fuse, "byte_fallback": False})
        _, got = assert_same(path, ["☃☃ x 猫猫猫", "é\U0001F600"])
        assert (got["input_ids"] == unk).any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_added_tokens(tmp_path, layout):
    """A special added token is found in the raw text, with its lstrip /
    rstrip; a normalized one in the normalized text, as its content
    normalizes (with the legacy Prepend, "▁<tool>")."""
    n = write_spbpe_dir(tmp_path / "probe", layout)
    added = [{"id": n, "content": "<tool>", "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": True, "special": False},
             {"id": n + 1, "content": "[SEP]", "single_word": False, "lstrip": True,
              "rstrip": True, "normalized": False, "special": True},
             {"id": n + 2, "content": "tool call", "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": True, "special": False}]
    write_spbpe_dir(tmp_path / "added", layout, added=added)
    assert_same(tmp_path / "added",
                ["<tool> run", "a<tool>b", "x  [SEP]  y", "[SEP]", "the tool call here",
                 "tool call", "<s><tool></s>", "x<tool>"], max_length=20)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_legacy_false_and_extra_config_keys_change_nothing(tmp_path, layout):
    """tokenizer_config.json's legacy flag only matters when transformers
    converts from the .model file, which a tokenizer.json directory never
    does."""
    write_spbpe_dir(tmp_path, layout, config={"legacy": False, "model_max_length": 64,
                                              "clean_up_tokenization_spaces": False})
    assert_same(tmp_path, TEXTS)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_random_unicode_sweep(tmp_path, layout):
    """A seeded sweep of random strings over ASCII, Latin, CJK, emoji,
    whitespace and the specials' text."""
    write_spbpe_dir(tmp_path, layout)
    rng = np.random.default_rng(7)
    pools = [list("abcdefgh ijk  lmnop"), [chr(c) for c in range(0x20, 0x7F)],
             [chr(c) for c in range(0xC0, 0x180)], [chr(c) for c in range(0x4E00, 0x4E40)],
             [chr(c) for c in range(0x1F600, 0x1F610)], [" ", "\t", "\n", "　", "▁"],
             ["<s>", "</s>", "<unk>", "<bos>", "<pad>"] + WORDS[:20]]
    texts = []
    for _ in range(120):
        parts = rng.integers(0, len(pools), rng.integers(1, 12))
        texts.append("".join(pools[p][rng.integers(0, len(pools[p]))] for p in parts))
    assert_same(tmp_path, texts, max_length=32)


def test_a_tokenizer_without_pad_token(tmp_path):
    """Llama's and Mistral's tokenizers ship no pad token: padding to
    max_length raises in both."""
    write_spbpe_dir(tmp_path, "legacy", config={"pad_token": None})
    ref, ours = AutoTokenizer.from_pretrained(str(tmp_path)), load_tokenizer(tmp_path)
    assert ref.pad_token is None and ours.pad_id is None
    with pytest.raises(ValueError, match="padding token"):
        ref(["a", "bb"], padding="max_length", truncation=True, max_length=8)
    with pytest.raises(ValueError, match="pad_token"):
        ours(["a", "bb"], max_length=8)


@pytest.mark.parametrize("what,kwargs,match", [
    ("dropout", dict(model={"dropout": 0.1}), "dropout"),
    ("ignore_merges", dict(model={"ignore_merges": True}), "ignore_merges"),
    ("prefix", dict(model={"continuing_subword_prefix": "##"}), "continuing_subword_prefix"),
    ("add_prefix_space", dict(config={"add_prefix_space": True}), "add_prefix_space"),
])
def test_refusals(tmp_path, what, kwargs, match):
    write_spbpe_dir(tmp_path, "legacy", **kwargs)
    with pytest.raises(ValueError, match=match):
        load_tokenizer(tmp_path)


@pytest.mark.parametrize("pre", [{"type": "ByteLevel", "add_prefix_space": False,
                                  "trim_offsets": True, "use_regex": True},
                                 {"type": "Split", "pattern": {"String": " "},
                                  "behavior": "Isolated", "invert": False}])
def test_llama3_pre_tokenizers_are_refused(tmp_path, pre):
    write_spbpe_dir(tmp_path, "metaspace")
    tj = json.loads((tmp_path / "tokenizer.json").read_text(encoding="utf-8"))
    tj["pre_tokenizer"] = pre
    (tmp_path / "tokenizer.json").write_text(json.dumps(tj), encoding="utf-8")
    with pytest.raises(ValueError, match=pre["type"]):
        load_tokenizer(tmp_path)


def test_model_file_without_tokenizer_json_is_refused(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "LlamaTokenizer"}))
    with pytest.raises(ValueError, match="tokenizer.model"):
        load_tokenizer(tmp_path)


@pytest.mark.parametrize("model_type,cls", [("llama", LlamaTokenizerFast),
                                            ("mistral", LlamaTokenizerFast),
                                            ("gemma", GemmaTokenizerFast)])
def test_chosen_by_model_type(tmp_path, model_type, cls):
    """Without tokenizer_class, config.json's model_type chooses, as
    AutoTokenizer does (Mistral's checkpoints take LlamaTokenizerFast)."""
    write_spbpe_dir(tmp_path, "gemma" if model_type == "gemma" else "legacy")
    cfg = json.loads((tmp_path / "tokenizer_config.json").read_text())
    del cfg["tokenizer_class"]
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    (tmp_path / "config.json").write_text(json.dumps({"model_type": model_type}))
    ref, _ = assert_same(tmp_path, TEXTS)
    assert type(ref) is cls


@pytest.mark.parametrize("layout", LAYOUTS)
def test_words_merge_apart_where_no_merge_crosses_into_a_boundary(tmp_path, layout):
    """A vocabulary whose merges never join a character to a following
    "▁" (SentencePiece's, trained by word) takes the split-word path; the
    crate's, which merges whole pieces, gives the same ids.  A vocabulary
    with pieces like "▁hello▁wor" keeps the whole-piece path."""
    write_spbpe_dir(tmp_path / "word", layout, by_word=True, vocab_size=600)
    assert load_tokenizer(tmp_path / "word").split_words
    write_spbpe_dir(tmp_path / "whole", layout)
    assert not load_tokenizer(tmp_path / "whole").split_words
    rng = np.random.default_rng(11)
    words = WORDS + ["猫", "\U0001F600", "é", "  ", "<s>", "x"]
    texts = TEXTS + [" ".join(words[i] for i in rng.integers(0, len(words), 12))
                     for _ in range(40)]
    for fuse in (True, False):
        path = tmp_path / f"unk-{fuse}"
        write_spbpe_dir(path, layout, by_word=True, model={"fuse_unk": fuse},
                        drop=["<0xE7>", "<0xF0>"])
        assert load_tokenizer(path).split_words
        assert_same(path, texts, max_length=40)
    assert_same(tmp_path / "word", texts, max_length=40)
