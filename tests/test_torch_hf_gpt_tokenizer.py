"""The port's tokenizers of the GPT families against the classes JAX's
``AutoTokenizer`` loads for them, on the same directories: ``input_ids``
and ``attention_mask`` must match exactly (tolerance 0).

- GPT-2 (GPT-Neo's and GPT-J's checkpoints take the same class):
  ``GPT2TokenizerFast``, the byte-level BPE of ``hf_bpe.py`` with the
  ``ByteLevel`` post-processor (no special tokens around the text), as
  ``tokenizer.json`` and as ``vocab.json`` + ``merges.txt``, with and
  without ``add_bos_token``, padded right and left; without a pad token
  the embedder refuses the checkpoint;
- BLOOM: ``BloomTokenizerFast`` on a ``tokenizer.json`` laid out as the
  published one (``Split`` on BLOOM's pattern, Isolated, then
  ``ByteLevel`` without its regex; padded left); the split held against
  the crate's over every code point;
- XGLM: ``XGLMTokenizerFast`` on a ``tokenizer.json`` laid out as
  ``XGLMConverter`` writes it (fairseq's ids ``<s> <pad> </s> <unk>`` at
  0-3, seven ``<madeupword>``s last, ``</s> A``);
- GPT-SW3: ``GPTSw3Tokenizer`` needs ``sentencepiece``: JAX's
  ``AutoTokenizer`` fails, the port raises ``ValueError`` naming it.

The BPE and Unigram models are trained by the ``tokenizers`` crate on the
pipeline tests' words and a few scripts."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers
from tokenizers import processors, trainers
from tokenizers import ByteLevelBPETokenizer as BPETrainer
from transformers import AutoTokenizer, BloomTokenizerFast, GPT2TokenizerFast
from transformers import XGLMTokenizerFast

from advanced_rag_tpu_torch.models import hf_bpe, hf_unigram
from advanced_rag_tpu_torch.models.hf_tokenizer import load_tokenizer
from test_torch_hf_bpe import CODE_POINTS, CORPUS, TEXTS
from test_torch_hf_encdec_tokenizer import MORE
from test_torch_hf_unigram import charsmap
from test_torch_pipeline import WORDS

EOT = "<|endoftext|>"
GPT_SPECIALS = [f"a {EOT} b", f"{EOT}{EOT}", f" {EOT} ", "<s> x </s><pad><unk>",
                "<madeupword0> y", "x<madeupword6>", "( a|b ) 。，、 ! ? …",
                "one. two, three! four? five… six। seven۔ eight، nine"]
ALL_TEXTS = TEXTS + MORE + GPT_SPECIALS


def assert_same(ref, port, texts, max_length):
    want = ref(list(texts), padding="max_length", truncation=True, max_length=max_length,
               return_tensors="np")
    got = port(list(texts), max_length=max_length)
    assert sorted(got) == sorted(want) == ["attention_mask", "input_ids"]
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def reference(path):
    return AutoTokenizer.from_pretrained(str(path), local_files_only=True)


# ---------------------------------------------------------------- GPT-2


def write_gpt2_dir(path, form="json", pad=True, vocab_size=420, **init):
    """A GPT-2 tokenizer directory trained here (``<|endoftext|>`` the one
    special token), as ``save_pretrained`` writes it ("json") or as
    vocab.json + merges.txt with a tokenizer_config.json ("files"); with
    ``pad`` the config names ``<|endoftext|>`` the pad token, as
    deployments of GPT-2 embedders do; returns the vocab size."""
    raw = path.parent / f"{path.name}-raw"
    raw.mkdir(parents=True, exist_ok=True)
    trainer = BPETrainer()
    trainer.train_from_iterator(CORPUS, vocab_size=vocab_size, min_frequency=1,
                                special_tokens=[EOT])
    trainer.save_model(str(raw))
    path.mkdir(parents=True, exist_ok=True)
    kwargs = dict(init, **({"pad_token": EOT} if pad else {}))
    if form == "json":
        GPT2TokenizerFast(vocab_file=str(raw / "vocab.json"),
                          merges_file=str(raw / "merges.txt"), **kwargs).save_pretrained(path)
    else:
        for name in ("vocab.json", "merges.txt"):
            shutil.copy(raw / name, path / name)
        (path / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "GPT2Tokenizer", **kwargs}))
    return len(json.loads((raw / "vocab.json").read_text()))


GPT2_CASES = {"json": {}, "files": {}, "json-left": {"padding_side": "left"},
              "files-bos": {"add_bos_token": True},
              "json-prefix-space": {"add_prefix_space": True}}


@pytest.fixture(scope="module", params=list(GPT2_CASES))
def gpt2_pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(f"gpt2-{request.param}") / "tok"
    write_gpt2_dir(path, request.param.split("-")[0], **GPT2_CASES[request.param])
    return request.param, reference(path), load_tokenizer(path)


def test_gpt2_class_and_template(gpt2_pair):
    case, ref, port = gpt2_pair
    assert type(ref).__name__ == "GPT2TokenizerFast"
    assert isinstance(port, hf_bpe.ByteLevelBPETokenizer)
    eot = ref.convert_tokens_to_ids(EOT)
    want = [eot] if case == "files-bos" else []
    assert list(ref("")["input_ids"]) == port.prefix == want
    assert port.suffix == [] and port.pad_id == ref.pad_token_id == eot
    assert port.padding_side == ref.padding_side


@pytest.mark.parametrize("max_length", [8, 48])
def test_gpt2_texts_match(gpt2_pair, max_length):
    _, ref, port = gpt2_pair
    assert_same(ref, port, ALL_TEXTS, max_length)


def test_gpt2_without_pad_token(tmp_path):
    """GPT-2 ships no pad token: both tokenizers have none, and padding
    raises in each (the embedders refuse such a checkpoint)."""
    write_gpt2_dir(tmp_path / "tok", pad=False)
    ref, port = reference(tmp_path / "tok"), load_tokenizer(tmp_path / "tok")
    assert ref.pad_token_id is None and port.pad_id is None
    with pytest.raises(ValueError, match="padding token"):
        ref(["a"], padding="max_length", max_length=8)
    with pytest.raises(ValueError, match="no pad_token"):
        port(["a"], max_length=8)
    # a text that fills the row needs no padding
    assert port(["dense sparse fusion rank " * 8], max_length=8)["input_ids"].shape == (1, 8)


@pytest.mark.parametrize("model_type", ["gpt_neo", "gptj"])
def test_neo_and_j_take_gpt2s_class(tmp_path, model_type):
    """By config.json's model_type (no tokenizer_class), GPT-Neo's and
    GPT-J's checkpoints take GPT2TokenizerFast."""
    write_gpt2_dir(tmp_path / "tok")
    cfg = json.loads((tmp_path / "tok" / "tokenizer_config.json").read_text())
    cfg.pop("tokenizer_class")
    (tmp_path / "tok" / "tokenizer_config.json").write_text(json.dumps(cfg))
    (tmp_path / "tok" / "config.json").write_text(json.dumps({"model_type": model_type}))
    ref, port = reference(tmp_path / "tok"), load_tokenizer(tmp_path / "tok")
    assert type(ref).__name__ == "GPT2TokenizerFast"
    assert_same(ref, port, ALL_TEXTS, 32)


# ---------------------------------------------------------------- BLOOM


def bloom_pre_tokenizer():
    return pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(hf_bpe.BLOOM_SPLIT), "isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])


def write_bloom_dir(path, vocab_size=420, **init):
    """BLOOM's layout: a byte-level BPE trained here behind the published
    pre-tokenizer, ``<unk> <s> </s> <pad>`` at 0-3, the ByteLevel
    post-processor; BloomTokenizerFast saves it (padding_side left, as
    bigscience/bloom-560m's tokenizer_config.json); returns the vocab
    size."""
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = bloom_pre_tokenizer()
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(CORPUS + [" ".join(WORDS)] * 4, trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<unk>", "<s>", "</s>", "<pad>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), min_frequency=1))
    path.mkdir(parents=True, exist_ok=True)
    BloomTokenizerFast(tokenizer_object=tok, **{"padding_side": "left", **init}
                       ).save_pretrained(path)
    return tok.get_vocab_size()


@pytest.fixture(scope="module")
def bloom_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("bloom") / "tok"
    write_bloom_dir(path)
    return reference(path), load_tokenizer(path)


def test_bloom_class(bloom_pair):
    ref, port = bloom_pair
    assert type(ref).__name__ == "BloomTokenizerFast"
    assert isinstance(port, hf_bpe.ByteLevelBPETokenizer) and port.split is hf_bpe.bloom_split
    assert list(ref("")["input_ids"]) == port.prefix + port.suffix == []
    assert port.pad_id == ref.pad_token_id == 3
    assert port.padding_side == ref.padding_side == "left"


@pytest.mark.parametrize("max_length", [8, 48])
def test_bloom_texts_match(bloom_pair, max_length):
    ref, port = bloom_pair
    assert_same(ref, port, ALL_TEXTS, max_length)


def test_bloom_split_over_every_code_point():
    """BLOOM's Split against the crate's over all of Unicode: each code
    point behind a letter, then a space and a letter after it, so the
    pieces show whether the pattern's class holds it, and whether it is
    whitespace to the `` ?`` in front."""
    split = pre_tokenizers.Split(Regex(hf_bpe.BLOOM_SPLIT), "isolated", invert=False)
    for lo in range(0, len(CODE_POINTS), 8192):
        text = "".join(f"a{chr(c)} b" for c in CODE_POINTS[lo:lo + 8192])
        want = [w for w, _ in split.pre_tokenize_str(text)]
        got = hf_bpe.bloom_split(text)
        if got != want:
            at = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"piece {at}: port {got[at]!r}, crate {want[at]!r}")


def test_bloom_refusals(tmp_path):
    """add_prefix_space (the class rewrites its pickled pre-tokenizer) and
    a pre-tokenizer other than BLOOM's raise, naming what."""
    write_bloom_dir(tmp_path / "a", add_prefix_space=True)
    with pytest.raises(ValueError, match="add_prefix_space true"):
        load_tokenizer(tmp_path / "a")
    write_bloom_dir(tmp_path / "b")
    tj = json.loads((tmp_path / "b" / "tokenizer.json").read_text())
    tj["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {"Regex": " ?\\w+"}
    (tmp_path / "b" / "tokenizer.json").write_text(json.dumps(tj))
    with pytest.raises(ValueError, match="not BLOOM's Split"):
        load_tokenizer(tmp_path / "b")


# ---------------------------------------------------------------- XGLM


def write_xglm_dir(path, vocab_size=400, **init):
    """XGLM's layout as ``XGLMConverter`` writes it: fairseq's ``<s> <pad>
    </s> <unk>`` at 0-3, the trained pieces, seven ``<madeupword>``s;
    SpmConverter's normalizer (the charsmap, a right Strip, " {2,}" to
    "▁") and Metaspace; ``</s> A``; returns the vocab size."""
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([normalizers.Precompiled(charsmap()),
                                           normalizers.Strip(left=False, right=True),
                                           normalizers.Replace(Regex(" {2,}"), "▁")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.train_from_iterator(CORPUS + [" ".join(WORDS[i:] + WORDS[:i]) for i in range(20)],
                            trainers.UnigramTrainer(vocab_size=vocab_size, unk_token="<unk>",
                                                    special_tokens=["<s>", "<pad>", "</s>",
                                                                    "<unk>"]))
    tj = json.loads(tok.to_str())
    tj["model"]["vocab"] += [[f"<madeupword{i}>", 0.0] for i in range(7)]
    tok = Tokenizer.from_str(json.dumps(tj))
    tok.post_processor = processors.TemplateProcessing(
        single="</s> $A", pair="</s> $A </s> </s> $B",
        special_tokens=[("<s>", 0), ("</s>", 2)])
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "raw.json"))
    XGLMTokenizerFast(tokenizer_file=str(path / "raw.json"), **init).save_pretrained(path)
    (path / "raw.json").unlink()
    return len(tj["model"]["vocab"])


@pytest.fixture(scope="module", params=["right", "left"])
def xglm_pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(f"xglm-{request.param}") / "tok"
    write_xglm_dir(path, padding_side=request.param)
    return reference(path), load_tokenizer(path)


def test_xglm_class(xglm_pair):
    ref, port = xglm_pair
    assert type(ref).__name__ == "XGLMTokenizerFast"
    assert isinstance(port, hf_unigram.UnigramTokenizer)
    assert list(ref("")["input_ids"]) == port.prefix == [2]
    assert port.suffix == [] and port.pad_id == ref.pad_token_id == 1
    assert port.padding_side == ref.padding_side
    with pytest.raises(ValueError, match="single texts only"):
        port(["a"], ["b"], max_length=16)


@pytest.mark.parametrize("max_length", [8, 48])
def test_xglm_texts_match(xglm_pair, max_length):
    from test_torch_hf_unigram import MORE as UNIGRAM_MORE

    ref, port = xglm_pair
    assert_same(ref, port, ALL_TEXTS + UNIGRAM_MORE, max_length)


# ---------------------------------------------------------------- GPT-SW3


@pytest.mark.parametrize("how", ["tokenizer_class", "model_type"])
def test_gpt_sw3_tokenizer_is_refused(tmp_path, how):
    """GPTSw3Tokenizer reads a SentencePiece model with sentencepiece: JAX's
    AutoTokenizer fails without it (ImportError naming SentencePiece by
    tokenizer_class; by model_type it finds no class, TypeError), and the
    port raises ValueError naming it either way."""
    (tmp_path / "spiece.model").write_bytes(b"\x00")
    if how == "tokenizer_class":
        (tmp_path / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "GPTSw3Tokenizer"}))
    else:
        (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt-sw3"}))
    with pytest.raises(ImportError if how == "tokenizer_class" else TypeError,
                       match="SentencePiece" if how == "tokenizer_class" else "NoneType"):
        reference(tmp_path)
    with pytest.raises(ValueError, match="sentencepiece"):
        load_tokenizer(tmp_path)
