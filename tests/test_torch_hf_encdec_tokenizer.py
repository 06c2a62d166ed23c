"""The port's tokenizers of the encoder-decoder families against the
classes JAX's ``AutoTokenizer`` loads for them, on the same directories:
``input_ids`` and ``attention_mask`` must match exactly (tolerance 0).

- BART: ``BartTokenizerFast``, RoBERTa's byte-level BPE (``hf_bpe.py``),
  as ``tokenizer.json`` and as ``vocab.json`` + ``merges.txt``;
- Blenderbot: ``BlenderbotTokenizerFast``, the same BPE with the
  converter's ``A </s>`` template; a ``tokenizer.json`` whose
  post-processor is a ``RobertaProcessing`` keeps ``<s> A </s>``;
- mBART: ``MBartTokenizerFast`` (``hf_unigram.py``), whose class replaces
  the file's template with ``A </s> <src_lang>`` and adds the 25
  language codes as special tokens; ``src_lang`` en_XX and de_DE;
- Pegasus: ``PegasusTokenizerFast`` on a ``tokenizer.json`` laid out as
  its converter writes one (``<pad>``, ``</s>``, ``<mask_1>``,
  ``<mask_2>``, ``<unk_2>`` ... ``<unk_102>`` in front, ``WhitespaceSplit``
  then ``Metaspace``, ``A </s>``);
- BlenderbotSmall: transformers' pure-Python ``BlenderbotSmallTokenizer``
  (``hf_blenderbot_small.py``) on a vocabulary and ``@@`` merges learned
  here, with an added token that strips on both sides;
- Marian: ``MarianTokenizer`` needs ``sentencepiece``: JAX's
  ``AutoTokenizer`` fails and the port raises ``ValueError`` naming it.

The Unigram models are trained by the ``tokenizers`` crate on the
pipeline tests' words, as ``tests/test_torch_hf_unigram.py`` does."""

from __future__ import annotations

import collections
import json
import shutil

import numpy as np
import pytest
from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors
from tokenizers import trainers
from transformers import (AddedToken, AutoTokenizer, BartTokenizerFast,
                          BlenderbotSmallTokenizer, BlenderbotTokenizerFast,
                          MBartTokenizerFast, PegasusTokenizerFast)

from advanced_rag_tpu_torch.models import hf_blenderbot_small, hf_bpe, hf_unigram
from advanced_rag_tpu_torch.models.hf_tokenizer import MBART_LANGUAGE_CODES, load_tokenizer
from test_torch_hf_bpe import CORPUS, TEXTS, train_bpe
from test_torch_hf_unigram import charsmap
from test_torch_pipeline import WORDS

MORE = ["dense sparse. Fusion, rank! (hybrid) it's? we're", "a.b..c ,x ( y )",
        "Hello\nWorld\n\nagain", "UPPER lower MiXeD", "''quoted'' `tick`",
        "a  b\t\tc   d", "  lead and trail  ", "ｄｅｎｓｅ ① ﬁne", "x" * 40]
BPE_SPECIALS = ["<s> x </s>", "a <mask> b", "<mask><mask>", "<pad><unk>", " <mask> "]


def assert_same(ref, port, texts, max_length=32):
    want = ref(list(texts), padding="max_length", truncation=True, max_length=max_length,
               return_tensors="np")
    got = port(list(texts), max_length=max_length)
    assert sorted(got) == sorted(want) == ["attention_mask", "input_ids"]
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def reference(path):
    return AutoTokenizer.from_pretrained(str(path), local_files_only=True)


# ---------------------------------------------------------------- BPE


@pytest.fixture(scope="module", params=["bart-json", "bart-files", "blenderbot-json",
                                        "blenderbot-files", "blenderbot-roberta"])
def bpe_pair(request, tmp_path_factory):
    family, form = request.param.split("-")
    root = tmp_path_factory.mktemp(request.param)
    raw, path = root / "raw", root / "tok"
    train_bpe(raw)
    path.mkdir()
    cls = BartTokenizerFast if family == "bart" else BlenderbotTokenizerFast
    if form == "files":
        for name in ("vocab.json", "merges.txt"):
            shutil.copy(raw / name, path / name)
        (path / "config.json").write_text(json.dumps({"model_type": family}))
    else:
        cls(vocab_file=str(raw / "vocab.json"),
            merges_file=str(raw / "merges.txt")).save_pretrained(path)
    if form == "roberta":
        # a Blenderbot tokenizer.json with RoBERTa's post-processor
        tj = json.loads((path / "tokenizer.json").read_text())
        vocab = tj["model"]["vocab"]
        tj["post_processor"] = {"type": "RobertaProcessing", "sep": ["</s>", vocab["</s>"]],
                                "cls": ["<s>", vocab["<s>"]], "trim_offsets": True,
                                "add_prefix_space": False}
        (path / "tokenizer.json").write_text(json.dumps(tj))
    return request.param, reference(path), load_tokenizer(path)


def test_bpe_classes(bpe_pair):
    case, ref, port = bpe_pair
    assert type(ref).__name__ == ("BartTokenizerFast" if case.startswith("bart")
                                  else "BlenderbotTokenizerFast")
    assert isinstance(port, hf_bpe.ByteLevelBPETokenizer)
    # Blenderbot's converter writes A </s>; RoBERTa's post-processor <s> A </s>
    eos = ref.convert_tokens_to_ids("</s>")
    want = ([ref.convert_tokens_to_ids("<s>"), eos] if case.split("-")[0] == "bart"
            or case == "blenderbot-roberta" else [eos])
    assert list(ref("")["input_ids"]) == want


@pytest.mark.parametrize("max_length", [8, 48])
def test_bpe_single_texts_match(bpe_pair, max_length):
    _, ref, port = bpe_pair
    assert_same(ref, port, TEXTS + MORE + BPE_SPECIALS, max_length=max_length)


# ---------------------------------------------------------------- Unigram


def train_unigram(normalizer, pre_tokenizer, specials, vocab_size=400):
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre_tokenizer
    tok.train_from_iterator(CORPUS + [" ".join(WORDS[i:] + WORDS[:i]) for i in range(20)],
                            trainers.UnigramTrainer(vocab_size=vocab_size,
                                                    special_tokens=specials,
                                                    unk_token="<unk>"))
    return json.loads(tok.to_str())


def write_mbart_dir(path, **init):
    """mBART's layout: XLM-R's normalizer and pieces, the language codes
    and ``<mask>`` appended to the vocabulary as ``MBartConverter`` does."""
    tj = train_unigram(normalizers.Sequence([normalizers.Precompiled(charsmap()),
                                             normalizers.Replace(Regex(" {2,}"), " ")]),
                       pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always"),
                       ["<s>", "<pad>", "</s>", "<unk>"])
    tj["model"]["vocab"] += [[code, 0.0] for code in MBART_LANGUAGE_CODES] + [["<mask>", 0.0]]
    tok = Tokenizer.from_str(json.dumps(tj))
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s> en_XX", pair="$A $B </s> en_XX",
        special_tokens=[("</s>", 2), ("en_XX", tj["model"]["vocab"].index(["en_XX", 0.0]))])
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "raw.json"))
    MBartTokenizerFast(tokenizer_file=str(path / "raw.json"), **init).save_pretrained(path)
    (path / "raw.json").unlink()
    return len(tj["model"]["vocab"])


def write_pegasus_dir(path):
    """Pegasus's layout as ``PegasusConverter`` writes it: the pad, eos and
    mask pieces and ``<unk_2>`` ... ``<unk_102>`` before the trained
    pieces, a right ``Strip`` and ``" {2,}"`` to ``▁``, ``WhitespaceSplit``
    then ``Metaspace``, ``A </s>``."""
    trained = train_unigram(None, pre_tokenizers.Metaspace(), ["<unk>"])
    head = [["<pad>", 0.0], ["</s>", 0.0], ["<mask_1>", 0.0], ["<mask_2>", 0.0]] + [
        [f"<unk_{i}>", -100.0] for i in range(2, 103)]
    tok = Tokenizer(models.Unigram([tuple(p) for p in head + trained["model"]["vocab"]],
                                   unk_id=len(head)))
    tok.normalizer = normalizers.Sequence([normalizers.Precompiled(charsmap()),
                                           normalizers.Strip(left=False, right=True),
                                           normalizers.Replace(Regex(" {2,}"), "▁")])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.WhitespaceSplit(),
        pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")])
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "$B", "</s>"], special_tokens=[("</s>", 1)])
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "raw.json"))
    PegasusTokenizerFast(tokenizer_file=str(path / "raw.json")).save_pretrained(path)
    (path / "raw.json").unlink()
    return len(head) + len(trained["model"]["vocab"])


@pytest.fixture(scope="module", params=["mbart", "mbart-de_DE", "pegasus"])
def unigram_pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param) / "tok"
    if request.param == "pegasus":
        write_pegasus_dir(path)
    else:
        write_mbart_dir(path, **({"src_lang": "de_DE"} if "de_DE" in request.param else {}))
    return request.param, reference(path), load_tokenizer(path)


UNIGRAM_SPECIALS = ["x <mask> y", "a\t<mask>", "de_DE en_XX text", "en_XXy", "</s><pad>",
                    "<mask_1> <mask_2> <unk_2><unk_102>", "<unk_7>x", "a <s> b"]


def test_unigram_classes(unigram_pair):
    case, ref, port = unigram_pair
    assert type(ref).__name__ == ("PegasusTokenizerFast" if case == "pegasus"
                                  else "MBartTokenizerFast")
    assert isinstance(port, hf_unigram.UnigramTokenizer)
    want = [ref.convert_tokens_to_ids("</s>")]
    if case.startswith("mbart"):
        want.append(ref.convert_tokens_to_ids(case[6:] or "en_XX"))
    assert list(ref("")["input_ids"]) == port.suffix == want


@pytest.mark.parametrize("max_length", [8, 48])
def test_unigram_single_texts_match(unigram_pair, max_length):
    from test_torch_hf_unigram import MORE as UNIGRAM_MORE

    _, ref, port = unigram_pair
    assert_same(ref, port, TEXTS + MORE + UNIGRAM_MORE + UNIGRAM_SPECIALS,
                max_length=max_length)


def test_templates_refuse_pairs(unigram_pair):
    """None of the families reranks: a suffix-only template takes single
    texts alone."""
    _, _, port = unigram_pair
    with pytest.raises(ValueError, match="single texts only"):
        port(["a"], ["b"], max_length=16)


# ---------------------------------------------------------------- BlenderbotSmall


def learn_merges(words, n):
    """``n`` BPE merges over ``words`` (lowercased, ``</w>`` on the last
    symbol), most frequent pair first."""
    corpus = collections.Counter(tuple(w[:-1]) + (w[-1] + "</w>",) for w in words if w)
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for word, count in corpus.items():
            for pair in zip(word, word[1:]):
                pairs[pair] += count
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.get)
        merges.append(best)
        merged = collections.Counter()
        for word, count in corpus.items():
            out, i = [], 0
            while i < len(word):
                if word[i:i + 2] == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += count
        corpus = merged
    return merges


def write_small_dir(path):
    """A BlenderbotSmall directory as the class saves it, named by
    config.json's model_type (by tokenizer_class AutoTokenizer takes
    BlenderbotSmallTokenizerFast: test_blenderbot_small_class_name): merges
    learned on the corpus, the vocabulary of every subword the class gives
    the corpus (less a few, so unknowns occur), an added token with lstrip
    and rstrip; returns the vocabulary size with the added token."""
    path.mkdir(parents=True, exist_ok=True)
    words = " ".join(CORPUS).lower().replace("'", " ' ").split()
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in learn_merges(words, 300)),
        encoding="utf-8")
    specials = ["__null__", "__start__", "__end__", "__unk__", "__newln__"]
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(specials)}))
    probe = BlenderbotSmallTokenizer(str(path / "vocab.json"), str(path / "merges.txt"))
    pieces = sorted({p for text in CORPUS + MORE for p in probe.tokenize(text)})
    vocab = specials + [p for i, p in enumerate(pieces) if i % 7 and p not in specials]
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    ref = BlenderbotSmallTokenizer(str(path / "vocab.json"), str(path / "merges.txt"))
    ref.add_tokens([AddedToken("<sep>", lstrip=True, rstrip=True)])
    ref.save_pretrained(path)
    cfg = json.loads((path / "tokenizer_config.json").read_text())
    assert cfg.pop("tokenizer_class") == "BlenderbotSmallTokenizer"
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))
    (path / "config.json").write_text(json.dumps({"model_type": "blenderbot-small"}))
    return len(ref)


@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("blenderbot-small")
    write_small_dir(path)
    return reference(path), load_tokenizer(path)


def test_blenderbot_small_class(small_pair):
    ref, port = small_pair
    assert type(ref).__name__ == "BlenderbotSmallTokenizer"
    assert isinstance(port, hf_blenderbot_small.BlenderbotSmallTokenizer)
    assert port.pad_id == ref.pad_token_id and port.unk_id == ref.unk_token_id
    assert list(ref("")["input_ids"]) == []


@pytest.mark.parametrize("max_length", [8, 64])
def test_blenderbot_small_texts_match(small_pair, max_length):
    ref, port = small_pair
    specials = ["a <sep> b", "a\t\t<sep>\n\nb", "__start__ x __end__", "__null__y",
                "__newln__", "x<sep><sep>y", "__UNK__ __unk__", "İstanbul ß ﬁ"]
    assert_same(ref, port, TEXTS + MORE + specials, max_length=max_length)


def test_blenderbot_small_class_name_is_refused(small_pair, tmp_path):
    """With tokenizer_class BlenderbotSmallTokenizer AutoTokenizer takes
    the byte-level BlenderbotSmallTokenizerFast, which fails on the @@
    vocabulary; the port raises ValueError naming the class."""
    src = small_pair[0].name_or_path
    for name in ("vocab.json", "merges.txt"):
        shutil.copy(f"{src}/{name}", tmp_path / name)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BlenderbotSmallTokenizer"}))
    with pytest.raises(Exception, match="out of vocabulary"):
        reference(tmp_path)
    with pytest.raises(ValueError, match="BlenderbotSmallTokenizerFast"):
        load_tokenizer(tmp_path)


def test_marian_tokenizer_is_refused(tmp_path):
    """MarianTokenizer reads SentencePiece files with sentencepiece, which
    is not installed: JAX's AutoTokenizer fails, the port raises naming it;
    by tokenizer_class and by model_type."""
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "marian"}))
    with pytest.raises(ValueError, match="sentencepiece"):
        reference(tmp_path)
    with pytest.raises(ValueError, match="MarianTokenizer is not supported.*sentencepiece"):
        load_tokenizer(tmp_path)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "MarianTokenizer"}))
    with pytest.raises(ValueError, match="MarianTokenizer is not supported"):
        load_tokenizer(tmp_path)
