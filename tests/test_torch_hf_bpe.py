"""The port's byte-level BPE tokenizer (``models/hf_bpe.py``) against
``RobertaTokenizerFast``, which JAX's ``AutoTokenizer`` loads for a RoBERTa
checkpoint, on the same directory.  ``input_ids`` and ``attention_mask``
must match exactly (tolerance 0), and neither returns token types.

Both file forms: ``tokenizer.json`` (written by ``save_pretrained``) and
``vocab.json`` + ``merges.txt`` alone (which transformers converts through
the slow tokenizer).  The vocabulary is a byte-level BPE trained by the
``tokenizers`` crate on the pipeline tests' words and a few scripts."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import ByteLevelBPETokenizer as BPETrainer
from tokenizers import pre_tokenizers
from transformers import AutoTokenizer, RobertaTokenizerFast

from advanced_rag_tpu_torch.models import hf_bpe
from advanced_rag_tpu_torch.models.hf_tokenizer import load_tokenizer
from test_torch_pipeline import WORDS

SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
CORPUS = [" ".join(WORDS), "The TPU kernel's dense scan, it's we're they'll I'd",
          "héllo wörld café naïve 東京大学 123 4567 ①②", "emoji 😀 👍🏽 ∑∫√ «quotes»",
          "tabs\tand\nnewlines  double  spaces", "ΣΟΦΊΑ σοφίας İstanbul ß"] * 8


def train_bpe(path, vocab_size=420):
    path.mkdir(parents=True, exist_ok=True)
    trainer = BPETrainer()
    trainer.train_from_iterator(CORPUS, vocab_size=vocab_size, min_frequency=1,
                                special_tokens=SPECIALS)
    trainer.save_model(str(path))
    return len(json.loads((path / "vocab.json").read_text()))


def write_bpe_dir(path, form="json", vocab_size=420, **init):
    """A RoBERTa tokenizer directory; ``form`` "json" as ``save_pretrained``
    writes it (tokenizer.json beside vocab.json and merges.txt), "files" as
    vocab.json + merges.txt alone (the caller writes config.json or
    tokenizer_config.json to name the class); returns the vocab size."""
    raw = path.parent / f"{path.name}-raw"
    n = train_bpe(raw, vocab_size)
    path.mkdir(parents=True, exist_ok=True)
    if form == "json":
        RobertaTokenizerFast(vocab_file=str(raw / "vocab.json"),
                             merges_file=str(raw / "merges.txt"), **init).save_pretrained(path)
    else:
        for name in ("vocab.json", "merges.txt"):
            shutil.copy(raw / name, path / name)
    return n


TEXTS = [
    "", " ", "  ", "hello", " hello", "Hello World", "dense sparse fusion rank",
    "The TPU kernel's dense scan", "it's  we're\tthey'll  x", "'S 'Ve 'x ''s ''",
    "héllo <mask> wörld<mask>", "a <mask>b", "a\t<mask>", "<mask>", " <mask> ",
    "<s>x</s><pad><unk>", "<s><s>", "東京 123 4567 ①②", "😀 👍🏽 ∑", "  leading",
    "trailing  ", "a\n\n b", "a \n b", "ünï", "x" * 60, "12ab34 a1 1a",
    "ΣΟΦΊΑ σοφίας", "　ideo nbsp sep", "mixed東京text!!", "?!...",
    "tab\t\tend\t", "\x00nul\x7f",
]


@pytest.fixture(scope="module", params=["json", "files"])
def bpe_pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(f"bpe-{request.param}") / "tok"
    write_bpe_dir(path, request.param)
    if request.param == "files":
        # the class from config.json's model_type (no tokenizer_config.json)
        (path / "config.json").write_text(json.dumps({"model_type": "roberta"}))
        assert not (path / "tokenizer.json").exists()
    return AutoTokenizer.from_pretrained(str(path), local_files_only=True), \
        load_tokenizer(path)


def reference(ref, texts, pairs, max_length):
    args = (list(texts),) if pairs is None else (list(texts), list(pairs))
    return ref(*args, padding="max_length", truncation=True, max_length=max_length,
               return_tensors="np")


def assert_same(ref, port, texts, pairs=None, max_length=32):
    want = reference(ref, texts, pairs, max_length)
    got = port(texts, pairs, max_length=max_length)
    assert sorted(got) == sorted(want) == ["attention_mask", "input_ids"]
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_the_fast_tokenizer_is_robertas(bpe_pair):
    ref, port = bpe_pair
    assert type(ref).__name__ == "RobertaTokenizerFast"
    assert isinstance(port, hf_bpe.ByteLevelBPETokenizer)
    assert port.model_input_names == tuple(ref.model_input_names)


@pytest.mark.parametrize("max_length", [8, 64])
def test_single_texts_match(bpe_pair, max_length):
    assert_same(*bpe_pair, TEXTS, max_length=max_length)


def test_pairs_truncate_at_every_pair_of_lengths(bpe_pair):
    """A text of n words is n tokens here; every (n_a, n_b) in 0..40 under
    a 28-token budget exercises longest_first both ways."""
    ref, port = bpe_pair
    texts = [" ".join(["dense"] * n) for n in range(41)]
    assert [len(ref(t, add_special_tokens=False)["input_ids"]) for t in texts] == list(range(41))
    a = [texts[i] for i in range(41) for _ in range(41)]
    b = [texts[j] for _ in range(41) for j in range(41)]
    assert_same(ref, port, a, b, max_length=32)


def test_specials_in_raw_text(bpe_pair):
    """Added tokens match in the raw text, leftmost-longest; <mask> takes
    the whitespace before it, the others none."""
    ref, port = bpe_pair
    texts = ["x <mask> y", "x  \t<mask>", "<mask><mask> <mask>", "<s> </s>", "a<pad>b",
             "<unk>", "< mask>", "<mask", "</s></s>", "<<s>>"]
    assert_same(ref, port, texts, max_length=24)
    assert_same(ref, port, texts, texts[::-1], max_length=24)


def test_add_prefix_space_from_tokenizer_config(tmp_path):
    """tokenizer_config.json's add_prefix_space overrides tokenizer.json's
    pre-tokenizer, as RobertaTokenizerFast.__init__ does."""
    write_bpe_dir(tmp_path / "tok", "json", add_prefix_space=True)
    cfg = json.loads((tmp_path / "tok" / "tokenizer_config.json").read_text())
    assert cfg["add_prefix_space"] is True
    ref = AutoTokenizer.from_pretrained(str(tmp_path / "tok"), local_files_only=True)
    port = load_tokenizer(tmp_path / "tok")
    assert port.add_prefix_space
    assert_same(ref, port, TEXTS, max_length=40)


def test_other_tokenizer_json_refused(tmp_path):
    write_bpe_dir(tmp_path / "tok", "json")
    tj = json.loads((tmp_path / "tok" / "tokenizer.json").read_text())
    tj["model"]["dropout"] = 0.1
    (tmp_path / "tok" / "tokenizer.json").write_text(json.dumps(tj))
    with pytest.raises(ValueError, match="dropout"):
        load_tokenizer(tmp_path / "tok")
    tj["model"]["dropout"] = None
    tj["pre_tokenizer"] = {"type": "Whitespace"}
    (tmp_path / "tok" / "tokenizer.json").write_text(json.dumps(tj))
    with pytest.raises(ValueError, match="not a byte-level BPE"):
        load_tokenizer(tmp_path / "tok")


@pytest.fixture(scope="module")
def json_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe-hyp") / "tok"
    write_bpe_dir(path, "json")
    return AutoTokenizer.from_pretrained(str(path), local_files_only=True), \
        load_tokenizer(path)


TEXT = st.text(max_size=60) | st.lists(
    st.sampled_from(list(WORDS) + SPECIALS + [" ", "  ", "'s", "'", ",", "\t", "\n",
                                              "é", "東", "1", "23", "😀", " "]),
    max_size=30).map("".join)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(texts=st.lists(TEXT, min_size=1, max_size=4))
def test_hypothesis_single_texts(json_pair, texts):
    assert_same(*json_pair, texts, max_length=24)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(pairs=st.lists(st.tuples(TEXT, TEXT), min_size=1, max_size=4))
def test_hypothesis_pairs(json_pair, pairs):
    assert_same(*json_pair, [a for a, _ in pairs], [b for _, b in pairs], max_length=20)


CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


def test_every_code_point_classes_as_the_crate():
    """The split's letter, number, whitespace and other classes over all
    of Unicode, read from the crate's own ByteLevel pre-tokenizer: the code
    points of each class the port gives, behind a character of that class,
    must come back as one word (a run of one class), and all of Unicode in
    order must split as the scanner splits it."""
    pre = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    table = hf_bpe.bytes_to_unicode()

    def crate(text):
        return [w for w, _ in pre.pre_tokenize_str(text)]

    def mapped(words):
        return ["".join(table[b] for b in w.encode()) for w in words]

    groups = {k: [] for k in (hf_bpe.LETTER, hf_bpe.NUMBER, hf_bpe.SPACE, hf_bpe.OTHER)}
    for c in CODE_POINTS:
        groups[hf_bpe.char_class(chr(c))].append(chr(c))
    for cls, lead in ((hf_bpe.LETTER, "a"), (hf_bpe.NUMBER, "1"), (hf_bpe.SPACE, "\t"),
                      (hf_bpe.OTHER, "!")):
        text = lead + "".join(groups[cls])
        words = pre.pre_tokenize_str(text)
        assert len(words) == 1, (cls, [f"U+{ord(text[a]):04X}" for _, (a, _) in words[1:21]])
    text = "".join(map(chr, CODE_POINTS))
    assert mapped(hf_bpe.pre_tokenize(text)) == crate(text)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(text=st.text(max_size=80) | st.text(alphabet=st.characters(max_codepoint=127),
                                           max_size=80))
def test_scanner_matches_the_crate(text):
    """The scanner against the crate's split (byte-level mapped), and the
    ASCII fast path against the scanner."""
    pre = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    want = [w for w, _ in pre.pre_tokenize_str(text)]
    table = hf_bpe.bytes_to_unicode()
    got = ["".join(table[b] for b in w.encode()) for w in hf_bpe.pre_tokenize(text)]
    assert got == want
    assert hf_bpe.pre_tokenize(text) == hf_bpe.pre_tokenize_any(text)
