"""The port's WordPiece tokenizer (``models/hf_tokenizer.py``) against
``BertTokenizerFast``, which JAX's ``AutoTokenizer`` loads for a BERT
checkpoint, on the same directory.  ``input_ids``, ``attention_mask`` and
``token_type_ids`` must match exactly (tolerance 0)."""

from __future__ import annotations

import json
import unicodedata

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import normalizers, pre_tokenizers
from transformers import AutoTokenizer, BertTokenizerFast

from advanced_rag_tpu_torch.models.hf_tokenizer import WordPieceTokenizer

WORDS = ["the", "tpu", "kernel", "retrieval", "dense", "sparse", "hybrid",
         "fusion", "rank", "cafe", "café", "naive", "über", "straße", "σοφία",
         "東京", "hello", "world", "un", "##able", "##s", "##ing", "##ed",
         "##er", "##ly", "a", "b", "##b", "##c", "ab", "abc", "i̇"]
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def vocab_list():
    chars = [chr(c) for c in range(0x21, 0x250)]
    chars += [chr(c) for c in range(0x391, 0x3CA)] + list("東京大学日本語中文字")
    chars += ["x" * 100]          # a vocabulary word of exactly 100 characters
    cont = ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    seen, out = set(), []
    for tok in (SPECIALS + [f"[unused{i}]" for i in range(4)] + WORDS
                + chars + cont):
        if tok not in seen:
            seen.add(tok)
            out.append(tok)
    return out


TEXTS = [
    "", " ", "\t\n", "Hello, World!", "hello world", "TPU kernels: dense+sparse.",
    "Café naïve façade Über STRASSE straße", "ÀÉÎÕÜ àéîõü ÇÑ",
    "东京大学 日本語テキスト中文", "mixed東京text", "\x00nul\x07bell\x1bescape\x7fdel",
    "zero​width­soft﻿bom", "line sep　ideo nbsp",
    "\u0085next\x0bvt\x0cff", "(a)[b]{c}<d>¿e?¡f! «g» “h” ‘i’ —j– …k",
    "ΣΟΦΊΑ σοφίας ΟΔΟΣ", "İstanbul ǅ ﬁ ß", "emoji 😀 👍🏽 ∑∫√",
    "x" * 100, "y" * 101, "a" + "b" * 100, "unable unables rankly",
    "hello [MASK] world [mask] [CLS][SEP]", "[UNK][PAD]tail", "�replacement",
    "á̧ combining", "tab\tsep\rcr", "ab" * 60,
]


def make_dir(path, *, lowercase, strip_accents):
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(vocab_list()) + "\n", encoding="utf-8")
    tok = BertTokenizerFast(vocab_file=str(path / "vocab.txt"),
                            do_lower_case=lowercase, strip_accents=strip_accents)
    tok.save_pretrained(path)
    return path


FLAGS = [(lc, sa) for lc in (True, False) for sa in (None, True, False)]


@pytest.fixture(scope="module", params=FLAGS, ids=lambda f: f"lower{f[0]}-strip{f[1]}")
def pair_of_tokenizers(request, tmp_path_factory):
    lc, sa = request.param
    path = make_dir(tmp_path_factory.mktemp("tok"), lowercase=lc, strip_accents=sa)
    return AutoTokenizer.from_pretrained(str(path), local_files_only=True), \
        WordPieceTokenizer.from_pretrained(path)


def reference(ref, texts, pairs, max_length):
    args = (list(texts),) if pairs is None else (list(texts), list(pairs))
    enc = ref(*args, padding="max_length", truncation=True,
              max_length=max_length, return_tensors="np")
    return {k: enc[k] for k in ("input_ids", "attention_mask", "token_type_ids")}


def assert_same(ref, port, texts, pairs=None, max_length=16):
    want = reference(ref, texts, pairs, max_length)
    got = port(texts, pairs, max_length=max_length)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("max_length", [16, 32])
def test_single_texts_match(pair_of_tokenizers, max_length):
    ref, port = pair_of_tokenizers
    assert_same(ref, port, TEXTS, max_length=max_length)


@pytest.mark.parametrize("max_length", [16, 32])
def test_pairs_match_with_longest_first_truncation(pair_of_tokenizers, max_length):
    """Every split of the budget: pairs of 0-40 tokens a side, so that
    neither, one and both sides are cut, either side the longer."""
    ref, port = pair_of_tokenizers
    lens = range(0, 41, 3)
    qs = [" ".join(["tpu"] * a) for a in lens for b in lens]
    ds = [" ".join(["dense"] * b) for a in lens for b in lens]
    assert_same(ref, port, qs, ds, max_length=max_length)
    assert_same(ref, port, TEXTS, TEXTS[::-1], max_length=max_length)


def test_vocab_txt_alone_reads_as_tokenizer_json(tmp_path):
    """A directory with vocab.txt and tokenizer_config.json only (no
    tokenizer.json): BertTokenizerFast converts it, the port reads it."""
    path = make_dir(tmp_path, lowercase=False, strip_accents=True)
    (path / "tokenizer.json").unlink()
    ref = AutoTokenizer.from_pretrained(str(path), local_files_only=True)
    port = WordPieceTokenizer.from_pretrained(path)
    assert_same(ref, port, TEXTS, max_length=32)
    assert_same(ref, port, TEXTS, TEXTS[::-1], max_length=32)


def test_tokenizer_config_overrides_tokenizer_json(tmp_path):
    """BertTokenizerFast takes do_lower_case / strip_accents from
    tokenizer_config.json over tokenizer.json's normalizer."""
    path = make_dir(tmp_path, lowercase=True, strip_accents=None)
    cfg = json.loads((path / "tokenizer_config.json").read_text())
    cfg["do_lower_case"] = False
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))
    ref = AutoTokenizer.from_pretrained(str(path), local_files_only=True)
    port = WordPieceTokenizer.from_pretrained(path)
    assert port.lowercase is False
    assert_same(ref, port, TEXTS, max_length=32)


@pytest.mark.parametrize("key,value,match", [
    ("pre_tokenizer", {"type": "Whitespace"}, "not a BERT WordPiece"),
    ("normalizer", {"type": "NFKC"}, "not a BERT WordPiece"),
    ("post_processor", {"type": "RobertaProcessing", "sep": ["[SEP]", 3],
                        "cls": ["[CLS]", 2]}, "not a BERT post-processor"),
    ("post_processor", None, "not a BERT post-processor"),
])
def test_other_tokenizers_are_refused(tmp_path, key, value, match):
    path = make_dir(tmp_path, lowercase=True, strip_accents=None)
    tj = json.loads((path / "tokenizer.json").read_text())
    tj[key] = value
    (path / "tokenizer.json").write_text(json.dumps(tj))
    with pytest.raises(ValueError, match=match):
        WordPieceTokenizer.from_pretrained(path)


@pytest.fixture(scope="module")
def lowercase_pair(tmp_path_factory):
    path = make_dir(tmp_path_factory.mktemp("hyp"), lowercase=True, strip_accents=None)
    return AutoTokenizer.from_pretrained(str(path), local_files_only=True), \
        WordPieceTokenizer.from_pretrained(path)


TEXT = st.text(max_size=60) | st.lists(
    st.sampled_from(WORDS + SPECIALS + [" ", ",", "\t", "é", "東", "##"]),
    max_size=30).map("".join)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(texts=st.lists(TEXT, min_size=1, max_size=4))
def test_hypothesis_single_texts(lowercase_pair, texts):
    assert_same(*lowercase_pair, texts, max_length=24)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(pairs=st.lists(st.tuples(TEXT, TEXT), min_size=1, max_size=4))
def test_hypothesis_pairs(lowercase_pair, pairs):
    assert_same(*lowercase_pair, [a for a, _ in pairs], [b for _, b in pairs],
                max_length=20)


CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


@pytest.mark.parametrize("step", ["clean_text", "handle_chinese_chars",
                                  "strip_accents", "lowercase", "pre_tokenize"])
def test_every_code_point_matches_the_crate(step):
    """Each normalizer step and the pre-tokenizer, one code point between
    two letters, over all of Unicode: the crate's own tables decide."""
    vocab = {t: i for i, t in enumerate(SPECIALS)}
    if step == "pre_tokenize":
        pre = pre_tokenizers.BertPreTokenizer()
        bad = [c for c in CODE_POINTS
               if [w for w, _ in pre.pre_tokenize_str(f"x{chr(c)}y")]
               != WordPieceTokenizer.pre_tokenize(f"x{chr(c)}y")]
    else:
        flags = {"clean_text": False, "handle_chinese_chars": False,
                 "strip_accents": False, "lowercase": False, step: True}
        ref = normalizers.BertNormalizer(**flags)
        port = WordPieceTokenizer(vocab, **flags)
        bad = [c for c in CODE_POINTS
               if ref.normalize_str(f"x{chr(c)}Y") != port.normalize(f"x{chr(c)}Y")]
    assert not bad, [f"U+{c:04X} {unicodedata.name(chr(c), '?')}" for c in bad[:20]]


@pytest.mark.parametrize("lowercase,strip_accents,clean_text",
                         [(lc, sa, ct) for lc in (True, False) for sa in (True, False)
                          for ct in (True, False)])
@settings(max_examples=100, deadline=None, derandomize=True)
@given(text=st.text(alphabet=st.characters(max_codepoint=127), max_size=80))
def test_ascii_fast_path_is_the_general_path(lowercase, strip_accents, clean_text, text):
    """On ASCII text ``normalize`` and ``pre_tokenize`` take a fast path;
    it must give what the per-character path gives (exactly)."""
    tok = WordPieceTokenizer({t: i for i, t in enumerate(SPECIALS)}, lowercase=lowercase,
                             strip_accents=strip_accents, clean_text=clean_text)
    assert tok.normalize(text) == tok.normalize_any(text)
    assert WordPieceTokenizer.pre_tokenize(text) == WordPieceTokenizer.pre_tokenize_any(text)
