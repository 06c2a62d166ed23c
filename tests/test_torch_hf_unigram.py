"""The port's Unigram tokenizer (``models/hf_unigram.py``) against
``XLMRobertaTokenizerFast``, which JAX's ``AutoTokenizer`` loads for an
XLM-RoBERTa checkpoint, on the same ``tokenizer.json``.  ``input_ids`` and
``attention_mask`` must match exactly (tolerance 0), and neither returns
token types.

The ``tokenizer.json`` is XLM-R's layout at a tiny size: a Unigram model
trained by the ``tokenizers`` crate, the normalizer ``Sequence[Precompiled,
Replace(" {2,}", " ")]``, ``Metaspace`` (``prepend_scheme`` "always") and
the template ``<s> A </s></s> B </s>``, ``<mask>`` last with ``lstrip``.
Its charsmap is a small darts-clone double array built by
``hf_unigram.build_precompiled`` (multi-character keys, full-width forms,
keys that prefix other keys, deletions), and ``Precompiled`` is held to
``tokenizers.normalizers.Precompiled`` on the same bytes, with the grapheme
clusters it walks by probed over all of Unicode."""

from __future__ import annotations

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors
from tokenizers import trainers
from transformers import AutoTokenizer, XLMRobertaTokenizerFast

from advanced_rag_tpu_torch.models import hf_unigram
from advanced_rag_tpu_torch.models.hf_tokenizer import load_tokenizer
from test_torch_hf_bpe import CORPUS, TEXTS
from test_torch_pipeline import WORDS

SPECIALS = ["<s>", "<pad>", "</s>", "<unk>"]
#: an NFKC-like charsmap: full-width forms, ligatures, compositions (keys of
#: two and three characters), a key that prefixes a longer one inside one
#: grapheme cluster ("x", "x́") and across clusters ("ａ", "ａｂ"),
#: deletions, whitespace to a space
RULES = {
    **{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},
    "ａｂ": "AB", "ﬁ": "fi", "ﬂ": "fl", "①": "1", "②": "2", "…": "...", "™": "TM",
    "é": "é", "ä": "ä", "ȫ": "ȫ", "x": "z", "x́": "Y",
    "Ω": "Ω", " ": " ", "　": " ", "\t": " ", "\n": " ", "\r": " ",
    "​": "", "\x01": "", "­": "", "Ａ": "a", "؀": "#",
}


def charsmap() -> bytes:
    return hf_unigram.build_precompiled(RULES)


def write_unigram_dir(path, vocab_size=400):
    """An XLM-R tokenizer directory: tokenizer.json, tokenizer_config.json
    and special_tokens_map.json as XLMRobertaTokenizerFast saves them."""
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([normalizers.Precompiled(charsmap()),
                                           normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always",
                                                 split=True)
    tok.train_from_iterator(CORPUS + [" ".join(WORDS[i:] + WORDS[:i]) for i in range(20)],
                            trainers.UnigramTrainer(vocab_size=vocab_size,
                                                    special_tokens=SPECIALS,
                                                    unk_token="<unk>"))
    tj = json.loads(tok.to_str())
    # whole words as pieces too, so a text of n words is n tokens
    have = {p for p, _ in tj["model"]["vocab"]}
    tj["model"]["vocab"] += [[f"▁{w}", -2.5] for w in sorted(set(WORDS))
                             if f"▁{w}" not in have]
    tj["model"]["vocab"].append(["<mask>", 0.0])
    tj["added_tokens"].append({"id": len(tj["model"]["vocab"]) - 1, "content": "<mask>",
                               "single_word": False, "lstrip": True, "rstrip": False,
                               "normalized": False, "special": True})
    tok = Tokenizer.from_str(json.dumps(tj))
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>",
        special_tokens=[("<s>", 0), ("</s>", 2)])
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "raw.json"))
    XLMRobertaTokenizerFast(tokenizer_file=str(path / "raw.json")).save_pretrained(path)
    (path / "raw.json").unlink()
    return len(tj["model"]["vocab"])


@pytest.fixture(scope="module")
def unigram_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("unigram") / "tok"
    write_unigram_dir(path)
    return AutoTokenizer.from_pretrained(str(path), local_files_only=True), \
        load_tokenizer(path)


def assert_same(ref, port, texts, pairs=None, max_length=32):
    args = (list(texts),) if pairs is None else (list(texts), list(pairs))
    want = ref(*args, padding="max_length", truncation=True, max_length=max_length,
               return_tensors="np")
    got = port(texts, pairs, max_length=max_length)
    assert sorted(got) == sorted(want) == ["attention_mask", "input_ids"]
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


MORE = ["ｄｅｎｓｅ ｓｐａｒｓｅ", "ａｂ ａ Ａ", "ﬁne ﬂow ① ② … ™", "café näive",
        "ȫ x́ x́̂ xx", "zero​width soft­hyphen",
        "nb sp ideo　sp", "\x01ctl\x01", "a▁▁b ▁lead", "▁", "؀a ؀",
        "dense   sparse\t\tfusion\n\nrank", "qqqq ЖЖЖ", "🇺🇸é 👍🏽", "\r\n\r\n"]


def test_the_fast_tokenizer_is_xlmrs(unigram_pair):
    ref, port = unigram_pair
    assert type(ref).__name__ == "XLMRobertaTokenizerFast"
    assert isinstance(port, hf_unigram.UnigramTokenizer)
    assert port.model_input_names == tuple(ref.model_input_names)


@pytest.mark.parametrize("max_length", [8, 64])
def test_single_texts_match(unigram_pair, max_length):
    assert_same(*unigram_pair, TEXTS + MORE, max_length=max_length)


def test_pairs_truncate_at_every_pair_of_lengths(unigram_pair):
    ref, port = unigram_pair
    texts = [" ".join(["dense"] * n) for n in range(41)]
    assert [len(ref(t, add_special_tokens=False)["input_ids"]) for t in texts] == list(range(41))
    a = [texts[i] for i in range(41) for _ in range(41)]
    b = [texts[j] for _ in range(41) for j in range(41)]
    assert_same(ref, port, a, b, max_length=32)


def test_specials_in_raw_text(unigram_pair):
    ref, port = unigram_pair
    texts = ["x <mask> y", "x  \t<mask>", "<mask><mask> <mask>", "<s> </s>", "a<pad>b",
             "<unk>", "< mask>", "<mask", "</s></s>", "<<s>>", "ａ<mask>ｂ"]
    assert_same(ref, port, texts, max_length=24)
    assert_same(ref, port, texts, texts[::-1], max_length=24)


TEXT = st.text(max_size=60) | st.lists(
    st.sampled_from(list(WORDS) + SPECIALS + ["<mask>", " ", "  ", "▁", "\t", "\n", "é",
                                              "東", "1", "ａ", "ｂ", "́", "x", "ﬁ",
                                              "​", "😀", "؀"]),
    max_size=30).map("".join)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(texts=st.lists(TEXT, min_size=1, max_size=4))
def test_hypothesis_single_texts(unigram_pair, texts):
    assert_same(*unigram_pair, texts, max_length=24)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(pairs=st.lists(st.tuples(TEXT, TEXT), min_size=1, max_size=4))
def test_hypothesis_pairs(unigram_pair, pairs):
    assert_same(*unigram_pair, [a for a, _ in pairs], [b for _, b in pairs], max_length=20)


@pytest.mark.parametrize("pre", [
    {"prepend_scheme": "always", "split": True}, {"prepend_scheme": "first", "split": True},
    {"prepend_scheme": "never", "split": True}, {"prepend_scheme": "always", "split": False},
    {"prepend_scheme": "first", "split": False}, {"add_prefix_space": True}],
    ids=["always", "first", "never", "always-nosplit", "first-nosplit", "legacy"])
def test_metaspace_forms_match_the_crate(tmp_path, pre):
    """Metaspace's prepend_scheme (always; first: only the piece at the
    start of the text, not one after an added token; never), split, and
    the older add_prefix_space form, against the crate on one vocabulary."""
    write_unigram_dir(tmp_path / "tok")
    tj = json.loads((tmp_path / "tok" / "tokenizer.json").read_text())
    tj["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", **pre}
    (tmp_path / "tok" / "tokenizer.json").write_text(json.dumps(tj))
    crate = Tokenizer.from_file(str(tmp_path / "tok" / "tokenizer.json"))
    port = load_tokenizer(tmp_path / "tok")
    for text in TEXTS + MORE + ["<mask> dense", "dense<mask>sparse rank", "▁x ▁▁y"]:
        assert port.encode(text) == crate.encode(text, add_special_tokens=False).ids, text
    if "add_prefix_space" in pre:
        tj["pre_tokenizer"]["add_prefix_space"] = False
        (tmp_path / "tok" / "tokenizer.json").write_text(json.dumps(tj))
        with pytest.raises(ValueError, match="add_prefix_space false"):
            load_tokenizer(tmp_path / "tok")


def test_precompiled_matches_the_crate():
    """The same charsmap bytes through the crate's Precompiled and the
    port's: every text, and what the port reads of the double array."""
    cm = charsmap()
    crate, port = normalizers.Precompiled(cm), hf_unigram.Precompiled(cm)
    for text in TEXTS + MORE + list(RULES) + ["".join(RULES), "x" + "́" * 4]:
        assert port(text) == crate.normalize_str(text), repr(text)
    assert port.transform("ａｂ") == "a"             # the shortest key wins
    assert port.transform("x́") == "z"
    assert port.transform("q") is None


@settings(max_examples=200, deadline=None, derandomize=True)
@given(text=st.text(max_size=40) | st.lists(st.sampled_from(
    list(RULES) + ["e", "a", "o", "́", "̈", "̄", "‍", "\U0001F1FA",
                   "\U0001F1F8", "ᄀ", "ᅡ", "ᆨ", "가", "ः", "क"]),
    max_size=20).map("".join))
def test_hypothesis_precompiled(text):
    cm = charsmap()
    assert hf_unigram.Precompiled(cm)(text) == normalizers.Precompiled(cm).normalize_str(text)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(text=st.text(alphabet=st.characters(max_codepoint=127), max_size=80))
def test_ascii_fast_path_is_the_general_path(text):
    """On ASCII text without CR LF, Precompiled takes str.translate; it
    must give what the per-cluster path gives (exactly)."""
    port = hf_unigram.Precompiled(charsmap())
    assert port(text) == port.normalize_any(text)


CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


@pytest.mark.parametrize("probe", ["attach", "control", "prepend"])
def test_grapheme_clusters_match_the_crate(probe):
    """The clusters the crate's Precompiled walks by, probed as
    scripts/torch_hf_unicode_tables.py probes them: one charsmap and one
    text of short probes, each ended by a line feed.  A cluster under 6
    bytes whose first character has a rule takes that rule whole, so the
    output shows whether the probe's characters joined: "a" + c over all
    code points (Extend, ZWJ, SpacingMark), c + U+0301 over the BMP
    (Control), c + "a" over planes 0-3 (Prepend)."""
    skip = {0x00, 0x0A, 0x0D, 0x61, 0x301}
    cps = [c for c in CODE_POINTS if c not in skip]
    if probe == "attach":
        rules, fmt = {"a": "#"}, "a{}"
    elif probe == "control":
        cps = [c for c in cps if c <= 0xFFFF]
        rules, fmt = {chr(c): "#" for c in cps}, "{}́"
    else:
        cps = [c for c in cps if c < 0x40000]
        rules, fmt = {chr(c): "#" for c in cps}, "{}a"
    cm = hf_unigram.build_precompiled(rules)
    text = "".join(fmt.format(chr(c)) + "\n" for c in cps)
    want = normalizers.Precompiled(cm).normalize_str(text).split("\n")
    got = hf_unigram.Precompiled(cm)(text).split("\n")
    bad = [f"U+{c:04X}" for c, w, g in zip(cps, want, got) if w != g]
    assert len(want) == len(got) == len(cps) + 1 and not bad, bad[:20]


def test_normalizers(tmp_path):
    """Each normalizer the port supports against the crate's, and one it
    does not."""
    specs = [normalizers.NFKC(), normalizers.Lowercase(), normalizers.Strip(),
             normalizers.Strip(left=False, right=True), normalizers.Replace("a", "bb"),
             normalizers.Replace(Regex(" {2,}"), " "),
             normalizers.Sequence([normalizers.NFKC(), normalizers.Lowercase(),
                                   normalizers.Replace(Regex("x+"), "y")])]
    texts = TEXTS + MORE + ["  ΣΟΦΊΑ İ ǅ ﬁ  ", "ＡＢＣ ①", "　 lead trail  "]
    for spec in specs:
        port = hf_unigram.Normalizer(json.loads(spec.__getstate__()))
        for text in texts:
            assert port(text) == spec.normalize_str(text), (spec, text)
    with pytest.raises(ValueError, match="'NFD' is not supported"):
        hf_unigram.Normalizer({"type": "NFD"})
    with pytest.raises(ValueError, match="regex"):
        hf_unigram.Normalizer({"type": "Replace", "pattern": {"Regex": r"\p{L}"},
                               "content": ""})


def test_sentencepiece_model_alone_is_refused(tmp_path):
    """transformers converts sentencepiece.bpe.model only with
    sentencepiece installed (neither here nor on the card); the port
    raises naming the tokenizer.json it reads."""
    (tmp_path / "sentencepiece.bpe.model").write_bytes(b"\x00" * 16)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "XLMRobertaTokenizer"}))
    with pytest.raises(ValueError, match="sentencepiece.bpe.model and no tokenizer.json"):
        load_tokenizer(tmp_path)
    with pytest.raises((ImportError, ValueError, OSError, AttributeError)):
        AutoTokenizer.from_pretrained(str(tmp_path), local_files_only=True)
