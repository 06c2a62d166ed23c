"""ALBERT's and BigBird's SentencePiece tokenizers in the port
(``models/hf_unigram.py``, ``hf_spbpe.py``, ``hf_tokenizer.load_tokenizer``)
against ``AlbertTokenizerFast`` and ``BigBirdTokenizerFast``, which JAX's
``AutoTokenizer`` loads, on the same ``tokenizer.json``; and the ``NFKD``
and ``StripAccents`` normalizers of ALBERT's chain against the
``tokenizers`` crate on every code point.

Each ``tokenizer.json`` is laid out as transformers' converters write it,
at a tiny size, its model trained by the crate:

- ALBERT (``AlbertConverter``): Unigram; Replace "``" and "''" by '"',
  ``NFKD``, ``StripAccents``, ``Lowercase``, ``Precompiled`` (the charsmap
  of ``tests/test_torch_hf_unigram.py``), Replace " {2,}" by " ";
  ``Metaspace``; ``[CLS]:0 $A:0 [SEP]:0`` / ``... $B:1 [SEP]:1``; the
  class returns token types;
- BigBird (``BigBirdConverter``, which ``SpmConverter`` builds): the
  normalizer ``Precompiled``, ``Strip`` (right), Replace " {2,}" by "▁",
  the same template, no token types returned; once as a Unigram model and
  once as a BPE one (``unk`` fused, no byte fallback), as a SentencePiece
  file of either type converts.

``input_ids``, ``attention_mask`` and ``token_type_ids`` must match exactly
(tolerance 0)."""

from __future__ import annotations

import json
import unicodedata

import numpy as np
import pytest
from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors
from tokenizers import trainers
from transformers import AlbertTokenizerFast, AutoTokenizer, BigBirdTokenizerFast

from advanced_rag_tpu_torch.models import hf_spbpe, hf_unigram
from advanced_rag_tpu_torch.models.hf_tokenizer import load_tokenizer
from test_torch_hf_bpe import CORPUS, TEXTS
from test_torch_hf_unigram import MORE, charsmap
from test_torch_pipeline import WORDS

CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
SPECIALS = {"albert": ["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"],
            "big_bird": ["<pad>", "</s>", "<s>", "<unk>", "[CLS]", "[SEP]", "[MASK]"]}
KINDS = ["albert", "big_bird", "big_bird-bpe"]
ALBERT_TEXTS = ["``quoted'' text", "ＡＬＢＥＲＴ Ｆｕｌｌ", "Crème Brûlée À LA CARTE",
                "ﬁ ① ㎏ ⅷ ǅ", "x [MASK] y", "x  \t[MASK]", "[CLS][SEP]<pad><unk>",
                "ΣΟΦΊΑ σοφίας", "Ǆemal ﬀ", "é ạ̈", "trailing   ",
                "   leading", "a  b   c"]


def normalizer(kind: str):
    if kind == "albert":
        return normalizers.Sequence([
            normalizers.Replace("``", '"'), normalizers.Replace("''", '"'),
            normalizers.NFKD(), normalizers.StripAccents(), normalizers.Lowercase(),
            normalizers.Precompiled(charsmap()), normalizers.Replace(Regex(" {2,}"), " ")])
    return normalizers.Sequence([normalizers.Precompiled(charsmap()),
                                 normalizers.Strip(left=False, right=True),
                                 normalizers.Replace(Regex(" {2,}"), "▁")])


def write_spm_dir(path, kind: str, vocab_size: int = 400):
    """An ALBERT or BigBird tokenizer directory as the fast class saves it."""
    family = kind.removesuffix("-bpe")
    specials = SPECIALS[family]
    bpe = kind.endswith("-bpe")
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True) if bpe
                    else models.Unigram())
    tok.normalizer = normalizer(family)
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    texts = CORPUS + [" ".join(WORDS[i:] + WORDS[:i]) for i in range(20)]
    trainer = (trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=specials,
                                   min_frequency=1) if bpe else
               trainers.UnigramTrainer(vocab_size=vocab_size, special_tokens=specials,
                                       unk_token="<unk>"))
    tok.train_from_iterator(texts, trainer)
    if not bpe:
        # whole words as pieces too, so a text of n words is n tokens
        tj = json.loads(tok.to_str())
        have = {p for p, _ in tj["model"]["vocab"]}
        tj["model"]["vocab"] += [[f"▁{w}", -2.5] for w in sorted(set(WORDS))
                                 if f"▁{w}" not in have]
        tok = Tokenizer.from_str(json.dumps(tj))
    cls_id, sep_id = (tok.token_to_id(t) for t in ("[CLS]", "[SEP]"))
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS]:0 $A:0 [SEP]:0", pair="[CLS]:0 $A:0 [SEP]:0 $B:1 [SEP]:1",
        special_tokens=[("[CLS]", cls_id), ("[SEP]", sep_id)])
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "raw.json"))
    fast = AlbertTokenizerFast if family == "albert" else BigBirdTokenizerFast
    fast(tokenizer_file=str(path / "raw.json")).save_pretrained(path)
    (path / "raw.json").unlink()
    return tok.get_vocab_size()


@pytest.fixture(scope="module", params=KINDS)
def spm_pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param) / "tok"
    write_spm_dir(path, request.param)
    return request.param, AutoTokenizer.from_pretrained(str(path), local_files_only=True), \
        load_tokenizer(path)


def assert_same(ref, port, texts, pairs=None, max_length=32):
    args = (list(texts),) if pairs is None else (list(texts), list(pairs))
    want = ref(*args, padding="max_length", truncation=True, max_length=max_length,
               return_tensors="np")
    got = port(texts, pairs, max_length=max_length)
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_the_fast_tokenizer_is_the_familys(spm_pair):
    kind, ref, port = spm_pair
    assert type(ref).__name__ == ("AlbertTokenizerFast" if kind == "albert"
                                  else "BigBirdTokenizerFast")
    assert isinstance(port, hf_spbpe.SentencePieceBPETokenizer if kind.endswith("-bpe")
                      else hf_unigram.UnigramTokenizer)
    assert port.model_input_names == tuple(ref.model_input_names)
    assert ("token_type_ids" in port.model_input_names) == (kind == "albert")


@pytest.mark.parametrize("max_length", [8, 64])
def test_single_texts_match(spm_pair, max_length):
    _, ref, port = spm_pair
    assert_same(ref, port, TEXTS + MORE + ALBERT_TEXTS, max_length=max_length)


def test_pairs_match_with_their_token_types(spm_pair):
    """Pairs truncated longest_first (the [SEP] of B of type 1 where the
    class returns types), every length pair of 0..24 words under 29."""
    kind, ref, port = spm_pair
    texts = [" ".join(["dense"] * n) for n in range(25)]
    a = [texts[i] for i in range(25) for _ in range(25)]
    b = [texts[j] for _ in range(25) for j in range(25)]
    assert_same(ref, port, a, b, max_length=32)
    mixed = TEXTS + ALBERT_TEXTS
    assert_same(ref, port, mixed, mixed[::-1], max_length=40)


@pytest.mark.parametrize("step", ["NFKD", "StripAccents"])
def test_every_code_point_matches_the_crate(step):
    """Each of ALBERT's Unicode normalizers, one code point between two
    letters, over all of Unicode: the crate's own tables decide.  Under
    NFKD every mark of a nonzero combining class is also put after a
    class-240 mark and before a class-1 mark, so the crate's ordering (its
    ``_CRATE_STARTER`` marks block it) is held too."""
    ref = getattr(normalizers, step)()
    port = hf_unigram.Normalizer({"type": step})
    bad = [c for c in CODE_POINTS
           if ref.normalize_str(f"x{chr(c)}Y") != port(f"x{chr(c)}Y")]
    if step == "NFKD":
        marks = [c for c in CODE_POINTS if unicodedata.combining(chr(c))]
        bad += [c for c in marks for t in (f"aͅ{chr(c)}", f"a{chr(c)}̴",
                                           f"á{chr(c)}̖")
                if ref.normalize_str(t) != port(t)]
    assert not bad, [f"U+{c:04X} {unicodedata.name(chr(c), '?')}" for c in bad[:20]]


def test_the_crate_tables_are_what_they_change():
    """Each ``_CRATE_*`` entry of the two normalizers is a real difference
    from unicodedata (a stale entry would hide a later one)."""
    for c in hf_unigram._expand(hf_unigram._CRATE_NFKD_WHOLE):
        assert unicodedata.normalize("NFKD", chr(c)) != chr(c)
    for c in hf_unigram._expand(hf_unigram._CRATE_STARTER):
        assert unicodedata.combining(chr(c))
    for c in hf_unigram._expand(hf_unigram._CRATE_NOT_MARK):
        assert unicodedata.category(chr(c))[0] == "M"
    for c in hf_unigram._expand(hf_unigram._CRATE_MARK):
        assert unicodedata.category(chr(c))[0] != "M"


def test_roformer_tokenizer_is_refused(tmp_path):
    """RoFormerTokenizerFast installs a Jieba pre-tokenizer that imports
    rjieba, which is not installed: JAX's AutoTokenizer raises ImportError;
    the port raises ValueError naming it, by tokenizer_class or, with none,
    by model_type."""
    (tmp_path / "vocab.txt").write_text("\n".join(SPECIALS["albert"] + ["[PAD]", "a"]))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "RoFormerTokenizer"}))
    with pytest.raises(ImportError, match="rjieba"):
        AutoTokenizer.from_pretrained(str(tmp_path), local_files_only=True)
    with pytest.raises(ValueError, match="Jieba"):
        load_tokenizer(tmp_path)
    (tmp_path / "tokenizer_config.json").unlink()
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "roformer"}))
    with pytest.raises(ValueError, match="Jieba"):
        load_tokenizer(tmp_path)


def test_spiece_model_alone_is_refused(tmp_path):
    """An ALBERT directory with spiece.model and no tokenizer.json: the port
    reads no SentencePiece file (transformers converts it only with
    sentencepiece installed)."""
    (tmp_path / "spiece.model").write_bytes(b"\x00" * 16)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "AlbertTokenizer"}))
    with pytest.raises(ValueError, match="spiece.model and no tokenizer.json"):
        load_tokenizer(tmp_path)
