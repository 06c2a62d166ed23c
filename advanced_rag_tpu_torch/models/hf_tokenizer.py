"""BERT WordPiece tokenizer read from a local HF checkpoint directory, and
``load_tokenizer``, the port's ``AutoTokenizer``.

The JAX package tokenizes HF checkpoints with ``AutoTokenizer``, which for
the BERT family loads ``BertTokenizerFast`` (the ``tokenizers`` crate).
This is the port's own copy of what that tokenizer does, so the card's
machine needs neither ``transformers`` nor ``tokenizers``:

1. special tokens ([CLS], [SEP], [PAD], [UNK], [MASK] and any other added
   token) are found in the raw text first, leftmost-longest, and map to
   their ids without normalization;
2. the BERT normalizer on the text between them: clean text (drop NUL,
   U+FFFD and control characters, map whitespace to a space), spaces
   around CJK ideographs, accents stripped (NFD, then every nonspacing
   mark dropped; ``strip_accents=None`` follows ``lowercase``), then each
   character lowercased on its own;
3. the BERT pre-tokenizer: split on whitespace (dropped) and on
   punctuation (Unicode ``P*`` and ASCII 33-47, 58-64, 91-96, 123-126,
   each its own word);
4. WordPiece: greedy longest match, continuations prefixed ``##``; a word
   of more than ``max_input_chars_per_word`` characters, or one that
   cannot be covered, is a single [UNK];
5. the template ``[CLS] A [SEP]`` / ``[CLS] A [SEP] B [SEP]`` (type ids 0
   for A, 1 for B and its [SEP]), truncation to ``max_length`` (a pair by
   ``longest_first`` as the crate splits the budget) and right padding
   with [PAD].

The normalizer flags follow ``BertTokenizerFast.__init__``:
``tokenizer_config.json``'s ``do_lower_case`` (default true),
``strip_accents`` (default none) and ``tokenize_chinese_chars`` (default
true) override those in ``tokenizer.json``.

``load_tokenizer(path)`` chooses as transformers' ``AutoTokenizer`` does:
``tokenizer_config.json``'s ``tokenizer_class`` first, else
``config.json``'s ``model_type``.  BERT, ELECTRA and DistilBERT take
``WordPieceTokenizer`` (so does a RoFormer checkpoint whose
``tokenizer_class`` names BERT's); RoBERTa and RoBERTa-PreLayerNorm take
``hf_bpe.ByteLevelBPETokenizer`` (so do BART and, with its ``A </s>``
template, Blenderbot); XLM-RoBERTa, ALBERT, mBART and Pegasus take
``hf_unigram.UnigramTokenizer``; BigBird takes the Unigram or the
SentencePiece BPE tokenizer as its ``tokenizer.json``'s ``model.type``
says; Llama, Mistral and Gemma take ``hf_spbpe.SentencePieceBPETokenizer``;
GPT-2, GPT-Neo and GPT-J take ``GPT2TokenizerFast``'s and BLOOM
``BloomTokenizerFast``'s form of the byte-level BPE, XGLM the Unigram
tokenizer with its ``</s> A`` template; ``GPTSw3Tokenizer`` (GPT-SW3's
own, and ``model_type`` gpt-sw3's without ``tokenizer_class``) raises, as
it needs ``sentencepiece``; BlenderbotSmall (by ``model_type``) takes
``hf_blenderbot_small.BlenderbotSmallTokenizer``, the slow class
``AutoTokenizer`` takes there; a ``tokenizer_class`` naming it raises, as
``AutoTokenizer`` then takes the byte-level ``BlenderbotSmallTokenizerFast``,
which cannot read those files.  ``RoFormerTokenizer`` raises
``ValueError``: its Jieba pre-tokenizer needs ``rjieba``, which neither
the card's machine nor the JAX package's has (JAX's ``AutoTokenizer``
raises ``ImportError`` there); so does ``MarianTokenizer``, which needs
``sentencepiece``.  Each tokenizer
carries the ``model_input_names`` of its transformers class: only BERT's,
ELECTRA's and ALBERT's return ``token_type_ids``.  ``TemplateTokenizer``
is what the BPE and Unigram tokenizers share: added tokens split out of
the text as the crate's added vocabulary does, the pair template
(RoBERTa's ``<s> A </s></s> B </s>`` or, for ALBERT and BigBird, ``[CLS] A
[SEP] B [SEP]`` with B's token types 1), truncation and padding.
"""

from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .hf_checkpoint import checkpoint_dir, read_json

# Unicode's White_Space property (Rust's char::is_whitespace)
_WHITESPACE = frozenset(chr(c) for c in (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
    *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000))
_ASCII_PUNCT = frozenset(chr(c) for c in (
    *range(33, 48), *range(58, 65), *range(91, 97), *range(123, 127)))
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# an ASCII text after clean text: words and single punctuation marks
_ASCII_WORDS = re.compile(r"[!-/:-@\[-`{-~]|[^ \t\n\r\x0b\x0c!-/:-@\[-`{-~]+")
# clean text on ASCII: controls dropped, whitespace to a space
_ASCII_CLEAN = {c: None for c in (*range(0, 9), 11, 12, *range(14, 32), 127)}
_ASCII_CLEAN.update({c: " " for c in (9, 10, 13)})


# Where the ``tokenizers`` crate's Unicode tables and Python 3.12's
# ``unicodedata`` (Unicode 15.0) disagree, the crate's answer, over every
# code point: printed by scripts/torch_hf_unicode_tables.py and held
# against the crate by tests/test_torch_hf_tokenizer.py.
_CRATE_NOT_CONTROL = (
    (0x890, 0x891), (0x8e2, 0x8e2), (0x110cd, 0x110cd), (0x13430, 0x1343f),
)
_CRATE_MN = ((0x1734, 0x1734),)
_CRATE_NOT_MN = (
    (0x7fd, 0x7fd), (0x898, 0x89f), (0x8ca, 0x8e1), (0x9fe, 0x9fe),
    (0xafa, 0xaff), (0xb55, 0xb55), (0xc04, 0xc04), (0xc3c, 0xc3c),
    (0xd00, 0xd00), (0xd3b, 0xd3c), (0xd81, 0xd81), (0xeba, 0xeba),
    (0xece, 0xece), (0x180f, 0x180f), (0x1885, 0x1886), (0x1abf, 0x1ace),
    (0x1df6, 0x1dfb), (0xa82c, 0xa82c), (0xa8c5, 0xa8c5), (0xa8ff, 0xa8ff),
    (0xa9bd, 0xa9bd), (0x10d24, 0x10d27), (0x10eab, 0x10eac),
    (0x10efd, 0x10eff), (0x10f46, 0x10f50), (0x10f82, 0x10f85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110c2, 0x110c2),
    (0x111c9, 0x111c9), (0x111cf, 0x111cf), (0x1123e, 0x1123e),
    (0x11241, 0x11241), (0x1133b, 0x1133b), (0x11438, 0x1143f),
    (0x11442, 0x11444), (0x11446, 0x11446), (0x1145e, 0x1145e),
    (0x1182f, 0x11837), (0x11839, 0x1183a), (0x1193b, 0x1193c),
    (0x1193e, 0x1193e), (0x11943, 0x11943), (0x119d4, 0x119d7),
    (0x119da, 0x119db), (0x119e0, 0x119e0), (0x11a01, 0x11a0a),
    (0x11a33, 0x11a38), (0x11a3b, 0x11a3e), (0x11a47, 0x11a47),
    (0x11a51, 0x11a56), (0x11a59, 0x11a5b), (0x11a8a, 0x11a96),
    (0x11a98, 0x11a99), (0x11c30, 0x11c36), (0x11c38, 0x11c3d),
    (0x11c3f, 0x11c3f), (0x11c92, 0x11ca7), (0x11caa, 0x11cb0),
    (0x11cb2, 0x11cb3), (0x11cb5, 0x11cb6), (0x11d31, 0x11d36),
    (0x11d3a, 0x11d3a), (0x11d3c, 0x11d3d), (0x11d3f, 0x11d45),
    (0x11d47, 0x11d47), (0x11d90, 0x11d91), (0x11d95, 0x11d95),
    (0x11d97, 0x11d97), (0x11ef3, 0x11ef4), (0x11f00, 0x11f01),
    (0x11f36, 0x11f3a), (0x11f40, 0x11f40), (0x11f42, 0x11f42),
    (0x13440, 0x13440), (0x13447, 0x13455), (0x16f4f, 0x16f4f),
    (0x16fe4, 0x16fe4), (0x1cf00, 0x1cf2d), (0x1cf30, 0x1cf46),
    (0x1e000, 0x1e006), (0x1e008, 0x1e018), (0x1e01b, 0x1e021),
    (0x1e023, 0x1e024), (0x1e026, 0x1e02a), (0x1e08f, 0x1e08f),
    (0x1e130, 0x1e136), (0x1e2ae, 0x1e2ae), (0x1e2ec, 0x1e2ef),
    (0x1e4ec, 0x1e4ef), (0x1e944, 0x1e94a),
)
_CRATE_PUNCT = ((0x166d, 0x166d), (0x111c9, 0x111c9))
_CRATE_NOT_PUNCT = (
    (0x61d, 0x61d), (0x9fd, 0x9fd), (0xa76, 0xa76), (0xc77, 0xc77),
    (0xc84, 0xc84), (0x1b7d, 0x1b7e), (0x2e43, 0x2e4f), (0x2e52, 0x2e5d),
    (0x10ead, 0x10ead), (0x10f55, 0x10f59), (0x10f86, 0x10f89),
    (0x1144b, 0x1144f), (0x1145a, 0x1145b), (0x1145d, 0x1145d),
    (0x11660, 0x1166c), (0x116b9, 0x116b9), (0x1183b, 0x1183b),
    (0x11944, 0x11946), (0x119e2, 0x119e2), (0x11a3f, 0x11a46),
    (0x11a9a, 0x11a9c), (0x11a9e, 0x11aa2), (0x11b00, 0x11b09),
    (0x11c41, 0x11c45), (0x11c70, 0x11c71), (0x11ef7, 0x11ef8),
    (0x11f43, 0x11f4f), (0x11fff, 0x11fff), (0x12ff1, 0x12ff2),
    (0x16e97, 0x16e9a), (0x16fe2, 0x16fe2), (0x1e95e, 0x1e95f),
)
_CRATE_LOWER = (
    (0x1c89, 0x1c89, 1), (0xa7cb, 0xa7cb, -42343), (0xa7cc, 0xa7cc, 1),
    (0xa7ce, 0xa7ce, 1), (0xa7d2, 0xa7d2, 1), (0xa7d4, 0xa7d4, 1),
    (0xa7da, 0xa7da, 1), (0xa7dc, 0xa7dc, -42561), (0x10d50, 0x10d65, 32),
    (0x16ea0, 0x16eb8, 27),
)
_CRATE_NFD_WHOLE = ((0x11938, 0x11938),)


def _expand(runs) -> frozenset:
    return frozenset(c for lo, hi, *_ in runs for c in range(lo, hi + 1))


_NOT_CONTROL, _MN, _NOT_MN, _PUNCT, _NOT_PUNCT = map(_expand, (
    _CRATE_NOT_CONTROL, _CRATE_MN, _CRATE_NOT_MN, _CRATE_PUNCT, _CRATE_NOT_PUNCT))
_LOWER = {chr(c): chr(c + d) for lo, hi, d in _CRATE_LOWER for c in range(lo, hi + 1)}
_NFD_WHOLE = frozenset(map(chr, _expand(_CRATE_NFD_WHOLE)))


def _is_control(ch: str) -> bool:
    # the crate's "other" categories: Cc, Cf, Co, Cs (unassigned is kept)
    return (ch not in "\t\n\r" and ord(ch) not in _NOT_CONTROL
            and unicodedata.category(ch) in ("Cc", "Cf", "Co", "Cs"))


def _is_mark(ch: str) -> bool:
    """A nonspacing mark (Mn), which strip_accents drops."""
    cp = ord(ch)
    return cp in _MN or (cp not in _NOT_MN and unicodedata.category(ch) == "Mn")


def _nfd(text: str) -> str:
    """NFD as the crate computes it: the characters of ``_NFD_WHOLE``
    (starters, so no reordering crosses them) stay whole."""
    if _NFD_WHOLE.isdisjoint(text):
        return unicodedata.normalize("NFD", text)
    out, start = [], 0
    for i, ch in enumerate(text):
        if ch in _NFD_WHOLE:
            out += [unicodedata.normalize("NFD", text[start:i]), ch]
            start = i + 1
    out.append(unicodedata.normalize("NFD", text[start:]))
    return "".join(out)


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    return ch in _ASCII_PUNCT or cp in _PUNCT or (
        cp not in _NOT_PUNCT and unicodedata.category(ch)[0] == "P")


def _token_content(tok) -> Optional[str]:
    """A special token as tokenizer_config / special_tokens_map write it:
    a string or an AddedToken dict."""
    if isinstance(tok, dict):
        return tok.get("content")
    return tok


def _template_tokens(post: dict) -> Tuple[str, str]:
    """The [CLS] and [SEP] strings of a BERT post-processor; any other
    template raises."""
    if post.get("type") == "BertProcessing":
        return post["cls"][0], post["sep"][0]
    if post.get("type") == "TemplateProcessing" and post.get("single"):
        first, last = post["single"][0], post["single"][-1]
        cls_tok = first.get("SpecialToken", {}).get("id")
        sep_tok = last.get("SpecialToken", {}).get("id")

        def piece(kind, name, type_id):
            return {kind: {"id": name, "type_id": type_id}}

        single = [piece("SpecialToken", cls_tok, 0), piece("Sequence", "A", 0),
                  piece("SpecialToken", sep_tok, 0)]
        pair = single + [piece("Sequence", "B", 1), piece("SpecialToken", sep_tok, 1)]
        if post["single"] == single and post.get("pair") == pair:
            return cls_tok, sep_tok
    raise ValueError(f"not a BERT post-processor: {json.dumps(post)[:200]}")


class WordPieceTokenizer:
    """``BertTokenizerFast`` on its own: ``__call__`` returns numpy
    ``input_ids``, ``attention_mask`` and ``token_type_ids`` [B, L] int64,
    padded to ``max_length`` and truncated to it.  ``model_input_names``
    says which of them the transformers class returns (DistilBERT's
    tokenizer returns no token types)."""

    model_input_names: Tuple[str, ...] = ("input_ids", "token_type_ids",
                                          "attention_mask")

    def __init__(self, vocab: Dict[str, int], *, unk_token: str = "[UNK]",
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]",
                 added_tokens: Optional[Dict[str, int]] = None,
                 clean_text: bool = True, handle_chinese_chars: bool = True,
                 strip_accents: Optional[bool] = None, lowercase: bool = True,
                 continuing_prefix: str = "##",
                 max_input_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        for name, tok in (("unk", unk_token), ("cls", cls_token),
                          ("sep", sep_token), ("pad", pad_token)):
            if tok not in self.vocab and tok not in (added_tokens or {}):
                raise ValueError(f"the {name} token {tok!r} is not in the vocabulary")
        self.added = dict(added_tokens) if added_tokens is not None else {
            t: self.vocab[t] for t in (pad_token, unk_token, cls_token, sep_token)}

        def tid(t: str) -> int:
            return self.added[t] if t in self.added else self.vocab[t]

        self.unk_id, self.cls_id = tid(unk_token), tid(cls_token)
        self.sep_id, self.pad_id = tid(sep_token), tid(pad_token)
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.lowercase = lowercase
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.prefix = continuing_prefix
        self.max_chars = max_input_chars_per_word
        # leftmost-longest: the alternation tries longer tokens first
        self._added_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)
        self._char_map: Dict[str, str] = {}
        self._words: Dict[str, Tuple[int, ...]] = {}

    @classmethod
    def from_pretrained(cls, path) -> "WordPieceTokenizer":
        """Read ``tokenizer.json`` when present, else ``vocab.txt``, with
        ``tokenizer_config.json`` / ``special_tokens_map.json``."""
        path = checkpoint_dir(path)
        cfg = {}
        if (path / "tokenizer_config.json").exists():
            cfg = json.loads((path / "tokenizer_config.json").read_text())
        if (path / "special_tokens_map.json").exists():
            for k, v in json.loads(
                    (path / "special_tokens_map.json").read_text()).items():
                cfg.setdefault(k, v)
        flags = dict(lowercase=bool(cfg.get("do_lower_case", True)),
                     strip_accents=cfg.get("strip_accents"),
                     handle_chinese_chars=bool(cfg.get("tokenize_chinese_chars", True)))
        if (path / "tokenizer.json").exists():
            tj = json.loads((path / "tokenizer.json").read_text())
            model, norm = tj.get("model") or {}, tj.get("normalizer") or {}
            if model.get("type") != "WordPiece" or norm.get("type") != "BertNormalizer" \
                    or (tj.get("pre_tokenizer") or {}).get("type") != "BertPreTokenizer":
                raise ValueError(
                    f"{path}/tokenizer.json is not a BERT WordPiece tokenizer "
                    f"(model {model.get('type')}, normalizer {norm.get('type')})")
            cls_tok, sep_tok = _template_tokens(tj.get("post_processor") or {})
            added = {t["content"]: int(t["id"]) for t in tj.get("added_tokens", [])}
            return cls(model["vocab"], unk_token=model.get("unk_token", "[UNK]"),
                       cls_token=cls_tok, sep_token=sep_tok,
                       pad_token=_token_content(cfg.get("pad_token")) or "[PAD]",
                       added_tokens=added,
                       clean_text=bool(norm.get("clean_text", True)),
                       continuing_prefix=model.get("continuing_subword_prefix", "##"),
                       max_input_chars_per_word=int(
                           model.get("max_input_chars_per_word", 100)),
                       **flags)
        if not (path / "vocab.txt").exists():
            raise FileNotFoundError(f"{path} has neither tokenizer.json nor vocab.txt")
        vocab: Dict[str, int] = {}
        with open(path / "vocab.txt", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        toks = {k: _token_content(cfg.get(f"{k}_token")) or d for k, d in (
            ("unk", "[UNK]"), ("cls", "[CLS]"), ("sep", "[SEP]"),
            ("pad", "[PAD]"), ("mask", "[MASK]"))}
        # BertTokenizerFast adds its special tokens to the added vocabulary
        added = {t: vocab[t] for t in toks.values() if t in vocab}
        return cls(vocab, unk_token=toks["unk"], cls_token=toks["cls"],
                   sep_token=toks["sep"], pad_token=toks["pad"],
                   added_tokens=added, **flags)

    # -- the pipeline ---------------------------------------------------------

    def _map_char(self, ch: str) -> str:
        """Clean text and CJK spacing of one character."""
        out = self._char_map.get(ch)
        if out is None:
            out = ch
            if self.clean_text:
                if ch in ("\x00", "�") or _is_control(ch):
                    out = ""
                elif ch in _WHITESPACE:
                    out = " "
            if out and self.handle_chinese_chars and _is_cjk(ch):
                out = f" {ch} "
            self._char_map[ch] = out
        return out

    def normalize(self, text: str) -> str:
        if text.isascii():
            # the same result as normalize_any, several times faster
            # (scripts/torch_hf_tokenizer_ab.py)
            if self.clean_text:
                text = text.translate(_ASCII_CLEAN)
            return text.lower() if self.lowercase else text
        return self.normalize_any(text)

    def normalize_any(self, text: str) -> str:
        """The normalizer one character at a time, on any text."""
        text = "".join([self._map_char(ch) for ch in text])
        if self.strip_accents:
            text = "".join([ch for ch in _nfd(text) if not _is_mark(ch)])
        if self.lowercase:
            # one character at a time, as the crate does (no final sigma)
            text = "".join([_LOWER.get(ch) or ch.lower() for ch in text])
        return text

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        if text.isascii():
            return _ASCII_WORDS.findall(text)
        return WordPieceTokenizer.pre_tokenize_any(text)

    @staticmethod
    def pre_tokenize_any(text: str) -> List[str]:
        """The pre-tokenizer one character at a time, on any text."""
        words: List[str] = []
        cur: List[str] = []
        for ch in text:
            if ch in _WHITESPACE or _is_punct(ch):
                if cur:
                    words.append("".join(cur))
                    cur = []
                if ch not in _WHITESPACE:
                    words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> Tuple[int, ...]:
        ids = self._words.get(word)
        if ids is not None:
            return ids
        if len(word) > self.max_chars:
            ids = (self.unk_id,)
        else:
            pieces: List[int] = []
            start = 0
            while start < len(word):
                end = len(word)
                while end > start:
                    sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                    if sub in self.vocab:
                        pieces.append(self.vocab[sub])
                        break
                    end -= 1
                if end == start:
                    pieces = [self.unk_id]
                    break
                start = end
            ids = tuple(pieces)
        if len(self._words) >= 1 << 18:
            self._words.clear()
        self._words[word] = ids
        return ids

    def _encode_plain(self, text: str) -> List[int]:
        out: List[int] = []
        for word in self.pre_tokenize(self.normalize(text)):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without the template's special tokens."""
        if self._added_re is None:
            return self._encode_plain(text)
        out: List[int] = []
        pos = 0
        for m in self._added_re.finditer(text):
            out.extend(self._encode_plain(text[pos:m.start()]))
            out.append(self.added[m.group()])
            pos = m.end()
        out.extend(self._encode_plain(text[pos:]))
        return out

    @staticmethod
    def _pair_budget(n1: int, n2: int, budget: int) -> Tuple[int, int]:
        """``longest_first`` as the ``tokenizers`` crate splits ``budget``
        between two sequences of n1 and n2 tokens that do not fit."""
        swap = n1 > n2
        if swap:
            n1, n2 = n2, n1
        n2 = n1 if n1 > budget else max(n1, budget - n1)
        if n1 + n2 > budget:
            n1 = budget // 2
            n2 = n1 + budget % 2
        return (n2, n1) if swap else (n1, n2)

    def __call__(self, texts: Sequence[str],
                 pairs: Optional[Sequence[str]] = None, *,
                 max_length: int) -> Dict[str, np.ndarray]:
        if pairs is not None and len(pairs) != len(texts):
            raise ValueError("texts and pairs must align")
        n_special = 2 if pairs is None else 3
        if max_length < n_special:
            raise ValueError(f"max_length {max_length} leaves no room for "
                             f"the {n_special} special tokens")
        budget = max_length - n_special
        ids = np.full((len(texts), max_length), self.pad_id, np.int64)
        types = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            a = self.encode(text)
            if pairs is None:
                row = [self.cls_id, *a[:budget], self.sep_id]
                n_a = len(row)
            else:
                b = self.encode(pairs[i])
                if len(a) + len(b) > budget:
                    na, nb = self._pair_budget(len(a), len(b), budget)
                    a, b = a[:na], b[:nb]
                row = [self.cls_id, *a, self.sep_id, *b, self.sep_id]
                n_a = len(a) + 2
            ids[i, :len(row)] = row
            types[i, n_a:len(row)] = 1
            mask[i, :len(row)] = 1
        out = {"input_ids": ids, "attention_mask": mask, "token_type_ids": types}
        return {k: v for k, v in out.items() if k in self.model_input_names}


# -- what the BPE and Unigram tokenizers share ----------------------------------

@dataclass(frozen=True)
class AddedToken:
    """An entry of the crate's added vocabulary."""
    content: str
    id: int
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = False
    single_word: bool = False


def read_tokenizer_config(path) -> dict:
    """``tokenizer_config.json`` with ``special_tokens_map.json`` under it."""
    path = checkpoint_dir(path)
    cfg = read_json(path / "tokenizer_config.json") \
        if (path / "tokenizer_config.json").exists() else {}
    if (path / "special_tokens_map.json").exists():
        for k, v in read_json(path / "special_tokens_map.json").items():
            cfg.setdefault(k, v)
    return cfg


#: RoBERTa's and XLM-R's special tokens where the config names none
ROBERTA_SPECIALS = dict(bos_token="<s>", eos_token="</s>", sep_token="</s>",
                        cls_token="<s>", unk_token="<unk>", pad_token="<pad>",
                        mask_token="<mask>")
#: ALBERT's and BigBird's (``AlbertTokenizerFast``, ``BigBirdTokenizerFast``)
ALBERT_SPECIALS = dict(bos_token="[CLS]", eos_token="[SEP]", sep_token="[SEP]",
                       cls_token="[CLS]", unk_token="<unk>", pad_token="<pad>",
                       mask_token="[MASK]")
BIG_BIRD_SPECIALS = dict(ALBERT_SPECIALS, bos_token="<s>", eos_token="</s>")
#: ``GPT2TokenizerFast``'s (GPT-Neo's and GPT-J's checkpoints take it),
#: ``BloomTokenizerFast``'s and ``XGLMTokenizerFast``'s (its seven
#: ``<madeupword>``s come from ``xglm_additional``)
GPT2_SPECIALS = dict(bos_token="<|endoftext|>", eos_token="<|endoftext|>",
                     unk_token="<|endoftext|>")
BLOOM_SPECIALS = dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                      pad_token="<pad>")
XGLM_SPECIALS = dict(ROBERTA_SPECIALS)
del XGLM_SPECIALS["mask_token"]
#: the language codes ``MBartTokenizerFast`` adds as special tokens
MBART_LANGUAGE_CODES = (
    "ar_AR", "cs_CZ", "de_DE", "en_XX", "es_XX", "et_EE", "fi_FI", "fr_XX", "gu_IN",
    "hi_IN", "it_IT", "ja_XX", "kk_KZ", "ko_KR", "lt_LT", "lv_LV", "my_MM", "ne_NP",
    "nl_XX", "ro_RO", "ru_RU", "si_LK", "tr_TR", "vi_VN", "zh_CN")
#: ``PegasusTokenizerFast``'s (its ``additional_special_tokens`` come from
#: ``pegasus_additional``)
PEGASUS_SPECIALS = dict(pad_token="<pad>", eos_token="</s>", unk_token="<unk>",
                        mask_token="<mask_2>")


def mbart_additional(cfg: dict) -> List:
    """``MBartTokenizerFast``'s additional special tokens: the language
    codes, then the config's others."""
    given = cfg.get("additional_special_tokens") or []
    return list(MBART_LANGUAGE_CODES) + [
        t for t in given if _token_content(t) not in MBART_LANGUAGE_CODES]


def xglm_additional(cfg: dict) -> List:
    """``XGLMTokenizerFast``'s additional special tokens: the config's,
    then the seven ``<madeupword>``s it lacks."""
    given = list(cfg.get("additional_special_tokens") or [])
    have = set(map(_token_content, given))
    return given + [w for w in (f"<madeupword{i}>" for i in range(7)) if w not in have]


def pegasus_additional(cfg: dict) -> List:
    """``PegasusTokenizerFast``'s additional special tokens: the config's
    with ``mask_token_sent`` in front, filled up with ``<unk_i>`` to
    ``offset - 1`` tokens; without any, ``mask_token_sent`` and
    ``<unk_2>`` ... ``<unk_{offset - 1}>``."""
    offset = int(cfg.get("offset", 103))
    sent = cfg.get("mask_token_sent", "<mask_1>")
    given = cfg.get("additional_special_tokens")
    if given is None:
        return ([sent] if sent is not None else []) + [
            f"<unk_{i}>" for i in range(2, offset)]
    out = list(given)
    if sent is not None and _token_content(sent) not in map(_token_content, out):
        out.insert(0, sent)
    return out + [f"<unk_{i}>" for i in range(len(out), offset - 1)]


def added_tokens(json_tokens: Sequence[dict], cfg: dict,
                 vocab: Dict[str, int], specials: Optional[Dict[str, str]] = None,
                 lstrip_mask: Optional[bool] = None) -> List[AddedToken]:
    """The added vocabulary ``PreTrainedTokenizerFast.__init__`` leaves for
    RoBERTa's and XLM-R's classes (or another class whose default special
    tokens are ``specials``): ``tokenizer.json``'s ``added_tokens``, then
    ``tokenizer_config.json``'s ``added_tokens_decoder``, then the class's
    special tokens (``ROBERTA_SPECIALS`` where the config names none; a
    mask token given as a string takes ``lstrip`` where the class makes it
    so, RoBERTa's, ALBERT's and BigBird's, as ``lstrip_mask`` says, by
    default for RoBERTa's specials), each once, by content; a special
    token is matched in the raw text (not normalized)."""
    roberta = specials is None
    specials = ROBERTA_SPECIALS if roberta else specials
    lstrip_mask = roberta if lstrip_mask is None else lstrip_mask
    out: Dict[str, AddedToken] = {}

    def add(content, tid, flags):
        if content in out:
            return
        if tid is None:
            if content not in vocab:
                raise ValueError(f"the added token {content!r} is not in the vocabulary")
            tid = vocab[content]
        if flags.get("single_word"):
            raise ValueError(f"the added token {content!r} is single_word, "
                             "which the port does not support")
        out[content] = AddedToken(
            content, int(tid), lstrip=bool(flags.get("lstrip", False)),
            rstrip=bool(flags.get("rstrip", False)),
            normalized=bool(flags.get("normalized", not flags.get("special", True))))

    for t in json_tokens:
        add(t["content"], t["id"], t)
    for tid, t in sorted((cfg.get("added_tokens_decoder") or {}).items(),
                         key=lambda kv: int(kv[0])):
        add(t["content"], int(tid), t)
    names = [f"{k}_token" for k in ("bos", "eos", "unk", "sep", "pad", "cls", "mask")]
    for name in names + ["additional_special_tokens"]:
        toks = cfg.get(name, specials.get(name))
        for tok in (toks if isinstance(toks, list) else [toks]):
            if tok is None:
                continue
            flags = tok if isinstance(tok, dict) else {"lstrip": lstrip_mask and name == "mask_token"}
            add(_token_content(tok), None, {"special": True, "normalized": False, **flags})
    return list(out.values())


def special_id(cfg: dict, name: str, added: Sequence[AddedToken],
               specials: Optional[Dict[str, str]] = None) -> Optional[int]:
    """The id of the special token ``name`` (e.g. "pad_token"), which
    ``added_tokens`` put in the added vocabulary (``specials``: the class's
    defaults, RoBERTa's where None); None where neither names one (GPT-2's
    class has no pad token)."""
    content = _token_content(cfg.get(name, (specials or ROBERTA_SPECIALS).get(name)))
    if content is None:
        return None
    return next(t.id for t in added if t.content == content)


def _added_pattern(tokens: Sequence[AddedToken]):
    # leftmost-longest: the alternation tries longer tokens first
    if not tokens:
        return None
    return re.compile("|".join(re.escape(t.content) for t in
                               sorted(tokens, key=lambda t: len(t.content), reverse=True)))


def split_added(text: str, pattern, by_content: Dict[str, AddedToken]
                ) -> List[Union[str, int]]:
    """``text`` as the crate's ``find_matches`` splits it: the pieces
    between added tokens (str) and the tokens' ids (int); an ``lstrip``
    token takes the whitespace before it, an ``rstrip`` one that after."""
    if pattern is None or not text:
        return [text] if text else []
    out: List[Union[str, int]] = []
    pos = 0
    for m in pattern.finditer(text):
        tok = by_content[m.group()]
        start, stop = m.start(), m.end()
        if tok.lstrip:
            while start > pos and text[start - 1] in _WHITESPACE:
                start -= 1
        if tok.rstrip:
            while stop < len(text) and text[stop] in _WHITESPACE:
                stop += 1
        if pos < start:
            out.append(text[pos:start])
        out.append(tok.id)
        pos = stop
    if pos < len(text):
        out.append(text[pos:])
    return out


class TemplateTokenizer:
    """The template around the ids a subclass's ``encode_piece`` gives the
    text between added tokens: ``<s> A </s>`` / ``<s> A </s></s> B </s>``
    (RoBERTa's, ``pair_seps`` 2) or ``[CLS] A [SEP]`` / ``[CLS] A [SEP] B
    [SEP]`` (ALBERT's and BigBird's, ``pair_seps`` 1, B and its separator
    of token type 1), or with ``suffix`` a single text followed by those
    ids alone (Pegasus's and Blenderbot's ``A </s>``, mBART's ``A </s>
    <lang>``, BlenderbotSmall's ``A``; no pair template), truncated to
    ``max_length`` (a pair ``longest_first``, a single text on
    ``truncation_side``) and padded with the pad id on ``padding_side``
    (right by default); ``prefix`` puts ids before a single text (XGLM's
    ``</s> A``; no pair template); ``__call__`` returns numpy
    ``input_ids``, ``attention_mask``
    and, where ``model_input_names`` has them, ``token_type_ids`` [B, L]
    int64, as the fast tokenizers do (RoBERTa's, XLM-R's and BigBird's
    return no token types)."""

    model_input_names: Tuple[str, ...] = ("input_ids", "attention_mask")

    def __init__(self, added: Sequence[AddedToken], *, cls_id: Optional[int],
                 sep_id: Optional[int], pad_id: Optional[int], pair_seps: int = 2,
                 suffix: Optional[Sequence[int]] = None,
                 prefix: Optional[Sequence[int]] = None, padding_side: str = "right",
                 truncation_side: str = "right"):
        self.added = list(added)
        self.cls_id, self.sep_id, self.pad_id = cls_id, sep_id, pad_id
        self.pair_seps = pair_seps
        if prefix is not None and suffix is None:
            suffix = []
        self.suffix = None if suffix is None else list(suffix)
        self.prefix = list(prefix or [])
        for name, side in (("padding_side", padding_side),
                           ("truncation_side", truncation_side)):
            if side not in ("left", "right"):
                raise ValueError(f"{name} {side!r} is not left or right")
        self.padding_side, self.truncation_side = padding_side, truncation_side
        self._by_content = {t.content: t for t in self.added}
        self._raw_re = _added_pattern([t for t in self.added if not t.normalized])
        self._norm_re = _added_pattern([t for t in self.added if t.normalized])

    def normalize(self, text: str) -> str:
        return text

    def encode_piece(self, text: str, first: bool) -> List[int]:
        """The ids of a normalized piece; ``first``: it starts the text."""
        raise NotImplementedError

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without the template's special tokens."""
        out: List[int] = []
        for i, piece in enumerate(split_added(text, self._raw_re, self._by_content)):
            if isinstance(piece, int):
                out.append(piece)
                continue
            subs = split_added(self.normalize(piece), self._norm_re, self._by_content)
            for j, sub in enumerate(subs):
                out.extend([sub] if isinstance(sub, int)
                           else self.encode_piece(sub, first=i == j == 0))
        return out

    def __call__(self, texts: Sequence[str],
                 pairs: Optional[Sequence[str]] = None, *,
                 max_length: int) -> Dict[str, np.ndarray]:
        if pairs is not None and len(pairs) != len(texts):
            raise ValueError("texts and pairs must align")
        if pairs is not None and self.suffix is not None:
            raise ValueError("this tokenizer's template takes single texts only")
        head, tail = ((self.prefix, self.suffix) if self.suffix is not None
                      else ([self.cls_id], [self.sep_id]))
        n_special = len(head) + len(tail) if pairs is None else 2 + self.pair_seps
        if max_length < n_special:
            raise ValueError(f"max_length {max_length} leaves no room for "
                             f"the {n_special} special tokens")
        budget = max_length - n_special
        ids = np.full((len(texts), max_length), 0 if self.pad_id is None else self.pad_id,
                      np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        types = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            a = self.encode(text)
            if pairs is None:
                if len(a) > budget:
                    a = a[:budget] if self.truncation_side == "right" else a[len(a) - budget:]
                row = [*head, *a, *tail]
            else:
                b = self.encode(pairs[i])
                if len(a) + len(b) > budget:
                    na, nb = WordPieceTokenizer._pair_budget(len(a), len(b), budget)
                    a, b = a[:na], b[:nb]
                row = [self.cls_id, *a, *[self.sep_id] * self.pair_seps, *b, self.sep_id]
                if self.pair_seps == 1:
                    types[i, len(a) + 2:len(row)] = 1
            if len(row) < max_length and self.pad_id is None:
                raise ValueError("the tokenizer has no pad_token to pad to max_length")
            at = (slice(0, len(row)) if self.padding_side == "right"
                  else slice(max_length - len(row), max_length))
            ids[i, at] = row
            mask[i, at] = 1
        out = {"input_ids": ids, "attention_mask": mask}
        if "token_type_ids" in self.model_input_names:
            out["token_type_ids"] = types
        return out


def roberta_template(post: dict) -> Tuple[int, int]:
    """The ids of ``<s>`` and ``</s>`` in a ``RobertaProcessing`` or the
    equal ``TemplateProcessing``; any other template raises."""
    if post.get("type") == "RobertaProcessing":
        return int(post["cls"][1]), int(post["sep"][1])
    if post.get("type") == "TemplateProcessing":
        def toks(seq):
            return [("S", p["SpecialToken"]["id"]) if "SpecialToken" in p
                    else ("Q", p["Sequence"]["id"]) for p in seq]

        single, pair = toks(post.get("single") or []), toks(post.get("pair") or [])
        special = post.get("special_tokens") or {}
        if len(single) == 3 and single[1] == ("Q", "A"):
            cls_tok, sep_tok = single[0][1], single[2][1]
            want = [("S", cls_tok), ("Q", "A"), ("S", sep_tok), ("S", sep_tok),
                    ("Q", "B"), ("S", sep_tok)]
            if single[0][0] == single[2][0] == "S" and pair == want and all(
                    len(special.get(t, {}).get("ids", [])) == 1 for t in (cls_tok, sep_tok)):
                return int(special[cls_tok]["ids"][0]), int(special[sep_tok]["ids"][0])
    raise ValueError(f"not a RoBERTa post-processor: {json.dumps(post)[:200]}")


def _items(seq) -> List[Tuple[str, str, int]]:
    """A ``TemplateProcessing`` form as (kind, id, type id) triples: "S"
    for a special token, "Q" for a sequence ($A, $B)."""
    return [("S", p["SpecialToken"]["id"], p["SpecialToken"].get("type_id", 0))
            if "SpecialToken" in p else
            ("Q", p["Sequence"]["id"], p["Sequence"].get("type_id", 0))
            for p in seq or []]


def bert_template(post: dict) -> Tuple[int, int]:
    """The ids of ``[CLS]`` and ``[SEP]`` in the ``TemplateProcessing``
    that ALBERT's and BigBird's converters write (``[CLS]:0 $A:0 [SEP]:0``,
    pair ``... $B:1 [SEP]:1``); any other template raises."""
    if post.get("type") == "TemplateProcessing":
        single, pair = _items(post.get("single")), _items(post.get("pair"))
        special = post.get("special_tokens") or {}
        if len(single) == 3 and single[0][0] == single[2][0] == "S":
            cls_tok, sep_tok = single[0][1], single[2][1]
            want = [("S", cls_tok, 0), ("Q", "A", 0), ("S", sep_tok, 0)]
            if single == want and pair == want + [("Q", "B", 1), ("S", sep_tok, 1)] and all(
                    len(special.get(t, {}).get("ids", [])) == 1 for t in (cls_tok, sep_tok)):
                return int(special[cls_tok]["ids"][0]), int(special[sep_tok]["ids"][0])
    raise ValueError(f"not a [CLS] A [SEP] B [SEP] post-processor: {json.dumps(post)[:200]}")


def affix_template(post: dict) -> Tuple[List[int], List[int]]:
    """The ids before and after ``$A`` in a ``TemplateProcessing`` whose
    single form is the text between special tokens of type 0 (Pegasus's
    ``$A </s>``, Blenderbot's ``$A:0 </s>:0``, XGLM's ``</s> $A``, GPT-2's
    ``<|endoftext|> $A``); its pair form is never used; any other
    raises."""
    if post.get("type") == "TemplateProcessing":
        single, special = _items(post.get("single")), post.get("special_tokens") or {}
        at = [i for i, (kind, _, _) in enumerate(single) if kind == "Q"]
        if at and single[at[0]] == ("Q", "A", 0) and len(at) == 1 and all(
                kind == "S" and type_id == 0 and len(special.get(tok, {}).get("ids", [])) == 1
                for kind, tok, type_id in single[:at[0]] + single[at[0] + 1:]):
            ids = [int(special[tok]["ids"][0]) if kind == "S" else None
                   for kind, tok, _ in single]
            return ids[:at[0]], ids[at[0] + 1:]
    raise ValueError(f"not a single-text post-processor: {json.dumps(post)[:200]}")


def suffix_template(post: dict) -> List[int]:
    """The ids after ``$A`` in a ``TemplateProcessing`` whose single form
    is the text followed by special tokens of type 0 (Pegasus's ``$A
    </s>``, Blenderbot's ``$A:0 </s>:0``); any other raises."""
    try:
        prefix, suffix = affix_template(post)
    except ValueError:
        prefix = None
    if prefix != []:
        raise ValueError(f"not an A </s> post-processor: {json.dumps(post)[:200]}")
    return suffix


def load_tokenizer(path):
    """The tokenizer of a checkpoint directory, chosen as ``AutoTokenizer``
    chooses it: ``tokenizer_config.json``'s ``tokenizer_class``, else
    ``config.json``'s ``model_type``."""
    path = checkpoint_dir(path)
    cls_name = read_tokenizer_config(path).get("tokenizer_class")
    if cls_name:
        family = cls_name.removesuffix("Fast").removesuffix("Tokenizer").lower()
        family = {"xlmroberta": "xlm-roberta", "bigbird": "big_bird",
                  "blenderbotsmall": "blenderbot-small",
                  "gptsw3": "gpt-sw3"}.get(family, family)
    else:
        family = (read_json(path / "config.json").get("model_type")
                  if (path / "config.json").exists() else None)
    if family in ("bert", "electra"):
        return WordPieceTokenizer.from_pretrained(path)
    if family == "distilbert":
        tok = WordPieceTokenizer.from_pretrained(path)
        tok.model_input_names = ("input_ids", "attention_mask")
        return tok
    if family in ("roberta", "roberta-prelayernorm", "bart", "blenderbot", "gpt2",
                  "gpt_neo", "gptj", "bloom"):
        from .hf_bpe import ByteLevelBPETokenizer

        # GPT-Neo's and GPT-J's checkpoints take GPT2TokenizerFast
        return ByteLevelBPETokenizer.from_pretrained(path, {
            "blenderbot": "blenderbot", "bloom": "bloom", "gpt2": "gpt2",
            "gpt_neo": "gpt2", "gptj": "gpt2"}.get(family, "roberta"))
    if family == "gpt-sw3":
        raise ValueError(f"{path}: GPTSw3Tokenizer is not supported: it reads its "
                         "SentencePiece model with sentencepiece, which neither the card's "
                         "machine nor the JAX package's has (the JAX reference's "
                         "AutoTokenizer fails there); a GPT-SW3 checkpoint whose "
                         "tokenizer_class names a tokenizer the port reads is served")
    if family in ("xlm-roberta", "albert", "mbart", "pegasus", "xglm"):
        from .hf_unigram import UnigramTokenizer

        return UnigramTokenizer.from_pretrained(path, family)
    if family == "big_bird":
        from .hf_spbpe import SentencePieceBPETokenizer
        from .hf_unigram import UnigramTokenizer

        # BigBird's converter writes whichever model its SentencePiece file holds
        kind = ((read_json(path / "tokenizer.json").get("model") or {}).get("type")
                if (path / "tokenizer.json").exists() else None)
        if kind == "BPE":
            return SentencePieceBPETokenizer.from_pretrained(path, family)
        return UnigramTokenizer.from_pretrained(path, family)
    if family == "roformer":
        raise ValueError(f"{path}: RoFormerTokenizer is not supported: its Jieba "
                         "pre-tokenizer needs rjieba (the JAX reference's AutoTokenizer "
                         "raises ImportError there); a RoFormer checkpoint with a "
                         "WordPiece tokenizer (tokenizer_class BertTokenizer) is served")
    if family == "blenderbot-small":
        if cls_name:
            raise ValueError(
                f"{path}: tokenizer_class {cls_name!r} is not supported: AutoTokenizer "
                "then takes BlenderbotSmallTokenizerFast, a byte-level BPE that cannot "
                "read the @@ vocabulary of BlenderbotSmallTokenizer's files; without "
                "tokenizer_class, config.json's model_type 'blenderbot-small' takes "
                "the slow class, which the port reads")
        from .hf_blenderbot_small import BlenderbotSmallTokenizer

        return BlenderbotSmallTokenizer.from_pretrained(path)
    if family == "marian":
        raise ValueError(f"{path}: MarianTokenizer is not supported: it reads its "
                         "SentencePiece files with sentencepiece, which neither the card's "
                         "machine nor the JAX package's has (the JAX reference's "
                         "AutoTokenizer fails there); a Marian checkpoint whose "
                         "tokenizer_class names a tokenizer the port reads is served")
    if family in ("llama", "mistral", "gemma"):
        from .hf_spbpe import SentencePieceBPETokenizer

        # Mistral's checkpoints take LlamaTokenizerFast
        return SentencePieceBPETokenizer.from_pretrained(
            path, "gemma" if family == "gemma" else "llama")
    raise ValueError(f"{path}: tokenizer {cls_name or family!r} is not supported; "
                     "the port reads the BERT, ELECTRA, DistilBERT (WordPiece), "
                     "RoBERTa, RoBERTa-PreLayerNorm, BART, Blenderbot (byte-level BPE), "
                     "GPT-2, BLOOM (byte-level BPE), XLM-RoBERTa, ALBERT, mBART, Pegasus, "
                     "XGLM (Unigram), BigBird (Unigram or SentencePiece BPE), Llama, "
                     "Mistral, Gemma (SentencePiece BPE) and BlenderbotSmall tokenizers")


__all__ = ["ALBERT_SPECIALS", "BIG_BIRD_SPECIALS", "BLOOM_SPECIALS", "GPT2_SPECIALS",
           "MBART_LANGUAGE_CODES", "PEGASUS_SPECIALS", "ROBERTA_SPECIALS", "XGLM_SPECIALS",
           "AddedToken", "TemplateTokenizer", "WordPieceTokenizer", "added_tokens",
           "affix_template", "bert_template", "load_tokenizer", "mbart_additional",
           "pegasus_additional", "read_tokenizer_config", "xglm_additional",
           "roberta_template", "special_id", "split_added", "suffix_template"]
