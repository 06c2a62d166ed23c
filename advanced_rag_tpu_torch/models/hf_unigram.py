"""The SentencePiece Unigram tokenizers of XLM-RoBERTa, ALBERT, BigBird,
mBART and Pegasus read from a local HF checkpoint's ``tokenizer.json``.

The port's copy of ``XLMRobertaTokenizerFast``, ``AlbertTokenizerFast``,
``BigBirdTokenizerFast``, ``MBartTokenizerFast`` and
``PegasusTokenizerFast`` (the ``tokenizers`` crate), so the card's machine
needs neither ``transformers`` nor ``tokenizers``:

1. added tokens are found in the raw text first, leftmost-longest
   (``TemplateTokenizer``; the ``<mask>`` / ``[MASK]`` of the first four
   classes takes ``lstrip``; mBART's language codes and Pegasus's
   ``<mask_1>``, ``<unk_2>`` ... are special tokens of their classes);
2. the normalizer on each piece between them (``Normalizer``):
   ``Sequence``, ``Replace`` (a string, or a regex of literals and
   repetition such as XLM-R's ``" {2,}"``), ``NFKC``, ``NFKD``,
   ``StripAccents`` (every combining mark dropped, Mn, Mc and Me: the
   crate's ``is_combining_mark``, unlike BERT's Mn-only strip), ``Strip``,
   ``Lowercase`` (one character at a time, as the crate does) and
   ``Precompiled``; any other raises, naming it.  ALBERT's converter
   writes Replace "``" and "''", ``NFKD``, ``StripAccents``, ``Lowercase``,
   ``Precompiled``, Replace " {2,}"; BigBird's ``Precompiled``, ``Strip``
   (right), Replace " {2,}" by "▁";
3. ``Precompiled`` is SentencePiece's charsmap: a little-endian ``uint32``
   trie size, the darts-clone double array (read with numpy), then the
   NUL-terminated normalized strings.  The crate walks the text by
   extended grapheme cluster (``graphemes``): a cluster of fewer than 6
   UTF-8 bytes whose prefix is a key is replaced by the rule of its
   *shortest* such prefix (the rest of the cluster goes), every other
   character by its own rule or kept;
4. the ``Metaspace`` pre-tokenizer: spaces become ``▁``, one is put in
   front as ``prepend_scheme`` says (``always``; ``first``: only for the
   piece at the start of the text; ``never``), and with ``split`` the
   piece is cut before each run of ``▁``; Pegasus's converter puts
   ``WhitespaceSplit`` before it, so each word takes its own ``▁``;
5. the Unigram model: Viterbi over the pieces' scores (``_viterbi``, the
   crate's ``encode_optimized``: a character no piece covers is ``unk``
   at the lowest score less 10, and consecutive unknowns fuse);
6. the template: XLM-R's ``<s> A </s></s> B </s>``, ALBERT's and BigBird's
   ``[CLS] A [SEP] B [SEP]`` (``hf_tokenizer.bert_template``; ALBERT's
   class returns the token types, B's 1), Pegasus's ``A </s>`` (single
   texts only); mBART's class overwrites the file's with ``A </s>
   <src_lang>`` (``tokenizer_config.json``'s ``src_lang``, default
   ``en_XX``); the ids are ``tokenizer.json``'s (XLM-R's fairseq offset,
   Pegasus's 103, are already in them).

A directory with ``sentencepiece.bpe.model`` (or ``spiece.model``) and no
``tokenizer.json`` raises: transformers converts that file only with
``sentencepiece`` installed, which the card's machine lacks.

``NFKD`` is Python's ``unicodedata`` (Unicode 15.0) where the crate's
older tables agree; the characters of ``_CRATE_NFKD_WHOLE`` the crate
leaves whole, and the marks of ``_CRATE_STARTER`` it takes as starters
(combining class 0), so no reordering crosses either.  ``StripAccents``
takes ``unicodedata``'s M categories with the crate's ``_CRATE_MARK`` /
``_CRATE_NOT_MARK`` differences.

The grapheme cluster classes are Python's ``unicodedata`` (Unicode 15.0)
with the ``_CRATE_*`` differences that
``scripts/torch_hf_unicode_tables.py`` finds by probing the crate's
``Precompiled`` itself; ``tests/test_torch_hf_unigram.py`` holds them
against it.  Of UAX #29 the rules that join clusters of 6 or more bytes
only (emoji ZWJ sequences, GB11; Indic conjuncts, GB9c) are left out: the
crate walks such a cluster one character at a time either way.
"""

from __future__ import annotations

import base64
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .hf_checkpoint import checkpoint_dir, read_json
from .hf_tokenizer import (_LOWER, _WHITESPACE, ALBERT_SPECIALS, BIG_BIRD_SPECIALS,
                           PEGASUS_SPECIALS, ROBERTA_SPECIALS, TemplateTokenizer,
                           _token_content, added_tokens, bert_template, mbart_additional,
                           pegasus_additional, read_tokenizer_config, roberta_template,
                           special_id, suffix_template)

# Where the crate's grapheme clusters (unicode-segmentation) and the rules
# below on unicodedata disagree: characters that attach to the one before
# (Extend, ZWJ, SpacingMark), that break on both sides (Control) or that
# attach to the one after (Prepend).
_CRATE_ATTACH = (
    (0x897, 0x897), (0xe33, 0xe33), (0xeb3, 0xeb3), (0xff9e, 0xff9f),
    (0x10d69, 0x10d6d), (0x10efc, 0x10efc), (0x113b8, 0x113c0),
    (0x113c2, 0x113c2), (0x113c5, 0x113c5), (0x113c7, 0x113ca),
    (0x113cc, 0x113d0), (0x113d2, 0x113d2), (0x113e1, 0x113e2),
    (0x11f5a, 0x11f5a), (0x1611e, 0x1612f), (0x1e5ee, 0x1e5ef),
    (0x1f3fb, 0x1f3ff), (0xe0020, 0xe007f),
)
_CRATE_NOT_ATTACH = (
    (0x102b, 0x102c), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106d),
    (0x1083, 0x1083), (0x1087, 0x108c), (0x108f, 0x108f), (0x109a, 0x109c),
    (0x1a61, 0x1a61), (0x1a63, 0x1a64), (0xaa7b, 0xaa7b), (0xaa7d, 0xaa7d),
    (0x11720, 0x11721),
)
_CRATE_CONTROL = ((0x2065, 0x2065), (0xfff0, 0xfff8))
_CRATE_NOT_CONTROL = (
    (0x600, 0x605), (0x6dd, 0x6dd), (0x70f, 0x70f), (0x890, 0x891),
    (0x8e2, 0x8e2),
)
_CRATE_PREPEND = (
    (0x600, 0x605), (0x6dd, 0x6dd), (0x70f, 0x70f), (0x890, 0x891),
    (0x8e2, 0x8e2), (0xd4e, 0xd4e), (0x110bd, 0x110bd), (0x110cd, 0x110cd),
    (0x111c2, 0x111c3), (0x113d1, 0x113d1), (0x1193f, 0x1193f),
    (0x11941, 0x11941), (0x11a3a, 0x11a3a), (0x11a84, 0x11a89),
    (0x11d46, 0x11d46), (0x11f02, 0x11f02),
)


# Where the crate's NFKD and combining-mark tables (older than Python
# 3.12's unicodedata) disagree: characters its NFKD leaves whole, marks it
# gives combining class 0, marks its StripAccents keeps and characters it
# drops as marks.
_CRATE_NFKD_WHOLE = (
    (0x32ff, 0x32ff), (0xa7f2, 0xa7f4), (0xab69, 0xab69), (0x10781, 0x10785),
    (0x10787, 0x107b0), (0x107b2, 0x107ba), (0x11938, 0x11938),
    (0x1e030, 0x1e06d), (0x1f16c, 0x1f16c), (0x1fbf0, 0x1fbf9),
)
_CRATE_STARTER = (
    (0x7fd, 0x7fd), (0x898, 0x89f), (0x8ca, 0x8d3), (0x9fe, 0x9fe),
    (0xc3c, 0xc3c), (0xd3b, 0xd3c), (0xeba, 0xeba), (0x1715, 0x1715),
    (0x1abf, 0x1ace), (0x1df6, 0x1dfa), (0xa82c, 0xa82c), (0x10d24, 0x10d27),
    (0x10eab, 0x10eac), (0x10efd, 0x10eff), (0x10f46, 0x10f50),
    (0x10f82, 0x10f85), (0x11070, 0x11070), (0x1133b, 0x1133b),
    (0x1145e, 0x1145e), (0x11839, 0x1183a), (0x1193d, 0x1193e),
    (0x11943, 0x11943), (0x119e0, 0x119e0), (0x11a34, 0x11a34),
    (0x11a47, 0x11a47), (0x11a99, 0x11a99), (0x11d42, 0x11d42),
    (0x11d44, 0x11d45), (0x11d97, 0x11d97), (0x11f41, 0x11f42),
    (0x16ff0, 0x16ff1), (0x1e08f, 0x1e08f), (0x1e130, 0x1e136),
    (0x1e2ae, 0x1e2ae), (0x1e2ec, 0x1e2ef), (0x1e4ec, 0x1e4ef),
)
_CRATE_NOT_MARK = (
    (0x7fd, 0x7fd), (0x898, 0x89f), (0x8ca, 0x8d3), (0x9fe, 0x9fe),
    (0xafa, 0xaff), (0xb55, 0xb55), (0xc04, 0xc04), (0xc3c, 0xc3c),
    (0xcf3, 0xcf3), (0xd00, 0xd00), (0xd3b, 0xd3c), (0xd81, 0xd81),
    (0xeba, 0xeba), (0xece, 0xece), (0x1715, 0x1715), (0x180f, 0x180f),
    (0x1abf, 0x1ace), (0x1cf7, 0x1cf7), (0x1df6, 0x1dfa), (0xa82c, 0xa82c),
    (0xa8ff, 0xa8ff), (0x10d24, 0x10d27), (0x10eab, 0x10eac),
    (0x10efd, 0x10eff), (0x10f46, 0x10f50), (0x10f82, 0x10f85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110c2, 0x110c2),
    (0x11145, 0x11146), (0x111c9, 0x111c9), (0x111ce, 0x111cf),
    (0x11241, 0x11241), (0x1133b, 0x1133b), (0x1145e, 0x1145e),
    (0x1182c, 0x1183a), (0x11930, 0x11935), (0x11937, 0x11938),
    (0x1193b, 0x1193e), (0x11940, 0x11940), (0x11942, 0x11943),
    (0x119d1, 0x119d7), (0x119da, 0x119e0), (0x119e4, 0x119e4),
    (0x11a01, 0x11a0a), (0x11a33, 0x11a39), (0x11a3b, 0x11a3e),
    (0x11a47, 0x11a47), (0x11a51, 0x11a5b), (0x11a8a, 0x11a99),
    (0x11d31, 0x11d36), (0x11d3a, 0x11d3a), (0x11d3c, 0x11d3d),
    (0x11d3f, 0x11d45), (0x11d47, 0x11d47), (0x11d8a, 0x11d8e),
    (0x11d90, 0x11d91), (0x11d93, 0x11d97), (0x11ef3, 0x11ef6),
    (0x11f00, 0x11f01), (0x11f03, 0x11f03), (0x11f34, 0x11f3a),
    (0x11f3e, 0x11f42), (0x13440, 0x13440), (0x13447, 0x13455),
    (0x16f4f, 0x16f4f), (0x16f7f, 0x16f87), (0x16fe4, 0x16fe4),
    (0x16ff0, 0x16ff1), (0x1cf00, 0x1cf2d), (0x1cf30, 0x1cf46),
    (0x1e08f, 0x1e08f), (0x1e130, 0x1e136), (0x1e2ae, 0x1e2ae),
    (0x1e2ec, 0x1e2ef), (0x1e4ec, 0x1e4ef),
)
_CRATE_MARK = ((0x1cf2, 0x1cf3),)


def _expand(runs) -> frozenset:
    return frozenset(c for lo, hi in runs for c in range(lo, hi + 1))


_ATTACH, _NOT_ATTACH = _expand(_CRATE_ATTACH), _expand(_CRATE_NOT_ATTACH)
_CONTROL, _NOT_CONTROL = _expand(_CRATE_CONTROL), _expand(_CRATE_NOT_CONTROL)
_PREPEND = _expand(_CRATE_PREPEND)
#: the characters NFKD keeps whole, each a starter in the crate's tables
_NFKD_KEEP = frozenset(map(chr, _expand(_CRATE_NFKD_WHOLE) | _expand(_CRATE_STARTER)))
_NOT_MARK, _MARK = _expand(_CRATE_NOT_MARK), _expand(_CRATE_MARK)


def nfkd(text: str) -> str:
    """NFKD as the crate computes it: the characters of ``_NFKD_KEEP``
    stay whole, and no mark is reordered across them."""
    if _NFKD_KEEP.isdisjoint(text):
        return unicodedata.normalize("NFKD", text)
    out, start = [], 0
    for i, ch in enumerate(text):
        if ch in _NFKD_KEEP:
            out += [unicodedata.normalize("NFKD", text[start:i]), ch]
            start = i + 1
    out.append(unicodedata.normalize("NFKD", text[start:]))
    return "".join(out)


def is_combining_mark(ch: str) -> bool:
    """A character the crate's ``StripAccents`` drops."""
    cp = ord(ch)
    return cp in _MARK or (cp not in _NOT_MARK
                           and unicodedata.category(ch) in ("Mn", "Mc", "Me"))


def strip_accents(text: str) -> str:
    if text.isascii():
        return text
    return "".join([ch for ch in text if not is_combining_mark(ch)])

# grapheme cluster classes
OTHER, CR, LF, CONTROL, ATTACH, PREPEND, L, V, T, LV, LVT, RI = range(12)


def base_class(ch: str) -> int:
    """The grapheme cluster class by unicodedata alone."""
    cp = ord(ch)
    if cp == 0x0D:
        return CR
    if cp == 0x0A:
        return LF
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me", "Mc") or cp in (0x200C, 0x200D):
        return ATTACH
    if cat in ("Cc", "Cf", "Zl", "Zp"):
        return CONTROL
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return T
    if 0xAC00 <= cp <= 0xD7A3:
        return LV if (cp - 0xAC00) % 28 == 0 else LVT
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return RI
    return OTHER


def grapheme_class(ch: str) -> int:
    """The grapheme cluster class as the crate's clusters show it."""
    cp = ord(ch)
    for table, k in ((_PREPEND, PREPEND), (_ATTACH, ATTACH), (_CONTROL, CONTROL)):
        if cp in table:
            return k
    k = base_class(ch)
    if (k == ATTACH and cp in _NOT_ATTACH) or (k == CONTROL and cp in _NOT_CONTROL):
        return OTHER
    return k


_GCLASS: Dict[str, int] = {}


def _joins(a: int, b: int) -> bool:
    """No cluster break between classes ``a`` and ``b`` (for two regional
    indicators: when an odd number of them ends at ``a``)."""
    if a == CR and b == LF:
        return True
    if a in (CR, LF, CONTROL) or b in (CR, LF, CONTROL):
        return False
    if a == L and b in (L, V, LV, LVT):
        return True
    if a in (LV, V) and b in (V, T):
        return True
    if a in (LVT, T) and b == T:
        return True
    if b == ATTACH or a == PREPEND:
        return True
    return a == b == RI


_JOIN = [[_joins(a, b) for b in range(12)] for a in range(12)]


def graphemes(text: str) -> List[str]:
    """``text`` cut into extended grapheme clusters (UAX #29, without
    GB9c and GB11)."""
    out: List[str] = []
    start, prev, ri_run = 0, -1, 0
    gclass, join = _GCLASS, _JOIN
    for i, ch in enumerate(text):
        k = gclass.get(ch)
        if k is None:
            k = gclass[ch] = grapheme_class(ch)
        if prev >= 0 and not (join[prev][k] and (k != RI or ri_run % 2)):
            out.append(text[start:i])
            start = i
        ri_run = ri_run + 1 if k == RI else 0
        prev = k
    if start < len(text):
        out.append(text[start:])
    return out


class Precompiled:
    """SentencePiece's precompiled charsmap, applied as the crate does."""

    def __init__(self, charsmap: bytes):
        if len(charsmap) < 4:
            raise ValueError("a precompiled charsmap needs its 4-byte trie size")
        (size,) = struct.unpack("<I", charsmap[:4])
        if size % 4 or 4 + size > len(charsmap):
            raise ValueError(f"a precompiled charsmap's trie of {size} bytes "
                             f"overruns its {len(charsmap)} bytes")
        self.units = np.frombuffer(charsmap, dtype="<u4", count=size // 4,
                                   offset=4).astype(np.int64).tolist()
        self.normalized = charsmap[4 + size:]
        self._cache: Dict[str, Optional[str]] = {}
        # the rules of the ASCII characters, for str.translate
        self._ascii = {c: r for c in range(128)
                       if (r := self.transform(chr(c))) is not None}

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def transform(self, chunk: str) -> Optional[str]:
        """The rule of the shortest key that prefixes ``chunk``, or None."""
        if chunk in self._cache:
            return self._cache[chunk]
        units, out = self.units, None
        pos = self._offset(units[0])
        for c in chunk.encode("utf-8"):
            if c == 0:                    # the walk stops at a NUL byte
                break
            pos ^= c
            if pos >= len(units):
                break
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                break
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                start = units[pos] & ((1 << 31) - 1)
                end = self.normalized.index(b"\0", start)
                out = self.normalized[start:end].decode("utf-8")
                break
        if len(self._cache) >= 1 << 16:
            self._cache.clear()
        self._cache[chunk] = out
        return out

    def _char(self, ch: str) -> str:
        rule = self.transform(ch)
        return ch if rule is None else rule

    def __call__(self, text: str) -> str:
        if text.isascii() and "\r\n" not in text:
            # every ASCII cluster but CR LF is one character: the same
            # result as normalize_any (scripts/torch_hf_tokenizer_ab.py)
            return text.translate(self._ascii)
        return self.normalize_any(text)

    def normalize_any(self, text: str) -> str:
        """The charsmap by grapheme cluster, on any text."""
        parts: List[str] = []
        for g in graphemes(text):
            if len(g) > 1 and len(g.encode("utf-8")) < 6:
                rule = self.transform(g)
                if rule is not None:
                    parts.append(rule)
                    continue
            parts.extend([self._char(ch) for ch in g])
        return "".join(parts)


def build_precompiled(rules: Dict[str, str]) -> bytes:
    """A precompiled charsmap of ``rules`` (key -> normalized text): a
    double array that ``Precompiled`` and the crate read (not byte for
    byte the one darts-clone would build)."""
    blob, values = bytearray(), {}
    for key, value in rules.items():
        if not key or "\0" in key:
            raise ValueError(f"a charsmap key must be a non-empty text without "
                             f"NUL, not {key!r}")
        values[key] = len(blob)
        blob += value.encode("utf-8") + b"\0"
    root: dict = {}
    for key in rules:
        node = root
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = values[key]
    units: Dict[int, int] = {0: 0}
    bases, block, free = set(), 1, 1
    queue = [(root, 0)]
    for node, pos in queue:
        labels = sorted(k for k in node if k is not None)
        if labels:                        # children: a 256-slot block they fit
            need = labels + [0] if None in node else labels
            while block * 256 in bases or any(block * 256 + c in units for c in need):
                block += 1
            base = block * 256
            block += 1
        else:                             # only a value: any free slot
            while free in units or free in bases:
                free += 1
            base = free
        bases.add(base)
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("the charsmap is too large for this builder")
        units[pos] = units[pos] | (offset << 10)
        if None in node:
            units[pos] |= 1 << 8
            units[base] = (1 << 31) | node[None]
        for label in labels:
            units[base ^ label] = label
            queue.append((node[label], base ^ label))
    # whole 256-unit blocks: a walk XORs any byte into a base in range
    array = [units.get(i, 0) for i in range(((max(units) >> 8) + 1) << 8)]
    return struct.pack(f"<I{len(array)}I", 4 * len(array), *array) + bytes(blob)


_REGEX_OK = re.compile(r"^(?:[^\\\[\](){}.*+?|^$]|\\[^pPsSwWdDbBAzZ0-9]|\{\d+(?:,\d*)?\}|[*+?])+$")


class Normalizer:
    """A ``tokenizer.json`` normalizer of the kinds the port supports."""

    def __init__(self, spec: Optional[dict]):
        self.steps = []
        self._add(spec or {"type": "Sequence", "normalizers": []})

    def _add(self, spec: dict) -> None:
        kind = spec.get("type")
        if kind == "Sequence":
            for sub in spec.get("normalizers", []):
                self._add(sub)
        elif kind == "Replace":
            pattern, content = spec["pattern"], spec["content"]
            if "String" in pattern:
                old = pattern["String"]
                self.steps.append(lambda s, old=old, new=content: s.replace(old, new))
            else:
                regex = pattern["Regex"]
                if not _REGEX_OK.match(regex):
                    raise ValueError(f"the Replace regex {regex!r} is not supported "
                                     "(only literals and repetition)")
                compiled = re.compile(regex)
                self.steps.append(lambda s, r=compiled, new=content: r.sub(
                    lambda m: new, s))
        elif kind == "Prepend":
            # the crate prepends to a non-empty piece only
            self.steps.append(lambda s, p=spec["prepend"]: p + s if s else s)
        elif kind == "NFKC":
            self.steps.append(lambda s: unicodedata.normalize("NFKC", s))
        elif kind == "NFKD":
            self.steps.append(nfkd)
        elif kind == "StripAccents":
            self.steps.append(strip_accents)
        elif kind == "Strip":
            left, right = spec.get("strip_left", True), spec.get("strip_right", True)

            def strip(s, left=left, right=right):
                i, j = 0, len(s)
                while left and i < j and s[i] in _WHITESPACE:
                    i += 1
                while right and j > i and s[j - 1] in _WHITESPACE:
                    j -= 1
                return s[i:j]

            self.steps.append(strip)
        elif kind == "Lowercase":
            self.steps.append(lambda s: "".join([_LOWER.get(ch) or ch.lower() for ch in s]))
        elif kind == "Precompiled":
            charsmap = spec.get("precompiled_charsmap")
            if charsmap:
                self.steps.append(Precompiled(base64.b64decode(charsmap)))
        else:
            raise ValueError(f"the normalizer {kind!r} is not supported (supported: "
                             "Sequence, Replace, Prepend, NFKC, NFKD, StripAccents, "
                             "Strip, Lowercase, Precompiled)")

    def __call__(self, text: str) -> str:
        for step in self.steps:
            text = step(text)
        return text


def _split_whitespace(text: str) -> List[str]:
    """The crate's ``WhitespaceSplit``: the runs between whitespace."""
    words, start = [], None
    for i, ch in enumerate(text):
        if ch in _WHITESPACE:
            if start is not None:
                words.append(text[start:i])
                start = None
        elif start is None:
            start = i
    if start is not None:
        words.append(text[start:])
    return words


def metaspace(text: str, rep: str, prepend_scheme: str, split: bool,
              first: bool) -> List[str]:
    """The crate's ``Metaspace`` pre-tokenizer on one normalized piece:
    spaces become ``rep``, one is put in front as ``prepend_scheme`` says
    (``first``: only for the piece that starts the text), and with
    ``split`` each run of ``rep`` starts a word, merged with what
    follows."""
    if not text:
        return []
    text = text.replace(" ", rep)
    if not text.startswith(rep) and (prepend_scheme == "always" or (
            prepend_scheme == "first" and first)):
        text = rep + text
    if not split:
        return [text]
    words, start, i, n = [], 0, 0, len(text)
    while i < n:
        if text[i] == rep and (i == 0 or text[i - 1] != rep) and i > start:
            words.append(text[start:i])
            start = i
        i += 1
    words.append(text[start:])
    return words


#: each class's special tokens, its template (a pair template's (cls,
#: sep) or a suffix-only one's ids; None: the class writes its own), the
#: separators of its pair template, whether it returns token types and
#: whether its mask token takes ``lstrip``
UNIGRAM_CLASSES = {
    "xlm-roberta": (None, roberta_template, 2, False, True),
    "albert": (ALBERT_SPECIALS, bert_template, 1, True, True),
    "big_bird": (BIG_BIRD_SPECIALS, bert_template, 1, False, True),
    "mbart": (ROBERTA_SPECIALS, None, 0, False, True),
    "pegasus": (PEGASUS_SPECIALS, suffix_template, 0, False, False),
}


class UnigramTokenizer(TemplateTokenizer):
    """``XLMRobertaTokenizerFast``, ``AlbertTokenizerFast``,
    ``BigBirdTokenizerFast``, ``MBartTokenizerFast`` or
    ``PegasusTokenizerFast`` on its own: ``__call__`` returns numpy
    ``input_ids`` and ``attention_mask`` (ALBERT's also
    ``token_type_ids``) [B, L] int64.  ``whitespace_split``: the
    pre-tokenizer is Pegasus's ``WhitespaceSplit`` before ``Metaspace``."""

    def __init__(self, pieces: Sequence[Tuple[str, float]], *, unk_id: int, added,
                 cls_id: Optional[int], sep_id: Optional[int], pad_id: int,
                 normalizer: Optional[dict] = None, replacement: str = "▁",
                 prepend_scheme: str = "always", split: bool = True,
                 pair_seps: int = 2, type_ids: bool = False,
                 suffix: Optional[Sequence[int]] = None, whitespace_split: bool = False):
        super().__init__(added, cls_id=cls_id, sep_id=sep_id, pad_id=pad_id,
                         pair_seps=pair_seps, suffix=suffix)
        if whitespace_split and prepend_scheme == "first":
            raise ValueError("Metaspace prepend_scheme 'first' after WhitespaceSplit "
                             "is not supported")
        self.whitespace_split = whitespace_split
        if type_ids:
            self.model_input_names = ("input_ids", "token_type_ids", "attention_mask")
        if not 0 <= unk_id < len(pieces):
            raise ValueError(f"unk_id {unk_id} is not a piece of the vocabulary")
        if prepend_scheme not in ("always", "first", "never"):
            raise ValueError(f"prepend_scheme {prepend_scheme!r} is not supported")
        self.pieces: Dict[str, Tuple[int, float]] = {}
        for i, (piece, score) in enumerate(pieces):
            # a piece given twice takes its last id, as the crate's map does
            self.pieces[piece] = (i, float(score))
        self.max_piece = max((len(p) for p in self.pieces), default=1)
        self.unk_id = unk_id
        self.unk_score = min(float(s) for _, s in pieces) - 10.0
        self.normalizer = Normalizer(normalizer)
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme
        self.split = split
        self._words: Dict[str, Tuple[int, ...]] = {}

    @classmethod
    def from_pretrained(cls, path, family: str = "xlm-roberta") -> "UnigramTokenizer":
        path = checkpoint_dir(path)
        if not (path / "tokenizer.json").exists():
            for spm in ("sentencepiece.bpe.model", "spiece.model"):
                if (path / spm).exists():
                    raise ValueError(
                        f"{path} holds {spm} and no tokenizer.json: the port reads "
                        "the tokenizer.json (transformers converts the .model file "
                        "only where sentencepiece is installed)")
            raise FileNotFoundError(f"{path} has no tokenizer.json")
        specials, template, pair_seps, type_ids, lstrip_mask = UNIGRAM_CLASSES[family]
        cfg = read_tokenizer_config(path)
        if family == "mbart":
            cfg = dict(cfg, additional_special_tokens=mbart_additional(cfg))
        elif family == "pegasus":
            cfg = dict(cfg, additional_special_tokens=pegasus_additional(cfg))
        tj = read_json(path / "tokenizer.json")
        model, pre = tj.get("model") or {}, tj.get("pre_tokenizer") or {}
        subs = [p.get("type") for p in pre.get("pretokenizers") or []]
        whitespace_split = pre.get("type") == "Sequence" and subs == [
            "WhitespaceSplit", "Metaspace"]
        if whitespace_split:
            pre = pre["pretokenizers"][1]
        if model.get("type") != "Unigram" or pre.get("type") != "Metaspace":
            raise ValueError(f"{path}/tokenizer.json is not a Unigram tokenizer "
                             f"(model {model.get('type')}, pre-tokenizer {pre.get('type')})")
        if model.get("byte_fallback"):
            raise ValueError(f"{path}/tokenizer.json: Unigram byte_fallback is "
                             "not supported")
        pieces = [(p, s) for p, s in model["vocab"]]
        vocab = {p: i for i, (p, _) in enumerate(pieces)}
        added = added_tokens(tj.get("added_tokens", []), cfg, vocab, specials,
                             lstrip_mask=lstrip_mask)
        cls_id = sep_id = suffix = None
        if family == "mbart":
            # MBartTokenizerFast overwrites the file's post-processor:
            # $A </s> <src_lang>
            lang = _token_content(cfg.get("src_lang") or "en_XX")
            lang_id = {t.content: t.id for t in added}.get(lang, vocab.get(lang))
            if lang_id is None:
                raise ValueError(f"{path}: src_lang {lang!r} is not in the vocabulary")
            suffix = [special_id(cfg, "eos_token", added, specials), lang_id]
        elif template is suffix_template:
            suffix = template(tj.get("post_processor") or {})
        else:
            cls_id, sep_id = template(tj.get("post_processor") or {})
        if pre.get("add_prefix_space") is False and "prepend_scheme" not in pre:
            # the older form; the crate reads only add_prefix_space true
            raise ValueError(f"{path}/tokenizer.json: Metaspace add_prefix_space "
                             "false is not supported")
        if model.get("unk_id") is None:
            raise ValueError(f"{path}/tokenizer.json: a Unigram model without "
                             "unk_id is not supported")
        return cls(pieces, unk_id=int(model["unk_id"]), added=added, cls_id=cls_id,
                   sep_id=sep_id, pad_id=special_id(cfg, "pad_token", added, specials),
                   normalizer=tj.get("normalizer"),
                   replacement=pre.get("replacement", "▁"),
                   prepend_scheme=pre.get("prepend_scheme", "always"),
                   split=bool(pre.get("split", True)), pair_seps=pair_seps,
                   type_ids=type_ids, suffix=suffix, whitespace_split=whitespace_split)

    def normalize(self, text: str) -> str:
        return self.normalizer(text)

    def pre_tokenize(self, text: str, first: bool) -> List[str]:
        """``Metaspace`` on one normalized piece (after ``WhitespaceSplit``:
        on each of its words)."""
        if self.whitespace_split:
            return [w for word in _split_whitespace(text) for w in metaspace(
                word, self.replacement, self.prepend_scheme, self.split, first)]
        return metaspace(text, self.replacement, self.prepend_scheme, self.split, first)

    def _viterbi(self, word: str) -> Tuple[int, ...]:
        """The crate's ``encode_optimized`` and the ids of its tokens."""
        n = len(word)
        score = [0.0] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        pieces, top = self.pieces, self.max_piece
        for start in range(n):
            base = score[start]
            single = False
            for end in range(start + 1, min(n, start + top) + 1):
                hit = pieces.get(word[start:end])
                if hit is None:
                    continue
                cand = hit[1] + base
                if back[end] is None or cand > score[end]:
                    score[end], back[end] = cand, (start, hit[0])
                single = single or end == start + 1
            if not single:
                cand = self.unk_score + base
                if back[start + 1] is None or cand > score[start + 1]:
                    score[start + 1], back[start + 1] = cand, (start, self.unk_id)
        # back from the end: consecutive unknowns fuse into one string,
        # which takes its piece's id if it is one, else unk's
        tokens: List[str] = []
        end, unk_end = n, None
        while end > 0:
            start, tid = back[end]
            if tid == self.unk_id:
                unk_end = end if unk_end is None else unk_end
            else:
                if unk_end is not None:
                    tokens.append(word[end:unk_end])
                    unk_end = None
                tokens.append(word[start:end])
            end = start
        if unk_end is not None:
            tokens.append(word[0:unk_end])
        return tuple(pieces[t][0] if t in pieces else self.unk_id
                     for t in reversed(tokens))

    def encode_piece(self, text: str, first: bool) -> List[int]:
        out: List[int] = []
        for word in self.pre_tokenize(text, first):
            ids = self._words.get(word)
            if ids is None:
                ids = self._viterbi(word)
                if len(self._words) >= 1 << 18:
                    self._words.clear()
                self._words[word] = ids
            out.extend(ids)
        return out


__all__ = ["UNIGRAM_CLASSES", "Normalizer", "Precompiled", "UnigramTokenizer",
           "build_precompiled", "grapheme_class", "graphemes", "is_combining_mark",
           "metaspace", "nfkd", "strip_accents"]
