"""RoBERTa's byte-level BPE tokenizer read from a local HF checkpoint.

The port's copy of ``RobertaTokenizerFast`` (the ``tokenizers`` crate;
``BartTokenizerFast`` is the same class, and ``BlenderbotTokenizerFast``
differs in its template only), so the card's machine needs neither
``transformers`` nor ``tokenizers``:

1. added tokens (``<s>``, ``</s>``, ``<unk>``, ``<pad>``, ``<mask>`` and any
   other) are found in the raw text first, leftmost-longest; ``<mask>``
   takes the whitespace before it (``lstrip``) (``TemplateTokenizer``);
2. the ``ByteLevel`` pre-tokenizer on each piece between them: a space in
   front when ``add_prefix_space`` is set and the piece has none, then
   GPT-2's split ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
   ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`` (``pre_tokenize``, a hand-written
   scanner: Python's ``re`` has no ``\\p{L}``), each word's UTF-8 bytes
   mapped to GPT-2's ``bytes_to_unicode`` alphabet;
3. BPE: the crate's merge loop, the pair of lowest rank first and, among
   equal ranks, the leftmost (``_merge``);
4. the template ``<s> A </s>`` / ``<s> A </s></s> B </s>``, truncation
   (``longest_first`` for pairs) and padding.  Blenderbot's is the one its
   ``tokenizer.json`` names (its converter writes ``A </s>``, a single
   text alone; a ``RobertaProcessing`` is RoBERTa's), and ``A </s>``
   where only ``vocab.json`` + ``merges.txt`` are given.

``GPT2TokenizerFast`` (which GPT-Neo's and GPT-J's checkpoints take) is
the same pipeline with the ``ByteLevel`` post-processor: no special
tokens around the text (``<|endoftext|> A`` where its converter was given
``add_bos_token``), no pad token unless the config names one (the
embedder then refuses the checkpoint), and padding on
``tokenizer_config.json``'s ``padding_side`` (default right).
``BloomTokenizerFast`` pre-tokenizes with a ``Sequence``: a ``Split`` on
``BLOOM_SPLIT`` (``bloom_split``: each match of `` ?`` and a run of
characters other than whitespace and ``( | . , ! ? … 。 ， 、 । ۔ ، )``,
and each stretch between matches, is a word) then ``ByteLevel`` without
its regex; its published config pads on the left.

Files: ``tokenizer.json`` (model ``BPE``, pre-tokenizer ``ByteLevel``,
post-processor ``RobertaProcessing`` or the equal ``TemplateProcessing``),
else ``vocab.json`` + ``merges.txt`` (its first line, the ``#version``
header, skipped as the slow tokenizer skips it), with
``tokenizer_config.json`` / ``special_tokens_map.json``;
``tokenizer_config.json``'s ``add_prefix_space`` (default false)
overrides ``tokenizer.json``'s, as ``RobertaTokenizerFast.__init__`` does.

The letter, number and whitespace classes of the split are the crate's
(Oniguruma's Unicode tables), code point by code point: Python's
``unicodedata`` (Unicode 15.0) with the ``_CRATE_*`` differences printed
by ``scripts/torch_hf_unicode_tables.py`` and held against the crate over
every code point by ``tests/test_torch_hf_bpe.py``; BLOOM's split by
``tests/test_torch_hf_gpt_tokenizer.py``.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

from .hf_checkpoint import checkpoint_dir, read_json
from .hf_tokenizer import (BLOOM_SPECIALS, GPT2_SPECIALS, TemplateTokenizer, affix_template,
                           added_tokens, read_tokenizer_config, roberta_template, special_id,
                           suffix_template)

# Where Oniguruma's \p{L} / \p{N} / \s in the crate and Python 3.12's
# unicodedata (Unicode 15.0: categories L*, N*; White_Space) disagree.
_CRATE_LETTER = (
    (0x1c89, 0x1c8a), (0xa7cb, 0xa7cd), (0xa7da, 0xa7dc), (0x105c0, 0x105f3),
    (0x10d4a, 0x10d65), (0x10d6f, 0x10d85), (0x10ec2, 0x10ec4),
    (0x11380, 0x11389), (0x1138b, 0x1138b), (0x1138e, 0x1138e),
    (0x11390, 0x113b5), (0x113b7, 0x113b7), (0x113d1, 0x113d1),
    (0x113d3, 0x113d3), (0x11bc0, 0x11be0), (0x13460, 0x143fa),
    (0x16100, 0x1611d), (0x16d40, 0x16d6c), (0x18cff, 0x18cff),
    (0x1e5d0, 0x1e5ed), (0x1e5f0, 0x1e5f0), (0x2ebf0, 0x2ee5d),
)
_CRATE_NOT_LETTER = ()
_CRATE_NUMBER = (
    (0x10d40, 0x10d49), (0x116d0, 0x116e3), (0x11bf0, 0x11bf9),
    (0x16130, 0x16139), (0x16d70, 0x16d79), (0x1ccf0, 0x1ccf9),
    (0x1e5f1, 0x1e5fa),
)
_CRATE_NOT_NUMBER = ()
_CRATE_SPACE = ()
_CRATE_NOT_SPACE = ()

OTHER, LETTER, NUMBER, SPACE = range(4)
# Unicode's White_Space property
_WHITE_SPACE = frozenset((
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
    *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000))


def _expand(runs) -> frozenset:
    return frozenset(c for lo, hi in runs for c in range(lo, hi + 1))


_FORCE = {}
for _cls, _runs in ((LETTER, _CRATE_LETTER), (NUMBER, _CRATE_NUMBER),
                    (SPACE, _CRATE_SPACE)):
    _FORCE.update(dict.fromkeys(_expand(_runs), _cls))
_NOT = {LETTER: _expand(_CRATE_NOT_LETTER), NUMBER: _expand(_CRATE_NOT_NUMBER),
        SPACE: _expand(_CRATE_NOT_SPACE)}


def char_class(ch: str) -> int:
    """OTHER, LETTER, NUMBER or SPACE, as the crate's split sees ``ch``."""
    cp = ord(ch)
    forced = _FORCE.get(cp)
    if forced is not None:
        return forced
    if cp in _WHITE_SPACE and cp not in _NOT[SPACE]:
        return SPACE
    cat = unicodedata.category(ch)[0]
    if cat == "L" and cp not in _NOT[LETTER]:
        return LETTER
    if cat == "N" and cp not in _NOT[NUMBER]:
        return NUMBER
    return OTHER


def _space_chars() -> List[str]:
    """Every character the crate's ``\\s`` matches."""
    chars = (set(_WHITE_SPACE) | _expand(_CRATE_SPACE)) - _NOT[SPACE]
    return [chr(c) for c in sorted(chars)]


#: BLOOM's Split pattern as its tokenizer.json writes it (Oniguruma: the
#: nested class is part of the outer one), and the same in Python's re
BLOOM_SPLIT = " ?[^(\\s|[.,!?…。，、।۔،])]+"
_BLOOM_SPLIT = re.compile(" ?[^" + re.escape("(|.,!?…。，、।۔،)")
                          + "".join(map(re.escape, _space_chars())) + "]+")


def bloom_split(text: str) -> List[str]:
    """BLOOM's ``Split`` pre-tokenizer (behavior ``Isolated``): each match
    of ``BLOOM_SPLIT`` and each stretch between two matches, in order."""
    out: List[str] = []
    pos = 0
    for m in _BLOOM_SPLIT.finditer(text):
        if m.start() > pos:
            out.append(text[pos:m.start()])
        out.append(m.group())
        pos = m.end()
    if pos < len(text):
        out.append(text[pos:])
    return out


_CLASS: Dict[str, int] = {}
# an ASCII text: the same split with the ASCII classes, through re
_SP = "\\t\\n\\x0b\\x0c\\r "
_ASCII_SPLIT = re.compile(
    "'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+"
    f"| ?[^{_SP}A-Za-z0-9]+|[{_SP}]+(?![^{_SP}])|[{_SP}]+")


def pre_tokenize(text: str) -> List[str]:
    """GPT-2's split of ``text`` into words."""
    if text.isascii():
        return _ASCII_SPLIT.findall(text)
    return pre_tokenize_any(text)


def pre_tokenize_any(text: str) -> List[str]:
    """The split by the scanner, on any text."""
    cls = []
    for ch in text:
        k = _CLASS.get(ch)
        if k is None:
            k = _CLASS[ch] = char_class(ch)
        cls.append(k)
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "'" and i + 1 < n:
            if text[i + 1] in "stmd":
                out.append(text[i:i + 2])
                i += 2
                continue
            if text[i + 1:i + 3] in ("re", "ve", "ll"):
                out.append(text[i:i + 3])
                i += 3
                continue
        start, k = i, cls[i]
        if ch == " " and i + 1 < n and cls[i + 1] != SPACE:
            i += 1                                 # ' ?' then a run
            k = cls[i]
        if k != SPACE:
            j = i + 1
            while j < n and cls[j] == k:
                j += 1
            out.append(text[start:j])
            i = j
            continue
        j = i + 1
        while j < n and cls[j] == SPACE:
            j += 1
        # \s+(?!\S) keeps the last space for the next word; \s+ takes one
        end = j if j == n or j - i == 1 else j - 1
        out.append(text[i:end])
        i = end
    return out


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_TABLE = bytes_to_unicode()


def merge_ids(ids: List[int], merges: Dict[Tuple[int, int], Tuple[int, int]]
              ) -> Tuple[int, ...]:
    """The crate's ``Word::merge_all`` on a word's symbol ids: the pair of
    lowest rank first and, among equal ranks, the leftmost; ``merges``
    maps a pair of ids to (rank, merged id)."""
    ids = list(ids)
    n = len(ids)
    nxt, prv, alive = list(range(1, n + 1)), list(range(-1, n - 1)), [True] * n
    heap = []
    for i in range(n - 1):
        m = merges.get((ids[i], ids[i + 1]))
        if m is not None:
            heap.append((m[0], i, m[1]))
    heapq.heapify(heap)
    while heap:
        _, pos, new_id = heapq.heappop(heap)
        if not alive[pos] or nxt[pos] >= n:
            continue
        right = nxt[pos]
        m = merges.get((ids[pos], ids[right]))
        if m is None or m[1] != new_id:
            continue                       # an entry the merges outdated
        ids[pos] = new_id
        alive[right] = False
        nxt[pos] = nxt[right]
        if nxt[pos] < n:
            prv[nxt[pos]] = pos
        if prv[pos] >= 0:
            m = merges.get((ids[prv[pos]], new_id))
            if m is not None:
                heapq.heappush(heap, (m[0], prv[pos], m[1]))
        if nxt[pos] < n:
            m = merges.get((new_id, ids[nxt[pos]]))
            if m is not None:
                heapq.heappush(heap, (m[0], pos, m[1]))
    return tuple(t for t, a in zip(ids, alive) if a)


class ByteLevelBPETokenizer(TemplateTokenizer):
    """``RobertaTokenizerFast`` (or GPT-2's, BLOOM's class) on its own:
    ``__call__`` returns numpy ``input_ids`` and ``attention_mask`` [B, L]
    int64.  ``split``: the pre-tokenizer's split of a piece into words
    (GPT-2's ``pre_tokenize``, or BLOOM's ``bloom_split``)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], *,
                 added, cls_id: Optional[int], sep_id: Optional[int], pad_id: Optional[int],
                 add_prefix_space: bool = False, suffix: Optional[Sequence[int]] = None,
                 prefix: Optional[Sequence[int]] = None, padding_side: str = "right",
                 truncation_side: str = "right", split=None):
        super().__init__(added, cls_id=cls_id, sep_id=sep_id, pad_id=pad_id,
                         suffix=suffix, prefix=prefix, padding_side=padding_side,
                         truncation_side=truncation_side)
        self.split = pre_tokenize if split is None else split
        self.vocab = dict(vocab)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise ValueError(f"the merge {a!r} {b!r} is not in the vocabulary")
            # a pair given twice takes its last rank, as the crate's map does
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.add_prefix_space = add_prefix_space
        self._words: Dict[str, Tuple[int, ...]] = {}

    @classmethod
    def from_pretrained(cls, path, family: str = "roberta") -> "ByteLevelBPETokenizer":
        """``family`` "roberta" (RoBERTa's and BART's class), "blenderbot",
        "gpt2" (GPT-2's class, which GPT-Neo's and GPT-J's checkpoints
        take) or "bloom"."""
        path = checkpoint_dir(path)
        cfg = read_tokenizer_config(path)
        specials = {"gpt2": GPT2_SPECIALS, "bloom": BLOOM_SPECIALS}.get(family)
        suffix = prefix = split = None
        gpt = family in ("gpt2", "bloom")
        if (path / "tokenizer.json").exists():
            tj = read_json(path / "tokenizer.json")
            model, pre = tj.get("model") or {}, tj.get("pre_tokenizer") or {}
            if family == "bloom":
                pre, split = cls._bloom_pre_tokenizer(pre, f"{path}/tokenizer.json")
            if model.get("type") != "BPE" or pre.get("type") != "ByteLevel" \
                    or tj.get("normalizer"):
                raise ValueError(
                    f"{path}/tokenizer.json is not a byte-level BPE tokenizer "
                    f"(model {model.get('type')}, pre-tokenizer {pre.get('type')}, "
                    f"normalizer {(tj.get('normalizer') or {}).get('type')})")
            # RoBERTa's and GPT-2's converters set none of these
            for where, key, ok in (
                    (model, "dropout", None), (model, "unk_token", None),
                    (model, "continuing_subword_prefix", ""),
                    (model, "end_of_word_suffix", ""), (model, "byte_fallback", False),
                    (model, "ignore_merges", False),
                    (pre, "use_regex", family != "bloom")):
                if where.get(key) not in (None, ok):
                    raise ValueError(f"{path}/tokenizer.json: {key} "
                                     f"{where.get(key)!r} is not supported")
            vocab = model["vocab"]
            merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                      for m in model.get("merges", [])]
            added = added_tokens(tj.get("added_tokens", []), cfg, vocab, specials)
            post = tj.get("post_processor") or {}
            if gpt:
                # GPT-2's converter writes a ByteLevel post-processor (no
                # special tokens) or, with add_bos_token, <|endoftext|> $A
                prefix, suffix = (([], []) if post.get("type") in (None, "ByteLevel")
                                  else affix_template(post))
            elif family == "blenderbot" and post.get("type") == "TemplateProcessing":
                suffix = suffix_template(post)
            cls_id, sep_id = (None, None) if suffix is not None else roberta_template(post)
            # the class's add_prefix_space replaces a top-level ByteLevel's;
            # BLOOM's class keeps its Sequence's unless it is set
            add_prefix_space = bool(cfg.get("add_prefix_space", False)) or (
                family == "bloom" and bool(pre.get("add_prefix_space")))
        else:
            if family == "bloom":
                raise FileNotFoundError(f"{path} has no tokenizer.json, which "
                                        "BloomTokenizerFast needs")
            if not (path / "vocab.json").exists() or not (path / "merges.txt").exists():
                raise FileNotFoundError(
                    f"{path} has neither tokenizer.json nor vocab.json + merges.txt")
            vocab = read_json(path / "vocab.json")
            lines = (path / "merges.txt").read_text(encoding="utf-8").split("\n")[1:-1]
            # the slow tokenizer's bpe_ranks: each pair once, where it first stands
            merges = list(dict.fromkeys(tuple(line.split()) for line in lines))
            added = added_tokens([], cfg, vocab, specials)
            cls_id, sep_id = (None, None) if gpt else (
                special_id(cfg, n, added) for n in ("cls_token", "sep_token"))
            if family == "blenderbot":
                # BlenderbotConverter's template
                suffix = [special_id(cfg, "eos_token", added)]
            elif gpt:
                # GPT2Converter's: <|endoftext|> $A with add_bos_token
                suffix = []
                prefix = ([special_id(cfg, "bos_token", added, specials)]
                          if cfg.get("add_bos_token") else [])
            add_prefix_space = bool(cfg.get("add_prefix_space", False))
        if family == "bloom" and add_prefix_space:
            raise ValueError(f"{path}: add_prefix_space true is not supported for BLOOM's "
                             "tokenizer (its class rewrites the pickled pre-tokenizer)")
        return cls(vocab, merges, added=added, cls_id=cls_id, sep_id=sep_id,
                   pad_id=special_id(cfg, "pad_token", added, specials),
                   add_prefix_space=add_prefix_space, suffix=suffix, prefix=prefix,
                   padding_side=cfg.get("padding_side", "right"),
                   truncation_side=cfg.get("truncation_side", "right"), split=split)

    @staticmethod
    def _bloom_pre_tokenizer(pre: dict, where: str):
        """BLOOM's ``Sequence`` of ``Split`` (``BLOOM_SPLIT``, Isolated)
        and ``ByteLevel`` without its regex: that ``ByteLevel`` and
        ``bloom_split``; any other form raises."""
        steps = pre.get("pretokenizers") or []
        split = steps[0] if len(steps) == 2 else {}
        if (pre.get("type") != "Sequence" or split.get("type") != "Split"
                or split.get("pattern") != {"Regex": BLOOM_SPLIT}
                or split.get("behavior") != "Isolated" or split.get("invert")):
            raise ValueError(f"{where}: the pre-tokenizer is not BLOOM's Split then "
                             f"ByteLevel: {json.dumps(pre)[:200]}")
        return steps[1], bloom_split

    def _merge(self, word: str) -> Tuple[int, ...]:
        """The crate's ``merge_word`` + ``merge_all`` on one mapped word."""
        # a character outside the vocabulary is dropped (no unk token)
        return merge_ids([self.vocab[ch] for ch in word if ch in self.vocab], self.merges)

    def encode_piece(self, text: str, first: bool) -> List[int]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        out: List[int] = []
        for word in self.split(text):
            ids = self._words.get(word)
            if ids is None:
                mapped = "".join(_BYTE_TABLE[b] for b in word.encode("utf-8"))
                ids = self._merge(mapped)
                if len(self._words) >= 1 << 18:
                    self._words.clear()
                self._words[word] = ids
            out.extend(ids)
        return out


__all__ = ["BLOOM_SPLIT", "ByteLevelBPETokenizer", "bloom_split", "bytes_to_unicode",
           "char_class", "merge_ids", "pre_tokenize", "pre_tokenize_any"]
