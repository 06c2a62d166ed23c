"""BlenderbotSmall's tokenizer read from a local HF checkpoint.

``AutoTokenizer`` has no fast class for ``blenderbot-small``: it loads
transformers' pure-Python ``BlenderbotSmallTokenizer``.  This is the
port's copy of what that class and ``PreTrainedTokenizer`` do, so the
card's machine needs no ``transformers``:

1. added tokens (``__start__``, ``__end__``, ``__unk__``, ``__null__`` and
   ``tokenizer_config.json``'s ``added_tokens_decoder``) are cut out of
   the raw text, leftmost-longest; a token with ``lstrip`` / ``rstrip``
   strips the whitespace (``str.strip``'s) of the piece before / after it;
   a special token absent from ``vocab.json`` takes the next id past the
   vocabulary, as ``_add_tokens`` gives it;
2. each other piece is cut into ``\\S+\\n?`` words; in each word a space
   goes before ``. , ! ? ( )``, around ``'``, runs of whitespace become
   one space and a newline becomes `` __newln__``; each part, lowercased,
   is merged by BPE (``merges.txt`` ranks, ``</w>`` on the last symbol)
   and written with ``@@`` continuations;
3. each subword maps to its added token's id, else to ``vocab.json``'s id
   of its lowercase form, else to the unknown token's;
4. no special tokens around the text (the class keeps
   ``build_inputs_with_special_tokens``' default), truncation to
   ``max_length`` and right padding with ``__null__``.

``__call__`` returns numpy ``input_ids`` and ``attention_mask`` [B, L]
int64, as the class does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

from .hf_checkpoint import checkpoint_dir, read_json
from .hf_tokenizer import (AddedToken, TemplateTokenizer, _added_pattern, _token_content,
                           read_tokenizer_config)

#: the class's special tokens where the config names none
SPECIALS = dict(bos_token="__start__", eos_token="__end__", unk_token="__unk__",
                pad_token="__null__")
_WORDS = re.compile(r"\S+\n?")
_PUNCT = re.compile("([.,!?()])")
_QUOTE = re.compile("(')")
_SPACES = re.compile(r"\s{2,}")


def slow_added_tokens(cfg: dict, vocab: Dict[str, int]) -> List[AddedToken]:
    """The added vocabulary ``PreTrainedTokenizer.__init__`` leaves:
    ``added_tokens_decoder`` with its flags, then the special tokens (no
    strip, not normalized) at their vocabulary ids or past it."""
    out: Dict[str, AddedToken] = {}
    for tid, t in sorted((cfg.get("added_tokens_decoder") or {}).items(),
                         key=lambda kv: int(kv[0])):
        if t.get("single_word"):
            raise ValueError(f"the added token {t['content']!r} is single_word, "
                             "which the port does not support")
        out[t["content"]] = AddedToken(t["content"], int(tid), lstrip=bool(t.get("lstrip")),
                                       rstrip=bool(t.get("rstrip")), normalized=False)
    size = len({**vocab, **{c: t.id for c, t in out.items()}})
    names = [f"{k}_token" for k in ("bos", "eos", "unk", "sep", "pad", "cls", "mask")]
    for name in names + ["additional_special_tokens"]:
        toks = cfg.get(name, SPECIALS.get(name))
        for tok in (toks if isinstance(toks, list) else [toks]):
            content = _token_content(tok)
            if content is None or content in out:
                continue
            tid = vocab.get(content)
            if tid is None:
                tid, size = size, size + 1
            out[content] = AddedToken(content, tid, lstrip=False, rstrip=False,
                                      normalized=False)
    return list(out.values())


class BlenderbotSmallTokenizer(TemplateTokenizer):
    """``BlenderbotSmallTokenizer`` on its own."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], *,
                 added: Sequence[AddedToken], unk_id: int, pad_id: int):
        super().__init__(added, cls_id=None, sep_id=None, pad_id=pad_id, suffix=[])
        self.vocab = dict(vocab)
        # a pair given twice takes its last rank, as the class's dict does
        self.ranks = {pair: rank for rank, pair in enumerate(merges)}
        self.unk_id = unk_id
        self._pattern = _added_pattern(self.added)
        self._words: Dict[str, Tuple[int, ...]] = {}

    @classmethod
    def from_pretrained(cls, path) -> "BlenderbotSmallTokenizer":
        path = checkpoint_dir(path)
        if not (path / "vocab.json").exists() or not (path / "merges.txt").exists():
            raise FileNotFoundError(f"{path} has no vocab.json + merges.txt")
        cfg = read_tokenizer_config(path)
        vocab = read_json(path / "vocab.json")
        lines = (path / "merges.txt").read_text(encoding="utf-8").split("\n")[1:-1]
        added = slow_added_tokens(cfg, vocab)
        unk = _token_content(cfg.get("unk_token", SPECIALS["unk_token"]))
        if unk not in vocab:
            raise ValueError(f"{path}: the unknown token {unk!r} is not in vocab.json")
        pad = _token_content(cfg.get("pad_token", SPECIALS["pad_token"]))
        return cls(vocab, [tuple(line.split()) for line in lines], added=added,
                   unk_id=vocab[unk], pad_id=next(t.id for t in added if t.content == pad))

    def _bpe(self, word: str) -> List[str]:
        """One lowercased part as its subwords (``@@`` on all but the last)."""
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = {(a, b) for a, b in zip(symbols, symbols[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(symbols):
                if i < len(symbols) - 1 and (symbols[i], symbols[i + 1]) == best:
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        return [s + "@@" for s in symbols[:-1]] + [symbols[-1][:-4]]

    def _word_ids(self, word: str) -> Tuple[int, ...]:
        text = _SPACES.sub(" ", _QUOTE.sub(r" \1 ", _PUNCT.sub(r" \1", word)))
        text = text.replace("\n", " __newln__")
        ids: List[int] = []
        for part in text.split(" "):
            if not part:
                continue
            part = part.lower()
            # a single character is its own token, "</w>" never added
            for sub in (self._bpe(part) if len(part) > 1 else [part]):
                tid = self._by_content.get(sub)
                ids.append(tid.id if tid is not None
                           else self.vocab.get(sub.lower(), self.unk_id))
        return tuple(ids)

    def encode(self, text: str) -> List[int]:
        pieces: List[object] = []
        pos = 0
        for m in self._pattern.finditer(text) if self._pattern is not None else ():
            if m.start() > pos:
                pieces.append(text[pos:m.start()])
            pieces.append(self._by_content[m.group()])
            pos = m.end()
        if pos < len(text):
            pieces.append(text[pos:])
        for i, piece in enumerate(pieces):
            if isinstance(piece, AddedToken):
                if piece.rstrip and i + 1 < len(pieces) and isinstance(pieces[i + 1], str):
                    pieces[i + 1] = pieces[i + 1].lstrip()
                if piece.lstrip and i > 0 and isinstance(pieces[i - 1], str):
                    pieces[i - 1] = pieces[i - 1].rstrip()
        out: List[int] = []
        for piece in pieces:
            if isinstance(piece, AddedToken):
                out.append(piece.id)
                continue
            for word in _WORDS.findall(piece):
                ids = self._words.get(word)
                if ids is None:
                    ids = self._word_ids(word)
                    if len(self._words) >= 1 << 18:
                        self._words.clear()
                    self._words[word] = ids
                out.extend(ids)
        return out


__all__ = ["BlenderbotSmallTokenizer", "slow_added_tokens"]
