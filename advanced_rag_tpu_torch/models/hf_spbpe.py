"""The SentencePiece-style BPE tokenizer of the Llama, Mistral and Gemma
checkpoints (and of a BigBird checkpoint whose SentencePiece model is a
BPE one), read from a local ``tokenizer.json``.

The port's copy of what ``LlamaTokenizerFast``, ``GemmaTokenizerFast`` and
``BigBirdTokenizerFast`` (the ``tokenizers`` crate) do, so the card's
machine needs neither ``transformers`` nor ``tokenizers``:

1. added tokens (``<s>``, ``</s>``, ``<unk>``, ``<bos>``, ``<pad>`` and
   any other) are found in the raw text first, leftmost-longest; a
   ``normalized`` added token is found in the normalized pieces, as its
   content normalizes (``TemplateTokenizer.encode``);
2. the normalizer on each piece between them (``hf_unigram.Normalizer``):
   the legacy Llama layout's ``Prepend("▁")`` (on a non-empty piece) +
   ``Replace(" ", "▁")``, Gemma's ``Replace`` alone;
3. the pre-tokenizer: none (the whole piece is one word) or ``Metaspace``
   (``replacement``, ``prepend_scheme`` first / always / never,
   ``split``), the newer Llama layout;
4. BPE with the crate's ``merge_word``: each character its vocabulary id;
   one outside the vocabulary becomes its UTF-8 bytes' ``<0xXX>`` pieces
   (``byte_fallback``), else ``unk_token`` (runs of unknowns fused into
   one with ``fuse_unk``), else nothing; then ``hf_bpe.merge_ids``, the
   crate's merge order.  Without a splitting pre-tokenizer the crate
   merges a whole piece as one word; where no merge joins a character to
   a ``▁`` after it (SentencePiece's own vocabularies split by
   whitespace), no token crosses such a boundary, so the port merges the
   words between them apart and memoizes each (``split_words``), the
   same ids for less work;
5. the template that ``update_post_processor`` builds from
   ``tokenizer_config.json``'s ``add_bos_token`` (default true) and
   ``add_eos_token`` (default false): ``[bos] A [eos]``, in place of the
   post-processor in ``tokenizer.json`` (``TemplateTokenizer``'s prefix
   and suffix); truncation on ``truncation_side`` (default right) and
   padding to ``max_length`` on ``padding_side`` (default left, the
   classes' own).  BigBird's class
   instead takes its ``tokenizer.json``'s ``[CLS] A [SEP] B [SEP]``
   (``TemplateTokenizer``: pairs, right padding, no token types), with
   BigBird's converter's normalizer (``Precompiled``, ``Strip``, Replace
   " {2,}") and ``Metaspace``.

It refuses, with ``ValueError`` naming it: BPE ``dropout``,
``ignore_merges``, a word prefix or suffix, a ``ByteLevel`` or ``Split``
pre-tokenizer (Llama-3's layout), ``add_prefix_space``
in ``tokenizer_config.json`` (transformers then rebuilds the tokenizer
from the SentencePiece ``.model`` file, which needs ``sentencepiece``),
and a ``tokenizer.model`` without ``tokenizer.json``.  A checkpoint with no
pad token (Llama's and Mistral's ship none) gets ``pad_id`` None; the
embedder refuses it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from .hf_bpe import merge_ids
from .hf_checkpoint import checkpoint_dir, read_json
from .hf_tokenizer import (BIG_BIRD_SPECIALS, TemplateTokenizer, _added_pattern,
                           _token_content, added_tokens, bert_template,
                           read_tokenizer_config)
from .hf_unigram import Normalizer, metaspace

#: a token that crosses a word boundary: a character, then "▁"
_CROSSES = re.compile("[^▁]▁")
#: the words between such boundaries: a run of "▁" and what follows it
_WORDS = re.compile("▁+[^▁]*|[^▁]+")

#: each class's default special tokens (``LlamaTokenizerFast`` also serves
#: Mistral's checkpoints)
CLASS_SPECIALS = {
    "llama": dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>"),
    "gemma": dict(bos_token="<bos>", eos_token="<eos>", unk_token="<unk>",
                  pad_token="<pad>"),
    "big_bird": BIG_BIRD_SPECIALS,
}


class SentencePieceBPETokenizer(TemplateTokenizer):
    """``LlamaTokenizerFast`` / ``GemmaTokenizerFast`` on their own:
    ``__call__`` returns numpy ``input_ids`` and ``attention_mask`` [B, L]
    int64."""

    def __init__(self, vocab: Dict[str, int], merges, *, added, bos_id: Optional[int],
                 eos_id: Optional[int], pad_id: Optional[int],
                 unk_token: Optional[str] = None, byte_fallback: bool = False,
                 fuse_unk: bool = False, normalizer: Optional[dict] = None,
                 pre_tokenizer: Optional[dict] = None, padding_side: str = "left",
                 truncation_side: str = "right", where: str = "tokenizer.json",
                 pair_template: bool = False):
        sides = dict(padding_side=padding_side, truncation_side=truncation_side)
        if pair_template:        # BigBird's [CLS] A [SEP] B [SEP]
            super().__init__(added, cls_id=bos_id, sep_id=eos_id, pad_id=pad_id,
                             pair_seps=1, **sides)
        else:                    # [bos] A [eos], single texts
            super().__init__(added, cls_id=None, sep_id=None, pad_id=pad_id,
                             prefix=[] if bos_id is None else [bos_id],
                             suffix=[] if eos_id is None else [eos_id], **sides)
        self.vocab = dict(vocab)
        self.merges = {}
        for rank, (a, b) in enumerate(merges):
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise ValueError(f"{where}: the merge {a!r} {b!r} is not in the vocabulary")
            # a pair given twice takes its last rank, as the crate's map does
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        if unk_token is not None and unk_token not in self.vocab:
            raise ValueError(f"{where}: unk_token {unk_token!r} is not in the vocabulary")
        self.unk_id = None if unk_token is None else self.vocab[unk_token]
        self.fuse_unk = fuse_unk
        self.bytes = ([self.vocab.get(f"<0x{b:02X}>") for b in range(256)]
                      if byte_fallback else None)
        self.normalizer = Normalizer(normalizer)
        pre = pre_tokenizer or {}
        if pre and pre.get("type") != "Metaspace":
            raise ValueError(f"{where}: the pre-tokenizer {pre.get('type')} is not "
                             "supported (supported: none, Metaspace)")
        if pre and "prepend_scheme" not in pre and pre.get("add_prefix_space") is False:
            # the older form; the crate reads only add_prefix_space true
            raise ValueError(f"{where}: Metaspace add_prefix_space false is not supported")
        self.metaspace = (pre.get("replacement", "▁"), pre.get("prepend_scheme", "always"),
                          bool(pre.get("split", True))) if pre else None
        if self.metaspace and self.metaspace[1] not in ("always", "first", "never"):
            raise ValueError(f"{where}: prepend_scheme {self.metaspace[1]!r} is not supported")
        # no merge joins a character to a following "▁", so none crosses
        # there: the words between merge alone (unknowns fuse only within
        # a word, "▁" being known)
        self.split_words = ("▁" in self.vocab
                            and (self.metaspace is None or self.metaspace[0] == "▁")
                            and not any(_CROSSES.search(a + b) for a, b in merges))
        # the crate finds a normalized added token as its content normalizes
        normed = [t for t in self.added if t.normalized]
        self._by_content.update({self.normalize(t.content): t for t in normed})
        self._norm_re = _added_pattern([type(t)(self.normalize(t.content), t.id)
                                        for t in normed])
        self._words: Dict[str, tuple] = {}

    @classmethod
    def from_pretrained(cls, path, family: str = "llama") -> "SentencePieceBPETokenizer":
        path = checkpoint_dir(path)
        if not (path / "tokenizer.json").exists():
            if (path / "tokenizer.model").exists():
                raise ValueError(
                    f"{path} holds tokenizer.model and no tokenizer.json: the port "
                    "reads tokenizer.json (transformers converts the .model file only "
                    "where sentencepiece is installed)")
            raise FileNotFoundError(f"{path} has no tokenizer.json")
        cfg = read_tokenizer_config(path)
        where = f"{path}/tokenizer.json"
        if cfg.get("add_prefix_space") is not None:
            raise ValueError(
                f"{path}/tokenizer_config.json: add_prefix_space is not supported "
                "(transformers then converts the tokenizer from tokenizer.model, "
                "which needs sentencepiece)")
        tj = read_json(path / "tokenizer.json")
        model = tj.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"{where}: model {model.get('type')} is not BPE")
        for key, ok in (("dropout", (None, 0, 0.0)), ("ignore_merges", (None, False)),
                        ("continuing_subword_prefix", (None, "")),
                        ("end_of_word_suffix", (None, ""))):
            if model.get(key) not in ok:
                raise ValueError(f"{where}: BPE {key} {model.get(key)!r} is not supported")
        vocab = model["vocab"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        specials = CLASS_SPECIALS[family]
        added = added_tokens(tj.get("added_tokens", []), cfg, vocab, specials,
                             lstrip_mask=family == "big_bird")

        def token_id(name: str) -> Optional[int]:
            content = _token_content(cfg.get(name, specials.get(name)))
            if content is None:
                return None
            return next(t.id for t in added if t.content == content)

        common = dict(unk_token=model.get("unk_token"),
                      byte_fallback=bool(model.get("byte_fallback", False)),
                      fuse_unk=bool(model.get("fuse_unk", False)),
                      normalizer=tj.get("normalizer"), pre_tokenizer=tj.get("pre_tokenizer"),
                      where=where)
        if family == "big_bird":
            cls_id, sep_id = bert_template(tj.get("post_processor") or {})
            return cls(vocab, merges, added=added, bos_id=cls_id, eos_id=sep_id,
                       pad_id=token_id("pad_token"), padding_side="right",
                       pair_template=True, **common)
        bos_id, eos_id = token_id("bos_token"), token_id("eos_token")
        add_bos = bool(cfg.get("add_bos_token", True))
        add_eos = bool(cfg.get("add_eos_token", False))
        for name, want, tid in (("bos_token", add_bos, bos_id), ("eos_token", add_eos, eos_id)):
            if want and tid is None:
                raise ValueError(f"{path}: add_{name} is true but {name} is None")
        return cls(vocab, merges, added=added, bos_id=bos_id if add_bos else None,
                   eos_id=eos_id if add_eos else None, pad_id=token_id("pad_token"),
                   padding_side=cfg.get("padding_side", "left"),
                   truncation_side=cfg.get("truncation_side", "right"), **common)

    def normalize(self, text: str) -> str:
        return self.normalizer(text)

    def _symbols(self, word: str) -> List[int]:
        """The crate's ``merge_word`` before the merges: each character's
        id, its bytes' pieces, or unk (fused with ``fuse_unk``)."""
        out: List[int] = []
        unk = None                       # a pending unk: (id, fused)
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(tid)
                continue
            if self.bytes is not None:
                ids = [self.bytes[b] for b in ch.encode("utf-8")]
                if None not in ids:
                    # the crate adds them and leaves a pending unk pending
                    out.extend(ids)
                    continue
            if self.unk_id is not None:
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = self.unk_id
        if unk is not None:
            out.append(unk)
        return out

    def encode_piece(self, text: str, first: bool) -> List[int]:
        words = ([text] if self.metaspace is None else
                 metaspace(text, *self.metaspace, first=first))
        if self.split_words:
            words = [w for word in words for w in _WORDS.findall(word)]
        out: List[int] = []
        for word in words:
            ids = self._words.get(word)
            if ids is None:
                ids = merge_ids(self._symbols(word), self.merges)
                if len(self._words) >= 1 << 18:
                    self._words.clear()
                self._words[word] = ids
            out.extend(ids)
        return out


__all__ = ["CLASS_SPECIALS", "SentencePieceBPETokenizer"]
