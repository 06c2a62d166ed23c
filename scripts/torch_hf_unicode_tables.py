"""Print the Unicode tables of the port's HF tokenizers
(``advanced_rag_tpu_torch/models/hf_tokenizer.py``, ``hf_bpe.py``,
``hf_unigram.py``).

The ``tokenizers`` crate classifies characters with its own Unicode
tables, which are older than Python's ``unicodedata`` in some places
(categories) and newer in others (Rust's lowercase mapping, Oniguruma's
letters and numbers, the grapheme clusters of ``unicode-segmentation``).
This script finds, over every code point, where the port's rules built on
``unicodedata`` and the crate disagree, and prints the code points where
the crate's answer has to be taken instead, as the ``_CRATE_*`` literals
that the modules carry:

- ``hf_tokenizer.py``: the BERT normalizer and pre-tokenizer;
- ``hf_bpe.py``: ``\\p{L}``, ``\\p{N}`` and ``\\s`` of GPT-2's split;
- ``hf_unigram.py``: the grapheme cluster classes that ``Precompiled``
  normalizes by, probed through ``Precompiled`` itself; what ALBERT's
  ``NFKD`` leaves whole or takes as a starter, and the marks its
  ``StripAccents`` drops.

It needs ``tokenizers`` (installed beside ``transformers``), so it runs on
a machine with the JAX package's dependencies, never on the card's:

    python scripts/torch_hf_unicode_tables.py

``tests/test_torch_hf_tokenizer.py::test_every_code_point_matches_the_crate``,
``tests/test_torch_hf_bpe.py``, ``tests/test_torch_hf_unigram.py`` and
``tests/test_torch_hf_albert_tokenizer.py`` hold the tables against the
crate.
"""

from __future__ import annotations

import sys
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tokenizers import Regex, normalizers, pre_tokenizers  # noqa: E402

CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


def ranges(cps: Iterable[int]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for c in sorted(cps):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [(lo, hi) for lo, hi in out]


def shift_runs(mapping: Dict[int, int]) -> List[Tuple[int, int, int]]:
    """(lo, hi, delta) runs of consecutive code points sharing a delta."""
    out: List[List[int]] = []
    for c in sorted(mapping):
        d = mapping[c] - c
        if out and out[-1][1] == c - 1 and out[-1][2] == d:
            out[-1][1] = c
        else:
            out.append([c, c, d])
    return [tuple(r) for r in out]


def crate_tables() -> Dict[str, object]:
    def norm(**flags):
        return normalizers.BertNormalizer(
            **{"clean_text": False, "handle_chinese_chars": False,
               "strip_accents": False, "lowercase": False, **flags})

    clean, strip, lower = (norm(clean_text=True), norm(strip_accents=True),
                           norm(lowercase=True))
    pre = pre_tokenizers.BertPreTokenizer()
    nfd = normalizers.NFD()
    control, mn, punct, low, nfd_whole = set(), set(), set(), {}, set()
    for c in CODE_POINTS:
        ch = chr(c)
        if clean.normalize_str(ch) == "" and ch not in " \t\n\r":
            control.add(c)
        if strip.normalize_str(ch) == "":
            mn.add(c)
        lo = lower.normalize_str(ch)
        if len(lo) == 1 and lo != ch.lower():
            low[c] = ord(lo)
        elif len(lo) != 1 and lo != ch.lower():
            raise SystemExit(f"U+{c:04X}: lowercase {lo!r} is not one character")
        crate_nfd, py_nfd = nfd.normalize_str(ch), unicodedata.normalize("NFD", ch)
        if crate_nfd != py_nfd:
            if crate_nfd != ch or unicodedata.combining(ch):
                raise SystemExit(f"U+{c:04X}: NFD {crate_nfd!r} against {py_nfd!r}")
            nfd_whole.add(c)
        words = [w for w, _ in pre.pre_tokenize_str(f"x{ch}y")]
        if words == ["x", ch, "y"]:
            punct.add(c)
    py_control = {c for c in CODE_POINTS
                  if unicodedata.category(chr(c)) in ("Cc", "Cf", "Co", "Cs")
                  and chr(c) not in "\t\n\r"}
    # the port strips after NFD, so a character that decomposes is judged
    # by its pieces: the tables hold characters the crate's NFD leaves alone
    whole = [c for c in CODE_POINTS
             if unicodedata.normalize("NFD", chr(c)) == chr(c) or c in nfd_whole]
    mn &= set(whole)
    py_mn = {c for c in whole if unicodedata.category(chr(c)) == "Mn"}
    py_punct = {c for c in CODE_POINTS
                if unicodedata.category(chr(c)).startswith("P")
                or 33 <= c <= 47 or 58 <= c <= 64 or 91 <= c <= 96
                or 123 <= c <= 126}
    if control - py_control - {0xFFFD}:
        raise SystemExit("the crate drops characters unicodedata does not "
                         f"call control: {ranges(control - py_control)}")
    return {
        "_CRATE_NOT_CONTROL": ranges(py_control - control),
        "_CRATE_MN": ranges(mn - py_mn),
        "_CRATE_NOT_MN": ranges(py_mn - mn),
        "_CRATE_PUNCT": ranges(punct - py_punct),
        "_CRATE_NOT_PUNCT": ranges(py_punct - punct),
        "_CRATE_LOWER": shift_runs(low),
        # starters (combining class 0) NFD decomposes and the crate does not
        "_CRATE_NFD_WHOLE": ranges(nfd_whole),
    }


#: Unicode's White_Space property, the port's base for \s
WHITE_SPACE = {0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
               *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000}


def crate_class(cls: str) -> set:
    """The code points the crate's Oniguruma puts in ``[cls]``."""
    split = pre_tokenizers.Split(Regex(f"[^{cls}]+"), behavior="removed")
    out = set()
    for _, (a, b) in split.pre_tokenize_str("".join(map(chr, CODE_POINTS))):
        out.update(CODE_POINTS[a:b])
    return out


def bpe_tables() -> Dict[str, object]:
    """The classes of GPT-2's split against unicodedata's."""
    py = {"LETTER": {c for c in CODE_POINTS if unicodedata.category(chr(c))[0] == "L"},
          "NUMBER": {c for c in CODE_POINTS if unicodedata.category(chr(c))[0] == "N"},
          "SPACE": WHITE_SPACE}
    out = {}
    for name, cls in (("LETTER", r"\p{L}"), ("NUMBER", r"\p{N}"), ("SPACE", r"\s")):
        crate = crate_class(cls)
        out[f"_CRATE_{name}"] = ranges(crate - py[name])
        out[f"_CRATE_NOT_{name}"] = ranges(py[name] - crate)
    return out


def grapheme_tables() -> Dict[str, object]:
    """The grapheme cluster classes the crate's ``Precompiled`` shows,
    against ``hf_unigram.base_class``.  Each probe is one charsmap and one
    text of many short probes, each ended by a line feed (a cluster
    break): a cluster of fewer than 6 bytes whose first character has a
    rule takes that rule whole, so the output says whether the probe's
    characters joined.

    - attach (all code points): ``a`` + c, with a rule for ``a`` only;
    - control (the BMP; c + U+0301 stays under 6 bytes): c + U+0301, with a
      rule for every c;
    - prepend (planes 0-3, where every assigned Prepend lies): c + ``a``,
      with a rule for every c."""
    from advanced_rag_tpu_torch.models.hf_unigram import (ATTACH, CONTROL,
                                                          base_class,
                                                          build_precompiled)

    def probe(rules, cps, fmt):
        text = "".join(fmt(chr(c)) + "\n" for c in cps)
        out = normalizers.Precompiled(build_precompiled(rules)).normalize_str(text)
        res = out.split("\n")[:-1]
        assert len(res) == len(cps)
        return {c for c, r in zip(cps, res) if r == "#"}

    skip = {0x00, 0x0A, 0x0D, 0x61, 0x301}
    every = [c for c in CODE_POINTS if c not in skip]
    bmp = [c for c in every if c <= 0xFFFF]
    planes = [c for c in every if c < 0x40000]
    attach = probe({"a": "#"}, every, lambda ch: "a" + ch)
    joins = probe({chr(c): "#" for c in bmp}, bmp, lambda ch: ch + "\u0301")
    prepend = probe({chr(c): "#" for c in planes}, planes, lambda ch: ch + "a")
    base = {c: base_class(chr(c)) for c in every}
    control = {c for c in bmp if c not in joins}
    return {
        "_CRATE_ATTACH": ranges(c for c in attach if base[c] != ATTACH),
        "_CRATE_NOT_ATTACH": ranges(c for c in every
                                    if base[c] == ATTACH and c not in attach),
        "_CRATE_CONTROL": ranges(c for c in control if base[c] != CONTROL),
        "_CRATE_NOT_CONTROL": ranges(c for c in bmp
                                     if base[c] == CONTROL and c not in control),
        "_CRATE_PREPEND": ranges(prepend),
    }


def normalizer_tables() -> Dict[str, object]:
    """The crate's ``NFKD`` and ``StripAccents`` against unicodedata's:
    the characters NFKD leaves whole (each a starter that unicodedata
    decomposes), the marks of a nonzero combining class in unicodedata
    that the crate takes as starters (neither a class-1 mark after one nor
    a class-240 mark before one moves), and where its combining marks
    (what StripAccents drops) differ from the M categories."""
    nfkd, strip = normalizers.NFKD(), normalizers.StripAccents()
    whole, starter, mark, not_mark = set(), set(), set(), set()
    for c in CODE_POINTS:
        ch = chr(c)
        crate = nfkd.normalize_str(ch)
        if crate != unicodedata.normalize("NFKD", ch):
            if crate != ch or unicodedata.combining(ch):
                raise SystemExit(f"U+{c:04X}: NFKD {crate!r}")
            whole.add(c)
        if unicodedata.combining(ch):
            after, before = "a" + ch + "\u0334", "a\u0345" + ch
            if nfkd.normalize_str(after) == after and nfkd.normalize_str(before) == before:
                starter.add(c)
        dropped = strip.normalize_str(ch) == ""
        if dropped != (unicodedata.category(ch) in ("Mn", "Mc", "Me")):
            (mark if dropped else not_mark).add(c)
    return {"_CRATE_NFKD_WHOLE": ranges(whole), "_CRATE_STARTER": ranges(starter),
            "_CRATE_NOT_MARK": ranges(not_mark), "_CRATE_MARK": ranges(mark)}


def literal(name: str, runs) -> str:
    """``name = (...)`` as hf_tokenizer.py holds it, 79 columns wide."""
    items = ["(" + ", ".join(f"{v:#x}" if i < 2 else str(v)
                             for i, v in enumerate(r)) + ")" for r in runs]
    one = f"{name} = ({', '.join(items)}{',' if len(items) == 1 else ''})"
    if len(one) <= 79:
        return one
    lines, cur = [f"{name} = ("], "   "
    for item in items:
        if len(cur) + len(item) + 2 > 79:
            lines.append(cur)
            cur = "   "
        cur += f" {item},"
    return "\n".join([*lines, cur, ")"])


def main() -> None:
    print(f"# unicodedata {unicodedata.unidata_version}")
    for module, tables in (("hf_tokenizer.py", crate_tables), ("hf_bpe.py", bpe_tables),
                           ("hf_unigram.py", grapheme_tables),
                           ("hf_unigram.py", normalizer_tables)):
        print(f"# {module}")
        for name, runs in tables().items():
            print(literal(name, runs))


if __name__ == "__main__":
    main()
