"""Hugging Face ``tokenizer.json`` tokenizers in plain Python.

The JAX package serves ``tokenizer.json`` through the ``tokenizers``
library; the card's machine does not have it, so this module reads the
file and runs the library's pipeline itself, id for id:

1. **added tokens** are split out of the raw text first (those with
   ``normalized: false``), then out of each normalized piece (those with
   ``normalized: true``, matched in their normalized form), leftmost and
   longest first, with ``single_word``, ``lstrip`` and ``rstrip``;
2. the **normalizer** runs on every piece that is not an added token;
3. the **pre-tokenizer** splits each piece further;
4. the **model** maps each pre-token to ids (cached per pre-token, as the
   library caches it);
5. the **post-processor** adds the template's special tokens when asked.

Decoding maps ids to tokens (added tokens first, special ones dropped on
request), runs the decoder chain and joins the pieces; with no decoder the
tokens are joined with spaces, as the library does.

Supported components: normalizers ``NFC``, ``NFD``, ``NFKC``, ``NFKD``,
``Lowercase``, ``Strip``, ``Prepend``, ``Replace``, ``Sequence``;
pre-tokenizers ``ByteLevel``, ``Split``, ``Whitespace``,
``WhitespaceSplit``, ``Metaspace``, ``Digits``, ``Sequence``; models
``BPE``, ``WordLevel``, ``Unigram``; post-processors
``TemplateProcessing``, ``ByteLevel``, ``Sequence``; decoders
``ByteLevel``, ``Metaspace``, ``Replace``, ``ByteFallback``, ``Fuse``,
``Strip``, ``Sequence``.  Any other type raises ``ValueError`` naming it.

The library runs its regular expressions on Oniguruma (Ruby syntax) and a
few fixed ones on Rust's ``regex`` crate; both read ``\\s``, ``\\w`` and
``\\p{..}`` over Unicode properties that Python's ``re`` either lacks or
reads differently.  ``onig_regex`` translates a pattern to ``re`` with
those classes spelled out from ``unicodedata``, built once a process.
"""

from __future__ import annotations

import bisect
import functools
import heapq
import json
import re
import unicodedata
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# ----------------------------------------------------------- unicode classes

# Unicode's White_Space property: Rust's char::is_whitespace, the regex
# crate's and Oniguruma's \s.  Python's str.isspace also takes \x1c-\x1f.
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
                (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
                (0x3000, 0x3000))
# Other_Alphabetic code points outside the mark categories (circled and
# squared Latin letters): Alphabetic = L + Nl + Other_Alphabetic.
_OTHER_ALPHABETIC_SO = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                        (0x1F170, 0x1F189))
_JOIN_CONTROL = ((0x200C, 0x200D),)
_LONG_CATEGORY = {
    "Letter": "L", "Cased_Letter": "LC", "Uppercase_Letter": "Lu", "Lowercase_Letter": "Ll",
    "Titlecase_Letter": "Lt", "Modifier_Letter": "Lm", "Other_Letter": "Lo", "Mark": "M",
    "Nonspacing_Mark": "Mn", "Spacing_Mark": "Mc", "Enclosing_Mark": "Me", "Number": "N",
    "Decimal_Number": "Nd", "Letter_Number": "Nl", "Other_Number": "No", "Punctuation": "P",
    "Connector_Punctuation": "Pc", "Dash_Punctuation": "Pd", "Open_Punctuation": "Ps",
    "Close_Punctuation": "Pe", "Initial_Punctuation": "Pi", "Final_Punctuation": "Pf",
    "Other_Punctuation": "Po", "Symbol": "S", "Math_Symbol": "Sm", "Currency_Symbol": "Sc",
    "Modifier_Symbol": "Sk", "Other_Symbol": "So", "Separator": "Z", "Space_Separator": "Zs",
    "Line_Separator": "Zl", "Paragraph_Separator": "Zp", "Other": "C", "Control": "Cc",
    "Format": "Cf", "Surrogate": "Cs", "Private_Use": "Co", "Unassigned": "Cn",
}

Ranges = Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=1)
def _category_runs() -> Dict[str, List[Tuple[int, int]]]:
    """General category → its code point runs, one pass over Unicode."""
    runs: Dict[str, List[Tuple[int, int]]] = {}
    start, cat = 0, unicodedata.category("\0")
    for cp in range(1, 0x110000):
        c = unicodedata.category(chr(cp))
        if c != cat:
            runs.setdefault(cat, []).append((start, cp - 1))
            start, cat = cp, c
    runs.setdefault(cat, []).append((start, 0x10FFFF))
    return runs


def _union(*sets: Iterable[Tuple[int, int]]) -> Ranges:
    merged: List[List[int]] = []
    for a, b in sorted(r for s in sets for r in s):
        if merged and a <= merged[-1][1] + 1:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return tuple((a, b) for a, b in merged)


def _complement(rs: Ranges) -> Ranges:
    out, nxt = [], 0
    for a, b in rs:
        if a > nxt:
            out.append((nxt, a - 1))
        nxt = b + 1
    if nxt <= 0x10FFFF:
        out.append((nxt, 0x10FFFF))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def category_ranges(name: str) -> Ranges:
    """Code point ranges of a general category (``L``, ``Lu``, ``Letter``,
    ``LC``).  Anything else (scripts, binary properties) raises."""
    name = _LONG_CATEGORY.get(name, name)
    runs = _category_runs()
    if name == "LC":
        return _union(runs.get("Lu", ()), runs.get("Ll", ()), runs.get("Lt", ()))
    if len(name) == 1 and name in "LMNPSZC":
        return _union(*(v for k, v in runs.items() if k[0] == name))
    if len(name) == 2 and name in runs or name == "Cn":
        return _union(runs.get(name, ()))
    raise ValueError(f"unsupported Unicode property \\p{{{name}}} in a tokenizer pattern")


@functools.lru_cache(maxsize=None)
def named_ranges(name: str) -> Ranges:
    """The classes each engine gives its shorthand escapes."""
    if name == "space":
        return _WHITE_SPACE
    if name == "digit":
        return category_ranges("Nd")
    if name == "onig_word":  # Oniguruma: Letter | Mark | Decimal_Number | Connector_Punctuation
        return _union(category_ranges("L"), category_ranges("M"), category_ranges("Nd"),
                      category_ranges("Pc"))
    if name == "rust_word":  # regex crate: Alphabetic | M | Nd | Pc | Join_Control
        return _union(category_ranges("L"), category_ranges("Nl"), _OTHER_ALPHABETIC_SO,
                      category_ranges("M"), category_ranges("Nd"), category_ranges("Pc"),
                      _JOIN_CONTROL)
    if name == "numeric":  # Rust char::is_numeric: Nd | Nl | No
        return category_ranges("N")
    if name == "xdigit":
        return ((0x30, 0x39), (0x41, 0x46), (0x61, 0x66))
    raise KeyError(name)


def _class_body(rs: Ranges) -> str:
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in rs)


def _class(rs: Ranges, negate: bool = False) -> str:
    return f"[{'^' if negate else ''}{_class_body(rs)}]"


@functools.lru_cache(maxsize=None)
def _in_set(name: str) -> Callable[[str], bool]:
    """Membership test of a named class, for per-character predicates."""
    rs = named_ranges(name)
    starts = [a for a, _ in rs]

    def test(c: str) -> bool:
        cp = ord(c)
        i = bisect.bisect_right(starts, cp) - 1
        return i >= 0 and cp <= rs[i][1]

    return test


def is_whitespace(c: str) -> bool:
    return _in_set("space")(c)


# ------------------------------------------------------------------- regexes

_SHORTHAND = {"s": "space", "d": "digit", "h": "xdigit", "w": "onig_word"}
# Escapes both engines read alike (control characters, \A, backrefs).
_PLAIN_ESCAPES = set("AtnrfvaxuU0123456789")


def _property(pattern: str, i: int, negate: bool) -> Tuple[Ranges, int, bool]:
    """Parse ``\\p{Name}`` / ``\\p{^Name}`` at ``pattern[i]`` (the ``{``)."""
    end = pattern.find("}", i)
    if pattern[i:i + 1] != "{" or end < 0:
        raise ValueError(f"unsupported property escape in tokenizer pattern {pattern!r}")
    name = pattern[i + 1:end]
    if name.startswith("^"):
        name, negate = name[1:], not negate
    return category_ranges(name), end + 1, negate


def translate_onig(pattern: str) -> str:
    """An Oniguruma (Ruby syntax) pattern as a Python ``re`` pattern with
    the same matches: Unicode classes spelled out, ``^``/``$`` as line
    anchors, ``\\z``/``\\Z`` as Ruby reads them.  Constructs without a
    faithful translation (nested classes, ``\\X``, ``\\R``, ``\\K``,
    ``\\G``, scripts) raise ``ValueError``."""
    out: List[str] = []
    i, n = 0, len(pattern)
    in_class = class_start = False

    def put(rs: Ranges, negate: bool) -> None:
        if in_class:
            out.append(_class_body(_complement(rs) if negate else rs))
        else:
            out.append(_class(rs, negate))

    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            i += 2
            class_start = False
            if e.lower() in _SHORTHAND:
                put(named_ranges(_SHORTHAND[e.lower()]), e.isupper())
            elif e in "pP":
                rs, i, neg = _property(pattern, i, e == "P")
                put(rs, neg)
            elif e == "x" and pattern[i:i + 1] == "{":
                end = pattern.index("}", i)
                out.append(f"\\U{int(pattern[i + 1:end], 16):08x}")
                i = end + 1
            elif e == "e":
                out.append(r"\x1b")
            elif in_class and e == "b":
                out.append(r"\x08")
            elif not in_class and e == "z":
                out.append(r"\Z")
            elif not in_class and e == "Z":
                out.append(r"(?=\n?\Z)")
            elif not in_class and e in "bB":
                w = _class_body(named_ranges("onig_word"))
                b = f"(?:(?<=[{w}])(?![{w}])|(?<![{w}])(?=[{w}]))"
                out.append(b if e == "b" else f"(?!{b})")
            elif e.isalnum() and e not in _PLAIN_ESCAPES:
                raise ValueError(f"unsupported escape \\{e} in tokenizer pattern {pattern!r}")
            else:
                out.append("\\" + e)
            continue
        if in_class:
            if c == "[":
                raise ValueError(f"nested character class in tokenizer pattern {pattern!r}")
            if pattern.startswith("&&", i):
                raise ValueError(f"class intersection in tokenizer pattern {pattern!r}")
            if c == "]" and not class_start:
                in_class = False
            class_start = c == "^" and class_start and out[-1] == "["
            out.append(c)
        elif c == "[":
            in_class = class_start = True
            out.append(c)
        elif c == "^":
            out.append("(?m:^)")
        elif c == "$":
            out.append("(?m:$)")
        elif pattern.startswith("(?<", i) and pattern[i + 3:i + 4] not in ("=", "!"):
            out.append("(?P<")
            i += 3
            continue
        elif pattern.startswith("(?~", i):
            raise ValueError(f"absent operator in tokenizer pattern {pattern!r}")
        else:
            out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def onig_regex(pattern: str) -> "re.Pattern[str]":
    try:
        return re.compile(translate_onig(pattern))
    except re.error as exc:
        raise ValueError(f"unsupported tokenizer pattern {pattern!r}: {exc}") from None


def onig_find_iter(rx: "re.Pattern[str]", text: str) -> Iterable[Tuple[int, int]]:
    """Oniguruma's ``find_iter`` as the ``onig`` crate walks it: an empty
    match right after the previous match is skipped."""
    pos, last_end, n = 0, -1, len(text)
    while pos <= n:
        m = rx.search(text, pos)
        if m is None:
            return
        s, e = m.span()
        if s == e and e == last_end:
            pos += 1
            continue
        pos = last_end = e
        yield s, e


def find_matches(pattern: Any, text: str) -> List[Tuple[int, int, bool]]:
    """``Pattern::find_matches``: the text cut into (start, end, is_match)
    spans.  ``pattern`` is a compiled regex, a literal string or a
    per-character predicate."""
    if not text:
        return [(0, 0, False)]
    out: List[Tuple[int, int, bool]] = []
    if callable(pattern) and not isinstance(pattern, re.Pattern):
        last = 0
        for i, c in enumerate(text):
            if pattern(c):
                if last < i:
                    out.append((last, i, False))
                out.append((i, i + 1, True))
                last = i + 1
        if last < len(text):
            out.append((last, len(text), False))
        return out
    if isinstance(pattern, str):
        if not pattern:
            return [(0, len(text), False)]
        spans: Iterable[Tuple[int, int]] = _literal_spans(pattern, text)
    else:
        spans = onig_find_iter(pattern, text)
    prev = 0
    for s, e in spans:
        if prev != s:
            out.append((prev, s, False))
        out.append((s, e, True))
        prev = e
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _literal_spans(lit: str, text: str) -> Iterable[Tuple[int, int]]:
    i = text.find(lit)
    while i >= 0:
        yield i, i + len(lit)
        i = text.find(lit, i + len(lit))


def split_spans(matches: List[Tuple[int, int, bool]], behavior: str) -> List[Tuple[int, int]]:
    """``NormalizedString::split``: the kept spans under a
    ``SplitDelimiterBehavior``."""
    if behavior == "Isolated":
        return [(s, e) for s, e, _ in matches]
    if behavior == "Removed":
        return [(s, e) for s, e, m in matches if not m]
    acc: List[List[int]] = []
    prev = False
    if behavior == "Contiguous":
        for s, e, m in matches:
            if m == prev and acc:
                acc[-1][1] = e
            else:
                acc.append([s, e])
            prev = m
        return [(s, e) for s, e in acc]
    if behavior == "MergedWithPrevious":
        for s, e, m in matches:
            if m and not prev and acc:
                acc[-1][1] = e
            else:
                acc.append([s, e])
            prev = m
        return [(s, e) for s, e in acc]
    if behavior == "MergedWithNext":
        for s, e, m in reversed(matches):
            if m and not prev and acc:
                acc[-1][0] = s
            else:
                acc.append([s, e])
            prev = m
        return [(s, e) for s, e in reversed(acc)]
    raise ValueError(f"unsupported split behavior {behavior!r}")


def _pattern(obj: Any, kind: str) -> Any:
    """A ``{"String": ...}`` or ``{"Regex": ...}`` pattern of a component."""
    if isinstance(obj, dict) and "String" in obj:
        return obj["String"]
    if isinstance(obj, dict) and "Regex" in obj:
        return onig_regex(obj["Regex"])
    if isinstance(obj, str):
        return obj
    raise ValueError(f"unsupported {kind} pattern {obj!r}")


def _replace(pattern: Any, content: str, text: str) -> str:
    if isinstance(pattern, str):
        return text.replace(pattern, content) if pattern else text
    return "".join(content if m else text[s:e] for s, e, m in find_matches(pattern, text))


# --------------------------------------------------------------- normalizers

# Code points the library's Unicode normalization tables (its
# unicode-normalization-alignments crate) predate and Python 3.12's
# unicodedata (Unicode 15.0) has: decompositions added since (and the
# parts of the one new canonical one), and combining marks whose class is
# new.  The library leaves each unchanged with class 0, so it normalizes
# the text on either side of one independently; found by comparing the
# library's NFC/NFD/NFKC/NFKD with unicodedata's over every code point.
_NORMALIZATION_GAPS = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE), (0xC3C, 0xC3C),
    (0xD3B, 0xD3C), (0xEBA, 0xEBA), (0x1715, 0x1715), (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFA),
    (0x32FF, 0x32FF), (0xA7F2, 0xA7F4), (0xA82C, 0xA82C), (0xAB69, 0xAB69), (0x10781, 0x10785),
    (0x10787, 0x107B0), (0x107B2, 0x107BA), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070),
    (0x1133B, 0x1133B), (0x1145E, 0x1145E), (0x11839, 0x1183A), (0x11930, 0x11930),
    (0x11935, 0x11935), (0x11938, 0x11938), (0x1193D, 0x1193E), (0x11943, 0x11943),
    (0x119E0, 0x119E0), (0x11A34, 0x11A34), (0x11A47, 0x11A47), (0x11A99, 0x11A99),
    (0x11D42, 0x11D42), (0x11D44, 0x11D45), (0x11D97, 0x11D97), (0x11F41, 0x11F42),
    (0x16FF0, 0x16FF1), (0x1E030, 0x1E06D), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136),
    (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF), (0x1F16C, 0x1F16C),
    (0x1FBF0, 0x1FBF9),
)
_GAP = re.compile(f"({_class(_NORMALIZATION_GAPS)})")


def unicode_normalize(form: str, s: str) -> str:
    """``unicodedata.normalize`` as the library's tables give it."""
    if not _GAP.search(s):
        return unicodedata.normalize(form, s)
    return "".join(p if i % 2 else unicodedata.normalize(form, p)
                   for i, p in enumerate(_GAP.split(s)))


def _lowercase(s: str) -> str:
    # char::to_lowercase one character at a time: no final-sigma context.
    return "".join(c.lower() for c in s)


def _strip(s: str, left: bool, right: bool) -> str:
    i, j = 0, len(s)
    if left:
        while i < j and is_whitespace(s[i]):
            i += 1
    if right:
        while j > i and is_whitespace(s[j - 1]):
            j -= 1
    return s[i:j]


Normalizer = Callable[[str], str]


def build_normalizer(obj: Optional[Dict[str, Any]]) -> Optional[Normalizer]:
    if obj is None:
        return None
    kind = obj.get("type")
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return functools.partial(unicode_normalize, kind)
    if kind == "Lowercase":
        return _lowercase
    if kind == "Strip":
        return functools.partial(_strip, left=bool(obj.get("strip_left", True)),
                                 right=bool(obj.get("strip_right", True)))
    if kind == "Prepend":
        prefix = obj["prepend"]
        return lambda s: prefix + s if s else s
    if kind == "Replace":
        pattern, content = _pattern(obj["pattern"], "Replace"), obj["content"]
        return functools.partial(_replace, pattern, content)
    if kind == "Sequence":
        steps = [build_normalizer(n) for n in obj.get("normalizers") or ()]

        def seq(s: str) -> str:
            for step in steps:
                s = step(s)
            return s

        return seq
    raise ValueError(f"unsupported normalizer type {kind!r}")


# ------------------------------------------------------------ pre-tokenizers

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character map (ByteLevel)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTES_CHAR = _bytes_to_unicode()
CHAR_BYTES = {c: b for b, c in BYTES_CHAR.items()}
_BYTE_TABLE = [BYTES_CHAR[b] for b in range(256)]
_GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


def byte_level_chars(s: str) -> str:
    table = _BYTE_TABLE
    return "".join([table[b] for b in s.encode("utf-8")])


# A piece is (text, starts at original offset 0).
Piece = Tuple[str, bool]
PreTokenizer = Callable[[str, bool], List[Piece]]


def _pieces(text: str, at_start: bool, spans: List[Tuple[int, int]]) -> List[Piece]:
    return [(text[s:e], at_start and s == 0) for s, e in spans if e > s]


def build_pre_tokenizer(obj: Optional[Dict[str, Any]], after_split: bool = False,
                        inserts: bool = False) -> Optional[PreTokenizer]:
    """``after_split``: an earlier step of a Sequence already cut the
    pieces; ``inserts``: the normalizer can insert characters (Prepend,
    Replace).  Together they would make Metaspace's ``first`` scheme read
    original offsets this module does not keep, so that case raises."""
    if obj is None:
        return None
    kind = obj.get("type")
    if kind == "ByteLevel":
        prefix = bool(obj.get("add_prefix_space", True))
        rx = onig_regex(_GPT2_PATTERN) if obj.get("use_regex", True) else None

        def byte_level(text: str, at_start: bool) -> List[Piece]:
            if prefix and not text.startswith(" "):
                text = " " + text
            spans = ([(s, e) for s, e, _ in find_matches(rx, text)] if rx is not None
                     else [(0, len(text))])
            return [(byte_level_chars(text[s:e]), at_start and s == 0) for s, e in spans if e > s]

        return byte_level
    if kind == "Split":
        pattern = _pattern(obj["pattern"], "Split")
        behavior = obj.get("behavior", "Isolated")
        invert = bool(obj.get("invert", False))
        split_spans([], behavior)  # refuse an unknown behavior at load

        def split(text: str, at_start: bool) -> List[Piece]:
            matches = find_matches(pattern, text)
            if invert:
                matches = [(s, e, not m) for s, e, m in matches]
            return _pieces(text, at_start, split_spans(matches, behavior))

        return split
    if kind == "Whitespace":
        w = _class_body(named_ranges("rust_word"))
        rx = re.compile(f"[{w}]+|[^{w}{_class_body(_WHITE_SPACE)}]+")

        def whitespace(text: str, at_start: bool) -> List[Piece]:
            matches = [(s, e, not m) for s, e, m in find_matches(rx, text)]
            return _pieces(text, at_start, split_spans(matches, "Removed"))

        return whitespace
    if kind == "WhitespaceSplit":
        def whitespace_split(text: str, at_start: bool) -> List[Piece]:
            return _pieces(text, at_start, split_spans(find_matches(is_whitespace, text), "Removed"))

        return whitespace_split
    if kind == "Digits":
        behavior = "Isolated" if obj.get("individual_digits", False) else "Contiguous"
        numeric = _in_set("numeric")

        def digits(text: str, at_start: bool) -> List[Piece]:
            return _pieces(text, at_start, split_spans(find_matches(numeric, text), behavior))

        return digits
    if kind == "Metaspace":
        rep, scheme, do_split = _metaspace(obj)
        if scheme == "first" and after_split and inserts:
            raise ValueError("unsupported pre-tokenizer: Metaspace with prepend_scheme 'first' "
                             "after a splitting step over an inserting normalizer")

        def metaspace(text: str, at_start: bool) -> List[Piece]:
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (scheme == "always" or scheme == "first" and at_start):
                text = rep + text
            if not do_split:
                return [(text, at_start)]
            return _pieces(text, at_start, split_spans(find_matches(rep, text), "MergedWithNext"))

        return metaspace
    if kind == "Sequence":
        steps = []
        for i, p in enumerate(obj.get("pretokenizers") or ()):
            steps.append(build_pre_tokenizer(p, after_split or i > 0, inserts))

        def sequence(text: str, at_start: bool) -> List[Piece]:
            pieces = [(text, at_start)]
            for step in steps:
                pieces = [q for t, a in pieces for q in step(t, a)]
            return pieces

        return sequence
    raise ValueError(f"unsupported pre_tokenizer type {kind!r}")


def _metaspace(obj: Dict[str, Any]) -> Tuple[str, str, bool]:
    rep = obj.get("replacement", "▁")
    scheme = obj.get("prepend_scheme")
    if obj.get("add_prefix_space") is False:
        scheme = "never"
    scheme = scheme or "always"
    if scheme not in ("always", "never", "first"):
        raise ValueError(f"unsupported Metaspace prepend_scheme {scheme!r}")
    return rep, scheme, bool(obj.get("split", True))


def _normalizer_inserts(obj: Optional[Dict[str, Any]]) -> bool:
    if obj is None:
        return False
    if obj.get("type") == "Sequence":
        return any(_normalizer_inserts(n) for n in obj.get("normalizers") or ())
    return obj.get("type") in ("Prepend", "Replace")


# -------------------------------------------------------------------- models

_CACHE_CAPACITY = 10_000  # the library's per-model cache size


class _Cached:
    """Per-pre-token id cache: filled until full, as the library's is."""

    def __init__(self) -> None:
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, text: str) -> List[int]:
        hit = self._cache.get(text)
        if hit is not None:
            return hit
        ids = self._tokenize(text)
        if len(self._cache) < _CACHE_CAPACITY:
            self._cache[text] = ids
        return ids

    def _tokenize(self, text: str) -> List[int]:
        raise NotImplementedError


class BPE(_Cached):
    """Byte-pair encoding: characters (with ``continuing_subword_prefix``
    and ``end_of_word_suffix``), byte fallback or unk for the unknown
    ones, then the lowest-rank merge first until none applies."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], *,
                 unk_token: Optional[str] = None, continuing_subword_prefix: Optional[str] = None,
                 end_of_word_suffix: Optional[str] = None, fuse_unk: bool = False,
                 byte_fallback: bool = False, ignore_merges: bool = False,
                 dropout: Optional[float] = None):
        super().__init__()
        if dropout not in (None, 0.0):
            raise ValueError(f"unsupported BPE dropout {dropout!r}: only deterministic BPE is served")
        self.vocab = dict(vocab)
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix
        self.suffix = end_of_word_suffix
        self.fuse_unk = fuse_unk
        self.byte_fallback = byte_fallback
        self.ignore_merges = ignore_merges
        plen = len((continuing_subword_prefix or "").encode())
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            tail = b.encode()[plen:].decode("utf-8", errors="strict")
            for part in (a, b, a + tail):
                if part not in self.vocab:
                    raise ValueError(f"BPE merge token {part!r} is not in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + tail])

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "BPE":
        merges = []
        for m in obj.get("merges") or ():
            if isinstance(m, str):
                parts = m.split(" ", 1)
                if len(parts) != 2:
                    raise ValueError(f"bad BPE merge {m!r}")
                merges.append((parts[0], parts[1]))
            else:
                merges.append((m[0], m[1]))
        return cls(obj.get("vocab") or {}, merges, unk_token=obj.get("unk_token"),
                   continuing_subword_prefix=obj.get("continuing_subword_prefix"),
                   end_of_word_suffix=obj.get("end_of_word_suffix"),
                   fuse_unk=bool(obj.get("fuse_unk", False)),
                   byte_fallback=bool(obj.get("byte_fallback", False)),
                   ignore_merges=bool(obj.get("ignore_merges", False)), dropout=obj.get("dropout"))

    def tokenize(self, text: str) -> List[int]:
        if not text:
            return []
        if self.ignore_merges:
            hit = self.vocab.get(text)
            if hit is not None:
                return [hit]
        return super().tokenize(text)

    def _unk_id(self) -> int:
        try:
            return self.vocab[self.unk_token]
        except KeyError:
            raise ValueError(f"BPE unk_token {self.unk_token!r} is not in the vocabulary") from None

    def _tokenize(self, w: str) -> List[int]:
        ids: List[int] = []
        unk: Optional[int] = None  # a pending (maybe fused) unk
        last = len(w) - 1
        for i, ch in enumerate(w):
            s = ch
            if i > 0 and self.prefix is not None:
                s = self.prefix + s
            if i == last and self.suffix is not None:
                s = s + self.suffix
            hit = self.vocab.get(s)
            if hit is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(hit)
                continue
            if self.byte_fallback:
                codes = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if all(c is not None for c in codes):
                    ids.extend(codes)  # type: ignore[arg-type]
                    continue
            if self.unk_token is not None:
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self._unk_id()
        if unk is not None:
            ids.append(unk)
        return self._merge(ids)

    def _merge(self, sym: List[int]) -> List[int]:
        n = len(sym)
        if n < 2:
            return sym
        merges = self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] < n:
                prev[nxt[right]] = pos
            p = prev[pos]
            if p >= 0:
                m = merges.get((sym[p], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            q = nxt[pos]
            if q < n:
                m = merges.get((new_id, sym[q]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        return self.vocab_r.get(i)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    def get_vocab_size(self) -> int:
        return len(self.vocab)


class WordLevel:
    def __init__(self, vocab: Dict[str, int], unk_token: Optional[str] = "<unk>"):
        self.vocab = dict(vocab)
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk_token = unk_token

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "WordLevel":
        return cls(obj.get("vocab") or {}, obj.get("unk_token", "<unk>"))

    def tokenize(self, text: str) -> List[int]:
        hit = self.vocab.get(text)
        if hit is None:
            hit = self.vocab.get(self.unk_token) if self.unk_token is not None else None
            if hit is None:
                raise ValueError("WordLevel: a word is not in the vocabulary and there is no unk token")
        return [hit]

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        return self.vocab_r.get(i)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    def get_vocab_size(self) -> int:
        return len(self.vocab)


_K_UNK_PENALTY = 10.0


class Unigram(_Cached):
    """Viterbi segmentation over the pieces' scores, unknown characters
    scored ``min_score - 10`` and fused into one unk; ``byte_fallback``
    spells an unknown segment's bytes as ``<0xNN>`` pieces."""

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: Optional[int] = None,
                 byte_fallback: bool = False):
        super().__init__()
        if unk_id is not None and not 0 <= unk_id < len(vocab):
            raise ValueError(f"Unigram unk_id {unk_id} is not in the vocabulary")
        self.pieces = [p for p, _ in vocab]
        self.scores = [float(s) for _, s in vocab]
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self.ids: Dict[str, int] = {}
        for i, p in enumerate(self.pieces):
            self.ids[p] = i
        self.min_score = min(self.scores) if self.scores else float("inf")
        # First characters → the piece lengths that start with them, so a
        # position tries only lengths some piece has.
        self._lengths: Dict[str, List[int]] = {}
        for p in self.ids:
            if p:
                self._lengths.setdefault(p[0], []).append(len(p))
        for k in self._lengths:
            self._lengths[k] = sorted(set(self._lengths[k]))

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "Unigram":
        return cls([(p, s) for p, s in obj.get("vocab") or ()], obj.get("unk_id"),
                   bool(obj.get("byte_fallback", False)))

    def _segments(self, s: str) -> List[str]:
        n = len(s)
        score = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        node = [0] * (n + 1)
        unk_score = self.min_score - _K_UNK_PENALTY
        ids, scores = self.ids, self.scores
        for i in range(n):
            base = score[i]
            single = False
            for ln in self._lengths.get(s[i], ()):
                j = i + ln
                if j > n:
                    break
                pid = ids.get(s[i:j])
                if pid is None:
                    continue
                cand = scores[pid] + base
                if start[j] is None or cand > score[j]:
                    score[j], start[j], node[j] = cand, i, pid
                if ln == 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: an unknown character and no unk_id")
                cand = unk_score + base
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], node[i + 1] = cand, i, self.unk_id
        out: List[str] = []
        fused: List[str] = []
        end = n
        while end > 0:
            b = start[end]
            assert b is not None
            if self.unk_id is not None and node[end] == self.unk_id:
                fused.append(s[b:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(s[b:end])
            end = b
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def _tokenize(self, text: str) -> List[int]:
        if not text:
            return []
        out: List[int] = []
        for seg in self._segments(text):
            pid = self.ids.get(seg)
            if pid is None:
                if self.byte_fallback:
                    codes = [self.ids.get(f"<0x{b:02X}>") for b in seg.encode("utf-8")]
                    if all(c is not None for c in codes):
                        out.extend(codes)  # type: ignore[arg-type]
                        continue
                if self.unk_id is None:
                    raise ValueError("Unigram: an unknown segment and no unk_id")
                pid = self.unk_id
            out.append(pid)
        return out

    def token_to_id(self, token: str) -> Optional[int]:
        return self.ids.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        return self.pieces[i] if 0 <= i < len(self.pieces) else None

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.ids)

    def get_vocab_size(self) -> int:
        return len(self.pieces)


def build_model(obj: Dict[str, Any]):
    kind = obj.get("type")
    if kind is None:  # untagged, as older files write it
        kind = "BPE" if "merges" in obj else "Unigram" if isinstance(obj.get("vocab"), list) else "WordLevel"
    if kind == "BPE":
        return BPE.from_dict(obj)
    if kind == "WordLevel":
        return WordLevel.from_dict(obj)
    if kind == "Unigram":
        return Unigram.from_dict(obj)
    raise ValueError(f"unsupported model type {kind!r}")


# ----------------------------------------------------------- post-processors

PostProcessor = Callable[[List[int]], List[int]]


def build_post_processor(obj: Optional[Dict[str, Any]]) -> Optional[PostProcessor]:
    """What runs on a single sequence's ids when special tokens are asked
    for (the pair template is never used: the server encodes one text)."""
    if obj is None:
        return None
    kind = obj.get("type")
    if kind == "ByteLevel":
        return lambda ids: ids  # offsets only
    if kind == "TemplateProcessing":
        specials = {k: list(v["ids"]) for k, v in (obj.get("special_tokens") or {}).items()}
        template = []
        for item in obj.get("single") or ():
            if "SpecialToken" in item:
                name = item["SpecialToken"]["id"]
                if name not in specials:
                    raise ValueError(f"TemplateProcessing names a missing special token {name!r}")
                template.append(specials[name])
            elif "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise ValueError("unsupported TemplateProcessing: the single template uses B")
                template.append(None)
            else:
                raise ValueError(f"unsupported TemplateProcessing piece {item!r}")

        def apply(ids: List[int]) -> List[int]:
            out: List[int] = []
            for part in template:
                out.extend(ids if part is None else part)
            return out

        return apply
    if kind == "Sequence":
        steps = [build_post_processor(p) for p in obj.get("processors") or ()]

        def seq(ids: List[int]) -> List[int]:
            for step in steps:
                ids = step(ids)
            return ids

        return seq
    raise ValueError(f"unsupported post_processor type {kind!r}")


# ------------------------------------------------------------------ decoders

Decoder = Callable[[List[str]], List[str]]


def _byte_level_decode(tokens: List[str]) -> List[str]:
    out = bytearray()
    for t in tokens:
        bs = [CHAR_BYTES.get(c) for c in t]
        out.extend(t.encode("utf-8") if None in bs else bs)  # type: ignore[arg-type]
    return [out.decode("utf-8", errors="replace")]


_HEX = set("0123456789abcdefABCDEF")


def _fallback_byte(token: str) -> Optional[int]:
    """``<0xNN>`` (u8::from_str_radix: an optional ``+``, hex digits)."""
    if len(token.encode("utf-8")) != 6 or not token.startswith("<0x") or not token.endswith(">"):
        return None
    digits = token[3:5]
    body = digits[1:] if digits.startswith("+") else digits
    if not body or any(c not in _HEX for c in body):
        return None
    return int(body, 16)


def _byte_fallback_decode(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush() -> None:
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for t in tokens:
        b = _fallback_byte(t)
        if b is not None:
            pending.append(b)
        else:
            flush()
            out.append(t)
    flush()
    return out


def _strip_decode(content: str, start: int, stop: int, tokens: List[str]) -> List[str]:
    out = []
    for t in tokens:
        chars = list(t)
        cut0 = 0
        for i, c in enumerate(chars[:start]):
            if c != content:
                break
            cut0 = i + 1
        cut1 = len(chars)
        for i in range(min(stop, len(chars))):
            j = len(chars) - i - 1
            if chars[j] != content:
                break
            cut1 = j
        out.append("".join(chars[cut0:max(cut0, cut1)]))
    return out


def build_decoder(obj: Optional[Dict[str, Any]]) -> Optional[Decoder]:
    if obj is None:
        return None
    kind = obj.get("type")
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Metaspace":
        rep, scheme, _ = _metaspace(obj)

        def metaspace(tokens: List[str]) -> List[str]:
            out = []
            for i, t in enumerate(tokens):
                drop = i == 0 and scheme != "never"
                out.append(t.replace(rep, "") if drop else t.replace(rep, " "))
            return out

        return metaspace
    if kind == "Replace":
        pattern, content = _pattern(obj["pattern"], "Replace"), obj["content"]
        return lambda tokens: [_replace(pattern, content, t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return functools.partial(_strip_decode, obj["content"], int(obj.get("start", 0)),
                                 int(obj.get("stop", 0)))
    if kind == "Sequence":
        steps = [build_decoder(d) for d in obj.get("decoders") or ()]

        def seq(tokens: List[str]) -> List[str]:
            for step in steps:
                tokens = step(tokens)
            return tokens

        return seq
    raise ValueError(f"unsupported decoder type {kind!r}")


# ----------------------------------------------------------------- tokenizer

class AddedToken:
    __slots__ = ("content", "special", "single_word", "lstrip", "rstrip", "normalized")

    def __init__(self, content: str, special: bool = False, single_word: bool = False,
                 lstrip: bool = False, rstrip: bool = False, normalized: Optional[bool] = None):
        self.content = content
        self.special = special
        self.single_word = single_word
        self.lstrip = lstrip
        self.rstrip = rstrip
        self.normalized = (not special) if normalized is None else normalized

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AddedToken":
        return cls(d["content"], bool(d.get("special", False)), bool(d.get("single_word", False)),
                   bool(d.get("lstrip", False)), bool(d.get("rstrip", False)),
                   d.get("normalized"))


def _ends_with_word(s: str) -> bool:
    return bool(s) and _in_set("rust_word")(s[-1])


def _starts_with_word(s: str) -> bool:
    return bool(s) and _in_set("rust_word")(s[0])


class _Matcher:
    """The added vocabulary's leftmost-longest matcher over one set of
    token texts (an alternation sorted longest first finds, at the
    leftmost position, the longest)."""

    def __init__(self, entries: List[Tuple[str, int, AddedToken]]):
        by_text: Dict[str, Tuple[int, AddedToken]] = {}
        for text, tid, tok in entries:
            by_text.setdefault(text, (tid, tok))
        self.by_text = by_text
        alts = sorted(by_text, key=len, reverse=True)
        self.rx = re.compile("|".join(map(re.escape, alts))) if alts else None

    def split(self, text: str, at_start: bool) -> List[Tuple[str, Optional[int], bool]]:
        """``find_matches``: (piece, token id or None, at original 0)."""
        if self.rx is None or not text:
            return [(text, None, at_start)] if text else []
        out: List[Tuple[str, Optional[int], bool]] = []
        offset = 0
        for m in self.rx.finditer(text):
            start, stop = m.span()
            tid, tok = self.by_text[m.group()]
            if tok.single_word:
                if (start > 0 and _ends_with_word(text[:start])
                        or stop < len(text) and _starts_with_word(text[stop:])):
                    continue
            if tok.lstrip:
                k = start
                while k > 0 and is_whitespace(text[k - 1]):
                    k -= 1
                start = max(k, offset)
            if tok.rstrip:
                while stop < len(text) and is_whitespace(text[stop]):
                    stop += 1
            if offset < start:
                out.append((text[offset:start], None, at_start and offset == 0))
            out.append((text[start:stop], tid, at_start and start == 0))
            offset = stop
        if offset != len(text):
            out.append((text[offset:], None, at_start and offset == 0))
        return [p for p in out if p[0]]


class Tokenizer:
    """A ``tokenizer.json`` pipeline: ``encode`` → ids, ``decode`` → text."""

    def __init__(self, model, *, normalizer: Optional[Normalizer] = None,
                 pre_tokenizer: Optional[PreTokenizer] = None,
                 post_processor: Optional[PostProcessor] = None,
                 decoder: Optional[Decoder] = None,
                 added_tokens: Sequence[AddedToken] = ()):
        self.model = model
        self.normalizer = normalizer
        self.pre_tokenizer = pre_tokenizer
        self.post_processor = post_processor
        self.decoder = decoder
        self._added: Dict[str, int] = {}  # content → id
        self._added_r: Dict[int, AddedToken] = {}
        self._special: set = set()
        self._special_list: List[AddedToken] = []
        self._plain_list: List[AddedToken] = []
        self.add_tokens(added_tokens)

    # -- loading ------------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_str(cls, text: str) -> "Tokenizer":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "Tokenizer":
        for key in ("truncation", "padding"):
            if obj.get(key) is not None:
                raise ValueError(f"unsupported tokenizer.json {key} setting {obj[key]!r}")
        norm = obj.get("normalizer")
        return cls(
            build_model(obj["model"]),
            normalizer=build_normalizer(norm),
            pre_tokenizer=build_pre_tokenizer(obj.get("pre_tokenizer"),
                                              inserts=_normalizer_inserts(norm)),
            post_processor=build_post_processor(obj.get("post_processor")),
            decoder=build_decoder(obj.get("decoder")),
            added_tokens=[AddedToken.from_dict(d) for d in obj.get("added_tokens") or ()],
        )

    # -- the added vocabulary -----------------------------------------------
    def add_tokens(self, tokens: Sequence[AddedToken]) -> None:
        """``AddedVocabulary::add_tokens``: a token the vocabulary has keeps
        its id; a new one takes the next id past the model's."""
        for t in tokens:
            if t.special and t.content and t.content not in self._special:
                self._special.add(t.content)
                self._special_list.append(t)
        size = self.model.get_vocab_size()
        for t in tokens:
            if not t.content or any(v.content == t.content for v in self._added_r.values()):
                continue
            tid = self.token_to_id(t.content)
            if tid is None:
                top = max(self._added.values(), default=None)
                tid = size if top is None else (top + 1 if top >= size or size == 0 else size)
            self._added[t.content] = tid
            self._added_r[tid] = t
            if t.content not in self._special:
                self._plain_list.append(t)
        self._refresh()

    def _refresh(self) -> None:
        raw, norm = [], []
        for t in self._special_list + self._plain_list:
            tid = self.token_to_id(t.content)
            tok = self._added_r.get(tid, t) if tid is not None else t
            if t.normalized:
                text = self.normalizer(t.content) if self.normalizer else t.content
                norm.append((text, tid, tok))
            else:
                raw.append((t.content, tid, tok))
        self._raw = _Matcher(raw)
        self._norm = _Matcher(norm)

    # -- encode / decode ------------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        model, pre, norm = self.model, self.pre_tokenizer, self.normalizer
        for piece, tid, at0 in self._raw.split(text, True):
            if tid is not None:
                ids.append(tid)
                continue
            if norm is not None:
                piece = norm(piece)
            for sub, sid, sub0 in self._norm.split(piece, at0):
                if sid is not None:
                    ids.append(sid)
                    continue
                for word, _ in (pre(sub, sub0) if pre is not None else [(sub, sub0)]):
                    ids.extend(model.tokenize(word))
        if add_special_tokens and self.post_processor is not None:
            ids = self.post_processor(ids)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            added = self._added_r.get(i)
            tok = added.content if added is not None else self.model.id_to_token(i)
            if tok is None or skip_special_tokens and tok in self._special:
                continue
            tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))

    # -- vocabulary -----------------------------------------------------------
    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._added.get(token)
        return tid if tid is not None else self.model.token_to_id(token)

    def get_vocab_size(self) -> int:
        """The model's tokens and the added ones, each text counted once."""
        return len(self.model.get_vocab().keys() | self._added.keys())
