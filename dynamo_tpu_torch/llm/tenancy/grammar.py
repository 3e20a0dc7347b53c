"""Grammar-constrained decoding: JSON schema / regex → token-mask automaton.

Reference semantics: Outlines (Willard & Louf, arXiv:2307.09702) — structured
generation reduces to a finite-state machine over the *token* vocabulary:
compile the constraint to a character-level DFA, then index every vocabulary
token against every reachable DFA state.  At decode time the engine holds one
integer (the automaton state) per constrained sequence, masks the logits with
the state's admissible-token set, and advances the state on each accepted
token — no per-step re-parsing, no device-side state, and the whole thing
rides the existing unified ragged program as a per-row logit mask
(ops/sampling.py).

Pipeline stages here (all host-side, all cached):

  JSON schema ──build_regex_from_schema──▶ regex (restricted syntax)
  regex ──parse──▶ AST ──Thompson──▶ NFA ──subset──▶ lazy char-DFA
  char-DFA × tokenizer ──token walk──▶ TokenMaskAutomaton

The ``TokenMaskAutomaton`` is plain data (per-state token→next edges +
accepting flags), so the PREPROCESSOR — the only layer holding the tokenizer
— compiles it once per (constraint, tokenizer) and ships it inside the
``PreprocessedRequest``; engines (possibly in another process, holding no
tokenizer) just walk integers.  EOS handling is the engine's: EOS is
admissible exactly in accepting states (the engine knows the model's eos ids;
the automaton only flags which states accept).

Canonical whitespace: generated regexes allow optional blanks around JSON
structural characters, so models keep their natural " " after ':' and ','.

Cost shape: indexing is O(states × vocab × token_len) once per constraint —
sub-millisecond for test vocabularies, seconds for 128k-token vocabularies,
which is why the compile cache (preprocessor) and the automaton cache
(engine, by content hash) both exist.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

# Hard cap on token-automaton states: a runaway schema must fail loudly at
# compile time, never OOM the preprocessor.
MAX_STATES = 4096


class GrammarError(ValueError):
    """Unsupported/invalid constraint (maps to HTTP 400 at the edge)."""


class GrammarCacheMissError(ValueError):
    """A hash-only grammar stub missed the engine's content-hash LRU.

    Not a request error in the usual sense: the DISPATCHER (preprocessor)
    owns the full automaton and re-sends it on this signal.  ``error_kind``
    rides the service-plane prologue so the remote flavour surfaces as a
    non-retryable ``RemoteEngineError(kind="grammar_miss")`` — replaying
    the stub on other workers would just collect more misses."""

    error_kind = "grammar_miss"

    def __init__(self, content_hash: str):
        super().__init__(
            f"grammar {content_hash!r} not in engine cache; resend full table"
        )
        self.content_hash = content_hash


# --------------------------------------------------------------------------
# Restricted regex syntax: literals, escapes, [...] classes (ranges,
# negation), ( ) grouping, |, *, +, ?, {m}, {m,n}, {m,}.  This is the syntax
# build_regex_from_schema emits; user-supplied nvext.grammar regexes are held
# to the same subset.
# --------------------------------------------------------------------------

_ESCAPES = {
    "n": "\n",
    "t": "\t",
    "r": "\r",
    "f": "\f",
    "b": "\b",
    "0": "\0",
}

# Perl-style shorthand classes usable both inline and inside [...].
_SHORTHAND = {
    "d": frozenset("0123456789"),
    "s": frozenset(" \t\n\r\f"),
    "w": frozenset(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
    ),
}

# AST nodes: ("lit", chars, negated) | ("cat", [n]) | ("alt", [n]) |
# ("star", n) | ("plus", n) | ("opt", n)


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> GrammarError:
        return GrammarError(f"regex error at {self.i}: {msg} in {self.p!r}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise self.error("unbalanced ')'")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self.peek() == "|":
            self.next()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts: List[Any] = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self._repeat())
        return ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.next()
                node = ("star", node)
            elif ch == "+":
                self.next()
                node = ("plus", node)
            elif ch == "?":
                self.next()
                node = ("opt", node)
            elif ch == "{":
                node = self._bounded(node)
            else:
                return node

    def _bounded(self, node):
        self.next()  # '{'
        spec = ""
        while self.peek() is not None and self.peek() != "}":
            spec += self.next()
        if self.peek() != "}":
            raise self.error("unterminated {m,n}")
        self.next()
        parts = spec.split(",")
        try:
            lo = int(parts[0])
            hi = int(parts[1]) if len(parts) > 1 and parts[1] else (
                lo if len(parts) == 1 else None
            )
        except ValueError as e:
            raise self.error(f"bad repetition {spec!r}") from e
        if lo < 0 or (hi is not None and hi < lo):
            raise self.error(f"bad repetition bounds {spec!r}")
        # {m,n} → m copies + (n-m) optionals; {m,} → m copies + star.
        out: List[Any] = [node] * lo
        if hi is None:
            out.append(("star", node))
        else:
            out.extend(("opt", node) for _ in range(hi - lo))
        return ("cat", out)

    def _atom(self):
        ch = self.next()
        if ch == "(":
            node = self._alt()
            if self.peek() != ")":
                raise self.error("unterminated group")
            self.next()
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            return ("lit", frozenset("\n"), True)  # any char but newline
        if ch == "\\":
            return self._escape(in_class=False)
        if ch in "*+?{":
            raise self.error(f"dangling quantifier {ch!r}")
        return ("lit", frozenset(ch), False)

    def _escape(self, in_class: bool):
        if self.peek() is None:
            raise self.error("dangling backslash")
        ch = self.next()
        if ch in _SHORTHAND:
            return ("lit", _SHORTHAND[ch], False)
        if ch.isupper() and ch.lower() in _SHORTHAND:
            return ("lit", _SHORTHAND[ch.lower()], True)
        return ("lit", frozenset(_ESCAPES.get(ch, ch)), False)

    def _char_class(self):
        negated = False
        if self.peek() == "^":
            self.next()
            negated = True
        chars: set = set()
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise self.error("unterminated character class")
            if ch == "]" and not first:
                self.next()
                return ("lit", frozenset(chars), negated)
            first = False
            self.next()
            if ch == "\\":
                lit = self._escape(in_class=True)
                if lit[2]:
                    raise self.error("negated shorthand inside class")
                chars |= lit[1]
                continue
            if self.peek() == "-" and self.i + 1 < len(self.p) and (
                self.p[self.i + 1] != "]"
            ):
                self.next()  # '-'
                hi = self.next()
                if hi == "\\":
                    hi_lit = self._escape(in_class=True)
                    (hi,) = hi_lit[1]
                if ord(hi) < ord(ch):
                    raise self.error(f"bad range {ch}-{hi}")
                chars |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
            else:
                chars.add(ch)


# --------------------------------------------------------------------------
# Thompson NFA + lazy subset-construction DFA
# --------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        # per state: [(chars, negated, target)], [eps targets]
        self.trans: List[List[Tuple[FrozenSet[str], bool, int]]] = []
        self.eps: List[List[int]] = []

    def state(self) -> int:
        self.trans.append([])
        self.eps.append([])
        return len(self.trans) - 1

    def build(self, node) -> Tuple[int, int]:
        kind = node[0]
        if kind == "lit":
            s, a = self.state(), self.state()
            self.trans[s].append((node[1], node[2], a))
            return s, a
        if kind == "cat":
            if not node[1]:
                s = self.state()
                return s, s
            start, acc = self.build(node[1][0])
            for part in node[1][1:]:
                s2, a2 = self.build(part)
                self.eps[acc].append(s2)
                acc = a2
            return start, acc
        if kind == "alt":
            s, a = self.state(), self.state()
            for branch in node[1]:
                bs, ba = self.build(branch)
                self.eps[s].append(bs)
                self.eps[ba].append(a)
            return s, a
        if kind == "star":
            s, a = self.state(), self.state()
            bs, ba = self.build(node[1])
            self.eps[s] += [bs, a]
            self.eps[ba] += [bs, a]
            return s, a
        if kind == "plus":
            bs, ba = self.build(node[1])
            s, a = self.state(), self.state()
            self.eps[s].append(bs)
            self.eps[ba] += [bs, a]
            return s, a
        if kind == "opt":
            s, a = self.state(), self.state()
            bs, ba = self.build(node[1])
            self.eps[s] += [bs, a]
            self.eps[ba].append(a)
            return s, a
        raise GrammarError(f"unknown AST node {kind!r}")


class _CharDFA:
    """Lazy subset-construction DFA over the NFA (states = frozensets)."""

    def __init__(self, pattern: str):
        nfa = _NFA()
        start, accept = nfa.build(_Parser(pattern).parse())
        self._nfa = nfa
        self._accept = accept
        self.start = self._closure(frozenset([start]))
        self._move_memo: Dict[Tuple[FrozenSet[int], str], Optional[FrozenSet[int]]] = {}

    def _closure(self, states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in self._nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    def move(self, states: FrozenSet[int], ch: str) -> Optional[FrozenSet[int]]:
        key = (states, ch)
        hit = self._move_memo.get(key, _MISS)
        if hit is not _MISS:
            return hit
        targets = {
            t
            for s in states
            for chars, negated, t in self._nfa.trans[s]
            if (ch in chars) != negated
        }
        out = self._closure(frozenset(targets)) if targets else None
        self._move_memo[key] = out
        return out

    def walk(self, states: FrozenSet[int], text: str) -> Optional[FrozenSet[int]]:
        for ch in text:
            states = self.move(states, ch)
            if states is None:
                return None
        return states

    def accepting(self, states: FrozenSet[int]) -> bool:
        return self._accept in states


_MISS = object()


# --------------------------------------------------------------------------
# Token-level automaton (the serializable artifact the engine consumes)
# --------------------------------------------------------------------------


class TokenMaskAutomaton:
    """Per-state admissible-token sets + transitions over TOKEN ids.

    ``edges[state]`` maps token id → next state; ``accepting`` states may end
    the value (EOS admissible there — the ENGINE adds the model's eos ids to
    accepting states' masks, since the automaton is tokenizer-level data and
    the model's eos ids are engine knowledge).  A state with no outgoing
    edges is *terminal*: the constrained value is complete and only EOS can
    follow (the engine finishes the stream).
    """

    def __init__(
        self,
        start: int,
        edges: List[Dict[int, int]],
        accepting: Sequence[int],
        content_hash: Optional[str] = None,
    ):
        self.start = start
        self.edges = edges
        self.accepting = frozenset(accepting)
        self.hash = content_hash or self._compute_hash()
        # Engine-side packed-mask cache (set_mask_context fixes vocab/eos).
        self._vocab: Optional[int] = None
        self._eos_ids: Tuple[int, ...] = ()
        self._packed: Dict[int, np.ndarray] = {}
        # Wire-form cache: edges are immutable after construction and
        # serializing them is O(total edges log edges) — per-request callers
        # (preprocessor) must not pay that on every compile-cache hit.
        self._wire: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- identity
    def _compute_hash(self) -> str:
        payload = json.dumps(
            {
                "start": self.start,
                "edges": [sorted(e.items()) for e in self.edges],
                "accepting": sorted(self.accepting),
            },
            separators=(",", ":"),
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    # ------------------------------------------------------------ traversal
    def advance(self, state: int, token_id: int) -> Optional[int]:
        """Next state after ``token_id``, or None if inadmissible."""
        if not 0 <= state < len(self.edges):
            return None
        return self.edges[state].get(token_id)

    def is_accepting(self, state: int) -> bool:
        return state in self.accepting

    def is_terminal(self, state: int) -> bool:
        """Complete: no token may follow (only EOS).  Requires ACCEPTING —
        compile-time pruning removes non-accepting dead ends, but a
        hand-built or corrupted automaton must not let one end a stream
        as a clean stop."""
        return (
            0 <= state < len(self.edges)
            and not self.edges[state]
            and state in self.accepting
        )

    def allowed(self, state: int) -> Sequence[int]:
        return list(self.edges[state].keys()) if 0 <= state < len(self.edges) else []

    # ------------------------------------------------------- engine masking
    def set_mask_context(self, vocab_size: int, eos_ids: Sequence[int]) -> None:
        """Fix the packed-mask geometry (per engine); resets the cache when
        it changes (same automaton dict can serve engines with different
        vocab/eos)."""
        ctx = (vocab_size, tuple(sorted(eos_ids)))
        if (self._vocab, self._eos_ids) != ctx:
            self._vocab, self._eos_ids = ctx
            self._packed = {}

    def packed_mask(self, state: int) -> np.ndarray:
        """uint32[ceil(vocab/32)] bitmask of admissible tokens at ``state``
        (bit i of word i//32 = token i admissible); EOS bits set in
        accepting states.  Cached per state."""
        if self._vocab is None:
            raise RuntimeError("set_mask_context before packed_mask")
        cached = self._packed.get(state)
        if cached is not None:
            return cached
        V = self._vocab
        words = np.zeros(((V + 31) // 32,), np.uint32)
        ids = [t for t in self.allowed(state) if 0 <= t < V]
        if self.is_accepting(state):
            ids += [e for e in self._eos_ids if 0 <= e < V]
        if ids:
            arr = np.asarray(ids, np.int64)
            np.bitwise_or.at(
                words, arr // 32, (np.uint32(1) << (arr % 32).astype(np.uint32))
            )
        self._packed[state] = words
        return words

    # ---------------------------------------------------------------- wire
    def to_dict(self) -> Dict[str, Any]:
        if self._wire is None:
            self._wire = {
                "start": self.start,
                "edges": [sorted(e.items()) for e in self.edges],
                "accepting": sorted(self.accepting),
                "hash": self.hash,
            }
        return self._wire

    def wire_stub(self) -> Dict[str, Any]:
        """Hash-only wire form (content-addressed dispatch): engines whose
        LRU already holds this automaton resolve it from the hash alone —
        the full edge table (KBs per constrained request on real vocabs)
        ships only after an explicit ``GrammarCacheMissError`` round trip
        (the preprocessor's fallback)."""
        return {"hash": self.hash, "stub": True}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TokenMaskAutomaton":
        edges = [
            {int(t): int(n) for t, n in state_edges}
            for state_edges in d.get("edges", [])
        ]
        return cls(
            start=int(d.get("start", 0)),
            edges=edges,
            accepting=[int(s) for s in d.get("accepting", [])],
            content_hash=d.get("hash"),
        )


def _token_strings(tokenizer) -> Dict[int, str]:
    """Content tokens only: id → the piece as a stream renders it.  Special
    tokens (bos/eos/pad/role markers) and empty pieces are excluded — a
    special token's surface text ("<eos>") must never satisfy a grammar's
    string class.  A tokenizer with ``decode_window`` (sentencepiece) is
    asked for the mid-stream form: decoding a "▁word" piece alone strips
    the dummy-prefix space, so it would index as "word" while the stream
    renders " word" and the output leaves its language."""
    win = getattr(tokenizer, "decode_window", None)
    out: Dict[int, str] = {}
    for i in range(tokenizer.vocab_size):
        if win is not None:
            s = win([i], skip_special_tokens=True, sequence_start=False)
        else:
            s = tokenizer.decode([i], skip_special_tokens=True)
        if s:
            out[i] = s
    return out


def compile_token_automaton(
    pattern: str,
    tokenizer,
    max_states: int = MAX_STATES,
    token_strings: Optional[Dict[int, str]] = None,
) -> TokenMaskAutomaton:
    """Index the whole vocabulary against the pattern's char-DFA (module
    docstring stage 3).  States are discovered breadth-first from the start
    state through token transitions; each reachable state's edge map is the
    per-state token mask the engine applies.  ``token_strings`` lets callers
    with a pinned tokenizer (GrammarCompiler) decode the vocabulary once."""
    dfa = _CharDFA(pattern)
    vocab = token_strings if token_strings is not None else _token_strings(tokenizer)
    id_of: Dict[FrozenSet[int], int] = {dfa.start: 0}
    order: List[FrozenSet[int]] = [dfa.start]
    edges: List[Dict[int, int]] = [{}]
    accepting: List[int] = []
    if dfa.accepting(dfa.start):
        accepting.append(0)
    from collections import deque as _deque

    queue = _deque([dfa.start])
    while queue:
        cur = queue.popleft()
        cur_id = id_of[cur]
        for tok, text in vocab.items():
            nxt = dfa.walk(cur, text)
            if nxt is None:
                continue
            nid = id_of.get(nxt)
            if nid is None:
                nid = id_of[nxt] = len(order)
                if nid >= max_states:
                    raise GrammarError(
                        f"grammar exceeds {max_states} token-automaton states"
                    )
                order.append(nxt)
                edges.append({})
                if dfa.accepting(nxt):
                    accepting.append(nid)
                queue.append(nxt)
            edges[cur_id][tok] = nid
    # Prune dead ends: a token edge into a state from which NO accepting
    # state is reachable (over token transitions) must not be admissible —
    # the vocabulary may lack the pieces a char-path needs (special tokens
    # and undecodable ids are excluded from indexing), and following such
    # an edge would strand the stream in an uncompletable value.
    live = set(accepting)
    changed = True
    while changed:
        changed = False
        for sid, e in enumerate(edges):
            if sid not in live and any(t in live for t in e.values()):
                live.add(sid)
                changed = True
    if 0 not in live:
        raise GrammarError(
            "grammar is unsatisfiable over this vocabulary: no token "
            "sequence can complete the constrained value"
        )
    edges = [
        {tok: nxt for tok, nxt in e.items() if nxt in live} for e in edges
    ]
    return TokenMaskAutomaton(0, edges, accepting)


# --------------------------------------------------------------------------
# JSON schema → regex
# --------------------------------------------------------------------------

_WS = "[ \t\n\r]*"
# RFC 8259: control characters (U+0000–U+001F) MUST be escaped inside JSON
# strings — excluding them from the unescaped-char class keeps "guaranteed
# valid" output actually json.loads-able (a raw newline in a mask-admissible
# token would otherwise end a clean STOP with unparseable JSON).
_JSON_CONTROL = "".join(chr(c) for c in range(0x20))
_STRING_INNER = (
    '([^"\\\\' + _JSON_CONTROL + ']|\\\\["\\\\/bfnrt]|\\\\u[0-9a-fA-F]{4})*'
)
_STRING = '"' + _STRING_INNER + '"'
_INTEGER = "-?(0|[1-9][0-9]*)"
_NUMBER = _INTEGER + "(\\.[0-9]+)?([eE][+-]?[0-9]+)?"
_BOOLEAN = "(true|false)"
_NULL = "null"

_RE_META = set("\\^$.|?*+()[]{}-")


def _re_escape(text: str) -> str:
    return "".join("\\" + c if c in _RE_META else c for c in text)


def _literal_regex(value: Any) -> str:
    """Regex matching exactly one JSON literal (enum/const values)."""
    return _re_escape(json.dumps(value, separators=(",", ":")))


def build_regex_from_schema(schema: Dict[str, Any], depth: int = 6) -> str:
    """JSON schema (subset) → regex over the value's serialized form.

    Supported: type object (properties serialized in declaration order, all
    emitted — optional-property subsets would blow the regex up
    combinatorially), array (items, minItems/maxItems), string (enum,
    minLength/maxLength unsupported), integer, number, boolean, null,
    enum/const at any level, anyOf/oneOf (alternation), nested to ``depth``.
    Free-form nesting ({} / json_object mode) is depth-bounded: beyond
    ``depth`` only scalar values are admitted.
    """
    if depth < 0:
        raise GrammarError("schema nesting exceeds the supported depth")
    if not isinstance(schema, dict):
        raise GrammarError(f"schema must be an object, got {type(schema).__name__}")
    if "const" in schema:
        return _literal_regex(schema["const"])
    if "enum" in schema:
        opts = schema["enum"]
        if not opts:
            raise GrammarError("empty enum")
        return "(" + "|".join(_literal_regex(v) for v in opts) + ")"
    for key in ("anyOf", "oneOf"):
        if key in schema:
            branches = schema[key]
            if not branches:
                raise GrammarError(f"empty {key}")
            return (
                "("
                + "|".join(
                    build_regex_from_schema(b, depth - 1) for b in branches
                )
                + ")"
            )
    t = schema.get("type")
    if isinstance(t, list):
        return "(" + "|".join(
            build_regex_from_schema({**schema, "type": one}, depth) for one in t
        ) + ")"
    if t == "string":
        return _STRING
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return _BOOLEAN
    if t == "null":
        return _NULL
    if t == "array":
        items = schema.get("items")
        item_re = (
            build_regex_from_schema(items, depth - 1)
            if isinstance(items, dict)
            else _any_value_regex(depth - 1)
        )
        min_items = int(schema.get("minItems", 0))
        max_items = schema.get("maxItems")
        one = item_re
        sep = _WS + "," + _WS
        if max_items is not None:
            max_items = int(max_items)
            if max_items < min_items:
                raise GrammarError("maxItems < minItems")
            if max_items == 0:
                body = ""
            else:
                reps = "(" + sep + one + "){%d,%d}" % (
                    max(0, min_items - 1),
                    max_items - 1,
                )
                body = one + reps
                if min_items == 0:
                    body = "(" + body + ")?"
        else:
            reps = "(" + sep + one + ")" + (
                "{%d,}" % (min_items - 1) if min_items > 1 else "*"
            )
            body = one + reps
            if min_items == 0:
                body = "(" + body + ")?"
        return "\\[" + _WS + body + _WS + "\\]"
    if t == "object" and schema.get("properties"):
        props = schema["properties"]
        parts = []
        for name, sub in props.items():
            parts.append(
                _re_escape(json.dumps(name))
                + _WS
                + ":"
                + _WS
                + build_regex_from_schema(sub, depth - 1)
            )
        sep = _WS + "," + _WS
        return "\\{" + _WS + sep.join(parts) + _WS + "\\}"
    if t == "object":
        # Free-form OBJECT (json_object mode / no properties): the top
        # level must still be an object — only the property VALUES are
        # generic JSON.  The generic grammar duplicates the value regex
        # ~4x per level, so its depth is capped harder than structured
        # schemas (which grow linearly).
        return _any_object_regex(min(depth, 2))
    if schema == {} or t is None:
        # Free-form VALUE: any bounded-depth JSON.
        return _any_value_regex(min(depth, 2))
    raise GrammarError(f"unsupported schema: {json.dumps(schema)[:120]}")


def _any_object_regex(depth: int) -> str:
    """Generic JSON OBJECT grammar: `{...}` at the top level, generic
    values (nesting bounded at ``depth``) inside."""
    value = _any_value_regex(max(0, depth))
    member = _STRING + _WS + ":" + _WS + value
    return (
        "\\{" + _WS + "(" + member
        + "(" + _WS + "," + _WS + member + ")*)?" + _WS + "\\}"
    )


def _any_value_regex(depth: int) -> str:
    """Generic JSON value grammar, nesting bounded at ``depth``."""
    scalar = "(" + "|".join((_STRING, _NUMBER, _BOOLEAN, _NULL)) + ")"
    value = scalar
    for _ in range(max(0, depth)):
        arr = "\\[" + _WS + "(" + value + "(" + _WS + "," + _WS + value + ")*)?" + _WS + "\\]"
        obj = (
            "\\{" + _WS + "(" + _STRING + _WS + ":" + _WS + value
            + "(" + _WS + "," + _WS + _STRING + _WS + ":" + _WS + value + ")*)?"
            + _WS + "\\}"
        )
        value = "(" + "|".join((scalar, arr, obj)) + ")"
    return value


# --------------------------------------------------------------------------
# Front door: constraint spec → automaton (with compile caching)
# --------------------------------------------------------------------------


def constraint_spec(
    response_format: Optional[Dict[str, Any]], nvext_grammar: Any
) -> Optional[Dict[str, Any]]:
    """Normalize the two request surfaces into one constraint spec dict:
    ``{"kind": "json_schema"|"json_object"|"regex", ...}``; None = no
    constraint.  ``nvext.grammar`` accepts a regex string or a JSON schema
    dict; ``response_format`` follows the OpenAI shape."""
    if nvext_grammar is not None:
        if isinstance(nvext_grammar, str):
            return {"kind": "regex", "pattern": nvext_grammar}
        if isinstance(nvext_grammar, dict):
            return {"kind": "json_schema", "schema": nvext_grammar}
        raise GrammarError("nvext.grammar must be a regex string or a schema")
    if not response_format:
        return None
    kind = response_format.get("type")
    if kind in (None, "text"):
        return None
    if kind == "json_object":
        return {"kind": "json_object"}
    if kind == "json_schema":
        js = response_format.get("json_schema") or {}
        schema = js.get("schema", js if "type" in js or "enum" in js else None)
        if not isinstance(schema, dict):
            raise GrammarError("response_format.json_schema.schema missing")
        return {"kind": "json_schema", "schema": schema}
    raise GrammarError(f"unsupported response_format type {kind!r}")


def spec_regex(spec: Dict[str, Any]) -> str:
    kind = spec.get("kind")
    if kind == "regex":
        return spec["pattern"]
    if kind == "json_object":
        return build_regex_from_schema({"type": "object"})
    if kind == "json_schema":
        return build_regex_from_schema(spec["schema"])
    raise GrammarError(f"unknown constraint kind {kind!r}")


class GrammarCompiler:
    """Spec → TokenMaskAutomaton with an LRU compile cache.

    One instance per preprocessor (the tokenizer is fixed); the cache key is
    the canonical spec JSON.  Compilation is the expensive step (token
    indexing) — repeated agent/tool-calling traffic reuses the entry."""

    def __init__(self, tokenizer, max_entries: int = 64):
        import threading

        self._tokenizer = tokenizer
        self._max = max_entries
        self._cache: Dict[str, TokenMaskAutomaton] = {}
        # compile() may run off the event loop (preprocessor offloads cache
        # misses to a thread); the lock keeps the shared LRU coherent and
        # collapses concurrent same-spec compiles into one.
        self._lock = threading.Lock()
        # id → decoded piece, computed once per tokenizer: vocabulary
        # decoding costs as much as the DFA walk and is identical across
        # every constraint this compiler ever sees.
        self._token_strings: Optional[Dict[int, str]] = None
        self.compiles = 0
        self.hits = 0

    def compile(self, spec: Dict[str, Any]) -> TokenMaskAutomaton:
        key = json.dumps(spec, sort_keys=True, separators=(",", ":"))
        with self._lock:
            cached = self._cache.pop(key, None)
            if cached is not None:
                self._cache[key] = cached  # LRU refresh
                self.hits += 1
                return cached
            if self._token_strings is None:
                self._token_strings = _token_strings(self._tokenizer)
            automaton = compile_token_automaton(
                spec_regex(spec), self._tokenizer,
                token_strings=self._token_strings,
            )
            self.compiles += 1
            self._cache[key] = automaton
            while len(self._cache) > self._max:
                self._cache.pop(next(iter(self._cache)))
            return automaton
