"""Minimal sentencepiece runtime: parse ``tokenizer.model`` directly and
tokenize with it — no sentencepiece/protobuf dependency.

A copy of the JAX package's ``llm/sp.py`` (pure Python), ids for ids.  Like
the JAX module it does not run ``NormalizerSpec`` normalization; where that
would change a text (``remove_extra_whitespaces``, on unless the proto turns
it off: leading, trailing or repeated spaces) the encode logs it, once a
model at warning level and then at debug level, and tokenizes as the JAX
module does.

Reference counterpart: ``lib/llm/src/tokenizers/sp.rs`` (the reference
serves tokenizer.model-only checkpoints — older Llama/Mistral releases —
natively).  The .model file is a protobuf ``ModelProto``; the subset that
matters for inference is tiny and stable, so this module walks the wire
format directly:

  ModelProto:    field 1 repeated SentencePiece, field 2 TrainerSpec,
                 field 3 NormalizerSpec
  SentencePiece: field 1 piece (string), field 2 score (float),
                 field 3 type (1=NORMAL 2=UNKNOWN 3=CONTROL 4=USER_DEFINED
                 5=UNUSED 6=BYTE)
  TrainerSpec:   field 3 model_type (1=UNIGRAM 2=BPE), fields 40-42,45
                 unk/bos/eos/pad ids
  NormalizerSpec: field 2 precompiled_charsmap, field 3 add_dummy_prefix,
                 field 5 escape_whitespaces

Models whose NormalizerSpec carries a non-empty ``precompiled_charsmap``
(an NFKC-style normalization automaton this module does not execute) or
``escape_whitespaces=false`` (spaces are NOT ▁-escaped) are REFUSED at
parse time rather than silently mis-tokenized — serving a model through
the wrong normalizer corrupts every prompt.

Encoding implements both algorithms over the piece vocabulary:
- **unigram**: Viterbi segmentation maximizing the sum of piece scores;
- **BPE**: greedy highest-score adjacent merge (sentencepiece BPE stores
  merge priority as the piece score).
Unknown characters fall back to BYTE pieces (``<0xNN>``) when the model
ships them, else the unk id.  Decode maps BYTE pieces back to raw bytes
and ``▁`` to space, dropping control pieces — byte-exact round trips for
text the model covers.
"""

from __future__ import annotations

import logging
import re
import struct
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# What sentencepiece's remove_extra_whitespaces would rewrite.
_EXTRA_WS = re.compile(r"^ | $|  ")

WS = "▁"  # ▁ sentencepiece whitespace marker

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def _walk(buf: bytes, pos: int, end: int):
    """Yield (field_number, wire_type, value, new_pos) over a message."""
    while pos < end:
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _varint(buf, pos)
        elif wire == 1:  # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:  # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val, pos


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


class SentencePieceModel:
    """Parsed tokenizer.model: vocabulary, scores, and the two encoders."""

    def __init__(self, blob: bytes):
        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        self.model_type = 1  # UNIGRAM default
        self.unk_id, self.bos_id, self.eos_id = 0, 1, 2
        self.add_dummy_prefix = True
        self.escape_whitespaces = True
        self.precompiled_charsmap = b""
        self.remove_extra_whitespaces = True  # the proto's default
        self._warned_normalizer = False
        for field, wire, val, _ in _walk(blob, 0, len(blob)):
            if field == 1 and wire == 2:  # SentencePiece
                piece, score, typ = "", 0.0, NORMAL
                for f2, w2, v2, _ in _walk(val, 0, len(val)):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        typ = v2
                self.pieces.append(piece)
                self.scores.append(score)
                self.types.append(typ)
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2, _ in _walk(val, 0, len(val)):
                    if f2 == 3 and w2 == 0:
                        self.model_type = v2
                    elif f2 == 40 and w2 == 0:
                        self.unk_id = v2
                    elif f2 == 41 and w2 == 0:
                        self.bos_id = v2
                    elif f2 == 42 and w2 == 0:
                        self.eos_id = v2
            elif field == 3 and wire == 2:  # NormalizerSpec
                for f2, w2, v2, _ in _walk(val, 0, len(val)):
                    if f2 == 2 and w2 == 2:
                        self.precompiled_charsmap = v2
                    elif f2 == 3 and w2 == 0:
                        self.add_dummy_prefix = bool(v2)
                    elif f2 == 4 and w2 == 0:
                        self.remove_extra_whitespaces = bool(v2)
                    elif f2 == 5 and w2 == 0:
                        self.escape_whitespaces = bool(v2)
        if not self.pieces:
            raise ValueError("tokenizer.model contains no sentencepiece vocab")
        if self.precompiled_charsmap:
            # e.g. T5/ALBERT-style NFKC models.  Tokenizing without running
            # the automaton silently diverges from the training-time
            # normalization; refuse rather than serve a wrong tokenizer.
            raise ValueError(
                "tokenizer.model carries a non-empty NormalizerSpec."
                "precompiled_charsmap (normalization automaton) which this "
                "parser does not execute — refusing to mis-tokenize; use a "
                "tokenizer.json for this model instead"
            )
        if not self.escape_whitespaces:
            raise ValueError(
                "tokenizer.model sets NormalizerSpec.escape_whitespaces="
                "false; this parser assumes ▁-escaped whitespace — "
                "refusing to mis-tokenize"
            )
        self.index: Dict[str, int] = {p: i for i, p in enumerate(self.pieces)}
        self._byte_ids: Dict[int, int] = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                self._byte_ids[int(p[3:5], 16)] = i
        self._max_piece_len = max(len(p) for p in self.pieces)
        # Special tokens matched as literal spans BEFORE segmentation —
        # chat templates interpolate "<s>"/"</s>"/"[INST]"-style control
        # and user-defined pieces as text, and those must become their ids,
        # never character pieces (HF's AddedVocabulary role).
        specials = [
            p for p, t in zip(self.pieces, self.types)
            if t in (CONTROL, USER_DEFINED) and p
        ]
        self._special_re = (
            re.compile("|".join(re.escape(p) for p in
                                sorted(specials, key=len, reverse=True)))
            if specials else None
        )

    # ----------------------------------------------------------- encoding
    def encode(self, text: str) -> List[int]:
        """Text → ids.  Control/user-defined pieces appearing literally in
        the text (chat-template markers) map straight to their ids; the
        spans between them segment per model_type, each with the model's
        dummy-prefix rule (matching sentencepiece's per-call prefix — the
        HF slow-tokenizer "legacy" behavior older checkpoints trained
        with)."""
        if not text:
            return []
        ids: List[int] = []
        pos = 0
        spans: List[Tuple[Optional[int], str]] = []
        if self._special_re is not None:
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    spans.append((None, text[pos:m.start()]))
                spans.append((self.index[m.group()], ""))
                pos = m.end()
        if pos < len(text):
            spans.append((None, text[pos:]))
        for special_id, chunk in spans:
            if special_id is not None:
                ids.append(special_id)
                continue
            if self.remove_extra_whitespaces:
                self._note_unnormalized(text, chunk)
            norm = chunk.replace(" ", WS)
            if self.add_dummy_prefix and not norm.startswith(WS):
                norm = WS + norm
            ids.extend(
                self._encode_bpe(norm) if self.model_type == 2
                else self._encode_unigram(norm)
            )
        return ids

    def _note_unnormalized(self, text: str, chunk: str) -> None:
        """Log where sentencepiece's whitespace normalization, which this
        module does not run, would have changed ``chunk``."""
        m = _EXTRA_WS.search(chunk)
        if m is None:
            return
        level = logging.DEBUG if self._warned_normalizer else logging.WARNING
        self._warned_normalizer = True
        logger.log(
            level,
            "sentencepiece NormalizerSpec.remove_extra_whitespaces is not applied: "
            "the span %r (at %d of a %d-char text) keeps its extra spaces, where "
            "sentencepiece would collapse them and give other ids",
            chunk[max(0, m.start() - 8): m.end() + 8], text.find(chunk) + m.start(), len(text),
        )

    def _char_fallback(self, ch: str) -> List[int]:
        ids = []
        for b in ch.encode("utf-8"):
            bid = self._byte_ids.get(b)
            if bid is None:
                return [self.unk_id]
            ids.append(bid)
        return ids

    def _encode_unigram(self, norm: str) -> List[int]:
        """Viterbi over piece scores (ties break toward longer pieces via
        traversal order, matching sentencepiece's lattice best-path)."""
        n = len(norm)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                pid = self.index.get(norm[i:j])
                if pid is None or self.types[pid] in (CONTROL, UNUSED):
                    continue
                s = best[i] + self.scores[pid]
                if s > best[j]:
                    best[j], back[j] = s, (i, pid)
            if best[i + 1] == NEG:  # no piece covers norm[i]: byte fallback
                best[i + 1], back[i + 1] = best[i] - 100.0, (i, None)
        ids: List[int] = []
        spans: List[Tuple[int, int, Optional[int]]] = []
        j = n
        while j > 0:
            i, pid = back[j]
            spans.append((i, j, pid))
            j = i
        for i, j, pid in reversed(spans):
            ids.extend(self._char_fallback(norm[i:j]) if pid is None else [pid])
        return ids

    def _encode_bpe(self, norm: str) -> List[int]:
        """Greedy merges: repeatedly join the adjacent pair whose merged
        piece has the highest score (sentencepiece BPE merge priority).

        Heap + doubly-linked symbol list → O(n log n): this is the
        production encode path for Llama-2/Mistral tokenizer.model files
        (model_type=BPE), so prefill-length prompts must not pay a
        rescan-all-pairs O(n^2)."""
        import heapq

        n = len(norm)
        if n == 0:
            return []
        sym: List[Optional[str]] = list(norm)  # None = absorbed slot
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))  # n = end sentinel
        heap: List[Tuple[float, int, int, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j >= n or sym[i] is None or sym[j] is None:
                return
            merged = sym[i] + sym[j]
            pid = self.index.get(merged)
            if pid is not None:
                # (-score, left position): highest score first, leftmost on
                # ties — sentencepiece's merge order.
                heapq.heappush(heap, (-self.scores[pid], i, j, merged))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, j, merged = heapq.heappop(heap)
            # Stale entries: either slot absorbed, or no longer adjacent,
            # or the strings changed since this pair was pushed.
            if sym[i] is None or sym[j] is None or nxt[i] != j:
                continue
            if sym[i] + sym[j] != merged:
                continue
            sym[i] = merged
            sym[j] = None
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prev[nxt[j]] = i
            push(i)
            if prev[i] >= 0:
                push(prev[i])
        ids: List[int] = []
        i = 0  # slot 0 is always live (merges keep their left index)
        while i < n:
            s = sym[i]
            pid = self.index.get(s)
            if pid is None or self.types[pid] in (CONTROL, UNUSED):
                ids.extend(self._char_fallback(s))
            else:
                ids.append(pid)
            i = nxt[i]
        return ids

    # ----------------------------------------------------------- decoding
    def decode(self, ids: List[int], sequence_start: bool = True) -> str:
        """Ids → text: BYTE pieces concatenate to raw bytes, ▁ → space,
        control pieces dropped.  ``sequence_start`` governs the
        dummy-prefix strip: only a window that begins the sequence drops
        its leading space — incremental detokenizers decode mid-stream
        windows with ``sequence_start=False`` so inter-token spaces
        survive the prefix-diff (llm/tokenizer.DecodeStream)."""
        out: List[str] = []
        pending: List[int] = []  # byte-piece run

        def flush():
            if pending:
                out.append(bytes(pending).decode("utf-8", errors="replace"))
                pending.clear()

        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue
            t = self.types[i]
            if t == BYTE:
                pending.append(int(self.pieces[i][3:5], 16))
                continue
            flush()
            if t in (CONTROL, UNKNOWN):
                continue
            out.append(self.pieces[i].replace(WS, " "))
        flush()
        text = "".join(out)
        if sequence_start and self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i]

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls(f.read())


# ------------------------------------------------------------------ writer
def build_model_proto(
    pieces: List[Tuple[str, float, int]],
    *,
    model_type: int = 1,
    add_dummy_prefix: bool = True,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    escape_whitespaces: bool = True,
    precompiled_charsmap: bytes = b"",
) -> bytes:
    """Serialize a minimal ModelProto — the test-fixture writer (building a
    real .model without the sentencepiece library), kept next to the parser
    so the two stay in sync with the same field map."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    def field(num: int, wire: int, payload: bytes) -> bytes:
        return varint((num << 3) | wire) + payload

    blob = b""
    for piece, score, typ in pieces:
        sp = field(1, 2, varint(len(piece.encode())) + piece.encode())
        sp += field(2, 5, struct.pack("<f", score))
        sp += field(3, 0, varint(typ))
        blob += field(1, 2, varint(len(sp)) + sp)
    trainer = (
        field(3, 0, varint(model_type))
        + field(40, 0, varint(unk_id))
        + field(41, 0, varint(bos_id))
        + field(42, 0, varint(eos_id))
    )
    blob += field(2, 2, varint(len(trainer)) + trainer)
    norm = field(3, 0, varint(1 if add_dummy_prefix else 0))
    norm += field(5, 0, varint(1 if escape_whitespaces else 0))
    if precompiled_charsmap:
        norm += field(
            2, 2, varint(len(precompiled_charsmap)) + precompiled_charsmap
        )
    blob += field(3, 2, varint(len(norm)) + norm)
    return blob
