"""Tokenizers + incremental detokenization.

Copy of the JAX package's ``llm/tokenizer.py`` for what needs no model
files: ``BaseTokenizer`` with its role-tagged chat fallback,
``ByteTokenizer`` and ``DecodeStream``.  Reference semantics:
lib/llm/src/tokenizers.rs (Encoding, incremental ``DecodeStream``) and the
preprocessor's prompt templating (lib/llm/src/preprocessor/prompt/).

The HuggingFace and sentencepiece tokenizers are not ported yet: they need
the ``tokenizers`` package and a checkpoint's tokenizer files, neither of
which the port has (ROADMAP queue 1).  Chat templates need jinja2, so a
tokenizer with a template cannot render it here; ``ByteTokenizer`` has none.

``DecodeStream`` performs incremental detokenization by decoding a sliding
window of accumulated ids and diffing against the previously emitted prefix,
holding back trailing bytes that form an incomplete UTF-8 sequence.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence


class BaseTokenizer(ABC):
    """Minimal tokenizer interface used by the preprocessor and backend."""

    @abstractmethod
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ...

    @abstractmethod
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        ...

    @property
    @abstractmethod
    def eos_token_id(self) -> Optional[int]:
        ...

    @property
    @abstractmethod
    def bos_token_id(self) -> Optional[int]:
        ...

    @property
    @abstractmethod
    def vocab_size(self) -> int:
        ...

    # -- chat templating ----------------------------------------------------

    @property
    def chat_template(self) -> Optional[str]:
        return None

    def apply_chat_template(
        self,
        messages: List[Dict[str, Any]],
        add_generation_prompt: bool = True,
        **kwargs: Any,
    ) -> str:
        """Render messages to a prompt string with the role-tagged fallback
        (the JAX package's rendering when a tokenizer has no template)."""
        if self.chat_template is not None:
            raise NotImplementedError(
                "chat templates need jinja2, which the port does not use "
                "(ROADMAP queue 1: HF tokenizers)"
            )
        parts = [f"<|{m['role']}|>\n{m.get('content') or ''}" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "\n".join(parts)

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens=skip_special_tokens)


class ByteTokenizer(BaseTokenizer):
    """Self-contained byte-level tokenizer: ids 0-255 = bytes, then specials.

    Deterministic, lossless, zero files.  Specials: BOS=256, EOS=257, PAD=258,
    then one id per extra special token (e.g. role markers).
    """

    BOS = 256
    EOS = 257
    PAD = 258

    def __init__(self, extra_specials: Optional[List[str]] = None):
        self._specials: Dict[str, int] = {"<bos>": self.BOS, "<eos>": self.EOS, "<pad>": self.PAD}
        for i, tok in enumerate(extra_specials or []):
            self._specials[tok] = 259 + i
        self._special_by_id = {v: k for k, v in self._specials.items()}
        self.bos_token = "<bos>"
        self.eos_token = "<eos>"

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.BOS] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf = bytearray()
        for i in ids:
            if i < 256:
                buf.append(i)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if i in self._special_by_id:
                    if not skip_special_tokens:
                        out.append(self._special_by_id[i])
                else:
                    # Ids past the byte+special range (a model vocab larger
                    # than this tokenizer's) decode lossily, never silently:
                    # downstream consumers (streaming clients, stop-string
                    # scan) must see one glyph per token.
                    out.append("�")
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    @property
    def eos_token_id(self) -> int:
        return self.EOS

    @property
    def bos_token_id(self) -> int:
        return self.BOS

    @property
    def vocab_size(self) -> int:
        return 259 + len(self._specials) - 3


class DecodeStream:
    """Incremental detokenizer: feed ids one at a time, get stable text deltas.

    Offset-based incremental decode: decode the tail since the last stable
    boundary; if it ends in U+FFFD the final token(s) form an incomplete
    multi-byte sequence, so the delta is held back until a later token
    completes it (reference DecodeStream semantics, lib/llm/src/tokenizers.rs).
    """

    def __init__(self, tokenizer: BaseTokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        self._ids: List[int] = []
        self._prefix_offset = 0  # start of the decode window (last boundary)
        self._read_offset = 0  # ids before this are already emitted

    def _decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=self._skip)

    def step(self, token_id: int) -> str:
        """Feed one token id; return newly-stable text (may be empty)."""
        self._ids.append(token_id)
        tail = self._ids[self._prefix_offset :]
        text = self._decode(tail)
        if text.endswith("�"):
            if len(self._ids) - self._read_offset < 4:
                # Possibly an incomplete multi-byte sequence: hold the
                # delta.  A UTF-8 character resolves within 4 bytes, so a
                # longer unresolved window is a DELIBERATE replacement
                # glyph (e.g. an id outside a lossy tokenizer's range) —
                # holding forever would jail the whole stream until finish.
                return ""
            # Force-emit the held window and COMMIT past it (both offsets
            # to the end): re-decoding these ids later could resolve
            # differently than what we just emitted and garble the diff.
            prev = self._decode(self._ids[self._prefix_offset : self._read_offset])
            self._prefix_offset = len(self._ids)
            self._read_offset = len(self._ids)
            return text[len(prev) :]
        prev = self._decode(self._ids[self._prefix_offset : self._read_offset])
        delta = text[len(prev) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return delta

    def flush(self) -> str:
        """Emit any held-back text at end of stream (replacement chars kept)."""
        if self._read_offset >= len(self._ids):
            return ""
        text = self._decode(self._ids[self._prefix_offset :])
        prev = self._decode(self._ids[self._prefix_offset : self._read_offset])
        self._read_offset = len(self._ids)
        self._prefix_offset = len(self._ids)
        return text[len(prev) :]
