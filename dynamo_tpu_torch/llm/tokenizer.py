"""Tokenizers + incremental detokenization.

Copy of the JAX package's ``llm/tokenizer.py`` for what needs no package
the card's machine lacks: ``BaseTokenizer`` with its role-tagged chat
fallback, ``ByteTokenizer``, ``SentencePieceTokenizer`` (over the pure
Python ``llm/sp.py``) and ``DecodeStream``.  Reference semantics:
lib/llm/src/tokenizers.rs (Encoding, incremental ``DecodeStream``) and the
preprocessor's prompt templating (lib/llm/src/preprocessor/prompt/).

``HFTokenizer`` needs the ``tokenizers`` package and chat templates need
jinja2, neither of which the port uses.  A sentencepiece checkpoint that
ships a chat template is served with the role-tagged fallback, and says so
once in the log.

``DecodeStream`` performs incremental detokenization by decoding a sliding
window of accumulated ids and diffing against the previously emitted prefix,
holding back trailing bytes that form an incomplete UTF-8 sequence.
"""

from __future__ import annotations

import json
import logging
import os
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


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


class SentencePieceTokenizer(BaseTokenizer):
    """``tokenizer.model``-only checkpoints (older Llama/Mistral) served
    through the vendored sentencepiece runtime (llm/sp.py; reference:
    lib/llm/src/tokenizers/sp.rs).  Special tokens come from a sibling
    tokenizer_config.json when present; its chat template is recorded but
    rendered with the role-tagged fallback (no jinja2 here)."""

    def __init__(self, model_file: str, config_file: Optional[str] = None):
        from .sp import SentencePieceModel

        self._sp = SentencePieceModel.from_file(model_file)
        self._chat_template: Optional[str] = None
        self._template_noted = False
        self.bos_token: Optional[str] = None
        self.eos_token: Optional[str] = None
        if config_file is None:
            candidate = os.path.join(os.path.dirname(model_file), "tokenizer_config.json")
            config_file = candidate if os.path.exists(candidate) else None
        if config_file is not None:
            with open(config_file) as f:
                cfg = json.load(f)
            self._chat_template = cfg.get("chat_template")
            self.bos_token = _token_str(cfg.get("bos_token"))
            self.eos_token = _token_str(cfg.get("eos_token"))

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._sp.encode(text)
        if add_special_tokens and self._sp.bos_id >= 0:
            ids = [self._sp.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        # sp.decode always drops CONTROL/UNKNOWN pieces (sentencepiece
        # semantics); NORMAL pieces are never "special".
        return self._sp.decode(list(ids))

    def decode_window(
        self, ids: Sequence[int], skip_special_tokens: bool = True,
        *, sequence_start: bool = True,
    ) -> str:
        """Window decode for incremental detokenization: a window that does
        not begin the sequence keeps its leading ▁-space so prefix-diff
        deltas preserve inter-token spaces (DecodeStream)."""
        return self._sp.decode(list(ids), sequence_start=sequence_start)

    def apply_chat_template(
        self,
        messages: List[Dict[str, Any]],
        add_generation_prompt: bool = True,
        **kwargs: Any,
    ) -> str:
        if self._chat_template is not None and not self._template_noted:
            self._template_noted = True
            logger.warning(
                "the tokenizer's chat template needs jinja2, which this package does "
                "not use; chat prompts are rendered with the role-tagged fallback"
            )
        parts = [f"<|{m['role']}|>\n{m.get('content') or ''}" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "\n".join(parts)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._sp.eos_id if self._sp.eos_id >= 0 else None

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._sp.bos_id if self._sp.bos_id >= 0 else None

    @property
    def vocab_size(self) -> int:
        return self._sp.vocab_size

    @property
    def chat_template(self) -> Optional[str]:
        return self._chat_template


def _token_str(value: Any) -> Optional[str]:
    """tokenizer_config tokens are either "..." or {"content": "..."}."""
    if isinstance(value, dict):
        return value.get("content")
    return value


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
        # Mid-stream windows must keep a leading ▁-space (sentencepiece
        # dummy prefix) or the prefix-diff silently eats inter-token
        # spaces; tokenizers exposing decode_window get told whether the
        # window starts the sequence.
        win = getattr(self._tok, "decode_window", None)
        if win is not None:
            return win(
                ids, skip_special_tokens=self._skip,
                sequence_start=self._prefix_offset == 0,
            )
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
