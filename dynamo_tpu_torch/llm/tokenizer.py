"""Tokenizers + incremental detokenization.

A copy of the JAX package's ``llm/tokenizer.py``.  Reference semantics:
lib/llm/src/tokenizers.rs (Encoding, HF/sentencepiece backends,
incremental ``DecodeStream``) and the preprocessor's prompt templating
(lib/llm/src/preprocessor/prompt/).

- ``HFTokenizer`` — a ``tokenizer.json`` (the HF format every target model
  ships) run by ``llm/hf_tokenizer.py`` in plain Python, and the chat
  template of a sibling tokenizer_config.json;
- ``SentencePieceTokenizer`` — a ``tokenizer.model`` through ``llm/sp.py``;
- ``ByteTokenizer`` — self-contained byte-level tokenizer (ids 0-255 are
  raw bytes + special tokens above), for tests, echo serving and synthetic
  benchmarks.

Chat templates render through ``llm/chat_template.py``, the subset of
Jinja2 that chat templates use, with the JAX renderer's environment; the
card's machine has neither ``tokenizers`` nor jinja2.

``DecodeStream`` performs incremental detokenization by decoding a sliding
window of accumulated ids and diffing against the previously emitted prefix,
holding back trailing bytes that form an incomplete UTF-8 sequence.
"""

from __future__ import annotations

import json
import os
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
        """Render messages to a prompt string (reference: minijinja templates,
        lib/llm/src/preprocessor/prompt/template/)."""
        template = self.chat_template
        if template is None:
            # simple role-tagged fallback (mirrors no-template GGUF models)
            parts = [f"<|{m['role']}|>\n{m.get('content') or ''}" for m in messages]
            if add_generation_prompt:
                parts.append("<|assistant|>\n")
            return "\n".join(parts)
        from .chat_template import render_chat_template

        return render_chat_template(
            template,
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=getattr(self, "bos_token", "") or "",
            eos_token=getattr(self, "eos_token", "") or "",
            **kwargs,
        )

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens=skip_special_tokens)


class HFTokenizer(BaseTokenizer):
    """HuggingFace ``tokenizer.json`` backend (+ chat template/config),
    run by ``llm/hf_tokenizer.Tokenizer``."""

    def __init__(
        self,
        tokenizer_file: Optional[str] = None,
        config_file: Optional[str] = None,
        *,
        tokenizer: Optional[Any] = None,  # an in-memory hf_tokenizer.Tokenizer
        bos_token_id: Optional[int] = None,
        eos_token_id: Optional[int] = None,
    ):
        from .hf_tokenizer import Tokenizer

        if tokenizer is not None:
            self._tok = tokenizer  # e.g. built from GGUF metadata
        elif tokenizer_file is not None:
            self._tok = Tokenizer.from_file(tokenizer_file)
        else:
            raise ValueError("need tokenizer_file or tokenizer")
        self._chat_template: Optional[str] = None
        self.bos_token: Optional[str] = None
        self.eos_token: Optional[str] = None
        self._bos_id: Optional[int] = None
        self._eos_id: Optional[int] = None

        if config_file is None and tokenizer_file is not None:
            candidate = os.path.join(os.path.dirname(tokenizer_file), "tokenizer_config.json")
            config_file = candidate if os.path.exists(candidate) else None
        if config_file is not None:
            self._chat_template, self.bos_token, self.eos_token = _read_config(config_file)
        if self.bos_token:
            self._bos_id = self._tok.token_to_id(self.bos_token)
        if self.eos_token:
            self._eos_id = self._tok.token_to_id(self.eos_token)
        if bos_token_id is not None:
            self._bos_id = int(bos_token_id)
        if eos_token_id is not None:
            self._eos_id = int(eos_token_id)

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "HFTokenizer":
        return cls(os.path.join(model_dir, "tokenizer.json"))

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._eos_id

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._bos_id

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    @property
    def chat_template(self) -> Optional[str]:
        return self._chat_template


class SentencePieceTokenizer(BaseTokenizer):
    """``tokenizer.model``-only checkpoints (older Llama/Mistral) served
    through the vendored sentencepiece runtime (llm/sp.py; reference:
    lib/llm/src/tokenizers/sp.rs).  Chat template / special tokens come
    from a sibling tokenizer_config.json when present."""

    def __init__(self, model_file: str, config_file: Optional[str] = None):
        from .sp import SentencePieceModel

        self._sp = SentencePieceModel.from_file(model_file)
        self._chat_template: Optional[str] = None
        self.bos_token: Optional[str] = None
        self.eos_token: Optional[str] = None
        if config_file is None:
            candidate = os.path.join(os.path.dirname(model_file), "tokenizer_config.json")
            config_file = candidate if os.path.exists(candidate) else None
        if config_file is not None:
            self._chat_template, self.bos_token, self.eos_token = _read_config(config_file)

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


def _read_config(config_file: str):
    """tokenizer_config.json's chat template, bos and eos token strings.
    The template is compiled here, so a construct outside the renderer's
    subset stops the tokenizer's load, named, not the first chat request."""
    with open(config_file) as f:
        cfg = json.load(f)
    template = cfg.get("chat_template")
    if isinstance(template, str):
        from .chat_template import compile_template

        compile_template(template)
    return template, _token_str(cfg.get("bos_token")), _token_str(cfg.get("eos_token"))


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
