"""OpenAI-compatible API types, delta generation, and aggregation.

Copy of the JAX package's ``llm/openai.py``.  Reference semantics:
lib/llm/src/protocols/openai/** — chat-completions and completions request
types (with the ``nvext`` extension: ignore_eos, annotations,
use_raw_prompt), the ``DeltaGenerator`` that shapes per-token engine
outputs into ``chat.completion.chunk`` SSE objects, and the stream→full
aggregators used for ``stream=false`` responses.

The JAX package validates requests with pydantic, which the port does not
use.  Here the request types are dataclasses whose ``from_dict`` applies
pydantic's lax-mode rules to each field (``"12"`` is an int, ``1`` a
float, ``"yes"`` a bool, an int is never a string) and keeps unknown keys
in ``extra``, as ``extra="allow"`` does.  A field that fails raises
``ValueError``, which the HTTP edge maps to 400.  Chunks are plain dicts.
"""

from __future__ import annotations

import json
import math
import re
import time
import uuid
from dataclasses import MISSING, dataclass, field, fields
from typing import Any, Callable, ClassVar, Dict, List, Optional, Union

from .protocols import SamplingOptions, StopConditions

# -- field converters (pydantic lax mode, for JSON values) -------------------

_INT_DIGITS = re.compile(r"-?(?:0|[1-9][0-9]*)")
_DECIMAL_ZEROS = re.compile(r"\.0+$")
_TRUE = frozenset(("1", "on", "t", "true", "y", "yes"))
_FALSE = frozenset(("0", "off", "f", "false", "n", "no"))


def _int(v: Any) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float) and math.isfinite(v) and v == int(v) and abs(v) < 2**63:
        return int(v)
    if isinstance(v, str) and v.isascii():
        s = v.strip()
        for text in (s, _DECIMAL_ZEROS.sub("", s)):
            n = _int_str(text)
            if n is not None:
                return n
    raise ValueError(f"expected an integer, got {v!r}")


def _int_str(s: str) -> Optional[int]:
    """pydantic-core's string-to-int steps, quirks included: the sign is set
    aside, leading zeros and underscores are dropped up to the first other
    character (so ``"0-1"`` is -1), the sign goes back on, underscores that
    are neither doubled nor trailing go, and what is left must be a JSON
    integer."""
    sign = s[:1] if s[:1] in ("-", "+") else ""
    rest = s[len(sign):]
    if not rest or rest[0] not in "0123456789":
        return None
    if rest[0] == "0":
        for i, c in enumerate(rest):
            if c not in "0_":
                rest = rest[i:] if c in "123456789-" else ""
                break
        else:
            rest = rest[-1]
    text = (sign if sign == "-" else "") + rest
    if text.endswith("_") or "__" in text:
        return None
    text = text.replace("_", "")
    return int(text) if _INT_DIGITS.fullmatch(text) else None


def _float(v: Any) -> float:
    if isinstance(v, (bool, int, float)):
        try:
            return float(v)
        except OverflowError:
            pass
    elif isinstance(v, str) and v.isascii():
        # pydantic drops underscores that are neither leading, trailing nor
        # doubled, and then no longer trims white space.
        s = v.replace("_", "")
        if s == v or not (v.startswith("_") or v.endswith("_") or "__" in v
                          or v != v.strip()):
            try:
                return float(s)
            except ValueError:
                pass
    raise ValueError(f"expected a number, got {v!r}")


def _bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str):
        s = v.lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
    raise ValueError(f"expected a boolean, got {v!r}")


def _str(v: Any) -> str:
    if isinstance(v, str):
        return v
    raise ValueError(f"expected a string, got {v!r}")


def _dict(v: Any) -> Dict[str, Any]:
    if isinstance(v, dict) and all(isinstance(k, str) for k in v):
        return dict(v)
    raise ValueError(f"expected an object, got {v!r}")


def _list(conv: Callable[[Any], Any]) -> Callable[[Any], list]:
    def convert(v: Any) -> list:
        if not isinstance(v, list):
            raise ValueError(f"expected an array, got {v!r}")
        return [conv(x) for x in v]

    return convert


def _union(*convs: Callable[[Any], Any]) -> Callable[[Any], Any]:
    """First member that accepts the value, in declaration order."""

    def convert(v: Any) -> Any:
        for conv in convs:
            try:
                return conv(v)
            except ValueError:
                continue
        raise ValueError(f"no accepted type matches {v!r}")

    return convert


def _opt(conv: Callable[[Any], Any]) -> Callable[[Any], Any]:
    return lambda v: None if v is None else conv(v)


@dataclass(kw_only=True)
class _Validated:
    """Base of the request types: ``from_dict`` validates and converts each
    known key with its class's ``_SCHEMA`` converter and keeps the rest in
    ``extra``."""

    extra: Dict[str, Any] = field(default_factory=dict)
    _SCHEMA: ClassVar[Dict[str, Callable[[Any], Any]]] = {}

    @classmethod
    def from_dict(cls, d: Any):
        if not isinstance(d, dict):
            raise ValueError(f"{cls.__name__}: expected an object, got {type(d).__name__}")
        kw: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        for key, value in d.items():
            conv = cls._SCHEMA.get(key)
            if conv is None:
                extra[key] = value
                continue
            try:
                kw[key] = conv(value)
            except ValueError as e:
                raise ValueError(f"{cls.__name__}.{key}: {e}") from None
        missing = [
            f.name for f in fields(cls)
            if f.name in cls._SCHEMA and f.name not in kw
            and f.default is MISSING and f.default_factory is MISSING
        ]
        if missing:
            raise ValueError(f"{cls.__name__}: field required: {', '.join(missing)}")
        return cls(extra=extra, **kw)


@dataclass(kw_only=True)
class NvExt(_Validated):
    """Extension fields (reference nvext): engine hints + debug annotations."""

    ignore_eos: Optional[bool] = None
    use_raw_prompt: Optional[bool] = None
    annotations: Optional[List[str]] = None
    greed_sampling: Optional[bool] = None
    # Per-request speculative-decoding opt-out (false disables the engine's
    # draft-free speculation for this request; tokens are identical either
    # way).
    spec_decode: Optional[bool] = None
    # Structured-output constraint (llm/tenancy/grammar.py): a regex string
    # (restricted syntax) or a JSON-schema dict.  Wins over the standard
    # ``response_format`` field when both are set.
    grammar: Optional[Union[str, Dict[str, Any]]] = None
    # QoS: priority class ("interactive" | "batch") and tenant identity for
    # the scheduler's weighted fair queue.
    priority: Optional[str] = None
    tenant: Optional[str] = None

    _SCHEMA: ClassVar[Dict[str, Callable[[Any], Any]]] = {
        "ignore_eos": _opt(_bool),
        "use_raw_prompt": _opt(_bool),
        "annotations": _opt(_list(_str)),
        "greed_sampling": _opt(_bool),
        "spec_decode": _opt(_bool),
        "grammar": _opt(_union(_str, _dict)),
        "priority": _opt(_str),
        "tenant": _opt(_str),
    }


@dataclass(kw_only=True)
class ChatMessage(_Validated):
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None

    _SCHEMA: ClassVar[Dict[str, Callable[[Any], Any]]] = {
        "role": _str,
        "content": _opt(_union(_str, _list(_dict))),
        "name": _opt(_str),
    }

    def text(self) -> str:
        if isinstance(self.content, list):
            return "".join(
                part.get("text", "") for part in self.content if part.get("type") == "text"
            )
        return self.content or ""


@dataclass(kw_only=True)
class CommonFields(_Validated):
    model: str
    stream: bool = False
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    min_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    seed: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    n: int = 1
    nvext: Optional[NvExt] = None
    # Structured output (OpenAI shape): {"type": "text" | "json_object" |
    # "json_schema", "json_schema": {"name": ..., "schema": {...}}}.
    # Compiled to a token-mask automaton at the preprocessor
    # (llm/tenancy/grammar.py) and enforced as a per-row logit mask.
    response_format: Optional[Dict[str, Any]] = None

    _SCHEMA: ClassVar[Dict[str, Callable[[Any], Any]]] = {
        "model": _str,
        "stream": _bool,
        "max_tokens": _opt(_int),
        "max_completion_tokens": _opt(_int),
        "min_tokens": _opt(_int),
        "temperature": _opt(_float),
        "top_p": _opt(_float),
        "top_k": _opt(_int),
        "frequency_penalty": _opt(_float),
        "presence_penalty": _opt(_float),
        "seed": _opt(_int),
        "stop": _opt(_union(_str, _list(_str))),
        "n": _int,
        "nvext": _opt(NvExt.from_dict),
        "response_format": _opt(_dict),
    }

    def stop_conditions(self) -> StopConditions:
        stop = self.stop
        if isinstance(stop, str):
            stop = [stop]
        return StopConditions(
            max_tokens=self.max_tokens or self.max_completion_tokens,
            min_tokens=self.min_tokens,
            stop=list(stop or []),
            ignore_eos=bool(self.nvext and self.nvext.ignore_eos),
        )

    def sampling_options(self) -> SamplingOptions:
        return SamplingOptions(
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            seed=self.seed,
            spec_decode=self.nvext.spec_decode if self.nvext else None,
        )


@dataclass(kw_only=True)
class ChatCompletionRequest(CommonFields):
    messages: List[ChatMessage]
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    tools: Optional[List[Dict[str, Any]]] = None
    stream_options: Optional[Dict[str, Any]] = None

    _SCHEMA: ClassVar[Dict[str, Callable[[Any], Any]]] = {
        **CommonFields._SCHEMA,
        "messages": _list(ChatMessage.from_dict),
        "logprobs": _opt(_bool),
        "top_logprobs": _opt(_int),
        "tools": _opt(_list(_dict)),
        "stream_options": _opt(_dict),
    }

    def sampling_options(self) -> SamplingOptions:
        opts = super().sampling_options()
        if self.top_logprobs is not None and not 0 <= self.top_logprobs <= 20:
            # OpenAI's documented range; the sampler computes exactly this
            # many alternatives (ops/sampling.py TOPK_LOGPROBS), so anything
            # larger must be rejected, not silently clamped.
            raise ValueError("top_logprobs must be between 0 and 20")
        if self.logprobs:
            opts.logprobs = self.top_logprobs or 0
        return opts


@dataclass(kw_only=True)
class CompletionRequest(CommonFields):
    prompt: Union[str, List[str], List[int], List[List[int]]]
    echo: Optional[bool] = None
    logprobs: Optional[int] = None
    stream_options: Optional[Dict[str, Any]] = None

    _SCHEMA: ClassVar[Dict[str, Callable[[Any], Any]]] = {
        **CommonFields._SCHEMA,
        "prompt": _union(_str, _list(_str), _list(_int), _list(_list(_int))),
        "echo": _opt(_bool),
        "logprobs": _opt(_int),
        "stream_options": _opt(_dict),
    }

    def sampling_options(self) -> SamplingOptions:
        opts = super().sampling_options()
        if self.logprobs is not None:
            if not 0 <= self.logprobs <= 20:
                raise ValueError("logprobs must be between 0 and 20")
            opts.logprobs = self.logprobs
        return opts


def _now() -> int:
    return int(time.time())


class DeltaGenerator:
    """Shapes backend text deltas into OpenAI streaming chunks.

    Reference: protocols/openai/chat_completions/delta.rs — one object per
    request, stamps a stable completion id/created, emits the role on the
    first chunk, finish_reason on the last, optional usage chunk.
    """

    def __init__(
        self,
        model: str,
        chat: bool = True,
        request_id: Optional[str] = None,
        index: int = 0,
    ):
        self.chat = chat
        self.model = model
        self.id = ("chatcmpl-" if chat else "cmpl-") + (request_id or uuid.uuid4().hex)
        self.created = _now()
        self.object = "chat.completion.chunk" if chat else "text_completion"
        self.index = index  # choice index (n > 1 fan-out)
        self._first = True

    def _base(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "object": self.object,
            "created": self.created,
            "model": self.model,
        }

    def text_chunk(
        self, text: str, logprobs: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        out = self._base()
        if self.chat:
            delta: Dict[str, Any] = {"content": text}
            if self._first:
                delta["role"] = "assistant"
                self._first = False
            choice: Dict[str, Any] = {
                "index": self.index, "delta": delta, "finish_reason": None
            }
            if logprobs is not None:
                choice["logprobs"] = {
                    "content": [
                        {
                            "token": logprobs["token"],
                            "logprob": logprobs["logprob"],
                            "top_logprobs": logprobs.get("top", []),
                        }
                    ]
                }
            out["choices"] = [choice]
        else:
            choice = {"index": self.index, "text": text, "finish_reason": None}
            if logprobs is not None:
                choice["logprobs"] = {
                    "tokens": [logprobs["token"]],
                    "token_logprobs": [logprobs["logprob"]],
                    "top_logprobs": [
                        {t["token"]: t["logprob"] for t in logprobs.get("top", [])}
                    ],
                }
            out["choices"] = [choice]
        return out

    def finish_chunk(self, finish_reason: str) -> Dict[str, Any]:
        out = self._base()
        if self.chat:
            out["choices"] = [{"index": self.index, "delta": {}, "finish_reason": finish_reason}]
        else:
            out["choices"] = [{"index": self.index, "text": "", "finish_reason": finish_reason}]
        return out

    def usage_chunk(self, usage: Dict[str, int]) -> Dict[str, Any]:
        out = self._base()
        out["choices"] = []
        out["usage"] = usage
        return out


def aggregate_chunks(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold a chunk stream into a full (non-streaming) response.

    Reference: protocols/openai/chat_completions/aggregator.rs — used at the
    HTTP edge for ``stream=false`` (everything downstream always streams).
    """
    if not chunks:
        raise ValueError("empty stream")
    first = chunks[0]
    chat = first.get("object") == "chat.completion.chunk"

    class _Acc:
        def __init__(self):
            self.text: List[str] = []
            self.finish: Optional[str] = None
            self.role = "assistant"
            self.lp_content: List[Dict[str, Any]] = []  # chat logprobs
            self.lp_tokens: List[str] = []  # completions logprobs
            self.lp_vals: List[float] = []
            self.lp_top: List[Dict[str, float]] = []

    accs: Dict[int, _Acc] = {}
    usage: Optional[Dict[str, int]] = None
    for ch in chunks:
        if ch.get("usage"):
            u = ch["usage"]
            if usage is None:
                usage = dict(u)
            else:  # n > 1: completions sum, the shared prompt counts once
                usage["completion_tokens"] = usage.get(
                    "completion_tokens", 0
                ) + u.get("completion_tokens", 0)
                usage["total_tokens"] = (
                    usage.get("prompt_tokens", 0) + usage["completion_tokens"]
                )
        for choice in ch.get("choices", []):
            acc = accs.setdefault(int(choice.get("index", 0)), _Acc())
            lp = choice.get("logprobs")
            if chat:
                delta = choice.get("delta", {})
                if delta.get("role"):
                    acc.role = delta["role"]
                if delta.get("content"):
                    acc.text.append(delta["content"])
                if lp and lp.get("content"):
                    acc.lp_content.extend(lp["content"])
            else:
                if choice.get("text"):
                    acc.text.append(choice["text"])
                if lp:
                    acc.lp_tokens.extend(lp.get("tokens", []))
                    acc.lp_vals.extend(lp.get("token_logprobs", []))
                    acc.lp_top.extend(lp.get("top_logprobs", []))
            if choice.get("finish_reason"):
                acc.finish = choice["finish_reason"]
    out = {
        "id": first["id"],
        "object": "chat.completion" if chat else "text_completion",
        "created": first["created"],
        "model": first["model"],
    }
    choices = []
    for idx in sorted(accs) or [0]:
        acc = accs.get(idx, _Acc())
        full_text = "".join(acc.text)
        if chat:
            c: Dict[str, Any] = {
                "index": idx,
                "message": {"role": acc.role, "content": full_text},
                "finish_reason": acc.finish,
            }
            if acc.lp_content:
                c["logprobs"] = {"content": acc.lp_content}
        else:
            c = {"index": idx, "text": full_text, "finish_reason": acc.finish}
            if acc.lp_tokens:
                c["logprobs"] = {
                    "tokens": acc.lp_tokens,
                    "token_logprobs": acc.lp_vals,
                    "top_logprobs": acc.lp_top,
                }
        choices.append(c)
    out["choices"] = choices
    if usage is not None:
        out["usage"] = usage
    return out


def sse_encode(data: Any) -> bytes:
    """One SSE event (reference codec.rs)."""
    return b"data: " + json.dumps(data, separators=(",", ":")).encode() + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"
