"""Internal LLM protocols: the token-level request/response types.

Reference semantics: lib/llm/src/protocols/common.rs — ``StopConditions``,
``SamplingOptions``, ``PreprocessedRequest`` (aka BackendInput),
``LLMEngineOutput``, ``FinishReason``.  These cross process boundaries, so the
canonical wire form is a plain dict (msgpack-friendly); the classes here are
thin construction/validation helpers with ``to_dict``/``from_dict``.

Per-token engine outputs stay plain dicts on the hot path (one per generated
token per request) — schema documented on ``LLMEngineOutput``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class ModelNotFoundError(LookupError):
    """Request named a model/adapter nobody serves.  Raised by engines
    (TpuEngine._resolve_adapter) and mapped to the OpenAI 404
    ``model_not_found`` error body at the HTTP edge — never silently
    falling through to the base model (llm/tenancy)."""

    # Wire tag: the service transport ships this in its error prologue so
    # remote callers (runtime/client.py RemoteEngineError.kind) can map the
    # failure back to a 404 without importing this module.
    error_kind = "model_not_found"

    def __init__(self, model: str):
        super().__init__(f"model {model!r} not found")
        self.model = model


class FinishReason(str, enum.Enum):
    STOP = "stop"  # hit eos or a stop sequence
    LENGTH = "length"  # hit max_tokens
    CANCELLED = "cancelled"  # request cancelled
    ERROR = "error"

    def __str__(self) -> str:  # serialize as bare string
        return self.value


@dataclass
class StopConditions:
    """When to stop generating (protocols/common.rs StopConditions)."""

    max_tokens: Optional[int] = None
    min_tokens: Optional[int] = None
    stop: List[str] = field(default_factory=list)  # stop strings (hidden)
    stop_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "max_tokens": self.max_tokens,
            "min_tokens": self.min_tokens,
            "stop": self.stop,
            "stop_token_ids": self.stop_token_ids,
            "ignore_eos": self.ignore_eos,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StopConditions":
        return cls(
            max_tokens=d.get("max_tokens"),
            min_tokens=d.get("min_tokens"),
            stop=list(d.get("stop") or []),
            stop_token_ids=list(d.get("stop_token_ids") or []),
            ignore_eos=bool(d.get("ignore_eos", False)),
        )


@dataclass
class SamplingOptions:
    """How to sample (protocols/common.rs SamplingOptions)."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    seed: Optional[int] = None
    # None = no logprobs; 0 = chosen-token only; N = chosen + top-N
    logprobs: Optional[int] = None
    # Speculative decoding opt-out (nvext.spec_decode): False disables the
    # engine's draft-free speculation for THIS request; None/True defer to
    # the engine's spec_decode config.  Output tokens are identical either
    # way (engine/spec.py exact-stream acceptance) — the knob exists for
    # latency-shape control and for A/B measurement.
    spec_decode: Optional[bool] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "temperature": self.temperature,
            "top_p": self.top_p,
            "top_k": self.top_k,
            "frequency_penalty": self.frequency_penalty,
            "presence_penalty": self.presence_penalty,
            "seed": self.seed,
            "logprobs": self.logprobs,
            "spec_decode": self.spec_decode,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SamplingOptions":
        return cls(
            temperature=d.get("temperature"),
            top_p=d.get("top_p"),
            top_k=d.get("top_k"),
            frequency_penalty=d.get("frequency_penalty"),
            presence_penalty=d.get("presence_penalty"),
            seed=d.get("seed"),
            logprobs=d.get("logprobs"),
            spec_decode=d.get("spec_decode"),
        )


@dataclass
class PreprocessedRequest:
    """Token-in request to an engine (protocols/common.rs PreprocessedRequest).

    ``token_ids`` is the full prompt after templating+tokenization.
    ``annotations`` carries pass-through flags (e.g. requesting the engine
    echo back ``token_ids``/``formatted_prompt``).
    """

    token_ids: List[int]
    stop_conditions: StopConditions = field(default_factory=StopConditions)
    sampling_options: SamplingOptions = field(default_factory=SamplingOptions)
    model: Optional[str] = None
    annotations: Dict[str, Any] = field(default_factory=dict)
    # Structured-output constraint (llm/tenancy/grammar.py): the serialized
    # TokenMaskAutomaton dict compiled by the PREPROCESSOR (the only layer
    # holding the tokenizer); engines deserialize by content hash and apply
    # it as a per-row logit mask.  None = unconstrained.
    grammar: Optional[Dict[str, Any]] = None
    # QoS priority class (engine/scheduler.py): "interactive" | "batch".  None =
    # unspecified (treated as interactive downstream); parsed at the edge
    # from the x-priority header / nvext.priority and consumed by the
    # scheduler (batch rows preempt first, shed first under brownout).
    priority: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "token_ids": self.token_ids,
            "stop_conditions": self.stop_conditions.to_dict(),
            "sampling_options": self.sampling_options.to_dict(),
            "model": self.model,
            "annotations": self.annotations,
        }
        if self.grammar is not None:
            # Omitted when absent: pre-tenancy consumers (recorded streams,
            # older workers) never see the key.
            out["grammar"] = self.grammar
        if self.priority is not None:
            # Same omitted-when-absent wire compat as grammar.
            out["priority"] = self.priority
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d["token_ids"]),
            stop_conditions=StopConditions.from_dict(d.get("stop_conditions") or {}),
            sampling_options=SamplingOptions.from_dict(d.get("sampling_options") or {}),
            model=d.get("model"),
            annotations=dict(d.get("annotations") or {}),
            grammar=d.get("grammar"),
            priority=d.get("priority"),
        )


class LLMEngineOutput:
    """Schema of the per-step engine output dict (kept as a plain dict on the
    wire and in the hot loop; one per generated token):

    ``{"token_ids": [int, ...],        # newly generated token(s) this step
       "text": str | None,            # filled by the Backend detokenizer
       "finish_reason": str | None,   # FinishReason value when finished
       "cum_log_prob": float | None,
       "usage": {...} | None}``        # optional final usage stats
    """

    @staticmethod
    def token(token_id: int) -> Dict[str, Any]:
        return {"token_ids": [token_id], "text": None, "finish_reason": None}

    @staticmethod
    def tokens(token_ids: List[int]) -> Dict[str, Any]:
        """Multi-token step output (fused-chunk fast path; consumers
        iterate ``token_ids``, so granularity is an engine choice)."""
        return {"token_ids": list(token_ids), "text": None, "finish_reason": None}

    @staticmethod
    def finished(reason: FinishReason, usage: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        return {"token_ids": [], "text": None, "finish_reason": str(reason), "usage": usage}
