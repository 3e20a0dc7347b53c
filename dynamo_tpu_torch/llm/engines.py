"""Engine-free test engines (echo) — copy of the JAX package's
``llm/engines.py``; reference lib/llm/src/engines.rs:40-105.

``EchoEngineCore`` speaks the token-level protocol (PreprocessedRequest in,
LLMEngineOutput dicts out) and echoes the prompt tokens back one at a time —
it lets the serving graph (HTTP → preprocess → backend) run and be
load-tested with no model and no GPU, like the reference's
``out=echocore``.  ``DYN_TOKEN_ECHO_DELAY_MS`` (env) or the ``delay_ms``
argument paces emission to simulate decode latency.

``EchoEngineFull`` echoes at the OpenAI level (``out=echofull``).
"""

from __future__ import annotations

import asyncio
import os
from typing import Any, AsyncIterator, Dict

from ..runtime.engine import AsyncEngine, Context, ResponseStream
from .openai import ChatCompletionRequest, CompletionRequest, DeltaGenerator
from .protocols import FinishReason, LLMEngineOutput, PreprocessedRequest


def _delay_s(delay_ms: float | None) -> float:
    if delay_ms is None:
        delay_ms = float(os.environ.get("DYN_TOKEN_ECHO_DELAY_MS", "0"))
    return delay_ms / 1000.0


class EchoEngineCore(AsyncEngine):
    """Token-in/token-out echo: yields the prompt tokens back."""

    def __init__(self, delay_ms: float | None = None):
        self._delay = _delay_s(delay_ms)

    async def generate(self, request: Context) -> ResponseStream:
        pre = PreprocessedRequest.from_dict(request.data)

        async def gen() -> AsyncIterator[Dict[str, Any]]:
            max_tokens = pre.stop_conditions.max_tokens
            emitted = 0
            for tok in pre.token_ids:
                if request.is_stopped:
                    break
                if max_tokens is not None and emitted >= max_tokens:
                    break
                if self._delay:
                    await asyncio.sleep(self._delay)
                yield LLMEngineOutput.token(tok)
                emitted += 1
            yield LLMEngineOutput.finished(
                FinishReason.LENGTH,
                usage={
                    "prompt_tokens": len(pre.token_ids),
                    "completion_tokens": emitted,
                    "total_tokens": len(pre.token_ids) + emitted,
                },
            )

        return ResponseStream(gen(), request.ctx)


class EchoEngineFull(AsyncEngine):
    """OpenAI-level echo: streams the prompt text back as chunks."""

    def __init__(self, delay_ms: float | None = None):
        self._delay = _delay_s(delay_ms)

    async def generate(self, request: Context) -> ResponseStream:
        raw = request.data
        chat = "messages" in raw
        if chat:
            oai = ChatCompletionRequest.from_dict(raw)
            text = oai.messages[-1].text() if oai.messages else ""
        else:
            oai = CompletionRequest.from_dict(raw)
            text = oai.prompt if isinstance(oai.prompt, str) else str(oai.prompt)

        async def gen() -> AsyncIterator[Dict[str, Any]]:
            gen_ = DeltaGenerator(oai.model, chat=chat, request_id=request.id)
            for word in text.split():
                if request.is_stopped:
                    break
                if self._delay:
                    await asyncio.sleep(self._delay)
                yield gen_.text_chunk(word + " ")
            yield gen_.finish_chunk("stop")

        return ResponseStream(gen(), request.ctx)
