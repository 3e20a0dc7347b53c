"""OpenAI preprocessor operator: template + tokenize → PreprocessedRequest.

Copy of the JAX package's ``llm/preprocessor.py``.  Reference semantics:
lib/llm/src/preprocessor.rs (OpenAIPreprocessor) — the forward edge renders
the chat template and tokenizes into ``BackendInput``; the backward edge
shapes backend text deltas into OpenAI chunks via ``DeltaGenerator``.
Annotation requests (nvext.annotations) can echo the formatted prompt /
token ids back to the caller as annotation events.

A traced request (``ctx.trace``, sampled at the HTTP edge) records the
``edge.preprocess`` span and carries its trace to the engine in
``annotations["trace"]``.

Not ported yet: structured output (``response_format`` other than text,
``nvext.grammar``) and LoRA adapters, which the engine lacks.  A request
asking for structured output is rejected with a ``ValueError`` (400 at the
edge), never served unconstrained.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, AsyncIterator, Dict, Union

from ..engine.scheduler import normalize_priority
from ..runtime.engine import AsyncEngine, AsyncEngineContext, Context, ResponseStream
from ..runtime.pipeline import Operator
from .openai import ChatCompletionRequest, CompletionRequest, DeltaGenerator
from .protocols import PreprocessedRequest
from .tokenizer import BaseTokenizer
from .trace_service import preprocess_span


class OpenAIPreprocessor(Operator):
    """Chat/completions requests → token-level requests → OpenAI chunks."""

    def __init__(self, tokenizer: BaseTokenizer, model_name: str = ""):
        self._tokenizer = tokenizer
        self.model_name = model_name

    # -- forward ------------------------------------------------------------

    @staticmethod
    def _parse(
        oai: Union[ChatCompletionRequest, CompletionRequest, Dict[str, Any]]
    ) -> Union[ChatCompletionRequest, CompletionRequest]:
        if isinstance(oai, dict):
            return (
                ChatCompletionRequest.from_dict(oai)
                if "messages" in oai
                else CompletionRequest.from_dict(oai)
            )
        return oai

    @staticmethod
    def _refuse_unported(oai) -> None:
        """Structured output is not ported: refuse it rather than serve the
        request unconstrained."""
        if oai.nvext is not None and oai.nvext.grammar is not None:
            raise ValueError("nvext.grammar is not supported: structured output is not ported yet")
        rf = oai.response_format
        if rf and rf.get("type") not in (None, "text"):
            raise ValueError(
                f"response_format type {rf.get('type')!r} is not supported: structured "
                "output is not ported yet"
            )

    def preprocess(
        self, oai: Union[ChatCompletionRequest, CompletionRequest, Dict[str, Any]]
    ) -> PreprocessedRequest:
        oai = self._parse(oai)
        self._refuse_unported(oai)
        if isinstance(oai, ChatCompletionRequest):
            if oai.nvext and oai.nvext.use_raw_prompt and len(oai.messages) == 1:
                prompt = oai.messages[0].text()
            else:
                prompt = self._tokenizer.apply_chat_template(
                    [
                        {"role": m.role, "content": m.text()}
                        for m in oai.messages
                    ],
                    add_generation_prompt=True,
                    tools=oai.tools,
                )
            token_ids = self._tokenizer.encode(prompt, add_special_tokens=False)
        else:
            prompt_field = oai.prompt
            if isinstance(prompt_field, list) and prompt_field and isinstance(prompt_field[0], int):
                prompt = None
                token_ids = list(prompt_field)
            else:
                prompt = prompt_field if isinstance(prompt_field, str) else str(prompt_field)
                token_ids = self._tokenizer.encode(prompt)
        annotations: Dict[str, Any] = {}
        if oai.nvext and oai.nvext.annotations:
            if "formatted_prompt" in oai.nvext.annotations and prompt is not None:
                annotations["formatted_prompt"] = prompt
            if "token_ids" in oai.nvext.annotations:
                annotations["token_ids"] = token_ids
        # QoS identity: an explicit nvext.tenant overrides the scheduler's
        # default fairness key (the model name); priority rides its own
        # PreprocessedRequest field.
        priority = None
        if oai.nvext:
            if oai.nvext.tenant:
                annotations["tenant"] = str(oai.nvext.tenant)
            if oai.nvext.priority is not None:
                priority = normalize_priority(oai.nvext.priority)
        return PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=oai.stop_conditions(),
            sampling_options=oai.sampling_options(),
            model=oai.model,
            annotations=annotations,
            priority=priority,
        )

    # -- the operator -------------------------------------------------------

    async def generate(self, request: Context, next: AsyncEngine) -> ResponseStream:
        raw = request.data
        chat = "messages" in raw if isinstance(raw, dict) else True
        with preprocess_span(request.ctx):
            pre = self.preprocess(raw)
        trace = getattr(request.ctx, "trace", None)
        if trace is not None and trace.sampled:
            # Propagation: the trace rides ``annotations.trace`` on the
            # PreprocessedRequest — the same omit-when-absent idiom as
            # tenant, so an untraced request never carries the key.
            pre.annotations["trace"] = trace.to_dict()
        model = pre.model or self.model_name
        n = int(raw.get("n") or 1) if isinstance(raw, dict) else 1
        # Only user-REQUESTED debug annotations (nvext.annotations) echo as
        # the SSE ``annotation`` event.
        echo = {
            k: v
            for k, v in pre.annotations.items()
            if k in ("formatted_prompt", "token_ids")
        }
        if n <= 1:
            stream = await next.generate(Context(pre.to_dict(), request.ctx))
            return ResponseStream(
                self._to_chunks(stream, model, chat, request.id, echo),
                request.ctx,
            )
        # n > 1: one engine request per choice — the prefix cache shares the
        # prompt KV across them; streams merge with per-choice indices.
        # Reference: protocols/openai (n) + multiple SSE choice indices.
        streams = []
        for i in range(n):
            child = AsyncEngineContext(f"{request.id}-c{i}")
            request.ctx.link_child(child)
            pre_i = pre
            if pre.sampling_options.seed is not None:
                so = dataclasses.replace(
                    pre.sampling_options, seed=pre.sampling_options.seed + i
                )
                pre_i = dataclasses.replace(pre, sampling_options=so)
            streams.append(await next.generate(Context(pre_i.to_dict(), child)))
        return ResponseStream(
            self._merge_choices(streams, model, chat, request.id, echo),
            request.ctx,
        )

    async def _merge_choices(
        self,
        streams,
        model: str,
        chat: bool,
        request_id: str,
        annotations: Dict[str, Any],
    ) -> AsyncIterator[Dict[str, Any]]:
        """Interleave n sub-request streams into one chunk stream with
        per-choice indices; one summed usage chunk at the end."""
        queue: "asyncio.Queue" = asyncio.Queue()

        async def pump(i: int, stream) -> None:
            gen = DeltaGenerator(model, chat=chat, request_id=request_id, index=i)
            try:
                async for item in stream:
                    reason = item.get("finish_reason")
                    if reason is not None:
                        await queue.put((gen.finish_chunk(reason), item.get("usage")))
                        return
                    if item.get("text") or item.get("logprobs"):
                        await queue.put(
                            (
                                gen.text_chunk(
                                    item.get("text") or "",
                                    logprobs=item.get("logprobs"),
                                ),
                                None,
                            )
                        )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # surface, don't truncate silently
                await queue.put((e, None))
            finally:
                await stream.aclose()
                await queue.put((None, None))  # stream-done marker

        tasks = [asyncio.ensure_future(pump(i, s)) for i, s in enumerate(streams)]
        try:
            if annotations:
                yield {"__annotations__": annotations}
            done = 0
            usages = []
            while done < len(streams):
                chunk, usage = await queue.get()
                if usage:
                    usages.append(usage)
                if chunk is None:
                    done += 1
                    continue
                if isinstance(chunk, Exception):
                    # A failed choice fails the request, matching n=1.
                    raise chunk
                yield chunk
            if usages:
                merged = {
                    "prompt_tokens": usages[0].get("prompt_tokens", 0),
                    "completion_tokens": sum(
                        u.get("completion_tokens", 0) for u in usages
                    ),
                }
                merged["total_tokens"] = (
                    merged["prompt_tokens"] + merged["completion_tokens"]
                )
                gen = DeltaGenerator(model, chat=chat, request_id=request_id)
                yield gen.usage_chunk(merged)
        finally:
            for t in tasks:
                t.cancel()

    async def _to_chunks(
        self,
        stream: ResponseStream,
        model: str,
        chat: bool,
        request_id: str,
        annotations: Dict[str, Any],
    ) -> AsyncIterator[Dict[str, Any]]:
        gen = DeltaGenerator(model, chat=chat, request_id=request_id)
        try:
            if annotations:
                yield {"__annotations__": annotations}
            async for item in stream:
                reason = item.get("finish_reason")
                if reason is not None:
                    if item.get("usage"):
                        # merge usage into the finish chunk (OpenAI shape
                        # allows usage on the final chunk)
                        chunk = gen.finish_chunk(reason)
                        chunk["usage"] = item["usage"]
                        yield chunk
                    else:
                        yield gen.finish_chunk(reason)
                    return
                if item.get("text") or item.get("logprobs"):
                    yield gen.text_chunk(
                        item.get("text") or "", logprobs=item.get("logprobs")
                    )
        finally:
            await stream.aclose()
