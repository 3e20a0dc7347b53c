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

When the pipeline fronts a LoRA adapter (``adapter=``, one pipeline per
served name), every request is stamped with the adapter id and its KV-hash
salt.  Structured output (``response_format`` ``json_object`` /
``json_schema``, ``nvext.grammar``) compiles HERE, the only layer holding
the tokenizer, into a serializable token-mask automaton that rides the
PreprocessedRequest (llm/tenancy/grammar.py); constrained requests dispatch
hash-first, with one full-table resend on ``grammar_miss``.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, AsyncIterator, Dict, Optional, Union

from ..engine.scheduler import normalize_priority
from ..runtime.engine import AsyncEngine, AsyncEngineContext, Context, ResponseStream
from ..runtime.pipeline import Operator
from .openai import ChatCompletionRequest, CompletionRequest, DeltaGenerator
from .protocols import PreprocessedRequest
from .tenancy.grammar import GrammarCacheMissError, GrammarCompiler, constraint_spec
from .tokenizer import BaseTokenizer
from .trace_service import preprocess_span

# Sentinel for preprocess(grammar=...): distinguishes "compile it for me"
# (the default, sync callers) from an explicitly precompiled value — which
# may legitimately be None (generate() compiles off-loop first).
_UNSET = object()


class OpenAIPreprocessor(Operator):
    """Chat/completions requests → token-level requests → OpenAI chunks."""

    def __init__(self, tokenizer: BaseTokenizer, model_name: str = "",
                 adapter: Optional[str] = None, grammar_compiler=None):
        self._tokenizer = tokenizer
        self.model_name = model_name
        self.adapter = adapter
        # Shared across the sibling per-adapter preprocessors of one
        # tokenizer when the caller passes it; lazily created otherwise.
        # Compilation (vocabulary indexing) is the expensive step.
        self._grammar_compiler = grammar_compiler
        # Hash-first dispatch state per automaton hash: {"misses", "full"}.
        # After a miss the next 2**misses dispatches ship the full table —
        # with round-robin routing a single miss→resend pair can seed the
        # SAME two workers forever, so the full-table burst walks the
        # rotation and seeds the whole fleet before stubs are retried.
        self._grammar_wire: Dict[str, Dict[str, int]] = {}

    def _constraint_spec(self, oai) -> Optional[dict]:
        return constraint_spec(
            getattr(oai, "response_format", None),
            oai.nvext.grammar if oai.nvext else None,
        )

    def _compile_grammar(self, oai) -> Optional[dict]:
        """Constraint spec → serialized automaton dict (None when the
        request is unconstrained).  GrammarError (bad schema/regex) is a
        ValueError: the HTTP edge maps it to 400."""
        from .metrics import tenancy_metrics

        spec = self._constraint_spec(oai)
        if spec is None:
            return None
        if self._grammar_compiler is None:
            self._grammar_compiler = GrammarCompiler(self._tokenizer)
        before = self._grammar_compiler.compiles
        automaton = self._grammar_compiler.compile(spec)
        if self._grammar_compiler.compiles > before:
            tenancy_metrics.grammar_compiles_total += 1
        else:
            tenancy_metrics.grammar_cache_hits_total += 1
        return automaton.to_dict()

    async def _compile_grammar_async(self, oai) -> Optional[dict]:
        """Off-loop grammar compile: a cache miss indexes the whole
        vocabulary (seconds on a 128k vocabulary) and must not stall every
        concurrent stream on this process's event loop."""
        if self._constraint_spec(oai) is None:
            return None
        return await asyncio.to_thread(self._compile_grammar, oai)

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

    def preprocess(
        self,
        oai: Union[ChatCompletionRequest, CompletionRequest, Dict[str, Any]],
        grammar: Any = _UNSET,
    ) -> PreprocessedRequest:
        oai = self._parse(oai)
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
        if self.adapter:
            from .tenancy.lora import kv_salt_for_adapter

            # Tenant identity rides the request: the engine resolves the
            # adapter to a device slot, and the KV router salts its overlap
            # hashing with the same value the engine seals blocks under.
            annotations["adapter"] = self.adapter
            annotations["kv_salt"] = kv_salt_for_adapter(self.adapter)
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
            grammar=self._compile_grammar(oai) if grammar is _UNSET else grammar,
            priority=priority,
        )

    # -- dispatch -----------------------------------------------------------

    @staticmethod
    def _is_grammar_miss(exc: BaseException) -> bool:
        from ..runtime.transports.service import RemoteEngineError

        if isinstance(exc, GrammarCacheMissError):
            return True  # in-process engine (cli run out=torch)
        return isinstance(exc, RemoteEngineError) and exc.kind == "grammar_miss"

    async def _dispatch(self, next: AsyncEngine, ctx, pre) -> ResponseStream:
        """Hash-first constrained dispatch: ship the automaton's content
        hash alone; only an engine whose LRU lacks it answers
        ``grammar_miss``, and exactly then the full edge table (KBs per
        request on a real vocabulary) goes over the wire.  Repeated misses
        (cold fleet) switch to an exponentially growing full-table burst
        that seeds the routing rotation, then stubs are retried.
        Unconstrained requests dispatch unchanged."""
        from .metrics import tenancy_metrics

        g = pre.grammar
        if not g or not g.get("hash") or "edges" not in g:
            return await next.generate(Context(pre.to_dict(), ctx))
        state = self._grammar_wire.setdefault(g["hash"], {"misses": 0, "full": 0})
        if len(self._grammar_wire) > 256:  # bounded (hash churn)
            # (`next` names the downstream engine here — index, don't iter.)
            self._grammar_wire.pop(list(self._grammar_wire)[0])
        if state["full"] > 0:
            state["full"] -= 1
        else:
            stub = dataclasses.replace(pre, grammar={"hash": g["hash"], "stub": True})
            try:
                stream = await next.generate(Context(stub.to_dict(), ctx))
                state["misses"] = 0
                tenancy_metrics.grammar_stub_dispatches_total += 1
                return stream
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                if not self._is_grammar_miss(e):
                    raise
                state["misses"] += 1
                state["full"] = min(2 ** state["misses"], 16)
                tenancy_metrics.grammar_full_resends_total += 1
        return await next.generate(Context(pre.to_dict(), ctx))

    # -- the operator -------------------------------------------------------

    async def generate(self, request: Context, next: AsyncEngine) -> ResponseStream:
        raw = request.data
        chat = "messages" in raw if isinstance(raw, dict) else True
        oai = self._parse(raw)
        with preprocess_span(request.ctx):
            pre = self.preprocess(oai, grammar=await self._compile_grammar_async(oai))
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
            stream = await self._dispatch(next, request.ctx, pre)
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
            streams.append(await self._dispatch(next, child, pre_i))
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
