"""Console input modes for ``cli run``: interactive chat, single-prompt
stdin, and batch-file evaluation.

Copy of the JAX package's ``llm/console.py``.  Reference parity:
``dynamo-run in=text|stdin|batch:FILE`` (launch/dynamo-run/src/opt.rs:23-38,
input/text.rs, input/batch.rs).  All three drive the SAME pipeline object
the HTTP frontend serves (preprocessor → backend → engine), so a prompt
typed at the REPL exercises chat templates, sampling, and streaming
identically to a /v1/chat/completions call.

Batch file format (reference input/batch.rs Entry): one JSON object per
line with ``{"text": ...}``; results are written next to the input as
``output.jsonl`` with response/tokens_in/tokens_out/elapsed_ms/
finish_reason added.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from ..runtime.engine import Context


def _chat_request(model: str, messages: List[dict], args) -> Dict[str, Any]:
    req: Dict[str, Any] = {
        "model": model,
        "messages": messages,
        "stream": True,
    }
    if getattr(args, "max_tokens", None):
        req["max_tokens"] = args.max_tokens
    if getattr(args, "temperature", None) is not None:
        req["temperature"] = args.temperature
    return req


async def _stream_chat(pipeline, req, out) -> Dict[str, Any]:
    """Stream one chat request, echoing deltas to ``out``; returns
    {content, finish_reason, usage}."""
    parts: List[str] = []
    finish = None
    usage: Dict[str, Any] = {}
    stream = await pipeline.generate(Context(req))
    try:
        async for chunk in stream:
            if "__annotations__" in chunk:
                continue
            for ch in chunk.get("choices") or []:
                delta = (ch.get("delta") or {}).get("content") or ch.get("text")
                if delta:
                    parts.append(delta)
                    if out is not None:
                        out.write(delta)
                        out.flush()
                if ch.get("finish_reason"):
                    finish = ch["finish_reason"]
            if chunk.get("usage"):
                usage = chunk["usage"]
    finally:
        await stream.aclose()
    return {"content": "".join(parts), "finish_reason": finish, "usage": usage}


async def run_text_chat(pipeline, model: str, args, *, instream=None, out=None) -> None:
    """Interactive chat REPL with in-session message history (in=text).
    EOF (ctrl-D) or an empty line with ctrl-C exits."""
    instream = instream or sys.stdin
    out = out or sys.stdout
    loop = asyncio.get_running_loop()
    messages: List[dict] = []
    out.write(f"chat with {model!r} — ctrl-D to exit\n")
    while True:
        out.write("> ")
        out.flush()
        line = await loop.run_in_executor(None, instream.readline)
        if not line:  # EOF
            out.write("\n")
            return
        prompt = line.strip()
        if not prompt:
            continue
        messages.append({"role": "user", "content": prompt})
        try:
            result = await _stream_chat(
                pipeline, _chat_request(model, messages, args), out
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — REPL stays alive
            out.write(f"error: {e}\n")
            messages.pop()
            continue
        out.write("\n")
        messages.append({"role": "assistant", "content": result["content"]})


async def run_stdin_prompt(pipeline, model: str, args, *, instream=None, out=None) -> None:
    """Read ONE prompt (whole stdin), stream the completion, exit (in=stdin)."""
    instream = instream or sys.stdin
    out = out or sys.stdout
    loop = asyncio.get_running_loop()
    prompt = (await loop.run_in_executor(None, instream.read)).strip()
    if not prompt:
        raise SystemExit("in=stdin: empty prompt on stdin")
    messages = [{"role": "user", "content": prompt}]
    await _stream_chat(pipeline, _chat_request(model, messages, args), out)
    out.write("\n")


async def run_batch(
    pipeline, model: str, path: str, args, *, concurrency: int = 8, out=None
) -> str:
    """Evaluate every ``{"text": ...}`` line of ``path``; write
    ``output.jsonl`` beside it (in=batch:FILE).  Returns the output path."""
    out = out or sys.stderr
    if not os.path.isfile(path):
        raise SystemExit(f"in=batch: no such file {path!r}")
    with open(path) as f:
        entries = []
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise SystemExit(f"in=batch: {path}:{ln}: invalid JSON ({e})")
            if not isinstance(obj, dict) or not isinstance(obj.get("text"), str):
                raise SystemExit(f'in=batch: {path}:{ln}: need {{"text": ...}}')
            entries.append(obj)

    sem = asyncio.Semaphore(concurrency)
    results: List[Optional[dict]] = [None] * len(entries)
    t0 = time.perf_counter()

    async def one(i: int, entry: dict) -> None:
        async with sem:
            start = time.perf_counter()
            req = _chat_request(model, [{"role": "user", "content": entry["text"]}], args)
            try:
                r = await _stream_chat(pipeline, req, None)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — batch keeps going
                results[i] = dict(entry, response=None, error=str(e))
                return
            usage = r["usage"] or {}
            results[i] = dict(
                entry,
                response=r["content"],
                tokens_in=usage.get("prompt_tokens", 0),
                tokens_out=usage.get("completion_tokens", 0),
                elapsed_ms=int((time.perf_counter() - start) * 1e3),
                finish_reason=r["finish_reason"],
            )

    await asyncio.gather(*[one(i, e) for i, e in enumerate(entries)])
    elapsed = time.perf_counter() - t0

    out_path = os.path.join(os.path.dirname(os.path.abspath(path)), "output.jsonl")
    with open(out_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    tokens_out = sum((r or {}).get("tokens_out", 0) for r in results)
    out.write(
        f"batch: {len(entries)} prompts in {elapsed:.1f}s "
        f"({tokens_out} output tokens, {tokens_out / max(elapsed, 1e-9):.1f} tok/s) "
        f"-> {out_path}\n"
    )
    return out_path
