"""General timestamped stream record/replay.  A copy of the JAX package's
``runtime/recorder.py``.

Reference counterpart: lib/llm/src/recorder.rs (674 LoC) — capture ANY
request/response stream to JSONL with timestamps, replay it later with or
without the original pacing (debugging, billing audit, load reproduction).
The KV-event recorder (llm/kv_router/recorder.py) is the specialized
sibling; this one wraps arbitrary engines/streams.

Line format (one JSON object per line):
  {"ts": <epoch s>, "stream": <id>, "kind": "request"|"item"|"end",
   "data": <payload>}

Usage:
  rec = StreamRecorder(path)
  engine = RecordingEngine(inner_engine, rec)   # drop-in AsyncEngine wrap
  ...
  async for req, items in replay_streams(path): ...        # audit
  await replay_into(path, engine, timed=True)              # load replay
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any, AsyncIterator, Dict, List, Optional, TextIO, Tuple

from .engine import AsyncEngine, Context, ResponseStream


class StreamRecorder:
    """Append-only JSONL for timestamped multi-stream capture."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[TextIO] = open(path, "a", encoding="utf-8")
        self.count = 0

    def record(self, stream: str, kind: str, data: Any) -> None:
        # Tolerate records after close (a stream still draining during
        # shutdown must not blow up its teardown) — they are dropped.
        # Writes are synchronous line appends; heavy production capture
        # should point at fast local disk (the reference's recorder has
        # the same property).
        if self._fh is None or self._fh.closed:
            return
        self._fh.write(
            json.dumps(
                {"ts": time.time(), "stream": stream, "kind": kind, "data": data}
            )
            + "\n"
        )
        self.count += 1

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class RecordingEngine(AsyncEngine):
    """Drop-in AsyncEngine wrapper: records every request and every
    response item flowing through, without altering either (the reference
    wires its recorder the same way, as a pipeline tap)."""

    def __init__(self, inner: AsyncEngine, recorder: StreamRecorder):
        self.inner = inner
        self.recorder = recorder

    def __getattr__(self, name):  # passthrough (metrics, stats, close, ...)
        return getattr(self.inner, name)

    async def generate(self, request: Context) -> ResponseStream:
        sid = request.id or uuid.uuid4().hex
        self.recorder.record(sid, "request", request.data)
        inner_stream = await self.inner.generate(request)
        rec = self.recorder

        async def tap() -> AsyncIterator[Any]:
            try:
                async for item in inner_stream:
                    rec.record(sid, "item", item)
                    yield item
            finally:
                rec.record(sid, "end", None)
                rec.flush()

        return ResponseStream(tap(), request.ctx)


def load_streams(path: str) -> List[Tuple[Dict[str, Any], List[Any], List[float]]]:
    """Parse a recording into [(request, items, timestamps)] per stream,
    in request order."""
    streams: Dict[str, Tuple[Dict[str, Any], List[Any], List[float]]] = {}
    order: List[str] = []
    live: Dict[str, str] = {}  # raw sid → current unique key
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            sid = row["stream"]
            if row["kind"] == "request":
                # Request ids are client-settable and files append across
                # runs, so a sid can repeat — keep every occurrence
                # distinct instead of silently dropping the earlier one.
                key = sid
                n = 1
                while key in streams:
                    key = f"{sid}#{n}"
                    n += 1
                live[sid] = key
                streams[key] = (row["data"], [], [row["ts"]])
                order.append(key)
            elif row["kind"] == "item" and live.get(sid) in streams:
                key = live[sid]
                streams[key][1].append(row["data"])
                streams[key][2].append(row["ts"])
    return [streams[key] for key in order]


async def replay_into(
    path: str, engine: AsyncEngine, timed: bool = False
) -> List[List[Any]]:
    """Re-issue every recorded request against ``engine``.  Untimed:
    strictly serial, in recorded order (deterministic audit diffs).
    Timed: every request LAUNCHES at its recorded offset from the first —
    overlapping recorded load replays as overlapping load, which is the
    point of load reproduction.  Returns each stream's items in recorded
    request order."""
    rows = load_streams(path)
    if not rows:
        return []

    async def one(request) -> List[Any]:
        stream = await engine.generate(Context(request))
        return [item async for item in stream]

    if not timed:
        return [await one(request) for request, _items, _tss in rows]

    t0 = rows[0][2][0]

    async def timed_one(request, offset: float) -> List[Any]:
        await asyncio.sleep(max(0.0, offset))
        return await one(request)

    return list(
        await asyncio.gather(
            *(timed_one(req, tss[0] - t0) for req, _items, tss in rows)
        )
    )
