"""KV event record/replay (JSONL) — offline router analysis + tests.  A copy
of the JAX package's ``llm/kv_router/recorder.py``.

Reference semantics: lib/llm/src/recorder.rs + kv_router/recorder.rs and the
Python ``KvRecorder.replay_events`` binding (_core.pyi:432-499): capture the
timestamped per-worker event stream to JSONL; replay it later into an
indexer (optionally honouring original timing) to reproduce routing
decisions without a live fleet.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Optional, TextIO, Union

from .indexer import KvIndexer, KvIndexerSharded, WorkerId
from .protocols import KvCacheEvent


class KvRecorder:
    """Append-only JSONL event log: {"ts", "worker_id", "event"}."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[TextIO] = open(path, "a", encoding="utf-8")
        self.count = 0

    def record(self, worker_id: WorkerId, event: KvCacheEvent) -> None:
        assert self._fh is not None, "recorder closed"
        self._fh.write(
            json.dumps(
                {"ts": time.time(), "worker_id": worker_id, "event": event.to_dict()}
            )
            + "\n"
        )
        self.count += 1

    def callback_for(self, worker_id: WorkerId):
        """Engine-compatible event_callback bound to one worker id."""

        def cb(event: KvCacheEvent) -> None:
            self.record(worker_id, event)

        return cb

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


async def replay_events(
    path: str,
    indexer: Union[KvIndexer, KvIndexerSharded],
    timed: bool = False,
    max_count: Optional[int] = None,
) -> int:
    """Feed a recorded JSONL stream into an indexer; returns events applied.

    ``timed=True`` sleeps to reproduce original inter-event gaps (useful for
    soak-style router tests); default replays as fast as possible.
    """
    applied = 0
    prev_ts: Optional[float] = None
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if timed and prev_ts is not None:
                gap = rec["ts"] - prev_ts
                if gap > 0:
                    await asyncio.sleep(min(gap, 1.0))
            prev_ts = rec["ts"]
            indexer.apply_event(rec["worker_id"], KvCacheEvent.from_dict(rec["event"]))
            applied += 1
            if max_count is not None and applied >= max_count:
                break
    return applied
