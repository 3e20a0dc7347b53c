"""Prefill work queue over the hub's ack/nack queue plane (a copy of the
JAX package's ``llm/disagg/prefill_queue.py``).

A work queue named per model: decode workers enqueue remote-prefill items,
prefill workers pull with at-least-once handoff (un-acked items requeue on
failure, so a dying prefill worker never loses a request).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ...runtime.transports.shard import hub_key


def prefill_queue_name(model: str) -> str:
    """Per-model prefill queue name (shard-map routed: DYN401)."""
    return hub_key("prefill", model)


class PrefillQueue:
    def __init__(self, hub, model: str):
        self.hub = hub
        self.queue_name = prefill_queue_name(model)

    async def enqueue(self, request: Dict[str, Any]) -> None:
        await self.hub.q_push(self.queue_name, request)

    async def dequeue(self):
        """Returns ``(request, ack_token)``; blocks until an item arrives."""
        return await self.hub.q_pop(self.queue_name)

    async def ack(self, token: str) -> bool:
        return await self.hub.q_ack(token)

    async def nack(self, token: str) -> bool:
        return await self.hub.q_nack(token)

    async def size(self) -> int:
        return await self.hub.q_len(self.queue_name)
