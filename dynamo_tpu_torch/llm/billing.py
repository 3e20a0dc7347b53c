"""Billing events on the event plane (reference: lib/llm/src/billing.rs:35-67,
the baseten fork's addition): per-request token usage published to the
``token_events`` subject for a metering consumer.  A copy of the JAX
package's ``llm/billing.py``."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Dict, Optional

TOKEN_EVENTS_SUBJECT = "token_events"


@dataclass(frozen=True)
class BillingEvent:
    input_tokens: int
    output_tokens: int
    model: str
    organization_id: Optional[str] = None
    request_id: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "input_tokens": self.input_tokens,
            "output_tokens": self.output_tokens,
            "model": self.model,
            "organization_id": self.organization_id,
            "request_id": self.request_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BillingEvent":
        return cls(
            input_tokens=int(d.get("input_tokens", 0)),
            output_tokens=int(d.get("output_tokens", 0)),
            model=d.get("model", ""),
            organization_id=d.get("organization_id"),
            request_id=d.get("request_id"),
        )


class BillingPublisher:
    def __init__(self, namespace):
        self._namespace = namespace
        self._bg: set = set()

    async def publish(self, event: BillingEvent) -> None:
        await self._namespace.publish(TOKEN_EVENTS_SUBJECT, event.to_dict())

    def publish_nowait(self, event: BillingEvent) -> None:
        task = asyncio.get_event_loop().create_task(self.publish(event))
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)
