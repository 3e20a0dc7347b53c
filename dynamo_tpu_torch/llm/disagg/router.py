"""Local-vs-remote prefill decision with live config (a copy of the JAX
package's ``llm/disagg/router.py``).

Prefill goes remote iff

    prefill_tokens − prefix_hit_tokens > max_local_prefill_length
    AND queue_size < max_prefill_queue_size

and the thresholds live-update from the hub key ``disagg_router/{model}``.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)

from ...runtime.transports.shard import hub_key

CONFIG_PREFIX = "disagg_router/"


def disagg_config_key(model: str) -> str:
    """Live-threshold config key for one model (shard-map routed: DYN401)."""
    return hub_key("disagg_router", model)


@dataclass
class DisaggConfig:
    max_local_prefill_length: int = 512
    max_prefill_queue_size: int = 64

    def to_dict(self) -> dict:
        return {
            "max_local_prefill_length": self.max_local_prefill_length,
            "max_prefill_queue_size": self.max_prefill_queue_size,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DisaggConfig":
        return cls(
            max_local_prefill_length=int(
                d.get("max_local_prefill_length", cls.max_local_prefill_length)
            ),
            max_prefill_queue_size=int(
                d.get("max_prefill_queue_size", cls.max_prefill_queue_size)
            ),
        )


class DisaggregatedRouter:
    def __init__(self, model: str, config: Optional[DisaggConfig] = None):
        self.model = model
        self.config = config or DisaggConfig()
        self._watch_task: Optional[asyncio.Task] = None
        self._watcher = None
        self._hub = None

    def prefill_remote(
        self, prefill_length: int, prefix_hit_length: int, queue_size: int
    ) -> bool:
        return (
            prefill_length - prefix_hit_length > self.config.max_local_prefill_length
            and queue_size < self.config.max_prefill_queue_size
        )

    # ---------------------------------------------------------- live config
    @property
    def config_key(self) -> str:
        return disagg_config_key(self.model)

    async def watch_config(self, hub) -> "DisaggregatedRouter":
        """Start live-updating thresholds from the hub KV."""
        self._hub = hub
        current = await hub.kv_get(self.config_key)
        if current:
            self.config = DisaggConfig.from_dict(current)
        self._watcher = await hub.watch_prefix(self.config_key)
        self._watch_task = asyncio.get_running_loop().create_task(self._watch())
        return self

    async def _watch(self) -> None:
        """Apply config deltas; a crashed watch re-establishes with backoff
        (the same shape as runtime/client.py — a raised watcher must not freeze
        the thresholds stale forever).  The router keeps serving its current
        config throughout; only liveness of UPDATES degrades."""
        backoff = 0.1
        while True:
            try:
                async for event in self._watcher:
                    backoff = 0.1
                    if event.type == "put" and event.value:
                        self.config = DisaggConfig.from_dict(event.value)
                        logger.info(
                            "disagg config updated for %s: %s", self.model, self.config
                        )
                return  # closed cleanly (stop())
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — hub hiccup
                logger.exception("disagg config watch died; re-establishing")
            try:
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)
                old, self._watcher = self._watcher, None
                if old is not None:
                    try:
                        await old.aclose()  # free the hub-side registration
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 — dead watcher
                        pass
                self._watcher = await self._hub.watch_prefix(self.config_key)
                current = await self._hub.kv_get(self.config_key)
                if current:
                    self.config = DisaggConfig.from_dict(current)
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — still down; retry
                pass

    async def stop(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            try:
                await self._watch_task
            except asyncio.CancelledError:
                pass
            self._watch_task = None
        if self._watcher is not None:
            await self._watcher.aclose()


async def publish_config(hub, model: str, config: DisaggConfig) -> None:
    """Operator-side: push new thresholds (hot-reloads every watcher)."""
    await hub.kv_put(disagg_config_key(model), config.to_dict())
