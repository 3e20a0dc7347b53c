"""Chaos ladder of the port: fleet goodput-under-SLO with escalating fault
injection (``python -m dynamo_tpu_torch.tools.goodput``).

The counterpart of the JAX package's ``benchmarks/goodput.py``, with
``TorchEngine`` workers over the port's runtime, migration, planner,
supervisor, watchdog, bulk plane and object tier.  The rungs, the trace,
the report schema, the ``--check`` bars and the ``--fault-matrix``
cross-check are the JAX ladder's.  Workers run on the card unless
``--device cpu`` is given (without CUDA the ladder raises); ``--model``
and ``--dtype`` pick the engines' model (debug-tiny in f32 by default,
the geometry below otherwise unchanged).

Replay a seeded arrival trace
against a real multi-worker deployment (native engines over the full
hub + service + migration planes, planner signals live, health watchdog
armed) while the fault ladder escalates L0→L4, and report DistServe-style
goodput — the fraction of requests that complete AND meet their TTFT/ITL
SLO — plus the dropped-stream count per rung.  Zero dropped streams is the
acceptance bar: every fault in the ladder is one the resilience stack
claims to survive (seeded resume, migration splice, hub session resume),
so a drop is a regression, not noise.

Ladder rungs (fault fractions are of the trace duration):

====  =======================================================================
L0    no faults — the baseline every other rung is scored against
L1    ``worker_crash`` mid-trace (transport aborted, lease revoked; live
      streams resume seeded on surviving workers)
L2    L1 + ``slow_stream`` straggler window + REAL hub kill/restart during
      the burst (snapshot restore, client session resume, watch re-arm)
L3    L2 + ``kv_pressure`` window (admission squeeze → queue growth)
L4    L3 + ``watch_error``/``error_prologue``/``delay`` storm + a second
      worker crash — the everything-at-once rung
L5    ``worker_crash`` + SUPERVISOR-DRIVEN RESPAWN mid-burst
      (planner/supervisor.py): the crashed worker rejoins the fleet and
      receives one migrated sequence as a rebalance — crashed workers no
      longer stay down for the rung (ROADMAP L5 carry-over)
L6    OVERLOAD: a ``tenant_flood`` fault drives a 3x noisy-neighbor burst
      from one flooding tenant on top of the normal multi-tenant trace;
      the scheduler's WFQ (engine/scheduler.py) must keep the non-flooding
      tenants' goodput >= 0.9x their L0 (isolated) goodput
L7    KV CORRUPTION STORM: ``kv_corrupt`` armed on every integrity plane
      (disk read / host restore / wire inject) while a storm driver
      hammers the tiers — shared-prefix repeat traffic through the client
      with squeezed host budgets (demote → disk-read → restore churn) plus
      export/inject hops between workers.  The integrity plane
      (engine/integrity.py) must detect EVERY injected flip before any
      scatter, drop + negative-cache the poisoned chain, and recompute:
      0 dropped streams, 0 poisoned tokens, byte-identity vs L0
L8    HUB SHARD KILL: one hub shard's primary dies mid-burst and its warm
      standby promotes onto the same address; the sibling shard never
      blips and goodput holds the L2 bar
L9    BULK PEER KILL: a ``_drive_bulk`` driver runs continuous prefix
      pulls over the peer-to-peer bulk plane (transports/bulk.py) while
      ``bulk_conn_drop`` aborts connections mid-chunk (→ resume from the
      last verified chunk), the victim's bulk SERVER is killed outright
      for a window (→ hub-path fallback, then recovery once it
      re-registers), and ``bulk_slow_peer`` stalls chunks late in the
      trace.  Bars: >=1 bulk transfer, >=1 resume, >=1 fallback, a
      post-revival recovery, every bulk stream byte-identical to the
      hub-path oracle, and 0 dropped streams
L10   OBJSTORE SCALE-FROM-ZERO: the fleet runs with the durable object
      tier armed (engine/object_store.py); a driver warms a prefix on
      the crash victim and persists it to the object tier (the autopilot
      ``kv_prefetch persist=True`` path), the victim is killed, and a
      FRESH engine — empty HBM/host/disk, same object directory — is
      spawned into the fleet as a scale-from-zero replacement.  Bars:
      >=1 chain persisted before the crash, the warm start skips >=90%
      of the second-occurrence prefill (restored, not recomputed), and
      the warm stream is byte-identical to the pre-crash run
====  =======================================================================

Determinism: the trace, every request's sampling seed, and the fault
schedule derive from ``--seed``.  Wall-clock latencies (and therefore the
strict goodput number) carry scheduler noise, so the report separates a
``deterministic`` core — per-request outcome, token count, and the hash of
the exact token stream — which is byte-stable across runs of the same seed
and is what the regression test compares.  Every request is also stream-
deterministic across rungs: most carry an explicit seed, and an UNSEEDED
subset (every 5th request) relies on server-side seed resolution — the
engine derives the seed from the FIXED request id, stamps it on the first
stream item, and the routed client resumes with it after crashes
(runtime/client.py _StreamGuard) — so ``--check`` verifies byte-identity
against the L0 control for seeded and unseeded streams alike.  The workers'
engines run ``batch_invariant`` (engine/config.py): a rung's extra traffic
packs the steps differently, and on the card a token's bits would otherwise
follow the step's size.

Usage:
    python -m dynamo_tpu_torch.tools.goodput --levels 0,1,2,5,6 --device cpu \
        --seed 7 [--json out.json] [--check] [--fault-matrix fm.json]

``--check`` exits nonzero unless: every rung has 0 dropped streams, L2
goodput >= 0.85 x L0 goodput, all completed streams are token-identical to
the L0 control, L5 respawned its crashed worker, L6's non-flooding
tenants each retain >= 0.9x their L0 goodput, L7 detected every
injected corruption before scatter (``integrity.detected >= fired >= 1``),
and L10's scale-from-zero replacement restored >=90% of its
second-occurrence prefill from the object tier, byte-identically.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import hashlib
import json
import logging
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..device import default_device

logger = logging.getLogger("goodput")

REPORT_SCHEMA = "dynamo-tpu-goodput-v1"

# Engine geometry for the CPU ladder: small enough to compile fast, big
# enough that 3 workers x max_batch rows exercise real batching/preemption.
# Tiers are ON for every rung (the L0 control must run the exact engine
# shape the corruption rung stresses; the tiering contract is that restores
# are byte-identical, so lower rungs are unaffected beyond offload traffic)
# — run_ladder adds the per-engine disk tier with an explicit directory.
ENGINE_CFG = dict(
    model="debug-tiny",
    block_size=4,
    num_blocks=96,
    max_batch=4,
    max_model_len=256,
    prefill_chunk=32,
    dtype="float32",
    decode_steps=2,
    pipeline_depth=2,
    host_cache_bytes=8 << 20,
    host_offload_interval=0.05,
    # CPU-smoke scale: the production default (30s) would keep a hash
    # banned for the whole rung after its FIRST detection, starving the
    # other planes of restore traffic for the same 9 storm hashes.
    kv_corrupt_ttl_s=1.0,
)

NAMESPACE = "chaos"
COMPONENT = "fleet"

# Multi-tenant trace shape: normal requests round-robin over these fairness
# tenants (engine/scheduler.py WfqQueue keys on them); the L6 noisy
# neighbor floods as FLOOD_TENANT with request ids offset by FLOOD_BASE so
# they never collide with (or get compared against) the control trace.
TENANTS = ("t0", "t1", "t2")
FLOOD_TENANT = "flood"
FLOOD_BASE = 100_000
# L7 corruption-storm traffic: ids offset past the flood band, a few SHARED
# prompts replayed every wave (repeat occurrences are what drive the tier
# demote/restore churn the armed kv_corrupt faults corrupt).  Storm ids
# never appear in the L0 control, so they ride the 0-dropped bar but not
# the cross-rung identity bar (each storm stream is still seeded).
STORM_TENANT = "storm"
CORRUPT_BASE = 200_000
STORM_PROMPTS = 3
# Every UNSEEDED_EVERY-th request omits its sampling seed: server-side
# seed resolution (engine stamps the resolved seed, derived from the fixed
# request id, on the first stream item) must keep these byte-identical
# across rungs and resumable after crashes.
UNSEEDED_EVERY = 5


def _prompt_tokens(i: int, isl: int, vocab: int = 251) -> List[int]:
    # Distinct per request (defeats prefix caching, like random ISL corpora).
    return [(i * 7919 + j * 104729 + 11) % (vocab - 2) + 1 for j in range(isl)]


def _pct(xs: List[float], p: float) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p))]


# --------------------------------------------------------------------------
# Fault schedule
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` at ``at`` (fraction of the trace
    duration), optionally held until ``until``; ``worker`` indexes the
    fleet; ``level`` feeds delay_s/magnitude; ``count`` caps firings."""

    kind: str
    at: float
    until: Optional[float] = None
    worker: Optional[int] = None
    level: float = 0.0
    count: Optional[int] = None
    # Explicit fault-point match key (e.g. the kv_corrupt PLANE: disk /
    # host / wire); None keeps the worker-address / wildcard derivation.
    match: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "at": self.at}
        if self.until is not None:
            out["until"] = self.until
        if self.worker is not None:
            out["worker"] = self.worker
        if self.level:
            out["level"] = self.level
        if self.count is not None:
            out["count"] = self.count
        if self.match is not None:
            out["match"] = self.match
        return out


def ladder_rungs() -> List[Dict[str, Any]]:
    """The canonical L0–L6 ladder (docs/chaos.md documents each rung)."""
    crash1 = FaultEvent("worker_crash", at=0.35, worker=1, count=1)
    slow = FaultEvent("slow_stream", at=0.15, until=0.55, worker=0, level=0.12)
    outage = FaultEvent("hub_outage", at=0.40, until=0.52)
    pressure = FaultEvent("kv_pressure", at=0.50, until=0.80, level=0.6)
    storm = [
        FaultEvent("watch_error", at=0.25, count=2),
        FaultEvent("error_prologue", at=0.45, count=2),
        FaultEvent("delay", at=0.60, until=0.75, level=0.2),
        FaultEvent("worker_crash", at=0.70, worker=2, count=1),
    ]
    # L6: the noisy neighbor — a 3x flood from one tenant while the fault
    # is armed (the trace driver reads the armed level as the rate
    # multiplier; runtime/faultinject.py documents the kind).
    flood = FaultEvent("tenant_flood", at=0.10, until=0.80, level=3.0)
    # L7: kv_corrupt armed on every integrity plane for most of the trace;
    # the storm driver (_drive_corruption) supplies the tier churn the
    # flips land on.  Detection is 1:1 with firings by construction (one
    # flip per read/restore/inject), which is what the check bar compares.
    corrupt = [
        FaultEvent("kv_corrupt", at=0.10, until=0.80, match="disk"),
        FaultEvent("kv_corrupt", at=0.10, until=0.80, match="host"),
        FaultEvent("kv_corrupt", at=0.10, until=0.80, match="wire"),
    ]
    # L8: kill one hub shard's PRIMARY mid-burst; its warm standby promotes
    # onto the same address at ``until`` (runtime/transports/hub.HubStandby).
    # The fleet runs a 2-shard map, so the sibling shard keeps serving its
    # keys throughout and the routed clients ride their local routing cache
    # through the failover window (docs/hub.md).
    shard_kill = FaultEvent("hub_shard_kill", at=0.40, until=0.52)
    # L9: the bulk data plane under fire (docs/bulk_plane.md).  The armed
    # count=2 drop forces mid-chunk aborts the client must RESUME through;
    # the driver additionally kills the victim's bulk server outright over
    # [0.45, 0.70] (a dead peer, not a dropped connection — resume cannot
    # help, the fallback ladder must) and the late slow_peer window stalls
    # chunks without breaking transfers.
    bulk_faults = [
        FaultEvent("bulk_conn_drop", at=0.15, count=2),
        FaultEvent("bulk_slow_peer", at=0.80, until=0.90, level=0.05),
    ]
    return [
        {"level": 0, "name": "L0-baseline", "events": []},
        {"level": 1, "name": "L1-worker-crash", "events": [crash1]},
        {"level": 2, "name": "L2-crash+straggler+hub-restart",
         "events": [slow, crash1, outage]},
        {"level": 3, "name": "L3-kv-pressure",
         "events": [slow, crash1, outage, pressure]},
        {"level": 4, "name": "L4-storm",
         "events": [slow, crash1, outage, pressure, *storm]},
        {"level": 5, "name": "L5-crash+respawn+rebalance",
         "events": [crash1], "supervise": True},
        {"level": 6, "name": "L6-tenant-flood-overload",
         "events": [flood]},
        {"level": 7, "name": "L7-kv-corruption-storm",
         "events": corrupt, "corrupt": True},
        {"level": 8, "name": "L8-hub-shard-kill",
         "events": [shard_kill], "shards": 2},
        {"level": 9, "name": "L9-bulk-peer-kill",
         "events": bulk_faults, "bulk": True},
        # L10: the object tier's reason to exist — the crash victim's KV
        # survives its death, and a from-zero replacement starts warm.
        {"level": 10, "name": "L10-objstore-scale-from-zero",
         "events": [crash1], "objstore": True},
    ]


# --------------------------------------------------------------------------
# Fleet
# --------------------------------------------------------------------------


@dataclass
class _Worker:
    runtime: Any
    engine: Any
    mig: Any
    address: str
    closed: bool = False
    # Migration-target record for this worker (rebalance after respawn).
    target: Dict[str, Any] = field(default_factory=dict)

    def poll(self):
        """Process-handle duck type for planner/supervisor.Supervisor's
        liveness check: None = alive, anything else = exited."""
        return 1 if self.closed else None


class ChaosFleet:
    """One rung's deployment: persistent hub + N migration-capable workers
    (cli worker-mode wiring over shared prewarmed engines) + routed client
    + planner signal plane + health watchdog."""

    def __init__(self, engines: List[Any], persist_path: str,
                 watchdog: bool = True, shards: int = 1):
        self.engines = engines
        self.persist_path = persist_path
        self.enable_watchdog = watchdog
        self.shards = shards
        self.hub = None
        self.hub_port: Optional[int] = None
        # Shard mode (L8): every hub primary, plus one warm standby on the
        # shard that owns the discovery namespace ("instances/...").
        self.hubs: List[Any] = []
        self.standby = None
        self.standby_shard: Optional[int] = None
        self.shard_failovers = 0
        self.workers: List[_Worker] = []
        self.client = None
        self.client_rt = None
        self.collector = None
        self.planner = None
        self.watchdog = None
        self.supervisor = None
        self.respawned = 0
        self.rebalanced = 0
        self._pubs: List[Any] = []

    @property
    def instance_prefix(self) -> str:
        return f"instances/{NAMESPACE}/{COMPONENT}/gen/"

    @property
    def hub_address(self) -> str:
        """Connect spec: one address, or the comma-joined shard map."""
        if self.shards > 1:
            return ",".join(h.address for h in self.hubs)
        return self.hub.address

    async def start(self) -> "ChaosFleet":
        from ..runtime.transports.hub import HubServer

        if self.shards > 1:
            from ..runtime.transports.hub import HubStandby
            from ..runtime.transports.shard import ShardMap

            for i in range(self.shards):
                self.hubs.append(
                    await HubServer(
                        persist_path=f"{self.persist_path}.s{i}",
                        persist_interval_s=0.2,
                    ).start()
                )
            # The standby shadows (and the rung kills) the shard that owns
            # the discovery namespace — the worst-case victim: watches,
            # registrations and leases for instance routing all live there.
            smap = ShardMap([h.address for h in self.hubs])
            self.standby_shard = smap.shard_of_token("instances")
            self.standby = await HubStandby(
                self.hubs[self.standby_shard].address
            ).start()
        else:
            self.hub = await HubServer(
                persist_path=self.persist_path, persist_interval_s=0.2
            ).start()
            self.hub_port = self.hub.port
        for engine in self.engines:
            self.workers.append(await self._spawn_worker(engine))
        await self._start_client_plane()
        return self

    async def _spawn_worker(self, engine) -> _Worker:
        from ..llm.kv_router.publisher import KvMetricsPublisher
        from ..llm.migration import (
            MIGRATE_IN_ENDPOINT,
            MIGRATE_OUT_ENDPOINT,
            MigratableWorker,
        )
        from ..runtime.component import DistributedRuntime

        rt = await DistributedRuntime.connect(
            self.hub_address, lease_ttl=1.5
        )
        mig = MigratableWorker(engine, chunk_blocks=4)
        component = rt.namespace(NAMESPACE).component(COMPONENT)
        gen_ep = component.endpoint("gen")
        in_ep = component.endpoint(MIGRATE_IN_ENDPOINT)
        out_ep = component.endpoint(MIGRATE_OUT_ENDPOINT)
        server = await rt.service_server()
        await in_ep.serve_endpoint(mig.migrate_in_handler)
        await out_ep.serve_endpoint(mig.migrate_out_handler)
        await gen_ep.serve_endpoint(
            mig,
            metadata={
                "role": "decode",
                "migrate": {
                    "import_path": in_ep.path,
                    "out_path": out_ep.path,
                    "generate_path": gen_ep.path,
                },
            },
        )
        try:
            self._pubs.append(
                await KvMetricsPublisher(
                    component, rt.worker_id, engine.metrics
                ).start()
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — signal plane is optional here
            logger.warning("metrics publisher failed to start", exc_info=True)
        worker = _Worker(rt, engine, mig, server.address)

        async def die():
            # worker_crash fired: finish the death the way SIGKILL would —
            # the lease goes with the runtime, so discovery sees the corpse.
            if not worker.closed:
                worker.closed = True
                await rt.close()

        server.on_crash = die
        worker.target = {
            "worker_id": rt.worker_id,
            "address": server.address,
            "import_path": in_ep.path,
            "generate_path": gen_ep.path,
        }
        return worker

    # -- supervisor-driven respawn (L5 rung; ROADMAP carry-over) -----------

    async def start_supervisor(self) -> None:
        """Watch ``planner/targets/decode`` and respawn crashed workers
        (planner/supervisor.py).  The ledger is seeded with the live fleet,
        so only deaths trigger spawns; a respawn reuses the dead worker's
        ENGINE (its process never died — only its runtime/lease) and then
        receives one migrated sequence from the busiest survivor as the
        post-rejoin rebalance."""
        from ..planner.actuate import target_key
        from ..planner.supervisor import Supervisor

        async def spawn(pool: str):
            for idx, worker in enumerate(self.workers):
                if worker.closed:
                    fresh = await self._spawn_worker(worker.engine)
                    self.workers[idx] = fresh
                    self.respawned += 1
                    logger.warning("[supervisor] respawned worker %d", idx)
                    await self._rebalance_to(fresh)
                    return fresh
            return await self._spawn_worker(self.engines[0])

        async def stop(pool: str, handle, drain: str):
            if not handle.closed:
                handle.closed = True
                await handle.runtime.close()

        await self.client_rt.hub.kv_put(
            target_key("decode"),
            {"replicas": len(self.workers), "drain": "migrate"},
        )
        self.supervisor = Supervisor(
            self.client_rt.hub, spawn, stop, pools=["decode"], resync_s=0.25
        )
        self.supervisor.handles["decode"] = list(self.workers)
        await self.supervisor.start()

    async def _rebalance_to(self, worker: _Worker) -> None:
        """Migration rebalance after rejoin: move one live sequence from
        the most loaded survivor onto the fresh worker."""
        donors = [
            w
            for w in self.workers
            if w is not worker and not w.closed and w.engine.live_request_ids()
        ]
        if not donors:
            return
        donor = max(donors, key=lambda w: len(w.engine.live_request_ids()))
        rids = donor.engine.live_request_ids()
        if not rids:
            return
        try:
            if await donor.mig.migrate_out(rids[0], worker.target):
                self.rebalanced += 1
                logger.warning(
                    "[supervisor] rebalanced %s onto respawned worker",
                    rids[0],
                )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — rebalance is best-effort
            logger.warning("post-respawn rebalance failed", exc_info=True)

    async def _start_client_plane(self) -> None:
        from ..planner.policy import DecisionEngine
        from ..planner.service import Planner
        from ..planner.signals import SignalCollector
        from ..runtime.client import Client
        from ..runtime.component import DistributedRuntime
        from ..runtime.resilience import RetryPolicy
        from ..runtime.health import HealthConfig, HealthWatchdog

        self.client_rt = await DistributedRuntime.connect(
            self.hub_address, lease_ttl=1.5
        )
        self.client = Client(
            self.client_rt.hub,
            self.instance_prefix,
            # Attempts sized so the empty-pool wait after a hub restart
            # (watch resync lands before workers re-register) spans the
            # full re-registration window.
            retry_policy=RetryPolicy(
                max_attempts=8, base_delay_s=0.1, max_delay_s=1.0
            ),
            breaker_reset_s=0.5,
        )
        await self.client.start()
        await self.client.wait_for_instances(10)
        component = self.client_rt.namespace(NAMESPACE).component(COMPONENT)
        self.collector = await SignalCollector(
            component, stale_after_s=5.0
        ).start()
        # Planner live in dry-run: its sensing/decision loop runs under
        # chaos (the point), but the smoke fleet is not actuatable.
        self.planner = await Planner(
            self.collector, DecisionEngine(), interval_s=0.5, dry_run=True
        ).start()
        if self.enable_watchdog:
            self.watchdog = await HealthWatchdog(
                self.client_rt.hub,
                self.instance_prefix,
                config=HealthConfig(
                    probe_interval_s=0.3,
                    probe_timeout_s=0.6,
                    quarantine_after=3,
                    straggler_factor=4.0,
                    straggler_min_ms=100.0,
                    straggler_min_samples=4,
                    straggler_streak=2,
                    eject_grace_s=2.0,
                ),
            ).start()

    # -- hub outage (the REAL kind: kill + restart from snapshot) ----------

    async def kill_hub(self) -> None:
        if self.hub is not None:
            await self.hub.close()
            self.hub = None

    async def restart_hub(self) -> None:
        from ..runtime.transports.hub import HubServer

        self.hub = await HubServer(
            port=self.hub_port,
            persist_path=self.persist_path,
            persist_interval_s=0.2,
        ).start()

    # -- shard failover (L8: kill one primary, promote its warm standby) ----

    async def kill_shard_primary(self) -> None:
        assert self.standby_shard is not None and self.hubs
        await self.hubs[self.standby_shard].close()

    async def promote_standby(self) -> None:
        """Standby takes over the dead primary's address; clients observe
        exactly a hub restart on that one shard — reconnect, watch resync,
        lease re-grant — while the sibling shard never blips."""
        from ..runtime.transports.shard import shard_metrics

        assert self.standby is not None and self.standby_shard is not None
        addr = self.hubs[self.standby_shard].address
        self.hubs[self.standby_shard] = await self.standby.promote(
            persist_path=f"{self.persist_path}.s{self.standby_shard}",
            persist_interval_s=0.2,
        )
        self.standby = None
        self.shard_failovers += 1
        shard_metrics.note_failover(addr)

    # -- teardown ----------------------------------------------------------

    async def close(self) -> None:
        if self.supervisor is not None:
            await self.supervisor.stop()
            self.supervisor = None
        for obj in (self.watchdog, self.planner, self.collector):
            if obj is not None:
                await obj.stop()
        for pub in self._pubs:
            try:
                await pub.stop()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                pass
        if self.client is not None:
            await self.client.close()
        if self.client_rt is not None:
            await self.client_rt.close()
        for worker in self.workers:
            if not worker.closed:
                worker.closed = True
                try:
                    await worker.runtime.close()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — crashed mid-rung
                    pass
        if self.standby is not None:
            await self.standby.close()
            self.standby = None
        for hub in self.hubs:
            try:
                await hub.close()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a killed primary mid-rung
                pass
        self.hubs = []
        if self.hub is not None:
            await self.hub.close()
        # Engines outlive the fleet (shared across rungs): wait for any
        # sequences orphaned by a crash to cancel out.
        deadline = time.monotonic() + 5.0
        for engine in self.engines:
            while engine.live_request_ids() and time.monotonic() < deadline:
                await asyncio.sleep(0.05)


# --------------------------------------------------------------------------
# Trace replay
# --------------------------------------------------------------------------


@dataclass
class Outcome:
    i: int
    status: str = "pending"  # ok | dropped
    tokens: int = 0
    token_hash: str = ""
    error: str = ""
    tenant: str = ""
    ttft_ms: Optional[float] = None
    itl_ms: List[float] = field(default_factory=list)


def _tenant_for(i: int) -> str:
    """Deterministic tenant assignment (flood ids live past FLOOD_BASE,
    corruption-storm ids past CORRUPT_BASE)."""
    if i >= CORRUPT_BASE:
        return STORM_TENANT
    return FLOOD_TENANT if i >= FLOOD_BASE else TENANTS[i % len(TENANTS)]


def _request_dict(
    i: int, isl: int, osl: int, seed: int, prompt_i: Optional[int] = None
) -> Dict[str, Any]:
    from ..llm.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    # Every UNSEEDED_EVERY-th normal request omits its seed: the engine
    # resolves one from the FIXED request id (_one_request pins it), so the
    # stream stays byte-deterministic across rungs AND crash-resumable via
    # the resolved-seed stamp (runtime/client.py _StreamGuard).
    # ``prompt_i`` decouples the prompt from the request id so the L7 storm
    # can REPEAT a small prompt set under fresh ids (repeat occurrences are
    # what exercise the tier restore planes).
    unseeded = i < FLOOD_BASE and i % UNSEEDED_EVERY == 2
    return PreprocessedRequest(
        token_ids=_prompt_tokens(i if prompt_i is None else prompt_i, isl),
        stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
        sampling_options=SamplingOptions(
            temperature=0.8, seed=None if unseeded else seed * 100003 + i
        ),
        annotations={"tenant": _tenant_for(i)},
    ).to_dict()


async def prewarm_engine(engine, seed: int = 0) -> None:
    """Capture the device programs (on CUDA) and pay the KV export/inject
    path up front so rung (and test) timings measure serving, not first
    use."""
    from ..runtime.engine import Context, collect

    if engine.device.type == "cuda":
        await engine.run_warmup()
    warm = _request_dict(10_000, 16, 4, seed)
    await collect(await engine.generate(Context(dict(warm))))
    payload = await engine.export_prompt_blocks(list(warm["token_ids"]))
    if payload is not None:
        await engine.inject_blocks(list(warm["token_ids"]), payload)


async def _one_request(
    client, i: int, isl: int, osl: int, seed: int,
    prompt_i: Optional[int] = None,
    trace_ctx=None,
) -> Outcome:
    from ..runtime.engine import Context

    out = Outcome(i=i, tenant=_tenant_for(i))
    tokens: List[int] = []
    t0 = time.monotonic()
    t0_perf = time.perf_counter()
    last = None
    try:
        # FIXED request id: unseeded requests derive their engine-resolved
        # seed from it (crc32(id) ^ engine seed), so the same (ladder seed,
        # i) replays byte-identically on any worker and across rungs.
        req = _request_dict(i, isl, osl, seed, prompt_i)
        ctx = Context.with_id(req, f"g{seed}-{i}")
        if trace_ctx is not None:
            # L0 trace stamping (docs/tracing.md): annotations.trace rides
            # to the engine (queue/prefill/decode spans) and ctx.trace lets
            # the routed client record its route/failover spans — the
            # ladder's cross-runtime assembly is scored in run_rung.
            req["annotations"]["trace"] = trace_ctx.to_dict()
            ctx.ctx.trace = trace_ctx
        stream = await client.generate(ctx)
        async for item in stream:
            now = time.monotonic()
            got = item.get("token_ids") or ()
            if got:
                if out.ttft_ms is None:
                    out.ttft_ms = (now - t0) * 1e3
                elif last is not None:
                    out.itl_ms.append((now - last) * 1e3)
                last = now
                tokens.extend(int(t) for t in got)
    except asyncio.CancelledError:
        raise
    except Exception as e:  # noqa: BLE001 — a dropped stream IS the datum
        out.status = "dropped"
        out.error = type(e).__name__
        return out
    out.status = "ok"
    out.tokens = len(tokens)
    out.token_hash = hashlib.sha256(
        json.dumps(tokens).encode()
    ).hexdigest()[:16]
    if trace_ctx is not None:
        # The driver IS this harness's edge: its root span anchors the
        # aggregator's assembly (and the TTFT decomposition window).
        from ..runtime.tracing import collector as _trace_collector

        _trace_collector.record(
            trace_ctx, "driver.request", "driver",
            t0_perf, time.perf_counter(),
            attrs={"request": i}, parent_id=None,
        )
    return out


async def _drive_fault(
    fleet: ChaosFleet,
    ev: FaultEvent,
    duration: float,
    armed: Optional[List[Any]] = None,
) -> None:
    from ..runtime.faultinject import faults

    await asyncio.sleep(ev.at * duration)
    if ev.kind == "hub_outage":
        logger.warning("[fault] hub kill (restart in %.1fs)",
                       ((ev.until or ev.at) - ev.at) * duration)
        await fleet.kill_hub()
        await asyncio.sleep(max(((ev.until or ev.at) - ev.at) * duration, 0.1))
        await fleet.restart_hub()
        logger.warning("[fault] hub restarted")
        return
    if ev.kind == "hub_shard_kill":
        # The REAL shard failover (not an armed flavour): SIGKILL one
        # shard's primary, hold the window, then promote its warm standby
        # onto the same address (lease floor intact).
        logger.warning("[fault] shard %s primary kill (promote in %.1fs)",
                       fleet.standby_shard,
                       ((ev.until or ev.at) - ev.at) * duration)
        await fleet.kill_shard_primary()
        await asyncio.sleep(max(((ev.until or ev.at) - ev.at) * duration, 0.1))
        await fleet.promote_standby()
        logger.warning("[fault] standby promoted on shard %s",
                       fleet.standby_shard)
        return
    match = ev.match or "*"
    if match == "*" and ev.worker is not None and ev.worker < len(fleet.workers):
        match = fleet.workers[ev.worker].address
    fault = faults.arm(
        ev.kind,
        match=match,
        count=ev.count,
        delay_s=ev.level or 0.05,
    )
    if armed is not None:
        # The disarmed _Fault object keeps its fired count — the L7
        # integrity bar compares detections against it.
        armed.append(fault)
    if ev.until is not None:
        await asyncio.sleep((ev.until - ev.at) * duration)
        faults.disarm(ev.kind, match if match != "*" else None)


async def _drive_flood(
    fleet: ChaosFleet,
    ev: FaultEvent,
    t_start: float,
    *,
    seed: int,
    rate: float,
    duration: float,
    isl: int,
    osl: int,
) -> List[Outcome]:
    """The ``tenant_flood`` fault's hook site: replay a seeded
    noisy-neighbor trace at ``level``x the base rate under FLOOD_TENANT
    across the fault's SCHEDULED window [at, until].  The window gate is
    the schedule itself, not the live armed state — arming/disarming
    happens via wall-clock sleeps in a separate task, and a boundary
    arrival racing them would make the rung's deterministic core differ
    run to run.  (The armed fault remains the rung's declarative record
    of the window; dynamo_tpu_torch/tools/fault_matrix.py sweeps the kind.)"""
    from ..planner.sim import gen_trace

    level = max(ev.level, 1.0)
    trace = gen_trace(
        "burst", rate=rate * level, duration_s=duration,
        seed=seed + 7919, isl=isl, osl=osl,
    )
    lo = ev.at * duration
    hi = (ev.until if ev.until is not None else 1.0) * duration
    tasks: List[asyncio.Task] = []
    try:
        for j, arrival in enumerate(trace):
            if not lo <= arrival.t <= hi:
                continue  # outside the scheduled flood window
            delay = arrival.t - (time.monotonic() - t_start)
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(
                asyncio.ensure_future(
                    _one_request(
                        fleet.client, FLOOD_BASE + j,
                        arrival.isl, arrival.osl, seed,
                    )
                )
            )
        return list(await asyncio.gather(*tasks))
    finally:
        for t in tasks:
            t.cancel()


async def _drive_corruption(
    fleet: ChaosFleet,
    events: List[FaultEvent],
    t_start: float,
    *,
    seed: int,
    duration: float,
    isl: int,
    osl: int,
) -> List[Outcome]:
    """The ``kv_corrupt`` fault's hook-site driver (the L7 storm): keep
    every integrity plane BUSY while the flips are armed.

    Each wave (a) force-evicts the shared storm prefixes out of HBM on
    every live engine (``KvBlockManager.evict_hashes`` — the real LRU
    eviction path, deterministic instead of hoping organic pressure lands
    on exactly these blocks) so the repeats MUST restore from the tiers;
    (b) replays STORM_PROMPTS shared prompts through the routed client
    under fresh ids — the restores walk host→HBM (the ``host`` flip's
    boundary) and, on squeeze waves, disk→host→HBM (the ``disk`` flip's);
    (c) alternates a host-budget squeeze so demotions reach the disk
    tier; and (d) ships one storm prefix between two live workers over
    export/inject — the ``wire`` plane, the same path cross-worker pulls
    and migration pushes ride.  Storm streams are seeded and must
    COMPLETE (detection degrades to recompute, never a drop); original
    host budgets are restored when the storm ends."""
    from ..tokens import hash_token_blocks
    lo = min(ev.at for ev in events) * duration
    hi = max(
        ev.until if ev.until is not None else 1.0 for ev in events
    ) * duration
    outcomes: List[Outcome] = []
    orig_caps: Dict[int, int] = {}
    counter = 0
    wave = 0
    delay = lo - (time.monotonic() - t_start)
    if delay > 0:
        await asyncio.sleep(delay)
    try:
        while time.monotonic() - t_start < hi:
            live = [w for w in fleet.workers if not w.closed]
            # Alternate the host-tier squeeze: even waves shrink the
            # budget so offloads DEMOTE to disk (the disk plane needs real
            # file reads); odd waves restore it so blocks stay
            # host-resident and the next repeat's restore verifies them at
            # the host→HBM boundary (the host plane).
            for w in live:
                eng = w.engine
                if getattr(eng, "host_kv", None) is None:
                    continue
                orig_caps.setdefault(id(eng), eng.host_kv.capacity_bytes)
                eng.host_kv.capacity_bytes = (
                    3 * eng.block_nbytes() if wave % 2 == 0
                    else orig_caps[id(eng)]
                )
            # Deterministic HBM pressure: evict the storm chains so the
            # repeats below restore through the (corrupting) tiers.
            for w in live:
                for p in range(STORM_PROMPTS):
                    w.engine.kv.evict_hashes([
                        tb.sequence_hash
                        for tb in hash_token_blocks(
                            _prompt_tokens(CORRUPT_BASE + p, isl),
                            w.engine.cfg.block_size,
                        )
                    ])
            tasks = [
                asyncio.ensure_future(
                    _one_request(
                        fleet.client, CORRUPT_BASE + counter + p, isl, osl,
                        seed, prompt_i=CORRUPT_BASE + p,
                    )
                )
                for p in range(STORM_PROMPTS)
            ]
            counter += STORM_PROMPTS
            outcomes.extend(await asyncio.gather(*tasks))
            for w in live:
                if w.closed:
                    continue
                try:
                    await w.engine.drain_offload()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — storm churn is best-effort
                    pass
            # Wire plane: one export→inject hop between two live workers
            # (the exact transfer path cross-worker pulls and migration
            # pushes use; the donor restores from its own tiers first).
            if len(live) >= 2:
                donor = live[wave % len(live)].engine
                dst = live[(wave + 1) % len(live)].engine
                toks = _prompt_tokens(CORRUPT_BASE + (wave % STORM_PROMPTS), isl)
                try:
                    await donor.restore_prefix(toks)
                    payload = await donor.export_prompt_blocks(toks)
                    if payload is not None:
                        await dst.inject_blocks(toks, payload)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — best-effort churn
                    logger.warning("storm wire hop failed", exc_info=True)
            wave += 1
            await asyncio.sleep(0.05)
    finally:
        for w in fleet.workers:
            eng = w.engine
            cap = orig_caps.get(id(eng))
            if cap is not None and getattr(eng, "host_kv", None) is not None:
                eng.host_kv.capacity_bytes = cap
    logger.info(
        "[storm] %d corruption-storm requests over %d waves", counter, wave
    )
    return outcomes


async def _drive_bulk(
    fleet: ChaosFleet,
    t_start: float,
    *,
    duration: float,
    kill_at: float = 0.45,
    kill_until: float = 0.70,
) -> Dict[str, Any]:
    """The bulk-plane driver (the L9 rung): run a bulk server per live
    worker (the same wiring ``cli.py start_decode`` does under
    ``DYN_BULK_PLANE``), then pull the prewarmed prefix peer-to-peer in a
    continuous wave loop while the rung's faults land.

    Each wave takes a hub-path ORACLE (a direct ``export_prompt_blocks``
    on the donor — the exact computation the service-plane exporter would
    run) and then fetches the same export over the bulk plane.  A bulk
    miss — dead peer, exhausted resumes — serves the oracle instead (the
    fallback ladder), so no wave ever drops its stream.  Over
    [kill_at, kill_until] the victim worker's bulk server is CLOSED (a
    dead peer, not a dropped connection): waves pinned to it must fall
    back, and after the server re-registers a later wave must complete
    over the bulk plane again (``recovered``).  Byte-identity compares
    the fetched blob against the oracle encodes taken immediately before
    AND after the fetch (the donor's tiers churn under the main trace, so
    one snapshot could legitimately differ)."""
    from ..llm.kv_router.pull import (
        KV_EXPORT_ENDPOINT,
        make_bulk_export_source,
    )
    from ..runtime.transports import codec
    from ..runtime.transports.bulk import (
        BulkRendezvous,
        BulkServer,
        bulk_addr_key,
        bulk_fetch,
    )

    hub = fleet.client_rt.hub

    async def spawn_server(worker) -> BulkServer:
        # Small chunks so the armed conn-drop lands MID-stream and resume
        # has a verified prefix to keep.
        srv = BulkServer(
            worker_id=worker.runtime.worker_id, hub=hub, chunk_bytes=4096
        )
        srv.register_source(
            KV_EXPORT_ENDPOINT, make_bulk_export_source(worker.engine)
        )
        await srv.start()
        await hub.kv_put(
            bulk_addr_key(worker.runtime.worker_id), {"address": srv.address}
        )
        return srv

    workers = [w for w in fleet.workers if not w.closed]
    servers: List[Any] = [await spawn_server(w) for w in workers]
    # Short lookup cache so the revived victim's NEW address is seen
    # within a wave or two of re-registration.
    rdv = BulkRendezvous(hub, cache_ttl_s=0.2)
    warm = _prompt_tokens(10_000, 16)  # the prefix prewarm sealed everywhere
    stats = {
        "pulls": 0, "bulk_ok": 0, "fallbacks": 0, "mismatches": 0,
        "recovered": False,
    }
    victim = 0
    killed = False
    wave = 0
    delay = 0.05 * duration - (time.monotonic() - t_start)
    if delay > 0:
        await asyncio.sleep(delay)
    try:
        while (elapsed := time.monotonic() - t_start) < 0.95 * duration:
            in_kill = kill_at * duration <= elapsed < kill_until * duration
            if in_kill and not killed:
                logger.warning("[bulk] killing worker %d's bulk server", victim)
                await servers[victim].close()
                killed = True
            elif killed and elapsed >= kill_until * duration:
                servers[victim] = await spawn_server(workers[victim])
                killed = False
                logger.warning("[bulk] worker %d's bulk server revived", victim)
            # Pin waves to the victim while it is dead — the fallback path
            # is the thing under test in that window.
            donor = workers[victim if killed else wave % len(workers)]
            eng = donor.engine
            try:
                await eng.restore_prefix(warm)
                oracle = await eng.export_prompt_blocks(warm)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — donor busy; skip the wave
                logger.warning("[bulk] oracle export failed", exc_info=True)
                oracle = None
            if oracle is None:
                wave += 1
                await asyncio.sleep(0.1)
                continue
            oracle_blob = codec.encode(oracle)
            blob = None
            prep = await rdv.prepare(
                donor.runtime.worker_id,
                budget=2 * len(oracle_blob) + (1 << 20),
            )
            if prep is not None:
                try:
                    blob = await bulk_fetch(
                        prep[0], KV_EXPORT_ENDPOINT, prep[1],
                        meta={"token_ids": warm},
                        timeout_s=2.0, max_resumes=2,
                    )
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — dead peer / resumes spent
                    blob = None
            stats["pulls"] += 1
            if blob is None:
                # Hub-path fallback: the oracle IS the stream — no drop.
                stats["fallbacks"] += 1
                from ..llm.metrics import bulk_metrics

                bulk_metrics.fallbacks_total += 1
            else:
                stats["bulk_ok"] += 1
                if not killed and elapsed >= kill_until * duration:
                    stats["recovered"] = True
                if blob != oracle_blob:
                    try:
                        after_blob = codec.encode(
                            await eng.export_prompt_blocks(warm)
                        )
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001
                        after_blob = None
                    if blob != after_blob:
                        stats["mismatches"] += 1
            wave += 1
            await asyncio.sleep(0.1)
    finally:
        for srv in servers:
            try:
                await srv.close()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — victim already closed
                pass
    logger.info("[bulk] %s over %d waves", stats, wave)
    return stats


# L10 warm-prompt id band: past the storm band, never in the L0 control.
OBJSTORE_BASE = 300_000


async def _drive_objstore(
    fleet: "ChaosFleet",
    ev: FaultEvent,
    t_start: float,
    *,
    duration: float,
    seed: int,
    extra_engines: List[Any],
) -> Dict[str, Any]:
    """The L10 driver: persist → crash → scale-from-zero warm start.

    Before the armed ``worker_crash`` fires, a seeded warm request runs on
    the victim's engine and its sealed chain is pushed to the durable
    object tier via ``persist_hashes`` — exactly what the autopilot's
    ``kv_prefetch persist=True`` directive does through the prefetch
    consumer.  After the crash, a FRESH engine (empty HBM/host/disk, the
    victim's ``object_store_dir``) is spawned into the fleet as the
    scale-from-zero replacement; the same request replayed on it must
    restore its prefill from objects (>=90% of blocks matched, not
    recomputed) and stream byte-identically to the pre-crash run.  The
    victim's engine object is NOT closed (only its runtime/lease died),
    mirroring a real node loss where the store outlives the process; the
    byte budget is far above rung traffic, so its idle offload loop can't
    GC the persisted objects out from under the replacement."""
    from ..engine.config import EngineConfig
    from ..engine.engine import TorchEngine
    from ..runtime.engine import Context
    from ..tokens import hash_token_blocks

    victim = fleet.workers[ev.worker or 0]
    engine = victim.engine
    bs = engine.cfg.block_size
    stats: Dict[str, Any] = {
        "persisted": 0, "prompt_blocks": 0, "warm_matched_blocks": 0,
        "skip_frac": 0.0, "byte_identical": False, "crashed": False,
        "rejoined": False,
    }
    isl, osl = 40, 4  # 10 full blocks at the ladder's block_size=4
    stats["prompt_blocks"] = isl // bs
    req = _request_dict(OBJSTORE_BASE, isl, osl, seed)
    prompt = list(req["token_ids"])
    want = []
    async for item in await engine.generate(Context(dict(req))):
        want.extend(item.get("token_ids", []))

    # Settle the offload ladder, then persist the sealed chain durably.
    # ``persist_hashes`` stores only what the object tier lacks, so a
    # chain that reaches the host tier over several pump cycles is
    # persisted over several calls: the count adds up across them (the
    # reference keeps only the last call's, which reads 0 once a first
    # call stored part of the chain).
    chain = [tb.sequence_hash for tb in hash_token_blocks(prompt, bs)]
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        await engine.drain_offload()
        stats["persisted"] += await engine.persist_hashes(chain)
        if stats["persisted"] >= stats["prompt_blocks"] - 1:
            break
        await asyncio.sleep(0.05)

    # Wait for the armed crash to take the victim down.
    while not victim.closed:
        if time.monotonic() - t_start > duration + 5.0:
            return stats  # crash never fired; check_report flags it
        await asyncio.sleep(0.05)
    stats["crashed"] = True

    # Scale from zero: fresh tiers except the durable object directory.
    # The empty disk dir lives beside the fleet's (same kv_root), so the
    # ladder's teardown rmtree sweeps it too.
    fresh_disk = tempfile.mkdtemp(
        prefix="objstore-fresh-",
        dir=str(Path(engine.cfg.disk_cache_dir).parent),
    )
    fresh = TorchEngine(
        dataclasses.replace(
            engine.cfg,
            disk_cache_dir=fresh_disk,
        ),
        params=engine.params,
        device=engine.device,
    )
    extra_engines.append(fresh)  # run_rung closes it after the fleet
    await prewarm_engine(fresh, seed)
    matched0 = fresh.kv.matched_blocks
    got = []
    async for item in await fresh.generate(Context(dict(req))):
        got.extend(item.get("token_ids", []))
    stats["warm_matched_blocks"] = fresh.kv.matched_blocks - matched0
    stats["skip_frac"] = round(
        stats["warm_matched_blocks"] / max(stats["prompt_blocks"], 1), 3
    )
    stats["byte_identical"] = got == want
    # Rejoin the fleet for the remainder of the trace: the replacement is
    # a real serving worker, not a scoring fixture.
    fleet.workers.append(await fleet._spawn_worker(fresh))
    stats["rejoined"] = True
    logger.info("[objstore] %s", stats)
    return stats


async def _score_tracing(trace_agg, trace_exporter, trace_ctxs) -> Dict[str, Any]:
    """The L0 rung's ``tracing`` block: a stamped trace counts as ASSEMBLED
    once the aggregator holds its driver root span plus an ENGINE span —
    i.e. the worker-side instrumentation recorded under the same trace_id
    and the batch crossed the hub event plane.  (driver/client spans are
    recorded by the driving process itself, so they alone prove nothing
    about the worker side.)  ``--check`` bars assembled == sampled."""
    await trace_exporter.flush()
    want = {i: tc.trace_id for i, tc in trace_ctxs.items()}

    def _assembled(tid: str) -> bool:
        t = trace_agg.get(tid)
        if t is None:
            return False
        comps = set(t["components"])
        return "driver" in comps and "engine" in comps

    # Subscription delivery is asynchronous: give late batches a moment.
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if all(_assembled(tid) for tid in want.values()):
            break
        await asyncio.sleep(0.1)
        await trace_exporter.flush()
    assembled = sum(1 for tid in want.values() if _assembled(tid))
    return {
        "sampled": len(want),
        "assembled": assembled,
        "orphan_spans": trace_agg.orphan_spans_total,
    }


async def run_rung(
    engines: List[Any],
    rung: Dict[str, Any],
    *,
    seed: int,
    rate: float,
    duration: float,
    isl: int,
    osl: int,
    persist_path: str,
    slo_ttft_s: float,
    slo_itl_s: float,
    watchdog: bool = True,
) -> Dict[str, Any]:
    from ..planner.sim import gen_trace
    from ..runtime.faultinject import faults
    from ..runtime.health import health_metrics, worker_latency
    from ..runtime.resilience import metrics as res

    from ..llm.metrics import kv_integrity_metrics

    faults.reset()
    worker_latency.reset()
    trace = gen_trace(
        "burst", rate=rate, duration_s=duration, seed=seed, isl=isl, osl=osl
    )
    integrity_before = {
        "corrupt": dict(kv_integrity_metrics.corrupt_total),
        "verified": dict(kv_integrity_metrics.verified_total),
        "negcache": kv_integrity_metrics.negative_cache_hits_total,
        "recomputed": kv_integrity_metrics.recomputed_total,
    }
    before = {
        "reconnects": res.hub_reconnects_total,
        "sessions_resumed": res.hub_sessions_resumed_total,
        "requeued": res.hub_requeued_items_total,
        "stream_resumes": res.stream_resumes_total,
        "migration_splices": res.migration_splices_total,
        "failovers": res.failovers_total,
        "quarantines": health_metrics.quarantines_total,
        "ejections": health_metrics.ejections_total,
    }
    fleet = await ChaosFleet(
        engines, persist_path, watchdog=watchdog,
        shards=rung.get("shards", 1),
    ).start()
    if rung.get("supervise"):
        await fleet.start_supervisor()
    # L0 trace stamping (docs/tracing.md): every 5th seeded request carries
    # a forced TraceContext; span batches publish on the hub's ``traces``
    # subject (the REAL cross-runtime plane) and an aggregator subscribed
    # through the client runtime scores assembly in the rung report.
    trace_agg = trace_exporter = None
    trace_ctxs: Dict[int, Any] = {}
    if rung["level"] == 0:
        from ..llm.trace_service import TraceAggregator
        from ..runtime.tracing import (
            TRACES_TOPIC,
            SpanExporter,
            TraceContext,
        )

        tns = fleet.client_rt.namespace(NAMESPACE)
        trace_agg = await TraceAggregator().start(tns)

        async def _publish_spans(payload):
            await tns.publish(TRACES_TOPIC, payload)

        trace_exporter = await SpanExporter(
            [_publish_spans], interval_s=0.1
        ).start()
        # i % 5 == 0 requests are all SEEDED (unseeded ids are i % 5 == 2),
        # so the stamp set is exactly "every 5th seeded request".
        trace_ctxs = {
            i: TraceContext.new()
            for i in range(len(trace))
            if i % UNSEEDED_EVERY == 0
        }
    t_start = time.monotonic()
    armed: List[Any] = []
    fault_tasks = [
        asyncio.ensure_future(_drive_fault(fleet, ev, duration, armed))
        for ev in rung["events"]
    ]
    req_tasks: List[asyncio.Task] = []
    flood_events = [ev for ev in rung["events"] if ev.kind == "tenant_flood"]
    flood_task = None
    if flood_events:
        flood_task = asyncio.ensure_future(
            _drive_flood(
                fleet, flood_events[0], t_start,
                seed=seed, rate=rate, duration=duration, isl=isl, osl=osl,
            )
        )
    corrupt_events = [ev for ev in rung["events"] if ev.kind == "kv_corrupt"]
    tracing_block = None
    storm_task = None
    if corrupt_events:
        storm_task = asyncio.ensure_future(
            _drive_corruption(
                fleet, corrupt_events, t_start,
                seed=seed, duration=duration, isl=isl, osl=osl,
            )
        )
    bulk_task = None
    bulk_before = None
    bulk_block = None
    if rung.get("bulk"):
        from ..llm.metrics import bulk_metrics

        bulk_before = bulk_metrics.snapshot()
        bulk_task = asyncio.ensure_future(
            _drive_bulk(fleet, t_start, duration=duration)
        )
    objstore_task = None
    objstore_block = None
    extra_engines: List[Any] = []  # the L10 scale-from-zero replacement
    if rung.get("objstore"):
        objstore_task = asyncio.ensure_future(
            _drive_objstore(
                fleet, rung["events"][0], t_start,
                duration=duration, seed=seed, extra_engines=extra_engines,
            )
        )
    try:
        for i, arrival in enumerate(trace):
            delay = arrival.t - (time.monotonic() - t_start)
            if delay > 0:
                await asyncio.sleep(delay)
            req_tasks.append(
                asyncio.ensure_future(
                    _one_request(
                        fleet.client, i, arrival.isl, arrival.osl, seed,
                        trace_ctx=trace_ctxs.get(i),
                    )
                )
            )
        outcomes = list(await asyncio.gather(*req_tasks))
        if trace_agg is not None:
            tracing_block = await _score_tracing(
                trace_agg, trace_exporter, trace_ctxs
            )
        if flood_task is not None:
            # The flood's streams are admitted work too: they count against
            # the 0-dropped bar (and are reported under their own tenant).
            outcomes.extend(await flood_task)
        if storm_task is not None:
            # Same contract for the corruption storm: every storm stream
            # must COMPLETE — detection degrades to recompute, never a drop.
            outcomes.extend(await storm_task)
        if bulk_task is not None:
            from ..llm.metrics import bulk_metrics

            stats = await bulk_task
            snap = bulk_metrics.snapshot()
            bulk_block = {
                **stats,
                "transfers": int(snap["transfers_total"]
                                 - bulk_before["transfers_total"]),
                "resumes": int(snap["resumes_total"]
                               - bulk_before["resumes_total"]),
                "bytes": int(snap["bytes_total"] - bulk_before["bytes_total"]),
                "fault_fired": sum(
                    f.fired for f in armed if f.point.startswith("bulk_")
                ),
            }
        if objstore_task is not None:
            objstore_block = await objstore_task
        await asyncio.gather(*fault_tasks)
    finally:
        for t in (*req_tasks, *fault_tasks):
            t.cancel()
        if flood_task is not None:
            flood_task.cancel()
        if storm_task is not None:
            storm_task.cancel()
        if bulk_task is not None:
            bulk_task.cancel()
        if objstore_task is not None:
            objstore_task.cancel()
        if trace_exporter is not None:
            await trace_exporter.stop(final_flush=False)
        if trace_agg is not None:
            await trace_agg.stop()
        faults.reset()
        await fleet.close()
        for eng in extra_engines:
            try:
                await eng.close()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
    # -- scoring ------------------------------------------------------------
    outcomes = sorted(outcomes, key=lambda o: o.i)
    completed = [o for o in outcomes if o.status == "ok"]
    dropped = [o for o in outcomes if o.status == "dropped"]

    def _in_slo(o: Outcome) -> bool:
        return (
            o.status == "ok"
            and (o.ttft_ms or 0.0) <= slo_ttft_s * 1e3
            and max(o.itl_ms or [0.0]) <= slo_itl_s * 1e3
        )

    within_slo = [o for o in completed if _in_slo(o)]
    # Per-tenant goodput: the L6 fairness bar compares each non-flooding
    # tenant against its own L0 (isolated) number.
    per_tenant: Dict[str, Dict[str, Any]] = {}
    for tenant in sorted({o.tenant for o in outcomes}):
        touts = [o for o in outcomes if o.tenant == tenant]
        per_tenant[tenant] = {
            "requests": len(touts),
            "completed": sum(1 for o in touts if o.status == "ok"),
            "goodput": sum(1 for o in touts if _in_slo(o)) / max(len(touts), 1),
        }
    n = max(len(outcomes), 1)
    delta = lambda k, after: after - before[k]  # noqa: E731
    report = {
        "level": rung["level"],
        "name": rung["name"],
        "faults": [ev.to_dict() for ev in rung["events"]],
        "requests": len(outcomes),
        "completed": len(completed),
        "dropped": len(dropped),
        "dropped_errors": sorted({o.error for o in dropped}),
        "shed": 0,  # no admission control in the direct-client harness
        "supervise": bool(rung.get("supervise")),
        "goodput": len(within_slo) / n,
        "completion_rate": len(completed) / n,
        "per_tenant": per_tenant,
        "ttft_p50_ms": _pct([o.ttft_ms for o in completed if o.ttft_ms], 0.5),
        "ttft_p95_ms": _pct([o.ttft_ms for o in completed if o.ttft_ms], 0.95),
        "itl_p95_ms": _pct(
            [x for o in completed for x in o.itl_ms], 0.95
        ),
        "resilience": {
            "reconnects": delta("reconnects", res.hub_reconnects_total),
            "sessions_resumed": delta(
                "sessions_resumed", res.hub_sessions_resumed_total
            ),
            "requeued": delta("requeued", res.hub_requeued_items_total),
            "stream_resumes": delta("stream_resumes", res.stream_resumes_total),
            "migration_splices": delta(
                "migration_splices", res.migration_splices_total
            ),
            "failovers": delta("failovers", res.failovers_total),
            "quarantines": delta(
                "quarantines", health_metrics.quarantines_total
            ),
            "ejections": delta("ejections", health_metrics.ejections_total),
            "respawns": fleet.respawned,
            "rebalanced": fleet.rebalanced,
            "shard_failovers": fleet.shard_failovers,
        },
        "shards": fleet.shards,
        "deterministic": {
            "outcomes": [
                [o.i, o.status, o.tokens, o.token_hash] for o in outcomes
            ],
            "dropped": len(dropped),
        },
    }
    if tracing_block is not None:
        report["tracing"] = tracing_block
    if bulk_block is not None:
        report["bulk"] = bulk_block
    if objstore_block is not None:
        report["objstore"] = objstore_block
    if corrupt_events:
        # The L7 bars: every armed kv_corrupt firing is one injected flip,
        # and the integrity plane's corrupt counters advance exactly once
        # per detected flip — detected >= fired means nothing scattered
        # undetected ("0 poisoned tokens" is then proven by the generic
        # byte-identity bar over the completed streams).
        planes = {
            p: kv_integrity_metrics.corrupt_total[p]
            - integrity_before["corrupt"][p]
            for p in kv_integrity_metrics.corrupt_total
        }
        report["integrity"] = {
            "fired": sum(f.fired for f in armed if f.point == "kv_corrupt"),
            "detected": sum(planes.values()),
            "planes": planes,
            "verified": sum(kv_integrity_metrics.verified_total.values())
            - sum(integrity_before["verified"].values()),
            "negative_cache_hits": kv_integrity_metrics.negative_cache_hits_total
            - integrity_before["negcache"],
            "recomputed": kv_integrity_metrics.recomputed_total
            - integrity_before["recomputed"],
        }
    return report


# --------------------------------------------------------------------------
# Ladder driver + checks
# --------------------------------------------------------------------------


def check_report(
    report: Dict[str, Any],
    min_ratio: float = 0.85,
    min_tenant_ratio: float = 0.9,
) -> List[str]:
    """The CI bars; returns human-readable violations (empty = pass)."""
    problems: List[str] = []
    rungs = {r["level"]: r for r in report["rungs"]}
    if 0 not in rungs:
        return ["no L0 baseline rung in report"]
    l0 = rungs[0]
    if l0["completed"] == 0:
        problems.append("L0 completed no requests")
    tracing = l0.get("tracing")
    if tracing is not None and tracing["assembled"] != tracing["sampled"]:
        # Cross-runtime span assembly over the hub event plane is a
        # correctness surface of the tracing subsystem (docs/tracing.md):
        # every stamped trace must assemble at the aggregator.
        problems.append(
            f"L0: {tracing['sampled'] - tracing['assembled']} of "
            f"{tracing['sampled']} stamped trace(s) failed to assemble "
            f"(orphan_spans={tracing['orphan_spans']})"
        )
    control = {o[0]: o[3] for o in l0["deterministic"]["outcomes"] if o[1] == "ok"}
    for level, rung in sorted(rungs.items()):
        if rung["dropped"] != 0:
            problems.append(
                f"L{level}: {rung['dropped']} dropped stream(s) "
                f"{rung['dropped_errors']}"
            )
        if level > 0:
            # Flood-tenant ids (>= FLOOD_BASE) never appear in the L0
            # control, so the identity bar covers exactly the shared trace
            # — seeded AND unseeded (server-resolved seed) streams alike.
            for i, status, _tokens, token_hash in rung["deterministic"]["outcomes"]:
                if status == "ok" and i in control and token_hash != control[i]:
                    problems.append(
                        f"L{level}: request {i} token stream diverged from "
                        f"the L0 control (resume/splice not exact)"
                    )
                    break
        if rung.get("supervise") and not rung["resilience"].get("respawns"):
            problems.append(
                f"L{level}: supervised rung respawned no crashed worker"
            )
        if any(ev["kind"] == "kv_corrupt" for ev in rung["faults"]):
            # Corruption rung: every injected flip must be DETECTED before
            # scatter.  Zero firings means the storm never reached the
            # armed planes — a silently-dead rung must fail, not pass.
            integ = rung.get("integrity") or {}
            if integ.get("fired", 0) < 1:
                problems.append(
                    f"L{level}: corruption rung fired no kv_corrupt faults "
                    "(storm never reached the integrity planes)"
                )
            if integ.get("detected", 0) < integ.get("fired", 0):
                problems.append(
                    f"L{level}: {integ.get('fired', 0) - integ.get('detected', 0)} "
                    "injected corruption(s) scattered UNDETECTED "
                    f"(fired={integ.get('fired')} detected={integ.get('detected')})"
                )
        if any(ev["kind"] == "tenant_flood" for ev in rung["faults"]):
            # Noisy-neighbor isolation: every non-flooding tenant keeps >=
            # min_tenant_ratio of its isolated (L0) goodput while the
            # flood runs — the WFQ fairness acceptance bar.
            for tenant, base in (l0.get("per_tenant") or {}).items():
                if tenant == FLOOD_TENANT or base["goodput"] <= 0:
                    continue
                got = (rung.get("per_tenant") or {}).get(tenant, {})
                ratio = got.get("goodput", 0.0) / base["goodput"]
                if ratio < min_tenant_ratio:
                    problems.append(
                        f"L{level}: tenant {tenant!r} goodput "
                        f"{got.get('goodput', 0.0):.3f} is {ratio:.2f}x its "
                        f"L0 {base['goodput']:.3f}; bar is {min_tenant_ratio}"
                    )
    if 2 in rungs and l0["goodput"] > 0:
        ratio = rungs[2]["goodput"] / l0["goodput"]
        if ratio < min_ratio:
            problems.append(
                f"L2 goodput {rungs[2]['goodput']:.3f} is "
                f"{ratio:.2f}x L0 ({l0['goodput']:.3f}); bar is {min_ratio}"
            )
    if 8 in rungs:
        # Shard-failover rung: the standby must actually have promoted
        # (a rung that never failed over proves nothing), and goodput
        # through the failover window holds the same bar as L2's restart.
        if not rungs[8]["resilience"].get("shard_failovers"):
            problems.append(
                "L8: no shard failover occurred (standby never promoted)"
            )
        if l0["goodput"] > 0:
            ratio = rungs[8]["goodput"] / l0["goodput"]
            if ratio < min_ratio:
                problems.append(
                    f"L8 goodput {rungs[8]['goodput']:.3f} is "
                    f"{ratio:.2f}x L0 ({l0['goodput']:.3f}); bar is {min_ratio}"
                )
    if 9 in rungs:
        # Bulk-plane rung: transfers must actually have moved over the
        # peer plane, the armed conn-drops must have forced resumes, the
        # peer kill must have forced hub-path fallbacks AND a post-revival
        # recovery, and every bulk stream must be byte-identical to the
        # hub-path oracle.  (0 dropped is the generic bar above.)
        b = rungs[9].get("bulk") or {}
        if b.get("bulk_ok", 0) < 1:
            problems.append(
                "L9: no transfer completed over the bulk plane"
            )
        if b.get("resumes", 0) < 1:
            problems.append(
                "L9: conn drops forced no resume-from-verified-chunk"
            )
        if b.get("fallbacks", 0) < 1:
            problems.append(
                "L9: the bulk peer kill produced no hub-path fallback"
            )
        if not b.get("recovered"):
            problems.append(
                "L9: no bulk transfer completed after the peer revived"
            )
        if b.get("mismatches", 0):
            problems.append(
                f"L9: {b['mismatches']} bulk stream(s) diverged from the "
                "hub-path oracle (bulk plane not byte-identical)"
            )
    if 10 in rungs:
        # Scale-from-zero rung: the chain must actually have been made
        # durable BEFORE the crash, the replacement must restore (not
        # recompute) >=90% of the second-occurrence prefill, and the warm
        # stream must be byte-identical to the pre-crash run.  A rung
        # where the crash never fired proves nothing and must fail.
        o = rungs[10].get("objstore") or {}
        if not o.get("crashed"):
            problems.append(
                "L10: the armed worker_crash never took the victim down"
            )
        if o.get("persisted", 0) < 1:
            problems.append(
                "L10: no chain persisted to the object tier before the "
                "crash (warming path dead)"
            )
        if o.get("skip_frac", 0.0) < 0.9:
            problems.append(
                f"L10: scale-from-zero warm start skipped only "
                f"{o.get('skip_frac', 0.0):.0%} of second-occurrence "
                f"prefill ({o.get('warm_matched_blocks', 0)}/"
                f"{o.get('prompt_blocks', 0)} blocks); bar is 90%"
            )
        if not o.get("byte_identical"):
            problems.append(
                "L10: warm-start stream diverged from the pre-crash run"
            )
        if not o.get("rejoined"):
            problems.append(
                "L10: the replacement worker never rejoined the fleet"
            )
    return problems


async def run_ladder(args) -> Dict[str, Any]:
    """Run ``args``' rungs.  The engines share the first one's weight tree
    (the same seeded draw each would make), one copy on the device."""
    from ..engine.config import EngineConfig
    from ..engine.engine import TorchEngine

    levels = sorted({int(x) for x in str(args.levels).split(",") if x != ""})
    rungs = [r for r in ladder_rungs() if r["level"] in levels]
    n_workers = max(
        [args.workers]
        + [ev.worker + 1 for r in rungs for ev in r["events"]
           if ev.worker is not None]
    )
    device = default_device(args.device)
    # Batch-invariant engines: --check holds every rung's streams to L0's
    # bit for bit, while each rung's traffic packs the steps differently.
    cfg = dict(ENGINE_CFG, model=args.model, dtype=args.dtype, batch_invariant=True)
    logger.info("building %d engines (%s on %s)", n_workers, cfg["model"], device)
    # Per-engine disk tiers with EXPLICIT directories: the engine-owned
    # per-PID default would collide across the fleet's engines (one
    # process), and the first close() would rmtree everyone's files.
    kv_root = Path(
        tempfile.mkdtemp(prefix="goodput-kv-", dir=args.workdir)
    )
    # The L10 rung arms the durable object tier on EVERY engine (same
    # "exact engine shape for every rung" rule as the disk tiers above —
    # restores are byte-identical, so lower rungs only gain demotion
    # traffic); per-worker directories keep stores process-lifetime
    # disjoint, and the L10 replacement deliberately reuses its victim's.
    objstore = any(r.get("objstore") for r in rungs)
    engines = []
    for i in range(n_workers):
        engines.append(TorchEngine(
            EngineConfig(
                **cfg,
                disk_cache_bytes=8 << 20,
                disk_cache_dir=str(kv_root / f"w{i}"),
                **(
                    {
                        "object_store_bytes": 8 << 20,
                        "object_store_dir": str(kv_root / f"w{i}-objects"),
                    }
                    if objstore
                    else {}
                ),
            ),
            params=engines[0].params if engines else None,
            device=device,
        ))
    for engine in engines:
        await prewarm_engine(engine, args.seed)
    fault_matrix = None
    if args.fault_matrix:
        try:
            fault_matrix = json.loads(Path(args.fault_matrix).read_text())
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("could not read fault matrix %s: %s",
                           args.fault_matrix, e)
    report: Dict[str, Any] = {
        "schema": REPORT_SCHEMA,
        "seed": args.seed,
        "trace": {"shape": "burst", "rate": args.rate,
                  "duration_s": args.duration, "isl": args.isl,
                  "osl": args.osl},
        "slo": {"ttft_s": args.slo_ttft_s, "itl_s": args.slo_itl_s},
        "workers": n_workers,
        "rungs": [],
    }
    try:
        for rung in rungs:
            logger.info("=== rung %s ===", rung["name"])
            persist = str(
                Path(args.workdir) / f"hub-l{rung['level']}.json"
            )
            Path(persist).unlink(missing_ok=True)
            r = await run_rung(
                engines,
                rung,
                seed=args.seed,
                rate=args.rate,
                duration=args.duration,
                isl=args.isl,
                osl=args.osl,
                persist_path=persist,
                slo_ttft_s=args.slo_ttft_s,
                slo_itl_s=args.slo_itl_s,
                watchdog=not args.no_watchdog,
            )
            report["rungs"].append(r)
            logger.info(
                "%s: goodput=%.3f completed=%d/%d dropped=%d resilience=%s",
                rung["name"], r["goodput"], r["completed"], r["requests"],
                r["dropped"], r["resilience"],
            )
    finally:
        for engine in engines:
            await engine.close()
        shutil.rmtree(kv_root, ignore_errors=True)
    if fault_matrix is not None:
        swept = set(fault_matrix.get("fault_kinds") or ()) or {
            row.get("fault", "").split(" ")[0]
            for row in fault_matrix.get("fault_matrix", [])
        }
        used = {ev["kind"] for r in report["rungs"] for ev in r["faults"]}
        report["fault_matrix"] = {
            "path": args.fault_matrix,
            "swept_kinds": sorted(swept),
            "unswept_used_kinds": sorted(
                k for k in used if k != "hub_outage" and k not in swept
            ),
        }
    l0 = next((r for r in report["rungs"] if r["level"] == 0), None)
    for r in report["rungs"]:
        r["goodput_vs_l0"] = (
            r["goodput"] / l0["goodput"]
            if l0 and l0["goodput"] > 0 else None
        )
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--levels", default="0,1,2", help="comma list of rungs")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rate", type=float, default=2.5, help="arrivals/s")
    ap.add_argument("--duration", type=float, default=6.0, help="trace seconds")
    ap.add_argument("--isl", type=int, default=12)
    ap.add_argument("--osl", type=int, default=8)
    ap.add_argument("--workers", type=int, default=3)
    # CPU-smoke SLOs: generous enough that only pathological stalls (a
    # resume that spins, an outage that never heals) violate them — the
    # goodput signal on CI is recovery, not raw speed.  Hardware ladder
    # runs pass real DistServe-style budgets here.
    ap.add_argument("--slo-ttft-s", type=float, default=20.0)
    ap.add_argument("--slo-itl-s", type=float, default=5.0)
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--check", action="store_true",
                    help="enforce the CI bars (exit 1 on violation)")
    ap.add_argument("--min-goodput-ratio", type=float, default=0.85)
    ap.add_argument("--min-tenant-ratio", type=float, default=0.9,
                    help="per-tenant goodput retention bar on flood rungs")
    ap.add_argument("--fault-matrix", default=None,
                    help="a fault matrix --json artifact to cross-check")
    ap.add_argument("--no-watchdog", action="store_true")
    ap.add_argument("--workdir", default=tempfile.gettempdir())
    ap.add_argument("--model", default=ENGINE_CFG["model"], help="the workers' model")
    ap.add_argument("--dtype", default=ENGINE_CFG["dtype"], help="the workers' weight dtype")
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (default: CUDA, required)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    report = asyncio.run(run_ladder(args))
    print(json.dumps(
        {k: v for k, v in report.items() if k != "rungs"}, indent=2
    ))
    for r in report["rungs"]:
        print(json.dumps({k: v for k, v in r.items()
                          if k != "deterministic"}, indent=2))
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2))
        print(f"wrote {args.json}")
    if args.check:
        problems = check_report(
            report, args.min_goodput_ratio, args.min_tenant_ratio
        )
        if problems:
            for p in problems:
                print(f"CHECK FAILED: {p}", file=sys.stderr)
            return 1
        print("all chaos-ladder checks passed "
              f"(levels {[r['level'] for r in report['rungs']]}, "
              "0 dropped streams)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
