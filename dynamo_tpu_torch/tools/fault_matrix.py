"""Fault-point sweep of the port: arm every injectable fault against the
port's live stack and emit the failure matrix (fault point × observed
behaviour × status code).

The counterpart of the JAX package's ``tools/fault_matrix.py``, over the
port's hub, service plane, routed client, ``HttpService`` (spoken to with
a standard-library client) and, with ``--engine``, a ``TorchEngine``:

    python -m dynamo_tpu_torch.tools.fault_matrix [--json OUT.json] [--md OUT.md]
        [--engine] [--model debug-tiny] [--dtype float32] [--device cpu]

Each row comes from arming the fault (runtime/faultinject.py) against a
live ``HubServer`` + ``ServiceServer`` worker set or an ``HttpService``
edge.  The JSON artifact (schema ``dynamo-tpu-fault-matrix-v2``) carries
``fault_kinds``, every point swept, which the chaos ladder's
``--fault-matrix`` cross-checks (``dynamo_tpu_torch/tools/goodput.py``).
The exit code is 1 when any row observed ``UNEXPECTED`` or ``NOT
RECOVERED`` behaviour.

The device rule holds here too: without ``--device`` the tool needs CUDA
(the ``--engine`` sweep builds its engine there) and raises without it;
``--device cpu`` runs everything on the CPU.
"""

from __future__ import annotations

import argparse
import asyncio
import json
from pathlib import Path
from typing import Optional, Union

import torch

from ..device import default_device
from ..runtime.client import Client
from ..runtime.component import DistributedRuntime
from ..runtime.engine import Context, collect
from ..runtime.faultinject import faults
from ..runtime.resilience import Deadline, DeadlineExceededError, RetryPolicy
from ..runtime.resilience import metrics as resilience_metrics
from ..runtime.transports.hub import HubServer
from ..runtime.transports.service import RemoteEngineError


async def _serve_echo(runtime, n_items=3):
    async def echo(request: Context):
        for i in range(n_items):
            yield {"i": i, "worker": runtime.worker_id}

    ep = runtime.namespace("sweep").component("worker").endpoint("generate")
    await ep.serve_endpoint(echo)
    return ep


async def _client(rt):
    ep = rt.namespace("sweep").component("worker").endpoint("generate")
    c = Client(
        rt.hub,
        ep.instance_prefix,
        retry_policy=RetryPolicy(max_attempts=4, base_delay_s=0.01),
        breaker_reset_s=0.3,
    )
    await c.start()
    await c.wait_for_instances(5)
    return c


async def sweep_runtime() -> list:
    """Runtime-plane faults through the routed Client (3 workers)."""
    rows = []
    hub = await HubServer().start()
    workers = [await DistributedRuntime.connect(hub.address) for _ in range(3)]
    crt = await DistributedRuntime.connect(hub.address)
    try:
        for w in workers:
            await _serve_echo(w)
        client = await _client(crt)
        while len(client.instance_ids) < 3:
            await asyncio.sleep(0.02)
        dead_addr = (await workers[0].service_server()).address

        # connect_error → transparent failover, breaker opens
        faults.arm("connect_error", match=dead_addr)
        ok = 0
        for _ in range(20):
            items = await collect(await client.generate(Context({})))
            ok += len(items) == 3
        breaker = client._breakers[dead_addr].state
        faults.reset()
        rows.append({
            "fault": "connect_error",
            "injected_at": "MuxConnection dial (client → worker TCP)",
            "observed": f"{ok}/20 requests completed via failover; "
                        f"dead worker breaker={breaker.value}",
            "status": "200 (transparent)",
        })

        # error_prologue → failover before first token
        faults.arm("error_prologue", count=1)
        items = await collect(await client.generate(Context({})))
        faults.reset()
        rows.append({
            "fault": "error_prologue",
            "injected_at": "ServiceServer stream setup (prologue ok=false)",
            "observed": f"failed over before first token; "
                        f"{len(items)} items delivered",
            "status": "200 (transparent)",
        })

        # drop_mid_stream → clean error, NO retry (not idempotent)
        faults.arm("drop_mid_stream", count=1)
        got, err = 0, None
        try:
            async for _ in await client.generate(Context({})):
                got += 1
        except RemoteEngineError as e:
            err = type(e).__name__
        faults.reset()
        rows.append({
            "fault": "drop_mid_stream",
            "injected_at": "ServiceServer (transport aborted after an item)",
            "observed": f"{got} tokens delivered, then {err}; no replay "
                        "(post-first-token is not idempotent)",
            "status": "stream error (5xx at edge)",
        })

        # delay + deadline → DeadlineExceeded (504 at edge)
        faults.arm("delay", delay_s=1.0)
        ctx = Context({})
        ctx.ctx.deadline = Deadline.after(0.15)
        try:
            await collect(await client.generate(ctx))
            observed = "UNEXPECTED success"
        except DeadlineExceededError:
            observed = "DeadlineExceededError within budget"
        faults.reset()
        rows.append({
            "fault": "delay (worker stall)",
            "injected_at": "ServiceServer before prologue",
            "observed": observed,
            "status": "504",
        })

        # watch_error → watch restarts, instance set resyncs
        before = resilience_metrics.watch_restarts_total
        faults.arm("watch_error", count=1)
        extra = await DistributedRuntime.connect(hub.address)
        await _serve_echo(extra)
        deadline = asyncio.get_event_loop().time() + 5.0
        while (
            resilience_metrics.watch_restarts_total <= before
            or len(client.instance_ids) < 4
        ) and asyncio.get_event_loop().time() < deadline:
            await asyncio.sleep(0.05)
        faults.reset()
        recovered = len(client.instance_ids) >= 4
        rows.append({
            "fault": "watch_error",
            "injected_at": "hub Watcher stream (client discovery)",
            "observed": "watch re-established + instance set resynced"
                        if recovered else "NOT RECOVERED",
            "status": "none (self-healing)",
        })
        await extra.close()
        # let the extra worker's delete event drain before partitioning
        deadline = asyncio.get_event_loop().time() + 15.0
        while (
            len(client.instance_ids) != 3
            and asyncio.get_event_loop().time() < deadline
        ):
            await asyncio.sleep(0.05)

        # watch_stall → hub partition: stale view, lease expiry still bounds it
        faults.arm("watch_stall")
        stale_view = len(client.instance_ids)
        partition_rt = await DistributedRuntime.connect(hub.address)
        await _serve_echo(partition_rt)
        await asyncio.sleep(0.3)
        unseen = len(client.instance_ids) == stale_view
        faults.reset()
        rows.append({
            "fault": "watch_stall (hub partition)",
            "injected_at": "HubState watcher fanout",
            "observed": ("new instance invisible during partition; "
                         "requests keep flowing to known-live workers"
                         if unseen else "UNEXPECTED: delta leaked"),
            "status": "200 on live workers",
        })
        await partition_rt.close()

        await client.close()
    finally:
        faults.reset()
        for rt in (*workers, crt):
            await rt.close()
        await hub.close()
    return rows


async def sweep_chaos() -> list:
    """Chaos-ladder fault kinds (ISSUE 7): worker_crash / slow_stream /
    hub_outage against a fresh echo fleet, plus the hub restart path."""
    import time as _time

    from ..runtime.health import probe_address, worker_latency
    from ..runtime.resilience import metrics as res

    rows = []
    hub = await HubServer().start()
    workers = [await DistributedRuntime.connect(hub.address) for _ in range(3)]
    crt = await DistributedRuntime.connect(hub.address)
    try:
        for w in workers:
            await _serve_echo(w)
        client = await _client(crt)
        while len(client.instance_ids) < 3:
            await asyncio.sleep(0.02)

        # worker_crash → transport aborted + listener closed; traffic
        # reroutes; the health probe sees the corpse.
        target = await workers[0].service_server()
        dead_addr = target.address
        faults.arm("worker_crash", match=dead_addr, count=1)
        ok = 0
        for _ in range(12):
            try:
                items = await collect(await client.generate(Context({})))
                ok += len(items) == 3
            except RemoteEngineError:
                pass  # the stream that triggered the crash dies mid-flight
        alive = await probe_address(dead_addr, 0.5)
        faults.reset()
        rows.append({
            "fault": "worker_crash",
            "injected_at": "ServiceServer dispatch (aborts every connection, "
                           "stops accepting)",
            "observed": f"{ok}/12 requests completed around the corpse; "
                        f"health probe now {'UNEXPECTEDLY alive' if alive else 'dead'}",
            "status": "200 on survivors",
        })

        # slow_stream → straggler: items delayed, stream completes, and the
        # client-side latency tracker flags the outlier ITL.
        straggler = (await workers[1].service_server()).address
        worker_latency.reset()
        faults.arm("slow_stream", match=straggler, delay_s=0.08)
        t0 = _time.perf_counter()
        for _ in range(6):
            await collect(await client.generate(Context({})))
        elapsed = _time.perf_counter() - t0
        lat = worker_latency.snapshot()
        outlier = max(
            (row.get("itl_p50_ms") or 0.0 for row in lat.values()),
            default=0.0,
        )
        faults.reset()
        rows.append({
            "fault": "slow_stream",
            "injected_at": "ServiceServer response loop (per-item stall)",
            "observed": f"6/6 streams completed in {elapsed:.2f}s; worst "
                        f"per-worker ITL p50 {outlier:.0f}ms (watchdog "
                        "straggler-scan input)",
            "status": "200 (degraded latency)",
        })

        # hub_outage (armed flavour) → connections dropped; reconnect with
        # backoff; KV ops park then succeed once the outage clears.
        before = res.hub_reconnects_total
        faults.arm("hub_outage")
        await asyncio.sleep(0.3)
        put = asyncio.ensure_future(crt.hub.kv_put("sweep/outage", 1))
        await asyncio.sleep(0.4)
        faults.disarm("hub_outage")
        try:
            await asyncio.wait_for(put, 10.0)
            survived = (await crt.hub.kv_get("sweep/outage")) == 1
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — observation, not assertion
            put.cancel()
            survived = False
        rows.append({
            "fault": "hub_outage",
            "injected_at": "HubServer connection plane (accept+drop while "
                           "armed)",
            "observed": ("kv_put parked through the outage and landed after; "
                         if survived else "kv_put DID NOT survive; ")
                        + f"{res.hub_reconnects_total - before} reconnect(s)",
            "status": "paused, then 200",
        })
    finally:
        faults.reset()
        for rt in (*workers, crt):
            await rt.close()
        await hub.close()
    return rows


async def sweep_shards() -> list:
    """``hub_shard_kill`` against a real 2-shard hub (ISSUE 16 / ladder L8):
    a warm ``HubStandby`` follows the shard that owns the ``instances``
    routing token (the same victim the L8 rung picks), the victim's primary
    is actually closed mid-put, and the standby promotes onto the same
    address.  Bars: the owner-shard put parks and lands, the sibling shard
    never blips, the lease floor carries across the handoff, and the
    composite lease breaks (the owner must re-grant, like a hub restart)."""
    from ..runtime.transports.hub import HubStandby
    from ..runtime.transports.shard import ShardedHubClient, ShardMap, hub_key

    rows = []
    hubs = [await HubServer().start() for _ in range(2)]
    smap = ShardMap([h.address for h in hubs])
    victim = smap.shard_of_token("instances")
    sibling = 1 - victim
    standby = await HubStandby(hubs[victim].address).start()
    client = await ShardedHubClient(smap.spec).connect()
    try:
        # One key owned by each shard (crc32 routing is stable per spec).
        keys: dict = {}
        i = 0
        while len(keys) < 2:
            k = hub_key(f"sweep{i}", "x")
            keys.setdefault(smap.shard_for_key(k), k)
            i += 1
        await client.kv_put(keys[victim], "before")
        await client.kv_put(keys[sibling], "before")
        # The shard kill breaks this lease by design: nothing is left to revoke.
        lease = await client.lease_grant(ttl=30.0)  # dynalint: disable=DYN501
        floor_before = hubs[victim].state._next_lease_id

        await hubs[victim].close()  # the shard's primary really dies
        put = asyncio.ensure_future(client.kv_put(keys[victim], "after"))
        await asyncio.sleep(0.3)
        parked = not put.done()
        # The sibling shard owns its keys outright: reads mid-outage.
        sibling_ok = (await client.kv_get(keys[sibling])) == "before"

        hubs[victim] = await standby.promote()
        standby = None
        try:
            await asyncio.wait_for(put, 10.0)
            landed = (await client.kv_get(keys[victim])) == "after"
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — observation, not assertion
            put.cancel()
            landed = False
        floor_after = hubs[victim].state._next_lease_id
        # Leases are deliberately NOT replicated (only the floor is): the
        # promoted shard must report the composite lease dead so the owner
        # re-grants, and must never re-issue an id below the floor.
        broken = not await client.lease_keepalive(lease)
        observed = (
            ("owner-shard kv_put parked through the kill" if parked
             else "UNEXPECTED: kv_put completed against a dead shard")
            + ("; sibling shard served reads mid-outage" if sibling_ok
               else "; UNEXPECTED: sibling shard blipped")
            + ("; put landed after standby promotion" if landed
               else "; UNEXPECTED: put did not land after failover")
            + (f"; lease floor carried ({floor_before}->{floor_after})"
               if floor_after >= floor_before else
               f"; UNEXPECTED: lease floor regressed "
               f"({floor_before}->{floor_after})")
            + ("; composite lease broken (owner re-grants)" if broken
               else "; UNEXPECTED: composite lease outlived the shard's "
                    "lease state")
        )
        rows.append({
            "fault": "hub_shard_kill",
            "injected_at": "one hub shard's primary (real HubServer close + "
                           "HubStandby promotion onto the same address; the "
                           "ChaosFleet L8 flavour)",
            "observed": observed,
            "status": "paused on the dead shard, then 200",
        })
    finally:
        await client.close()
        if standby is not None:
            await standby.close()
        for hub in hubs:
            try:
                await hub.close()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — already-dead primary
                pass
    return rows


async def sweep_engine(device: Union[str, torch.device, None] = None,
                       model: str = "debug-tiny", dtype: str = "float32") -> list:
    """kv_pressure against a real engine (``model``, debug-tiny by
    default, on ``device``): admission stalls while the pool is squeezed
    and drains after.  Builds one engine; opt-in."""
    from ..engine.config import EngineConfig
    from ..engine.engine import TorchEngine

    rows = []
    engine = TorchEngine(EngineConfig(
        model=model, block_size=4, num_blocks=32, max_batch=2,
        max_model_len=128, prefill_chunk=32, dtype=dtype,
        decode_steps=2, pipeline_depth=2,
    ), device=default_device(device))
    try:
        req = {
            "token_ids": list(range(1, 17)),
            "stop_conditions": {"max_tokens": 4, "ignore_eos": True},
            "sampling_options": {"temperature": 0.0, "seed": 1},
        }
        await collect(await engine.generate(Context(dict(req))))  # warm
        faults.arm("kv_pressure", delay_s=0.95)
        task = asyncio.ensure_future(
            collect(await engine.generate(Context(dict(req, token_ids=list(range(20, 44))))))
        )
        await asyncio.sleep(0.4)
        stalled = not task.done()
        faults.reset()
        items = await asyncio.wait_for(task, 30.0)
        rows.append({
            "fault": "kv_pressure",
            "injected_at": "scheduler admission (free-block view squeezed)",
            "observed": ("admission stalled under pressure, "
                         if stalled else "UNEXPECTED: admitted under pressure, ")
                        + f"drained to {len(items)} items after release",
            "status": "delayed TTFT, then 200",
        })

        # tenant_flood → WFQ noisy-neighbor isolation (llm/qos.py): a
        # flooding tenant's backlog must not push another tenant's request
        # to the back of admission — the victim completes before the flood
        # tail (FIFO would finish it strictly last).
        faults.arm("tenant_flood", delay_s=3.0)
        order: list = []

        vocab = engine.model_config.vocab_size

        async def run_one(tenant: str, i: int) -> None:
            # The JAX sweep's ids, wrapped into the vocabulary: the port
            # refuses an id outside it, where the JAX engine clamps.
            ids = [t % vocab for t in range(50 + i * 29, 50 + i * 29 + 12)]
            r = dict(req, token_ids=ids,
                     annotations={"tenant": tenant})
            await collect(await engine.generate(Context(r)))
            order.append(tenant)

        flood_tasks = [
            asyncio.ensure_future(run_one("flood", i)) for i in range(5)
        ]
        await asyncio.sleep(0)  # flood enqueues first
        victim = asyncio.ensure_future(run_one("victim", 7))
        await asyncio.wait_for(
            asyncio.gather(*flood_tasks, victim), 60.0
        )
        faults.reset()
        victim_pos = order.index("victim")
        rows.append({
            "fault": "tenant_flood",
            "injected_at": "trace driver (dynamo_tpu_torch/tools/goodput.py L6 rung; "
                           "armed level = flood rate multiplier)",
            "observed": f"victim tenant finished at position {victim_pos} "
                        f"of {len(order)} behind a 5-request flood backlog "
                        "(WFQ admission; FIFO would finish it last)",
            "status": "200 (fair shares)",
        })
    finally:
        faults.reset()
        await engine.close()
    return rows


async def sweep_integrity() -> list:
    """``kv_corrupt`` per plane against the real integrity boundaries
    (engine/integrity.py; docs/kv_tiering.md §integrity) — store-level, so
    the sweep needs no engine build and runs in every matrix:

    - ``disk``: the ARMED fault flips a payload byte inside
      ``DiskKvStore.read`` (the real hook site); the envelope checksum
      must turn it into a recorded miss, never an array.
    - ``host``: a host-tier entry is bit-flipped in RAM; the offload
      stamp (``HostKvStore.checksum``) must disagree — the check
      ``_restore_pass`` runs before every scatter.
    - ``wire``: a transfer payload's K bytes are flipped; the per-block
      ``payload_block_checksums`` must localize the corrupt block — the
      check ``inject_blocks`` runs before sealing.

    The engine-level consequences (descendant drop, negative cache,
    byte-identical recompute, donor quarantine) are gated by
    tests/test_kv_integrity.py and the goodput L7 rung."""
    import tempfile

    from ..engine.disk_cache import DiskKvStore
    from ..engine.host_cache import HostKvStore
    from ..engine.integrity import (
        block_checksum,
        flip_array_byte,
        payload_block_checksums,
    )

    rows = []
    blk = torch.arange(2 * 4 * 4 * 8, dtype=torch.float32).reshape(2, 4, 4, 8)
    with tempfile.TemporaryDirectory() as d:
        store = DiskKvStore(1 << 20, d)
        assert store.put(7, blk, checksum=block_checksum(blk))
        faults.arm("kv_corrupt", match="disk", count=1)
        arr, _chk, corrupt = store.read(7)
        faults.reset()
        dropped = not store.contains(7)
        rows.append({
            "fault": "kv_corrupt disk",
            "injected_at": "DiskKvStore.read (payload byte flipped after "
                           "the OS read; armed fault point)",
            "observed": (
                "envelope checksum caught the flip, file deleted + loss "
                "recorded" if arr is None and corrupt and dropped
                else "UNEXPECTED: corrupt payload survived validation"
            ),
            "status": "tier miss -> recompute",
        })
    host = HostKvStore(1 << 20)
    host.put(5, blk.clone())
    entry = host.peek(5)
    flipped = flip_array_byte(entry)
    caught = block_checksum(flipped) != host.checksum(5)
    rows.append({
        "fault": "kv_corrupt host",
        "injected_at": "host tier entry (bit flipped in RAM; "
                       "_restore_pass verifies before every scatter)",
        "observed": ("offload stamp disagreed with the flipped bytes"
                     if caught else "UNEXPECTED: flip not detected"),
        "status": "tier drop -> recompute",
    })
    k = blk.reshape(2, 1, 4, 4, 8).repeat(1, 3, 1, 1, 1).contiguous()
    v = k + 1.0
    sums = payload_block_checksums(k, v)
    sums2 = payload_block_checksums(flip_array_byte(k), v)
    bad = [i for i in range(3) if sums[i] != sums2[i]]
    rows.append({
        "fault": "kv_corrupt wire",
        "injected_at": "transfer payload K bytes (inject_blocks verifies "
                       "per block before sealing; covers pull + migration "
                       "push + disagg import)",
        "observed": (
            f"per-block checksums localized the flip to block {bad[0]} "
            "(verified prefix still seals)" if len(bad) == 1
            else "UNEXPECTED: flip not localized"
        ),
        "status": "truncated import -> recompute",
    })
    return rows


async def _post_status(port: int, path: str, body: dict) -> int:
    """POST ``body`` as JSON over a fresh connection (standard library
    only); the response's status, its body read to the end."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    try:
        writer.write((f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n"
                      f"Content-Type: application/json\r\nContent-Length: {len(payload)}\r\n"
                      "\r\n").encode() + payload)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        await reader.read()
        return status
    finally:
        writer.close()
        await writer.wait_closed()


async def sweep_http() -> list:
    """HTTP-edge behaviours: admission shed + deadline + no instances."""
    from ..llm.http_service import HttpService
    from ..runtime.client import NoInstancesError
    from ..runtime.engine import AsyncEngine, ResponseStream

    rows = []

    class SlowEngine(AsyncEngine):
        async def generate(self, request):
            async def gen():
                await asyncio.sleep(0.3)
                yield {
                    "id": "c", "object": "chat.completion.chunk", "created": 0,
                    "model": "m",
                    "choices": [{"index": 0,
                                 "delta": {"role": "assistant", "content": "x"},
                                 "finish_reason": "stop"}],
                }

            return ResponseStream(gen(), request.ctx)

    class NoWorkers(AsyncEngine):
        async def generate(self, request):
            raise NoInstancesError("no instances", prefix="instances/sweep/")

    service = HttpService(
        host="127.0.0.1", port=0,
        max_inflight=2, admission_queue=0, default_deadline_s=2.0,
    )
    service.models.add_chat_model("slow", SlowEngine())
    service.models.add_chat_model("none", NoWorkers())
    await service.start()
    try:
        async def post(model, **extra):
            return await _post_status(service.port, "/v1/chat/completions", {
                "model": model, "messages": [{"role": "user", "content": "x"}], **extra})

        statuses = await asyncio.gather(*[post("slow") for _ in range(8)])
        rows.append({
            "fault": "burst past in-flight cap",
            "injected_at": "HTTP edge (AdmissionController)",
            "observed": f"{statuses.count(200)}×200 (the cap), "
                        f"{statuses.count(429)}/8 shed with Retry-After, "
                        f"{statuses.count(500)}×500",
            "status": "429",
        })
        # per-request budget (0.05s) far below the engine's 0.3s stall
        status = await post("slow", deadline_s=0.05)
        rows.append({
            "fault": "deadline exceeded at edge",
            "injected_at": "HTTP edge (Deadline on response drain)",
            "observed": f"got {status} from a stalled engine",
            "status": str(status),
        })
        status = await post("none")
        rows.append({
            "fault": "no live instances",
            "injected_at": "Client instance set empty",
            "observed": f"got {status} + Retry-After (was a bare 500)",
            "status": str(status),
        })
    finally:
        await service.close()
    return rows


async def sweep_bulk() -> list:
    """``bulk_conn_drop`` / ``bulk_slow_peer`` against a real BulkServer +
    ``bulk_fetch`` client pair (transports/bulk.py; docs/bulk_plane.md).
    The system under test is resume-from-last-verified-chunk plus the
    fallback ladder the goodput L9 chaos rung drives fleet-wide."""
    from ..llm.metrics import bulk_metrics
    from ..runtime.transports.bulk import (
        BulkServer,
        BulkTransferError,
        bulk_fetch,
        mint_ticket,
    )

    rows = []
    blob = bytes(range(256)) * 24  # 6 KiB -> 6 chunks at chunk_bytes=1024
    server = BulkServer(chunk_bytes=1024)

    async def source(meta):
        return blob

    server.register_source("kv_export", source)
    await server.start()
    try:
        bulk_metrics.reset()
        faults.arm("bulk_conn_drop", count=2)
        got = await bulk_fetch(server.address, "kv_export", mint_ticket("w1"))
        faults.reset()
        resumes = int(bulk_metrics.snapshot()["resumes_total"])
        rows.append({
            "fault": "bulk_conn_drop",
            "injected_at": "BulkServer fetch loop (connection aborted after "
                           "a chunk shipped; armed fault point, count=2)",
            "observed": (
                f"client resumed from the last verified chunk ({resumes} "
                "resumes), stream byte-identical"
                if got == blob and resumes >= 1
                else "UNEXPECTED: resume did not reproduce the stream"
            ),
            "status": "resumed -> byte-identical",
        })

        faults.arm("bulk_slow_peer", delay_s=0.2)
        fell_back = False
        try:
            await bulk_fetch(server.address, "kv_export", mint_ticket("w1"),
                             timeout_s=0.3, max_resumes=1)
        except BulkTransferError as exc:
            fell_back = exc.retryable  # the producers' cue for the hub path
        faults.reset()
        rows.append({
            "fault": "bulk_slow_peer",
            "injected_at": "BulkServer chunk loop (0.2s stall before each "
                           "chunk; armed fault point)",
            "observed": (
                "per-attempt timeout converted the straggler into a "
                "retryable error; the caller falls back to the hub path "
                "(then local recompute), stream stays byte-identical"
                if fell_back
                else "UNEXPECTED: straggler not converted to fallback"
            ),
            "status": "fallback -> hub path",
        })
    finally:
        await server.close()
    return rows


def to_markdown(rows: list) -> str:
    lines = [
        "| fault point | injected at | observed behaviour | client status |",
        "|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| `{r['fault']}` | {r['injected_at']} | {r['observed']} "
            f"| {r['status']} |"
        )
    return "\n".join(lines) + "\n"


async def run(args) -> int:
    device = default_device(args.device)
    rows = (await sweep_runtime() + await sweep_chaos() + await sweep_shards()
            + await sweep_http() + await sweep_integrity() + await sweep_bulk())
    if args.engine:
        rows += await sweep_engine(device, args.model, args.dtype)
    md = to_markdown(rows)
    print(md)
    if args.json:
        Path(args.json).write_text(json.dumps({
            "schema": "dynamo-tpu-fault-matrix-v2",
            "fault_kinds": sorted({r["fault"].split(" ")[0] for r in rows}),
            "fault_matrix": rows,
        }, indent=2))
        print(f"wrote {args.json}")
    if args.md:
        Path(args.md).write_text(md)
        print(f"wrote {args.md}")
    return 1 if bad_rows(rows) else 0


def bad_rows(rows: list) -> list:
    """The rows that fail the matrix: observed UNEXPECTED behaviour or a
    fault the stack did NOT RECOVER from."""
    return [r for r in rows if "UNEXPECTED" in r["observed"]
            or "NOT RECOVERED" in r["observed"]]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", default=None, help="write JSON artifact here")
    ap.add_argument("--md", default=None, help="write markdown matrix here")
    ap.add_argument("--engine", action="store_true",
                    help="include the kv_pressure sweep (builds a real engine)")
    ap.add_argument("--model", default="debug-tiny", help="the --engine sweep's model")
    ap.add_argument("--dtype", default="float32", help="the --engine sweep's weight dtype")
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (default: CUDA, required)")
    return ap


def main(argv: Optional[list] = None) -> int:
    return asyncio.run(run(parser().parse_args(argv)))


if __name__ == "__main__":
    raise SystemExit(main())
