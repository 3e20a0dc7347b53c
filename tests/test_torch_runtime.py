"""The port's distributed runtime against the JAX package's.

- The frame codec: the port's own msgpack writes the bytes that
  ``msgpack.packb(obj, use_bin_type=True)`` and the JAX codec write, for
  every value a hypothesis strategy draws from the planes' types, and each
  package decodes the other's; the edge cases (int range, the JSON
  fallback, strict map keys) behave alike; frames cross packages.
- The hub: ``tests/test_hub.py``'s cases on the port's hub, and across
  packages (a JAX client on a port server, and the reverse), the persist
  file included; ``tests/test_hub_shard.py``'s cases on the port's sharded
  client.
- The service plane and the routed client: ``tests/test_distributed.py``'s
  cases on the port, and across packages; the mid-stream resume of a
  greedy stream; the live-migration splice of a ``migrated`` marker, and a
  refusing target's error ending the stream, in both packages alike.
- The resilience/config/health pieces copied for the client, under one
  injected clock.
"""

import asyncio
import importlib
import json
import random
import types

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytestmark = pytest.mark.torch_port

def pkg(name: str) -> types.SimpleNamespace:
    """One package's runtime modules."""
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name,
        codec=m("runtime.transports.codec"),
        hub=m("runtime.transports.hub"),
        shard=m("runtime.transports.shard"),
        service=m("runtime.transports.service"),
        component=m("runtime.component"),
        client=m("runtime.client"),
        engine=m("runtime.engine"),
        resilience=m("runtime.resilience"),
    )


JAX, PORT = pkg("dynamo_tpu"), pkg("dynamo_tpu_torch")
# (server package, client package): the port alone, then across packages.
PAIRS = [(PORT, PORT), (JAX, PORT), (PORT, JAX)]
PAIR_IDS = ["port", "jax-server-port-client", "port-server-jax-client"]


# ---------------------------------------------------------------------- codec

_leaf = (
    st.none()
    | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.sampled_from([0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, -32, -33,
                       -128, -129, -32768, -32769, -(2**31), -(2**31) - 1])
    | st.floats(allow_nan=False)
    | st.text(max_size=40)
    | st.text(min_size=30, max_size=300)
    | st.binary(max_size=300)
)
_values = st.recursive(
    _leaf,
    lambda inner: (
        st.lists(inner, max_size=20)
        | st.tuples(inner, inner)
        | st.dictionaries(st.text(max_size=8) | st.binary(max_size=4), inner, max_size=20)
    ),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_codec_bytes_equal_msgpack_and_jax(value):
    raw = PORT.codec.encode(value)
    assert raw == msgpack.packb(value, use_bin_type=True) == JAX.codec.encode(value)
    expect = msgpack.unpackb(raw, raw=False)
    assert PORT.codec.decode(raw) == expect == JAX.codec.decode(PORT.codec.encode(value))
    assert PORT.codec.decode(JAX.codec.encode(value)) == expect


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_codec_container_and_string_lengths(n):
    """Every length format (fix, 8, 16, 32) of str, bin, array and map."""
    for value in ("x" * n, b"y" * n, list(range(n % 300)) * (1 + n // 300),
                  {str(i): i for i in range(n)}):
        raw = PORT.codec.encode(value)
        assert raw == msgpack.packb(value, use_bin_type=True)
        assert PORT.codec.decode(raw) == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("value", [2**64, -(2**63) - 1, [1, 2**70], {"k": -(2**64)}])
def test_codec_int_out_of_range_raises_overflow(value):
    for p in (PORT, JAX):
        with pytest.raises(OverflowError):
            p.codec.encode(value)


def test_codec_json_fallback_alike():
    """A str with a lone surrogate is msgpack's ValueError: both codecs fall
    back to JSON, byte for byte; a set is a TypeError for msgpack AND for
    the JSON fallback, so both codecs raise it."""
    for value in ("\ud800", {"a": ["ok", "\udfff"]}):
        raw = PORT.codec.encode(value)
        assert raw.startswith(b"\x00json") and raw == JAX.codec.encode(value)
        assert PORT.codec.decode(raw) == JAX.codec.decode(raw) == value
    for p in (PORT, JAX):
        with pytest.raises(TypeError):
            p.codec.encode({1, 2})
        with pytest.raises(TypeError):
            p.codec.encode({"k": {3}})


def test_codec_strict_map_key_on_decode():
    raw = PORT.codec.encode({1: 2})
    assert raw == JAX.codec.encode({1: 2}) == b"\x81\x01\x02"
    for p in (PORT, JAX):
        with pytest.raises(ValueError):
            p.codec.decode(raw)
    for bad in (b"\xcd\x01", b"\x92\x01", b"\x01\x02"):  # truncated, extra data
        with pytest.raises(ValueError):
            PORT.codec.decode(bad)
        with pytest.raises(ValueError):
            JAX.codec.decode(bad)


def test_codec_frame_header_unchanged():
    assert PORT.codec._HDR.format == JAX.codec._HDR.format == ">BII"
    assert PORT.codec.MAX_FRAME == JAX.codec.MAX_FRAME
    assert [(f.name, f.value) for f in PORT.codec.FrameType] == [
        (f.name, f.value) for f in JAX.codec.FrameType]


@pytest.mark.asyncio
async def test_frames_cross_packages():
    """Frames written by one package's ``write_frame`` are read by the
    other's ``read_frame``, over a real socket."""
    payloads = [{"token_ids": [1, 2, 3], "text": "héllo", "finish_reason": None},
                None, [1.5, b"\x00\xff", {"k": True}], "\ud800"]
    for writer_pkg, reader_pkg in ((PORT, JAX), (JAX, PORT)):
        got = []
        done = asyncio.Event()

        async def handle(reader, writer):
            for _ in payloads:
                frame = await reader_pkg.codec.read_frame(reader)
                got.append((int(frame.type), frame.stream, frame.unpack()))
            writer.close()
            done.set()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        _, w = await asyncio.open_connection("127.0.0.1", port)
        for i, p in enumerate(payloads):
            await writer_pkg.codec.write_frame(w, writer_pkg.codec.FrameType.RESP_ITEM, p,
                                               stream=7 + i)
        await asyncio.wait_for(done.wait(), 5)
        w.close()
        server.close()
        await server.wait_closed()
        assert got == [(4, 7 + i, p) for i, p in enumerate(payloads)]


# ------------------------------------------------------------------------ hub


def test_subject_matching_alike():
    cases = [("a.b.c", "a.b.c"), ("a.b.c", "a.b.d"), ("a.*.c", "a.x.c"), ("a.*.c", "a.x.y"),
             ("a.>", "a.b.c.d"), ("a.>", "a"), ("a.b", "a.b.c")]
    assert [PORT.hub.subject_matches(p, s) for p, s in cases] == [
        JAX.hub.subject_matches(p, s) for p, s in cases] == [
        True, False, True, False, True, False, False]


async def _hub_pair(srv, cli):
    server = await srv.hub.HubServer(host="127.0.0.1").start()
    client = await cli.hub.HubClient(server.address).connect()
    return server, client


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_hub_kv_roundtrip(srv, cli):
    server, client = await _hub_pair(srv, cli)
    try:
        await client.kv_put("models/llama", {"ctx": 8192})
        assert await client.kv_get("models/llama") == {"ctx": 8192}
        await client.kv_put("models/mixtral", {"ctx": 32768})
        kvs = await client.kv_get_prefix("models/")
        assert set(kvs) == {"models/llama", "models/mixtral"}
        assert await client.kv_delete("models/llama") is True
        assert await client.kv_get("models/llama") is None
    finally:
        await client.close()
        await server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_hub_watch_snapshot_then_delta(srv, cli):
    server, client = await _hub_pair(srv, cli)
    try:
        await client.kv_put("w/a", 1)
        watcher = await client.watch_prefix("w/")
        ev = await asyncio.wait_for(watcher.__anext__(), 2)
        assert (ev.type, ev.key, ev.value) == ("put", "w/a", 1)
        await client.kv_put("w/b", 2)
        ev = await asyncio.wait_for(watcher.__anext__(), 2)
        assert (ev.type, ev.key) == ("put", "w/b")
        await client.kv_delete("w/a")
        ev = await asyncio.wait_for(watcher.__anext__(), 2)
        assert (ev.type, ev.key) == ("delete", "w/a")
    finally:
        await client.close()
        await server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_hub_lease_expiry_deletes_keys_and_notifies(srv, cli):
    server = await srv.hub.HubServer(host="127.0.0.1").start()
    observer = await cli.hub.HubClient(server.address).connect()
    worker = await cli.hub.HubClient(server.address).connect()
    try:
        watcher = await observer.watch_prefix("inst/")
        lease = await worker.lease_grant(ttl=0.4)
        await worker.kv_put("inst/w1", {"addr": "x"}, lease_id=lease)
        ev = await asyncio.wait_for(watcher.__anext__(), 2)
        assert ev.type == "put"
        await worker.close()  # keepalives stop, the lease expires
        ev = await asyncio.wait_for(watcher.__anext__(), 5)
        assert (ev.type, ev.key) == ("delete", "inst/w1")
        assert await observer.kv_get("inst/w1") is None
    finally:
        await observer.close()
        await server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_hub_lease_keepalive_sustains_past_ttl(srv, cli):
    server, client = await _hub_pair(srv, cli)
    try:
        lease = await client.lease_grant(ttl=0.4)
        await client.kv_put("ka/x", 1, lease_id=lease)
        await asyncio.sleep(1.2)  # > ttl; the client's keepalive loop holds it
        assert await client.kv_get("ka/x") == 1
        await client.lease_revoke(lease)
        assert await client.kv_get("ka/x") is None
    finally:
        await client.close()
        await server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_hub_pubsub_wildcard_fanout(srv, cli):
    server = await srv.hub.HubServer(host="127.0.0.1").start()
    a = await cli.hub.HubClient(server.address).connect()
    b = await srv.hub.HubClient(server.address).connect()  # the other package publishes
    try:
        sub_exact = await a.subscribe("ns.worker.kv_events")
        sub_wild = await a.subscribe("ns.>")
        await asyncio.sleep(0.05)
        payload_in = {"event_id": 1, "f": 0.5, "s": "héllo"}
        await b.publish("ns.worker.kv_events", payload_in)
        subject, payload = await asyncio.wait_for(sub_exact.__anext__(), 2)
        assert payload == payload_in
        subject, payload = await asyncio.wait_for(sub_wild.__anext__(), 2)
        assert subject == "ns.worker.kv_events"
        await sub_exact.aclose()
        await sub_wild.aclose()
    finally:
        await a.close()
        await b.close()
        await server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_hub_queue_at_least_once_redelivery(srv, cli):
    server = await srv.hub.HubServer(host="127.0.0.1").start()
    producer = await srv.hub.HubClient(server.address).connect()
    consumer1 = await cli.hub.HubClient(server.address).connect()
    consumer2 = await cli.hub.HubClient(server.address).connect()
    try:
        await producer.q_push("prefill", {"req": 1})
        item, token = await consumer1.q_pop("prefill")
        assert item == {"req": 1}
        await consumer1.close()  # dies without acking → redelivery
        item2, token2 = await asyncio.wait_for(consumer2.q_pop("prefill"), 2)
        assert item2 == {"req": 1}
        assert await consumer2.q_ack(token2)
        assert await producer.q_len("prefill") == 0
    finally:
        await producer.close()
        await consumer2.close()
        await server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_hub_queue_blocking_pop_then_push(srv, cli):
    server, client = await _hub_pair(srv, cli)
    try:
        pop_task = asyncio.create_task(client.q_pop("jobs"))
        await asyncio.sleep(0.05)
        await client.q_push("jobs", "job-1")
        item, token = await asyncio.wait_for(pop_task, 2)
        assert item == "job-1"
        await client.q_ack(token)
    finally:
        await client.close()
        await server.close()


@pytest.mark.asyncio
async def test_inproc_hub_same_interface():
    hub = await PORT.hub.InprocHub().start()
    try:
        lease = await hub.lease_grant(ttl=5)
        await hub.kv_put("k", "v", lease_id=lease)
        assert await hub.kv_get("k") == "v"
        sub = await hub.subscribe("t.*")
        await hub.publish("t.x", 42)
        _, payload = await asyncio.wait_for(sub.__anext__(), 2)
        assert payload == 42
        await sub.aclose()
        await hub.q_push("q", 1)
        item, token = await hub.q_pop("q")
        assert item == 1 and await hub.q_ack(token)
    finally:
        await hub.close()


@pytest.mark.parametrize("writer,reader", [(PORT, PORT), (PORT, JAX), (JAX, PORT)],
                         ids=["port", "port-writes-jax-reads", "jax-writes-port-reads"])
@pytest.mark.asyncio
async def test_hub_restart_recovers_durable_state(tmp_path, writer, reader):
    """A hub restarted on the same ``--persist`` snapshot keeps durable KV
    and queued work, drops lease-bound keys — whichever package wrote the
    snapshot and whichever reads it."""
    snap = str(tmp_path / "hub.json")
    hub = await writer.hub.HubServer(host="127.0.0.1", persist_path=snap).start()
    port = hub.port
    client = await writer.hub.HubClient(hub.address).connect()
    await client.kv_put("models/m1", {"endpoint": "dyn://a.b.c"})
    await client.q_push("prefill", {"job": 1})
    lease = await client.lease_grant(ttl=30.0)
    await client.kv_put("instances/w1", {"id": 1}, lease_id=lease)
    await client.close()
    await hub.close()  # final snapshot on close
    hub2 = await reader.hub.HubServer(host="127.0.0.1", port=port, persist_path=snap).start()
    try:
        c2 = await reader.hub.HubClient(hub2.address).connect()
        assert await c2.kv_get("models/m1") == {"endpoint": "dyn://a.b.c"}
        assert await c2.kv_get("instances/w1") is None
        item, token = await asyncio.wait_for(c2.q_pop("prefill"), 5)
        assert item == {"job": 1}
        await c2.q_ack(token)
        await c2.close()
    finally:
        await hub2.close()


# ---------------------------------------------------------------- hub shards


def test_shard_routing_alike():
    """Routing is part of the map identity: both packages route every
    key, prefix and subject to the same shard."""
    spec = "a:1, b:2 ,c:3"
    ps, js = PORT.shard.ShardMap.parse(spec), JAX.shard.ShardMap.parse(spec)
    assert ps.spec == js.spec == "a:1,b:2,c:3"
    for token in ("instances", "models", "prefill", "health", "planner", "w", "mdc", "t7"):
        assert ps.shard_of_token(token) == js.shard_of_token(token)
        for parts in ((token, "x"), (token, "x", "y", 7)):
            assert PORT.shard.hub_key(*parts) == JAX.shard.hub_key(*parts)
            assert ps.shard_for_key(PORT.shard.hub_key(*parts)) == ps.shard_of_token(token)
        assert ps.shard_for_prefix(PORT.shard.hub_prefix(token)) == ps.shard_of_token(token)
        assert PORT.shard.hub_subject(token, "t") == JAX.shard.hub_subject(token, "t")
    one = PORT.shard.ShardMap.parse("a:1")
    assert one.shard_for_key("anything/at/all") == 0 and one.shard_for_subject("*.kv") == 0
    two = PORT.shard.ShardMap.parse("a:1,b:2")
    for bad in (lambda: two.shard_for_prefix("inst"), lambda: two.shard_for_subject(">")):
        with pytest.raises(PORT.shard.CrossShardError):
            bad()
    with pytest.raises(ValueError):
        PORT.shard.hub_key("")


async def _shard_pair(p):
    hubs = [await p.hub.HubServer(host="127.0.0.1").start() for _ in range(2)]
    smap = p.shard.ShardMap([h.address for h in hubs])
    client = await p.shard.ShardedHubClient(smap.spec).connect()
    return hubs, smap, client


def _keys_per_shard(p, smap):
    keys, i = {}, 0
    while len(keys) < len(smap):
        k = p.shard.hub_key(f"t{i}", "x")
        keys.setdefault(smap.shard_for_key(k), k)
        i += 1
    return keys


async def _close_all(client, hubs, standby=None):
    await client.close()
    if standby is not None:
        await standby.close()
    for h in hubs:
        try:
            await h.close()
        except Exception:  # noqa: BLE001 — already-dead primary
            pass


@pytest.mark.asyncio
async def test_shard_outage_parks_only_its_own_keys():
    hubs, smap, client = await _shard_pair(PORT)
    standby = await PORT.hub.HubStandby(hubs[0].address).start()
    try:
        keys = _keys_per_shard(PORT, smap)
        await client.kv_put(keys[0], "a")
        await client.kv_put(keys[1], "b")
        await hubs[0].close()
        put = asyncio.ensure_future(client.kv_put(keys[0], "a2"))
        await asyncio.sleep(0.25)
        assert not put.done()  # parked on the dead shard
        assert await client.kv_get(keys[1]) == "b"
        await client.kv_put(keys[1], "b2")
        assert await client.kv_get(keys[1]) == "b2"
        hubs[0] = await standby.promote()
        standby = None
        await asyncio.wait_for(put, 10)
        assert await client.kv_get(keys[0]) == "a2"
    finally:
        await _close_all(client, hubs, standby)


@pytest.mark.asyncio
async def test_shard_standby_promotion_preserves_lease_floor():
    primary = await PORT.hub.HubServer(host="127.0.0.1").start()
    standby = await PORT.hub.HubStandby(primary.address).start()
    client = await PORT.hub.HubClient(primary.address).connect()
    promoted = None
    try:
        for _ in range(3):
            await client.lease_grant(ttl=30.0)
        floor = primary.state._next_lease_id
        await client.kv_put("durable/x", 1)
        await client.close()
        await primary.close()
        promoted = await standby.promote()
        standby = None
        assert promoted.state._next_lease_id >= floor
        c2 = await PORT.hub.HubClient(promoted.address).connect()
        try:
            assert await c2.kv_get("durable/x") == 1
            assert await c2.lease_grant(ttl=30.0) >= floor
        finally:
            await c2.close()
    finally:
        if standby is not None:
            await standby.close()
        for server in (promoted, primary):
            if server is not None:
                try:
                    await server.close()
                except Exception:  # noqa: BLE001
                    pass


@pytest.mark.asyncio
async def test_shard_watch_rearm_after_failover():
    hubs, smap, client = await _shard_pair(PORT)
    standby = await PORT.hub.HubStandby(hubs[0].address).start()
    try:
        keys = _keys_per_shard(PORT, smap)
        prefix = PORT.shard.hub_prefix(keys[0].split("/", 1)[0])
        await client.kv_put(keys[0], 1)
        watcher = await client.watch_prefix(prefix)
        ev = await asyncio.wait_for(watcher.__anext__(), 2)
        assert (ev.type, ev.key, ev.value) == ("put", keys[0], 1)
        await hubs[0].close()
        hubs[0] = await standby.promote()
        standby = None
        with pytest.raises(PORT.hub.HubSessionLost):
            await asyncio.wait_for(watcher.__anext__(), 5)
        watcher2 = await client.watch_prefix(prefix)
        ev = await asyncio.wait_for(watcher2.__anext__(), 5)
        assert (ev.type, ev.key, ev.value) == ("put", keys[0], 1)
    finally:
        await _close_all(client, hubs, standby)


@pytest.mark.asyncio
async def test_shard_composite_lease_and_queue_tokens():
    hubs, smap, client = await _shard_pair(PORT)
    try:
        keys = _keys_per_shard(PORT, smap)
        lease = await client.lease_grant(ttl=5.0)
        await client.kv_put(keys[0], "x", lease_id=lease)
        await client.kv_put(keys[1], "y", lease_id=lease)
        assert await client.lease_keepalive(lease) is True
        await client.lease_revoke(lease)
        assert await client.kv_get(keys[0]) is None and await client.kv_get(keys[1]) is None
        assert await client.lease_keepalive(lease) is False
        with pytest.raises(PORT.shard.CrossShardError):
            await client.watch_prefix("inst")
        with pytest.raises(PORT.shard.CrossShardError):
            await client.subscribe("*.kv_events")
        q = PORT.shard.hub_key("prefill", "m")
        await client.q_push(q, {"r": 1})
        item, token = await client.q_pop(q)
        assert item == {"r": 1} and ":" in token
        assert await client.q_ack(token) is True and await client.q_len(q) == 0
    finally:
        await _close_all(client, hubs)


@pytest.mark.asyncio
async def test_shard_park_buffer_sheds_oldest_idempotent():
    server = await PORT.hub.HubServer(host="127.0.0.1").start()
    client = await PORT.hub.HubClient(server.address).connect()
    client.PARK_MAX_REQUESTS = 2
    puts: list = []
    try:
        await client.kv_put("p/seed", 0)
        await server.close()
        await asyncio.sleep(0.1)
        puts = [asyncio.ensure_future(client.kv_put(f"p/{i}", i)) for i in range(4)]
        await asyncio.sleep(0.3)
        done = [p for p in puts if p.done()]
        assert done == puts[:2]
        for p in done:
            with pytest.raises(ConnectionError):
                p.result()
    finally:
        await client.close()
        await asyncio.gather(*puts, return_exceptions=True)
        try:
            await server.close()
        except Exception:  # noqa: BLE001
            pass


@pytest.mark.asyncio
async def test_edge_health_and_metrics_surface_shards():
    """The port's edge: /health's ``hub_shards`` table (degraded on a down
    shard) and the ``dynamo_tpu_hub_shard_*`` block on /metrics."""
    from dynamo_tpu_torch.llm.http_service import HttpService

    hubs, smap, client = await _shard_pair(PORT)
    service = await HttpService(host="127.0.0.1", port=0, hub=client).start()

    async def get(path):
        r, w = await asyncio.open_connection("127.0.0.1", service.port)
        w.write(f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode())
        raw = await r.read()
        w.close()
        return raw.split(b"\r\n\r\n", 1)[1]

    try:
        body = json.loads(await get("/health"))
        assert body["status"] == "ok"
        assert [s["connected"] for s in body["hub_shards"]] == [True, True]
        await hubs[0].close()
        await asyncio.sleep(0.15)
        body = json.loads(await get("/health"))
        assert body["status"] == "degraded"
        assert [s["connected"] for s in body["hub_shards"]] == [False, True]
        text = (await get("/metrics")).decode()
        for family in ("dynamo_tpu_hub_shard_connects_total",
                       "dynamo_tpu_hub_shard_failovers_total",
                       "dynamo_tpu_hub_shard_routing_cache_staleness_seconds"):
            assert family in text
    finally:
        await service.close()
        await _close_all(client, hubs)


# ------------------------------------------------- service plane and client


def _echo(runtime):
    async def echo(request):
        for tok in request.data["tokens"]:
            yield {"token": tok, "worker": runtime.worker_id}

    return echo


async def _serve_echo(p, runtime, ns="test", comp="worker", ep="generate"):
    endpoint = runtime.namespace(ns).component(comp).endpoint(ep)
    return endpoint, await endpoint.serve_endpoint(_echo(runtime))


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_serve_and_call_remote_endpoint(srv, cli):
    """The worker (``srv``'s runtime, on its hub) serves; ``cli``'s routed
    client calls it."""
    hub_server = await srv.hub.HubServer(host="127.0.0.1").start()
    worker_rt = await srv.component.DistributedRuntime.connect(hub_server.address)
    client_rt = await cli.component.DistributedRuntime.connect(hub_server.address)
    try:
        await _serve_echo(srv, worker_rt)
        endpoint = client_rt.namespace("test").component("worker").endpoint("generate")
        client = await endpoint.client()
        await client.wait_for_instances(2)
        items = await cli.engine.collect(await client.generate(cli.engine.Context({"tokens": [1, 2, 3]})))
        assert [i["token"] for i in items] == [1, 2, 3]
        await client.close()
    finally:
        await worker_rt.close()
        await client_rt.close()
        await hub_server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_remote_cancellation_stops_worker(srv, cli):
    hub_server = await srv.hub.HubServer(host="127.0.0.1").start()
    worker_rt = await srv.component.DistributedRuntime.connect(hub_server.address)
    client_rt = await cli.component.DistributedRuntime.connect(hub_server.address)
    worker_saw_stop = asyncio.Event()
    try:
        async def slow(request):
            for i in range(1000):
                if request.is_stopped:
                    worker_saw_stop.set()
                    return
                yield {"i": i}
                await asyncio.sleep(0.01)

        await worker_rt.namespace("t").component("w").endpoint("gen").serve_endpoint(slow)
        client = await client_rt.namespace("t").component("w").endpoint("gen").client()
        await client.wait_for_instances(2)
        req = cli.engine.Context({})
        stream = await client.generate(req)
        got = []
        async for item in stream:
            got.append(item)
            if len(got) == 3:
                req.stop_generating()
                break
        await asyncio.wait_for(worker_saw_stop.wait(), 3)
        await stream.aclose()
        await client.close()
    finally:
        await worker_rt.close()
        await client_rt.close()
        await hub_server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_round_robin_failover_and_direct_routing(srv, cli):
    hub_server = await srv.hub.HubServer(host="127.0.0.1").start()
    w1 = await srv.component.DistributedRuntime.connect(hub_server.address)
    w2 = await srv.component.DistributedRuntime.connect(hub_server.address)
    client_rt = await cli.component.DistributedRuntime.connect(hub_server.address)
    Ctx = cli.engine.Context
    try:
        await _serve_echo(srv, w1)
        await _serve_echo(srv, w2)
        ep = client_rt.namespace("test").component("worker").endpoint("generate")
        client = await ep.client(router_mode=cli.client.RouterMode.ROUND_ROBIN)
        await client.wait_for_instances(2)
        while len(client.instance_ids) < 2:
            await asyncio.sleep(0.02)
        for target in (w1.worker_id, w2.worker_id):
            items = await cli.engine.collect(await client.direct(Ctx({"tokens": [9]}), target))
            assert items[0]["worker"] == target
        seen = set()
        for _ in range(4):
            items = await cli.engine.collect(await client.generate(Ctx({"tokens": [0]})))
            seen.add(items[0]["worker"])
        assert seen == {w1.worker_id, w2.worker_id}
        await w1.close()  # worker 1 leaves: lease revoked, instance set shrinks
        while w1.worker_id in client.instance_ids:
            await asyncio.sleep(0.05)
        for _ in range(3):
            items = await cli.engine.collect(await client.generate(Ctx({"tokens": [0]})))
            assert items[0]["worker"] == w2.worker_id
        await client.close()
    finally:
        await w2.close()
        await client_rt.close()
        await hub_server.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_remote_errors_propagate(srv, cli):
    """A mid-stream engine error and an unknown endpoint reach the caller
    as its package's ``RemoteEngineError``."""
    hub_server = await srv.hub.HubServer(host="127.0.0.1").start()
    worker_rt = await srv.component.DistributedRuntime.connect(hub_server.address)
    client_rt = await cli.component.DistributedRuntime.connect(hub_server.address)
    try:
        async def failing(request):
            yield {"ok": 1}
            raise ValueError("engine exploded")

        await worker_rt.namespace("t").component("w").endpoint("fail").serve_endpoint(failing)
        client = await client_rt.namespace("t").component("w").endpoint("fail").client()
        await client.wait_for_instances(2)
        stream = await client.generate(cli.engine.Context({}))
        with pytest.raises(cli.service.RemoteEngineError, match="engine exploded"):
            await cli.engine.collect(stream)
        await client.close()
        server = await worker_rt.service_server()
        bad = cli.service.RemoteEngine(server.address, "no.such.endpoint")
        with pytest.raises(cli.service.RemoteEngineError, match="no such endpoint"):
            await bad.generate(cli.engine.Context({}))
    finally:
        await worker_rt.close()
        await client_rt.close()
        await hub_server.close()


@pytest.mark.asyncio
async def test_detached_runtime_inproc():
    runtime = await PORT.component.DistributedRuntime.detached()
    try:
        await _serve_echo(PORT, runtime)
        client = await runtime.namespace("test").component("worker").endpoint("generate").client()
        await client.wait_for_instances(2)
        items = await PORT.engine.collect(await client.generate(PORT.engine.Context({"tokens": [7]})))
        assert items[0]["token"] == 7
        await client.close()
    finally:
        await runtime.close()


@pytest.mark.parametrize("srv,cli", PAIRS, ids=PAIR_IDS)
@pytest.mark.asyncio
async def test_multiplexed_streams_share_one_connection(srv, cli):
    class Echo(srv.engine.AsyncEngine):
        async def generate(self, request):
            async def gen():
                await asyncio.sleep(0.01)  # keep streams concurrently open
                yield {"v": request.data["i"]}

            return srv.engine.ResponseStream(gen(), request.ctx)

    server = await srv.service.ServiceServer().start()
    server.register("e", Echo())
    try:
        eng = cli.service.RemoteEngine(server.address, "e")
        outs = await asyncio.gather(
            *[cli.engine.collect(await eng.generate(cli.engine.Context({"i": i}))) for i in range(8)]
        )
        assert [o[0]["v"] for o in outs] == list(range(8))
        conn = await cli.service.MuxConnection.get(server.address)
        assert next(conn._sid) > 8  # all 8 streams rode the same connection
        conn._close_transport()
    finally:
        await server.close()


@pytest.mark.asyncio
async def test_deadline_propagates_to_the_worker():
    """The caller's remaining budget rides the request header; the worker's
    context gets a ``Deadline`` of the port's resilience module."""
    seen = []

    class Probe(PORT.engine.AsyncEngine):
        async def generate(self, request):
            seen.append(request.ctx.deadline)

            async def gen():
                yield {"ok": True}

            return PORT.engine.ResponseStream(gen(), request.ctx)

    server = await PORT.service.ServiceServer().start()
    server.register("p", Probe())
    try:
        req = PORT.engine.Context({})
        req.ctx.deadline = PORT.resilience.Deadline.after(5.0)
        await PORT.engine.collect(await PORT.service.RemoteEngine(server.address, "p").generate(req))
        assert isinstance(seen[0], PORT.resilience.Deadline)
        assert 4.0 < seen[0].remaining() <= 5.0
    finally:
        await server.close()


async def _token_worker(p, runtime, n, die_after=None):
    """A token-shaped worker: continues ``token_ids`` by +1; a worker with
    ``die_after`` hard-aborts its connection after that many items (a
    SIGKILL as the client sees it)."""
    server = await runtime.service_server()

    async def gen(request):
        ids = list(request.data["token_ids"])
        orig = (request.data.get("annotations") or {}).get("resume", {}).get(
            "orig_prompt_len", len(ids))
        for k in range(n - (len(ids) - orig)):
            if die_after is not None and k == die_after:
                server.crash()
                await asyncio.sleep(3600)
            yield {"token_ids": [ids[-1] + 1 + k]}

    ep = runtime.namespace("t").component("w").endpoint("generate")
    await ep.serve_endpoint(gen)


@pytest.mark.asyncio
async def test_greedy_stream_resumes_on_another_worker_after_a_crash():
    """The routed client's mid-stream resume: a greedy stream whose worker
    dies after 3 tokens continues on the survivor from prompt + delivered
    tokens, with ``orig_prompt_len`` kept; the caller sees one stream and
    ``stream_resumes_total`` rises by one — on both packages' clients."""
    for p in (PORT, JAX):
        hub = await p.hub.HubServer(host="127.0.0.1").start()
        dying = await p.component.DistributedRuntime.connect(hub.address)
        survivor = await p.component.DistributedRuntime.connect(hub.address)
        front = await p.component.DistributedRuntime.connect(hub.address)
        try:
            await _token_worker(p, dying, 8, die_after=3)
            await _token_worker(p, survivor, 8)
            client = await front.namespace("t").component("w").endpoint("generate").client()
            while len(client.instance_ids) < 2:
                await asyncio.sleep(0.02)
            before = p.resilience.metrics.stream_resumes_total
            req = {"token_ids": [10, 11], "sampling_options": {"temperature": 0.0}}
            stream = await client.direct(p.engine.Context(req), dying.worker_id)
            items = await p.engine.collect(stream)
            assert [t for it in items for t in it["token_ids"]] == list(range(12, 20)), p.name
            assert p.resilience.metrics.stream_resumes_total == before + 1
            await client.close()
        finally:
            for rt in (survivor, front):
                await rt.close()
            try:
                await dying.close()
            except Exception:  # noqa: BLE001 — crashed worker
                pass
            await hub.close()


@pytest.mark.asyncio
@pytest.mark.parametrize("P", [PORT, JAX], ids=["port", "jax"])
async def test_migration_cutover_marker_ends_the_stream_with_an_error(P):
    """A ``migrated`` item is never dropped silently: the client splices
    the stream to the target the marker names (one splice counted), and
    when that target answers with an application error (not retryable),
    the stream ends with that error — in both packages alike."""
    runtime = await P.component.DistributedRuntime.detached()
    try:
        async def refusing(request):
            raise ValueError("target refuses the resume request")
            yield  # pragma: no cover

        comp = runtime.namespace("t").component("w")
        target_ep = comp.endpoint("refuse")
        await target_ep.serve_endpoint(refusing)
        server = await runtime.service_server()

        async def migrating(request):
            yield {"token_ids": [1]}
            yield {"migrated": {"worker_id": None, "address": server.address,
                                "path": target_ep.path, "request": {"token_ids": [1]}}}

        ep = comp.endpoint("m")
        await ep.serve_endpoint(migrating)
        client = await ep.client()
        await client.wait_for_instances(1)
        splices0 = P.resilience.metrics.migration_splices_total
        stream = await client.generate(P.engine.Context({"token_ids": [0]}))
        with pytest.raises(P.service.RemoteEngineError, match="refuses the resume"):
            await P.engine.collect(stream)
        assert P.resilience.metrics.migration_splices_total == splices0 + 1
        await client.close()
    finally:
        await runtime.close()


@pytest.mark.asyncio
@pytest.mark.parametrize("S,C", PAIRS, ids=PAIR_IDS)
async def test_migration_cutover_marker_splices_the_target_stream(S, C):
    """The live-migration splice: the source's ``migrated`` marker carries
    a resume request and the target's address; the client re-dispatches
    it there and the caller sees one stream (the marker never surfaces),
    counted in ``migration_splices_total`` — the port's client on either
    package's servers, and the JAX client on the port's."""
    hub = await S.hub.HubServer().start()
    server_rt = await S.component.DistributedRuntime.connect(hub.address)
    client_rt = await C.component.DistributedRuntime.connect(hub.address)
    try:
        comp = server_rt.namespace("t").component("w")
        target_ep = comp.endpoint("target")

        async def target(request):
            # The resume request folds the emitted token into the prompt.
            assert request.data["token_ids"] == [0, 1]
            yield {"token_ids": [2]}
            yield {"token_ids": [3], "finish_reason": "length"}

        await target_ep.serve_endpoint(target)
        server = await server_rt.service_server()

        async def source(request):
            yield {"token_ids": [1]}
            yield {"token_ids": [], "migrated": {
                "worker_id": None, "address": server.address, "path": target_ep.path,
                "request": {"token_ids": [0, 1]}}}

        await comp.endpoint("src").serve_endpoint(source)
        client = await client_rt.namespace("t").component("w").endpoint("src").client()
        await client.wait_for_instances(1)
        splices0 = C.resilience.metrics.migration_splices_total
        items = await C.engine.collect(await client.generate(C.engine.Context({"token_ids": [0]})))
        assert [t for it in items for t in it.get("token_ids", [])] == [1, 2, 3]
        assert not any("migrated" in it for it in items)
        assert items[-1]["finish_reason"] == "length"
        assert C.resilience.metrics.migration_splices_total == splices0 + 1
        await client.close()
    finally:
        await client_rt.close()
        await server_rt.close()
        await hub.close()


# ------------------------------------------- resilience, config and health


def test_retry_policy_and_breaker_alike():
    """The copied ``RetryPolicy`` and ``CircuitBreaker`` replay the JAX
    ones under one seeded RNG and one injected clock."""
    for cfg in ({}, {"retry_max_attempts": 5, "retry_base_delay_s": 0.2, "retry_max_delay_s": 1}):
        a = PORT.resilience.RetryPolicy.from_config(cfg)
        b = JAX.resilience.RetryPolicy.from_config(cfg)
        assert (a.max_attempts, a.base_delay_s, a.max_delay_s) == (
            b.max_attempts, b.base_delay_s, b.max_delay_s)
        ra, rb = random.Random(3), random.Random(3)
        a = PORT.resilience.RetryPolicy(a.max_attempts, a.base_delay_s, a.max_delay_s, rng=ra)
        b = JAX.resilience.RetryPolicy(b.max_attempts, b.base_delay_s, b.max_delay_s, rng=rb)
        assert [a.backoff(i) for i in range(1, 8)] == [b.backoff(i) for i in range(1, 8)]
    now = [0.0]
    trace = {}
    for p in (PORT, JAX):
        now[0] = 0.0
        br = p.resilience.CircuitBreaker("w", failure_threshold=2, reset_timeout_s=1.0,
                                         clock=lambda: now[0])
        seq = []
        for step in ("fail", "fail", "probe", "t+1.5", "probe", "fail", "t+1.5", "probe", "ok",
                     "probe", "release"):
            if step == "fail":
                br.record_failure()
            elif step == "ok":
                br.record_success()
            elif step == "release":
                br.release_probe()
            elif step.startswith("t+"):
                now[0] += float(step[2:])
            else:
                seq.append(br.can_attempt())
                br.on_attempt()
            seq.append(br.state.value)
        trace[p.name] = seq
    assert trace["dynamo_tpu_torch"] == trace["dynamo_tpu"]


def test_breaker_gauges_render_alike():
    for p in (PORT, JAX):
        p.resilience.metrics.reset()
        br = p.resilience.metrics.register_breaker(
            p.resilience.CircuitBreaker("127.0.0.1:1", failure_threshold=1))
        br.record_failure()
    try:
        assert PORT.resilience.metrics.render() == JAX.resilience.metrics.render()
        assert 'dynamo_tpu_resilience_breaker_state{worker="127.0.0.1:1"} 2' in (
            PORT.resilience.metrics.render())
    finally:
        for p in (PORT, JAX):
            p.resilience.metrics.unregister_breaker("127.0.0.1:1")
            p.resilience.metrics.reset()


def test_resilience_config_section_from_env():
    from dynamo_tpu.runtime.config import RuntimeConfig as JaxConfig
    from dynamo_tpu_torch.runtime.config import RuntimeConfig

    env = {"DYN_RESILIENCE__RETRY_MAX_ATTEMPTS": "5", "DYN_RESILIENCE__BREAKER_RESET_S": "0.5",
           "DYN_NAMESPACE": "prod"}
    ours, theirs = RuntimeConfig.from_layers(environ=env), JaxConfig.from_layers(environ=env)
    assert ours.resilience == theirs.resilience == {"retry_max_attempts": 5, "breaker_reset_s": 0.5}
    assert ours.namespace == theirs.namespace == "prod"
    assert RuntimeConfig.from_layers(environ={}).namespace == JaxConfig().namespace


def test_health_trackers_alike():
    """``WorkerLatencyTracker`` and ``KvCorruptionLedger`` replay the JAX
    ones under one injected clock."""
    from dynamo_tpu.runtime import health as jh
    from dynamo_tpu_torch.runtime import health as ph

    now = [0.0]
    out = []
    for h in (ph, jh):
        now[0] = 0.0
        tr = h.WorkerLatencyTracker(window=4, stale_after_s=10.0, clock=lambda: now[0])
        led = h.KvCorruptionLedger(window_s=5.0, clock=lambda: now[0])
        rng = random.Random(1)
        snaps = []
        for i in range(40):
            now[0] += rng.random()
            w = rng.choice([1, 2, 3])
            (tr.record_ttft if i % 3 else tr.record_itl)(w, f"a{w}", rng.random() * 100)
            if i % 7 == 0:
                led.record(w, n=rng.choice([1, 2]))
            if i % 10 == 9:
                snaps.append((tr.snapshot(), led.counts()))
        out.append(snaps)
    assert out[0] == out[1]


@pytest.mark.asyncio
async def test_direct_routing_to_a_dead_leased_worker_fails_alike():
    """A worker whose process died keeps its instance until its lease
    expires; direct routing (what the KV router does) to it fails before
    the first token with no failover, in both packages (ROADMAP queue 3:
    a fault of the reference the port keeps for parity)."""
    for p in (PORT, JAX):
        hub = await p.hub.HubServer(host="127.0.0.1").start()
        a = await p.component.DistributedRuntime.connect(hub.address)
        b = await p.component.DistributedRuntime.connect(hub.address)
        front = await p.component.DistributedRuntime.connect(hub.address)
        try:
            async def gen(request):
                yield {"ok": 1}

            for rt in (a, b):
                await rt.namespace("t").component("w").endpoint("g").serve_endpoint(gen)
            client = await front.namespace("t").component("w").endpoint("g").client()
            while len(client.instance_ids) < 2:
                await asyncio.sleep(0.02)
            (await b.service_server()).crash()  # the process dies, the lease lives on
            with pytest.raises(ConnectionError):
                await p.engine.collect(await client.direct(p.engine.Context({}), b.worker_id))
            assert b.worker_id in client.instance_ids
            # Routed without a worker id, the same request fails over to A.
            items = await p.engine.collect(await client.generate(p.engine.Context({})))
            assert items == [{"ok": 1}]
            await client.close()
        finally:
            for rt in (a, front):
                await rt.close()
            try:
                await b.close()
            except Exception:  # noqa: BLE001 — crashed worker
                pass
            await hub.close()
