"""The bulk data plane on the port against the JAX package.

Every case of ``tests/test_bulk.py`` runs on both packages, each over its
own loopback ``BulkServer``, and the two outcomes (bytes, error kinds,
``retryable`` flags, the resume watermarks each server admitted, the
metrics) must be identical, and right:

- fetch and push round trips at chunk boundaries;
- resume from chunk k after ``bulk_conn_drop``, for fetch and for push;
- a ``bulk_slow_peer`` straggler's retryable timeout;
- ticket expiry, reuse, salt scope, wrong peer and byte budget;
- the hub as the fleet-wide one-shot arbiter (in-process, remote and
  sharded hubs);
- rendezvous ``None`` for an unregistered peer;
- the metrics series and the hub's publish bytes.

Then across packages and through the three consumers:

- a port ``bulk_fetch`` / ``bulk_push`` against a JAX ``BulkServer`` and
  the reverse: the same blobs, replies and watermarks;
- the prefix pull's bulk exporter on debug-tiny in f32: the payload equals
  the ``kv_export`` handler's, a miss falls back to it, and a pulled
  prefix streams like a recomputed one with the donor's pages, also from
  a donor of the other package;
- migration over the bulk plane: streams equal to migration over the
  service plane, to the never-migrated stream and to the JAX package's
  migration over the bulk plane, with the copy stream's bytes on
  ``dynamo_tpu_bulk_bytes_total``;
- the span sink: the aggregator assembles the same trace from a bulk push
  as from the hub path, and a miss falls back to the hub path, also into
  an ingest of the other package.
"""

import asyncio
import importlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.integrity import raw_bytes
from dynamo_tpu_torch.models.llama import params_from_jax

pytestmark = [pytest.mark.torch_port, pytest.mark.bulk]

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)
CHUNK = 16
SIZES = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK, 3 * CHUNK + 7]


def _pkg(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, bulk=m("runtime.transports.bulk"), codec=m("runtime.transports.codec"),
        hub=m("runtime.transports.hub"), shard=m("runtime.transports.shard"),
        faults=m("runtime.faultinject").faults, metrics=m("llm.metrics"),
        pull=m("llm.kv_router.pull"), trace=m("llm.trace_service"),
        migration=m("llm.migration"), mworker=m("llm.migration.worker"),
        config=m("engine.config"), engine_mod=m("engine.engine"), protocols=m("llm.protocols"),
        component=m("runtime.component"), engine=m("runtime.engine"),
        resilience=m("runtime.resilience"), tokens=m("tokens"),
    )


P = {JAX: _pkg(JAX), PORT: _pkg(PORT)}


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def blob_of(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def _clean_faults_and_metrics():
    for M in P.values():
        M.faults.reset()
        M.metrics.bulk_metrics.reset()
    yield
    for M in P.values():
        M.faults.reset()
        M.metrics.bulk_metrics.reset()


def _watermarks(srv):
    """Record, per admitted connection, (op, the client's resume_from, the
    chunks the server held for the transfer): the fetch and push resume
    watermarks."""
    seen = []
    real = srv._admit

    async def admit(hdr):
        live = await real(hdr)
        seen.append((hdr.get("op"), int(hdr.get("resume_from") or 0), len(live["chunks"])))
        return live

    srv._admit = admit
    return seen


async def _source_server(M, payloads, **kw):
    """``M``'s BulkServer with a tiny chunk size and a ``kv_export`` source
    serving ``payloads[meta['key']]``."""
    srv = M.bulk.BulkServer(chunk_bytes=kw.pop("chunk_bytes", CHUNK), **kw)

    async def source(meta):
        return payloads[meta["key"]]

    srv.register_source("kv_export", source)
    await srv.start()
    return srv


async def _sink_server(M, landed, **kw):
    srv = M.bulk.BulkServer(chunk_bytes=kw.pop("chunk_bytes", CHUNK), **kw)

    async def sink(data, meta):
        landed.append(data)
        return {"n": len(data)}

    srv.register_sink("migrate_in", sink)
    await srv.start()
    return srv


async def _outcome(M, coro):
    """("ok", value) or ("error", kind, retryable) for ``M``'s errors."""
    try:
        return ("ok", await coro)
    except M.bulk.BulkTransferError as e:
        return ("error", e.kind, e.retryable)


async def _both(case):
    """``case(M)`` on each package; the outcomes, keyed by package."""
    return {pkg: await case(P[pkg]) for pkg in PKGS}


def _snap(M):
    return M.metrics.bulk_metrics.snapshot()


# ---------------------------------------------------------------- framing


@pytest.mark.parametrize("size", SIZES)
async def test_fetch_roundtrip_chunk_boundaries(size):
    blob = blob_of(size, size)

    async def case(M):
        srv = await _source_server(M, {"b": blob})
        seen = _watermarks(srv)
        try:
            got = await M.bulk.bulk_fetch(srv.address, "kv_export", M.bulk.mint_ticket("p"),
                                          meta={"key": "b"})
            return got, srv._live, seen, _snap(M)
        finally:
            await srv.close()

    out = await _both(case)
    assert out[PORT] == out[JAX]
    got, live, seen, snap = out[PORT]
    assert got == blob and live == {} and seen == [("fetch", 0, 0)]
    assert snap["bytes_total"] == size and snap["transfers_total"] == 1


@pytest.mark.parametrize("size", SIZES)
async def test_push_roundtrip_chunk_boundaries(size):
    blob = blob_of(size, size + 100)

    async def case(M):
        landed = []
        srv = await _sink_server(M, landed)
        seen = _watermarks(srv)
        try:
            reply = await M.bulk.bulk_push(srv.address, "migrate_in", M.bulk.mint_ticket("p"),
                                           blob, chunk_bytes=CHUNK)
            return reply, landed, srv._live, seen, _snap(M)
        finally:
            await srv.close()

    out = await _both(case)
    assert out[PORT] == out[JAX]
    reply, landed, live, seen, snap = out[PORT]
    assert reply == {"n": size} and landed == [blob] and live == {}
    assert seen == [("push", 0, 0)] and snap["transfers_total"] == 1


@pytest.mark.parametrize("op,drops", [("fetch", 2), ("push", 1), ("push", 3)])
async def test_resume_from_chunk_k(op, drops):
    """A connection drop after chunk k resumes from k: a fetch keeps its
    verified prefix and the server replays only the cached tail; a push
    reads the server's ``have`` watermark.  The assembled stream is
    byte-identical, and the watermarks are the same in both packages."""
    blob = blob_of(5 * CHUNK, 7)

    async def case(M):
        landed = []
        srv = (await _source_server(M, {"b": blob}) if op == "fetch"
               else await _sink_server(M, landed))
        seen = _watermarks(srv)
        try:
            M.faults.arm("bulk_conn_drop", count=drops)
            if op == "fetch":
                got = await M.bulk.bulk_fetch(srv.address, "kv_export", M.bulk.mint_ticket("p"),
                                              meta={"key": "b"})
            else:
                got = await M.bulk.bulk_push(srv.address, "migrate_in", M.bulk.mint_ticket("p"),
                                             blob, chunk_bytes=CHUNK)
            return got, landed, seen, _snap(M)
        finally:
            await srv.close()

    out = await _both(case)
    assert out[PORT] == out[JAX]
    got, landed, seen, snap = out[PORT]
    if op == "fetch":
        assert got == blob
        # Each drop lands after one more verified chunk: resume from 1, 2.
        assert [s[1] for s in seen] == [0, 1, 2]
        assert snap["resumes_total"] == drops
    else:
        assert got == {"n": len(blob)} and landed == [blob]
        assert [s[2] for s in seen] == list(range(drops + 1))  # the server's `have`
        assert snap["resumes_total"] == drops
    assert snap["transfers_total"] == 1 and snap["bytes_total"] == len(blob)


async def test_slow_peer_timeout_is_retryable():
    """``bulk_slow_peer`` stalls every chunk; the per-attempt timeout turns
    the straggler into a retryable error — the producers' cue to fall back
    to the service plane instead of hanging the pull."""
    blob = blob_of(6 * CHUNK, 3)

    async def case(M):
        srv = await _source_server(M, {"b": blob})
        try:
            M.faults.arm("bulk_slow_peer", delay_s=0.2)
            return await _outcome(M, M.bulk.bulk_fetch(
                srv.address, "kv_export", M.bulk.mint_ticket("p"), meta={"key": "b"},
                timeout_s=0.25, max_resumes=1))
        finally:
            await srv.close()

    out = await _both(case)
    assert out[PORT] == out[JAX] == ("error", "", True)


# ----------------------------------------------------------------- tickets


async def _refusal(M, kind):
    clock = FakeClock()
    blob = blob_of(4 * CHUNK, 11)
    srv = await _source_server(M, {"b": blob}, clock=clock,
                               worker_id=42 if kind == "wrong_peer" else None)
    fetch = M.bulk.bulk_fetch
    try:
        if kind == "expiry":
            ticket = M.bulk.mint_ticket("p", ttl_s=5.0, clock=clock)
            clock.advance(6.0)
            return [await _outcome(M, fetch(srv.address, "kv_export", ticket, meta={"key": "b"}))]
        if kind == "reuse":
            ticket = M.bulk.mint_ticket("p", clock=clock)
            return [await _outcome(M, fetch(srv.address, "kv_export", ticket, meta={"key": "b"}))
                    for _ in range(2)]
        if kind == "salt":
            return [
                await _outcome(M, fetch(srv.address, "kv_export",
                                        M.bulk.mint_ticket("p", salt="tenant-a", clock=clock),
                                        meta={"key": "b"}, salt="tenant-b")),
                await _outcome(M, fetch(srv.address, "kv_export",
                                        M.bulk.mint_ticket("p", salt="tenant-a", clock=clock),
                                        meta={"key": "b"}, salt="tenant-a")),
            ]
        if kind == "wrong_peer":
            return [await _outcome(M, fetch(srv.address, "kv_export",
                                            M.bulk.mint_ticket(41, clock=clock), meta={"key": "b"})),
                    await _outcome(M, fetch(srv.address, "kv_export",
                                            M.bulk.mint_ticket(42, clock=clock), meta={"key": "b"}))]
        assert kind == "budget"
        return [await _outcome(M, fetch(srv.address, "kv_export",
                                        M.bulk.mint_ticket("p", budget=CHUNK, clock=clock),
                                        meta={"key": "b"})),
                await _outcome(M, fetch(srv.address, "kv_export",
                                        M.bulk.mint_ticket("p", budget=4 * CHUNK, clock=clock),
                                        meta={"key": "b"}))]
    finally:
        await srv.close()


@pytest.mark.parametrize("kind,want", [
    ("expiry", [("error", "ticket", False)]),
    ("reuse", ["ok", ("error", "ticket", False)]),
    ("salt", [("error", "ticket", False), "ok"]),
    ("wrong_peer", [("error", "ticket", False), "ok"]),
    ("budget", [("error", "budget", False), "ok"]),
])
async def test_ticket_refusals(kind, want):
    out = await _both(lambda M: _refusal(M, kind))
    assert out[PORT] == out[JAX]
    blob = blob_of(4 * CHUNK, 11)
    assert [o if o[0] == "error" else ("ok" if o[1] == blob else o) for o in out[PORT]] == want


async def _hub_of(M, kind, closers):
    if kind == "inproc":
        return await M.hub.InprocHub().start()
    if kind == "remote":
        srv = await M.hub.HubServer().start()
        closers.append(srv.close)
        client = await M.hub.HubClient(srv.address).connect()
        closers.append(client.close)
        return client
    srvs = [await M.hub.HubServer().start() for _ in range(2)]
    closers.extend(s.close for s in srvs)
    client = await M.shard.ShardedHubClient(",".join(s.address for s in srvs)).connect()
    closers.append(client.close)
    return client


@pytest.mark.parametrize("hub_kind", ["inproc", "remote", "sharded"])
async def test_hub_is_fleet_wide_oneshot_arbiter(hub_kind):
    """Ticket spend is arbitrated by the hub record (first delete wins): a
    replayed ticket is refused even by a server that never saw it spent —
    through the in-process hub, a remote hub client and the sharded
    client alike (each ``kv_delete`` answers False for a key already
    gone)."""
    blob = blob_of(2 * CHUNK, 5)

    async def case(M):
        closers = []
        hub = await _hub_of(M, hub_kind, closers)
        srv1 = await _source_server(M, {"b": blob}, worker_id=7, hub=hub)
        srv2 = await _source_server(M, {"b": blob}, worker_id=7, hub=hub)
        try:
            await hub.kv_put(M.bulk.bulk_addr_key(7), {"address": srv1.address})
            address, ticket = await M.bulk.BulkRendezvous(hub).prepare(7)
            assert address == srv1.address
            parked = await hub.kv_get(M.bulk.bulk_ticket_key(ticket["id"]))
            first = await _outcome(M, M.bulk.bulk_fetch(address, "kv_export", ticket,
                                                        meta={"key": "b"}))
            gone = await hub.kv_get(M.bulk.bulk_ticket_key(ticket["id"]))
            second = await _outcome(M, M.bulk.bulk_fetch(srv2.address, "kv_export", ticket,
                                                         meta={"key": "b"}))
            return parked == ticket, first, gone, second, await hub.kv_delete("bulk/ticket/x")
        finally:
            await srv1.close()
            await srv2.close()
            for close in reversed(closers):
                await close()
            if hub_kind == "inproc":
                await hub.close()

    out = await _both(case)
    assert out[PORT] == out[JAX] == (True, ("ok", blob), None, ("error", "ticket", False),
                                     False)


# -------------------------------------------------------------- rendezvous


async def test_rendezvous_none_for_unregistered_peer():
    async def case(M):
        hub = await M.hub.InprocHub().start()
        try:
            rdv = M.bulk.BulkRendezvous(hub)
            return await rdv.prepare(999), await rdv.prepare_sink("traces"), await rdv.lookup(9)
        finally:
            await hub.close()

    out = await _both(case)
    assert out[PORT] == out[JAX] == (None, None, None)


async def test_metrics_series_and_hub_publish_bytes():
    """``/metrics`` carries the four bulk counters under the JAX names,
    help strings and order, and the hub shard publish byte counter (the
    bulk plane's proof metric) counts the same control-plane volume."""

    async def case(M):
        rendered = M.metrics.bulk_metrics.render()
        hub = await M.hub.InprocHub().start()
        try:
            pm = M.shard.shard_metrics.publish_bytes
            before = pm.get("inproc", 0)
            await hub.publish("spans.w1", {"spans": ["x" * 256]})
            return rendered, pm.get("inproc", 0) - before, \
                "hub_shard_publish_bytes_total" in M.shard.shard_metrics.render()
        finally:
            await hub.close()

    out = await _both(case)
    assert out[PORT] == out[JAX]
    rendered, delta, listed = out[PORT]
    for series in ("bulk_bytes_total", "bulk_transfers_total",
                   "bulk_fallbacks_total", "bulk_resumes_total"):
        assert f"dynamo_tpu_{series}" in rendered
    assert delta > 256 and listed


# --------------------------------------------------------- across packages


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, JAX), (JAX, PORT)],
                         ids=["port-client-jax-server", "jax-client-port-server"])
@pytest.mark.parametrize("op", ["fetch", "push"])
async def test_bulk_interop_across_packages(client_pkg, server_pkg, op):
    """A client of one package against a ``BulkServer`` of the other: at
    every chunk boundary and through a resume (the fault armed on the
    server's package) the blobs, replies and watermarks are those of the
    same-package transfer."""
    C, S = P[client_pkg], P[server_pkg]

    async def run(cm, sm):
        results = []
        for size in SIZES + [5 * CHUNK]:
            blob = blob_of(size, 50 + size)
            landed = []
            srv = (await _source_server(sm, {"b": blob}) if op == "fetch"
                   else await _sink_server(sm, landed))
            seen = _watermarks(srv)
            try:
                if size == 5 * CHUNK:
                    sm.faults.arm("bulk_conn_drop", count=2)
                if op == "fetch":
                    got = await cm.bulk.bulk_fetch(srv.address, "kv_export",
                                                   cm.bulk.mint_ticket("p"), meta={"key": "b"})
                else:
                    got = await cm.bulk.bulk_push(srv.address, "migrate_in",
                                                  cm.bulk.mint_ticket("p"), blob,
                                                  chunk_bytes=CHUNK)
                results.append((got, landed, seen))
                assert (got == blob) if op == "fetch" else (landed == [blob])
            finally:
                sm.faults.reset()
                await srv.close()
        return results

    cross = await run(C, S)
    same = await run(S, S)
    assert cross == same


# --------------------------------------------------------------- consumers

BS = 4
PROMPT = list(range(1, 17))  # 4 full blocks
CFG = dict(model="debug-tiny", block_size=BS, num_blocks=64, max_batch=4, max_model_len=256,
           prefill_chunk=64, dtype="float32", decode_steps=2, pipeline_depth=2,
           host_cache_bytes=0)
_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS["jax"] = jax_init_params(
            jax_get_config("debug-tiny").with_overrides(dtype="float32"), jax.random.PRNGKey(0))
        _PARAMS["np"] = jax.tree_util.tree_map(np.asarray, _PARAMS["jax"])
    return _PARAMS


def _engine(pkg, **over):
    cfg = P[pkg].config.EngineConfig(**dict(CFG, **over))
    if pkg == JAX:
        return P[JAX].engine_mod.TpuEngine(cfg, params=_params()["jax"])
    return P[PORT].engine_mod.TorchEngine(
        cfg, params=params_from_jax(_params()["np"], device="cpu"), device="cpu")


def _req(pkg, tokens, max_tokens=8, seed=None, temperature=0.0, annotations=None):
    pr = P[pkg].protocols
    return pr.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=pr.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=pr.SamplingOptions(temperature=temperature, seed=seed),
        annotations=dict(annotations or {}),
    ).to_dict()


def _tokens(items):
    return [t for i in items for t in i.get("token_ids", [])]


async def _generate(pkg, engine, req):
    E = P[pkg].engine
    return _tokens(await E.collect(await engine.generate(E.Context(dict(req)))))


def _pages_of(engine, tokens):
    """The raw bytes of the pages holding ``tokens``' sealed blocks."""
    blocks = P[PORT].tokens.hash_token_blocks(tokens, BS)
    ids = [engine.kv._by_hash[tb.sequence_hash] for tb in blocks]
    if isinstance(engine.cache.pages, torch.Tensor):
        return raw_bytes(engine.cache.pages[:, ids]).tobytes()
    return np.ascontiguousarray(np.asarray(engine.cache.pages)[:, ids]).tobytes()


async def _handler_payload(pkg, engine, data):
    """The service plane's answer: the ``kv_export`` handler's one item."""
    E = P[pkg].engine
    items = await E.collect(await P[pkg].engine.engine_from_generator(
        P[pkg].pull.make_kv_export_handler(engine)).generate(E.Context(dict(data))))
    return items[0]["payload"]


@pytest.mark.parametrize("donor_pkg,puller_pkg", [(PORT, PORT), (JAX, JAX), (JAX, PORT),
                                                  (PORT, JAX)],
                         ids=["port", "jax", "jax-donor-port-puller", "port-donor-jax-puller"])
async def test_bulk_exporter_ab_identity_and_fallback(donor_pkg, puller_pkg):
    """The pull's exporter over the bulk plane returns exactly what the
    service plane's ``kv_export`` handler returns; a peer without a bulk
    server falls back to it (one fallback tick); and a puller whose
    exporter is the bulk plane serves a stream equal to its recompute,
    with pages bitwise the donor's — also across packages."""
    D, U = P[donor_pkg], P[puller_pkg]
    donor, target, control = _engine(donor_pkg), _engine(puller_pkg), _engine(puller_pkg)
    hub = await U.hub.InprocHub().start()
    srv = D.bulk.BulkServer(chunk_bytes=1 << 12, worker_id=7, hub=hub)
    srv.register_source("kv_export", D.pull.make_bulk_export_source(donor))
    await srv.start()
    fallback_calls = []

    async def service_path(worker_id, data):
        fallback_calls.append(worker_id)
        return await _handler_payload(donor_pkg, donor, data)

    try:
        await _generate(donor_pkg, donor, _req(donor_pkg, PROMPT, 2))
        await hub.kv_put(U.bulk.bulk_addr_key(7), {"address": srv.address})
        exporter = U.pull.make_bulk_exporter(U.bulk.BulkRendezvous(hub), service_path,
                                             max_bytes=1 << 20)
        data = {"token_ids": PROMPT, "start_block": 0, "max_blocks": 4}
        got = await exporter(7, data)
        want = await _handler_payload(donor_pkg, donor, data)
        assert got == want and got["n_blocks"] == 4  # byte-identical to the A/B oracle
        assert fallback_calls == [] and _snap(U)["fallbacks_total"] == 0
        assert _snap(U)["bytes_total"] == len(D.codec.encode(want))
        # Peer 8 runs no bulk server: the exporter falls back and counts it.
        assert await exporter(8, data) == want
        assert fallback_calls == [8] and _snap(U)["fallbacks_total"] == 1
        # A prefix pulled over the bulk plane streams like a recompute.
        puller = U.pull.PrefixPuller(target, exporter, max_bytes=1 << 20)
        covered = await puller.pull(PROMPT + [90, 91], None, {"worker_id": 7, "blocks": 4})
        assert covered == len(PROMPT)
        assert _pages_of(target, PROMPT) == _pages_of(donor, PROMPT)
        req = _req(puller_pkg, PROMPT + [90, 91], 8)
        assert await _generate(puller_pkg, target, req) == await _generate(puller_pkg, control, req)
        assert fallback_calls == [8]
    finally:
        await srv.close()
        await hub.close()
        for e in (donor, target, control):
            await e.close()


# ---- migration over the bulk plane


async def _spawn_worker(pkg, hub_address, ns, comp, bulk):
    """A migration-capable worker of ``pkg``, wired as the CLI's decode
    role wires it; with ``bulk``, a ``BulkServer`` serving the
    ``migrate_in`` sink and the worker's copy stream on a rendezvous."""
    M = P[pkg]
    rt = await M.component.DistributedRuntime.connect(hub_address)
    engine = _engine(pkg, num_blocks=128, max_model_len=512)
    toks = list(range(200, 216))
    await _generate(pkg, engine, _req(pkg, toks, 4, seed=1, temperature=0.9))
    await engine.inject_blocks(toks, await engine.export_prompt_blocks(toks))
    mig = M.migration.MigratableWorker(engine, chunk_blocks=4)
    component = rt.namespace(ns).component(comp)
    gen_ep, in_ep, out_ep = (component.endpoint(n) for n in ("gen", "migrate_in", "migrate_out"))
    server = await rt.service_server()
    await in_ep.serve_endpoint(mig.migrate_in_handler)
    await out_ep.serve_endpoint(mig.migrate_out_handler)
    metadata = {"migrate": {"import_path": in_ep.path, "out_path": out_ep.path,
                            "generate_path": gen_ep.path}}
    await gen_ep.serve_endpoint(mig, metadata=metadata)
    bulk_srv = None
    if bulk:
        bulk_srv = M.bulk.BulkServer(worker_id=rt.worker_id, hub=rt.hub)
        bulk_srv.register_sink(M.migration.MIGRATE_IN_ENDPOINT,
                               M.mworker.make_migrate_in_sink(mig))
        await bulk_srv.start()
        await rt.register_key(M.bulk.bulk_addr_key(rt.worker_id),
                              {"address": bulk_srv.address, "worker_id": str(rt.worker_id)})
        mig.bulk = M.bulk.BulkRendezvous(rt.hub, lease=rt.primary_lease)
    return SimpleNamespace(
        pkg=pkg, rt=rt, engine=engine, mig=mig, bulk_srv=bulk_srv,
        target={"worker_id": rt.worker_id, "address": server.address,
                "import_path": in_ep.path, "generate_path": gen_ep.path},
    )


async def _close_worker(w):
    if w.bulk_srv is not None:
        await w.bulk_srv.close()
    await w.engine.close()
    await w.rt.close()


async def _wait_for(cond, timeout=60.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, "condition timeout"
        await asyncio.sleep(0.005)


class _CopyGate:
    """The JAX migration test's count-bounded decode-vs-copy interlock:
    decode spends one budget unit per paced device op and parks when it is
    dry; each shipped copy round refills ``steps_per_round``; at ``final``
    (just before the freeze) the gate stops parking."""

    def __init__(self, worker, steps_per_round=2):
        self._worker, self._engine = worker, worker.engine
        self._per_round = self._budget = steps_per_round
        self._refill = asyncio.Event()
        self._final = self._released = False
        worker.engine.pace_hook = self._pace
        worker.copy_round_hook = self._round

    async def _pace(self):
        if self._released or self._final:
            return
        while self._budget <= 0 and not self._final and not self._released:
            self._refill.clear()
            await self._refill.wait()
        self._budget -= 1

    async def _round(self, cursor, final):
        if final:
            self._final = True
        else:
            self._budget += self._per_round
        self._refill.set()

    def release(self):
        self._released = True
        self._refill.set()
        self._engine.pace_hook = None
        self._worker.copy_round_hook = None


async def _migrated_streams(pkg, bulk):
    """Two streams (greedy, seeded at 0.7) migrated A → B mid-decode on
    workers of ``pkg``; per stream (the client's tokens, the never-migrated
    control), with the bulk metrics and the migration bytes."""
    M = P[pkg]
    hub = await M.hub.HubServer().start()
    a = await _spawn_worker(pkg, hub.address, "bk", "w", bulk)
    b = await _spawn_worker(pkg, hub.address, "bk", "w", bulk)
    client_rt = await M.component.DistributedRuntime.connect(hub.address)
    M.metrics.bulk_metrics.reset()
    M.metrics.migration_metrics.reset()
    streams = []
    try:
        client = await client_rt.namespace("bk").component("w").endpoint("gen").client()
        await client.wait_for_instances(5)
        for i, (seed, temp) in enumerate(((None, 0.0), (4242, 0.7))):
            req = _req(pkg, range(10 + i, 31 + i), 48, seed, temp)
            control = await _generate(pkg, a.engine, req)
            ctx = M.engine.Context(dict(req))
            items = []

            async def consume(stream):
                async for it in stream:
                    items.append(it)

            task = asyncio.ensure_future(consume(await client.generate(ctx, worker_id=a.rt.worker_id)))
            await _wait_for(lambda: len(_tokens(items)) >= 4)
            gate = _CopyGate(a.mig)
            assert await a.mig.migrate_out(ctx.id, b.target)
            gate.release()
            await task
            assert items[-1]["finish_reason"] == "length"
            streams.append((_tokens(items), control))
        await client.close()
        return streams, _snap(M), M.metrics.migration_metrics.bytes_total
    finally:
        await _close_worker(a)
        await _close_worker(b)
        await client_rt.close()
        await hub.close()


async def test_migration_over_bulk_plane():
    """Migration's copy stream over the bulk plane gives the streams of
    migration over the service plane and the never-migrated ones, on the
    port and on the JAX package alike; its copy-round bytes ride the bulk
    plane (each payload a codec blob a bit larger than its K/V) with no
    fallback, and none with the bulk plane off."""
    got = {}
    for pkg in PKGS:
        for bulk in (True, False):
            got[pkg, bulk] = await _migrated_streams(pkg, bulk)
    for pkg in PKGS:
        streams, snap, mig_bytes = got[pkg, True]
        assert all(s == c and len(s) == 48 for s, c in streams)
        assert snap["fallbacks_total"] == 0 and snap["transfers_total"] >= 2
        assert snap["bytes_total"] > mig_bytes > 0
        assert [s for s, _ in streams] == [s for s, _ in got[pkg, False][0]]
        assert got[pkg, False][1]["bytes_total"] == 0
    assert [s for s, _ in got[PORT, True][0]] == [s for s, _ in got[JAX, True][0]]


# ---- the span sink


def _span_batch(proc):
    base = dict(trace_id="t-bulk", component="edge", proc=proc)
    return {"proc": proc, "spans": [
        dict(base, span_id="s1", parent_id=None, name="edge.request", start_ms=1.0, dur_ms=9.0),
        dict(base, span_id="s2", parent_id="s1", name="engine.prefill", start_ms=2.0,
             dur_ms=3.0, component="engine"),
    ]}


@pytest.mark.parametrize("sink_pkg,ingest_pkg", [(PORT, PORT), (JAX, JAX), (PORT, JAX),
                                                 (JAX, PORT)],
                         ids=["port", "jax", "port-sink-jax-ingest", "jax-sink-port-ingest"])
async def test_bulk_span_sink_ab_identity_and_fallback(sink_pkg, ingest_pkg):
    """A worker's span batch pushed over the bulk plane into the edge's
    ingest assembles into the same trace as the hub path's, and with the
    ingest gone the batch falls back to the hub path (one fallback tick),
    never dropped."""
    S, I = P[sink_pkg], P[ingest_pkg]
    rt = await I.component.DistributedRuntime.detached()
    agg_bulk, agg_hub = I.trace.TraceAggregator(), I.trace.TraceAggregator()
    ingest = await I.trace.start_bulk_ingest(agg_bulk, rt)
    published = []

    async def hub_path(payload):
        published.append(payload)
        agg_hub.ingest(payload)

    batch = _span_batch("worker-1")
    try:
        key = I.bulk.bulk_sink_key(I.trace.BULK_TRACES_SINK, rt.worker_id)
        assert (await rt.hub.kv_get(key))["address"] == ingest.address
        sink = S.trace.make_bulk_span_sink(S.bulk.BulkRendezvous(rt.hub), hub_path)
        await sink(batch)
        assert published == [] and _snap(S)["fallbacks_total"] == 0
        assert _snap(S)["bytes_total"] == len(S.codec.encode(batch))
        await hub_path(batch)
        assert agg_bulk.get("t-bulk") == agg_hub.get("t-bulk") is not None
        # The ingest de-registered: the batch rides the hub path instead.
        await rt.hub.kv_delete(key)
        published.clear()
        await sink(batch)
        assert published == [batch] and _snap(S)["fallbacks_total"] == 1
    finally:
        await ingest.close()
        for agg in (agg_bulk, agg_hub):
            await agg.stop()
        await rt.close()
