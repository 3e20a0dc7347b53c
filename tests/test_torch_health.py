"""The health watchdog on the port against the JAX package.

The JAX package's watchdog tests (``tests/test_chaos.py``: probe failure →
quarantine → drain → eject → re-registration, straggler → quarantine →
recovery, ``probe_address`` over the service plane;
``tests/test_kv_integrity.py``: the corruption quarantine) run on both
packages with the same scripted prober, drainer and clock, and must give
identical state sequences, quarantine markers, drain calls, deletions and
``health_metrics`` renders.  ``probe_address`` is also held across
packages (a port probe against a JAX ``ServiceServer`` and the reverse).

End to end on the CPU: a ``HealthWatchdog`` with its default drainer over
three ``TorchEngine`` workers (debug-tiny, f32) quarantines the one whose
streams ``slow_stream`` makes a straggler, migrates its two live streams to
a peer, and both stay whole and equal to their never-migrated streams.
"""

import asyncio
import importlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.models.llama import params_from_jax

pytestmark = [pytest.mark.torch_port, pytest.mark.chaos]

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)


def _pkg(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, runtime=m("runtime"), health=m("runtime.health"),
        hub=m("runtime.transports.hub"), service=m("runtime.transports.service"),
        faults=m("runtime.faultinject").faults, metrics=m("llm.metrics"),
        migration=m("llm.migration"), config=m("engine.config"),
        engine_mod=m("engine.engine"), protocols=m("llm.protocols"),
        component=m("runtime.component"), engine=m("runtime.engine"),
        resilience=m("runtime.resilience"),
    )


P = {JAX: _pkg(JAX), PORT: _pkg(PORT)}


@pytest.fixture(autouse=True)
def _clean():
    for M in P.values():
        M.faults.reset()
        M.health.worker_latency.reset()
        M.health.health_metrics.reset()
    yield
    for M in P.values():
        M.faults.reset()
        M.health.worker_latency.reset()
        M.health.health_metrics.reset()


def _instance(ns, wid, address):
    return (
        f"instances/{ns}/c/gen/{wid}",
        {"address": address, "path": f"{ns}.c.gen", "worker_id": wid,
         "metadata": {"role": "decode"}},
    )


async def _observe(M, dog, hub, wids, ns):
    """One row of the state sequence: per worker its record, its
    quarantine marker and whether its registration is still in the hub."""
    row = {}
    for wid in wids:
        rec = dog.workers.get(wid)
        row[wid] = (
            None if rec is None else (rec.state, rec.fail_streak, rec.straggler_streak,
                                      rec.reason),
            await hub.kv_get(M.health.quarantine_key(wid)),
            await hub.kv_get(f"instances/{ns}/c/gen/{wid}") is not None,
        )
    return row


async def _both(scenario):
    out = {}
    for pkg in PKGS:
        M = P[pkg]
        M.health.health_metrics.reset()
        rows = await scenario(M)
        out[pkg] = (rows, M.health.health_metrics.render())
    return out


# ------------------------------------------------- the JAX watchdog tests


async def test_watchdog_probe_failure_quarantine_drain_eject():
    """Probe failures → quarantine (marker + drain) → eject after grace;
    the healthy peer is untouched; re-registration reinstates."""

    async def scenario(M):
        hub = await M.hub.InprocHub().start()
        clock = SimpleNamespace(t=100.0)
        drained, rows = [], []
        alive = {"dead:1": False}

        async def prober(address, timeout_s):
            return alive.get(address, True)

        async def drainer(info):
            drained.append(info["worker_id"])
            return 2

        for wid, addr in ((1, "dead:1"), (2, "ok:2")):
            key, info = _instance("h", wid, addr)
            await hub.kv_put(key, info)
        dog = M.health.HealthWatchdog(
            hub, "instances/h/", prober=prober, drainer=drainer, latency_source=lambda: {},
            config=M.health.HealthConfig(quarantine_after=2, eject_grace_s=5.0),
            clock=lambda: clock.t)
        try:
            for dt in (0.0, 0.0, 6.0, 0.0, 0.0):
                clock.t += dt
                await dog.tick()
                rows.append((await _observe(M, dog, hub, (1, 2), "h"), list(drained)))
            # The operator brings the worker back: re-registration resets.
            key, info = _instance("h", 1, "ok:1")
            await hub.kv_put(key, info)
            await dog.tick()
            rows.append((await _observe(M, dog, hub, (1, 2), "h"), list(drained)))
            return rows
        finally:
            await dog.stop()
            await hub.close()

    out = await _both(scenario)
    assert out[PORT] == out[JAX]
    rows, render = out[PORT]
    states = [r[0][1][0][0] for r in rows]
    assert states == ["healthy", "quarantined", "ejected", "ejected", "ejected", "healthy"]
    assert rows[1][0][1][1]["state"] == "quarantined" and rows[1][1] == [1]
    assert rows[2][0][1][1]["state"] == "ejected" and rows[2][0][1][2] is False
    assert rows[2][0][2][2] is True  # the healthy peer's registration stays
    assert rows[5][0][1][1] is None  # the marker cleared
    assert "dynamo_tpu_health_ejections_total 1" in render


async def test_watchdog_straggler_quarantine_and_recovery():
    """A sustained ITL outlier quarantines; clearing the outlier before the
    grace window reinstates instead of ejecting."""

    async def scenario(M):
        hub = await M.hub.InprocHub().start()
        lat = {
            1: {"address": "a:1", "itl_p50_ms": 900.0, "ttft_p50_ms": 50.0, "n": 10},
            2: {"address": "a:2", "itl_p50_ms": 20.0, "ttft_p50_ms": 45.0, "n": 10},
            3: {"address": "a:3", "itl_p50_ms": 22.0, "ttft_p50_ms": 48.0, "n": 10},
        }
        for wid in (1, 2, 3):
            key, info = _instance("s", wid, f"a:{wid}")
            await hub.kv_put(key, info)
        drained, rows = [], []

        async def prober(address, timeout_s):
            return True

        async def drainer(info):
            drained.append(info["worker_id"])
            return 0

        dog = M.health.HealthWatchdog(
            hub, "instances/s/", prober=prober, drainer=drainer, latency_source=lambda: lat,
            config=M.health.HealthConfig(straggler_factor=3.0, straggler_min_ms=50.0,
                                         straggler_min_samples=5, straggler_streak=2,
                                         eject_grace_s=30.0))
        try:
            for step in range(4):
                if step == 2:
                    lat[1]["itl_p50_ms"] = 25.0  # the straggler recovered
                await dog.tick()
                rows.append((await _observe(M, dog, hub, (1, 2, 3), "s"), list(drained)))
            return rows
        finally:
            await dog.stop()
            await hub.close()

    out = await _both(scenario)
    assert out[PORT] == out[JAX]
    rows, render = out[PORT]
    assert [r[0][1][0][:3] for r in rows] == [
        ("healthy", 0, 1), ("quarantined", 0, 2), ("healthy", 0, 0), ("healthy", 0, 0)]
    assert rows[1][0][1][0][3] == "latency_outlier" and rows[1][1] == [1]
    assert rows[2][0][1][1] is None  # the first tick without the outlier reinstates
    assert "dynamo_tpu_health_recoveries_total 1" in render


async def test_two_worker_fleet_has_no_straggler():
    """The fleet median is the upper median, so in a fleet of two it is the
    slower worker's own p50 and no worker can exceed ``straggler_factor``
    times it: in both packages a two-worker fleet never flags a straggler
    (kept for parity; ROADMAP queue 3)."""

    async def scenario(M):
        hub = await M.hub.InprocHub().start()
        lat = {1: {"itl_p50_ms": 900.0, "n": 10}, 2: {"itl_p50_ms": 10.0, "n": 10}}
        for wid in (1, 2):
            key, info = _instance("t", wid, f"a:{wid}")
            await hub.kv_put(key, info)

        async def prober(address, timeout_s):
            return True

        dog = M.health.HealthWatchdog(hub, "instances/t/", prober=prober,
                                      latency_source=lambda: lat)
        try:
            rows = []
            for _ in range(3):
                await dog.tick()
                rows.append(await _observe(M, dog, hub, (1, 2), "t"))
            return rows
        finally:
            await dog.stop()
            await hub.close()

    out = await _both(scenario)
    assert out[PORT] == out[JAX]
    rows, render = out[PORT]
    assert all(r[1][0] == ("healthy", 0, 0, "") for r in rows)
    assert "dynamo_tpu_health_stragglers_detected_total 0" in render


@pytest.mark.parametrize("probe_pkg,server_pkg", [(PORT, PORT), (JAX, JAX), (PORT, JAX),
                                                  (JAX, PORT)],
                         ids=["port", "jax", "port-probe-jax-server", "jax-probe-port-server"])
async def test_health_probe_over_service_plane(probe_pkg, server_pkg):
    """Every ServiceServer answers ``__health__`` without registration;
    readiness requires at least one real endpoint; a dead server fails."""
    probe = P[probe_pkg].health.probe_address
    server = await P[server_pkg].service.ServiceServer().start()
    try:
        assert not await probe(server.address, 1.0)  # alive but empty: not ready
        server.register("x", SimpleNamespace())
        assert await probe(server.address, 1.0)
    finally:
        await server.close()
    assert not await probe(server.address, 0.5)
    assert await probe("", 0.5)  # endpoint-less registrations pass


async def test_watchdog_quarantines_repeat_corruption_offender():
    """Repeated checksum failures attributed to one donor quarantine it
    through the watchdog's path; ledger decay reinstates."""

    async def scenario(M):
        ledger = M.health.kv_corruption
        hub = await M.hub.InprocHub().start()
        clock = SimpleNamespace(t=100.0)
        old_clock = ledger._clock
        ledger.reset()
        ledger._clock = lambda: clock.t
        drained, rows = [], []

        async def prober(address, timeout_s):
            return True

        async def drainer(info):
            drained.append(info["worker_id"])
            return 1

        for wid in (1, 2):
            key, info = _instance("i", wid, f"a:{wid}")
            await hub.kv_put(key, info)
        dog = M.health.HealthWatchdog(
            hub, "instances/i/", prober=prober, drainer=drainer, latency_source=lambda: {},
            config=M.health.HealthConfig(corrupt_after=3, eject_grace_s=1000.0),
            clock=lambda: clock.t)
        k0 = M.metrics.kv_integrity_metrics.quarantined_total
        try:
            for record, dt in ((2, 0.0), (1, 0.0), (0, ledger.window_s + 1.0)):
                ledger.record(1, n=record) if record else None
                clock.t += dt
                await dog.tick()
                rows.append((await _observe(M, dog, hub, (1, 2), "i"), list(drained),
                             M.metrics.kv_integrity_metrics.quarantined_total - k0))
            return rows
        finally:
            ledger.reset()
            ledger._clock = old_clock
            await dog.stop()
            await hub.close()

    out = await _both(scenario)
    assert out[PORT] == out[JAX]
    rows, render = out[PORT]
    assert [r[0][1][0][0] for r in rows] == ["healthy", "quarantined", "healthy"]
    assert rows[1][0][1][0][3] == "kv_corruption=3" and rows[1][1] == [1] and rows[1][2] == 1
    assert rows[2][0][1][1] is None
    assert "dynamo_tpu_health_corruption_quarantines_total 1" in render


def test_health_config_and_metrics_match_jax():
    """``HealthConfig.from_config`` reads the same fields with the same
    types, the runtime package exports the same health names, and the
    ``dynamo_tpu_health_*`` group renders with the JAX names, help
    strings, order and state rows."""
    cfg = {"probe_interval_s": "0.5", "quarantine_after": "3", "straggler_factor": 2,
           "corrupt_after": 4.0, "eject": 0, "eject_grace_s": 7, "straggler_streak": "1"}
    got = {pkg: P[pkg].health.HealthConfig.from_config(cfg) for pkg in PKGS}
    assert vars(got[PORT]) == vars(got[JAX])
    assert got[PORT].eject is False and got[PORT].quarantine_after == 3
    for pkg in PKGS:
        hm = P[pkg].health.health_metrics
        hm.probes_total, hm.state_counts = 5, {"healthy": 2, "ejected": 1}
    assert P[PORT].health.health_metrics.render() == P[JAX].health.health_metrics.render()
    for name in ("HealthConfig", "HealthWatchdog", "WorkerLatencyTracker", "health_metrics",
                 "probe_address", "worker_latency"):
        assert getattr(P[PORT].runtime, name) is getattr(P[PORT].health, name)
    assert P[PORT].health.quarantine_key(5) == P[JAX].health.quarantine_key(5)


# --------------------------------------------------------- end to end (CPU)

CFG = dict(model="debug-tiny", block_size=4, num_blocks=128, max_batch=4, max_model_len=512,
           prefill_chunk=64, dtype="float32", decode_steps=2, pipeline_depth=2)


def _engine():
    M = P[PORT]
    p = jax_init_params(jax_get_config("debug-tiny").with_overrides(dtype="float32"),
                        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    return M.engine_mod.TorchEngine(M.config.EngineConfig(**CFG), params=params, device="cpu")


def _req(tokens, max_tokens, seed=None, temperature=0.0):
    pr = P[PORT].protocols
    return pr.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=pr.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=pr.SamplingOptions(temperature=temperature, seed=seed),
    ).to_dict()


def _tokens(items):
    return [t for i in items for t in i.get("token_ids", [])]


async def _spawn(hub_address):
    M = P[PORT]
    rt = await M.component.DistributedRuntime.connect(hub_address)
    engine = _engine()
    mig = M.migration.MigratableWorker(engine, chunk_blocks=4)
    component = rt.namespace("hw").component("w")
    gen_ep, in_ep, out_ep = (component.endpoint(n) for n in ("gen", "migrate_in", "migrate_out"))
    server = await rt.service_server()
    await in_ep.serve_endpoint(mig.migrate_in_handler)
    await out_ep.serve_endpoint(mig.migrate_out_handler)
    await gen_ep.serve_endpoint(mig, metadata={"migrate": {
        "import_path": in_ep.path, "out_path": out_ep.path, "generate_path": gen_ep.path}})
    return SimpleNamespace(rt=rt, engine=engine, mig=mig, address=server.address)


async def test_default_drainer_moves_a_stragglers_live_streams():
    """Three workers; ``slow_stream`` on A's address makes A's streams a
    straggler's in the routed client's tracker.  The watchdog (default
    prober, drainer and latency source) quarantines A, its default drainer
    migrates A's two live streams to a healthy peer, and both streams end
    whole and equal to their never-migrated streams."""
    M = P[PORT]
    hub = await M.hub.HubServer().start()
    workers = [await _spawn(hub.address) for _ in range(3)]
    a = workers[0]
    client_rt = await M.component.DistributedRuntime.connect(hub.address)
    dog = None
    try:
        client = await client_rt.namespace("hw").component("w").endpoint("gen").client()
        await client.wait_for_instances(5)
        reqs = [_req(range(10 + i, 30 + i), 160, *(((None, 0.0), (4242, 0.7))[i]))
                for i in range(2)]
        controls = [_tokens(await M.engine.collect(await a.engine.generate(
            M.engine.Context(dict(r))))) for r in reqs]
        # The peers' pace, through the same client.
        for w in workers[1:]:
            await M.engine.collect(await client.generate(
                M.engine.Context(_req(range(40, 50), 24)), worker_id=w.rt.worker_id))
        M.faults.arm("slow_stream", match=a.address, delay_s=0.06)
        results = [[] for _ in reqs]

        async def consume(i):
            stream = await client.generate(M.engine.Context(dict(reqs[i])),
                                           worker_id=a.rt.worker_id)
            async for item in stream:
                results[i].append(item)

        tasks = [asyncio.ensure_future(consume(i)) for i in range(2)]
        dog = await M.health.HealthWatchdog(
            client_rt.hub, "instances/hw/w/gen/",
            config=M.health.HealthConfig(probe_interval_s=0.1, eject_grace_s=60.0)).start()
        deadline = asyncio.get_running_loop().time() + 60
        while not (M.health.health_metrics.drained_sequences_total >= 2):
            assert asyncio.get_running_loop().time() < deadline, M.health.health_metrics.render()
            await asyncio.sleep(0.05)
        M.faults.reset()
        await asyncio.gather(*tasks)
        assert dog.workers[a.rt.worker_id].state == "quarantined"
        assert dog.workers[a.rt.worker_id].reason == "latency_outlier"
        marker = await client_rt.hub.kv_get(M.health.quarantine_key(a.rt.worker_id))
        assert marker["state"] == "quarantined"
        for got, want in zip(results, controls):
            assert _tokens(got) == want and got[-1]["finish_reason"] == "length"
        assert not a.engine.live_request_ids()
        assert M.health.health_metrics.drains_total == 1
        assert M.resilience.metrics.migration_splices_total >= 2
        await client.close()
    finally:
        if dog is not None:
            await dog.stop()
        for w in workers:
            await w.engine.close()
            await w.rt.close()
        await client_rt.close()
        await hub.close()
