"""The auxiliary services on the port against the JAX package.

- billing (``tests/test_aux.py::test_billing_events_roundtrip``): each
  package's ``BillingPublisher`` onto one hub, each package's subscriber
  reading both; the events and their wire dicts equal;
- the ``metrics`` aggregator with a mock worker
  (``tests/test_aux.py::test_metrics_aggregator_with_mock_worker``): the
  port's standard-library ``/metrics`` against the JAX aiohttp server over
  the same seeded mock workers, the bodies byte for byte, 404 alike;
- the stream recorder (``tests/test_aux.py::test_stream_recorder_record_and_replay``):
  ``TorchEngine`` on the JAX engine's seed-0 weights against ``TpuEngine``
  (debug-tiny, f32): the same recorded streams, each package reading the
  other's file, replays equal;
- ``KvRecorder`` (``tests/test_kv_router.py::test_recorder_replay``): the
  same event files, and replays into either package's indexer give the
  same routing decisions;
- logging (``tests/test_runtime_config.py``): ``parse_filter``,
  ``JsonlFormatter`` and ``setup_logging`` alike.
"""

import asyncio
import importlib
import json
import logging
import random
import types

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)


def X(pkg):
    m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        billing=m("llm.billing"), ms=m("llm.metrics_service"), hub=m("runtime.transports.hub"),
        component=m("runtime.component"), recorder=m("runtime.recorder"),
        kvrec=m("llm.kv_router.recorder"), indexer=m("llm.kv_router.indexer"),
        protocols=m("llm.kv_router.protocols"), logcfg=m("runtime.logging_config"),
        engine=m("runtime.engine"), llm_protocols=m("llm.protocols"),
        kv_router=m("llm.kv_router"), runtime=m("runtime"),
    )


async def test_billing_events_roundtrip_across_packages():
    hub = await X(PORT).hub.HubServer().start()
    rts = {pkg: await X(pkg).component.DistributedRuntime.connect(hub.address) for pkg in PKGS}
    try:
        subs = {pkg: await rts[pkg].namespace("bill").subscribe(X(pkg).billing.TOKEN_EVENTS_SUBJECT)
                for pkg in PKGS}
        sent = {}
        for pkg in PKGS:
            B = X(pkg).billing
            ev = B.BillingEvent(10, 20, "m", organization_id=f"org-{pkg}")
            sent[pkg] = ev.to_dict()
            await B.BillingPublisher(rts[pkg].namespace("bill")).publish(ev)
        for pkg in PKGS:
            got = []
            for _ in PKGS:
                _, payload = await asyncio.wait_for(subs[pkg].__anext__(), 5)
                got.append(X(pkg).billing.BillingEvent.from_dict(payload).to_dict())
            assert sorted(got, key=json.dumps) == sorted(sent.values(), key=json.dumps)
        assert X(PORT).billing.TOKEN_EVENTS_SUBJECT == X(JAX).billing.TOKEN_EVENTS_SUBJECT
        for sub in subs.values():
            await sub.aclose()
    finally:
        for rt in rts.values():
            await rt.close()
        await hub.close()


async def test_metrics_aggregator_bodies_match_jax():
    """One hub, both aggregators, two seeded mock workers (one of each
    package) publishing on a fixed clock: after the same publications the
    two ``/metrics`` bodies are byte for byte the same, as are their
    statuses and content types, and an unknown path answers 404 on both."""
    from aiohttp import ClientSession

    hub = await X(PORT).hub.HubServer().start()
    rts = {pkg: await X(pkg).component.DistributedRuntime.connect(hub.address) for pkg in PKGS}
    services, mocks = {}, []
    try:
        for pkg in PKGS:
            comp = rts[pkg].namespace("obs").component("worker")
            services[pkg] = await X(pkg).ms.MetricsAggregatorService(
                comp, host="127.0.0.1", port=0).start()
        for pkg, wid in ((PORT, 42), (JAX, 43)):
            comp = rts[pkg].namespace("obs").component("worker")
            mocks.append(await X(pkg).ms.MockWorker(comp, worker_id=wid, interval=0.05,
                                                     seed=7).start())
        await asyncio.sleep(0.4)
        for m in mocks:
            await m.stop()
        # One more hit-rate event for the router's series, then settle.
        await rts[PORT].namespace("obs").component("worker").publish(
            "kv-hit-rate", {"worker_id": 42, "isl_blocks": 9, "overlap_blocks": 4})
        await asyncio.sleep(0.3)
        ports = {PORT: services[PORT].port,
                 JAX: services[JAX]._runner.addresses[0][1]}
        got = {}
        async with ClientSession() as http:
            for pkg in PKGS:
                got[pkg] = []
                for path in ("/metrics", "/nope"):
                    async with http.get(f"http://127.0.0.1:{ports[pkg]}{path}") as r:
                        got[pkg].append((r.status, r.headers.get("Content-Type"), await r.read()))
        assert got[PORT] == got[JAX]
        text = got[PORT][0][2].decode()
        assert 'dynamo_tpu_worker_kv_total_blocks{worker_id="42"} 256' in text
        assert 'dynamo_tpu_worker_kv_total_blocks{worker_id="43"} 256' in text
        assert "dynamo_tpu_router_isl_blocks 9" in text
        assert services[PORT].render() == services[JAX].render()
    finally:
        for s in services.values():
            await s.stop()
        for rt in rts.values():
            await rt.close()
        await hub.close()


def test_stream_recorder_record_and_replay_across_packages(tmp_path):
    """``RecordingEngine`` around ``TorchEngine`` (the JAX engine's seed-0
    weights) and around ``TpuEngine``: the items captured verbatim and
    equal across packages, monotone timestamps, each package loading the
    other's file, and ``replay_into`` reproducing the streams."""
    from dynamo_tpu.engine import EngineConfig as JaxConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.models.config import get_config as jax_get_config
    from dynamo_tpu.models.llama import init_params as jax_init_params
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.llama import params_from_jax

    cfg = dict(model="debug-tiny", block_size=4, num_blocks=64, max_batch=2, max_model_len=64,
               prefill_chunk=16, dtype="float32")
    p = jax_init_params(jax_get_config("debug-tiny").with_overrides(dtype="float32"),
                        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")

    async def main():
        engines = {PORT: TorchEngine(EngineConfig(**cfg), params=params, device="cpu"),
                   JAX: TpuEngine(JaxConfig(**cfg))}
        outs, rows = {}, {}
        for pkg in PKGS:
            R, E, pr = X(pkg).recorder, X(pkg).engine, X(pkg).llm_protocols
            path = str(tmp_path / f"{pkg}.jsonl")
            rec = R.StreamRecorder(path)
            eng = R.RecordingEngine(engines[pkg], rec)
            outs[pkg] = []
            for i, prompt in enumerate(([1, 2, 3], [9, 8, 7, 6])):
                req = pr.PreprocessedRequest(
                    token_ids=prompt, stop_conditions=pr.StopConditions(max_tokens=5,
                                                                        ignore_eos=True))
                outs[pkg].append(await E.collect(await eng.generate(
                    E.Context.with_id(req.to_dict(), f"req-{i}"))))
            rec.close()
            assert rec.count == 2 * 2 + sum(len(o) for o in outs[pkg])
        for pkg in PKGS:
            other = JAX if pkg == PORT else PORT
            rows[pkg] = X(pkg).recorder.load_streams(str(tmp_path / f"{other}.jsonl"))
            assert [(r[0], r[1]) for r in rows[pkg]] == [
                (r[0], r[1]) for r in X(other).recorder.load_streams(str(tmp_path / f"{other}.jsonl"))]
            for (_, items, tss), live in zip(rows[pkg], outs[other]):
                assert items == live and tss == sorted(tss) and len(tss) >= len(items)
            assert await X(pkg).recorder.replay_into(str(tmp_path / f"{other}.jsonl"),
                                                     engines[pkg]) == outs[pkg]
        toks = {pkg: [[t for it in o for t in it.get("token_ids", [])] for o in outs[pkg]]
                for pkg in PKGS}
        assert toks[PORT] == toks[JAX]
        for e in engines.values():
            await e.close()

    asyncio.run(main())


def _events(pkg, seed):
    P_ = X(pkg).protocols
    rng = random.Random(seed)
    out = []
    for i in range(24):
        wid = rng.randint(1, 3)
        n = rng.randint(1, 6)
        base = rng.randint(0, 3) * 1000
        blocks = [P_.KvCacheStoredBlockData(base + k, base + k + 7) for k in range(n)]
        out.append((wid, P_.KvCacheEvent.stored(i + 1, None, blocks)))
    return out


@pytest.mark.parametrize("sharded", [False, True])
def test_kv_recorder_replay_gives_the_same_routing(sharded, tmp_path):
    """Each package's ``KvRecorder`` writes the same event stream; each
    file replays into either package's indexer (plain or sharded) and the
    overlap scores that route requests are equal everywhere."""
    for pkg in PKGS:
        rec = X(pkg).kvrec.KvRecorder(str(tmp_path / f"{pkg}.jsonl"))
        for wid, ev in _events(pkg, 5):
            rec.record(wid, ev)
        rec.close()
    lines = {pkg: [{k: v for k, v in json.loads(line).items() if k != "ts"}
                   for line in open(tmp_path / f"{pkg}.jsonl")] for pkg in PKGS}
    assert lines[PORT] == lines[JAX]
    queries = [[base + k for k in range(n)] for base in (0, 1000, 2000, 3000) for n in (1, 3, 6)]
    decisions = {}
    for reader in PKGS:
        I = X(reader).indexer
        for src in PKGS:
            idx = I.KvIndexerSharded(4, num_shards=2) if sharded else I.KvIndexer(4)

            async def replay(i=idx, s=src):
                return await X(reader).kvrec.replay_events(str(tmp_path / f"{s}.jsonl"), i)

            assert asyncio.run(replay()) == 24
            decisions[(reader, src)] = [idx.find_matches_for_hashes(q).scores for q in queries] \
                if hasattr(idx, "find_matches_for_hashes") else \
                [idx.find_matches(q).scores for q in queries]
    first = decisions[(PORT, PORT)]
    assert all(d == first for d in decisions.values())
    assert any(first)
    assert X(PORT).kv_router.KvRecorder is X(PORT).kvrec.KvRecorder


def test_logging_filters_formatter_and_setup_match():
    """``parse_filter`` and ``JsonlFormatter`` give the same results, and
    ``setup_logging`` installs one handler with the same levels, on both;
    the port's runtime package exports them as the JAX one does."""
    spec = "warn,dynamo_tpu.engine=debug,hub=error,bogus=nope"
    assert X(PORT).logcfg.parse_filter(spec) == X(JAX).logcfg.parse_filter(spec)
    rec = logging.LogRecord("dynamo_tpu.engine", logging.INFO, __file__, 1, "hello %s", ("x",),
                            None)
    rec.created = 1700000000.25
    rec.extra_field = {"a": 1}
    outs = {pkg: json.loads(X(pkg).logcfg.JsonlFormatter().format(rec)) for pkg in PKGS}
    assert outs[PORT] == outs[JAX] and outs[PORT]["time"].endswith("Z")
    root = logging.getLogger()
    saved = (list(root.handlers), root.level, logging.getLogger("mymod").level)
    try:
        states = {}
        for pkg in PKGS:
            for h in [h for h in root.handlers if getattr(h, "_dyn_installed", False)]:
                root.removeHandler(h)
            L = X(pkg).logcfg
            L.setup_logging(spec="warn,mymod=debug", fmt="jsonl")
            L.setup_logging(spec="warn,mymod=debug", fmt="jsonl")
            ours = [h for h in root.handlers if getattr(h, "_dyn_installed", False)]
            states[pkg] = (len(ours), type(ours[0].formatter).__name__, root.level,
                           logging.getLogger("mymod").level)
        assert states[PORT] == states[JAX] == (1, "JsonlFormatter", logging.WARNING,
                                               logging.DEBUG)
        for name in ("JsonlFormatter", "parse_filter", "setup_logging"):
            assert getattr(X(PORT).runtime, name) is getattr(X(PORT).logcfg, name)
    finally:
        for h in [h for h in root.handlers if getattr(h, "_dyn_installed", False)]:
            root.removeHandler(h)
        for h in saved[0]:
            if h not in root.handlers:
                root.addHandler(h)
        root.setLevel(saved[1])
        logging.getLogger("mymod").setLevel(saved[2])


async def test_run_record_taps_every_stream(tmp_path):
    """``run in=http out=echocore --record FILE``: the CLI wraps the engine
    in ``RecordingEngine``, so a completion through the edge lands in the
    file as one stream (request, items, end), loadable by both packages."""
    import urllib.request

    from dynamo_tpu_torch import cli

    path = str(tmp_path / "rec.jsonl")
    args = cli.parse_args(["run", "in=http", "out=echocore", "--port", "0", "--host",
                           "127.0.0.1", "--record", path])
    ready = asyncio.get_running_loop().create_future()
    task = asyncio.ensure_future(cli._run(args, on_serving=ready.set_result))
    try:
        service = await asyncio.wait_for(ready, 30)
        body = json.dumps({"model": "echo", "prompt": [5, 6, 7], "max_tokens": 3}).encode()

        def post():
            req = urllib.request.Request(f"http://127.0.0.1:{service.port}/v1/completions",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status

        assert await asyncio.to_thread(post) == 200
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    rows = {pkg: X(pkg).recorder.load_streams(path) for pkg in PKGS}
    assert rows[PORT] == rows[JAX] and len(rows[PORT]) == 1
    request, items, _ = rows[PORT][0]
    assert request["token_ids"] == [5, 6, 7] and items
