"""The port's KV router against the JAX package's.

- ``fast_sequence_hashes``: bit-identical to the JAX function (and so to
  ``xxhash``) at 1–4096 ids, salted and not, on both of the port's paths
  (xxhash when installed; numpy uint64 lanes and the Python chain step
  without it, as on the card's machine).
- ``KvIndexer`` / ``KvIndexerSharded``: one seeded event sequence (stored,
  removed, tiered, cleared, worker removal) gives equal ``OverlapScores``.
- ``DefaultWorkerSelector``: the same snapshots and requests give the same
  picks in the same order (the seeded tie-break included).
- The engine's KV events reach the publisher on the loop's thread, in
  order, also when emitted from a device thread.
- The full loop (``tests/test_kv_router.py``'s, here on the port): two
  ``TorchEngine`` workers behind the port's hub and a KV ``ModelWatcher``;
  the same script on two ``TpuEngine`` workers behind the JAX stack gives
  the same routing decisions (worker and overlap) and identical greedy
  streams.  Then a mixed deployment: a port worker and a JAX worker under
  one model on one hub, served by each package's frontend, on each
  package's hub.
"""

import asyncio
import importlib
import random
import threading

import jax
import numpy as np
import pytest
import xxhash

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch import tokens as port_tokens
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.llama import params_from_jax

pytestmark = pytest.mark.torch_port

PKGS = {}
for _name in ("dynamo_tpu", "dynamo_tpu_torch"):
    PKGS[_name] = {sub: importlib.import_module(f"{_name}.{sub}") for sub in (
        "tokens", "llm.kv_router.indexer", "llm.kv_router.protocols",
        "llm.kv_router.scheduler", "llm.kv_router.publisher", "llm.discovery",
        "llm.http_service", "runtime.component", "runtime.client",
        "runtime.transports.hub", "runtime.engine",
    )}
JAXP, PORTP = PKGS["dynamo_tpu"], PKGS["dynamo_tpu_torch"]


# ------------------------------------------------------------------ hashing


@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 33, 255, 1024, 2048, 4096])
@pytest.mark.parametrize("salt", [None, "tenant-a"])
@pytest.mark.parametrize("numpy_lanes", [False, True], ids=["xxhash", "numpy"])
def test_fast_sequence_hashes_bit_identical(n, salt, numpy_lanes, monkeypatch):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 2**31, size=n).tolist()
    monkeypatch.setattr(port_tokens, "USING_XXHASH", not numpy_lanes)
    for bs in (1, 3, 4, 16):
        want = JAXP["tokens"].fast_sequence_hashes(ids, bs, salt)
        assert port_tokens.fast_sequence_hashes(ids, bs, salt) == want
        assert want == [b.sequence_hash for b in port_tokens.hash_token_blocks(ids, bs, salt)]
    assert port_tokens.block_hashes_np(ids, 16) == [
        xxhash.xxh64_intdigest(np.asarray(ids[i:i + 16], dtype="<u4").tobytes(), seed=1337)
        for i in range(0, n - 15, 16)]


# ------------------------------------------------------------------ indexer


def _event_script(seed=0, n_events=300, bs=4):
    """A seeded sequence of (worker, event-as-dict): prompts stored along
    shared prefixes, evictions, tier demotions and promotions, a cleared
    worker, and explicit worker removals (``None`` events)."""
    rng = random.Random(seed)
    prefixes = [[rng.randrange(1000) for _ in range(bs * rng.randrange(1, 6))] for _ in range(5)]
    stored = {w: [] for w in range(1, 5)}
    script = []
    eid = 0
    toks_mod = JAXP["tokens"]
    for _ in range(n_events):
        eid += 1
        w = rng.randrange(1, 5)
        r = rng.random()
        if r < 0.5 or not stored[w]:
            toks = rng.choice(prefixes) + [rng.randrange(1000) for _ in range(bs * rng.randrange(0, 4))]
            blocks = toks_mod.hash_token_blocks(toks, bs)
            start = rng.randrange(0, max(1, len(blocks)))
            parent = blocks[start - 1].sequence_hash if start else None
            ev = {"event_id": eid, "data": {"stored": {
                "parent_hash": parent,
                "blocks": [{"block_hash": b.sequence_hash, "tokens_hash": b.block_hash}
                           for b in blocks[start:]]}}}
            stored[w] += [b.sequence_hash for b in blocks[start:]]
        elif r < 0.7:
            hs = rng.sample(stored[w], k=min(len(stored[w]), rng.randrange(1, 4)))
            ev = {"event_id": eid, "data": {"removed": {"block_hashes": hs}}}
        elif r < 0.9:
            hs = rng.sample(stored[w], k=min(len(stored[w]), rng.randrange(1, 4)))
            tier = rng.choice(["host", "disk", "objstore", "hbm"])
            ev = {"event_id": eid, "data": {"tiered": {"tier": tier, "block_hashes": hs}}}
        elif r < 0.95:
            ev = {"event_id": eid, "data": {"cleared": {}}}
            stored[w] = []
        else:
            ev = None  # worker removal (lease loss)
            stored[w] = []
        script.append((w, ev))
    queries = [rng.choice(prefixes) + [rng.randrange(1000) for _ in range(bs * rng.randrange(0, 3))]
               for _ in range(40)]
    return script, queries, prefixes


@pytest.mark.parametrize("sharded", [False, True], ids=["KvIndexer", "KvIndexerSharded"])
def test_indexer_overlap_scores_equal(sharded):
    script, queries, _ = _event_script()
    out = {}
    for name, p in PKGS.items():
        idx_mod, proto = p["llm.kv_router.indexer"], p["llm.kv_router.protocols"]
        cls = idx_mod.KvIndexerSharded if sharded else idx_mod.KvIndexer
        idx = cls(4)
        trace = []
        for i, (w, ev) in enumerate(script):
            if ev is None:
                idx.remove_worker(w)
            else:
                idx.apply_event(w, proto.KvCacheEvent.from_dict(ev))
            if i % 25 == 24:
                for q in queries:
                    s = idx.find_matches(q)
                    trace.append((s.scores, s.discounted, s.best(), s.deepest()))
                trace.append(idx.find_matches(queries[0], salt="t").scores)
        out[name] = trace
    assert out["dynamo_tpu_torch"] == out["dynamo_tpu"]
    assert any(scores for scores, *_ in out["dynamo_tpu"][:-1] if isinstance(scores, dict))


def test_selector_picks_equal():
    """Same snapshots, same requests: the same picks in the same order —
    the seeded ``random.Random(0)`` tie-break included — and the same
    ``KVHitRateEvent``s."""
    rng = random.Random(5)
    cases = []
    for _ in range(300):
        workers = sorted(rng.sample(range(1, 9), k=rng.randrange(1, 6)))
        scores = {w: rng.choice([0, 0, 1, 2, 4, 8]) for w in workers if rng.random() < 0.6}
        disc = {w: s * rng.choice([1.0, 0.75, 0.45]) for w, s in scores.items()}
        metrics = {w: dict(request_active_slots=rng.choice([0, 0, 1, 4]), request_total_slots=8,
                           gpu_cache_usage_perc=rng.choice([0.0, 0.0, 0.25, 0.5]))
                   for w in workers}
        cases.append((rng.choice([0, 4, 16, 33]), workers, scores, disc, metrics))
    picks = {}
    for name, p in PKGS.items():
        sch, idx, proto = (p["llm.kv_router.scheduler"], p["llm.kv_router.indexer"],
                           p["llm.kv_router.protocols"])
        events = []
        scheduler = sch.KvScheduler(4, hit_rate_callback=events.append)
        got = []
        for isl, workers, scores, disc, metrics in cases:
            snaps = [sch.WorkerSnapshot(w, proto.ForwardPassMetrics(**metrics[w])) for w in workers]
            got.append(scheduler.schedule(isl, idx.OverlapScores(scores, disc), snaps))
        picks[name] = (got, [e.to_dict() for e in events])
    assert picks["dynamo_tpu_torch"] == picks["dynamo_tpu"]
    assert len(set(picks["dynamo_tpu"][0])) > 3


# ------------------------------------------------- events onto the loop


@pytest.mark.asyncio
async def test_engine_events_reach_the_loop_thread_in_order():
    """``set_event_callback``: events emitted on the loop reach the sink at
    once; events emitted from a device thread hop over; an event emitted
    on the loop while a hop is pending queues behind it."""
    engine = TorchEngine(EngineConfig(model="debug-tiny", dtype="float32", num_blocks=16,
                                      block_size=4, max_model_len=32), device="cpu")
    got = []
    loop_thread = threading.get_ident()
    engine.set_event_callback(lambda ev: got.append((ev.event_id, threading.get_ident())))
    emit = engine.kv._event_callback
    proto = PORTP["llm.kv_router.protocols"]
    emit(proto.KvCacheEvent.removed(1, [1]))
    assert got == [(1, loop_thread)]

    def from_thread():
        emit(proto.KvCacheEvent.removed(2, [2]))
        emit(proto.KvCacheEvent.removed(3, [3]))

    await asyncio.to_thread(from_thread)
    emit(proto.KvCacheEvent.removed(4, [4]))  # hops 2 and 3 may still be pending
    for _ in range(5):
        await asyncio.sleep(0)
    assert got == [(i, loop_thread) for i in (1, 2, 3, 4)]
    emit(proto.KvCacheEvent.removed(5, [5]))
    assert got[-1] == (5, loop_thread)
    engine.set_event_callback(None)
    assert engine.kv._event_callback is None
    await engine.close()


# ------------------------------------------------------------ the full loop

BS = 4
CFG = dict(model="debug-tiny", block_size=BS, num_blocks=64, max_batch=4, max_model_len=128,
           prefill_chunk=32, dtype="float32", decode_steps=4)
_rng = np.random.default_rng(7)
PROMPTS = [_rng.integers(1, 250, size=n).tolist() for n in (21, 26, 17)]
# First passes (the seeded tie-break sends the third to the other worker),
# repeats, then a longer prompt over p0's prefix.
SCRIPT = [PROMPTS[0], PROMPTS[1], PROMPTS[2], PROMPTS[0], PROMPTS[2], PROMPTS[1],
          PROMPTS[0] + [7, 8, 9, 10, 11, 12]]


def _jax_params():
    cfg = jax_get_config("debug-tiny").with_overrides(dtype="float32")
    return jax_init_params(cfg, jax.random.PRNGKey(0))


_PARAMS = {}


def _engine(name):
    """A worker engine of package ``name`` on the shared seeded weights."""
    if "jax" not in _PARAMS:
        _PARAMS["jax"] = _jax_params()
        _PARAMS["np"] = jax.tree_util.tree_map(np.asarray, _PARAMS["jax"])
    if name == "dynamo_tpu":
        return TpuEngine(JaxEngineConfig(**CFG), params=_PARAMS["jax"])
    return TorchEngine(EngineConfig(**CFG), params=params_from_jax(_PARAMS["np"], device="cpu"),
                       device="cpu")


class _Counting:
    """Wraps a KvEventPublisher, counting what the engine emitted."""

    def __init__(self, inner, counter):
        self.inner, self.counter = inner, counter

    def __call__(self, event):
        self.counter[0] += 1
        self.inner(event)


async def _start_worker(hub_address, worker_pkg, worker_id, counter):
    """A worker of ``worker_pkg`` (engine, runtime, publishers) on the hub."""
    w = PKGS[worker_pkg]
    rt = await w["runtime.component"].DistributedRuntime.connect(hub_address)
    rt.worker_id = worker_id  # fixed ids: decisions compare across stacks
    engine = _engine(worker_pkg)
    endpoint = rt.namespace("t").component("worker").endpoint("generate")
    await endpoint.serve_endpoint(engine)
    pub = w["llm.kv_router.publisher"]
    engine.set_event_callback(_Counting(pub.KvEventPublisher(endpoint.component, worker_id), counter))
    # One snapshot at start and none after: every decision sees the same
    # load, so it turns on overlap and the seeded tie-break alone.
    mpub = await pub.KvMetricsPublisher(endpoint.component, worker_id, engine.metrics,
                                        interval=3600).start()
    await w["llm.discovery"].register_model(rt, "tiny", endpoint.path, kv_block_size=BS)
    return rt, engine, mpub


async def _frontend(front_pkg, hub_address, mode):
    f = PKGS[front_pkg]
    rt = await f["runtime.component"].DistributedRuntime.connect(hub_address)
    manager = f["llm.http_service"].ModelManager()
    watcher = await f["llm.discovery"].ModelWatcher(
        rt, manager, router_mode=f["runtime.client"].RouterMode(mode)).start()
    for _ in range(200):
        if manager.completion_engine("tiny") is not None:
            break
        await asyncio.sleep(0.02)
    return rt, manager, watcher


async def _complete(front_pkg, manager, prompt, max_tokens=6):
    f = PKGS[front_pkg]
    req = {"model": "tiny", "prompt": prompt, "max_tokens": max_tokens, "stream": True,
           "nvext": {"ignore_eos": True}}
    chunks = await f["runtime.engine"].collect(
        await manager.completion_engine("tiny").generate(f["runtime.engine"].Context(req)))
    text = "".join(c["choices"][0]["text"] for c in chunks if c.get("choices"))
    return text, chunks[-1]["choices"][0]["finish_reason"], chunks[-1].get("usage")


async def _run_script(pkg_name):
    """SCRIPT through one package's whole stack: hub, two workers of that
    package, a KV frontend.  Returns [(worker, overlap_blocks, text)] and
    the workers' prefix-hit gains per request."""
    p = PKGS[pkg_name]
    hub = await p["runtime.transports.hub"].HubServer(host="127.0.0.1").start()
    workers, counter = [], [0]
    front = None
    try:
        for wid in (1, 2):
            workers.append(await _start_worker(hub.address, pkg_name, wid, counter))
        front_rt, manager, watcher = front = await _frontend(pkg_name, hub.address, "kv")
        core = watcher._router_cores["tiny"]
        while len(core.client.instance_ids) < 2:
            await asyncio.sleep(0.02)
        sub = await core.component.subscribe("kv-hit-rate")
        out, gains = [], []
        for prompt in SCRIPT:
            before = [e.kv.matched_blocks for _, e, _ in workers]
            text, finish, usage = await _complete(pkg_name, manager, prompt)
            _, hit = await asyncio.wait_for(sub.__anext__(), 10)
            # Let every KV event the request produced reach the index.
            for _ in range(500):
                if core.indexer.events_applied >= counter[0]:
                    break
                await asyncio.sleep(0.01)
            assert core.indexer.events_applied == counter[0]
            out.append((hit["worker_id"], hit["overlap_blocks"], text, finish,
                        usage["completion_tokens"]))
            gains.append([e.kv.matched_blocks - b for (_, e, _), b in zip(workers, before)])
        await sub.aclose()
        return out, gains
    finally:
        if front is not None:
            await front[2].stop()
            await front[0].close()
        for rt, engine, mpub in workers:
            await mpub.stop()
            await engine.close()
            await rt.close()
        await hub.close()


@pytest.mark.asyncio
async def test_kv_routing_matches_the_jax_stack():
    got, gains = await _run_script("dynamo_tpu_torch")
    want, jax_gains = await _run_script("dynamo_tpu")
    assert got == want
    assert gains == jax_gains
    first = {}
    for prompt, (worker, overlap, _, finish, ntok), gain in zip(SCRIPT, got, gains):
        key = tuple(prompt)
        assert finish == "length" and ntok == 6
        if key in first:
            # A repeat goes to the worker that cached it, with its full
            # prefix, and only that worker's prefix hits rise.
            assert worker == first[key] and overlap == len(prompt) // BS
            assert gain[worker - 1] > 0 and gain[2 - worker] == 0
        else:
            first[key] = worker
    assert set(first.values()) == {1, 2}  # both workers hold first passes
    # The extension of p0 goes where p0's blocks are.
    assert got[-1][0] == first[tuple(PROMPTS[0])] and got[-1][1] == len(PROMPTS[0]) // BS


@pytest.mark.parametrize("hub_pkg", ["dynamo_tpu", "dynamo_tpu_torch"],
                         ids=["jax-hub", "port-hub"])
@pytest.mark.asyncio
async def test_mixed_deployment_serves_from_each_frontend(hub_pkg):
    """A port worker and a JAX worker under one model on one hub: each
    package's round-robin frontend reaches both, and every answer equals
    the others (the workers share the seeded weights)."""
    hub = await PKGS[hub_pkg]["runtime.transports.hub"].HubServer(host="127.0.0.1").start()
    workers, fronts = [], []
    try:
        for wid, worker_pkg in ((1, "dynamo_tpu_torch"), (2, "dynamo_tpu")):
            workers.append(await _start_worker(hub.address, worker_pkg, wid, [0]))
        texts = []
        for front_pkg in ("dynamo_tpu", "dynamo_tpu_torch"):
            rt, manager, watcher = await _frontend(front_pkg, hub.address, "round_robin")
            fronts.append((rt, watcher))
            client = watcher._clients["tiny"]
            while len(client.instance_ids) < 2:
                await asyncio.sleep(0.02)
            before = [e.kv.lookup_blocks for _, e, _ in workers]
            for _ in range(2):
                texts.append(await _complete(front_pkg, manager, PROMPTS[1]))
            served = [e.kv.lookup_blocks - b for (_, e, _), b in zip(workers, before)]
            assert all(s > 0 for s in served), (front_pkg, served)
        assert all(t == texts[0] for t in texts) and texts[0][1] == "length"
    finally:
        for rt, watcher in fronts:
            await watcher.stop()
            await rt.close()
        for rt, engine, mpub in workers:
            await mpub.stop()
            await engine.close()
            await rt.close()
        await hub.close()


@pytest.mark.asyncio
async def test_standalone_router_service_and_model_card():
    """``make_kv_router`` + ``KvRouter``: the standalone routing service
    answers ``{"worker_id", "overlap_blocks"}`` from the events a worker
    publishes; a ``ModelDeploymentCard`` published by a worker loads and
    lists alike in both packages' card classes."""
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter, make_kv_router
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    P = PORTP
    rt = await P["runtime.component"].DistributedRuntime.detached()
    try:
        endpoint = rt.namespace("t").component("worker").endpoint("generate")

        async def gen(request):
            yield {"token_ids": [1]}

        await endpoint.serve_endpoint(gen)
        core = await make_kv_router(endpoint, BS)
        await core.client.wait_for_instances(2)
        pub = P["llm.kv_router.publisher"].KvEventPublisher(endpoint.component, rt.worker_id)
        toks = PROMPTS[0]
        proto = P["llm.kv_router.protocols"]
        blocks = port_tokens.hash_token_blocks(toks, BS)
        await pub.publish(proto.KvCacheEvent.stored(1, None, [
            proto.KvCacheStoredBlockData(b.sequence_hash, b.block_hash) for b in blocks]))
        for _ in range(100):
            if core.indexer.events_applied:
                break
            await asyncio.sleep(0.01)
        Ctx = P["runtime.engine"].Context
        items = await P["runtime.engine"].collect(
            await KvRouter(core).generate(Ctx({"token_ids": toks + [1, 2]})))
        assert items == [{"worker_id": rt.worker_id, "overlap_blocks": len(toks) // BS}]
        await core.stop()
        await core.client.close()

        card = ModelDeploymentCard(name="tiny", context_length=128, kv_block_size=BS,
                                   architecture="debug-tiny", extra={"k": 1})
        await card.publish(rt)
        loaded = await ModelDeploymentCard.load(rt, "tiny")
        assert loaded == card and loaded.to_dict() == JaxCard.from_dict(card.to_dict()).to_dict()
        assert list(await ModelDeploymentCard.list_all(rt)) == ["tiny"]
        assert card.key() == JaxCard(name="tiny").key()
    finally:
        await rt.close()
