"""Live sequence migration on the port against the JAX package.

Mirrors of ``tests/test_migration.py`` on ``TorchEngine`` workers over the
port's hub and service plane:

- the snapshot round trip and its resume request (the speculation state
  included), a garbage ``resume`` annotation, and ``to_dict`` equal key for
  key to the JAX package's for the same sequence;
- the exact stream: a seeded temperature > 0 request migrated once (A→B)
  and another twice (A→B→C) give the never-migrated stream, spliced by the
  routed client (``migration_splices_total``), the source releasing its
  rows and blocks and the target resuming on a prefix hit;
- a commit failure rolls back with the source authoritative, a block-size
  mismatch aborts in the copy phase; the remote drain through
  ``request_migrate_out`` finishes while a control of the same sequence is
  still decoding; target picking; inject validation and rollback; penalty
  counts surviving the prompt folding;
- the CLI's decode role: stopping a ``run in=dyn:// out=torch`` worker
  drains its live streams to its peer through migration, whole;
- across packages, over one hub: a JAX source migrating to a port target
  and the reverse, greedy and seeded, each stream equal to the
  never-migrated stream of either package (the two share seeded weights
  and, since the port draws ``jax.random``'s noise, sampled streams).

Engines run debug-tiny in f32 at block size 4 (the JAX engine on its XLA
attention path, the port on the plain versions of its kernels).  The
copy-versus-decode race is made count-bounded by ``_CopyGate`` (the JAX
test's gate: the engine's ``pace_hook`` parks decode on a per-round
budget, the worker's ``copy_round_hook`` refills it).
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
from dynamo_tpu_torch.models.llama import params_from_jax

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"


def _pkg(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, config=m("engine.config"), engine_mod=m("engine.engine"),
        scheduler=m("engine.scheduler"), migration=m("llm.migration"),
        metrics=m("llm.metrics"), protocols=m("llm.protocols"),
        component=m("runtime.component"), hub=m("runtime.transports.hub"),
        engine=m("runtime.engine"), resilience=m("runtime.resilience"), tokens=m("tokens"),
    )


P = {JAX: _pkg(JAX), PORT: _pkg(PORT)}

CFG = dict(model="debug-tiny", block_size=4, num_blocks=128, max_batch=4, max_model_len=512,
           prefill_chunk=64, dtype="float32", decode_steps=2, pipeline_depth=2)
_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS["jax"] = jax_init_params(
            jax_get_config("debug-tiny").with_overrides(dtype="float32"), jax.random.PRNGKey(0))
        _PARAMS["np"] = jax.tree_util.tree_map(np.asarray, _PARAMS["jax"])
    return _PARAMS


def _engine(pkg, **over):
    """An engine of ``pkg`` on the shared seeded weights."""
    cfg = P[pkg].config.EngineConfig(**dict(CFG, **over))
    if pkg == JAX:
        return P[JAX].engine_mod.TpuEngine(cfg, params=_params()["jax"])
    return P[PORT].engine_mod.TorchEngine(
        cfg, params=params_from_jax(_params()["np"], device="cpu"), device="cpu")


def _req(pkg, tokens, max_tokens=16, seed=1234, temperature=0.9, **samp):
    pr = P[pkg].protocols
    return pr.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=pr.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=pr.SamplingOptions(temperature=temperature, seed=seed, **samp),
    ).to_dict()


def _tokens(items):
    return [t for i in items for t in i.get("token_ids", [])]


async def _control(pkg, engine, req):
    """The never-migrated stream of ``req`` on ``engine``."""
    E = P[pkg].engine
    return _tokens(await E.collect(await engine.generate(E.Context(dict(req)))))


async def _prewarm(pkg, engine):
    """One request and one export/inject round trip ahead of the races."""
    toks = list(range(200, 216))
    await _control(pkg, engine, _req(pkg, toks, max_tokens=4, seed=1))
    payload = await engine.export_prompt_blocks(toks)
    assert payload is not None
    await engine.inject_blocks(toks, payload)


async def _spawn_worker(pkg, hub_address, ns, comp, **over):
    """One migration-capable worker of ``pkg`` over the service plane: gen
    + migrate_in + migrate_out endpoints, as the CLI's decode role wires
    them."""
    M = P[pkg]
    rt = await M.component.DistributedRuntime.connect(hub_address)
    engine = _engine(pkg, **over)
    await _prewarm(pkg, engine)
    mig = M.migration.MigratableWorker(engine, chunk_blocks=4)
    component = rt.namespace(ns).component(comp)
    gen_ep = component.endpoint("gen")
    in_ep = component.endpoint("migrate_in")
    out_ep = component.endpoint("migrate_out")
    server = await rt.service_server()
    await in_ep.serve_endpoint(mig.migrate_in_handler)
    await out_ep.serve_endpoint(mig.migrate_out_handler)
    metadata = {"migrate": {"import_path": in_ep.path, "out_path": out_ep.path,
                            "generate_path": gen_ep.path}}
    await gen_ep.serve_endpoint(mig, metadata=metadata)
    return SimpleNamespace(
        pkg=pkg, rt=rt, engine=engine, mig=mig,
        info={"address": server.address, "path": gen_ep.path, "worker_id": rt.worker_id,
              "metadata": metadata},
        target={"worker_id": rt.worker_id, "address": server.address,
                "import_path": in_ep.path, "generate_path": gen_ep.path},
    )


async def _close_worker(w):
    await w.engine.close()
    await w.rt.close()


async def _wait_for(cond, timeout=60.0, interval=0.005):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, "condition timeout"
        await asyncio.sleep(interval)


def _consume(stream, items):
    async def run():
        async for it in stream:
            items.append(it)

    return asyncio.create_task(run())


class _Pace:
    """A fixed delay before every device op of ``engines`` (decode slower
    than the raced path); ``release()`` restores full speed."""

    def __init__(self, *engines, delay_s=0.05):
        self._engines = engines
        self._on = True
        self._delay = delay_s
        for e in engines:
            e.pace_hook = self._hook

    async def _hook(self):
        if self._on:
            await asyncio.sleep(self._delay)

    def release(self):
        self._on = False
        for e in self._engines:
            e.pace_hook = None


class _CopyGate:
    """The JAX test's count-bounded decode-vs-copy interlock: decode spends
    one budget unit per paced device op and parks when it is dry; each
    shipped copy round refills ``steps_per_round``; at ``final`` (just
    before the freeze) the gate stops parking and only delays."""

    def __init__(self, worker, steps_per_round=2, final_delay_s=0.02):
        self._worker, self._engine = worker, worker.engine
        self._per_round, self._final_delay = steps_per_round, final_delay_s
        self._budget = steps_per_round
        self._refill = asyncio.Event()
        self._final = self._released = False
        self.rounds = 0
        worker.engine.pace_hook = self._pace
        worker.copy_round_hook = self._round

    async def _pace(self):
        if self._released:
            return
        if self._final:
            await asyncio.sleep(self._final_delay)
            return
        while self._budget <= 0 and not self._final and not self._released:
            self._refill.clear()
            await self._refill.wait()
        self._budget -= 1

    async def _round(self, cursor, final):
        if final:
            self._final = True
        else:
            self.rounds += 1
            self._budget += self._per_round
        self._refill.set()

    def release(self):
        self._released = True
        self._refill.set()
        self._engine.pace_hook = None
        self._worker.copy_round_hook = None


# ---------------------------------------------------------------- snapshot


@pytest.mark.parametrize("pkg", [PORT, JAX])
def test_snapshot_roundtrip_and_resume_request(pkg):
    M = P[pkg]
    snap = M.migration.SequenceSnapshot(
        request_id="r1", token_ids=[1, 2, 3, 4, 5, 6], orig_prompt_len=4,
        sampling={"seed": 99, "temperature": 0.7, "top_k": 0, "top_p": 1.0},
        stop={"max_tokens": 32, "stop_token_ids": [7], "ignore_eos": True},
        spec={"k": 3, "ewma": 0.5, "bench_until": 9, "next_try": 4, "miss": 1},
        deadline_s=2.5,
    )
    assert snap.emitted == 2
    assert M.migration.SequenceSnapshot.from_dict(snap.to_dict()) == snap
    # The other package reads the same wire dict back to an equal snapshot.
    other = P[JAX if pkg == PORT else PORT].migration.SequenceSnapshot
    assert other.from_dict(snap.to_dict()).to_dict() == snap.to_dict()
    assert other.from_dict(snap.to_dict()).to_resume_request() == snap.to_resume_request()

    pre = M.protocols.PreprocessedRequest.from_dict(snap.to_resume_request())
    seq = M.scheduler.SequenceState.from_request("r1", pre, M.config.EngineConfig(**CFG))
    # The resumed state continues EXACTLY: rng-stream position, budget
    # accounting and the speculation controller count from the original
    # prompt, not the folded one.
    assert seq.orig_prompt_len == 4
    assert seq.num_output_tokens == 2
    assert seq.sampling_seed == 99
    assert seq.max_new_tokens == 32
    assert seq.stop_token_ids == frozenset({7})
    assert (seq.spec_k, seq.spec_ewma, seq.spec_bench_until, seq.spec_next_try,
            seq.spec_miss) == (3, 0.5, 9, 4, 1)


@pytest.mark.parametrize("pkg", [PORT, JAX])
def test_resume_annotation_ignores_garbage(pkg):
    M = P[pkg]
    pre = M.protocols.PreprocessedRequest.from_dict(
        {"token_ids": [1, 2, 3], "annotations": {"resume": {"orig_prompt_len": 99}}})
    seq = M.scheduler.SequenceState.from_request("r", pre, M.config.EngineConfig(**CFG))
    assert seq.orig_prompt_len == 3  # falls back to the fresh-request rule
    pre = M.protocols.PreprocessedRequest.from_dict(
        {"token_ids": [1, 2, 3], "annotations": {"resume": {"orig_prompt_len": "x",
                                                            "spec": "nope"}}})
    seq = M.scheduler.SequenceState.from_request("r", pre, M.config.EngineConfig(**CFG))
    assert seq.orig_prompt_len == 3 and seq.spec_k == -1


async def test_snapshot_to_dict_equals_jax_key_for_key():
    """The same live sequence (a resumed, spec-carrying, seeded request
    with two tokens emitted) snapshots to the same wire dict in both
    engines, and a snapshot of a fresh greedy request too."""
    out = {}
    for pkg in (JAX, PORT):
        M = P[pkg]
        engine = _engine(pkg)
        try:
            dicts = []
            for rid, req in (
                ("a", _req(pkg, range(1, 10), max_tokens=40, seed=7, temperature=0.8,
                           top_k=5, top_p=0.9, frequency_penalty=0.25)),
                ("b", _req(pkg, range(3, 8), max_tokens=5, seed=None, temperature=0.0)),
            ):
                if rid == "a":
                    req["annotations"] = {"resume": {"orig_prompt_len": 7, "spec": {
                        "k": 4, "ewma": 0.75, "bench_until": 12, "next_try": 3, "miss": 2}}}
                    req["stop_conditions"]["stop_token_ids"] = [9, 3]
                pre = M.protocols.PreprocessedRequest.from_dict(req)
                seq = M.scheduler.SequenceState.from_request(rid, pre, engine.cfg)
                seq.output = [11, 12]
                engine.scheduler.running.append(seq)
                dicts.append(engine.snapshot_sequence(rid).to_dict())
                engine.scheduler.running.remove(seq)
            out[pkg] = dicts
        finally:
            await engine.close()
    assert out[PORT] == out[JAX]
    assert [list(d) for d in out[PORT]] == [list(d) for d in out[JAX]]


# ------------------------------------------------- exact-stream equivalence


async def test_migrate_once_and_twice_exact_stream():
    """A seeded temperature > 0 request migrated mid-decode (A→B) gives
    the never-migrated stream with its tail decoded by B; a second one
    migrated twice (A→B→C) too — the resume request is self-describing,
    so a migrated sequence is itself migratable."""
    M = P[PORT]
    metrics = M.metrics.migration_metrics
    metrics.reset()
    splices0 = M.resilience.metrics.migration_splices_total
    hub = await M.hub.HubServer().start()
    a = await _spawn_worker(PORT, hub.address, "m", "w")
    b = await _spawn_worker(PORT, hub.address, "m", "w")
    c = await _spawn_worker(PORT, hub.address, "m", "w")
    client_rt = await M.component.DistributedRuntime.connect(hub.address)
    try:
        client = await client_rt.namespace("m").component("w").endpoint("gen").client()
        await client.wait_for_instances(5)
        # --- once: A → B
        req = _req(PORT, range(1, 18), max_tokens=64)
        control = await _control(PORT, a.engine, req)
        assert len(control) == 64
        ctx = M.engine.Context(dict(req))
        stream = await client.generate(ctx, worker_id=a.rt.worker_id)
        items = []
        task = _consume(stream, items)
        await _wait_for(lambda: len(_tokens(items)) >= 5)
        before = len(_tokens(items))
        gate = _CopyGate(a.mig)
        assert await a.mig.migrate_out(ctx.id, b.target)
        assert gate.rounds >= 1
        gate.release()
        await task
        assert _tokens(items) == control
        assert items[-1]["finish_reason"] == "length"
        assert a.engine.find_sequence(ctx.id) is None  # the source released it
        assert a.engine.kv.active_blocks == 0  # and its blocks
        assert before < len(control)
        assert metrics.completed_total == 1 and metrics.blocks_total > 0
        assert b.engine.kv.matched_blocks > 0  # resumed on a prefix hit
        assert M.resilience.metrics.migration_splices_total == splices0 + 1
        # --- twice: A → B → C
        req2 = _req(PORT, range(21, 41), max_tokens=128, seed=777)
        control2 = await _control(PORT, a.engine, req2)
        ctx2 = M.engine.Context(dict(req2))
        stream2 = await client.generate(ctx2, worker_id=a.rt.worker_id)
        items2 = []
        task2 = _consume(stream2, items2)
        await _wait_for(lambda: len(_tokens(items2)) >= 4)
        gate = _CopyGate(a.mig)
        assert await a.mig.migrate_out(ctx2.id, b.target)
        gate.release()
        await _wait_for(lambda: (s := b.engine.find_sequence(ctx2.id)) is not None
                        and s.num_output_tokens >= len(_tokens(items2)) + 2)
        gate = _CopyGate(b.mig)
        assert await b.mig.migrate_out(ctx2.id, c.target)
        gate.release()
        await task2
        assert _tokens(items2) == control2
        assert b.engine.find_sequence(ctx2.id) is None
        assert c.engine.kv.matched_blocks > 0
        assert metrics.completed_total == 3
        assert M.resilience.metrics.migration_splices_total == splices0 + 3
        await client.close()
    finally:
        for w in (a, b, c):
            await _close_worker(w)
        await client_rt.close()
        await hub.close()


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
async def test_migration_across_packages(src, dst):
    """One hub (the destination's package), a source worker of one package
    and a target of the other: a greedy and a seeded temperature stream,
    each migrated mid-decode through the port's routed client, equal the
    never-migrated stream of either package."""
    C = P[PORT]
    hub = await P[dst].hub.HubServer().start()
    a = await _spawn_worker(src, hub.address, "x", "w")
    b = await _spawn_worker(dst, hub.address, "x", "w")
    client_rt = await C.component.DistributedRuntime.connect(hub.address)
    try:
        client = await client_rt.namespace("x").component("w").endpoint("gen").client()
        await client.wait_for_instances(5)
        for i, (seed, temp) in enumerate(((None, 0.0), (4242, 0.7))):
            req = _req(PORT, range(10 + i, 31 + i), max_tokens=48, seed=seed, temperature=temp)
            want_src = await _control(src, a.engine, _req(src, req["token_ids"], 48, seed, temp))
            want_dst = await _control(dst, b.engine, _req(dst, req["token_ids"], 48, seed, temp))
            assert want_src == want_dst and len(want_src) == 48
            ctx = C.engine.Context(dict(req))
            stream = await client.generate(ctx, worker_id=a.rt.worker_id)
            items = []
            task = _consume(stream, items)
            await _wait_for(lambda: len(_tokens(items)) >= 4)
            gate = _CopyGate(a.mig)
            assert await a.mig.migrate_out(ctx.id, b.target)
            gate.release()
            await task
            assert _tokens(items) == want_src
            assert items[-1]["finish_reason"] == "length"
            assert a.engine.find_sequence(ctx.id) is None
        assert b.engine.kv.matched_blocks > 0
        await client.close()
    finally:
        await _close_worker(a)
        await _close_worker(b)
        await client_rt.close()
        await hub.close()


# -------------------------------------------------------- rollback paths


async def test_commit_failure_rolls_back_source_authoritative():
    """A target that refuses the commit (the folded prompt would exceed its
    max_model_len) leaves the source authoritative: the sequence unfreezes
    and keeps decoding, the client stream untouched.  A block-size
    mismatch is caught at the first push: the copy phase aborts without
    freezing."""
    M = P[PORT]
    metrics = M.metrics.migration_metrics
    metrics.reset()
    src = _engine(PORT)
    tiny = _engine(PORT, max_model_len=16)
    odd = _engine(PORT, block_size=8)
    src_mig = M.migration.MigratableWorker(src, chunk_blocks=4)
    src_mig.direct["tiny"] = M.migration.MigratableWorker(tiny)
    src_mig.direct["odd"] = M.migration.MigratableWorker(odd)
    try:
        req = _req(PORT, range(1, 18), max_tokens=64, seed=42)
        control = await _control(PORT, src, req)
        ctx = M.engine.Context(dict(req))
        task = asyncio.create_task(M.engine.collect(await src.generate(ctx)))
        await _wait_for(lambda: (s := src.find_sequence(ctx.id)) is not None
                        and s.num_output_tokens >= 3)
        pace = _Pace(src)
        target = {"worker_id": 9, "import_path": "-", "generate_path": "-"}
        assert not await src_mig.migrate_out(ctx.id, dict(target, address="tiny"))
        assert metrics.rolled_back_total == 1
        seq = src.find_sequence(ctx.id)
        assert seq is not None and not seq.frozen  # unfrozen, still live
        assert not await src_mig.migrate_out(ctx.id, dict(target, address="odd"))
        assert metrics.aborted_total == 1 and metrics.rolled_back_total == 1
        pace.release()
        assert _tokens(await task) == control  # the stream never noticed either try
    finally:
        for e in (src, tiny, odd):
            await e.close()


async def test_remote_drain_via_migrate_is_transfer_bound():
    """Draining a worker through its REMOTE ``migrate_out`` endpoint
    (``request_migrate_out``) finishes while a control run of the same
    sequence on the source is still decoding, with no token dropped or
    repeated."""
    M = P[PORT]
    cfg = dict(num_blocks=256)
    req = _req(PORT, range(1, 22), max_tokens=160, seed=31)
    hub = await M.hub.HubServer().start()
    a = await _spawn_worker(PORT, hub.address, "d", "w", **cfg)
    b = await _spawn_worker(PORT, hub.address, "d", "w", **cfg)
    client_rt = await M.component.DistributedRuntime.connect(hub.address)
    try:
        client = await client_rt.namespace("d").component("w").endpoint("gen").client()
        await client.wait_for_instances(5)
        ctx = M.engine.Context(dict(req))
        items = []
        task = _consume(await client.generate(ctx, worker_id=a.rt.worker_id), items)
        await _wait_for(lambda: len(_tokens(items)) >= 5)
        gate = _CopyGate(a.mig)
        control_task = asyncio.create_task(
            M.engine.collect(await a.engine.generate(M.engine.Context(dict(req)))))
        resp = await M.migration.request_migrate_out(a.info, b.target, request_id=ctx.id)
        assert resp["ok"] and resp["migrated"] == [ctx.id]
        assert not control_task.done(), "the drain was not faster than the sequence"
        assert ctx.id not in a.engine.live_request_ids()
        assert gate.rounds >= 1
        gate.release()
        await task
        control = _tokens(await control_task)
        assert len(control) == 160
        assert _tokens(items) == control
        await client.close()
    finally:
        await _close_worker(a)
        await _close_worker(b)
        await client_rt.close()
        await hub.close()


# ------------------------------------------------ target discovery helpers


@pytest.mark.parametrize("pkg", [PORT, JAX])
async def test_pick_migration_target_filters_and_orders(pkg):
    """Target picking over the port's hub, each package's coordinator:
    self and non-capable instances are skipped, the lowest worker id
    wins, ``exclude`` is honoured, and ``target_from_instance`` refuses
    records without ``metadata.migrate``."""
    M = P[pkg]
    hub = await P[PORT].hub.HubServer().start()
    try:
        client = await P[PORT].component.DistributedRuntime.connect(hub.address)
        try:
            mig = {"import_path": "ns/c/migrate_in", "out_path": "ns/c/migrate_out",
                   "generate_path": "ns/c/gen"}
            for wid, meta in ((5, {"migrate": mig}), (3, {"migrate": mig}), (2, {}),
                              (7, {"migrate": mig})):
                await client.hub.kv_put(f"instances/ns/c/gen/{wid}", {
                    "address": f"127.0.0.1:{9000 + wid}", "path": "ns/c/gen",
                    "worker_id": wid, "metadata": meta})
            t = await M.migration.pick_migration_target(client.hub, "instances/ns/c/", 3)
            assert t["worker_id"] == 5 and t["import_path"] == "ns/c/migrate_in"
            assert t["out_path"] == "ns/c/migrate_out" and t["address"] == "127.0.0.1:9005"
            t = await M.migration.pick_migration_target(
                client.hub, "instances/ns/c/", 3, exclude=frozenset({5}))
            assert t["worker_id"] == 7
            assert await M.migration.pick_migration_target(
                client.hub, "instances/ns/c/", 3, exclude=frozenset({5, 7})) is None
            assert M.migration.target_from_instance({"address": "x", "metadata": {}}) is None
        finally:
            await client.close()
    finally:
        await hub.close()


# ------------------------------------------------ engine-side primitives


async def test_inject_paths_validate_and_roll_back():
    """A truncated payload is refused before any allocation; a scatter
    failure after the allocation frees the blocks it took and leaves the
    sealed prefixes intact; the device-direct import refuses mismatched
    pages without touching the pool."""
    eng = _engine(PORT)
    donor = _engine(PORT)
    try:
        resident = list(range(1, 17))
        await _control(PORT, eng, _req(PORT, resident, max_tokens=2))
        other = list(range(100, 124))
        await _control(PORT, donor, _req(PORT, other, max_tokens=2))
        payload = await donor.export_prompt_blocks(other)
        assert payload is not None
        active_before = eng.kv.active_blocks
        hit_before = eng.estimate_prefix_hit(resident)
        bad = dict(payload, k=payload["k"][:-8])
        assert await eng.inject_blocks(other, bad) == 0
        assert eng.kv.active_blocks == active_before

        real = eng._restore_scatter

        def boom(*a, **k):
            raise RuntimeError("injected scatter failure")

        eng._restore_scatter = boom
        with pytest.raises(RuntimeError, match="injected scatter"):
            await eng.inject_blocks(other, payload)
        assert eng.kv.active_blocks == active_before
        assert eng.estimate_prefix_hit(resident) == hit_before
        eng._restore_scatter = real
        assert await eng.inject_blocks(other, payload) == 24

        tokens = list(range(50, 66))
        shape = tuple(eng.cache.pages.shape)
        wrong_dtype = torch.zeros((shape[0], 4) + shape[2:], dtype=torch.float16)
        assert await eng.inject_blocks_from_device(tokens, wrong_dtype, 4) == 0
        wrong_layers = torch.zeros((shape[0] + 1, 4) + shape[2:], dtype=eng.cache.pages.dtype)
        assert await eng.inject_blocks_from_device(tokens, wrong_layers, 4) == 0
        assert eng.kv.active_blocks == active_before
    finally:
        await eng.close()
        await donor.close()


@pytest.mark.parametrize("pkg", [PORT, JAX])
async def test_penalty_counts_survive_prompt_folding(pkg):
    """Penalty counts cover generated tokens that migration (or
    preemption) folded into the prompt, and not the original prompt."""
    M = P[pkg]
    eng = _engine(pkg)
    try:
        seq = M.scheduler.SequenceState(
            request_id="x", prompt=[1, 2, 3, 9, 9],
            block_seq=M.tokens.TokenBlockSequence(block_size=4),
            freq_penalty=0.5, orig_prompt_len=3,
        )
        seq.output = [7]
        counts = np.asarray(eng._sampling_arrays([seq]).counts)
        assert counts[0, 9] == 2 and counts[0, 7] == 1 and counts[0, 1] == 0
    finally:
        await eng.close()


async def test_spec_state_travels_with_a_migrated_sequence():
    """A speculating sequence's controller state (k, EWMA, bench window,
    retry point, misses) rides the snapshot and is the target's state
    after the resume."""
    M = P[PORT]
    src = _engine(PORT, spec_decode={"enable": True, "k": 4})
    dst = _engine(PORT, spec_decode={"enable": True, "k": 4})
    src_mig = M.migration.MigratableWorker(src, chunk_blocks=4)
    src_mig.direct["dst"] = M.migration.MigratableWorker(dst)
    try:
        prompt = [5, 6, 7, 8] * 6
        ctx = M.engine.Context(_req(PORT, prompt, max_tokens=60, seed=None, temperature=0.0))
        items = []
        task = _consume(await src.generate(ctx), items)
        await _wait_for(lambda: (s := src.find_sequence(ctx.id)) is not None
                        and s.num_output_tokens >= 8)
        pace = _Pace(src)
        seq = src.find_sequence(ctx.id)
        assert await src_mig.migrate_out(ctx.id, {
            "worker_id": 1, "address": "dst", "import_path": "-", "generate_path": "-"})
        pace.release()
        await task
        # The cut-over sequence's controller state, as it froze.
        state = (seq.spec_k, seq.spec_ewma, seq.spec_bench_until, seq.spec_next_try,
                 seq.spec_miss)
        assert state != (-1, 1.0, -1, 0, 0)  # the controller did act on this traffic
        marker = items[-1]["migrated"]
        resume = marker["request"]["annotations"]["resume"]
        assert resume["spec"] == dict(zip(("k", "ewma", "bench_until", "next_try", "miss"),
                                          state))
        pre = M.protocols.PreprocessedRequest.from_dict(marker["request"])
        back = M.scheduler.SequenceState.from_request(ctx.id, pre, dst.cfg)
        assert (back.spec_k, back.spec_ewma, back.spec_bench_until, back.spec_next_try,
                back.spec_miss) == state
        rest = _tokens(await M.engine.collect(await dst.generate(M.engine.Context(
            marker["request"]))))
        control = await _control(PORT, dst, _req(PORT, prompt, max_tokens=60, seed=None,
                                                 temperature=0.0))
        assert _tokens(items) + rest == control
    finally:
        await src.close()
        await dst.close()


# ------------------------------------------------- the CLI's decode role


async def test_stop_decode_drains_live_streams_to_the_peer():
    """Two ``run in=dyn:// out=torch`` workers (the CLI's own code, in this
    process); stopping the one serving two live streams drains both to the
    other through migration: both cut over, and the streams end whole and
    equal to their never-migrated controls."""
    from dynamo_tpu_torch import cli

    M = P[PORT]
    hub = await M.hub.HubServer().start()
    argv = ["run", "in=dyn://dm.TorchWorker.generate", "out=torch", "--hub", hub.address,
            "--model", "tiny", "--arch", "debug-tiny", "--dtype", "float32", "--device", "cpu",
            "--block-size", "4", "--num-blocks", "128", "--max-model-len", "512",
            "--decode-steps", "2"]
    runtimes = []
    tasks = []
    for _ in range(2):
        got = asyncio.get_running_loop().create_future()
        tasks.append(asyncio.create_task(cli._run(cli.parse_args(argv), on_serving=got.set_result)))
        runtimes.append(await asyncio.wait_for(got, 60))
    client_rt = await M.component.DistributedRuntime.connect(hub.address)
    try:
        client = await client_rt.namespace("dm").component("TorchWorker").endpoint(
            "generate").client()
        await client.wait_for_instances(5)
        a_id = runtimes[0].worker_id
        splices0 = M.resilience.metrics.migration_splices_total
        resumes0 = M.resilience.metrics.stream_resumes_total
        completed0 = M.metrics.migration_metrics.completed_total
        reqs = [_req(PORT, range(30 + i, 50 + i), max_tokens=400, seed=90 + i) for i in range(2)]
        streams = [[], []]
        consumers = [_consume(await client.generate(M.engine.Context(dict(r)), worker_id=a_id), s)
                     for r, s in zip(reqs, streams)]
        await _wait_for(lambda: all(len(_tokens(s)) >= 3 for s in streams))
        tasks[0].cancel()  # the worker's shutdown: stop_decode drains via migration
        try:
            await tasks[0]
        except asyncio.CancelledError:
            pass
        await asyncio.gather(*consumers)
        # The CLI workers' own weights (the port's seed-0 init).
        from dynamo_tpu_torch.engine import build_torch_engine

        control_engine = build_torch_engine(cli.parse_args(argv))
        try:
            for r, s in zip(reqs, streams):
                assert _tokens(s) == await _control(PORT, control_engine, r)
                assert s[-1]["finish_reason"] == "length"
        finally:
            await control_engine.close()
        # Both sequences cut over to the peer.  The client splices each
        # stream there on its cutover marker, unless the source's shutdown,
        # which follows the drain at once, cuts the marker off first (the
        # reference's stop order): the stream then resumes there instead.
        assert M.metrics.migration_metrics.completed_total - completed0 == 2
        spliced = M.resilience.metrics.migration_splices_total - splices0
        resumed = M.resilience.metrics.stream_resumes_total - resumes0
        assert spliced >= 1 and spliced + resumed == 2
        await client.close()
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await client_rt.close()
        await hub.close()
