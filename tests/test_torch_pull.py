"""The cross-worker prefix pull and the prefetch plane on the port against
the JAX package.

Mirrors of ``tests/test_kv_tiering.py``'s pull and prefetch cases on
``TorchEngine``:

- a pulled prefix serves a stream identical to a recomputed one, the
  pulled pages bitwise equal to the donor's, counted on the pull metrics;
- the ``kv_export`` handler restores blocks the donor demoted to its tiers
  before exporting them;
- a failed pull (peer unreachable) prefills locally with the same stream;
- the byte budget and the local depth bound the pull;
- the push router stamps ``kv_pull`` when a peer holds a strictly deeper
  prefix than the winner, and not otherwise (on each package's router);
- the router core's ``KvPrefetchPublisher`` and a worker's
  ``KvPrefetchConsumer`` over the port's hub promote a disk chain to the
  host tier, and ``warm_hot_chains`` pushes at once;
- across packages, over the port's hub and service plane: a port puller
  against a JAX donor's ``kv_export`` and the reverse pull pages bitwise
  equal to the donor's and stream like a recomputed prefix; a dead donor
  degrades to local prefill.

Engines run debug-tiny in f32 at block size 4 on the same seeded weights.
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

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"


def _pkg(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, config=m("engine.config"), engine_mod=m("engine.engine"),
        pull=m("llm.kv_router.pull"), router=m("llm.kv_router.router"),
        indexer=m("llm.kv_router.indexer"), metrics=m("llm.metrics"),
        protocols=m("llm.protocols"), component=m("runtime.component"),
        hub=m("runtime.transports.hub"), engine=m("runtime.engine"), tokens=m("tokens"),
    )


P = {JAX: _pkg(JAX), PORT: _pkg(PORT)}
BS = 4
PROMPT = list(range(1, 13))  # 3 full blocks
_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS["jax"] = jax_init_params(
            jax_get_config("debug-tiny").with_overrides(dtype="float32"), jax.random.PRNGKey(0))
        _PARAMS["np"] = jax.tree_util.tree_map(np.asarray, _PARAMS["jax"])
    return _PARAMS


def _cfg(tmp_path=None, **over):
    cfg = dict(model="debug-tiny", block_size=BS, num_blocks=16, max_batch=2, max_model_len=64,
               prefill_chunk=32, dtype="float32", host_cache_bytes=0)
    if tmp_path is not None:
        cfg.update(host_cache_bytes=64 << 20, host_offload_interval=3600,
                   disk_cache_bytes=64 << 20, disk_cache_dir=str(tmp_path / "kv"))
    cfg.update(over)
    return cfg


def _engine(pkg, tmp_path=None, **over):
    cfg = P[pkg].config.EngineConfig(**_cfg(tmp_path, **over))
    if pkg == JAX:
        return P[JAX].engine_mod.TpuEngine(cfg, params=_params()["jax"])
    return P[PORT].engine_mod.TorchEngine(
        cfg, params=params_from_jax(_params()["np"], device="cpu"), device="cpu")


async def _generate(pkg, engine, tokens, max_tokens=4, seed=None, temperature=0.0,
                    annotations=None):
    M = P[pkg]
    req = M.protocols.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=M.protocols.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=M.protocols.SamplingOptions(temperature=temperature, seed=seed),
        annotations=dict(annotations or {}),
    ).to_dict()
    out = await M.engine.collect(await engine.generate(M.engine.Context(req)))
    return [t for item in out for t in item["token_ids"]]


def _pages_of(engine, tokens):
    """The raw bytes of the pages holding ``tokens``' sealed blocks."""
    blocks = P[PORT].tokens.hash_token_blocks(tokens, BS)
    ids = [engine.kv._by_hash[tb.sequence_hash] for tb in blocks]
    if isinstance(engine.cache.pages, torch.Tensor):
        return raw_bytes(engine.cache.pages[:, ids]).tobytes()
    return np.ascontiguousarray(np.asarray(engine.cache.pages)[:, ids]).tobytes()


def _puller_for(pkg, engine, donor, max_bytes=None, fail=False):
    async def exporter(worker_id, data):
        if fail:
            raise RuntimeError("peer unreachable")
        return await donor.export_prompt_blocks(
            data["token_ids"], start_block=data.get("start_block", 0),
            max_blocks=data.get("max_blocks", 0), salt=data.get("salt"))

    return P[pkg].pull.PrefixPuller(engine, exporter, max_bytes=max_bytes)


async def _drain_offload(engine):
    while engine._offload_queue:
        await engine.drain_offload()


async def _flood(engine, bases, length=12):
    """Push earlier prompts' blocks out of the device pool (and, with a
    small host budget, down the tiers) by serving fresh prompts."""
    for base in bases:
        await _generate(PORT, engine, [base + i for i in range(length)])
        await _drain_offload(engine)


# ------------------------------------------------------------ on the port


async def test_pull_serves_uncomputed_prefix_byte_identically():
    kv_tier = P[PORT].metrics.kv_tier_metrics
    donor, target, control = _engine(PORT), _engine(PORT), _engine(PORT)
    try:
        await _generate(PORT, donor, PROMPT, max_tokens=1)
        donor_blocks = donor.estimate_prefix_hit(PROMPT) // BS
        assert donor_blocks == 3
        target.set_prefix_puller(_puller_for(PORT, target, donor))
        started0, done0 = kv_tier.pulls_started_total, kv_tier.pulls_completed_total
        blocks0 = kv_tier.pulled_blocks_total
        pulled = await _generate(PORT, target, PROMPT, seed=11, temperature=0.9,
                                 annotations={"kv_pull": {"worker_id": 0, "blocks": donor_blocks}})
        want = await _generate(PORT, control, PROMPT, seed=11, temperature=0.9)
        assert pulled == want
        assert (kv_tier.pulls_started_total, kv_tier.pulls_completed_total) == (
            started0 + 1, done0 + 1)
        assert kv_tier.pulled_blocks_total == blocks0 + 3
        assert target.kv.matched_blocks >= donor_blocks
        # The admission recomputes the prompt's last position (its logits),
        # rewriting the last block's last row: the blocks before it stay the
        # donor's, bit for bit.
        assert _pages_of(target, PROMPT[:8]) == _pages_of(donor, PROMPT[:8])
    finally:
        for e in (donor, target, control):
            await e.close()


async def test_pull_serves_donor_demoted_blocks(tmp_path):
    """The export handler restores a demoted run from the donor's own tiers
    before exporting (``export_prompt_blocks`` reads the device pool
    only)."""
    M = P[PORT]
    donor = _engine(PORT, tmp_path)
    target, control = _engine(PORT), _engine(PORT)
    try:
        await _generate(PORT, donor, PROMPT, max_tokens=1)
        await _drain_offload(donor)
        donor.host_kv.capacity_bytes = 2 * donor.block_nbytes()
        await _flood(donor, (20, 40, 60, 80, 100, 120))
        blocks = M.tokens.hash_token_blocks(PROMPT, BS)
        assert len(donor.kv.match_prefix(blocks)) < 3, "needs demotion"
        handler = M.pull.make_kv_export_handler(donor)

        async def exporter(worker_id, data):
            async for item in handler(M.engine.Context(dict(data))):
                return (item or {}).get("payload")

        target.set_prefix_puller(M.pull.PrefixPuller(target, exporter))
        pulled = await _generate(PORT, target, PROMPT, seed=21, temperature=0.9,
                                 annotations={"kv_pull": {"worker_id": 0, "blocks": 3}})
        assert pulled == await _generate(PORT, control, PROMPT, seed=21, temperature=0.9)
        assert target.kv.matched_blocks >= 3, "the pull served no blocks"
    finally:
        for e in (donor, target, control):
            await e.close()


async def test_pull_failure_falls_back_to_local_prefill():
    kv_tier = P[PORT].metrics.kv_tier_metrics
    donor, target, control = _engine(PORT), _engine(PORT), _engine(PORT)
    try:
        target.set_prefix_puller(_puller_for(PORT, target, donor, fail=True))
        failed0 = kv_tier.pulls_failed_total
        got = await _generate(PORT, target, PROMPT, seed=5, temperature=0.9,
                              annotations={"kv_pull": {"worker_id": 0, "blocks": 3}})
        assert got == await _generate(PORT, control, PROMPT, seed=5, temperature=0.9)
        assert kv_tier.pulls_failed_total == failed0 + 1
        assert target.kv.matched_blocks == 0
    finally:
        for e in (donor, target, control):
            await e.close()


@pytest.mark.parametrize("pkg", [PORT, JAX])
async def test_pull_respects_byte_budget_and_local_depth(pkg):
    donor, target = _engine(pkg), _engine(pkg)
    try:
        await _generate(pkg, donor, PROMPT, max_tokens=1)
        hint = {"worker_id": 0, "blocks": 3}
        # A budget below one block: nothing moves.
        assert await _puller_for(pkg, target, donor, max_bytes=8).pull(PROMPT, None, hint) == 0
        # A budget of two blocks moves two of three.
        two = _puller_for(pkg, target, donor, max_bytes=2 * target.block_nbytes())
        assert await two.pull(PROMPT, None, hint) == 2 * BS
        assert target.local_prefix_blocks(PROMPT) == 2
        # A peer no deeper than the local tiers: nothing moves.
        await _generate(pkg, target, PROMPT, max_tokens=1)
        local = target.local_prefix_blocks(PROMPT)
        assert await _puller_for(pkg, target, donor).pull(
            PROMPT, None, {"worker_id": 0, "blocks": local}) == 0
        # A malformed hint is ignored.
        assert await _puller_for(pkg, target, donor).pull(PROMPT, None, {"blocks": 9}) == 0
    finally:
        await donor.close()
        await target.close()


@pytest.mark.parametrize("pkg", [PORT, JAX])
async def test_push_router_stamps_kv_pull_hint(pkg):
    M = P[pkg]

    class _Client:
        def __init__(self):
            self.calls = []

        async def generate(self, request, worker_id=None):
            self.calls.append((request.data, worker_id))
            return "stream"

    class _Core:
        def __init__(self, winner, overlap):
            self.client = _Client()
            self._ret = (winner, overlap)

        def select_with_scores(self, token_ids, salt=None):
            return self._ret

    overlap = M.indexer.OverlapScores({3: 1, 7: 4}, {3: 1.0, 7: 4 * 0.45})
    core = _Core(3, overlap)  # the donor (7) is deeper than the winner (3)
    await M.router.KvPushRouter(core).generate(
        M.engine.Context({"token_ids": list(range(8)), "annotations": {"tenant": "t"}}))
    data, wid = core.client.calls[0]
    assert wid == 3
    assert data["annotations"] == {"tenant": "t", "kv_pull": {"worker_id": 7, "blocks": 4}}
    core2 = _Core(7, overlap)  # the winner is already the deepest: no hint
    await M.router.KvPushRouter(core2).generate(M.engine.Context({"token_ids": list(range(8))}))
    assert "kv_pull" not in (core2.client.calls[0][0].get("annotations") or {})
    core3 = _Core(None, overlap)  # no winner: the client's own routing, no hint
    await M.router.KvPushRouter(core3).generate(M.engine.Context({"token_ids": [1]}))
    assert core3.client.calls[0][1] is None


async def test_prefetch_plane_promotes_disk_chains_to_host(tmp_path):
    """The router core's publisher pushes its hottest routed chains on
    ``kv_prefetch``; a worker's consumer promotes them disk → host
    (``prefetch_hashes``), counted in ``prefetched_blocks_total``."""
    M = P[PORT]
    kv_tier = M.metrics.kv_tier_metrics
    engine = _engine(PORT, tmp_path)
    hub = await M.hub.HubServer().start()
    rt = await M.component.DistributedRuntime.connect(hub.address)
    consumer = None
    try:
        await _generate(PORT, engine, PROMPT)
        await _drain_offload(engine)
        engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
        await _flood(engine, (20, 40, 60, 80, 100, 120))
        chain = [tb.sequence_hash for tb in M.tokens.hash_token_blocks(PROMPT, BS)
                 if engine.disk_kv.contains(tb.sequence_hash)]
        assert chain, "the test needs demoted blocks"
        assert not any(engine.host_kv.contains(h) for h in chain)
        engine.host_kv.capacity_bytes = 64 << 20  # room again
        component = rt.namespace("p").component("w")
        consumer = await M.pull.KvPrefetchConsumer(component, engine).start()

        class _Hot:
            def top(self, n):
                return [chain]

        core = SimpleNamespace(hot_chains=_Hot(), component=component, _prefetch_pub=None)
        pub = M.pull.KvPrefetchPublisher(core, interval=3600)
        core._prefetch_pub = pub
        pre0 = kv_tier.prefetched_blocks_total
        await M.router.KvRouterCore.warm_hot_chains(core)  # one push, out of band
        for _ in range(500):
            if all(engine.host_kv.contains(h) for h in chain):
                break
            await asyncio.sleep(0.01)
        assert all(engine.host_kv.contains(h) for h in chain)
        assert kv_tier.prefetched_blocks_total == pre0 + len(chain)
        await pub.stop()
    finally:
        if consumer is not None:
            await consumer.stop()
        await engine.close()
        await rt.close()
        await hub.close()


# ------------------------------------------------------- across packages


async def _export_worker(pkg, hub_address, engine):
    """``engine`` serving its sealed blocks at ``kv_export`` on ``pkg``'s
    service plane, as the CLI's decode role registers it."""
    M = P[pkg]
    rt = await M.component.DistributedRuntime.connect(hub_address)
    ep = rt.namespace("x").component("w").endpoint(M.pull.KV_EXPORT_ENDPOINT)
    await ep.serve_endpoint(M.pull.make_kv_export_handler(engine))
    return rt


@pytest.mark.parametrize("donor_pkg,puller_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-donor-port-puller", "port-donor-jax-puller"])
async def test_pull_across_packages(donor_pkg, puller_pkg):
    """A puller of one package against the other's ``kv_export`` over the
    port's hub: the pulled pages are bitwise the donor's, the stream equals
    a recomputed one; after the donor's worker is gone, a pull degrades to
    local prefill with the same stream."""
    hub = await P[PORT].hub.HubServer().start()
    donor = _engine(donor_pkg)
    target, control = _engine(puller_pkg), _engine(puller_pkg)
    donor_rt = await _export_worker(donor_pkg, hub.address, donor)
    donor_up = True
    C = P[puller_pkg]
    client_rt = await C.component.DistributedRuntime.connect(hub.address)
    try:
        client = await client_rt.namespace("x").component("w").endpoint(
            C.pull.KV_EXPORT_ENDPOINT).client()
        await client.wait_for_instances(5)
        puller = C.pull.PrefixPuller(target, C.pull.make_client_exporter(client))
        target.set_prefix_puller(puller)
        prompt = list(range(30, 54))  # 6 full blocks
        await _generate(donor_pkg, donor, prompt, max_tokens=1)
        hint = {"worker_id": donor_rt.worker_id, "blocks": 6}
        # The pull alone first: the pulled pages are the donor's, bit for
        # bit (the admission below recomputes the last position).
        assert await puller.pull(prompt, None, hint) == 6 * BS
        assert _pages_of(target, prompt) == _pages_of(donor, prompt)
        got = await _generate(puller_pkg, target, prompt, seed=3, temperature=0.8,
                              annotations={"kv_pull": hint})
        assert got == await _generate(puller_pkg, control, prompt, seed=3, temperature=0.8)
        assert target.kv.matched_blocks >= 6
        # The donor's worker dies: the next pull fails and prefills locally.
        await donor_rt.close()
        donor_up = False
        other = list(range(60, 76))
        await _generate(donor_pkg, donor, other, max_tokens=1)
        failed0 = C.metrics.kv_tier_metrics.pulls_failed_total
        got = await _generate(puller_pkg, target, other, seed=4, temperature=0.8,
                              annotations={"kv_pull": {"worker_id": hint["worker_id"],
                                                       "blocks": 4}})
        assert got == await _generate(puller_pkg, control, other, seed=4, temperature=0.8)
        assert C.metrics.kv_tier_metrics.pulls_failed_total == failed0 + 1
        await client.close()
    finally:
        for e in (donor, target, control):
            await e.close()
        if donor_up:
            await donor_rt.close()
        await client_rt.close()
        await hub.close()
