"""KV export and whole-block KV tiers at tp 2 on one node, against the JAX
package's ``TpuEngine(tp=2)`` in one process on two host devices.

The port runs ``tp 2`` as two gloo rank processes on the CPU (this file
run as a script, ``run_ranks`` of ``tests/test_torch_parallel.py``,
``nnodes 1``); the leader serves and the follower replays.  On one node
the leader gathers every rank's heads, so the export and the tiers carry
whole blocks, as one JAX process does (ROADMAP departures):

- a prefix evicted through host, disk and object store restores to the
  same greedy and seeded-sampled streams, with the same restored counts
  per tier, counters, metrics and tier-tagged KV events as JAX's; the
  node's host tier is the leader's alone, within ``host_cache_bytes``;
- the export payload has JAX's keys, shape, dtype and ``n_blocks``, its
  values within 1e-4 of JAX's and 1e-5 of a one-rank port engine's, its
  checksums zlib's over its own bytes;
- the port's tp-2 payload injected into ``TpuEngine`` and JAX's tp-2
  payload into the port's tp-2 engine each stream what a local prefill
  streams;
- an object-store prefix crosses tp 2 -> 1 and 1 -> 2;
- a corrupt disk block at tp 2 is quarantined and recomputed as JAX does;
- a disaggregated pair with a tp-2 prefill worker counts its remote and
  local prefills as JAX's pair does;
- ``AxisGroup.gather`` moves any page dtype's bytes to the group's first
  rank.

The ``nnodes 2`` refusals stay in ``tests/test_torch_multihost.py``.
"""

import asyncio
import os
import shutil
import sys
import zlib

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_parallel import (  # noqa: E402
    RANK_ENV, free_port, rank_main, run_ranks,
)

BS = 4
ENGINE = dict(model="debug-tiny", block_size=BS, num_blocks=16, max_batch=2, max_model_len=64,
              prefill_chunk=32, dtype="float32")
TIERS = dict(host_cache_bytes=64 << 20, host_offload_interval=3600.0,  # drained explicitly
             disk_cache_bytes=64 << 20, object_store_bytes=64 << 20)
PROMPT = list(range(1, 13))  # 3 full blocks
SAMPLED = ([(i * 5 + 2) % 250 + 1 for i in range(13)], {"temperature": 0.8, "seed": 7})
FLOOD = (20, 40, 60, 80, 100, 120)
EXPORTED = [(i * 7 + 3) % 250 + 1 for i in range(22)]  # 5 full blocks and a tail
IMPORTED = [(i * 11 + 1) % 250 + 1 for i in range(17)]  # 4 full blocks and a tail
SCALED = list(range(1, 41))  # 10 full blocks
LONG = [((i * 7) % 250) + 1 for i in range(48)]  # 12 blocks, above the threshold 16
MAX_TOKENS = 4
RANK_TIMEOUT_S = 300
# Four ranks: tp 2 with a replica axis, blocks of 16 so that a restore's
# whole blocks (8 KiB each) outgrow a step frame capped at 64 KiB.  The
# prompt stays below ``sp_prefill_min``: both packages pin an sp pass's
# blocks on the device, so only a chunked prefill reaches the tiers.
MESHES = {"dp2tp2": {"dp": 2, "tp": 2}, "sp2tp2": {"sp": 2, "tp": 2}}
MESH_BS = 16
MESH_ENGINE = dict(ENGINE, block_size=MESH_BS, num_blocks=32, max_model_len=256,
                   prefill_chunk=64)
MESH_PROMPT = [((i * 13) % 250) + 1 for i in range(168)]  # 10 full blocks and a tail


def _request(prompt, sampling=None, max_tokens=MAX_TOKENS):
    return {"token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
            "sampling_options": sampling or {"temperature": 0.0}}


async def _gen(engine, ctx_cls, prompt, sampling=None, max_tokens=MAX_TOKENS):
    out = []
    async for item in await engine.generate(ctx_cls(_request(prompt, sampling, max_tokens))):
        out += item.get("token_ids", [])
    return out


async def _drain(engine):
    while engine._offload_queue:
        await engine.drain_offload()


def _hashes(hash_token_blocks, prompt):
    return [tb.sequence_hash for tb in hash_token_blocks(prompt, BS)]


def _counters(engine):
    out = {"host": {k: getattr(engine.host_kv, k) for k in (
        "stored_blocks", "restored_blocks", "evicted_blocks", "demoted_blocks", "corrupt_blocks")}}
    out["disk"] = {k: getattr(engine.disk_kv, k) for k in (
        "stored_blocks", "promoted_blocks", "evicted_blocks", "rejected_blocks",
        "corrupt_blocks", "demoted_blocks")}
    out["objstore"] = {k: getattr(engine.object_kv, k) for k in (
        "stored_blocks", "fetched_blocks", "evicted_blocks", "rejected_blocks",
        "corrupt_blocks")}
    # Blocks per tier, not bytes: an envelope's JSON header holds the
    # block's CRC in decimal, so sizes may differ by a digit across
    # packages (tests/test_torch_tiers.py).
    summary = engine.kv_tier_summary()
    out["summary"] = {k: v["blocks"] for k, v in summary.items() if k != "prefix_hit_rate"}
    out["matched"] = engine.kv.matched_blocks
    return out


def _metrics(m):
    tier = {k: v for k, v in m.kv_tier_metrics.snapshot().items() if "latency" not in k}
    obj = {k: v for k, v in m.objstore_metrics.snapshot().items() if "bytes" not in k}
    return tier, m.kv_integrity_metrics.snapshot(), obj


def _reset(m):
    m.kv_tier_metrics.reset()
    m.kv_integrity_metrics.reset()
    m.objstore_metrics.reset()


# ------------------------------------------------ scenarios (either package)


async def _chain(engine, ctx_cls, pkg):
    """Greedy and seeded-sampled first passes, the flood that cascades the
    greedy prompt's blocks host -> disk -> object store, both prompts
    again; then an export, an inject and a persist."""
    chain = _hashes(pkg["hash_token_blocks"], PROMPT)
    out = {"first": await _gen(engine, ctx_cls, PROMPT),
           "sampled_first": await _gen(engine, ctx_cls, *SAMPLED)}
    await _drain(engine)
    out["host_after_offload"] = [engine.host_kv.contains(h) for h in chain]
    engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
    engine.disk_kv.capacity_bytes = 2 * engine.block_nbytes() + 1024
    for base in FLOOD:
        out[base] = await _gen(engine, ctx_cls, [base + i for i in range(12)])
        await _drain(engine)
    out["tiers"] = [engine._tier_of(h) for h in chain]
    out["resident"] = [h in engine.kv._by_hash for h in chain]
    out["before"] = _counters(engine)
    out["again"] = await _gen(engine, ctx_cls, PROMPT)
    out["sampled_again"] = await _gen(engine, ctx_cls, *SAMPLED)
    out["after"] = _counters(engine)
    out["host_used"] = engine.host_kv.used_bytes
    out["host_capacity"] = engine.host_kv.capacity_bytes
    out["local_prefix"] = engine.local_prefix_blocks(PROMPT)
    engine.host_kv.capacity_bytes = 64 << 20
    out["metrics"] = _metrics(pkg["metrics"])
    out["chain_events"] = len(pkg["events"])
    await _gen(engine, ctx_cls, EXPORTED)
    out["export"] = await engine.export_prompt_blocks(EXPORTED)
    out["export_tail"] = await engine.export_prompt_blocks(EXPORTED, start_block=2, max_blocks=2)
    if pkg.get("inject") is not None:
        out["covered"] = await engine.inject_blocks(IMPORTED, pkg["inject"])
        hits = engine.kv.matched_blocks
        out["imported"] = await _gen(engine, ctx_cls, IMPORTED)
        out["import_hits"] = engine.kv.matched_blocks - hits
    await _gen(engine, ctx_cls, SCALED)
    await _drain(engine)
    out["persisted"] = await engine.persist_hashes(_hashes(pkg["hash_token_blocks"], SCALED))
    return out


async def _scale_from_zero(engine, ctx_cls, pkg):
    """A fresh engine on an object store another engine wrote."""
    out = {"objects": len(engine.object_kv), "host": len(engine.host_kv),
           "disk": len(engine.disk_kv)}
    out["stream"] = await _gen(engine, ctx_cls, SCALED)
    out["restored"] = engine.host_kv.restored_blocks
    out["matched"] = engine.kv.matched_blocks
    return out


async def _corrupt_disk(engine, ctx_cls, pkg):
    """PROMPT's blocks squeezed onto disk, ``kv_corrupt`` armed on the
    disk plane once, PROMPT again (quarantined, recomputed), then once
    more (the negative cache)."""
    faults = pkg["faults"]
    chain = _hashes(pkg["hash_token_blocks"], PROMPT)
    reported = []
    first = await _gen(engine, ctx_cls, PROMPT)
    await _drain(engine)
    engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
    for base in FLOOD:
        await _gen(engine, ctx_cls, [base + i for i in range(12)])
        await _drain(engine)
    engine.host_kv.capacity_bytes = 64 << 20
    engine.set_integrity_reporter(reported.append)
    engine.kv.evict_hashes(chain)
    tiers = [engine._tier_of(h) for h in chain]
    faults.arm("kv_corrupt", match="disk", count=1)
    try:
        again = await _gen(engine, ctx_cls, PROMPT)
    finally:
        faults.reset()
    banned = [engine.integrity.banned(h) for h in chain]
    await _drain(engine)
    engine.kv.evict_hashes(chain)
    third = await _gen(engine, ctx_cls, PROMPT)
    return dict(first=first, again=again, third=third, tiers=tiers, banned=banned,
                reported=reported, held=[engine._tier_of(h) for h in chain],
                counters=_counters(engine), metrics=_metrics(pkg["metrics"]))


async def _disagg(engine, ctx_cls, pkg):
    """A decode worker (one rank) fed by ``engine`` as the prefill
    worker, over a hub: one long prompt (remote), one short (local)."""
    D = pkg["disagg"]
    hub = await pkg["HubServer"](host="127.0.0.1").start()
    d_engine = pkg["one_rank"]()
    d_rt = p_rt = ploop = None
    try:
        d_rt = await pkg["DistributedRuntime"].connect(hub.address)
        comp = d_rt.namespace("d").component("decode")
        import_ep = comp.endpoint(D.KV_IMPORT_ENDPOINT)
        server = await d_rt.service_server()
        router = D.DisaggregatedRouter(
            "tiny", D.DisaggConfig(max_local_prefill_length=16, max_prefill_queue_size=8))
        worker = D.DisaggDecodeWorker(d_engine, D.PrefillQueue(d_rt.hub, "tiny"), router,
                                      import_address=server.address, import_path=import_ep.path,
                                      transfer_timeout=30.0)
        await import_ep.serve_endpoint(worker.kv_import_handler)
        await comp.endpoint("generate").serve_endpoint(worker)
        p_rt = await pkg["DistributedRuntime"].connect(hub.address)
        ploop = await D.PrefillWorkerLoop(engine, D.PrefillQueue(p_rt.hub, "tiny"),
                                          chunk_blocks=3).start()
        toks = await _gen(worker, ctx_cls, LONG)
        stats = dict(worker.stats())
        matched = d_engine.kv.matched_blocks
        short = await _gen(worker, ctx_cls, [7, 8, 9], max_tokens=2)
        return dict(toks=toks, short=short, remote=stats["remote_prefills"],
                    local=stats["local_prefills"], degraded=stats["degraded_fallbacks"],
                    pending=stats["pending_transfers"], matched=matched, handled=ploop.handled,
                    local_after=worker.stats()["local_prefills"])
    finally:
        if ploop is not None:
            await ploop.stop()
        await d_engine.close()
        for rt in (d_rt, p_rt):
            if rt is not None:
                await rt.close()
        await hub.close()


async def _mesh_tiers(engine, ctx_cls, pkg):
    """MESH_PROMPT served, exported, offloaded, evicted from the device and
    served again from the host tier (10 blocks in one restore)."""
    chain = [tb.sequence_hash for tb in pkg["hash_token_blocks"](MESH_PROMPT, MESH_BS)]
    out = {"first": await _gen(engine, ctx_cls, MESH_PROMPT)}
    out["export"] = await engine.export_prompt_blocks(MESH_PROMPT)
    await _drain(engine)
    engine.kv.evict_hashes(chain)
    out["tiers"] = [engine._tier_of(h) for h in chain]
    out["again"] = await _gen(engine, ctx_cls, MESH_PROMPT)
    out["counters"] = _counters(engine)
    return out


SCENARIOS = {"chain": _chain, "scale": _scale_from_zero, "corrupt": _corrupt_disk,
             "disagg": _disagg}


def _mesh_cfg(root, mesh):
    """The four-rank engine's settings (the JAX engine's too)."""
    return dict(MESH_ENGINE, **TIERS, **mesh, disk_cache_dir=os.path.join(root, "kv"),
                object_store_dir=os.path.join(root, "objects"))


def _scenario_cfg(name, root):
    """The tp-2 engine's settings of a scenario (the JAX engine's too)."""
    if name == "disagg":
        return dict(ENGINE, num_blocks=64, max_model_len=128, prefill_chunk=64)
    cfg = dict(ENGINE, **TIERS, disk_cache_dir=os.path.join(root, name, "kv"),
               object_store_dir=os.path.join(root, name, "objects"))
    if name == "scale":
        cfg.update(max_model_len=128, num_blocks=64,
                   object_store_dir=os.path.join(root, "objects_one_rank"))
    return cfg


# ------------------------------------------------------------ the rank jobs


def _port_pkg(inputs):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm import disagg, metrics
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.faultinject import faults
    from dynamo_tpu_torch.runtime.transports.hub import HubServer
    from dynamo_tpu_torch.tokens import hash_token_blocks

    def one_rank():
        return TorchEngine(EngineConfig(**dict(ENGINE, num_blocks=64, max_model_len=128,
                                               prefill_chunk=64)),
                           params=params_from_jax(inputs["tree"], device="cpu"), device="cpu")

    return dict(hash_token_blocks=hash_token_blocks, metrics=metrics, faults=faults,
                disagg=disagg, HubServer=HubServer, DistributedRuntime=DistributedRuntime,
                one_rank=one_rank, inject=inputs.get("inject"))


def _job_node(state, inputs):
    """Each scenario on a fresh tp-2 engine of both ranks: the leader
    serves it with its own step plane, the follower replays it."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.multihost import StepPublisher, follower_serve
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.runtime.engine import Context

    os.environ["DYN_STEP_TOKEN"] = "tiers-tp-test"
    pkg = _port_pkg(inputs)
    results = {}
    for name, step_port in inputs["scenarios"]:
        _reset(pkg["metrics"])
        events = pkg["events"] = []
        engine = TorchEngine(EngineConfig(**_scenario_cfg(name, inputs["root"]), tp=2),
                             params=params_from_jax(inputs["tree"], device="cpu"), device="cpu",
                             shard=state, event_callback=events.append)

        async def leader():
            engine.attach_publisher(await StepPublisher("127.0.0.1", step_port, 1).start(60))
            try:
                got = await SCENARIOS[name](engine, Context, pkg)
            finally:
                await engine.close()
            got["events"] = [e.to_dict() for e in events]
            return got

        async def follower():
            await follower_serve(engine, f"127.0.0.1:{step_port}", timeout=60)
            got = {"host_kv": engine.host_kv, "disk_kv": engine.disk_kv,
                   "object_kv": engine.object_kv}
            await engine.close()
            return got

        results[name] = asyncio.run(leader() if state.is_leader else follower())
    return results


def _job_mesh(state, inputs):
    """``_mesh_tiers`` on four ranks with every step frame capped at 64 KiB
    (a two-byte length): the leader serves, three ranks replay, and each
    returns its pages."""
    import struct

    from dynamo_tpu_torch.engine import multihost
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.multihost import StepPublisher, follower_serve
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.runtime.engine import Context

    multihost._LEN = struct.Struct(">H")
    os.environ["DYN_STEP_TOKEN"] = "tiers-tp-test"
    pkg = _port_pkg(inputs)
    engine = TorchEngine(EngineConfig(**_mesh_cfg(inputs["root"], inputs["mesh"])),
                         params=params_from_jax(inputs["tree"], device="cpu"), device="cpu",
                         shard=state)
    port = inputs["step_port"]

    async def leader():
        engine.attach_publisher(await StepPublisher("127.0.0.1", port, state.size - 1).start(60))
        try:
            got = await _mesh_tiers(engine, Context, pkg)
            chain = [tb.sequence_hash for tb in pkg["hash_token_blocks"](MESH_PROMPT, MESH_BS)]
            got["ids"] = [engine.kv._by_hash.get(h) for h in chain]
            got["parts"] = [p for kind, _, p in engine.transfer_parts if kind == "restore"]
            got["pages"] = engine.cache.pages.numpy().copy()
        finally:
            await engine.close()
        return got

    async def follower():
        await follower_serve(engine, f"127.0.0.1:{port}", timeout=60)
        got = {"pages": engine.cache.pages.numpy().copy()}
        await engine.close()
        return got

    return asyncio.run(leader() if state.is_leader else follower())


def _job_gather(state, inputs):
    """``AxisGroup.gather`` of each rank's slice, off the last axis and on
    it, in f32, bf16 and fp8: the bytes of every rank in group order."""
    import torch

    out = {}
    for name in ("float32", "bfloat16", "float8_e4m3fn"):
        dt = getattr(torch, name)
        base = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4) + 100 * state.rank
        t = base.to(dt)
        for dim in (1, 2):
            got = state.tp.gather(t, dim)
            out[(name, dim)] = None if got is None else got.view(torch.uint8).numpy()
        # The first rank's parts, one a rank, each landing on its rank.
        parts = None
        if state.tp.index == 0:
            parts = [(torch.arange(12, dtype=torch.float32).reshape(3, 4) - 50 * r).to(dt)
                     for r in range(state.tp.size)]
        mine = state.tp.scatter(torch.empty((3, 4), dtype=dt), parts)
        out[(name, "scatter")] = mine.view(torch.uint8).numpy()
    return out


JOBS = {"node": _job_node, "mesh": _job_mesh, "gather": _job_gather}


if __name__ == "__main__":
    rank_main(JOBS)
    sys.exit(0)


if not os.environ.get(RANK_ENV):
    import importlib

    import jax
    import ml_dtypes
    import torch

    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.models.config import get_config as jax_get_config
    from dynamo_tpu.models.llama import init_params as jax_init_params
    from dynamo_tpu.runtime.engine import Context as JaxContext
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.integrity import payload_block_checksums
    from dynamo_tpu_torch.llm import metrics as torch_metrics
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.runtime.engine import Context

pytestmark = pytest.mark.torch_port


def _jax_pkg(params, inject=None):
    def one_rank():
        return TpuEngine(JaxEngineConfig(**dict(ENGINE, num_blocks=64, max_model_len=128,
                                                prefill_chunk=64)), params=params)

    pkg = {sub: importlib.import_module(f"dynamo_tpu.{sub}") for sub in (
        "llm.disagg", "llm.metrics", "runtime.component", "runtime.faultinject",
        "runtime.transports.hub", "tokens")}
    return dict(hash_token_blocks=pkg["tokens"].hash_token_blocks, metrics=pkg["llm.metrics"],
                faults=pkg["runtime.faultinject"].faults, disagg=pkg["llm.disagg"],
                HubServer=pkg["runtime.transports.hub"].HubServer,
                DistributedRuntime=pkg["runtime.component"].DistributedRuntime,
                one_rank=one_rank, inject=inject)


def _port_one_rank(tree, **over):
    return TorchEngine(EngineConfig(**dict(ENGINE, **over)),
                       params=params_from_jax(tree, device="cpu"), device="cpu")


async def _jax_scenario(name, params, root, inject=None):
    pkg = _jax_pkg(params, inject)
    _reset(pkg["metrics"])
    events = pkg["events"] = []
    engine = TpuEngine(JaxEngineConfig(**_scenario_cfg(name, root), tp=2), params=params,
                       event_callback=events.append)
    try:
        got = await SCENARIOS[name](engine, JaxContext, pkg)
    finally:
        await engine.close()
    got["events"] = [e.to_dict() for e in events]
    return got


def _payload_arrays(p):
    """A payload's K and V as float32 arrays of its shape."""
    dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[p["dtype"]]
    return [np.frombuffer(p[x], dtype=dt).reshape(p["shape"]).astype(np.float32)
            for x in ("k", "v")]


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    """The JAX tp-2 engine's and the port's tp-2 ranks' run of every
    scenario, plus the one-rank references."""
    tmp = tmp_path_factory.mktemp("tiers_tp")
    params = jax_init_params(jax_get_config("debug-tiny").with_overrides(dtype="float32"),
                             jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    jroot, proot = str(tmp / "jax"), str(tmp / "port")

    async def references():
        # A one-rank port engine writes the object store the tp-2 engines
        # start from (tp 1 -> 2), and makes the one-rank export.
        one = _port_one_rank(tree, **TIERS, max_model_len=128, num_blocks=64,
                             disk_cache_dir=str(tmp / "one" / "kv"),
                             object_store_dir=os.path.join(proot, "objects_one_rank"))
        ref = {"first": await _gen(one, Context, SCALED)}
        await _drain(one)
        ref["persisted"] = await one.persist_hashes(
            _hashes(importlib.import_module("dynamo_tpu_torch.tokens").hash_token_blocks, SCALED))
        await _gen(one, Context, EXPORTED)
        ref["export"] = await one.export_prompt_blocks(EXPORTED)
        ref["local_imported"] = await _gen(one, Context, IMPORTED)
        ref["local_long"] = await _gen(one, Context, LONG)
        await one.close()
        # JAX's tp-2 payload of IMPORTED, for the port's tp-2 engine.
        jd = TpuEngine(JaxEngineConfig(**ENGINE, tp=2), params=params)
        await _gen(jd, JaxContext, IMPORTED)
        ref["jax_inject"] = await jd.export_prompt_blocks(IMPORTED)
        await jd.close()
        return ref

    ref = asyncio.run(references())
    shutil.copytree(os.path.join(proot, "objects_one_rank"),
                    os.path.join(jroot, "objects_one_rank"))
    # Both packages' tp-2 engines import JAX's tp-2 payload in the chain.
    want = {name: asyncio.run(_jax_scenario(name, params, jroot, inject=ref["jax_inject"]))
            for name in ("chain", "scale", "corrupt", "disagg")}
    names = ["chain", "scale", "corrupt", "disagg"]
    outs = run_ranks(__file__, "node", 2,
                     {"mesh": {"tp": 2}, "tree": tree, "root": proot,
                      "inject": ref["jax_inject"],
                      "scenarios": [(n, free_port()) for n in names]},
                     tmp, timeout=RANK_TIMEOUT_S)
    return dict(want=want, got=outs[0], follower=outs[1], ref=ref, params=params, tree=tree,
                proot=proot, tmp=tmp)


def test_streams_match_jax_tp2_through_every_tier(node):
    got, want = node["got"]["chain"], node["want"]["chain"]
    assert want["tiers"] == ["objstore"] * 3 and want["resident"] == [False] * 3
    for key in ("first", "sampled_first", "again", "sampled_again", *FLOOD):
        assert got[key] == want[key], key
    assert got["again"] == got["first"] and got["sampled_again"] == got["sampled_first"]


def test_restored_counts_and_transitions_match_jax_tp2(node):
    got, want = node["got"]["chain"], node["want"]["chain"]
    for key in ("host_after_offload", "tiers", "resident", "before", "after", "local_prefix"):
        assert got[key] == want[key], key
    # Both prompts' 3 blocks each came back from the tiers.
    assert got["after"]["host"]["restored_blocks"] == 6
    assert got["metrics"] == want["metrics"]
    assert got["metrics"][0]["restored_blocks_total"] == 6
    # The chain's KV events in order.  After it, an import allocates its
    # blocks unpadded where the JAX engine pads to a power of two (ROADMAP
    # departures), which moves one tier event at one rank too.
    n = got["chain_events"]
    assert n == want["chain_events"] and got["events"][:n] == want["events"][:n]
    assert len(got["events"]) == len(want["events"])


def test_node_host_tier_is_the_leaders_within_budget(node):
    got = node["got"]["chain"]
    assert 0 < got["host_used"] <= got["host_capacity"]
    assert got["host_used"] == node["want"]["chain"]["host_used"]
    for name in ("chain", "scale", "corrupt"):
        fol = node["follower"][name]
        assert fol["host_kv"] is None and fol["disk_kv"] is None and fol["object_kv"] is None


def test_export_payload_matches_jax_tp2_and_one_rank(node):
    got, want = node["got"]["chain"]["export"], node["want"]["chain"]["export"]
    one = node["ref"]["export"]
    assert got is not None and set(got) == set(want) == set(one)
    for key in ("n_blocks", "start_block", "block_size", "dtype", "shape", "kv_scale"):
        assert got[key] == want[key] == one[key], key
    assert got["n_blocks"] == 5 and got["shape"][3] == 2  # every KV head of debug-tiny
    for a, b, c in zip(_payload_arrays(got), _payload_arrays(want), _payload_arrays(one)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)
    k, v = (np.frombuffer(got[x], np.uint8).reshape(*got["shape"][:-1], -1) for x in "kv")
    assert got["checksums"] == payload_block_checksums(k, v)
    # Block 0's checksum chains K then V over its bytes, zlib's integer.
    crc = zlib.crc32(np.ascontiguousarray(k[:, 0]).tobytes())
    assert got["checksums"][0] == zlib.crc32(np.ascontiguousarray(v[:, 0]).tobytes(), crc)
    tail = node["got"]["chain"]["export_tail"]
    assert tail["n_blocks"] == 2 and tail["start_block"] == 2
    assert tail["checksums"] == got["checksums"][2:4]


def test_tp2_payloads_cross_packages(node):
    """The port's tp-2 payload into ``TpuEngine``, JAX's tp-2 payload into
    the port's tp-2 engine: each stream a local prefill's."""
    got = node["got"]["chain"]
    assert got["covered"] == 16 and got["import_hits"] >= 4
    assert got["imported"] == node["ref"]["local_imported"]
    port_payload = got["export"]

    async def into_jax():
        e = TpuEngine(JaxEngineConfig(**ENGINE), params=node["params"])
        try:
            covered = await e.inject_blocks(EXPORTED, port_payload)
            hits = e.kv.matched_blocks
            toks = await _gen(e, JaxContext, EXPORTED)
            return covered, e.kv.matched_blocks - hits, toks
        finally:
            await e.close()

    async def local():
        e = TpuEngine(JaxEngineConfig(**ENGINE), params=node["params"])
        try:
            return await _gen(e, JaxContext, EXPORTED)
        finally:
            await e.close()

    covered, hits, toks = asyncio.run(into_jax())
    assert covered == 20 and hits >= 5
    assert toks == asyncio.run(local())


@pytest.mark.parametrize("way", ["tp2-to-tp1", "tp1-to-tp2"])
def test_object_store_prefix_crosses_tp(node, way):
    if way == "tp1-to-tp2":
        got, want = node["got"]["scale"], node["want"]["scale"]
        assert got["objects"] == node["ref"]["persisted"] == 10
        assert got["host"] == 0 and got["disk"] == 0
        assert got["stream"] == node["ref"]["first"]
        assert got["restored"] >= 9 and got["matched"] >= 9
        assert got == {k: want[k] for k in got}
        return
    # PROMPT's 3 blocks begin SCALED's chain and are objects already.
    assert node["got"]["chain"]["persisted"] == node["want"]["chain"]["persisted"] == 7

    async def fresh():
        e = _port_one_rank(node["tree"], **TIERS, max_model_len=128, num_blocks=64,
                           disk_cache_dir=str(node["tmp"] / "fresh" / "kv"),
                           object_store_dir=os.path.join(node["proot"], "chain", "objects"))
        try:
            return await _scale_from_zero(e, Context, {})
        finally:
            await e.close()

    got = asyncio.run(fresh())
    assert got["objects"] >= 10 and got["host"] == 0
    assert got["stream"] == node["ref"]["first"]
    assert got["restored"] >= 9 and got["matched"] >= 9


def test_corrupt_disk_block_at_tp2_quarantined_like_jax(node):
    got, want = node["got"]["corrupt"], node["want"]["corrupt"]
    assert {k: v for k, v in got.items() if k != "events"} == {
        k: v for k, v in want.items() if k != "events"}
    assert got["again"] == got["third"] == got["first"]
    assert got["tiers"][0] == "disk" and got["banned"][0] and got["reported"] == ["disk"]
    integrity = got["metrics"][1]
    assert integrity["corrupt_disk_total"] == 1 and integrity["recomputed_total"] == 1
    assert got["events"] == want["events"]


def test_disagg_pair_with_a_tp2_prefill_worker_counts_like_jax(node):
    got, want = node["got"]["disagg"], node["want"]["disagg"]
    assert got["remote"] == 1 and got["local"] == 0 and got["degraded"] == 0
    assert got["handled"] == 1 and got["matched"] >= 10
    assert got["toks"] == node["ref"]["local_long"]
    for key in ("toks", "short", "remote", "local", "degraded", "pending", "handled",
                "local_after"):
        assert got[key] == want[key], key


def test_gather_moves_every_page_dtypes_bytes_to_the_first_rank(tmp_path):
    """``gather`` to the first rank and ``scatter`` from it, in bytes."""
    outs = run_ranks(__file__, "gather", 2, {"mesh": {"tp": 2}}, tmp_path)
    for (name, dim), got in outs[0].items():
        dt = getattr(torch, name)
        if dim == "scatter":
            for r in range(2):
                want = (torch.arange(12, dtype=torch.float32).reshape(3, 4) - 50 * r).to(dt)
                np.testing.assert_array_equal(outs[r][(name, dim)],
                                              want.view(torch.uint8).numpy())
            continue
        parts = [(torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + 100 * r).to(dt)
                 for r in range(2)]
        want = torch.cat(parts, dim=dim).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)
        assert outs[1][(name, dim)] is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_replica_ranks_take_their_heads_of_a_restore(mesh, tmp_path):
    """tp 2 with a replica axis (dp 2 or sp 2) on four ranks against JAX
    ``TpuEngine`` at the same mesh: the same streams, tier and counters,
    the export payload within 1e-4; a restore of 10 whole blocks (80 KiB,
    past the 64 KiB frame the ranks are held to) leaves every rank's pages
    its ``tp`` index's heads of the payload, bitwise."""
    params = jax_init_params(jax_get_config("debug-tiny").with_overrides(dtype="float32"),
                             jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)

    async def jax_side():
        pkg = _jax_pkg(params)
        engine = TpuEngine(JaxEngineConfig(**_mesh_cfg(str(tmp_path / "jax"), MESHES[mesh])),
                           params=params)
        try:
            return await _mesh_tiers(engine, JaxContext, pkg)
        finally:
            await engine.close()

    want = asyncio.run(jax_side())
    outs = run_ranks(__file__, "mesh", 4, {"mesh": MESHES[mesh], "tree": tree,
                                           "root": str(tmp_path / "port"),
                                           "step_port": free_port()}, tmp_path)
    got = outs[0]
    assert want["tiers"] == ["host"] * 10
    for key in ("first", "again", "tiers", "counters"):
        assert got[key] == want[key], key
    assert got["again"] == got["first"] and got["counters"]["host"]["restored_blocks"] == 10
    assert len(got["parts"]) == 1  # one restore of all 10 blocks
    pay, jpay = got["export"], want["export"]
    for key in ("n_blocks", "dtype", "shape"):
        assert pay[key] == jpay[key], key
    k, v = _payload_arrays(pay)
    for a, b in zip((k, v), _payload_arrays(jpay)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    kvl = k.shape[3] // 2
    for rank, o in enumerate(outs):
        t = rank % 2  # tp is the mesh's last axis
        for j, bid in enumerate(got["ids"]):
            page = o["pages"][:, bid]  # [L, ps, 2 * kvl, hd]: K even, V odd
            np.testing.assert_array_equal(page[:, :, 0::2], k[:, j, :, t * kvl:(t + 1) * kvl])
            np.testing.assert_array_equal(page[:, :, 1::2], v[:, j, :, t * kvl:(t + 1) * kvl])
