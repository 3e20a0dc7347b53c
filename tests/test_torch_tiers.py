"""The port's KV memory tiers against the JAX package's, on the same inputs.

- The stores: the same sequence of operations on ``HostKvStore``,
  ``DiskKvStore`` and ``ObjectKvStore`` of both packages, f32 and bf16
  blocks made from a seed with numpy: equal transitions, LRU order, used
  bytes, checksums and counters; the disk and object files byte-identical,
  each package reading the other's; corrupt files quarantined alike.
- The engine: ``TorchEngine`` against ``TpuEngine`` on debug-tiny in f32
  with a pool small enough to evict (the JAX engine on its XLA attention
  path, the port on the plain versions of its kernels): an evicted prefix
  restored through host, disk and object store with identical greedy
  streams, counters, tier-tagged KV events and metrics; a scale-from-zero
  start, also from an object store the JAX engine wrote; the ``kv_corrupt``
  fault on each plane quarantined and recomputed alike.
- Mirrors of the JAX package's tier tests, the ``/metrics`` groups over
  both HTTP edges, the CLI's tier flags, and the int8 scale calibration a
  warm start from the object store relies on.

Byte-level results are held exactly, logits through the streams (greedy).
"""

import asyncio
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.disk_cache import DiskKvStore as JaxDiskKvStore
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.host_cache import HostKvStore as JaxHostKvStore
from dynamo_tpu.engine.integrity import block_checksum as jax_block_checksum
from dynamo_tpu.engine.object_store import ObjectKvStore as JaxObjectKvStore
from dynamo_tpu.llm import metrics as jax_metrics
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.faultinject import faults as jax_faults
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.disk_cache import DiskKvStore
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.host_cache import HostKvStore
from dynamo_tpu_torch.engine.integrity import block_checksum, raw_bytes
from dynamo_tpu_torch.engine.object_store import ObjectKvStore
from dynamo_tpu_torch.llm import metrics as torch_metrics
from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheTierData
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context, collect
from dynamo_tpu_torch.runtime.faultinject import faults
from dynamo_tpu_torch.tokens import hash_token_blocks

pytestmark = pytest.mark.torch_port

BS = 4
PROMPT = list(range(1, 13))  # 3 full blocks
FLOOD = (20, 40, 60, 80, 100, 120)


# ------------------------------------------------------------------ stores

SHAPE = (2, 4, 4, 8)  # [L, ps, 2KV, D]


def _blocks(dt: str, n: int, seed: int = 0):
    """``n`` blocks in ``dt`` from one seed: numpy arrays for the JAX
    stores, torch tensors of the same bytes for the port's."""
    rng = np.random.default_rng(seed)
    jb, tb = [], []
    for _ in range(n):
        a = rng.standard_normal(SHAPE).astype(np.float32)
        if dt == "bfloat16":
            a = a.astype(jnp.bfloat16)
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        jb.append(a)
        tb.append(t)
    return jb, tb


def _np_dtype(dt):
    return jnp.bfloat16 if dt == "bfloat16" else np.float32


def _torch_dtype(dt):
    return getattr(torch, dt)


def _same_bytes(arr, tensor):
    return np.ascontiguousarray(arr).tobytes() == raw_bytes(tensor).tobytes()


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


H = [0x1000 + 0x10001 * i for i in range(16)]  # block hashes


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_host_store_matches_jax(dt):
    jb, tb = _blocks(dt, 8)
    for a, t in zip(jb, tb):
        assert block_checksum(t) == jax_block_checksum(a)
    nbytes = jb[0].nbytes
    assert tb[0].nbytes == nbytes
    evicted = ([], [])

    def hook(k):
        # Every other hash "demotes" (the next tier took it).
        return lambda h, blk: (evicted[k].append(h), h % 2 == 0)[1]

    stores = (JaxHostKvStore(3 * nbytes, on_evict=hook(0)), HostKvStore(3 * nbytes, on_evict=hook(1)))
    ops = [("put", 0), ("put", 1), ("put", 2), ("get", 0), ("put", 3), ("touch", 1),
           ("put", 4), ("drop", 3), ("put", 5), ("put", 6), ("put", 2), ("put", 7),
           ("drop", 0), ("get", 5)]
    for op, i in ops:
        got = []
        for store, blocks in zip(stores, (jb, tb)):
            if op == "put":
                got.append(store.put(H[i], blocks[i]))
            elif op == "get":
                got.append(store.get(H[i]) is not None)
            elif op == "touch":
                got.append(store.touch(H[i]))
            else:
                got.append(store.drop(H[i]))
        j, t = stores
        assert got[0] == got[1], (op, i)
        assert list(j._data) == list(t._data)
        assert j.used_bytes == t.used_bytes and len(j) == len(t)
        assert {h: j.checksum(h) for h in H} == {h: t.checksum(h) for h in H}
        assert j.drain_transitions() == t.drain_transitions()
    assert evicted[0] == evicted[1] and evicted[0]
    for name in ("stored_blocks", "evicted_blocks", "demoted_blocks", "corrupt_blocks"):
        assert getattr(stores[0], name) == getattr(stores[1], name), name
    assert stores[0].admit_bytes(3 * nbytes) == stores[1].admit_bytes(3 * nbytes) is True
    assert stores[0].admit_bytes(3 * nbytes + 1) == stores[1].admit_bytes(3 * nbytes + 1) is False


def _disk_ops(store, blocks, dtype, kind):
    """Puts past the budget (evictions through on_evict), reads, a stamped
    put whose payload fails its stamp, and a drop; returns what each op
    gave, as bytes for the blocks read."""
    out = []
    for i in (0, 1, 2, 3):
        out.append(store.put(H[i], blocks[i]))
    arr, crc, corrupt = store.read(H[2], expected_shape=SHAPE, expected_dtype=dtype)
    out.append((raw_bytes(arr).tobytes() if kind == "t" else arr.tobytes(), crc, corrupt))
    out.append(store.read(H[2], expected_shape=(9,), expected_dtype=dtype)[2])  # wrong shape
    out.append(store.put(H[4], blocks[4], checksum=12345))  # payload fails its stamp
    out.append(store.put(H[5], blocks[5]))
    out.append(store.drop(H[3]))
    out.append(store.put(H[2], blocks[2]))  # already present: a touch
    return out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_disk_store_matches_jax_byte_for_byte(tmp_path, dt):
    jb, tb = _blocks(dt, 8, seed=1)
    env = 100 + jb[0].nbytes  # one envelope: payload plus a small header
    demoted = ([], [])
    j = JaxDiskKvStore(3 * env, str(tmp_path / "j"))
    t = DiskKvStore(3 * env, str(tmp_path / "t"))
    j.on_evict = lambda h, p: (demoted[0].append((h, open(p, "rb").read())), True)[1]
    t.on_evict = lambda h, p: (demoted[1].append((h, open(p, "rb").read())), True)[1]
    want = _disk_ops(j, jb, _np_dtype(dt), "j")
    got = _disk_ops(t, tb, _torch_dtype(dt), "t")
    assert got == want
    assert demoted[0] == demoted[1] and demoted[0]  # the handed-off files too
    assert list(j._index.items()) == list(t._index.items())
    assert j.used_bytes == t.used_bytes
    assert j.drain_transitions() == t.drain_transitions()
    for name in ("stored_blocks", "evicted_blocks", "rejected_blocks", "corrupt_blocks",
                 "demoted_blocks"):
        assert getattr(j, name) == getattr(t, name), name
    files = _files(tmp_path / "t")
    assert files == _files(tmp_path / "j") and len(files) == 3

    # Each package reads the other's files (a re-index, then reads).
    jt = JaxDiskKvStore(3 * env, str(tmp_path / "t"))
    tj = DiskKvStore(3 * env, str(tmp_path / "j"))
    assert list(jt._index) == list(tj._index) == list(t._index)
    for h in t._index:
        a, ca, _ = jt.read(h, expected_shape=SHAPE, expected_dtype=_np_dtype(dt))
        b, cb, _ = tj.read(h, expected_shape=SHAPE, expected_dtype=_torch_dtype(dt))
        assert _same_bytes(a, b) and ca == cb == block_checksum(b)

    # A flipped payload byte: quarantined (deleted, a drop recorded) alike.
    victim = list(t._index)[0]
    for store in (jt, tj):
        path = store._path(victim)
        raw = bytearray(open(path, "rb").read())
        raw[-5] ^= 0xFF
        open(path, "wb").write(bytes(raw))
    rj = jt.read(victim, expected_shape=SHAPE, expected_dtype=_np_dtype(dt))
    rt = tj.read(victim, expected_shape=SHAPE, expected_dtype=_torch_dtype(dt))
    assert rj == rt == (None, None, True)
    assert not os.path.exists(jt._path(victim)) and not os.path.exists(tj._path(victim))
    assert jt.drain_transitions() == tj.drain_transitions() == [("drop", victim)]
    assert jt.corrupt_blocks == tj.corrupt_blocks == 1


def _object_ops(store, disk, blocks, dtype, kind):
    out = []
    for i in (0, 1, 2):
        out.append(store.put(H[i], blocks[i]))
    disk.put(H[3], blocks[3])
    out.append(store.ingest_kvblk(H[3], disk._path(H[3])))  # carried stamp
    disk.put(H[4], blocks[4])
    path = disk._path(H[4])
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    out.append(store.ingest_kvblk(H[4], path))  # rotted envelope refused
    out.append(store.put(H[5], blocks[5], checksum=7))  # fails its stamp
    out.append(store.put(H[6], blocks[6]))  # over budget: a GC sweep
    arr, crc, corrupt = store.read(H[3], expected_shape=SHAPE, expected_dtype=dtype)
    out.append((raw_bytes(arr).tobytes() if kind == "t" else arr.tobytes(), crc, corrupt))
    out.append(store.drop(H[6]))
    out.append(store.gc())
    return out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_object_store_matches_jax_byte_for_byte(tmp_path, dt):
    jb, tb = _blocks(dt, 8, seed=2)
    env = 100 + jb[0].nbytes
    jax_metrics.objstore_metrics.reset()
    torch_metrics.objstore_metrics.reset()
    j = JaxObjectKvStore(4 * env, str(tmp_path / "j"), part_bytes=100)
    t = ObjectKvStore(4 * env, str(tmp_path / "t"), part_bytes=100)
    want = _object_ops(j, JaxDiskKvStore(8 * env, str(tmp_path / "jd")), jb, _np_dtype(dt), "j")
    got = _object_ops(t, DiskKvStore(8 * env, str(tmp_path / "td")), tb, _torch_dtype(dt), "t")
    assert got == want
    assert list(j._index.items()) == list(t._index.items())
    assert j.used_bytes == t.used_bytes
    assert j.drain_transitions() == t.drain_transitions()
    for name in ("stored_blocks", "fetched_blocks", "evicted_blocks", "rejected_blocks",
                 "corrupt_blocks", "gc_runs"):
        assert getattr(j, name) == getattr(t, name), name
    assert torch_metrics.objstore_metrics.snapshot() == jax_metrics.objstore_metrics.snapshot()
    files = _files(tmp_path / "t")
    assert files == _files(tmp_path / "j") and files

    jt = JaxObjectKvStore(4 * env, str(tmp_path / "t"))
    tj = ObjectKvStore(4 * env, str(tmp_path / "j"))
    assert sorted(jt._index) == sorted(tj._index) == sorted(t._index)
    for h in t._index:
        a, ca, _ = jt.read(h, expected_shape=SHAPE, expected_dtype=_np_dtype(dt))
        b, cb, _ = tj.read(h, expected_shape=SHAPE, expected_dtype=_torch_dtype(dt))
        assert _same_bytes(a, b) and ca == cb == block_checksum(b)
    victim = sorted(t._index)[0]
    for store in (jt, tj):
        path = store._path(victim)
        raw = bytearray(open(path, "rb").read())
        raw[-5] ^= 0xFF
        open(path, "wb").write(bytes(raw))
    assert jt.read(victim)[2] and tj.read(victim)[2]
    assert not jt.contains(victim) and not tj.contains(victim)
    assert jt.drain_transitions() == tj.drain_transitions() == [("drop", victim)]


def test_integrity_primitives_match_jax():
    from types import SimpleNamespace

    from dynamo_tpu.engine import integrity as jint
    from dynamo_tpu_torch.engine import integrity as tint

    jb, tb = _blocks("bfloat16", 1)
    flipped = tint.flip_array_byte(tb[0])
    assert _same_bytes(jint.flip_array_byte(jb[0]), flipped)
    assert block_checksum(flipped) != block_checksum(tb[0])
    assert _same_bytes(jb[0], tb[0])  # the source stays pristine
    blob = bytes(range(200))
    assert bytes(tint.flip_blob_byte(blob, 37)) == jint.flip_blob_byte(blob, 37)
    assert tint.block_checksums(tb * 3) == [jax_block_checksum(jb[0])] * 3
    clock = SimpleNamespace(t=0.0)
    caches = [m.CorruptionCache(ttl_s=10.0, max_entries=3, clock=lambda: clock.t)
              for m in (jint, tint)]
    for cache in caches:
        cache.ban(1)
    assert [c.banned(1) for c in caches] == [True, True]
    assert [c.banned(2) for c in caches] == [False, False]
    clock.t = 10.0  # expired: a healthy copy is reachable again
    assert [c.banned(1) for c in caches] == [False, False]
    for cache in caches:
        for h in (10, 11, 12, 13):
            cache.ban(h)
    assert [sorted(c._banned) for c in caches[1:]] == [sorted(caches[0]._banned)]
    assert len(caches[1]) == 3


def test_envelope_without_checksum_reads_and_fsync_knob(tmp_path, monkeypatch):
    """An envelope without the checksum field (the JAX package's older
    files) stays readable; fsync runs only when asked."""
    import json
    import struct

    _, tb = _blocks("float32", 1)
    header = json.dumps({"dtype": "float32", "shape": list(SHAPE)}).encode()
    os.makedirs(tmp_path / "d")
    with open(tmp_path / "d" / ("%016x.kvblk" % 9), "wb") as f:
        f.write(b"DKVB1\n" + struct.pack("<I", len(header)) + header + raw_bytes(tb[0]).tobytes())
    arr, carried, corrupt = DiskKvStore(1 << 20, str(tmp_path / "d")).read(9)
    assert _same_bytes(tb[0].numpy(), arr) and carried is None and not corrupt
    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: calls.append(fd) or real(fd))
    DiskKvStore(1 << 20, str(tmp_path / "off")).put(1, tb[0])
    ObjectKvStore(1 << 20, str(tmp_path / "ooff")).put(1, tb[0])
    assert calls == []
    DiskKvStore(1 << 20, str(tmp_path / "on"), fsync=True).put(1, tb[0])
    ObjectKvStore(1 << 20, str(tmp_path / "oon"), fsync=True).put(1, tb[0])
    assert len(calls) == 2


def test_stores_reindex_and_drop_orphaned_staging_files(tmp_path):
    _, tb = _blocks("float32", 2)
    d = DiskKvStore(1 << 20, str(tmp_path / "d"))
    assert d.put(H[0], tb[0])
    open(os.path.join(tmp_path / "d", "00000000deadbeef.kvblk.tmp"), "wb").write(b"x")
    o = ObjectKvStore(1 << 20, str(tmp_path / "o"))
    assert o.put(H[1], tb[1])
    orphan = o._path(H[1]) + ".tmp"
    open(orphan, "wb").write(b"x")
    d2 = DiskKvStore(1 << 20, str(tmp_path / "d"))
    o2 = ObjectKvStore(1 << 20, str(tmp_path / "o"))
    assert list(d2._index) == [H[0]] and list(o2._index) == [H[1]]
    assert os.listdir(tmp_path / "d") == ["%016x.kvblk" % H[0]]
    assert not os.path.exists(orphan)
    assert _same_bytes(tb[0].numpy(), d2.get(H[0], SHAPE, torch.float32))


# ------------------------------------------------------------------ engines


def _cfg(tmp_path, tag, **over):
    cfg = dict(
        model="debug-tiny", block_size=BS, num_blocks=16, max_batch=2, max_model_len=64,
        prefill_chunk=32, dtype="float32",
        host_cache_bytes=64 << 20, host_offload_interval=3600.0,  # drained explicitly
        disk_cache_bytes=64 << 20, disk_cache_dir=str(tmp_path / tag / "kv"),
        object_store_bytes=64 << 20, object_store_dir=str(tmp_path / "objects"),
    )
    cfg.update(over)
    return cfg


_PARAMS = {}


def _params():
    if "p" not in _PARAMS:
        _PARAMS["p"] = jax_init_params(
            jax_get_config("debug-tiny").with_overrides(dtype="float32"), jax.random.PRNGKey(0))
    return _PARAMS["p"]


def _engines(cfg_j, cfg_t, events=None):
    """A TpuEngine and a TorchEngine with the same seeded weights."""
    ev = events or ([], [])
    params = _params()
    jax_engine = TpuEngine(JaxEngineConfig(**cfg_j), params=params, event_callback=ev[0].append)
    tree = jax.tree_util.tree_map(np.asarray, params)
    engine = TorchEngine(EngineConfig(**cfg_t), params=params_from_jax(tree, device="cpu"),
                         device="cpu", event_callback=ev[1].append)
    return jax_engine, engine


def _torch_engine(cfg):
    tree = jax.tree_util.tree_map(np.asarray, _params())
    return TorchEngine(EngineConfig(**cfg), params=params_from_jax(tree, device="cpu"),
                       device="cpu")


async def _gen(engine, tokens, max_tokens=4):
    ctx = JaxContext if isinstance(engine, TpuEngine) else Context
    req = PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
    ).to_dict()
    out = await collect(await engine.generate(ctx(req)))
    return [t for item in out for t in item["token_ids"]]


async def _drain(engine):
    while engine._offload_queue:
        await engine.drain_offload()


def _reset_metrics():
    for m in (jax_metrics, torch_metrics):
        m.kv_tier_metrics.reset()
        m.kv_integrity_metrics.reset()
        m.objstore_metrics.reset()


def _snapshot(m):
    """The three groups' counters, without latencies (timing) and byte
    totals (envelope sizes, see _counters)."""
    tier = {k: v for k, v in m.kv_tier_metrics.snapshot().items() if "latency" not in k}
    obj = {k: v for k, v in m.objstore_metrics.snapshot().items() if "bytes" not in k}
    return tier, m.kv_integrity_metrics.snapshot(), obj


def _counters(engine):
    out = {"host": {k: getattr(engine.host_kv, k) for k in (
        "stored_blocks", "restored_blocks", "evicted_blocks", "demoted_blocks", "corrupt_blocks")}}
    if engine.disk_kv is not None:
        out["disk"] = {k: getattr(engine.disk_kv, k) for k in (
            "stored_blocks", "promoted_blocks", "evicted_blocks", "rejected_blocks",
            "corrupt_blocks", "demoted_blocks")}
    if engine.object_kv is not None:
        out["objstore"] = {k: getattr(engine.object_kv, k) for k in (
            "stored_blocks", "fetched_blocks", "evicted_blocks", "rejected_blocks",
            "corrupt_blocks")}
    # Blocks per tier; not bytes: an envelope's JSON header holds the
    # block's CRC in decimal, and the two packages' f32 K/V differ in the
    # last bits (XLA's and torch's kernels), so sizes may differ by a digit.
    summary = engine.kv_tier_summary()
    out["summary"] = {k: v["blocks"] for k, v in summary.items() if k != "prefix_hit_rate"}
    out["matched"] = engine.kv.matched_blocks
    return out


async def _chain(engine):
    """Serve PROMPT, squeeze host and disk so the flood cascades its blocks
    host → disk → object store, then serve PROMPT again: object store →
    host → device, restored as a prefix hit."""
    chain = [tb.sequence_hash for tb in hash_token_blocks(PROMPT, BS)]
    out = {"first": await _gen(engine, PROMPT)}
    await _drain(engine)
    out["host_after_offload"] = [engine.host_kv.contains(h) for h in chain]
    engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
    engine.disk_kv.capacity_bytes = 2 * engine.block_nbytes() + 1024
    for base in FLOOD:
        out[base] = await _gen(engine, [base + i for i in range(12)])
        await _drain(engine)
    out["tiers"] = [engine._tier_of(h) for h in chain]
    out["resident"] = [h in engine.kv._by_hash for h in chain]
    out["before"] = _counters(engine)
    out["again"] = await _gen(engine, PROMPT)
    out["after"] = _counters(engine)
    out["local_prefix"] = engine.local_prefix_blocks(PROMPT)
    return out


async def test_tier_chain_restore_matches_tpu_engine(tmp_path):
    events = ([], [])
    jax_engine, engine = _engines(_cfg(tmp_path, "j"), _cfg(tmp_path, "t", object_store_dir=str(
        tmp_path / "objects_t")), events)
    _reset_metrics()
    try:
        want = await _chain(jax_engine)
        want_metrics = _snapshot(jax_metrics)
        got = await _chain(engine)
        got_metrics = _snapshot(torch_metrics)
    finally:
        await jax_engine.close()
        await engine.close()
    assert got == want
    assert want["tiers"] == ["objstore"] * 3 and want["resident"] == [False] * 3
    assert want["again"] == want["first"]
    assert want["after"]["host"]["restored_blocks"] == 3
    assert got_metrics == want_metrics
    assert got_metrics[0]["restored_blocks_total"] == 3
    assert got_metrics[0]["promoted_blocks_total"] >= 3
    assert [e.to_dict() for e in events[1]] == [e.to_dict() for e in events[0]]
    tiers = {e.data.tier for e in events[1] if isinstance(e.data, KvCacheTierData)}
    assert {"host", "objstore"} <= tiers
    # The engine-owned default disk dirs go at close; the object store stays.
    assert os.listdir(tmp_path / "objects_t")


async def test_restore_writes_the_captured_pages_in_place(tmp_path):
    """The restore scatters into the one pages tensor (the one every CUDA
    graph holds): its storage never moves, and the restored pages equal
    the bytes gathered after the first prefill."""
    engine = _torch_engine(_cfg(tmp_path, "t", disk_cache_bytes=0, object_store_bytes=0))
    try:
        ptr = engine.cache.pages.data_ptr()
        await _gen(engine, PROMPT)
        chain = [tb.sequence_hash for tb in hash_token_blocks(PROMPT, BS)]
        first = engine.cache.pages[:, engine.kv._by_hash[chain[1]]].clone()
        await _drain(engine)
        assert engine.kv.evict_hashes(chain) == 3
        again = await _gen(engine, PROMPT)
        assert engine.host_kv.restored_blocks == 3
        assert engine.cache.pages.data_ptr() == ptr
        assert torch.equal(engine.cache.pages[:, engine.kv._by_hash[chain[1]]], first)
        assert len(again) == 4
        cp = engine.copy_summary()
        assert cp["h2d_bytes"] == 3 * engine.block_nbytes()
        assert cp["d2h_bytes"] >= 3 * engine.block_nbytes()
    finally:
        await engine.close()


async def test_restore_entry_splits_the_upload(tmp_path):
    """A host restore's ``transfer_parts`` entry carries the upload's three
    parts — the wait for the copy lock, the buffer's allocation and the
    copies' enqueue — which add up to the whole upload (less the thread
    hop), and the count of source blocks not in pinned memory (none on the
    CPU, where nothing is pinned or asynchronous)."""
    engine = _torch_engine(_cfg(tmp_path, "t", disk_cache_bytes=0, object_store_bytes=0))
    try:
        await _gen(engine, PROMPT)
        chain = [tb.sequence_hash for tb in hash_token_blocks(PROMPT, BS)]
        await _drain(engine)
        assert engine.kv.evict_hashes(chain) == 3
        await _gen(engine, PROMPT)
        (parts,) = [pp for kind, n, pp in engine.transfer_parts if kind == "restore" and n == 3]
        split = ("upload_lock_wait", "upload_alloc", "upload_enqueue")
        assert set(split) | {"upload", "unpinned"} <= set(parts)
        assert all(parts[k] >= 0.0 for k in split)
        assert sum(parts[k] for k in split) <= parts["upload"] + 1e-6
        assert parts["upload"] - sum(parts[k] for k in split) < 0.05
        assert parts["unpinned"] == 0
    finally:
        await engine.close()


async def _scale_from_zero(writer, make_fresh):
    chain = [tb.sequence_hash for tb in hash_token_blocks(list(range(1, 41)), BS)]
    first = await _gen(writer, list(range(1, 41)))
    await _drain(writer)
    persisted = await writer.persist_hashes(chain)
    await writer.close()  # the worker dies; the objects survive
    fresh = make_fresh()
    try:
        assert len(fresh.disk_kv) == 0 and len(fresh.host_kv) == 0
        got = await _gen(fresh, list(range(1, 41)))
        return first, got, persisted, _counters(fresh)
    finally:
        await fresh.close()


async def test_scale_from_zero_matches_tpu_engine_and_reads_its_objects(tmp_path):
    big = dict(max_model_len=128, num_blocks=64)
    params = _params()
    _reset_metrics()
    want = await _scale_from_zero(
        TpuEngine(JaxEngineConfig(**_cfg(tmp_path, "j", **big)), params=params),
        lambda: TpuEngine(JaxEngineConfig(**_cfg(tmp_path, "j2", **big)), params=params))
    got = await _scale_from_zero(
        _torch_engine(_cfg(tmp_path, "t", object_store_dir=str(tmp_path / "objects_t"), **big)),
        lambda: _torch_engine(_cfg(tmp_path, "t2", object_store_dir=str(tmp_path / "objects_t"),
                                   **big)))
    assert got == want
    first, again, persisted, counters = got
    assert again == first and persisted == 10 and counters["matched"] >= 9
    assert sorted(_files(tmp_path / "objects_t")) == sorted(_files(tmp_path / "objects"))
    # Across packages: the JAX engine's object store warms a fresh port
    # engine, with the same stream.
    cross = _torch_engine(_cfg(tmp_path, "t3", **big))
    try:
        assert len(cross.object_kv) == 10
        assert await _gen(cross, list(range(1, 41))) == first
        assert cross.host_kv.restored_blocks >= 9 and cross.kv.matched_blocks >= 9
    finally:
        await cross.close()


async def _fault_run(engine, package_faults, plane, make_fresh=None):
    """Serve PROMPT, put its blocks in ``plane``'s tier (off the device),
    arm ``kv_corrupt`` on that plane once and serve it again, then once
    more (the negative cache)."""
    chain = [tb.sequence_hash for tb in hash_token_blocks(PROMPT, BS)]
    reported = []
    first = await _gen(engine, PROMPT)
    await _drain(engine)
    if plane == "disk":
        engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
        for base in FLOOD:
            await _gen(engine, [base + i for i in range(12)])
            await _drain(engine)
        engine.host_kv.capacity_bytes = 64 << 20
    elif plane == "objstore":
        assert await engine.persist_hashes(chain) == 3
        await engine.close()
        engine = make_fresh()
    engine.set_integrity_reporter(reported.append)
    engine.kv.evict_hashes(chain)
    tiers = [engine._tier_of(h) for h in chain]
    package_faults.arm("kv_corrupt", match=plane, count=1)
    try:
        again = await _gen(engine, PROMPT)
    finally:
        package_faults.reset()
    banned = [engine.integrity.banned(h) for h in chain]
    await _drain(engine)  # the recomputed blocks, back in the host tier
    engine.kv.evict_hashes(chain)
    third = await _gen(engine, PROMPT)
    out = dict(first=first, again=again, third=third, tiers=tiers, banned=banned,
               reported=reported, held=[engine._tier_of(h) for h in chain],
               counters=_counters(engine))
    await engine.close()
    return out


@pytest.mark.parametrize("plane", ["host", "disk", "objstore"])
async def test_kv_corrupt_fault_quarantines_like_tpu_engine(tmp_path, plane):
    params = _params()
    jcfg = _cfg(tmp_path, "j")
    tcfg = _cfg(tmp_path, "t", object_store_dir=str(tmp_path / "objects_t"))
    _reset_metrics()
    want = await _fault_run(
        TpuEngine(JaxEngineConfig(**jcfg), params=params), jax_faults, plane,
        lambda: TpuEngine(JaxEngineConfig(**dict(jcfg, disk_cache_dir=str(tmp_path / "j2"))),
                          params=params))
    got = await _fault_run(
        _torch_engine(tcfg), faults, plane,
        lambda: _torch_engine(dict(tcfg, disk_cache_dir=str(tmp_path / "t2"))))
    assert got == want
    assert got["again"] == got["third"] == got["first"]  # recomputed, same stream
    assert got["tiers"][0] == ("objstore" if plane == "objstore" else plane)
    assert got["banned"][0] and got["reported"] == [plane]
    assert _snapshot(torch_metrics) == _snapshot(jax_metrics)
    integrity = torch_metrics.kv_integrity_metrics
    assert integrity.corrupt_total[plane] == 1 and integrity.recomputed_total == 1
    assert integrity.negative_cache_hits_total >= 1


async def test_int8_kv_auto_scales_are_equal_in_a_fresh_engine():
    """A warm start from the object store restores int8 codes without
    their scales: it relies on ``kv_scale="auto"`` calibrating the same
    scales for the same weights in a fresh engine — in both packages."""
    cfg = dict(model="debug-tiny", block_size=BS, num_blocks=32, max_batch=2, max_model_len=64,
               dtype="float32", cache_dtype="int8", kv_scale="auto")
    a, b = _torch_engine(cfg), _torch_engine(cfg)
    ja = TpuEngine(JaxEngineConfig(**cfg), params=_params())
    jb = TpuEngine(JaxEngineConfig(**cfg), params=_params())
    try:
        assert np.array_equal(np.asarray(a.kv_scale), np.asarray(b.kv_scale))
        assert np.array_equal(np.asarray(ja.kv_scale), np.asarray(jb.kv_scale))
    finally:
        for e in (a, b, ja, jb):
            await e.close()


# ------------------------------------------- mirrors of the JAX tier tests


async def test_drain_offload_releases_device_lock_during_host_copy(tmp_path):
    """The device→host copy and the host-tier store must not hold the
    device lock — decode dispatch never waits on an offload."""
    engine = _torch_engine(_cfg(tmp_path, "t", disk_cache_bytes=0, object_store_bytes=0))
    await _gen(engine, PROMPT)
    assert engine._offload_queue, "test needs queued sealed blocks"
    gate, entered = threading.Event(), threading.Event()
    orig_put = engine.host_kv.put

    def slow_put(h, blk, **kw):
        entered.set()
        assert gate.wait(10.0)
        return orig_put(h, blk, **kw)

    engine.host_kv.put = slow_put
    drain = asyncio.get_running_loop().create_task(engine.drain_offload())
    try:
        await asyncio.to_thread(entered.wait, 10.0)
        assert entered.is_set()
        await asyncio.wait_for(engine._device_lock.acquire(), 1.0)
        engine._device_lock.release()
    finally:
        gate.set()
        await drain
    assert len(engine.host_kv) > 0
    await engine.close()


async def _demote_prompt_to_disk(engine):
    await _gen(engine, PROMPT)
    await _drain(engine)
    engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
    for base in FLOOD:
        await _gen(engine, [base + i for i in range(12)])
        await _drain(engine)


async def test_promotion_rejects_early_when_host_budget_too_small(tmp_path):
    engine = _torch_engine(_cfg(tmp_path, "t", object_store_bytes=0))
    await _demote_prompt_to_disk(engine)
    assert len(engine.disk_kv) > 0
    # A host budget below one block: promotion rejects before reading a file.
    engine.host_kv.capacity_bytes = 8
    before = engine.disk_kv.promoted_blocks
    assert await engine.prefetch_hashes(list(engine.disk_kv._index)) == 0
    assert engine.disk_kv.promoted_blocks == before
    await engine.close()


async def test_resume_after_disk_demotion_splices_exactly(tmp_path):
    """A resume request (prompt + the tokens already delivered) finds the
    blocks demoted to disk meanwhile: disk → host → device, then the
    stream continues exactly."""
    engine = _torch_engine(_cfg(tmp_path, "t", object_store_bytes=0))
    full = await _gen(engine, PROMPT, max_tokens=8)
    await _drain(engine)
    engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
    for base in FLOOD:
        await _gen(engine, [base + i for i in range(12)])
        await _drain(engine)
    assert len(engine.kv.match_prefix(hash_token_blocks(PROMPT, BS))) < 3, "needs eviction"
    delivered = full[:3]
    req = PreprocessedRequest(
        token_ids=PROMPT + delivered,
        stop_conditions=StopConditions(max_tokens=5, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
    ).to_dict()
    tail = [t for it in await collect(await engine.generate(Context(req))) for t in it["token_ids"]]
    assert delivered + tail == full
    assert engine.disk_kv.promoted_blocks > 0
    await engine.close()


async def test_prefetch_promotes_disk_chains_to_host(tmp_path):
    engine = _torch_engine(_cfg(tmp_path, "t", object_store_bytes=0))
    await _demote_prompt_to_disk(engine)
    chain = [tb.sequence_hash for tb in hash_token_blocks(PROMPT, BS)
             if engine.disk_kv.contains(tb.sequence_hash)]
    assert chain, "test needs demoted blocks"
    engine.host_kv.capacity_bytes = 64 << 20
    events = []
    engine.kv._event_callback = events.append
    pre0 = torch_metrics.kv_tier_metrics.prefetched_blocks_total
    n = await engine.prefetch_hashes(chain)
    assert n == len(chain)
    assert all(engine.host_kv.contains(h) for h in chain)
    assert torch_metrics.kv_tier_metrics.prefetched_blocks_total == pre0 + n
    host_tagged = {h for e in events if isinstance(e.data, KvCacheTierData)
                   and e.data.tier == "host" for h in e.data.block_hashes}
    assert set(chain) <= host_tagged
    await engine.close()


async def test_persist_hashes_sources_host_then_disk(tmp_path):
    engine = _torch_engine(_cfg(tmp_path, "t"))
    await _gen(engine, PROMPT)
    await _drain(engine)
    chain = [tb.sequence_hash for tb in hash_token_blocks(PROMPT, BS)]
    resident = [h for h in chain if engine.host_kv.contains(h)]
    assert resident, "test needs host-resident blocks"
    assert await engine.persist_hashes(chain) == len(resident)
    assert all(engine.object_kv.contains(h) for h in resident)
    assert await engine.persist_hashes(chain) == 0  # present objects are skipped
    # A chain on disk only is read (validated) from there.
    engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
    for base in FLOOD:
        await _gen(engine, [base + i for i in range(12)])
        await _drain(engine)
    on_disk = [h for h in engine.disk_kv._index if not engine.object_kv.contains(h)
               and not engine.host_kv.contains(h)]
    assert on_disk
    assert await engine.persist_hashes(on_disk[:2]) == 2
    await engine.close()


def test_config_requires_disk_tier_and_explicit_dir(tmp_path):
    base = dict(model="debug-tiny", block_size=BS, num_blocks=16, max_batch=2, max_model_len=64)
    with pytest.raises(ValueError):
        EngineConfig(**base, disk_cache_bytes=64 << 20)  # no host tier
    with pytest.raises(ValueError):
        EngineConfig(**base, host_cache_bytes=64 << 20, object_store_bytes=64 << 20,
                     object_store_dir=str(tmp_path / "o"))  # no disk tier
    with pytest.raises(ValueError):
        EngineConfig(**base, host_cache_bytes=64 << 20, disk_cache_bytes=64 << 20,
                     disk_cache_dir=str(tmp_path / "kv"), object_store_bytes=64 << 20)


async def test_default_disk_dir_is_per_process_and_removed_at_close(tmp_path):
    engine = _torch_engine(_cfg(tmp_path, "t", disk_cache_dir=None, object_store_bytes=0))
    d = engine.disk_kv.directory
    assert str(os.getpid()) in os.path.basename(d) and os.path.isdir(d)
    await engine.close()
    assert not os.path.exists(d)


# ------------------------------------------------------------- the edge


async def _edge_traffic(service_cls, pipeline_parts, engine, metrics_mod):
    """One HTTP edge over ``engine`` with the tier gauges wired, PROMPT,
    a flood and PROMPT again as /v1/completions; returns /metrics."""
    from aiohttp import ClientSession

    metrics_mod.kv_tier_metrics.set_source(engine.kv_tier_summary)
    metrics_mod.engine_dispatch_metrics.set_source(engine.dispatch_summary)
    service = service_cls(host="127.0.0.1", port=0)
    service.models.add_completion_model("m", pipeline_parts(engine))
    await service.start()
    base = f"http://127.0.0.1:{service.port}"
    try:
        async with ClientSession() as http:
            async def post(p):
                body = dict(model="m", prompt=p, max_tokens=4, nvext={"ignore_eos": True})
                async with http.post(base + "/v1/completions", json=body) as r:
                    assert r.status == 200, await r.text()
                await _drain(engine)

            await post(PROMPT)
            engine.host_kv.capacity_bytes = 2 * engine.block_nbytes()
            engine.disk_kv.capacity_bytes = 2 * engine.block_nbytes() + 1024
            for b in FLOOD:
                await post([b + i for i in range(12)])
            await post(PROMPT)
            async with http.get(base + "/metrics") as r:
                return await r.text()
    finally:
        metrics_mod.kv_tier_metrics.set_source(None)
        metrics_mod.engine_dispatch_metrics.set_source(None)
        await service.close()
        await engine.close()


async def test_tier_metrics_groups_match_the_jax_edge(tmp_path):
    from prometheus_client.parser import text_string_to_metric_families

    from dynamo_tpu.llm import Backend as JaxBackend
    from dynamo_tpu.llm import ByteTokenizer as JaxByteTokenizer
    from dynamo_tpu.llm import HttpService as JaxHttpService
    from dynamo_tpu.llm import OpenAIPreprocessor as JaxPreprocessor
    from dynamo_tpu.runtime import build_pipeline as jax_build_pipeline
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline

    jax_engine, engine = _engines(_cfg(tmp_path, "j"), _cfg(tmp_path, "t", object_store_dir=str(
        tmp_path / "objects_t")))
    _reset_metrics()
    jtok, ttok = JaxByteTokenizer(), ByteTokenizer()
    want = await _edge_traffic(JaxHttpService, lambda e: jax_build_pipeline(
        [JaxPreprocessor(jtok, "m"), JaxBackend(jtok)], e), jax_engine, jax_metrics)
    got = await _edge_traffic(HttpService, lambda e: build_pipeline(
        [OpenAIPreprocessor(ttok, "m"), Backend(ttok)], e), engine, torch_metrics)

    groups = ("dynamo_tpu_kv_tier_", "dynamo_tpu_kv_integrity_", "dynamo_tpu_objstore_")

    def samples(text):
        return {(s.name, tuple(sorted(s.labels.items()))): s.value
                for f in text_string_to_metric_families(text) if f.name.startswith(groups)
                for s in f.samples if "latency" not in s.name and "bytes" not in s.name}

    def families(text):
        return [(f.name, f.type, f.documentation) for f in text_string_to_metric_families(text)
                if f.name.startswith(groups)]

    assert families(got) == families(want) and len(families(got)) > 20
    assert samples(got) == samples(want)
    assert samples(got)[("dynamo_tpu_kv_tier_restored_blocks_total", ())] == 3
    assert samples(got)[("dynamo_tpu_kv_tier_blocks", (("tier", "objstore"),))] > 0
    # The groups follow the engine-dispatch group, as on the JAX edge.
    assert got.index("dynamo_tpu_kv_tier_") > got.index("dynamo_tpu_engine_dispatch_")
    assert got.index("dynamo_tpu_objstore_") > got.index("dynamo_tpu_kv_integrity_")


# --------------------------------------------------------------- the CLI


def test_cli_maps_the_tier_flags_and_still_refuses_the_pull(tmp_path):
    """The tier flags map onto the engine's config, and so, since the
    prefix pull was ported, does ``--kv-pull-mb`` (it was refused while
    the pull waited; the name is kept)."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.engine import build_torch_engine

    args = cli.parse_args([
        "run", "in=http", "out=torch", "--device", "cpu", "--dtype", "float32",
        "--host-cache-mb", "3", "--disk-cache-mb", "2", "--disk-cache-dir", str(tmp_path / "kv"),
        "--object-store-mb", "5", "--object-store-dir", str(tmp_path / "o"),
    ])
    engine = build_torch_engine(args)
    try:
        assert engine.host_kv.capacity_bytes == 3 << 20
        assert engine.disk_kv.capacity_bytes == 2 << 20
        assert engine.disk_kv.directory == str(tmp_path / "kv")
        assert engine.object_kv.capacity_bytes == 5 << 20
        assert engine.object_kv.directory == str(tmp_path / "o")
    finally:
        asyncio.run(engine.close())
    args = cli.parse_args(["run", "in=http", "out=torch", "--device", "cpu", "--kv-pull-mb", "8"])
    engine = build_torch_engine(args)
    try:
        assert engine.cfg.kv_pull_max_bytes == 8 << 20
    finally:
        asyncio.run(engine.close())
    engine = build_torch_engine(cli.parse_args(["run", "in=http", "out=torch", "--device", "cpu"]))
    try:
        assert engine.cfg.kv_pull_max_bytes == 64 << 20  # the JAX default
    finally:
        asyncio.run(engine.close())
