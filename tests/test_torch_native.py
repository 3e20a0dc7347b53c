"""The port's native library (``dynamo_tpu_torch/native.py``, built from its
own ``csrc/native/*.cc``) against the JAX package's (``tests/test_native.py``):

- ``hash_blocks`` equals the JAX ``native.hash_blocks`` and the port's
  pure-Python chain on seeded prompts up to 8192 ids, with and without a
  salt, and ``fast_sequence_hashes`` takes the native chain;
- ``DYN_NATIVE=0`` (a fresh interpreter) gives the same hashes through the
  pure-Python path;
- ``KvEventShim`` drains the same events as the JAX shim for the same
  publishes;
- ``DYN_NATIVE_LIB`` naming a missing library refuses loudly, and the
  library rebuilds when a source is newer than it.

The JAX side is a library of this module's own, built by the JAX
package's Makefile (``native/``, read only) into a directory of its own.
Every xdist worker that collects ``tests/test_native.py`` runs ``make -C
native``, whose rule writes ``native/build/libdyn_native.so`` in place with
no lock; a worker that loads a half-written file marks the JAX library
failed for the rest of its life.  So this module never loads that file.
"""

import ctypes
import importlib
import json
import os
import random
import subprocess
import sys

import pytest

from dynamo_tpu import native as jax_native
from dynamo_tpu.llm.kv_router import protocols as jax_protocols
from dynamo_tpu_torch import native, tokens
from dynamo_tpu_torch.llm.kv_router import protocols

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = (0, 15, 16, 17, 100, 1024, 8192)


def _prompts(seed):
    rng = random.Random(seed)
    return [[rng.randrange(0, 1 << 17) for _ in range(n)] for n in LENGTHS]


def _build_jax_library(build_dir):
    """Build the JAX package's library with its own Makefile (its flags,
    its sources, read only), with the Makefile's ``BUILD`` pointed at
    ``build_dir``, a directory of this worker's own: no other loader sees
    the file while it is written."""
    subprocess.run(["make", "-C", os.path.join(REPO, "native"), f"BUILD={build_dir}"],
                   check=True, capture_output=True, timeout=120)
    return build_dir / "libdyn_native.so"


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    assert native.available(), "the port's native library did not build"
    so = _build_jax_library(tmp_path_factory.mktemp("jax_native"))
    left = {k: getattr(jax_native, k) for k in ("_SO_PATH", "_lib", "_load_failed", "_build_thread")}
    # A fresh load: forget whatever this worker's collection-time build
    # left behind (a half-written library marks the module failed).
    importlib.reload(jax_native)
    jax_native._SO_PATH = str(so)
    assert jax_native.available(), "the JAX package's native library did not build"
    yield native.get_lib(), jax_native.get_lib()
    # Hand the module back as this worker's collection left it, so a later
    # tests/test_native.py here tests the library `make` built there.
    for k, v in left.items():
        setattr(jax_native, k, v)


def test_port_builds_its_own_sources(libs):
    lib, jlib = libs
    assert native._SO_PATH == str(native.PKG / "_build" / "libdyn_native.so")
    assert os.path.exists(native._SO_PATH)
    assert all(src.parent == native.PKG / "csrc" / "native" for src in native.SOURCES)
    for data in (b"", b"a", b"hello world", bytes(range(256)) * 5):
        assert lib.dyn_xxh64(data, len(data), 1337) == jlib.dyn_xxh64(data, len(data), 1337)
        assert lib.dyn_xxh64(data, len(data), 1337) == tokens.xxh64(data, tokens.HASH_SEED)


@pytest.mark.parametrize("salt", [None, "tenant-a"])
@pytest.mark.parametrize("block_size", [16, 4])
def test_hash_blocks_equal_jax_and_python_chain(libs, salt, block_size):
    root = tokens.salt_hash(salt) or 0
    for ids in _prompts(7):
        port = native.hash_blocks(ids, block_size, root)
        assert port == jax_native.hash_blocks(ids, block_size, root)
        py = tokens.hash_token_blocks(ids, block_size, salt)
        assert port == [(b.block_hash, b.sequence_hash) for b in py]
        assert tokens.fast_sequence_hashes(ids, block_size, salt) == [b.sequence_hash for b in py]


def test_native_disabled_gives_the_same_hashes(libs):
    """``DYN_NATIVE=0`` keeps the pure-Python path, hash for hash."""
    prog = (
        "import json, random, sys\n"
        "from dynamo_tpu_torch import native, tokens\n"
        "rng = random.Random(7)\n"
        "ids = [rng.randrange(0, 1 << 17) for _ in range(8192)]\n"
        "out = [tokens.fast_sequence_hashes(ids, 16, s) for s in (None, 'tenant-a')]\n"
        "print(json.dumps({'lib': native.get_lib(wait=True) is None, 'hashes': out}))\n"
    )
    env = dict(os.environ, DYN_NATIVE="0", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["lib"] is True  # no library loaded under DYN_NATIVE=0
    rng = random.Random(7)
    ids = [rng.randrange(0, 1 << 17) for _ in range(8192)]
    want = [[b.sequence_hash for b in tokens.hash_token_blocks(ids, 16, s)]
            for s in (None, "tenant-a")]
    assert got["hashes"] == want


def _publish(lib, seqs, toks, removed):
    a = (ctypes.c_uint64 * len(seqs))(*seqs)
    b = (ctypes.c_uint64 * len(toks))(*toks)
    assert lib.dyn_kv_publish_stored(99, a, b, len(seqs)) == 0
    assert lib.dyn_kv_publish_stored(0, a, None, 1) == 0  # a root block, no token hash
    r = (ctypes.c_uint64 * len(removed))(*removed)
    assert lib.dyn_kv_publish_removed(r, len(removed)) == 0
    assert lib.dyn_kv_publish_cleared() == 0


def _events(evs, P):
    out = []
    for ev in evs:
        d = ev.data
        if isinstance(d, P.KvCacheStoreData):
            out.append(("stored", ev.event_id, d.parent_hash,
                        [(b.block_hash, b.tokens_hash) for b in d.blocks]))
        elif isinstance(d, P.KvCacheRemoveData):
            out.append(("removed", ev.event_id, list(d.block_hashes)))
        else:
            out.append(("cleared", ev.event_id, d))
    return out


def test_kv_event_shim_drains_like_jax(libs):
    lib, jlib = libs
    seqs, toks, removed = [111, 222, 2**64 - 1], [333, 444, 555], [111, 222]
    drained = {}
    for name, mod, P, handle in (("port", native, protocols, lib),
                                 ("jax", jax_native, jax_protocols, jlib)):
        shim = mod.KvEventShim(worker_id=7)
        try:
            _publish(handle, seqs, toks, removed)
            drained[name] = _events(shim.drain(), P)
            assert shim.drain() == []
            assert shim.dropped == 0
        finally:
            shim.close()
    assert drained["port"] == drained["jax"]
    assert [e[0] for e in drained["port"]] == ["stored", "stored", "removed", "cleared"]
    assert drained["port"][1][2] is None  # parent 0 drains as a root


def test_explicit_library_override_never_falls_back(tmp_path):
    prog = "from dynamo_tpu_torch import native\nnative._build_and_load()\n"
    env = dict(os.environ, DYN_NATIVE_LIB=str(tmp_path / "missing.so"), PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode != 0
    assert "DYN_NATIVE_LIB" in r.stderr and "does not exist" in r.stderr


def test_stale_library_is_rebuilt(tmp_path, libs):
    so = tmp_path / "libdyn_native.so"
    assert native._stale(so)
    native.build(so)
    assert not native._stale(so)
    os.utime(so, (0, 0))  # older than every source
    assert native._stale(so)
    lib = ctypes.CDLL(str(so))
    lib.dyn_xxh64.restype = ctypes.c_uint64
    lib.dyn_xxh64.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
    assert lib.dyn_xxh64(b"abc", 3, 1337) == tokens._hash_bytes(b"abc")
