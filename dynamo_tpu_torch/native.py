"""ctypes bridge to the native C++ runtime components (csrc/native/*.cc).

A copy of the JAX package's ``native.py`` that builds the port's own copy of
the sources: ``g++ -O3 -std=c++17 -fPIC -shared`` over
``csrc/native/*.cc`` into ``_build/libdyn_native.so`` (listed in
``.gitignore``, beside the CUDA libraries of ops/_build.py), on a
background thread at first use, again whenever a source is newer than the
library.  Host code, no device kernel: the library is the router's fast
path for block hashing.  Everything here degrades gracefully: if the
library cannot build or load, callers fall back to pure Python, with the
same hashes (set ``DYN_NATIVE=0`` to force that).  ``DYN_NATIVE_LIB``
names another library (e.g. a sanitizer build) and never falls back
silently.

Surface:
- ``hash_blocks(tokens, block_size, parent_hash)`` — chained block hashing
  (native fast path for dynamo_tpu_torch.tokens; bit-identical to the
  pure-Python XXH64 chain).
- ``KvEventShim`` — drain side of the C ABI event ring
  (dyn_kv_publish_stored/removed from any engine → KvCacheEvent objects).
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

PKG = Path(__file__).resolve().parent
SOURCES = (PKG / "csrc" / "native" / "dyn_tokens.cc", PKG / "csrc" / "native" / "dyn_kv_events.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_DEFAULT_SO = PKG / "_build" / "libdyn_native.so"
_SO_PATH = os.environ.get("DYN_NATIVE_LIB", str(_DEFAULT_SO))

_lib = None
_lib_lock = threading.Lock()
_load_failed = False
_build_thread: Optional[threading.Thread] = None


def _stale(so: Path) -> bool:
    if not so.exists():
        return True
    built = so.stat().st_mtime
    return any(src.stat().st_mtime > built for src in SOURCES)


def build(so: Path = _DEFAULT_SO) -> Path:
    """Compile the library into ``so`` (through a temporary name, so a
    concurrent loader never sees a partial file).  Raises on failure."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def _build() -> bool:
    try:
        build()
        return True
    except subprocess.CalledProcessError as exc:
        logger.warning("native build failed (falling back to python): %s",
                       exc.stderr.decode(errors="replace")[-2000:])
    except (subprocess.SubprocessError, OSError) as exc:
        logger.warning("native build failed (falling back to python): %s", exc)
    return False


def _build_and_load() -> None:
    global _load_failed
    if "DYN_NATIVE_LIB" in os.environ:
        if not os.path.exists(_SO_PATH):
            # An explicit override must never silently fall back to the
            # pure-Python path (e.g. a sanitizer run that tests nothing) —
            # and auto-build only knows the default target.
            raise FileNotFoundError(f"DYN_NATIVE_LIB={_SO_PATH} does not exist; build it first")
    elif _stale(_DEFAULT_SO) and not _build():
        _load_failed = True
        return
    _load()


def get_lib(wait: bool = False) -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable/disabled.

    The g++ build runs on a background thread: with ``wait=False`` (the hot
    path) callers get None — and fall back to pure Python — until the build
    lands, instead of stalling the event loop for the compile.
    """
    global _build_thread, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if os.environ.get("DYN_NATIVE", "1") == "0":
        _load_failed = True
        return None
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        if _build_thread is None:
            _build_thread = threading.Thread(target=_build_and_load, daemon=True)
            _build_thread.start()
    if wait:
        _build_thread.join(timeout=150)
    return _lib


def _load() -> None:
    """Load + bind the shared library (runs on the build thread)."""
    global _lib, _load_failed
    with _lib_lock:
        if _lib is not None or _load_failed:
            return
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as exc:
            logger.warning("native load failed: %s", exc)
            _load_failed = True
            return
        lib.dyn_xxh64.restype = ctypes.c_uint64
        lib.dyn_xxh64.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.dyn_hash_blocks.restype = ctypes.c_uint64
        lib.dyn_hash_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.dyn_kv_init.restype = ctypes.c_int
        lib.dyn_kv_init.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.dyn_kv_publish_stored.restype = ctypes.c_int
        lib.dyn_kv_publish_stored.argtypes = [
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32,
        ]
        lib.dyn_kv_publish_removed.restype = ctypes.c_int
        lib.dyn_kv_publish_removed.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32,
        ]
        lib.dyn_kv_publish_cleared.restype = ctypes.c_int
        lib.dyn_kv_publish_cleared.argtypes = []
        lib.dyn_kv_drain.restype = ctypes.c_int64
        lib.dyn_kv_drain.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.dyn_kv_dropped.restype = ctypes.c_uint64
        lib.dyn_kv_dropped.argtypes = []
        lib.dyn_kv_shutdown.restype = None
        lib.dyn_kv_shutdown.argtypes = []
        _lib = lib


def available() -> bool:
    """True once the library is built+loaded (blocks for the build)."""
    return get_lib(wait=True) is not None


def hash_blocks(
    tokens, block_size: int, parent_hash: int = 0
) -> Optional[List[Tuple[int, int]]]:
    """Native chained hashing of complete blocks: [(local, seq), ...].

    Returns None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(tokens)
    n_blocks = n // block_size
    if n_blocks == 0:
        return []
    arr = (ctypes.c_uint32 * n)(*tokens)
    out_local = (ctypes.c_uint64 * n_blocks)()
    out_seq = (ctypes.c_uint64 * n_blocks)()
    wrote = lib.dyn_hash_blocks(
        arr, n, block_size, parent_hash & 0xFFFFFFFFFFFFFFFF, out_local, out_seq
    )
    return [(out_local[i], out_seq[i]) for i in range(wrote)]


class KvEventShim:
    """Drain side of the C-ABI event ring (external engine integration)."""

    _HEADER = struct.Struct("<BQQI")

    def __init__(self, worker_id: int = 0, capacity: int = 65536):
        lib = get_lib(wait=True)
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        rc = lib.dyn_kv_init(worker_id, capacity)
        if rc != 0:
            raise RuntimeError(f"dyn_kv_init failed: {rc}")
        self._buf = ctypes.create_string_buffer(1 << 20)

    def drain(self) -> List["KvCacheEvent"]:
        from .llm.kv_router.protocols import (
            KvCacheEvent,
            KvCacheStoredBlockData,
        )

        n = self._lib.dyn_kv_drain(self._buf, len(self._buf))
        events: List[KvCacheEvent] = []
        data = self._buf.raw[:n]
        off = 0
        while off < len(data):
            etype, event_id, parent, count = self._HEADER.unpack_from(data, off)
            off += self._HEADER.size
            pairs = [
                struct.unpack_from("<QQ", data, off + 16 * i) for i in range(count)
            ]
            off += 16 * count
            if etype == 1:
                events.append(
                    KvCacheEvent.stored(
                        event_id,
                        parent if parent != 0 else None,
                        [KvCacheStoredBlockData(s, t) for s, t in pairs],
                    )
                )
            elif etype == 2:
                events.append(KvCacheEvent.removed(event_id, [s for s, _ in pairs]))
            else:
                events.append(KvCacheEvent(event_id, None))
        return events

    @property
    def dropped(self) -> int:
        return self._lib.dyn_kv_dropped()

    def close(self) -> None:
        self._lib.dyn_kv_shutdown()
