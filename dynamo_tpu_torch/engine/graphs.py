"""Captured device programs: the port's counterpart of ``jax.jit`` and its
executable cache.

The JAX engine dispatches each unified step and each fused decode chunk as
ONE compiled XLA executable, cached per shape.  Here each of the engine's
two programs (``step``, ``multi``) is a ``Program`` holding one
``torch.cuda.CUDAGraph`` per key, captured the first time the key is seen
(as ``jax.jit`` compiles on first call, or ahead of time by
``TorchEngine.warmup``) and replayed after that.  A key holds everything
that changes the launched work: the token bucket, the sampler's host flags,
the carry form.  Routing is by device only, as for the kernels: on CUDA
every call replays a graph, and a capture or replay that fails raises; on
the CPU the same keys are recorded and the function runs eagerly, so the
CPU tests cover the keying.

A graph reads fixed addresses and writes fixed addresses on every replay:

- Its host inputs (numpy arrays) are packed into one pinned staging buffer
  (``Staging``, a ring of slots, each rewritten only once the copy that
  read it last has completed) and moved with ONE ``non_blocking`` copy
  into the graph's static input arena, whose typed views the captured
  function reads (``Layout``).  Device inputs (a chained carry) are copied
  into static tensors on the stream before the replay.
- Its outputs are static tensors overwritten by the next replay of any
  graph of the engine (they share one memory pool).  A caller therefore
  enqueues every use of them (the device→host copy into ``FetchRing``, the
  carry copy) before it dispatches anything else; stream order protects
  them, a host-side copy would not.

Capturing: the function runs once eagerly on the capture stream first (the
usual warm-up: kernels are built and loaded, and the prefill kernel's
per-stream scratch and cuBLAS's workspaces are allocated outside the
capture), then is captured on that stream in ``thread_local`` mode, so
fetch threads waiting on events elsewhere do not break it.  The graphs bake
in the addresses of the weights and the KV pages: nothing may reallocate
them while the graphs live, and ``close()`` drops them.

Kernel launch counts: a wrapper counts its Python calls, so a capture
counts once however often its graph runs.  Each graph records how many
launches of each hand-written kernel it captured (and takes them off the
totals: a capture launches nothing), and each replay adds them.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.decode_attention import decode_attention_cuda
from ..ops.prefill_attention import prefill_attention_cuda

ALIGN = 64  # byte alignment of every field in a staging buffer / arena

_TORCH = {
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.float32): torch.float32,
}

# The hand-written kernels' wrappers, whose ``launches`` counters replays
# advance.
KERNELS = {"decode_attention": decode_attention_cuda, "prefill_attention": prefill_attention_cuda}


def kernel_launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


class Layout:
    """Where each host input of one call lies in a flat byte buffer: the
    fields in the given order, each at an ``ALIGN``-byte offset."""

    def __init__(self, arrays: Mapping[str, np.ndarray]):
        fields = []
        off = 0
        for name, a in arrays.items():
            dt = np.dtype(a.dtype)
            if dt not in _TORCH:
                raise TypeError(f"input {name!r}: dtype {dt} cannot be staged")
            nbytes = int(np.prod(a.shape, dtype=np.int64)) * dt.itemsize
            fields.append((name, tuple(a.shape), dt, off, nbytes))
            off += -(-max(nbytes, 1) // ALIGN) * ALIGN
        self.fields = tuple(fields)
        self.nbytes = max(off, ALIGN)
        self.signature = tuple((n, s, d.str) for n, s, d, _, _ in fields)

    def pack(self, arrays: Mapping[str, np.ndarray], buf: np.ndarray) -> None:
        """Write ``arrays`` into ``buf`` (a uint8 array of >= nbytes)."""
        for name, _, dt, off, nbytes in self.fields:
            a = np.ascontiguousarray(arrays[name], dtype=dt)
            buf[off: off + nbytes] = a.reshape(-1).view(np.uint8)

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Typed views of the fields in ``buf`` (a uint8 tensor)."""
        return {
            name: buf[off: off + nbytes].view(_TORCH[dt]).view(shape)
            for name, shape, dt, off, nbytes in self.fields
        }


class Staging:
    """Pinned host buffers that the host→device input copies read from.
    Slots are used in turn; a slot is rewritten only after the event
    recorded behind the copy that last read it has completed."""

    def __init__(self, slots: int = 4):
        self._bufs: List[Optional[torch.Tensor]] = [None] * slots
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def copy_in(self, layout: Layout, arrays: Mapping[str, np.ndarray], dst: torch.Tensor) -> None:
        """Pack ``arrays`` into a slot and enqueue ONE non_blocking copy of
        it into ``dst`` (a device uint8 arena of ``layout.nbytes``)."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        ev = self._events[i]
        if ev is None:
            ev = self._events[i] = torch.cuda.Event()
        else:
            ev.synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() < layout.nbytes:
            buf = self._bufs[i] = torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=True)
        layout.pack(arrays, buf.numpy())
        dst.copy_(buf[: layout.nbytes], non_blocking=True)
        ev.record()


class HostFetch:
    """A started device→host copy of a dispatch's outputs; ``result()``
    (on a worker thread) waits for it and returns numpy copies."""

    def __init__(self, ring: Optional["FetchRing"], slot: Any, arrays: Sequence[Any]):
        self._ring = ring
        self._slot = slot
        self._arrays = arrays

    def result(self) -> Tuple[Optional[np.ndarray], ...]:
        if self._ring is None:
            return tuple(self._arrays)
        buf, ev = self._slot
        ev.synchronize()
        out = tuple(None if v is None else v.numpy().copy() for v in self._arrays)
        self._ring.release(self._slot)
        return out


class FetchRing:
    """Pinned host buffers for the deferred device→host copies of sampled
    outputs: one slot per fetch in flight, back in the ring once harvested.
    ``slots`` is the number in flight the engine can reach (pipeline depth
    plus the deferred fetches outstanding); a slot is added if more are ever
    needed.  On the CPU a fetch is a copy made at once."""

    def __init__(self, device: torch.device, slots: int):
        self._cuda = device.type == "cuda"
        self._lock = threading.Lock()
        self._free: List[Tuple[Optional[torch.Tensor], Any]] = [(None, None)] * slots

    def start(self, tensors: Sequence[Optional[torch.Tensor]]) -> HostFetch:
        if not self._cuda:
            return HostFetch(None, None, [None if t is None else t.numpy().copy() for t in tensors])
        with self._lock:
            buf, ev = self._free.pop() if self._free else (None, None)
        nbytes = sum(-(-t.numel() * t.element_size() // ALIGN) * ALIGN
                     for t in tensors if t is not None)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, ALIGN), dtype=torch.uint8, pin_memory=True)
        if ev is None:
            ev = torch.cuda.Event()
        views, off = [], 0
        for t in tensors:
            if t is None:
                views.append(None)
                continue
            n = t.numel() * t.element_size()
            v = buf[off: off + n].view(t.dtype).view(t.shape)
            v.copy_(t, non_blocking=True)
            views.append(v)
            off += -(-n // ALIGN) * ALIGN
        ev.record()
        return HostFetch(self, (buf, ev), views)

    def release(self, slot) -> None:
        with self._lock:
            self._free.append(slot)


class _Graph(NamedTuple):
    graph: Any  # torch.cuda.CUDAGraph
    arena: torch.Tensor  # static host-input arena (uint8)
    dev: Dict[str, torch.Tensor]  # static device inputs
    outputs: Any
    launches: Dict[str, int]  # kernel launches captured in the graph
    signature: Tuple


class Program:
    """One device program (``step`` or ``multi``) and its graphs by key."""

    def __init__(self, name: str, owner: "DevicePrograms"):
        self.name = name
        self._owner = owner
        self._graphs: Dict[Any, _Graph] = {}
        self._signatures: Dict[Any, Tuple] = {}

    def cache_size(self) -> int:
        """Distinct keys seen: graphs captured on CUDA, keys run on the CPU."""
        return len(self._signatures)

    def captured_launches(self) -> Dict[Any, Dict[str, int]]:
        """Kernel launches held by each captured graph, by key."""
        return {k: dict(g.launches) for k, g in self._graphs.items()}

    def __call__(
        self,
        key: Any,
        fn: Callable[[Dict[str, torch.Tensor]], Any],
        host: Mapping[str, np.ndarray],
        dev: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Any:
        """Run ``fn`` on ``host`` (numpy arrays) and ``dev`` (device
        tensors), both by name, as the program for ``key``: on CUDA by
        replaying its graph (captured now if the key is new), on the CPU
        eagerly.  Returns ``fn``'s outputs: on CUDA the graph's static
        outputs, valid until the next replay of any graph."""
        owner = self._owner
        if owner.closed:
            raise RuntimeError(f"{self.name}: the engine's programs are closed")
        dev = dict(dev or {})
        layout = Layout(host)
        signature = (layout.signature,
                     tuple((k, tuple(t.shape), t.dtype) for k, t in sorted(dev.items())))
        seen = self._signatures.get(key)
        if seen is not None and seen != signature:
            raise RuntimeError(
                f"{self.name}: key {key!r} was first called with other inputs; a "
                "key must hold everything that changes the program")
        if not owner.cuda:
            self._signatures[key] = signature
            arena = torch.empty(layout.nbytes, dtype=torch.uint8)
            layout.pack(host, arena.numpy())
            return fn({**layout.views(arena), **dev})
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(key, fn, layout, host, dev, signature)
        self._load(g, layout, host, dev)
        g.graph.replay()
        for name, n in g.launches.items():
            KERNELS[name].launches += n
        return g.outputs

    def _load(self, g: _Graph, layout: Layout, host, dev) -> None:
        self._owner.staging.copy_in(layout, host, g.arena)
        for k, t in dev.items():
            g.dev[k].copy_(t, non_blocking=True)

    def _capture(self, key, fn, layout, host, dev, signature) -> _Graph:
        owner = self._owner
        arena = torch.empty(layout.nbytes, dtype=torch.uint8, device=owner.device)
        dev_static = {k: torch.empty_like(t) for k, t in dev.items()}
        g = _Graph(None, arena, dev_static, None, {}, signature)
        self._load(g, layout, host, dev)
        x = {**layout.views(arena), **dev_static}
        stream = owner.capture_stream
        stream.wait_stream(torch.cuda.current_stream(owner.device))
        with torch.cuda.stream(stream):
            fn(x)  # warm-up, outside the capture (see the module notes)
        torch.cuda.current_stream(owner.device).wait_stream(stream)
        before = kernel_launches()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=owner.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                outputs = fn(x)
        finally:
            after = kernel_launches()
            for name, n in before.items():  # a capture launches nothing
                KERNELS[name].launches = n
        g = g._replace(graph=graph, outputs=outputs,
                       launches={k: after[k] - before[k] for k in before})
        self._graphs[key] = g
        self._signatures[key] = signature
        return g

    def close(self) -> None:
        for g in self._graphs.values():
            g.graph.reset()
        self._graphs.clear()
        self._signatures.clear()


class DevicePrograms:
    """The engine's programs, their shared graph memory pool and capture
    stream, and the host staging ring."""

    NAMES = ("step", "multi")

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.closed = False
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.capture_stream = torch.cuda.Stream(device) if self.cuda else None
        self.staging = Staging() if self.cuda else None
        self.step = Program("step", self)
        self.multi = Program("multi", self)

    def cache_sizes(self) -> Dict[str, int]:
        return {name: getattr(self, name).cache_size() for name in self.NAMES}

    def close(self) -> None:
        """Release every graph and the pool they share (waits for the
        device first: a replay may still be running)."""
        if self.closed:
            return
        self.closed = True
        if self.cuda:
            torch.cuda.synchronize(self.device)
        for name in self.NAMES:
            getattr(self, name).close()
        self.pool = None
