"""Process groups and collectives for the port's ranks, over
``torch.distributed``.

Port of the JAX package's ``parallel/distributed.py``.  JAX runs one
controller per host over all of that host's devices, bootstrapped by
``jax.distributed``; the port runs one process per rank (parallel/mesh.py),
and ``init_multihost`` brings this rank into the group: a ``TCPStore`` at
``coordinator`` (rank 0 hosts it), then ``init_process_group`` over it.

The backend is decided ONCE here, from the rank→device map every rank
publishes in the store:

- NCCL when every rank runs on a GPU of its own;
- gloo otherwise: CPU ranks, or ranks that share a card (NCCL refuses two
  ranks on one GPU).  Under gloo a CUDA tensor is staged through a pinned
  host buffer for every collective, in this module alone (gloo's own CUDA
  support varies by collective), and the engine runs its programs eagerly
  (engine/graphs.py: a host-staged collective cannot be captured).

It is not a fallback: an NCCL init error fails the run.

The forward's collectives go through ``AxisGroup``, one per mesh axis (or
axes) as seen from this rank: ``all_reduce`` (sum, max), ``all_gather``
and the ring ``shift`` to the next rank; the KV paths (engine/transfer.py,
engine/offload.py) ``gather`` to the group's first rank and ``scatter``
from it.  A group of one
rank returns its input, so the single-rank forward runs the same code.
``global_array`` has no counterpart: ``parallel.mesh.shard_params`` hands
each rank its slice.
"""

from __future__ import annotations

import datetime
import logging
import socket
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh, MeshConfig

logger = logging.getLogger(__name__)

_OPS = {"sum": "SUM", "max": "MAX"}


@dataclass
class MultiHostConfig:
    """--nnodes/--node-rank/--coordinator (reference: MultiNodeConfig).
    ``--cpu-devices`` acts through the rank→device map (``rank_devices``)
    and ``make_mesh``."""

    coordinator: str = ""  # host:port of the rank-0 process's store
    nnodes: int = 1
    node_rank: int = 0


class AxisGroup:
    """One collective group as seen from this rank: its ranks (global, in
    grid order), this rank's index among them, and the process group
    (None for a group of one)."""

    def __init__(self, ranks: Sequence[int], rank: int, pg=None, stage: bool = False):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.pg = pg
        self._stage = stage
        self._bufs: Dict[Tuple[torch.dtype, int], torch.Tensor] = {}

    # Pinned host buffers for the gloo staging of CUDA tensors, one per
    # dtype and size (the forward's shapes come from a few token buckets).
    def _host(self, t: torch.Tensor) -> torch.Tensor:
        key = (t.dtype, t.numel())
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        buf = buf.view(t.shape)
        buf.copy_(t)
        return buf

    def _staged(self, t: torch.Tensor) -> bool:
        return self._stage and t.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group (in place; returns ``t``)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        rop = getattr(dist.ReduceOp, _OPS[op])
        if not self._staged(t):
            dist.all_reduce(t, op=rop, group=self.pg)
            return t
        h = self._host(t.contiguous())
        dist.all_reduce(h, op=rop, group=self.pg)
        t.copy_(h)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in group order."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        if not self._staged(t):
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.pg)
            return torch.cat(parts, dim=dim)
        h = self._host(t)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h, group=self.pg)
        return torch.cat(parts, dim=dim).to(t.device)

    def gather(self, t: torch.Tensor, dim: int = 0) -> Optional[torch.Tensor]:
        """Every rank's ``t`` concatenated along ``dim`` in group order, on
        the group's first rank (on ``t``'s device); None on the others.
        Under gloo a CUDA ``t`` goes through pinned memory allocated for
        the call (the KV paths' sizes vary, so nothing is kept).  Bytes
        move, never values: the gather runs on a uint8 view (any page
        dtype, fp8 included; on the last axis each element's bytes stay
        together)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        raw = t.view(torch.uint8)
        staged = self._staged(raw)
        src = raw
        if staged:
            src = torch.empty(raw.shape, dtype=raw.dtype, pin_memory=True)
            src.copy_(raw)
        parts = [torch.empty_like(src) for _ in range(self.size)] if self.index == 0 else None
        dist.gather(src, parts, dst=self.ranks[0], group=self.pg)
        if parts is None:
            return None
        out = torch.cat(parts, dim=dim)
        if staged:
            out = out.to(t.device)
        return out.view(t.dtype)

    def scatter(self, out: torch.Tensor,
                parts: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The group's first rank's ``parts[i]`` written into ``out`` on the
        group's i-th rank, and returned.  ``parts`` is given on the first
        rank alone: one tensor a rank in group order, each of ``out``'s
        shape and dtype.  As in ``gather``, bytes move through uint8 views,
        and under gloo CUDA tensors go through pinned memory allocated for
        the call."""
        if self.size == 1:
            return out.copy_(parts[0])
        import torch.distributed as dist

        raw = out.view(torch.uint8)
        staged = self._staged(raw)
        dst = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True) if staged else raw
        src = None
        if self.index == 0:
            src = []
            for p in parts:
                p = p.contiguous().view(torch.uint8)
                if staged:
                    h = torch.empty(p.shape, dtype=torch.uint8, pin_memory=True)
                    h.copy_(p)
                    p = h
                src.append(p)
        dist.scatter(dst, src, src=self.ranks[0], group=self.pg)
        if staged:
            raw.copy_(dst)
        return out

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to the next rank of the ring and return the previous
        rank's (one ``batch_isend_irecv`` round)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        t = t.contiguous()
        staged = self._staged(t)
        src = self._host(t) if staged else t
        dst = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, nxt, group=self.pg),
               dist.P2POp(dist.irecv, dst, prv, group=self.pg)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return dst.to(t.device) if staged else dst


class ParallelState:
    """This rank's place in the mesh: its rank, device, the backend, and
    its groups over ``tp``, ``sp``, ``ep``, ``ep`` x ``tp`` (the MoE
    combine) and all ranks, and the number of nodes.  ``eager`` says
    whether the engine's programs run eagerly (gloo's host-staged
    collectives cannot be captured in a CUDA graph)."""

    def __init__(self, mesh: Mesh, rank: int, device: torch.device, backend: Optional[str],
                 groups: Dict[Tuple[str, ...], AxisGroup], nnodes: int = 1):
        self.mesh = mesh
        self.rank = rank
        self.nnodes = nnodes
        self.device = device
        self.backend = backend
        self.coords = mesh.coords(rank)
        self.tp = groups[("tp",)]
        self.sp = groups[("sp",)]
        self.ep = groups[("ep",)]
        self.ep_tp = groups[("ep", "tp")]
        self.world = groups[("dp", "ep", "sp", "tp")]

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @property
    def eager(self) -> bool:
        return self.backend == "gloo"

    @property
    def ep_index(self) -> int:
        return self.coords["ep"]

    def describe(self) -> str:
        return (f"rank {self.rank}/{self.size} on {self.device}, mesh {self.mesh.shape}, "
                f"backend {self.backend}, programs {'eager' if self.eager else 'graphs'}")


_GROUP_AXES: Tuple[Tuple[str, ...], ...] = (
    ("tp",), ("sp",), ("ep",), ("ep", "tp"), ("dp", "ep", "sp", "tp"))

_STATE: Optional[ParallelState] = None


def current() -> Optional[ParallelState]:
    """The state ``init_multihost`` set up in this process, or None."""
    return _STATE


def _device_identity(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    idx = device.index if device.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else idx}"


def choose_backend(identities: Sequence[str]) -> str:
    """NCCL when every rank has a GPU of its own, else gloo."""
    if all(i != "cpu" for i in identities) and len(set(identities)) == len(identities):
        return "nccl"
    return "gloo"


def init_multihost(cfg: MultiHostConfig, mesh_cfg: MeshConfig, local_rank: int,
                   device: torch.device, timeout_s: float = 300.0) -> ParallelState:
    """Bring this process (local rank ``local_rank`` of node
    ``cfg.node_rank``) into the group of ``mesh_cfg.num_devices`` ranks and
    return its ``ParallelState``.  Call once per process, before any
    engine is built.  Every rank creates every group, in one order."""
    global _STATE
    import torch.distributed as dist

    world = mesh_cfg.num_devices
    if world % cfg.nnodes:
        raise ValueError(f"{world} ranks do not split over {cfg.nnodes} nodes")
    local_world = world // cfg.nnodes
    rank = cfg.node_rank * local_world + local_rank
    if not cfg.coordinator:
        raise ValueError("a multi-rank run needs a coordinator host:port")
    host, port = cfg.coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world, is_master=(rank == 0), timeout=timeout)
    store.set(f"device/{rank}", _device_identity(device))
    identities = [store.get(f"device/{r}").decode() for r in range(world)]
    backend = choose_backend(identities)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store), rank=rank,
                            world_size=world, timeout=timeout, **kwargs)
    mesh = Mesh(mesh_cfg, [None] * world)
    stage = backend == "gloo"
    groups: Dict[Tuple[str, ...], AxisGroup] = {}
    for axes in _GROUP_AXES:
        for ranks in mesh.all_groups(axes):
            pg = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                groups[axes] = AxisGroup(ranks, rank, pg, stage)
    _STATE = ParallelState(mesh, rank, device, backend, groups, cfg.nnodes)
    logger.info("parallel: %s (devices %s)", _STATE.describe(), identities)
    return _STATE


def shutdown_multihost() -> None:
    """Leave the process group (the counterpart of process exit in JAX)."""
    global _STATE
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None


def rank_devices(count: int, cpu: bool) -> List[torch.device]:
    """The device of each of a node's ``count`` local ranks: the CPU, or
    ``cuda:(local_rank % device_count)``."""
    if cpu:
        return [torch.device("cpu")] * count
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("CUDA is not available; pass --device cpu (or --cpu-devices N) "
                           "to run the ranks on the CPU")
    return [torch.device("cuda", i % n) for i in range(count)]
