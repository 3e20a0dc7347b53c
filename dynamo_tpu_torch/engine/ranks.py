"""A node's ranks: start them, join the process group, wire the step plane.

The JAX package runs one controller per host over all of that host's
devices; the port runs one process per rank (parallel/).  A node's local
rank 0 starts its other local ranks as children running ``python -m
dynamo_tpu_torch.cli __rank__ <local rank> <its pid> <the same run
arguments>``; each joins the group, builds the same engine and replays the
leader's step plane (engine/multihost.py) until it closes.  Global rank 0
serves and publishes every dispatch.

``start_ranks`` is the one entry: ``run --tp/--dp/--ep/--sp/--nnodes``
(cli.py) and the SDK's ``TorchWorker`` at ``tp`` > 1 both boot through it;
``run_rank`` is the started child's side.
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
from typing import Any, Callable, Optional, Tuple

# argv[0] of a node's other local ranks, then the local rank and the
# starting pid: each runs the same command line as a follower of the step
# plane.
RANK_ROLE = "__rank__"


def mesh_config(args):
    """The ``(dp, ep, sp, tp)`` grid of a ``run`` command line."""
    from ..parallel.mesh import MeshConfig

    return MeshConfig(dp=getattr(args, "dp", 1), tp=getattr(args, "tp", 1),
                      ep=getattr(args, "ep", 1), sp=getattr(args, "sp", 1))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def die_with_parent(parent: int) -> None:
    """In a started rank, first thing: SIGTERM when the starting process
    ``parent`` dies (Linux ``PR_SET_PDEATHSIG``), so no rank outlives its
    node's rank 0 holding card memory; exit at once if it already has."""
    import ctypes

    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGTERM)
    except OSError:
        pass
    if os.getppid() != parent:
        raise SystemExit(f"rank: the process that started it ({parent}) has exited")


class NodeRanks:
    """This node's ranks as its local rank 0 sees them: the process group
    state, the started local ranks, and the step plane's address."""

    def __init__(self, state, children, step_host: str, step_port: int):
        self.state = state
        self.children = children
        self.step_host = step_host
        self.step_port = step_port

    async def guard(self, coro):
        """Await ``coro``, failing as soon as a started rank exits."""
        task = asyncio.ensure_future(coro)
        try:
            while True:
                done, _ = await asyncio.wait({task}, timeout=0.5)
                if done:
                    return task.result()
                for i, p in enumerate(self.children, 1):
                    if p.poll() is not None:
                        raise SystemExit(f"rank {i} of this node exited with {p.returncode}")
        finally:
            task.cancel()

    async def stop(self, timeout: float = 60.0) -> None:
        """Wait for the started ranks (they exit when the leader's step
        plane closes), killing any still running after ``timeout``; leave
        the process group."""
        from ..parallel.distributed import shutdown_multihost

        for p in self.children:
            try:
                await asyncio.to_thread(p.wait, timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                await asyncio.to_thread(p.wait)
        shutdown_multihost()

    async def kill(self) -> None:
        """Kill the started ranks at once and leave the process group."""
        for p in self.children:
            p.kill()
        await self.stop()


def _init_rank(args, local_rank: int):
    """Bring this process into the process group as local rank
    ``local_rank`` of node ``--node-rank``, on its device."""
    import torch

    from ..parallel.distributed import MultiHostConfig, init_multihost, rank_devices

    mesh_cfg = mesh_config(args)
    local = mesh_cfg.num_devices // args.nnodes
    cpu = getattr(args, "device", None) == "cpu" or bool(args.cpu_devices)
    dev = rank_devices(local, cpu)[local_rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    args.device = str(dev)
    cfg = MultiHostConfig(coordinator=args.coordinator, nnodes=args.nnodes,
                          node_rank=args.node_rank)
    return init_multihost(cfg, mesh_cfg, local_rank, dev)


async def _join(args) -> NodeRanks:
    """Start this node's other local ranks as children running the same
    command, and join the process group as local rank 0.  One node without
    ``--coordinator`` picks free local ports for the store and the step
    plane and, with ``DYN_STEP_TOKEN`` unset, a random token its ranks
    share."""
    import secrets

    from ..parallel.mesh import make_mesh

    if args.out != "torch":
        raise SystemExit(f"--tp/--dp/--ep/--sp/--nnodes need out=torch, not out={args.out}")
    mesh_cfg = mesh_config(args)
    world = mesh_cfg.num_devices
    if world % args.nnodes:
        raise SystemExit(f"{world} ranks do not split over --nnodes {args.nnodes}")
    if args.cpu_devices:
        # The JAX error of a mesh larger than the virtual CPU devices.
        import torch

        make_mesh(mesh_cfg, [torch.device("cpu")] * (args.cpu_devices * args.nnodes))
    if args.nnodes > 1 and not args.coordinator:
        raise SystemExit("multi-host run needs --coordinator host:port")
    arch = getattr(args, "arch", None) or (
        None if getattr(args, "checkpoint", None) or getattr(args, "model_config", None)
        else "debug-tiny")  # build_torch_engine's default
    if arch:
        from ..models.config import get_config
        from ..parallel.mesh import check_tp

        try:
            mc = get_config(arch)
        except (KeyError, ValueError):
            mc = None  # resolved by the engine (a checkpoint's own config)
        if mc is not None:
            check_tp(mc.num_kv_heads, args.tp)  # before any rank starts
    extra = []
    if not args.coordinator:
        args.coordinator = f"127.0.0.1:{_free_port()}"
        args.step_port = _free_port()
        extra = ["--coordinator", args.coordinator, "--step-port", str(args.step_port)]
        os.environ.setdefault("DYN_STEP_TOKEN", secrets.token_hex(16))
    children = []
    for i in range(1, world // args.nnodes):
        p = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", RANK_ROLE, str(i), str(os.getpid()),
             *args.run_argv, *extra],
            stdout=subprocess.DEVNULL)
        print(f"rank {args.node_rank * (world // args.nnodes) + i} started (pid {p.pid})",
              flush=True)
        children.append(p)
    ranks = NodeRanks(None, children, args.coordinator.rsplit(":", 1)[0], args.step_port)
    try:
        ranks.state = await ranks.guard(asyncio.to_thread(_init_rank, args, 0))
    except BaseException:
        for p in children:
            p.kill()
        raise
    print(f"parallel: {ranks.state.describe()}", flush=True)
    return ranks


async def _attach_step_plane(engine, args, ranks: NodeRanks) -> None:
    """The leader's step plane: bind the coordinator's interface (the
    frames are pickled, so exposure stays in the deployment's trust
    domain); a name that is not locally bindable, or bound where the
    followers cannot reach, falls back to 0.0.0.0, which requires
    ``DYN_STEP_TOKEN``."""
    from .multihost import StepPublisher

    n = ranks.state.size - 1
    first = StepPublisher(ranks.step_host, args.step_port, n)
    try:
        publisher = await ranks.guard(first.start(timeout=600.0 if args.nnodes == 1 else 60.0))
    except (OSError, asyncio.TimeoutError):
        if args.nnodes == 1:
            raise
        # abort, not close: a 'close' frame would make a connected follower
        # exit for good instead of reconnecting to the rebound publisher.
        await first.abort()
        print(f"step plane: cannot serve followers on {ranks.step_host}, falling back to "
              "0.0.0.0 (firewall the port; requires DYN_STEP_TOKEN)", flush=True)
        publisher = await ranks.guard(StepPublisher("0.0.0.0", args.step_port, n).start())
    engine.attach_publisher(publisher)


async def start_ranks(args, build: Callable[[Any], Any]) -> Tuple[Optional[Any], NodeRanks]:
    """Boot this node's ranks for the ``run`` command line ``args``: start
    the other local ranks, join the group as local rank 0, and build the
    engine with ``build(args)`` off the event loop (failing as soon as a
    started rank exits).  On the leader's node the engine gets its step
    plane publisher and ``(engine, ranks)`` is returned; the caller serves
    it and ends with ``ranks.stop()`` after closing it.  On another node
    this process replays the leader until it closes, stops the node's
    ranks, and returns ``(None, ranks)``."""
    from .multihost import follower_serve

    ranks = await _join(args)
    try:
        engine = await ranks.guard(asyncio.to_thread(build, args))
    except BaseException:
        await ranks.kill()
        raise
    if not ranks.state.is_leader:
        leader = f"{ranks.step_host}:{args.step_port}"
        print(f"follower node {args.node_rank}/{args.nnodes} replaying {leader}", flush=True)
        try:
            await ranks.guard(follower_serve(engine, leader, timeout=600.0))
        finally:
            await engine.close()
            await ranks.stop()
        return None, ranks
    try:
        await _attach_step_plane(engine, args, ranks)
    except BaseException:
        await engine.close()
        await ranks.kill()
        raise
    return engine, ranks


async def run_rank(local_rank: int, args) -> None:
    """A started rank: join the group, build the same engine, replay the
    leader's step plane until it closes."""
    from ..parallel.distributed import shutdown_multihost
    from . import build_torch_engine
    from .multihost import follower_serve

    _init_rank(args, local_rank)
    engine = build_torch_engine(args)
    try:
        await follower_serve(engine, f"{args.coordinator.rsplit(':', 1)[0]}:{args.step_port}",
                             timeout=600.0)
    finally:
        await engine.close()
        shutdown_multihost()
