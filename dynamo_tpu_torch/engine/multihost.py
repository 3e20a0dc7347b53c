"""Leader→follower dispatch plane of the port's ranks.

The JAX package's ``engine/multihost.py``, copied (it is host code): every
rank of a mesh must enqueue the same device programs, whose collectives
meet, in the same order.  The leader (global rank 0) runs the whole serving
stack — HTTP frontend, router, scheduler, KV manager; every other rank,
on this node or another, runs ``follower_serve``, which replays the
leader's dispatch stream: each frame carries only small host metadata
(ragged batch arrays, sampling arrays, page ids); params and KV pages
already live on every rank as its slices.

Reference counterpart: the vLLM Ray leader/follower processes and sglang's
``nnodes/node_rank/dist_init_addr`` bootstrap.  Like those, this is a
trusted intra-deployment plane (the trust domain of the process group's
own sockets), so frames are pickled with length framing; ``DYN_STEP_TOKEN``
authenticates a follower at accept time, and a wildcard bind without it is
refused.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import struct
from typing import Any, Optional, Tuple

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")


def _hello_frame() -> bytes:
    """Fixed-size authentication hello: magic + SHA-256 of DYN_STEP_TOKEN.

    Frames after the hello are pickled, so an attacker reaching the port
    would get code execution on the leader — the port must be firewalled to
    the deployment's trust domain, and setting DYN_STEP_TOKEN on every node
    additionally rejects unauthenticated connections at accept time.  The
    hello itself is a raw-bytes compare: nothing from an unauthenticated
    peer is ever unpickled."""
    import hashlib

    token = os.environ.get("DYN_STEP_TOKEN", "")
    return b"DYNSTEP1" + hashlib.sha256(token.encode()).digest()


async def _send(writer: asyncio.StreamWriter, obj: Any) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    writer.write(_LEN.pack(len(blob)) + blob)
    await writer.drain()


async def _recv(reader: asyncio.StreamReader) -> Any:
    head = await reader.readexactly(_LEN.size)
    blob = await reader.readexactly(_LEN.unpack(head)[0])
    return pickle.loads(blob)


class StepPublisher:
    """Leader side: accepts one connection per follower, then broadcasts
    every dispatch in order.  ``publish`` completes only after the frame is
    flushed to every follower, so stream order == dispatch order."""

    def __init__(self, host: str, port: int, num_followers: int):
        self.host, self.port = host, port
        self.num_followers = num_followers
        self._writers: list = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._connected = asyncio.Event()

    async def start(self, timeout: float = 120.0) -> "StepPublisher":
        if not os.environ.get("DYN_STEP_TOKEN"):
            # Post-hello frames are unpickled (code execution); with no
            # token the hello is the well-known sha256("") ANY peer can
            # send.  Refuse the wildcard bind outright; on a specific
            # interface warn loudly.
            if self.host in ("0.0.0.0", "::"):
                raise RuntimeError(
                    "step plane: refusing to bind a wildcard address with "
                    "no DYN_STEP_TOKEN set — any peer reaching the port "
                    "would get pickle-level code execution on the leader. "
                    "Set DYN_STEP_TOKEN on every node (or bind a private "
                    "interface)."
                )
            logger.warning(
                "step plane: DYN_STEP_TOKEN is unset — any peer that can "
                "reach %s:%d is trusted with pickled frames; set the token "
                "on every node",
                self.host, self.port,
            )
        expect = _hello_frame()

        async def on_conn(reader, writer):
            # The hello is a FIXED-SIZE raw-bytes compare, checked before
            # anything from this peer is unpickled; a wrong/missing token is
            # dropped before it ever counts toward the follower quorum.
            import hmac

            try:
                hello = await asyncio.wait_for(
                    reader.readexactly(len(expect)), 30.0
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                writer.close()
                return
            if not hmac.compare_digest(hello, expect):
                logger.warning("step plane: rejecting unauthenticated peer")
                writer.close()
                return
            self._writers.append((reader, writer))
            logger.info(
                "step follower %d/%d connected",
                len(self._writers),
                self.num_followers,
            )
            if len(self._writers) >= self.num_followers:
                self._connected.set()

        self._server = await asyncio.start_server(
            on_conn, host=self.host, port=self.port
        )
        if self.num_followers == 0:
            self._connected.set()
        await asyncio.wait_for(self._connected.wait(), timeout)
        return self

    async def publish(self, kind: str, payload: Tuple = ()) -> None:
        # One serialization, concurrent drains: this sits in the dispatch
        # hot path, once per device step.
        blob = pickle.dumps((kind, payload), protocol=pickle.HIGHEST_PROTOCOL)
        frame = _LEN.pack(len(blob)) + blob
        for _, writer in self._writers:
            writer.write(frame)
        await asyncio.gather(*(w.drain() for _, w in self._writers))

    async def close(self) -> None:
        try:
            await self.publish("close")
        except asyncio.CancelledError:
            raise
        except Exception:
            pass
        await self.abort()

    async def abort(self) -> None:
        """Tear down WITHOUT the 'close' broadcast: connections just drop.
        Used when the leader rebinds (cli step-plane fallback) — a follower
        that received no step yet treats the drop as transient and
        reconnects (follower_serve), whereas a 'close' frame would make it
        exit for good and the rebound publisher could never reach quorum."""
        for _, writer in self._writers:
            writer.close()
        self._writers.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


async def follower_serve(
    engine, leader: str, *, retry_s: float = 0.5, timeout: float = 120.0
) -> None:
    """Run this process as a dispatch follower of ``leader`` ("host:port").

    ``engine`` is a TorchEngine built with the SAME EngineConfig (and params
    source) as the leader's, on this rank's slice of the mesh — identical
    seeds or checkpoints give identical slices, so replaying the dispatch
    stream keeps every rank's collectives in lockstep.  Returns when the
    leader closes.
    """
    host, port = leader.rsplit(":", 1)
    deadline = asyncio.get_event_loop().time() + timeout
    while True:  # outer: reconnect while no step has been replayed yet
        while True:
            try:
                reader, writer = await asyncio.open_connection(host, int(port))
                break
            except OSError:
                if asyncio.get_event_loop().time() > deadline:
                    raise
                await asyncio.sleep(retry_s)
        writer.write(_hello_frame())
        await writer.drain()
        logger.info("connected to step leader %s", leader)
        replayed = 0
        try:
            while True:
                kind, payload = await _recv(reader)
                if kind == "close":
                    return
                await engine.mirror_step(kind, payload)
                replayed += 1
        except (asyncio.IncompleteReadError, ConnectionError):
            if replayed:
                # Mid-stream loss after state was applied: resuming on a
                # new connection would break the lockstep — fatal.
                raise
            if asyncio.get_event_loop().time() > deadline:
                raise
            # Dropped before any dispatch (e.g. the leader rebound its
            # step plane to another interface): safe to reconnect.
            logger.info("step leader dropped pre-stream; reconnecting")
            await asyncio.sleep(retry_s)
        finally:
            writer.close()
