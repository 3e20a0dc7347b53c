"""Routed client: discovery-watching AsyncEngine with pluggable routing.

A copy of the JAX package's ``runtime/client.py``, the live-migration
splice (``_StreamGuard._splice``) included.

Reference semantics: lib/runtime/src/component/client.rs — the client watches
the instance prefix, maintains the live instance set (shrinking on lease
expiry), and routes each request Random/RoundRobin/Direct.  KV-aware routing
plugs in above this layer (the KV router picks a worker_id, then calls
``direct``).

Request resilience (SURVEY §5 failure detection, runtime/resilience.py):
lease expiry bounds how long a dead worker stays routable, but between the
crash and the TTL every pick would hit a corpse.  ``generate`` therefore
retries connect-time and before-first-token failures on OTHER instances
(bounded attempts, exponential backoff with full jitter), consults a
per-worker-address circuit breaker when picking (open breakers are skipped;
a half-open probe re-admits the worker after its reset window), and honours
the request deadline at every hop.  Once a token has streamed the request is
NOT idempotent — mid-stream failures surface to the caller untouched,
unless the stream can resume deterministically elsewhere (``_StreamGuard``).
"""

from __future__ import annotations

import asyncio
import enum
import logging
import random
import time
from typing import Any, Dict, List, Optional, Set, Tuple

logger = logging.getLogger(__name__)

from .engine import AsyncEngine, Context, ResponseStream
from .health import worker_latency
from .resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExceededError,
    RetryPolicy,
    metrics,
)
from .tracing import span as trace_span
from .transports.service import RemoteEngine, RemoteEngineError
from .transports.shard import shard_metrics


class RouterMode(enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    # KV-cache-aware routing: interpreted by the serving layer (ModelWatcher
    # builds a KvPushRouter around the client); the Client itself treats it
    # as round-robin fallback.  Reference: component/client.rs RouterMode::KV.
    KV = "kv"


class NoInstancesError(RuntimeError):
    """No live instances registered for the endpoint (HTTP edge → 503)."""

    def __init__(self, message: str, prefix: str = ""):
        super().__init__(message)
        self.prefix = prefix


def _resilience_config() -> Dict[str, Any]:
    """The layered config's `resilience` section ({} if unloadable)."""
    from .config import RuntimeConfig

    try:
        return RuntimeConfig.from_layers().resilience
    except Exception:  # noqa: BLE001 — bad config file must not kill routing
        logger.warning("could not load resilience config; using defaults",
                       exc_info=True)
        return {}


def _is_retryable(exc: BaseException) -> bool:
    """Transport/worker failures may be replayed elsewhere; app errors not."""
    if isinstance(exc, RemoteEngineError):
        return exc.retryable
    return isinstance(exc, (ConnectionError, OSError, EOFError))


class Client(AsyncEngine):
    """AsyncEngine over the live instances of one endpoint."""

    WATCH_BACKOFF_INITIAL = 0.1
    WATCH_BACKOFF_MAX = 5.0

    def __init__(
        self,
        hub,
        instance_prefix: str,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        retry_policy: Optional[RetryPolicy] = None,
        breaker_failure_threshold: Optional[int] = None,
        breaker_reset_s: Optional[float] = None,
    ):
        self.hub = hub
        self.instance_prefix = instance_prefix
        self.router_mode = router_mode
        # Unset knobs fall back to the layered config's `resilience` section
        # (DYN_RESILIENCE__RETRY_MAX_ATTEMPTS=5 etc.), then to defaults.
        cfg: Dict[str, Any] = {}
        if None in (retry_policy, breaker_failure_threshold, breaker_reset_s):
            cfg = _resilience_config()
        self.retry_policy = retry_policy or RetryPolicy.from_config(cfg)
        self.breaker_failure_threshold = (
            breaker_failure_threshold
            if breaker_failure_threshold is not None
            else int(cfg.get("breaker_failure_threshold", 3))
        )
        self.breaker_reset_s = (
            breaker_reset_s
            if breaker_reset_s is not None
            else float(cfg.get("breaker_reset_s", 5.0))
        )
        self._instances: Dict[int, Dict[str, Any]] = {}
        # One cached RemoteEngine per live instance: constructing per call
        # re-dialed TCP each time; the cache is evicted on connection failure
        # and on instance removal (it is also what the breaker keys off).
        self._engines: Dict[int, RemoteEngine] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}  # by worker address
        self._rr_index = 0
        self._watcher = None
        self._watch_task: Optional[asyncio.Task] = None
        self._ready = asyncio.Event()
        # A static client (``Client.static``) talks to one fixed address
        # with no discovery, retries or failover.
        self._static_engine: Optional[RemoteEngine] = None
        # Degraded-mode routing cache: the instance table above IS the
        # cache — picks never block on hub RTT.  While the watch is down
        # (hub/shard outage, failover window) the cache serves stale with
        # the staleness bound surfaced on /metrics; a successful resync
        # clears it.
        self._stale_since: Optional[float] = None

    @classmethod
    def static(cls, address: str, path: str) -> "Client":
        """A client of one known instance (an address and path handed over
        out of band, e.g. a disaggregated decode worker's ``kv_import``
        reply target): no hub, no discovery."""
        client = cls(hub=None, instance_prefix="")
        client._static_engine = RemoteEngine(address, path)
        client._ready.set()
        return client

    async def start(self) -> "Client":
        if self._static_engine is not None or self._watch_task is not None:
            return self
        self._watcher = await self.hub.watch_prefix(self.instance_prefix)
        self._watch_task = asyncio.create_task(self._watch_loop())
        # The hub terminates the snapshot with a sync marker; wait for it so
        # the first generate() sees every already-registered instance.
        await self._watcher.synced.wait()
        return self

    def _apply_event(self, event) -> None:
        try:
            worker_id = int(event.key.rsplit("/", 1)[-1])
        except ValueError:
            # unrelated key under the prefix; the watch must survive
            logger.warning("ignoring non-instance key %r", event.key)
            return
        try:
            if event.type == "put":
                self._instances[worker_id] = event.value
            else:
                self._instances.pop(worker_id, None)
                self._engines.pop(worker_id, None)
                self._prune_breakers()
            if self._instances:
                self._ready.set()
            else:
                self._ready.clear()
        except Exception:  # noqa: BLE001 — keep the watch alive
            logger.exception("error handling instance event %r", event)

    def _prune_breakers(self) -> None:
        """Drop breakers for addresses no live instance uses (workers churn
        through ephemeral ports; stale gauges must not accumulate)."""
        live = {info["address"] for info in self._instances.values()}
        for address in list(self._breakers):
            if address not in live:
                del self._breakers[address]
                metrics.unregister_breaker(address)

    async def _watch_loop(self) -> None:
        """Consume instance deltas; survive watcher death (not just close).

        A watcher that RAISES (hub hiccup, protocol slip) used to silently
        end this task, freezing the instance set stale forever.  Now the
        watch is re-established with exponential backoff and the instance
        set is fully re-synced from the hub KV — deletes missed during the
        outage must not leave phantom instances (mirrors the watch-restart
        shape in deploy/controller.py).
        """
        backoff = self.WATCH_BACKOFF_INITIAL
        while True:
            try:
                async for event in self._watcher:
                    backoff = self.WATCH_BACKOFF_INITIAL
                    self._apply_event(event)
                return  # watcher closed cleanly (client shutdown)
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception(
                    "instance watch for %r died; re-establishing",
                    self.instance_prefix,
                )
                if self._stale_since is None:
                    self._stale_since = time.monotonic()
                    shard_metrics.note_cache_stale(id(self), self._stale_since)
            while True:
                try:
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, self.WATCH_BACKOFF_MAX)
                    old, self._watcher = self._watcher, None
                    if old is not None:
                        try:
                            await old.aclose()
                        except asyncio.CancelledError:
                            raise
                        except Exception:  # noqa: BLE001 — dead watcher
                            pass
                    self._watcher = await self.hub.watch_prefix(
                        self.instance_prefix
                    )
                    await self._resync()
                    metrics.watch_restarts_total += 1
                    logger.info(
                        "instance watch for %r re-established (%d instances)",
                        self.instance_prefix,
                        len(self._instances),
                    )
                    break
                except asyncio.CancelledError:
                    return
                except Exception:  # noqa: BLE001 — hub still down
                    logger.warning(
                        "watch re-establish for %r failed; retrying in %.1fs",
                        self.instance_prefix,
                        backoff,
                    )

    async def _resync(self) -> None:
        """Replace the instance set with the hub's current view."""
        snapshot = await self.hub.kv_get_prefix(self.instance_prefix)
        fresh: Dict[int, Dict[str, Any]] = {}
        for key, value in snapshot.items():
            try:
                fresh[int(key.rsplit("/", 1)[-1])] = value
            except ValueError:
                continue
        for wid in set(self._engines) - set(fresh):
            self._engines.pop(wid, None)
        self._instances = fresh
        self._prune_breakers()
        self._stale_since = None
        shard_metrics.note_cache_fresh(id(self))
        if fresh:
            self._ready.set()
        else:
            self._ready.clear()

    async def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None
        if self._watcher is not None:
            await self._watcher.aclose()
        shard_metrics.note_cache_fresh(id(self))

    # -- instance access ----------------------------------------------------

    @property
    def instance_ids(self) -> List[int]:
        return list(self._instances.keys())

    def instance(self, worker_id: int) -> Optional[Dict[str, Any]]:
        return self._instances.get(worker_id)

    async def wait_for_instances(self, timeout: float = 10.0) -> None:
        try:
            await asyncio.wait_for(self._ready.wait(), timeout)
        except asyncio.TimeoutError:
            raise NoInstancesError(
                f"no instances under {self.instance_prefix!r} "
                f"after {timeout:g}s",
                prefix=self.instance_prefix,
            ) from None

    # -- routing ------------------------------------------------------------

    def _breaker(self, address: str) -> CircuitBreaker:
        breaker = self._breakers.get(address)
        if breaker is None:
            breaker = CircuitBreaker(
                key=address,
                failure_threshold=self.breaker_failure_threshold,
                reset_timeout_s=self.breaker_reset_s,
            )
            self._breakers[address] = metrics.register_breaker(breaker)
        return breaker

    def _note_pick(self) -> None:
        """Account a pick served from the local routing cache (every pick
        is — admission never blocks on hub RTT); stale hits ride through a
        hub/shard failover window on the last synced view."""
        shard_metrics.routing_cache_hits_total += 1
        if self._stale_since is not None:
            shard_metrics.routing_cache_stale_hits_total += 1

    def _pick(
        self,
        worker_id: Optional[int],
        mode: RouterMode,
        exclude: Set[int] = frozenset(),
    ) -> Tuple[int, Dict[str, Any]]:
        if not self._instances:
            raise NoInstancesError(
                f"no instances under {self.instance_prefix!r}",
                prefix=self.instance_prefix,
            )
        if worker_id is not None:
            info = self._instances.get(worker_id)
            if info is None:
                raise NoInstancesError(
                    f"instance {worker_id} not found",
                    prefix=self.instance_prefix,
                )
            self._note_pick()
            return worker_id, info
        ids = sorted(self._instances.keys())
        candidates = [i for i in ids if i not in exclude] or ids
        # Skip instances whose breaker is open — unless that empties the
        # pool, in which case trying a sick worker beats certain failure.
        healthy = [
            i
            for i in candidates
            if self._breaker(self._instances[i]["address"]).can_attempt()
        ]
        if healthy:
            candidates = healthy
        if mode == RouterMode.RANDOM:
            wid = random.choice(candidates)
        else:
            # ROUND_ROBIN (and KV fallback when no overlap decision was made)
            self._rr_index += 1
            wid = candidates[self._rr_index % len(candidates)]
        self._note_pick()
        return wid, self._instances[wid]

    def _engine_for(self, worker_id: int, info: Dict[str, Any]) -> RemoteEngine:
        engine = self._engines.get(worker_id)
        if engine is None or engine.address != info["address"]:
            engine = RemoteEngine(info["address"], info["path"])
            self._engines[worker_id] = engine
        return engine

    def _evict(self, worker_id: int) -> None:
        self._engines.pop(worker_id, None)

    async def _acquire(
        self,
        request: Context,
        worker_id: Optional[int],
        mode: RouterMode,
        state: Dict[str, Any],
        deadline: Optional[Deadline],
    ) -> Tuple[int, str, ResponseStream]:
        """Open a response stream, retrying connect/prologue failures on
        other instances.  ``state`` ({"attempt", "tried"}) is shared with the
        first-token failover wrapper so the TOTAL attempt budget is bounded
        across both phases."""
        # Route span (runtime/tracing.py): pick + connect, with every retry
        # / failover / breaker-open recorded as span events — the routed
        # client is the one vantage point that sees them all.  NOOP (zero
        # cost) for untraced requests.
        rspan = trace_span(
            getattr(request.ctx, "trace", None), "client.route", "client"
        )
        try:
            return await self._acquire_routed(
                request, worker_id, mode, state, deadline, rspan
            )
        finally:
            rspan.finish()

    async def _acquire_routed(
        self,
        request: Context,
        worker_id: Optional[int],
        mode: RouterMode,
        state: Dict[str, Any],
        deadline: Optional[Deadline],
        rspan,
    ) -> Tuple[int, str, ResponseStream]:
        policy = self.retry_policy
        while True:
            if deadline is not None and deadline.expired:
                metrics.deadline_exceeded_total += 1
                raise DeadlineExceededError("deadline exceeded (routing)")
            try:
                wid, info = self._pick(worker_id, mode, exclude=state["tried"])
            except NoInstancesError:
                if worker_id is not None:
                    raise  # direct routing: the chosen worker is simply gone
                # Pool TRANSIENTLY empty — e.g. a hub restart resynced the
                # instance watch before the workers' lease monitors re-put
                # their registrations.  The fleet is still serving, so wait
                # for discovery to repopulate within the retry budget
                # instead of failing a survivable request (a hub crash
                # pauses traffic, it doesn't kill it).
                state["attempt"] += 1
                metrics.retries_total += 1
                rspan.event("no_instances", attempt=state["attempt"])
                if state["attempt"] >= policy.max_attempts:
                    metrics.retries_exhausted_total += 1
                    raise
                delay = max(policy.backoff(state["attempt"]), 0.1)
                if deadline is not None:
                    delay = min(delay, max(deadline.remaining(), 0.0))
                logger.warning(
                    "request %s: no live instances under %r; waiting %.2fs "
                    "for discovery (attempt %d/%d)",
                    request.id, self.instance_prefix, delay,
                    state["attempt"], policy.max_attempts,
                )
                try:
                    await asyncio.wait_for(self._ready.wait(), delay)
                except asyncio.TimeoutError:
                    pass
                # Membership changed wholesale: prior exclusions are stale.
                state["tried"] = set()
                continue
            address = info["address"]
            breaker = self._breaker(address)
            breaker.on_attempt()
            engine = self._engine_for(wid, info)
            try:
                if deadline is not None:
                    stream = await deadline.bound(
                        engine.generate(request), "connect"
                    )
                else:
                    stream = await engine.generate(request)
            except DeadlineExceededError:
                # An exhausted budget is the request's problem, not proof the
                # worker is sick — don't poison its breaker, but do hand back
                # the half-open probe slot if this attempt was the probe.
                breaker.release_probe()
                metrics.deadline_exceeded_total += 1
                raise
            except asyncio.CancelledError:
                breaker.release_probe()
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                if not _is_retryable(e):
                    breaker.release_probe()
                    raise
                breaker.record_failure()
                rspan.event(
                    "retry", worker=wid, breaker=str(breaker.state.value),
                )
                self._evict(wid)
                if worker_id is not None:
                    # Direct routing (the KV router chose): no failover
                    # target exists, so this is not a retry — don't let the
                    # retry counters suggest otherwise.
                    raise
                state["tried"].add(wid)
                state["attempt"] += 1
                metrics.retries_total += 1
                if state["attempt"] >= policy.max_attempts:
                    metrics.retries_exhausted_total += 1
                    raise
                logger.warning(
                    "request %s: worker %s failed (%s); failing over "
                    "(attempt %d/%d)",
                    request.id,
                    wid,
                    e,
                    state["attempt"],
                    policy.max_attempts,
                )
                delay = policy.backoff(state["attempt"])
                if deadline is not None:
                    delay = min(delay, max(deadline.remaining(), 0.0))
                if delay > 0:
                    await asyncio.sleep(delay)
                if state["tried"] >= set(self._instances):
                    # full lap: every live instance failed once — allow
                    # re-dials (the next lap rides the backoff ladder)
                    state["tried"] = set()
                continue
            breaker.record_success()
            rspan.set(worker=wid, address=address)
            return wid, address, stream

    async def generate(
        self,
        request: Context,
        worker_id: Optional[int] = None,
        mode: Optional[RouterMode] = None,
    ) -> ResponseStream:
        if self._static_engine is not None:
            return await self._static_engine.generate(request)
        mode = mode if mode is not None else self.router_mode
        deadline = getattr(request.ctx, "deadline", None)
        state: Dict[str, Any] = {"attempt": 0, "tried": set()}
        wid, address, stream = await self._acquire(
            request, worker_id, mode, state, deadline
        )
        # Every routed stream gets the guard: it consumes live-migration
        # ``migrated`` markers (splicing the target's continuation into one
        # client-visible stream) and resumes seeded streams after mid-flight
        # crashes.  Direct routing (the KV router already chose a worker)
        # keeps its no-failover contract for pre-first-token failures —
        # allow_failover gates only those; the migration splice and seeded
        # resume are deterministic continuations, safe on any instance.
        return ResponseStream(
            _StreamGuard(self, request, mode, state, deadline,
                         wid, address, stream,
                         allow_failover=worker_id is None),
            request.ctx,
        )

    # Convenience verbs mirroring the reference bindings (_core.pyi):
    async def random(self, request: Context) -> ResponseStream:
        return await self.generate(request, mode=RouterMode.RANDOM)

    async def round_robin(self, request: Context) -> ResponseStream:
        return await self.generate(request, mode=RouterMode.ROUND_ROBIN)

    async def direct(self, request: Context, worker_id: int) -> ResponseStream:
        return await self.generate(request, worker_id=worker_id)


class _StreamGuard:
    """Stream wrapper: failover, live-migration splice, seeded resume.

    Three distinct recovery surfaces, in order of when they can fire:

    - **Before the first token** a worker that accepted the prologue can
      still die; nothing user-visible has happened, so the request is
      safely replayable on another instance (bounded attempts shared with
      the connect phase).  Disabled for direct (KV-router-chosen) routing.
    - **A ``migrated`` item** mid-stream is the source worker's cutover
      marker (llm/migration): it carries a self-contained resume request
      plus the target's address.  The guard re-dispatches there (falling
      back to any instance — the resume request is deterministic) and
      splices the continuation in; the caller sees one uninterrupted,
      token-identical stream and never observes the marker.
    - **After the first token** a crash is recoverable only when replaying
      cannot change what the caller already saw: the resume request needs
      deterministic continuation.  Explicit-seed requests always have it;
      greedy (temperature-0) streams are seed-independent and resume
      seedless; for UNSEEDED SAMPLED requests the engine resolves a seed
      at admission and stamps it on the first stream item
      (``resolved_seed`` — engine.py generate), which the guard captures
      here.  So every stream that has delivered a token is resumable; only
      an unseeded sampled stream from a pre-QoS engine (no stamp seen)
      still propagates the error untouched.

    The deadline bounds the wait for every item and every re-dispatch.
    """

    def __init__(
        self,
        client: Client,
        request: Context,
        mode: RouterMode,
        state: Dict[str, Any],
        deadline: Optional[Deadline],
        wid: int,
        address: str,
        stream: ResponseStream,
        allow_failover: bool = True,
    ):
        self._client = client
        self._request = request
        self._mode = mode
        self._state = state
        self._deadline = deadline
        self._wid = wid
        self._address = address
        self._stream = stream
        self._allow_failover = allow_failover
        self._got_first = False
        # Per-worker latency observations (runtime/health.py): the routed
        # client is the one vantage point that sees queueing + transport +
        # engine together, so the straggler scan feeds off these.
        self._t_dispatched = time.monotonic()
        self._t_last_item: Optional[float] = None
        # Resume bookkeeping: the fed-token stream (base prompt + every
        # delivered token) and the original prompt length.  Only tracked
        # for token-shaped requests (dict with token_ids) — other payloads
        # (KV imports, control calls) can't resume and never migrate.
        self._all_tokens: Optional[List[int]] = None
        self._orig_prompt_len = 0
        # Engine-resolved sampler seed for UNSEEDED requests (stamped on the
        # first stream item): makes every stream crash-resumable, not just
        # explicit-seed ones.
        self._resolved_seed: Optional[int] = None
        self._track_request(request.data)

    def __aiter__(self):
        return self

    async def __anext__(self):
        while True:
            try:
                if self._deadline is not None:
                    item = await self._deadline.bound(
                        self._stream.__anext__(),
                        "first token" if not self._got_first else "stream",
                    )
                else:
                    item = await self._stream.__anext__()
            except (StopAsyncIteration, asyncio.CancelledError):
                raise
            except DeadlineExceededError:
                metrics.deadline_exceeded_total += 1
                await self.aclose()
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                if not _is_retryable(e):
                    raise
                if self._got_first:
                    if not await self._try_resume(e):
                        raise
                    continue
                if not self._allow_failover:
                    raise
                self._record_failure()
                if not await self._budget_ok(e, "died before first token"):
                    raise
                with trace_span(
                    self._trace(), "client.failover", "client",
                    attrs={"from_worker": self._wid},
                ):
                    self._wid, self._address, self._stream = (
                        await self._client._acquire(
                            self._request, None, self._mode, self._state,
                            self._deadline,
                        )
                    )
                self._reset_latency_anchor()
                continue
            if isinstance(item, dict) and "resolved_seed" in item:
                # Captured (and stripped) before anything else: the stamp
                # may ride the migrated marker when cutover precedes the
                # first token.
                self._resolved_seed = int(item.pop("resolved_seed"))
            if isinstance(item, dict) and item.get("migrated"):
                await self._splice(item["migrated"])
                continue
            now = time.monotonic()
            if not self._got_first:
                worker_latency.record_ttft(
                    self._wid, self._address,
                    (now - self._t_dispatched) * 1e3,
                )
            elif self._t_last_item is not None:
                worker_latency.record_itl(
                    self._wid, self._address,
                    (now - self._t_last_item) * 1e3,
                )
            self._t_last_item = now
            self._got_first = True
            if self._all_tokens is not None and isinstance(item, dict):
                self._all_tokens.extend(item.get("token_ids") or ())
            return item

    # -- recovery helpers ---------------------------------------------------

    def _trace(self):
        """The stream's active TraceContext (None = untraced — every span
        call below is then the shared no-op)."""
        return getattr(self._request.ctx, "trace", None)

    def _reset_latency_anchor(self) -> None:
        """Re-anchor the per-worker latency observations after any
        re-dispatch (failover, resume, splice): the recovery gap belongs to
        the WORKER THAT FAILED, not to the replacement — charging it there
        would make the watchdog's straggler scan quarantine the healthy
        failover target exactly when the fleet is already degraded."""
        self._t_dispatched = time.monotonic()
        self._t_last_item = None

    def _track_request(self, data: Any) -> None:
        """(Re)anchor resume tracking on a request payload: its token_ids
        become the fed-stream base, and its ``resume`` annotation (if any)
        preserves the original prompt length across re-dispatches."""
        if not isinstance(data, dict) or not isinstance(
            data.get("token_ids"), list
        ):
            return
        self._all_tokens = list(data["token_ids"])
        resume = (data.get("annotations") or {}).get("resume") or {}
        self._orig_prompt_len = int(
            resume.get("orig_prompt_len")
            or self._orig_prompt_len
            or len(self._all_tokens)
        )

    def _record_failure(self) -> None:
        client = self._client
        client._breaker(self._address).record_failure()
        client._evict(self._wid)
        self._state["tried"].add(self._wid)

    async def _budget_ok(self, exc: BaseException, what: str) -> bool:
        """Count one retry against the shared budget; backoff if granted."""
        client = self._client
        self._state["attempt"] += 1
        metrics.retries_total += 1
        metrics.failovers_total += 1
        if self._state["attempt"] >= client.retry_policy.max_attempts:
            metrics.retries_exhausted_total += 1
            return False
        logger.warning(
            "request %s: worker %s %s (%s); failing over (attempt %d/%d)",
            self._request.id, self._wid, what, exc,
            self._state["attempt"], client.retry_policy.max_attempts,
        )
        delay = client.retry_policy.backoff(self._state["attempt"])
        if self._deadline is not None:
            delay = min(delay, max(self._deadline.remaining(), 0.0))
        if delay > 0:
            await asyncio.sleep(delay)
        return True

    def _resume_request(self) -> Optional[Context]:
        """Self-contained continuation request from delivered tokens, or
        None when replay could diverge (no seed known client-side)."""
        data = self._request.data if isinstance(self._request.data, dict) else None
        if data is None or self._all_tokens is None:
            return None
        samp = dict(data.get("sampling_options") or {})
        if samp.get("seed") is None:
            if self._resolved_seed is not None:
                # The serving engine stamped its RESOLVED seed on the first
                # stream item exactly for this moment (unseeded sampled
                # requests, engine.py generate).
                samp["seed"] = self._resolved_seed
            elif (samp.get("temperature") or 0.0) > 0.0:
                # Sampled with no seed known client-side: an engine-
                # assigned default incorporates the worker's own engine
                # seed — another instance may re-derive differently.
                # Refuse, as before the resolved-seed stamp existed.
                return None
            # Greedy (temperature 0): argmax is seed-independent, so the
            # continuation is deterministic on any worker — resume seedless.
        resume = dict(data)
        resume["sampling_options"] = samp
        resume["token_ids"] = list(self._all_tokens)
        ann = dict(data.get("annotations") or {})
        prev = dict(ann.get("resume") or {})
        prev["orig_prompt_len"] = self._orig_prompt_len
        ann["resume"] = prev
        resume["annotations"] = ann
        return Context(resume, self._request.ctx)

    async def _try_resume(self, exc: BaseException) -> bool:
        """Mid-stream crash: continue a seeded stream on another worker."""
        request = self._resume_request()
        if request is None:
            return False
        self._record_failure()
        if not await self._budget_ok(exc, "died mid-stream"):
            return False
        with trace_span(
            self._trace(), "client.resume", "client",
            attrs={"from_worker": self._wid, "error": type(exc).__name__},
        ):
            self._wid, self._address, self._stream = (
                await self._client._acquire(
                    request, None, self._mode, self._state, self._deadline
                )
            )
        self._request = request
        self._reset_latency_anchor()
        metrics.stream_resumes_total += 1
        return True

    async def _splice(self, mig: Dict[str, Any]) -> None:
        """Cutover marker: re-dispatch the resume request to the migration
        target and continue the stream there.  A dead target is survivable
        — the resume request is deterministic, so any instance will do."""
        # Splice span: the cutover's client-visible cost (source stream
        # release + target re-dispatch).  The resume request carries the
        # trace in its annotations (migration snapshot), so the target's
        # engine spans join the SAME trace — one migrated stream, one
        # timeline.
        wid = mig.get("worker_id")
        sspan = trace_span(
            self._trace(), "client.splice", "client",
            attrs={"target_worker": wid},
        )
        try:
            await self._splice_inner(mig, sspan)
        except BaseException as e:
            # The raise paths (deadline exhausted, non-retryable target
            # error) are exactly the failed cutovers whose cost matters —
            # record the span instead of leaking it (finish is idempotent).
            sspan.set(error=type(e).__name__)
            raise
        finally:
            sspan.finish()

    async def _splice_inner(self, mig: Dict[str, Any], sspan) -> None:
        req_data = mig.get("request") or {}
        request = Context(req_data, self._request.ctx)
        client = self._client
        wid = mig.get("worker_id")
        try:
            # The marker is the source stream's last payload by protocol —
            # release its mux slot before splicing in the continuation.
            # NOT aclose(): that would stop_generating() the ctx the resume
            # request shares, cancelling the continuation it sets up.
            await self._stream._close_inner()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — source is done with us either way
            pass
        target_addr: Optional[str] = None
        try:
            info = client._instances.get(wid) if wid is not None else None
            if info is not None:
                engine = client._engine_for(wid, info)
                target_addr = info["address"]
            elif mig.get("address") and mig.get("path"):
                # The target may not be in the instance set (e.g. a static
                # deployment); dial it directly from the marker's address.
                engine = RemoteEngine(mig["address"], mig["path"])
                target_addr = mig["address"]
            else:
                raise RemoteEngineError("migration target unspecified")
            if self._deadline is not None:
                stream = await self._deadline.bound(
                    engine.generate(request), "migration splice"
                )
            else:
                stream = await engine.generate(request)
            # Track the TARGET's identity (even when it is not in the
            # instance set): a later mid-stream failure must evict and
            # blacklist the worker that actually failed, not the (healthy)
            # pre-migration source.
            self._wid, self._address = wid, target_addr
        except asyncio.CancelledError:
            raise
        except DeadlineExceededError:
            # Budget ran out mid-splice: the request's problem, not the
            # target's — no breaker poison, and no fallback dispatch (it
            # would be bounded by the same exhausted deadline).
            metrics.deadline_exceeded_total += 1
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            if not _is_retryable(e):
                raise
            # Blacklist the TARGET before falling back — self._wid/_address
            # still name the pre-migration source here, and without the
            # bookkeeping the picker could hand the same dead target
            # straight back, burning a second attempt from the shared
            # budget on a known-dead worker.
            if wid is not None:
                client._evict(wid)
                self._state["tried"].add(wid)
            if target_addr:
                client._breaker(target_addr).record_failure()
            logger.warning(
                "request %s: migration target %s unreachable (%s); "
                "resuming on any instance", self._request.id, wid, e,
            )
            sspan.event("target_unreachable", error=type(e).__name__)
            self._wid, self._address, stream = await client._acquire(
                request, None, self._mode, self._state, self._deadline
            )
        self._stream = stream
        # Task-confined: _StreamGuard is owned by the one consumer task
        # driving this stream, so the request swap cannot race a peer.
        self._request = request  # dynalint: disable=DYN101
        self._reset_latency_anchor()
        # The target's view of the fed stream is authoritative from here.
        self._track_request(req_data)
        # The in-flight request is now the self-contained resolved-seed
        # resume request — safe on ANY instance, so a direct-routed
        # stream's no-failover contract no longer applies: if the target
        # dies before its first post-splice token, fail over rather than
        # kill a request whose source already released the sequence.
        self._allow_failover = True
        metrics.migration_splices_total += 1

    async def aclose(self) -> None:
        await self._stream.aclose()
