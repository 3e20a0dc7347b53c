"""The planner's actuation paths end to end on the CPU, on the port and
against the JAX package (debug-tiny, f32, CLI processes).

- **The role flip.** Two ``run in=dyn://… --disagg decode`` workers of
  each package over a hub; a live greedy stream on A; a ``LocalActuator``
  writes ``flip_role(A, prefill)``: A's ``RoleFlipWatcher`` drains the
  stream to B through migration (it ends whole, spliced or resumed, equal
  to B serving it alone), A registers its prefill heartbeat and acks; the
  flip back brings A's decode surface back and A serves again.  The hub
  writes (the role key and A's instance record, ids masked) are the same
  sequence for both packages.  Also shown alike on both: after the flip a
  round-robin client routes to A's heartbeat, whose address is empty, and
  that request fails (ROADMAP queue 3).
- **The supervisor.** ``python -m dynamo_tpu_torch.planner supervise``
  with ``ProcessWorkerPool`` spawns port CLI workers to the target a
  ``LocalActuator`` writes; lowered by one, it SIGTERMs the newest, whose
  shutdown migrates its live stream to the survivor, whole.
- **Pool ownership**, on both packages alike: the supervisor counts only
  the workers it spawned, so a fleet holding a worker it did not spawn
  ends above the planner's target, and a flip moves a spawned worker out
  of its pool without the supervisor's knowledge (ROADMAP queue 3).
"""

import asyncio
import importlib
import os
import subprocess
import sys
import time

import pytest

from test_torch_cli_dist import Proc, _free_port, _wait_tcp

pytestmark = [pytest.mark.torch_port, pytest.mark.planner]

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--arch", "debug-tiny", "--dtype", "float32", "--block-size", "4", "--num-blocks", "128",
        "--max-batch", "4", "--max-model-len", "512", "--prefill-chunk", "64",
        "--decode-steps", "1", "--model", "tiny"]
SLOW = {"DYN_FAULTS": "slow_stream:*@0.03"}
E2E_LIMIT_S = 240.0


def M(pkg):
    m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
    import types

    return types.SimpleNamespace(
        component=m("runtime.component"), engine=m("runtime.engine"),
        protocols=m("llm.protocols"), actuate=m("planner.actuate"), policy=m("planner.policy"),
        supervisor=m("planner.supervisor"), hub=m("runtime.transports.hub"),
        client=m("runtime.client"),
    )


def _req(pkg, tokens, n):
    pr = M(pkg).protocols
    return pr.PreprocessedRequest(
        token_ids=list(tokens), stop_conditions=pr.StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=pr.SamplingOptions(temperature=0.0)).to_dict()


def _tokens(items):
    return [t for it in items for t in it.get("token_ids", [])]


def _worker(pkg, endpoint, hub, *extra, env=None):
    out = ["out=torch", "--device", "cpu"] if pkg == PORT else ["out=tpu"]
    return Proc(pkg, "run", f"in=dyn://{endpoint}", *out, "--hub", hub, *TINY, *extra, env=env)


async def _wait(pred, timeout=60.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = await pred()
        if got:
            return got
        await asyncio.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


async def _role_flip_script(pkg):
    """The same script on ``pkg``'s CLI workers; returns its transcript."""
    comp = "TorchWorker" if pkg == PORT else "TpuWorker"
    hub_port = _free_port()
    procs = [Proc(pkg, "hub", "--host", "127.0.0.1", "--port", str(hub_port))]
    _wait_tcp(hub_port)
    hub = f"127.0.0.1:{hub_port}"
    X = M(pkg)
    rt = await X.component.DistributedRuntime.connect(hub)
    prefix = f"instances/fl/{comp}/generate/"
    try:
        ids = []
        for _ in range(2):
            procs.append(_worker(pkg, f"fl.{comp}.generate", hub, "--disagg", "decode",
                                 "--max-local-prefill", "16", env=SLOW))

            async def registered(n=len(ids) + 1):
                keys = await rt.hub.kv_get_prefix(prefix)
                return len(keys) == n and keys

            keys = await _wait(registered, 120, "the worker's registration")
            ids.append(next(int(k.rsplit("/", 1)[1]) for k in keys
                            if int(k.rsplit("/", 1)[1]) not in ids))
        a, b = ids
        names = {str(a): "A", str(b): "B"}
        transcript = []
        watch = await rt.hub.watch_prefix(f"planner/roles/{a}")
        iwatch = await rt.hub.watch_prefix(f"{prefix}{a}")

        async def record(w, kind):
            async for ev in w:
                v = ev.value if isinstance(ev.value, dict) else {}
                if kind == "role":
                    transcript.append(("role", ev.type, v.get("role"), v.get("acked"),
                                       v.get("from"), v.get("tick"), v.get("reason")))
                else:
                    transcript.append(("instance", ev.type, (v.get("metadata") or {}).get("role"),
                                       bool(v.get("address")), names.get(str(v.get("worker_id")))))

        recorders = [asyncio.ensure_future(record(watch, "role")),
                     asyncio.ensure_future(record(iwatch, "instance"))]
        client = await rt.namespace("fl").component(
            comp).endpoint("generate").client()
        await client.wait_for_instances(10)
        items = []

        async def consume():
            async for it in await client.generate(X.engine.Context(_req(pkg, range(3, 11), 200)),
                                                  worker_id=a):
                items.append(it)

        stream = asyncio.ensure_future(consume())

        async def started():
            return len(_tokens(items)) >= 3

        await _wait(started, 60, "the stream's first tokens")
        act = X.actuate.LocalActuator(rt.hub)
        pol = X.policy
        await act.apply(pol.Decision(tick=1, actions=[pol.flip_role(a, pol.PREFILL, "test")],
                                     pressures={}))

        async def acked(frm):
            v = await rt.hub.kv_get(X.actuate.role_key(a))
            return v if v and v.get("acked") and v.get("from") == frm else None

        ack = await _wait(lambda: acked("decode"), 60, "the flip's ack")
        await asyncio.wait_for(stream, 120)
        got = _tokens(items)
        control = _tokens(await X.engine.collect(await client.generate(
            X.engine.Context(_req(pkg, range(3, 11), 200)), worker_id=b)))
        whole = (got == control, items[-1].get("finish_reason"))
        heartbeat = (await rt.hub.kv_get(f"{prefix}{a}"))
        # A round-robin client over the endpoint after the flip: its picks
        # alternate over B and A's prefill heartbeat (address "").
        rr = await rt.namespace("fl").component(
            comp).endpoint("generate").client(router_mode=X.client.RouterMode.ROUND_ROBIN)
        await rr.wait_for_instances(10)
        outcomes = []
        for i in range(4):
            try:
                n = len(_tokens(await X.engine.collect(await rr.generate(
                    X.engine.Context(_req(pkg, range(20 + i, 26 + i), 4))))))
                outcomes.append(n)
            except Exception as e:  # noqa: BLE001 — the outcome is the finding
                outcomes.append(type(e).__name__)
        await rr.close()
        await act.apply(pol.Decision(tick=2, actions=[pol.flip_role(a, pol.DECODE, "back")],
                                     pressures={}))
        back = await _wait(lambda: acked("prefill"), 60, "the flip back's ack")

        async def serving():
            v = await rt.hub.kv_get(f"{prefix}{a}")
            return v and v.get("address")

        await _wait(serving, 30, "A's decode surface")
        after = _tokens(await X.engine.collect(await client.generate(
            X.engine.Context(_req(pkg, range(40, 46), 6)), worker_id=a)))
        await asyncio.sleep(0.3)
        for r in recorders:
            r.cancel()
        await asyncio.gather(*recorders, return_exceptions=True)
        await watch.aclose()
        await iwatch.aclose()
        await client.close()
        return {
            "ack": {k: v for k, v in ack.items()}, "back": back, "whole": whole,
            "heartbeat": ((heartbeat or {}).get("address"),
                          ((heartbeat or {}).get("metadata") or {}).get("role")),
            "round_robin": sorted(map(str, outcomes)), "after": len(after),
            "transcript": transcript,
        }
    finally:
        await rt.close()
        for p in procs:
            p.kill()


async def test_role_flip_on_cli_workers_matches_jax():
    async def both():
        return {pkg: await _role_flip_script(pkg) for pkg in PKGS}

    got = await asyncio.wait_for(both(), E2E_LIMIT_S)
    for pkg in PKGS:
        r = got[pkg]
        assert r["ack"] == {"role": "prefill", "tick": 1, "reason": "test", "acked": True,
                            "from": "decode"}, (pkg, r)
        assert r["back"]["acked"] and r["back"]["from"] == "prefill", (pkg, r)
        assert r["whole"] == (True, "length"), (pkg, r)
        assert r["heartbeat"] == ("", "prefill"), (pkg, r)
        assert r["after"] == 6, (pkg, r)
        assert "ValueError" in r["round_robin"] and "4" in r["round_robin"], (pkg, r)
    assert got[PORT]["transcript"] == got[JAX]["transcript"]
    assert got[PORT]["round_robin"] == got[JAX]["round_robin"]


async def test_supervisor_spawns_port_workers_and_drains_on_scale_down():
    async def run():
        X = M(PORT)
        hub_port = _free_port()
        procs = [Proc(PORT, "hub", "--host", "127.0.0.1", "--port", str(hub_port))]
        _wait_tcp(hub_port)
        hub = f"127.0.0.1:{hub_port}"
        # ``exec``: ProcessWorkerPool signals the shell it spawned, and a
        # shell that forks its command would leave the worker running.
        spawn = " ".join(["exec", sys.executable, "-m", "dynamo_tpu_torch.cli", "run",
                          "in=dyn://sv.TorchWorker.generate", "out=torch", "--device", "cpu",
                          "--hub", hub, *TINY])
        from conftest import hermetic_child_env

        sup = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.planner", "supervise", "--hub", hub,
             "--spawn-decode", spawn, "--resync", "0.5", "--term-grace-s", "30"],
            cwd=REPO, env=hermetic_child_env(REPO) | SLOW | {"DYN_LOG": "warning"},
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        rt = await X.component.DistributedRuntime.connect(hub)
        prefix = "instances/sv/TorchWorker/generate/"
        try:
            order = []
            watch = await rt.hub.watch_prefix(prefix)

            async def follow():
                async for ev in watch:
                    if ev.type == "put":
                        wid = int(ev.key.rsplit("/", 1)[1])
                        if wid not in order:
                            order.append(wid)

            follower = asyncio.ensure_future(follow())
            act = X.actuate.LocalActuator(rt.hub)
            pol = X.policy

            def registered(n):
                async def pred():
                    return len(await rt.hub.kv_get_prefix(prefix)) == n and len(order) == n
                return pred

            # One worker at a time: the supervisor stops the worker it
            # spawned last, and two spawned together may register in
            # either order.
            for tick, n in ((1, 1), (2, 2)):
                await act.apply(pol.Decision(tick=tick, actions=[pol.scale_decode(1, n, "up")],
                                             pressures={}))
                await _wait(registered(n), 180, f"{n} spawned worker(s)")
            client = await rt.namespace("sv").component("TorchWorker").endpoint(
                "generate").client()
            await client.wait_for_instances(10)
            newest, survivor = order[1], order[0]
            items = []

            async def consume():
                async for it in await client.generate(
                        X.engine.Context(_req(PORT, range(5, 13), 240)), worker_id=newest):
                    items.append(it)

            stream = asyncio.ensure_future(consume())

            async def started():
                return len(_tokens(items)) >= 3

            await _wait(started, 60, "the stream's first tokens")
            await act.apply(pol.Decision(tick=3, actions=[pol.scale_decode(-1, 1, "down")],
                                         pressures={}))
            await asyncio.wait_for(stream, 120)

            async def one():
                keys = await rt.hub.kv_get_prefix(prefix)
                return list(keys) == [f"{prefix}{survivor}"]

            await _wait(one, 60, "the newest worker's exit")
            control = _tokens(await X.engine.collect(await client.generate(
                X.engine.Context(_req(PORT, range(5, 13), 240)), worker_id=survivor)))
            assert _tokens(items) == control and items[-1]["finish_reason"] == "length"
            target = await rt.hub.kv_get(X.actuate.target_key("decode"))
            assert target["replicas"] == 1 and target["drain"] == "migrate"
            follower.cancel()
            await asyncio.gather(follower, return_exceptions=True)
            await watch.aclose()
            await client.close()
        finally:
            await rt.close()
            sup.terminate()
            try:
                sup.wait(timeout=60)
            except subprocess.TimeoutExpired:
                sup.kill()
            for p in procs:
                p.kill()
        # The supervisor's SIGTERM path stopped its remaining worker.
        assert sup.returncode is not None

    await asyncio.wait_for(run(), E2E_LIMIT_S)


@pytest.mark.parametrize("pkg", PKGS)
async def test_supervisor_owns_only_the_workers_it_spawned(pkg):
    """``Supervisor._reconcile`` compares a pool's target with the workers
    it spawned itself: with one decode worker it did not spawn already
    serving, a decode target of 2 (what ``LocalActuator`` writes, a pool
    total) makes it spawn 2, and the fleet runs 3; a role flip that moves
    one of its workers to the prefill pool leaves its ledger unchanged, so
    the decode pool runs one below target with nothing spawned.  Both
    packages alike."""
    X = M(pkg)
    hub = await X.hub.InprocHub().start()
    spawned, stopped = [], []

    async def spawn(pool):
        spawned.append(pool)
        return f"{pool}-{len(spawned)}"

    async def stop(pool, handle, drain):
        stopped.append((pool, handle, drain))

    fleet = {"decode": ["external"], "prefill": []}
    sup = await X.supervisor.Supervisor(hub, spawn, stop, pools=["decode", "prefill"],
                                        resync_s=0.05).start()
    try:
        act = X.actuate.LocalActuator(hub)
        pol = X.policy
        await act.apply(pol.Decision(tick=1, actions=[pol.scale_decode(1, 2, "up")], pressures={}))
        for _ in range(100):
            if sup.owned("decode") == 2:
                break
            await asyncio.sleep(0.02)
        fleet["decode"] += list(sup.handles["decode"])
        over = (len(fleet["decode"]), sup.owned("decode"))
        # The planner flips one spawned worker to prefill, then restates the
        # decode total it now sees (2 of 3 remain): the ledger still owns 2.
        moved = fleet["decode"].pop()
        fleet["prefill"].append(moved)
        await act.apply(pol.Decision(tick=2, actions=[pol.flip_role(7, pol.PREFILL, "ratio")],
                                     pressures={}))
        await act.apply(pol.Decision(tick=3, actions=[pol.scale_decode(0, 2, "restate")],
                                     pressures={}))
        await asyncio.sleep(0.3)
        after = (len(fleet["decode"]) - 1, sup.owned("decode"), len(spawned), list(stopped))
    finally:
        await sup.stop()
        await hub.close()
    assert over == (3, 2), over
    assert after == (1, 2, 2, []), after


async def test_cli_edge_publishes_slo_and_metrics_commands_serve():
    """The port's ``http`` command publishes the edge's percentiles on
    ``slo_metrics`` (with its ``edge_id``) every 2 s; ``mock-worker``
    publishes synthetic metrics and ``metrics`` serves them, with the
    router's series, on its ``/metrics``."""
    import urllib.request

    async def run():
        X = M(PORT)
        hub_port = _free_port()
        procs = [Proc(PORT, "hub", "--host", "127.0.0.1", "--port", str(hub_port))]
        _wait_tcp(hub_port)
        hub = f"127.0.0.1:{hub_port}"
        rt = await X.component.DistributedRuntime.connect(hub)
        try:
            sub = await rt.namespace("dynamo").subscribe("slo_metrics")
            procs.append(Proc(PORT, "http", "--hub", hub, "--host", "127.0.0.1", "--port", "0"))
            procs.append(Proc(PORT, "mock-worker", "--hub", hub, "--component", "TorchWorker",
                              "--interval", "0.1"))
            procs.append(Proc(PORT, "metrics", "--hub", hub, "--component", "TorchWorker",
                              "--host", "127.0.0.1", "--port", "0"))
            _, slo = await asyncio.wait_for(sub.__anext__(), 60)
            assert slo["edge_id"].startswith("edge-") and "ttft_p95_ms" in slo
            assert slo["ttft_samples"] == 0.0
            line = await asyncio.to_thread(procs[-1].wait_line, "metrics aggregator on", 60)
            url = line.split(" on ", 1)[1]
            wid = (await asyncio.to_thread(procs[-2].wait_line, "mock worker", 60)).split()[2]

            def scrape():
                with urllib.request.urlopen(url, timeout=5) as r:
                    return r.read().decode()

            async def row():
                text = await asyncio.to_thread(scrape)
                return f'dynamo_tpu_worker_total_slots{{worker_id="{wid}"}} 8' in text and text

            text = await _wait(row, 30, "the mock worker's row")
            assert "dynamo_tpu_router_isl_blocks" in text
            await sub.aclose()
        finally:
            await rt.close()
            for p in procs:
                p.kill()

    await asyncio.wait_for(run(), E2E_LIMIT_S)
