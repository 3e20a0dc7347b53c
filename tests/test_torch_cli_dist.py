"""The port's distributed stack as real processes, as the README deploys it.

``python -m dynamo_tpu_torch.cli hub``, ``run in=dyn://… out=…`` workers
and ``http --router kv`` (``tests/test_cli_e2e.py``'s three-process
serving, on the port):

- with echo workers, the port's stack answers the same requests as the
  JAX package's three-process stack: statuses, texts, finish reasons and
  usage (the echo engine makes the answers engine-independent; the
  engines' own parity is tests/test_torch_router.py's);
- with ``out=torch --device cpu`` workers (debug-tiny, f32): a completion
  of 5 tokens, ``/metrics`` and ``/health``'s ``hub_shards``; then a
  second worker, and the worker serving a greedy stream is SIGKILLed
  mid-stream: the stream completes on the survivor, identical to the
  uninterrupted stream, the frontend's resume counter rises, and the dead
  instance leaves discovery within the lease TTL plus 1 s;
- the disaggregated stack (``tests/test_cli_e2e.py``'s four processes):
  ``hub``, ``run … --disagg prefill``, ``run … --disagg decode
  --max-local-prefill 16`` and ``http``, with ``out=torch --device cpu``
  workers: a 60-id prompt completes through the remote-prefill path
  (``disagg_stats``: remote prefills, no local one), with the text of the
  JAX package's four-process stack;
- ``DYN_BULK_PLANE=1`` honoured in this process: a ``run in=dyn://
  out=torch`` worker registers ``bulk/addr/<wid>``, serves, and answers a
  ticketed bulk ``kv_export`` fetch; ``http`` runs the bulk span ingest.

The port's children run in interpreters where aiohttp, pydantic,
prometheus_client, jinja2, tokenizers, xxhash and msgpack cannot be
imported, as on the card's machine.  Every child gets
``conftest.hermetic_child_env`` and every wait its own timeout; all
children are killed at the end.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENDPOINT = "in=dyn://dynamo.TorchWorker.generate"
TINY = ["--arch", "debug-tiny", "--dtype", "float32", "--device", "cpu", "--block-size", "4",
        "--num-blocks", "64", "--max-batch", "2", "--max-model-len", "128",
        "--prefill-chunk", "32", "--decode-steps", "1"]
LEASE_TTL_S = 10.0  # DistributedRuntime.DEFAULT_LEASE_TTL
# The card's machine has none of these; the port's processes run without
# them (the codec writes msgpack itself, tokens.py hashes without xxhash).
# With JAX_WEIGHTS_NPZ set, an ``out=torch`` child draws the JAX engine's
# seeded weights from that file (numpy only) instead of its own, so its
# answers can be held against the JAX stack's.
WITHOUT_ABSENT_PACKAGES = (
    "import os, sys\n"
    "for m in ('aiohttp', 'pydantic', 'prometheus_client', 'jinja2', 'tokenizers', 'xxhash',\n"
    "          'msgpack'):\n"
    "    sys.modules[m] = None\n"
    "if os.environ.get('JAX_WEIGHTS_NPZ'):\n"
    "    import numpy as np\n"
    "    from dynamo_tpu_torch.engine import engine as _engine\n"
    "    from dynamo_tpu_torch.models.llama import params_from_jax\n"
    "    _z = np.load(os.environ['JAX_WEIGHTS_NPZ'])\n"
    "    _tree = {}\n"
    "    for _k in _z.files:\n"
    "        _g, _, _n = _k.rpartition('.')\n"
    "        (_tree.setdefault(_g, {}) if _g else _tree)[_n] = _z[_k]\n"
    "    _engine.init_params = lambda mc, seed, dev: params_from_jax(_tree, dev)\n"
    "from dynamo_tpu_torch.cli import main\n"
    "main()\n"
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Proc:
    """A CLI child whose output is collected by a thread (the pipe never
    fills) and can be waited on line by line."""

    def __init__(self, pkg, *args, env=None):
        from conftest import hermetic_child_env

        entry = (["-c", WITHOUT_ABSENT_PACKAGES] if pkg == "dynamo_tpu_torch"
                 else ["-m", f"{pkg}.cli"])
        self.p = subprocess.Popen(
            [sys.executable, *entry, *args],
            env=hermetic_child_env(REPO) | {"DYN_LOG": "warning"} | (env or {}),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self.lines = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_line(self, prefix, timeout=60.0):
        end = time.time() + timeout
        while time.time() < end:
            for line in self.lines:
                if line.startswith(prefix):
                    return line
            if self.p.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"no {prefix!r} line: {self.lines[-20:]}")

    def kill(self):
        if self.p.poll() is None:
            self.p.kill()
        try:
            self.p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def _wait_tcp(port, timeout=30.0):
    end = time.time() + timeout
    while time.time() < end:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"port {port} never accepted connections")


def _http(base, method, path, body=None, timeout=60):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_model(base, name, timeout=60.0):
    end = time.time() + timeout
    while time.time() < end:
        try:
            status, raw = _http(base, "GET", "/v1/models", timeout=5)
            if status == 200 and any(m["id"] == name for m in json.loads(raw)["data"]):
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"model {name!r} never registered at {base}")


def _stack(pkg, worker_args, env=None, router="kv"):
    """hub + one worker + http frontend of ``pkg``; returns (procs, hub, base)."""
    hub_port, http_port = _free_port(), _free_port()
    procs = [Proc(pkg, "hub", "--host", "127.0.0.1", "--port", str(hub_port))]
    _wait_tcp(hub_port)
    hub = f"127.0.0.1:{hub_port}"
    procs.append(Proc(pkg, "run", ENDPOINT, *worker_args, "--hub", hub, env=env))
    procs.append(Proc(pkg, "http", "--hub", hub, "--host", "127.0.0.1", "--port", str(http_port),
                      "--router", router))
    return procs, hub, f"http://127.0.0.1:{http_port}"


def _mask(obj):
    """Drop per-response ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


REQUESTS = [
    ("POST", "/v1/completions", {"model": "echo", "prompt": [72, 101, 108, 108, 111, 33],
                                 "max_tokens": 5, "nvext": {"ignore_eos": True}}),
    ("POST", "/v1/completions", {"model": "echo", "prompt": [72, 105], "max_tokens": 5,
                                 "stream": True, "nvext": {"ignore_eos": True}}),
    ("POST", "/v1/chat/completions", {"model": "echo", "max_tokens": 8,
                                      "messages": [{"role": "user", "content": "hello there"}]}),
    ("POST", "/v1/completions", {"model": "nope", "prompt": "x", "max_tokens": 2}),
    ("POST", "/v1/completions", {"model": "echo", "max_tokens": 2}),
    ("GET", "/v1/models", None),
]


def _answers(base):
    out = []
    for method, path, body in REQUESTS:
        status, raw = _http(base, method, path, body)
        if body is not None and body.get("stream"):
            events = [ln[len("data: "):] for ln in raw.decode().splitlines() if ln.startswith("data: ")]
            parsed = [e if e == "[DONE]" else _mask(json.loads(e)) for e in events]
        else:
            parsed = _mask(json.loads(raw))
        if status == 400:
            # Validation wording is pydantic's on the JAX edge, the port's
            # own validator's here (tests/test_torch_llm.py holds the two).
            parsed["error"].pop("message")
        out.append((status, parsed))
    return out


def test_three_process_stacks_answer_alike():
    stacks = {}
    try:
        for pkg in ("dynamo_tpu", "dynamo_tpu_torch"):
            stacks[pkg] = _stack(pkg, ["out=echocore", "--model", "echo"])
        answers = {}
        for pkg, (procs, hub, base) in stacks.items():
            _wait_model(base, "echo")
            answers[pkg] = _answers(base)
            status, raw = _http(base, "GET", "/health")
            health = json.loads(raw)
            assert status == 200 and health["status"] == "ok"
            assert health["hub_shards"] == [{"shard": hub, "connected": True}]
        assert answers["dynamo_tpu_torch"] == answers["dynamo_tpu"]
        statuses = [s for s, _ in answers["dynamo_tpu_torch"]]
        assert statuses == [200, 200, 200, 404, 400, 200]
        unary = answers["dynamo_tpu_torch"][0][1]
        assert unary["choices"][0]["finish_reason"] == "length"
        assert unary["usage"]["completion_tokens"] == 5
    finally:
        for procs, _, _ in stacks.values():
            for p in procs:
                p.kill()


def _instances(hub):
    """worker ids under the endpoint's instance prefix (the port's hub client)."""
    from dynamo_tpu_torch.runtime.transports.hub import HubClient

    async def go():
        c = await HubClient(hub).connect()
        try:
            keys = await c.kv_get_prefix("instances/dynamo/TorchWorker/generate/")
            return {int(k.rsplit("/", 1)[1]) for k in keys}
        finally:
            await c.close()

    return asyncio.run(go())


def _resumes(base):
    _, raw = _http(base, "GET", "/metrics")
    for line in raw.decode().splitlines():
        if line.startswith("dynamo_tpu_resilience_stream_resumes_total "):
            return float(line.split()[1])
    raise AssertionError("no resume counter on /metrics")


def _stream(base, body, on_chunk=None, timeout=120):
    """A streamed completion read chunk by chunk; returns (text, finish)."""
    req = urllib.request.Request(base + "/v1/completions", method="POST",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    text, finish, n = "", None, 0
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[len("data: "):])
            for c in chunk.get("choices", []):
                text += c.get("text") or ""
                finish = c.get("finish_reason") or finish
            n += 1
            if on_chunk is not None:
                on_chunk(n)
    return text, finish


def test_torch_workers_serve_and_resume_after_sigkill():
    # Each streamed item waits 50 ms on the worker (the slow_stream fault
    # point), so a kill after a few chunks lands mid-stream.
    slow = {"DYN_FAULTS": "slow_stream:*@0.05"}
    procs, hub, base = _stack("dynamo_tpu_torch", ["out=torch", "--model", "tiny", *TINY],
                              env=slow)
    try:
        first = int(procs[1].wait_line("worker ").split()[1])
        _wait_model(base, "tiny")
        status, raw = _http(base, "POST", "/v1/completions", {
            "model": "tiny", "prompt": [5, 17, 33, 2, 250, 9, 61], "max_tokens": 5,
            "nvext": {"ignore_eos": True}})
        body = json.loads(raw)
        assert status == 200 and body["choices"][0]["finish_reason"] == "length"
        assert body["usage"]["completion_tokens"] == 5
        status, raw = _http(base, "GET", "/metrics")
        assert status == 200 and b"dynamo_tpu_http_service_requests_total" in raw
        health = json.loads(_http(base, "GET", "/health")[1])
        assert health["hub_shards"] == [{"shard": hub, "connected": True}]

        procs.append(Proc("dynamo_tpu_torch", "run", ENDPOINT, "out=torch", "--model", "tiny",
                          *TINY, "--hub", hub, env=slow))
        second = int(procs[3].wait_line("worker ").split()[1])
        by_id = {first: procs[1], second: procs[3]}
        end = time.time() + 60
        while _instances(hub) != {first, second}:
            assert time.time() < end, "the second worker never registered"
            time.sleep(0.2)

        greedy = {"model": "tiny", "prompt": list(range(40, 64)), "max_tokens": 30,
                  "temperature": 0.0, "nvext": {"ignore_eos": True}}
        want = _stream(base, greedy)
        assert want[1] == "length"
        # The repeat routes to the worker holding its prefix; which one that
        # is, the router's hit-rate event says.
        from dynamo_tpu_torch.runtime.transports.hub import HubClient

        async def next_hit(started):
            c = await HubClient(hub).connect()
            try:
                sub = await c.subscribe("dynamo.TorchWorker.kv-hit-rate")
                started.set()
                _, hit = await asyncio.wait_for(sub.__anext__(), 60)
                await sub.aclose()
                return hit
            finally:
                await c.close()

        started, hit = threading.Event(), {}
        t = threading.Thread(target=lambda: hit.update(asyncio.run(next_hit(started))))
        t.start()
        assert started.wait(30)
        time.sleep(0.2)
        before = _resumes(base)
        killed = {}

        def kill_after(n):
            if n == 4 and not killed:
                t.join(30)
                victim = hit["worker_id"]
                by_id[victim].p.send_signal(signal.SIGKILL)
                killed.update(worker=victim, at=time.monotonic())

        got = _stream(base, greedy, on_chunk=kill_after)
        assert killed, "the stream ended before the kill"
        assert hit["overlap_blocks"] == len(greedy["prompt"]) // 4
        assert got == want
        assert _resumes(base) == before + 1
        survivor = (set(by_id) - {killed["worker"]}).pop()
        while _instances(hub) != {survivor}:
            assert time.monotonic() - killed["at"] < LEASE_TTL_S + 1.0, _instances(hub)
            time.sleep(0.1)
    finally:
        for p in procs:
            p.kill()


def _disagg_stats(pkg, hub, component):
    """The decode worker's ``disagg_stats`` endpoint, over the hub."""
    import importlib

    comp = importlib.import_module(f"{pkg}.runtime.component")
    eng = importlib.import_module(f"{pkg}.runtime.engine")

    async def go():
        rt = await comp.DistributedRuntime.connect(hub)
        try:
            client = await rt.namespace("dynamo").component(component).endpoint(
                "disagg_stats").client()
            await client.wait_for_instances(30)
            items = await eng.collect(await client.generate(eng.Context({})))
            await client.close()
            return items[0]
        finally:
            await rt.close()

    return asyncio.run(go())


DISAGG_PROMPT = [((i * 7) % 250) + 1 for i in range(60)]  # 15 blocks of 4


def _jax_weights_npz(path):
    """The JAX CLI's debug-tiny f32 weights at seed 0, flattened to an npz
    (``layers.wq`` etc.) for the port's children."""
    import jax

    from dynamo_tpu.models.config import get_config
    from dynamo_tpu.models.llama import init_params

    tree = init_params(get_config("debug-tiny").with_overrides(dtype="float32"),
                       jax.random.PRNGKey(0))
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{n}": np.asarray(x) for n, x in v.items()})
        else:
            flat[k] = np.asarray(v)
    np.savez(path, **flat)
    return str(path)


def _disagg_stack(pkg, env=None):
    """hub, a prefill worker, a decode worker and the http frontend of
    ``pkg``; returns (procs, hub, base, worker component)."""
    out, comp = ("out=torch", "TorchWorker") if pkg == "dynamo_tpu_torch" else ("out=tpu",
                                                                              "TpuWorker")
    flags = ["--model", "tiny", "--arch", "debug-tiny", "--dtype", "float32", "--block-size",
             "4", "--num-blocks", "128", "--max-batch", "2", "--max-model-len", "128",
             "--prefill-chunk", "64"]
    if pkg == "dynamo_tpu_torch":
        flags += ["--device", "cpu"]
    hub_port, http_port = _free_port(), _free_port()
    procs = [Proc(pkg, "hub", "--host", "127.0.0.1", "--port", str(hub_port))]
    _wait_tcp(hub_port)
    hub = f"127.0.0.1:{hub_port}"
    procs.append(Proc(pkg, "run", f"in=dyn://dynamo.{comp}.prefill", out, "--hub", hub,
                      "--disagg", "prefill", *flags, env=env))
    procs.append(Proc(pkg, "run", f"in=dyn://dynamo.{comp}.generate", out, "--hub", hub,
                      "--disagg", "decode", "--max-local-prefill", "16", *flags, env=env))
    procs.append(Proc(pkg, "http", "--hub", hub, "--host", "127.0.0.1", "--port",
                      str(http_port)))
    return procs, hub, f"http://127.0.0.1:{http_port}", comp


def test_disaggregated_four_process_stacks_answer_alike(tmp_path):
    stacks = {}
    weights = {"JAX_WEIGHTS_NPZ": _jax_weights_npz(tmp_path / "weights.npz")}
    try:
        for pkg in ("dynamo_tpu_torch", "dynamo_tpu"):
            stacks[pkg] = _disagg_stack(pkg, weights if pkg == "dynamo_tpu_torch" else None)
        answers = {}
        for pkg, (procs, hub, base, comp) in stacks.items():
            if pkg == "dynamo_tpu_torch":
                procs[1].wait_line("worker ")  # the prefill worker is up
            _wait_model(base, "tiny", timeout=120)
            status, raw = _http(base, "POST", "/v1/completions", {
                "model": "tiny", "prompt": DISAGG_PROMPT, "max_tokens": 5,
                "nvext": {"ignore_eos": True}}, timeout=120)
            body = json.loads(raw)
            assert status == 200, body
            assert body["choices"][0]["finish_reason"] == "length"
            assert body["usage"]["completion_tokens"] == 5
            assert body["usage"]["prompt_tokens"] == 60
            stats = _disagg_stats(pkg, hub, comp)
            # Completing is not enough: a timed-out transfer falls back to
            # local prefill and still completes.
            assert stats["remote_prefills"] >= 1, (pkg, stats)
            assert stats["local_prefills"] == 0, (pkg, stats)
            assert stats["transfer_ms_last"] is not None
            answers[pkg] = body["choices"][0]["text"]
        assert answers["dynamo_tpu_torch"] == answers["dynamo_tpu"]
    finally:
        for procs, *_ in stacks.values():
            for p in procs:
                p.kill()


async def _bulk_plane_case(case):
    """``DYN_BULK_PLANE=1`` on the port's CLI, in this process over a port
    hub: a ``run in=dyn:// out=torch`` worker registers ``bulk/addr/<wid>``
    under its lease, serves a request, and its bulk server answers a
    ticketed ``kv_export`` fetch of the blocks it sealed; ``http`` (tracing
    on by default) registers its span ingest under ``bulk/sink/traces/``
    and a worker's batch pushed there lands in its aggregator.  Both
    registrations are gone once the command stops."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, StopConditions
    from dynamo_tpu_torch.llm.trace_service import BULK_TRACES_SINK, make_bulk_span_sink
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.engine import Context, collect
    from dynamo_tpu_torch.runtime.transports import bulk, codec
    from dynamo_tpu_torch.runtime.transports.hub import HubServer

    hub = await HubServer(host="127.0.0.1").start()
    rt = await DistributedRuntime.connect(hub.address)
    loop = asyncio.get_running_loop()
    ready = loop.create_future()
    if case == "bulk-plane-worker":
        args = cli.parse_args(["run", ENDPOINT, "out=torch", *TINY, "--model", "tiny",
                               "--hub", hub.address])
        task = asyncio.ensure_future(cli._run(args, on_serving=ready.set_result))
    else:
        args = cli.parse_args(["http", "--hub", hub.address, "--host", "127.0.0.1", "--port", "0"])
        task = asyncio.ensure_future(cli._run_http_frontend(args, on_serving=ready.set_result))
    try:
        await asyncio.wait({ready, task}, timeout=120, return_when=asyncio.FIRST_COMPLETED)
        assert ready.done(), task.exception() if task.done() else "not serving in 120 s"
        served = ready.result()
        if case == "bulk-plane-worker":
            wid = served.worker_id
            rec = await rt.hub.kv_get(bulk.bulk_addr_key(wid))
            assert rec["worker_id"] == str(wid) and rec["address"]
            ns, comp, ep = parse_endpoint_path(ENDPOINT.split("=", 1)[1])
            client = await rt.namespace(ns).component(comp).endpoint(ep).client()
            await client.wait_for_instances(30)
            prompt = list(range(1, 13))
            req = PreprocessedRequest(token_ids=prompt, stop_conditions=StopConditions(
                max_tokens=3, ignore_eos=True)).to_dict()
            items = await collect(await client.generate(Context(req), worker_id=wid))
            assert sum(len(i.get("token_ids", [])) for i in items) == 3
            await client.close()
            address, ticket = await bulk.BulkRendezvous(rt.hub).prepare(wid)
            assert address == rec["address"]
            blob = await bulk.bulk_fetch(address, "kv_export", ticket,
                                         meta={"token_ids": prompt, "start_block": 0})
            assert codec.decode(blob)["n_blocks"] == len(prompt) // 4
            gone = bulk.bulk_addr_key(wid)
        else:
            recs = await rt.hub.kv_get_prefix(bulk.bulk_sink_prefix(BULK_TRACES_SINK))
            assert len(recs) == 1
            published = []

            async def hub_path(payload):
                published.append(payload)

            span = {"trace_id": "t-cli", "span_id": "s1", "parent_id": None, "name": "w",
                    "component": "engine", "proc": "worker-1", "start_ms": 0.0, "dur_ms": 1.0}
            await make_bulk_span_sink(bulk.BulkRendezvous(rt.hub), hub_path)(
                {"proc": "worker-1", "spans": [span]})
            assert published == []
            assert served.trace_aggregator.get("t-cli")["spans"] == [span]
            gone = next(iter(recs))
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    assert await rt.hub.kv_get(gone) is None
    await rt.close()
    await hub.close()


@pytest.mark.parametrize("argv,env,match", [
    (["run", ENDPOINT, "out=echocore", "--hub", "127.0.0.1:1", "--disagg", "decode"], {},
     "--disagg decode requires the native engine"),
    (None, {"DYN_BULK_PLANE": "1"}, None),
    (None, {"DYN_BULK_PLANE": "1"}, None),
], ids=["disagg", "bulk-plane-worker", "bulk-plane-http"])
def test_cli_refuses_what_waits(argv, env, match, monkeypatch, request):
    """Options of the JAX commands the port refuses fail before anything
    dials the hub: ``--disagg`` on an engine without ``inject_blocks``
    (as the JAX CLI refuses it).  The bulk plane's cases, refused until the
    port had it, now hold ``DYN_BULK_PLANE=1`` honoured by a worker and by
    the ``http`` edge (``_bulk_plane_case``)."""
    from dynamo_tpu_torch import cli

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if argv is None:
        asyncio.run(_bulk_plane_case(request.node.callspec.id))
        return
    args = cli.parse_args(argv)
    run = cli._run if args.cmd == "run" else cli._run_http_frontend
    with pytest.raises(SystemExit, match=match):
        asyncio.run(run(args))
    if "--disagg" in argv:
        from dynamo_tpu import cli as jax_cli
        from dynamo_tpu.runtime import logging_config

        monkeypatch.setattr(logging_config, "setup_logging", lambda: None)
        with pytest.raises(SystemExit, match="--disagg decode requires the native"):
            jax_cli.main(argv)
