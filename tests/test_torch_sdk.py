"""The port's serving SDK (``dynamo_tpu_torch/sdk``) and its example graph
(``dynamo_tpu_torch/examples/llm``) against the JAX package's
(``tests/test_sdk.py``, ``tests/test_example_app.py``):

- ``@service`` meta, ``depends()`` discovery and ``Graph.link`` alike on
  both packages;
- ``ServiceConfigStore``: the file < env merge alike, with PyYAML and with
  the built-in subset reader;
- the allocator over a fixed device count: ``{"gpu": n}`` pinned through
  ``CUDA_VISIBLE_DEVICES``, ``""`` for a service with no accelerator, the
  JAX error on oversubscription, a ``"tpu"`` request refused naming
  ``"gpu"``; the count from ``DYN_TPU_CHIPS`` else ``torch.cuda``;
- ``run_worker``'s order: connect, resolve ``depends()`` edges, serve the
  endpoints, then the ``@async_on_start`` hooks; an in-process graph;
- the example graph end to end, as real processes: ``python -m
  dynamo_tpu_torch.sdk.runner dynamo_tpu_torch.examples.llm.graphs:agg
  --http-port P --router kv`` (the runner's own hub) with ``TorchWorker``
  on ``device: cpu``, after the JAX ``examples.llm.graphs:agg`` on its
  runner, both serving debug-tiny in bf16 on the JAX engine's seed-0
  weights: the same texts, usage and SSE chunk sequences through the HTTP
  edge and the same items from ``Processor.chat`` over the service plane,
  each request served alone; then SIGTERM stops each graph, every child
  included, within the supervisor's timeout.
"""

import asyncio
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def S(pkg):
    m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        sdk=m("sdk"), service=m("sdk.service"), graph=m("sdk.graph"), config=m("sdk.config"),
        allocator=m("sdk.allocator"), worker_main=m("sdk.worker_main"),
        runtime=m("runtime.component"), engine=m("runtime.engine"),
        hub=m("runtime.transports.hub"),
    )


def _graph_classes(pkg):
    """tests/test_sdk.py's three services, declared with ``pkg``'s SDK."""
    sdk, E = S(pkg).sdk, S(pkg).engine

    @sdk.service(namespace="sdktest")
    class Lower:
        @sdk.dynamo_endpoint
        async def transform(self, request: E.Context):
            yield {"text": request.data["text"].lower()}

    @sdk.service(namespace="sdktest")
    class Upper:
        @sdk.dynamo_endpoint
        async def transform(self, request: E.Context):
            yield {"text": request.data["text"].upper()}

    @sdk.service(namespace="sdktest", workers=2, resources={"gpu": 1})
    class Pipeline:
        stage = sdk.depends(Lower, endpoint="transform")
        started = False

        @sdk.async_on_start
        async def boot(self):
            type(self).started = True

        @sdk.dynamo_endpoint
        async def run(self, request: E.Context):
            stream = await self.stage.generate(request.data)
            async for item in stream:
                yield {"text": f"[{item['text']}]"}

    return Lower, Upper, Pipeline


def test_service_meta_discovery_and_link_match_jax():
    got = {}
    for pkg in PKGS:
        X = S(pkg)
        lower, upper, pipeline = _graph_classes(pkg)
        meta = pipeline._dynamo_meta
        graph = X.graph.Graph(pipeline).link(pipeline, upper, endpoint="transform")
        got[pkg] = (
            (meta.name, meta.namespace, meta.workers, meta.resources, meta.endpoints,
             meta.on_start, meta.config),
            [c.__name__ for c in X.graph.discover_services(lower)],
            sorted(X.service.collect_dependencies(pipeline)),
            [c.__name__ for c in graph.services()],
            pipeline.stage.endpoint_name,
            X.service.depends(upper).endpoint_name,
        )
    assert got[PORT] == got[JAX]
    assert got[PORT][3] == ["Pipeline", "Lower", "Upper"]
    assert got[PORT][0][4] == ["run"] and got[PORT][0][5] == ["boot"]


def test_load_target_resolves_a_graph_to_its_entry():
    G = S(PORT).graph
    assert G.load_target("dynamo_tpu_torch.examples.llm.graphs:agg").__name__ == "Frontend"
    assert G.load_target("dynamo_tpu_torch.examples.llm.components:TorchWorker").__name__ == \
        "TorchWorker"
    with pytest.raises(ValueError, match="module:Class"):
        G.load_target("dynamo_tpu_torch.examples.llm.graphs")
    router = G.load_target("dynamo_tpu_torch.examples.llm.graphs:agg_router")
    assert [c.__name__ for c in G.discover_services(router)] == [
        "Frontend", "Processor", "TorchWorker"]
    assert router._dynamo_meta.resources == {}
    worker = G.load_target("dynamo_tpu_torch.examples.llm.components:TorchWorker")
    assert worker._dynamo_meta.resources == {"gpu": 1}
    assert worker._dynamo_meta.namespace == "examples"


CONFIG_TEXT = (
    "# service config\n"
    "Pipeline:\n"
    "  workers: 3\n"
    "  model: llama-3.1-8b\n"
    "  nested:\n"
    "    ratio: 0.5\n"
    "    flag: true\n"
    "    off: False\n"
    "    none: ~\n"
    "Lower:\n"
    "  x: 1.5\n"
    "  name: 'quoted'  # trailing comment\n"
    "  list: [1, two, 3.0]\n"
    "  empty: []\n"
)


@pytest.mark.parametrize("reader", ["pyyaml", "builtin"])
def test_config_store_merge_matches_jax(tmp_path, monkeypatch, reader):
    cfg = tmp_path / "svc.yaml"
    cfg.write_text(CONFIG_TEXT)
    if reader == "builtin":
        monkeypatch.setitem(sys.modules, "yaml", None)  # ImportError: the subset reader
    got = {}
    for pkg in PKGS:
        C = S(pkg).config
        monkeypatch.setenv(C.ENV_VAR, json.dumps({"Pipeline": {"workers": 4}, "New": {"a": 1}}))
        store = C.ServiceConfigStore.load(str(cfg))
        store.set("Lower", "y", [1])
        again = C.ServiceConfigStore(json.loads(store.to_env()))
        got[pkg] = (store.as_dict(), store.for_service("Pipeline"), store.for_service("nope"),
                    again.as_dict(), C._parse_simple_yaml(CONFIG_TEXT),
                    C.load_service_configs(str(cfg)).as_dict())
    assert got[PORT] == got[JAX]
    assert got[PORT][1]["workers"] == 4 and got[PORT][1]["model"] == "llama-3.1-8b"
    assert S(PORT).config.ENV_VAR == "DYN_SERVICE_CONFIG"


def test_allocator_pins_gpus_and_refuses_tpu_requests():
    A = S(PORT).allocator
    J = S(JAX).allocator
    alloc, jalloc = A.GpuAllocator(total_devices=4), J.TpuAllocator(total_chips=4)
    a, b = alloc.assign({"gpu": 2}), alloc.assign({"gpu": 2})
    ja, jb = jalloc.assign({"tpu": 2}), jalloc.assign({"tpu": 2})
    assert (a.devices, b.devices) == (ja.chips, jb.chips) == ([0, 1], [2, 3])
    assert a.env == {"CUDA_VISIBLE_DEVICES": "0,1"} and b.env == {"CUDA_VISIBLE_DEVICES": "2,3"}
    assert alloc.assign({}).env == {"CUDA_VISIBLE_DEVICES": ""}
    assert alloc.assign({"gpu": 0}).env == {"CUDA_VISIBLE_DEVICES": ""}
    with pytest.raises(RuntimeError) as port_err:
        alloc.assign({"gpu": 1})
    with pytest.raises(RuntimeError) as jax_err:
        jalloc.assign({"tpu": 1})
    assert str(port_err.value) == str(jax_err.value).replace("TPU", "GPU")
    with pytest.raises(ValueError, match='"gpu"'):
        A.GpuAllocator(total_devices=4).assign({"tpu": 1})


def test_allocator_device_count(monkeypatch):
    import torch

    A = S(PORT).allocator
    monkeypatch.setenv("DYN_TPU_CHIPS", "3")
    assert A.GpuAllocator().total_devices == 3
    monkeypatch.setenv("DYN_TPU_CHIPS", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert A.GpuAllocator().total_devices == 2
    monkeypatch.delenv("DYN_TPU_CHIPS")
    assert A.GpuAllocator().total_devices == 2


async def test_sdk_graph_end_to_end_in_process():
    """tests/test_sdk.py::test_sdk_graph_end_to_end on the port: Pipeline →
    Lower booted the way worker_main does, in one process."""
    X = S(PORT)
    lower, _, pipeline = _graph_classes(PORT)
    hub = await X.hub.HubServer(host="127.0.0.1", port=0).start()
    rts = []
    try:
        for cls in reversed(X.graph.discover_services(pipeline)):  # deps first
            rt = await X.runtime.DistributedRuntime.connect(hub.address)
            rts.append(rt)
            meta = cls._dynamo_meta
            inst = cls()
            inst.runtime = rt
            for dep in X.service.collect_dependencies(cls).values():
                await dep.resolve(rt)
            comp = rt.namespace(meta.namespace).component(meta.name)
            for ep in meta.endpoints:
                await comp.endpoint(ep).serve_endpoint(getattr(inst, ep))
            for hook in meta.on_start:
                await getattr(inst, hook)()
        assert pipeline.started
        caller = await X.runtime.DistributedRuntime.connect(hub.address)
        rts.append(caller)
        client = await caller.namespace("sdktest").component("Pipeline").endpoint("run").client()
        await client.wait_for_instances(5)
        out = await X.engine.collect(await client.generate(X.engine.Context({"text": "HeLLo"})))
        assert out == [{"text": "[hello]"}]
        await client.close()
    finally:
        for rt in rts:
            await rt.close()
        await hub.close()


# A service whose start hook records what run_worker had done before it.
_sdk = S(PORT).sdk


@_sdk.service(namespace="ordertest")
class OrderLeaf:
    @_sdk.dynamo_endpoint
    async def ping(self, request):
        yield {"pong": request.data}


@_sdk.service(namespace="ordertest")
class OrderProbe:
    leaf = _sdk.depends(OrderLeaf)
    seen = {}

    def __init__(self, config=None):
        self.config = config or {}

    @_sdk.async_on_start
    async def hook(self):
        keys = await self.runtime.hub.kv_get_prefix("instances/ordertest/OrderProbe/")
        items = []
        async for item in await self.leaf.generate("x"):
            items.append(item)
        type(self).seen = {"config": self.config, "served_before_hook": len(keys),
                           "dependency": items}

    @_sdk.dynamo_endpoint
    async def echo(self, request):
        yield request.data


async def test_run_worker_order(monkeypatch):
    """run_worker connects, resolves depends() edges, serves the endpoints
    under its lease, and only then runs the @async_on_start hooks."""
    X = S(PORT)
    monkeypatch.setenv("DYN_SERVICE_CONFIG", json.dumps({"OrderProbe": {"k": 1}}))
    hub = await X.hub.HubServer(host="127.0.0.1", port=0).start()
    tasks = []
    try:
        tasks.append(asyncio.create_task(
            X.worker_main.run_worker(f"{__name__}:OrderLeaf", hub.address)))
        tasks.append(asyncio.create_task(
            X.worker_main.run_worker(f"{__name__}:OrderProbe", hub.address)))
        for _ in range(200):
            if OrderProbe.seen or any(t.done() for t in tasks):
                break
            await asyncio.sleep(0.05)
        for t in tasks:
            if t.done():
                t.result()  # raise the worker's failure
        assert OrderProbe.seen == {"config": {"k": 1}, "served_before_hook": 1,
                                   "dependency": [{"pong": "x"}]}
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await hub.close()


async def test_torch_worker_refuses_tp_like_run():
    """A ``tp`` the model cannot take in TorchWorker's config fails as
    ``run --tp`` does, before any rank starts or any engine is built."""
    from dynamo_tpu_torch.cli import parse_args
    from dynamo_tpu_torch.engine import build_torch_engine
    from dynamo_tpu_torch.examples.llm.components import TorchWorker

    worker = TorchWorker(config={"tp": 3, "device": "cpu", "model": "debug-tiny"})
    with pytest.raises(ValueError) as got:
        await worker.boot()
    with pytest.raises(ValueError) as want:
        build_torch_engine(parse_args(["run", "in=http", "out=torch", "--tp", "3",
                                       "--device", "cpu"]))
    assert str(got.value) == str(want.value)
    assert "must divide num_kv_heads" in str(got.value) and worker.engine is None


# ------------------------------------------------------------- the example graph


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_free(port):
    """Whether a listener could bind ``port`` (as the hub does: SO_REUSEADDR)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
        return True


def _wait_tcp(port, proc, timeout=120.0):
    end = time.time() + timeout
    while time.time() < end:
        if proc.poll() is not None:
            raise AssertionError(f"{proc.args} exited with {proc.returncode}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"port {port} never accepted connections")


def _http(base, method, path, body=None, timeout=120):
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


def _wait_model(base, name, proc, timeout=240.0):
    end = time.time() + timeout
    while time.time() < end:
        if proc.poll() is not None:
            raise AssertionError(f"{proc.args} exited with {proc.returncode}")
        try:
            status, raw = _http(base, "GET", "/v1/models", timeout=5)
            if status == 200 and any(m["id"] == name for m in json.loads(raw)["data"]):
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"model {name!r} never registered at {base}")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


CHAT = {"model": "example-model", "temperature": 0.0, "nvext": {"ignore_eos": True},
        "messages": [{"role": "user", "content": "hi there"}]}
EDGE_REQUESTS = [
    ("/v1/chat/completions", dict(CHAT, max_tokens=8)),
    ("/v1/chat/completions", dict(CHAT, max_tokens=12, stream=True)),
    # Ids, not text: the byte tokenizer's BOS (256) lies outside debug-tiny's
    # vocabulary, which the port refuses where the JAX engine clamps
    # (ROADMAP, deliberate departures, PR 3).
    ("/v1/completions", {"model": "example-model", "prompt": [84, 104, 101, 32, 103, 114],
                         "max_tokens": 10, "temperature": 0.0, "stream": True,
                         "nvext": {"ignore_eos": True}}),
    ("/v1/completions", {"model": "example-model", "prompt": [72, 105, 33], "max_tokens": 6,
                         "temperature": 0.0, "nvext": {"ignore_eos": True}}),
    ("/v1/completions", {"model": "nope", "prompt": "x", "max_tokens": 2}),
]
PROCESSOR_REQUEST = dict(CHAT, max_tokens=5, messages=[{"role": "user", "content": "hello"}])


def _edge_answers(base):
    out = []
    for path, body in EDGE_REQUESTS:  # one at a time: each served alone
        status, raw = _http(base, "POST", path, body)
        if body.get("stream"):
            events = [ln[len("data: "):] for ln in raw.decode().splitlines()
                      if ln.startswith("data: ")]
            out.append((status, [e if e == "[DONE]" else _mask(json.loads(e)) for e in events]))
        else:
            out.append((status, _mask(json.loads(raw))))
    return out


def _processor_items(pkg, hub):
    async def go():
        X = S(pkg)
        rt = await X.runtime.DistributedRuntime.connect(hub)
        try:
            client = await rt.namespace("examples").component("Processor").endpoint("chat").client()
            await client.wait_for_instances(60)
            items = await X.engine.collect(await client.generate(X.engine.Context(
                PROCESSOR_REQUEST)))
            await client.close()
            return [_mask(i) for i in items]
        finally:
            await rt.close()

    return asyncio.run(go())


SITE_HOOK = '''\
import os, sys
# The card's machine has none of these: the port's children run without them.
for _m in ("aiohttp", "pydantic", "prometheus_client", "jinja2", "tokenizers", "xxhash",
           "msgpack"):
    sys.modules[_m] = None
if os.environ.get("JAX_WEIGHTS_NPZ") and any(a.endswith(":TorchWorker") for a in sys.argv):
    # The JAX TpuWorker's seed-0 weights in place of the port's own draw.
    import numpy as np
    import torch
    from dynamo_tpu_torch.engine import engine as _engine
    from dynamo_tpu_torch.models.llama import params_from_jax

    _z = np.load(os.environ["JAX_WEIGHTS_NPZ"])
    _tree = {}
    for _k in _z.files:
        _g, _, _n = _k.rpartition(".")
        (_tree.setdefault(_g, {}) if _g else _tree)[_n] = _z[_k]

    def _cast(t, dt):
        return {k: _cast(v, dt) for k, v in t.items()} if isinstance(t, dict) else t.to(dt)

    _engine.init_params = lambda mc, seed, dev: _cast(params_from_jax(_tree, dev),
                                                      getattr(torch, mc.dtype))
'''


def _jax_worker_weights(path):
    """The JAX TpuWorker's engine weights (debug-tiny, its EngineConfig at
    seed 0, bf16), as exact f32 values in an npz (``layers.wq`` etc.)."""
    import jax.numpy as jnp

    from dynamo_tpu.engine import EngineConfig
    from dynamo_tpu.engine.engine import TpuEngine

    engine = TpuEngine(EngineConfig(model="debug-tiny", block_size=16, num_blocks=256,
                                    max_batch=8, max_model_len=1024, tp=1))
    flat = {}
    for k, v in engine.params.items():
        leaves = v.items() if isinstance(v, dict) else [(None, v)]
        for n, x in leaves:
            flat[k if n is None else f"{k}.{n}"] = np.asarray(jnp.asarray(x, jnp.float32))
    np.savez(path, **flat)
    return str(path)


def _child_env(extra=None):
    from conftest import hermetic_child_env

    return {**hermetic_child_env(REPO), "DYN_TPU_CHIPS": "1", **(extra or {})}


def _stop(proc, timeout):
    """SIGTERM ``proc``; its exit seconds (None when it had to be killed)."""
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout)
        return time.monotonic() - t0
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
        return None


def _children(pid):
    """Live processes whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return out


def test_example_graph_serves_like_jax(tmp_path):
    """The port's example graph through its runner answers the JAX graph's
    requests alike, and stops on SIGTERM with all its children."""
    assert _port_free(6650), "the runner's default hub port 6650 is taken"
    cfg = tmp_path / "graph.yaml"
    cfg.write_text("TorchWorker:\n  device: cpu\n  model: debug-tiny\n")
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITE_HOOK)
    weights = _jax_worker_weights(tmp_path / "weights.npz")
    logs = {}
    procs = {}

    def spawn(name, argv, env):
        logs[name] = open(tmp_path / f"{name}.log", "w")
        procs[name] = subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                                       stdout=logs[name], stderr=subprocess.STDOUT,
                                       start_new_session=True)
        return procs[name]

    try:
        # One graph at a time (each is a handful of processes): the JAX
        # graph's answers first, on a hub of its own.
        jax_hub_port, jax_http, port_http = _free_port(), _free_port(), _free_port()
        jax_hub = spawn("jax-hub", ["-m", "dynamo_tpu.cli", "hub", "--host", "127.0.0.1",
                                    "--port", str(jax_hub_port)], _child_env())
        _wait_tcp(jax_hub_port, jax_hub)
        jax_graph = spawn("jax-graph", [
            "-m", "dynamo_tpu.sdk.runner", "examples.llm.graphs:agg",
            "--hub", f"127.0.0.1:{jax_hub_port}", "--http-port", str(jax_http), "--router", "kv",
        ], _child_env())
        base = f"http://127.0.0.1:{jax_http}"
        _wait_model(base, "example-model", jax_graph)
        answers = {JAX: _edge_answers(base)}
        items = {JAX: _processor_items(JAX, f"127.0.0.1:{jax_hub_port}")}
        assert _stop(jax_graph, 15) is not None
        _stop(jax_hub, 15)

        port_env = _child_env({"PYTHONPATH": f"{site}{os.pathsep}{REPO}",
                               "JAX_WEIGHTS_NPZ": weights})
        port_graph = spawn("port-graph", [
            "-m", "dynamo_tpu_torch.sdk.runner", "dynamo_tpu_torch.examples.llm.graphs:agg",
            "-f", str(cfg), "--http-port", str(port_http), "--router", "kv",
        ], port_env)
        base = f"http://127.0.0.1:{port_http}"
        _wait_model(base, "example-model", port_graph)
        answers[PORT] = _edge_answers(base)
        items[PORT] = _processor_items(PORT, "127.0.0.1:6650")
        assert answers[PORT] == answers[JAX]
        assert items[PORT] == items[JAX]
        statuses = [s for s, _ in answers[PORT]]
        assert statuses == [200, 200, 200, 200, 404]
        unary = answers[PORT][0][1]
        assert unary["usage"]["completion_tokens"] == 8
        assert unary["choices"][0]["finish_reason"] == "length"
        assert answers[PORT][1][1][-1] == "[DONE]"
        assert items[PORT][-1]["choices"][0]["finish_reason"] == "length"

        kids = _children(port_graph.pid)
        assert len(kids) == 5  # hub, Frontend, Processor, TorchWorker, http edge
        took = _stop(port_graph, 15)
        assert took is not None and took < 12, took  # the supervisor's 10 s timeout
        alive = [k for k in kids if os.path.exists(f"/proc/{k}") and
                 open(f"/proc/{k}/stat").read().rsplit(")", 1)[1].split()[0] != "Z"]
        assert alive == []
    finally:
        for p in procs.values():  # each runner's group holds its children
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait(10)
        for f in logs.values():
            f.close()
        for name in logs:
            if procs[name].returncode not in (0, -signal.SIGTERM):
                print(f"=== {name}\n", (tmp_path / f"{name}.log").read_text()[-3000:])
