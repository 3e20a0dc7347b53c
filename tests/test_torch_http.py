"""The port's OpenAI HTTP path end to end against the JAX package's.

One JAX ``HttpService`` → ``OpenAIPreprocessor`` → ``Backend`` →
``TpuEngine`` (debug-tiny, f32, its XLA attention on the CPU) and one port
``HttpService`` → pipeline → ``TorchEngine(device="cpu")`` with the same
weights (``params_from_jax``) listen on free ports in one event loop, which
runs in a thread for the whole module so both engines are built and
compiled once.  The same requests go to both, one at a time, through an
aiohttp client; statuses, error type/code/param, texts, finish reasons,
usage and the SSE chunk sequences (``id`` and ``created`` masked) must be
identical.  Then: a client that disconnects mid-stream frees the port's
engine row, connections are kept alive, and the port's CLI serves
(``in=batch`` against the JAX CLI's output, ``in=http out=torch`` as a
subprocess).
"""

import asyncio
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
from aiohttp import ClientSession
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm import Backend as JaxBackend
from dynamo_tpu.llm import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.llm import HttpService as JaxHttpService
from dynamo_tpu.llm import OpenAIPreprocessor as JaxPreprocessor
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime import build_pipeline as jax_build_pipeline
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.runtime.pipeline import build_pipeline

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(
    model="debug-tiny", block_size=4, num_blocks=128, max_batch=4, max_model_len=128,
    prefill_chunk=16, dtype="float32", decode_steps=4,
)
PROMPT = [5, 17, 33, 2, 250, 9, 61]
CHAT = {"model": "m", "messages": [{"role": "user", "content": "hello there"}]}


class _Servers:
    """Both stacks on one event loop, run by a thread for the module."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.run(self._start(), timeout=300)

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def _start(self):
        params = jax_init_params(
            jax_get_config("debug-tiny").with_overrides(dtype="float32"), jax.random.PRNGKey(0))
        self.jax_engine = TpuEngine(JaxEngineConfig(**CFG), params=params)
        tree = jax.tree_util.tree_map(np.asarray, params)
        self.engine = TorchEngine(EngineConfig(**CFG), params=params_from_jax(tree, device="cpu"),
                                  device="cpu")
        jtok, ttok = JaxByteTokenizer(), ByteTokenizer()
        self.jax_service = JaxHttpService(host="127.0.0.1", port=0)
        self.service = HttpService(host="127.0.0.1", port=0)
        for service, pipeline in (
            (self.jax_service, jax_build_pipeline(
                [JaxPreprocessor(jtok, "m"), JaxBackend(jtok)], self.jax_engine)),
            (self.service, build_pipeline([OpenAIPreprocessor(ttok, "m"), Backend(ttok)],
                                          self.engine)),
        ):
            service.models.add_chat_model("m", pipeline)
            service.models.add_completion_model("m", pipeline)
            await service.start()
        self.jax_base = f"http://127.0.0.1:{self.jax_service.port}"
        self.base = f"http://127.0.0.1:{self.service.port}"

    async def _stop(self):
        await self.jax_service.close()
        await self.service.close()
        await self.jax_engine.close()
        await self.engine.close()

    def close(self):
        try:
            self.run(self._stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()


@pytest.fixture(scope="module")
def servers():
    s = _Servers()
    try:
        yield s
    finally:
        s.close()


async def _post(base, path, body=None, raw=None, headers=None):
    data = raw if raw is not None else json.dumps(body)
    async with ClientSession() as http:
        async with http.post(base + path, data=data,
                             headers={"Content-Type": "application/json", **(headers or {})}) as r:
            return r.status, r.headers.get("Content-Type", ""), await r.text(), dict(r.headers)


def _mask(obj):
    if isinstance(obj, dict):
        obj.pop("id", None)
        obj.pop("created", None)
    return obj


def _shape(status, ctype, text):
    """Status and body with ids and timestamps masked: the SSE events in
    order for a stream, else the JSON body; errors keep type/code/param."""
    if ctype.startswith("text/event-stream"):
        events = []
        for block in text.split("\n\n"):
            if not block:
                continue
            lines = block.split("\n")
            data = lines[-1][len("data: "):]
            events.append((lines[:-1], data if data == "[DONE]" else _mask(json.loads(data))))
        return status, events
    body = _mask(json.loads(text))
    if "error" in body:
        body = {k: body["error"].get(k) for k in ("type", "code", "param")}
    return status, body


async def _both(s, path, body=None, raw=None):
    """The same request to the JAX stack, then to the port's."""
    want = await _post(s.jax_base, path, body, raw)
    got = await _post(s.base, path, body, raw)
    return _shape(*want[:3]), _shape(*got[:3])


CASES = {
    "completion-unary": ("/v1/completions", dict(model="m", prompt=PROMPT, max_tokens=20)),
    "completion-stream": ("/v1/completions", dict(model="m", prompt=PROMPT, max_tokens=20,
                                                  stream=True)),
    "chat-unary": ("/v1/chat/completions", dict(CHAT, max_tokens=24)),
    "chat-stream": ("/v1/chat/completions", dict(CHAT, max_tokens=24, stream=True)),
    "chat-ignore-eos-min-tokens": ("/v1/chat/completions", dict(
        CHAT, max_tokens=30, min_tokens=6, stream=True, nvext={"ignore_eos": True})),
    "completion-annotations": ("/v1/completions", dict(
        model="m", prompt=list(range(40, 61)), max_tokens=9, stream=True,
        nvext={"annotations": ["token_ids"]})),
    "chat-raw-prompt-annotations": ("/v1/chat/completions", dict(
        CHAT, max_tokens=7, stream=True,
        nvext={"use_raw_prompt": True, "annotations": ["formatted_prompt", "token_ids"]})),
    "n2-seeded-unary": ("/v1/completions", dict(model="m", prompt=PROMPT, max_tokens=11, n=2,
                                                seed=5, temperature=0)),
    "unknown-model": ("/v1/completions", dict(model="nope", prompt=PROMPT)),
    "unknown-model-chat-stream": ("/v1/chat/completions", dict(CHAT, model="nope", stream=True)),
    "missing-model": ("/v1/chat/completions", {"messages": CHAT["messages"]}),
    "bad-top-logprobs": ("/v1/chat/completions", dict(CHAT, logprobs=True, top_logprobs=21)),
    "bad-logprobs": ("/v1/completions", dict(model="m", prompt=PROMPT, logprobs=21)),
    "bad-field-type": ("/v1/completions", dict(model="m", prompt=PROMPT, max_tokens="many")),
    "bad-messages": ("/v1/chat/completions", dict(model="m", messages=[{"content": "x"}])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_responses_match_jax(servers, case):
    path, body = CASES[case]
    want, got = servers.run(_both(servers, path, body))
    assert got == want


@pytest.mark.parametrize("raw", [b"{not json", b"", b"\xff\xfe"], ids=["garbled", "empty", "not-utf8"])
def test_invalid_json_matches_jax(servers, raw):
    want, got = servers.run(_both(servers, "/v1/completions", raw=raw))
    assert got == want == (400, {"type": "invalid_request_error", "code": 400, "param": None})


def test_stop_string_matches_jax(servers):
    body = dict(CHAT, max_tokens=40, nvext={"ignore_eos": True})
    full = servers.run(_post(servers.jax_base, "/v1/chat/completions", body))
    text = json.loads(full[2])["choices"][0]["message"]["content"]
    stop = text[6:8]
    assert len(stop) == 2
    for stream in (False, True):
        want, got = servers.run(_both(servers, "/v1/chat/completions",
                                      dict(body, stop=[stop, "never"], stream=stream)))
        assert got == want
    assert json.loads(servers.run(_post(servers.base, "/v1/chat/completions", dict(
        body, stop=stop)))[2])["choices"][0]["message"]["content"] == text[: text.index(stop)]


def test_n2_seeded_stream_matches_jax_per_choice(servers):
    """n = 2 merges two engine streams whose interleaving follows task
    scheduling: each choice's own chunk sequence and the summed usage
    chunk must match."""
    body = dict(model="m", prompt=PROMPT, max_tokens=13, n=2, seed=9, temperature=0, stream=True)
    (ws, want), (gs, got) = servers.run(_both(servers, "/v1/completions", body))
    assert ws == gs == 200

    def by_choice(events):
        out = {}
        for _, ev in events[:-2]:
            for ch in ev["choices"]:
                out.setdefault(ch["index"], []).append(ch)
        return out, events[-2:]

    assert by_choice(got) == by_choice(want)
    assert set(by_choice(got)[0]) == {0, 1}


def test_n2_sampled_matches_jax_in_shape_and_reproduces(servers):
    """Seeded sampling at temperature > 0: the port's draws are its own
    counter-hash stream, not jax.random (ops/sampling.py), so texts differ;
    statuses, choices, finish reasons and usage must not, and a rerun of
    the port's request must reproduce its texts."""
    body = dict(model="m", prompt=PROMPT, max_tokens=10, n=2, seed=3, temperature=0.9,
                nvext={"ignore_eos": True})
    (ws, want), (gs, got) = servers.run(_both(servers, "/v1/completions", body))
    assert ws == gs == 200
    assert got["usage"] == want["usage"]
    assert [(c["index"], c["finish_reason"]) for c in got["choices"]] == [
        (c["index"], c["finish_reason"]) for c in want["choices"]]
    again = _shape(*servers.run(_post(servers.base, "/v1/completions", body))[:3])[1]
    assert again == got


def test_models_health_and_request_ids_match_jax(servers):
    async def get(base, path):
        async with ClientSession() as http:
            async with http.get(base + path) as r:
                return r.status, await r.json()

    for path in ("/v1/models", "/health", "/live"):
        want, got = servers.run(get(servers.jax_base, path)), servers.run(get(servers.base, path))
        for _, body in (want, got):
            for m in body.get("data", []):
                m.pop("created")
        assert got == want
    for base in (servers.jax_base, servers.base):
        status, _, _, headers = servers.run(_post(
            base, "/v1/completions", dict(model="m", prompt=PROMPT, max_tokens=2),
            headers={"x-request-id": "abc"}))
        assert status == 200 and headers["x-request-id"].startswith("abc-")
        assert len(headers["x-request-id"]) == len("abc-") + 8


def test_keep_alive_and_metrics(servers):
    async def go():
        async with ClientSession() as http:  # one pooled connection, reused
            out = []
            for stream in (False, True, False):
                body = dict(model="m", prompt=PROMPT, max_tokens=5, stream=stream)
                async with http.post(servers.base + "/v1/completions", json=body) as r:
                    out.append((r.status, await r.text()))
            async with http.get(servers.base + "/metrics") as r:
                out.append((r.status, await r.text()))
            async with http.get(servers.base + "/nope") as r:
                out.append((r.status, ""))
            async with http.get(servers.base + "/v1/completions") as r:
                out.append((r.status, ""))
            return out

    *replies, metrics, missing, wrong_method = servers.run(go())
    assert [s for s, _ in replies] == [200, 200, 200]
    assert replies[1][1].endswith("data: [DONE]\n\n")
    assert (missing[0], wrong_method[0]) == (404, 405)
    samples = {(s.name, tuple(sorted(s.labels.items()))): s.value
               for f in text_string_to_metric_families(metrics[1]) for s in f.samples}
    ok = (("endpoint", "completions"), ("model", "m"), ("request_type", "unary"),
          ("status", "success"))
    assert samples[("dynamo_tpu_http_service_requests_total", ok)] >= 2
    assert any(n == "dynamo_tpu_http_service_time_to_first_token_seconds_count"
               for n, _ in samples)


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_engine_dispatch_metrics_match_jax(servers):
    """With each engine wired to its package's ``engine_dispatch_metrics``
    (as ``run in=http`` wires a colocated engine), the same trace through
    both servers leaves ``dispatch_summary()`` with the JAX engine's key
    set, step kinds included, and ``/metrics`` with the JAX server's
    engine-dispatch family names."""
    from dynamo_tpu.llm.metrics import engine_dispatch_metrics as jax_dispatch_metrics
    from dynamo_tpu_torch.llm.metrics import engine_dispatch_metrics

    async def trace(base):
        bodies = [dict(model="m", prompt=PROMPT[: 3 + i], max_tokens=10 + 3 * i,
                       nvext={"ignore_eos": True}) for i in range(3)]
        replies = await asyncio.gather(*(_post(base, "/v1/completions", b) for b in bodies))
        assert [r[0] for r in replies] == [200] * 3
        async with ClientSession() as http:
            async with http.get(base + "/metrics") as r:
                return await r.text()

    def families(text):
        return {f.name for f in text_string_to_metric_families(text)
                if f.name.startswith("dynamo_tpu_engine_")}

    jax_dispatch_metrics.set_source(servers.jax_engine.dispatch_summary)
    engine_dispatch_metrics.set_source(servers.engine.dispatch_summary)
    try:
        servers.jax_engine.reset_dispatch_stats()
        servers.engine.reset_dispatch_stats()
        want_text = servers.run(trace(servers.jax_base))
        got_text = servers.run(trace(servers.base))
        want, got = servers.jax_engine.dispatch_summary(), servers.engine.dispatch_summary()
    finally:
        jax_dispatch_metrics.set_source(None)
        engine_dispatch_metrics.set_source(None)
    assert _key_tree(got) == _key_tree(want)
    assert got["pipeline"]["sessions"] >= 1 and "decode_dispatch" in got["kinds"]
    assert families(got_text) == families(want_text)
    assert "dynamo_tpu_engine_dispatch_pipeline_sessions" in families(got_text)


@pytest.mark.parametrize("head,status", [
    (b"GET /health HTTP/1.0\r\n\r\n", 505),
    (b"NONSENSE\r\n\r\n", 400),
    (b"GET /health HTTP/1.1\r\nno colon here\r\n\r\n", 400),
    (b"POST /v1/completions HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", 501),
    (b"POST /v1/completions HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n", 413),
    (b"POST /v1/completions HTTP/1.1\r\nContent-Length: x\r\n\r\n", 400),
], ids=["http-1.0", "request-line", "header", "chunked-body", "too-large", "content-length"])
def test_malformed_requests_get_an_error_and_a_close(servers, head, status):
    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", servers.service.port)
        writer.write(head)
        await writer.drain()
        reply = await asyncio.wait_for(reader.read(), 10)  # the server closes
        writer.close()
        await writer.wait_closed()
        return reply

    reply = servers.run(go())
    assert reply.startswith(b"HTTP/1.1 %d " % status), reply[:80]
    assert b"Connection: close" in reply


def test_client_disconnect_frees_the_engine_row(servers):
    """A client that closes its connection after the first SSE chunk: the
    edge stops generation and records client_drop, and the scheduler holds
    no row long before the request's own end (each fused dispatch is slowed
    to 0.2 s here, so 100 tokens would take 5 s)."""
    engine = servers.engine
    multi = engine._multi

    def slow_multi(*args, **kwargs):
        time.sleep(0.2)
        return multi(*args, **kwargs)

    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", servers.service.port)
        body = json.dumps(dict(model="m", prompt=PROMPT, max_tokens=100, stream=True,
                               nvext={"ignore_eos": True})).encode()
        writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                     b"application/json\r\nContent-Length: %d\r\n\r\n%b" % (len(body), body))
        await writer.drain()
        while b"data: {" not in await reader.readline():
            pass
        assert engine.scheduler.num_running == 1
        writer.close()
        await writer.wait_closed()
        t0 = time.monotonic()
        while engine.scheduler.num_running or engine.scheduler.num_waiting:
            assert time.monotonic() - t0 < 3.0, "the dropped request still holds a row"
            await asyncio.sleep(0.02)
        return time.monotonic() - t0

    engine._multi = slow_multi
    try:
        servers.run(go())
    finally:
        engine._multi = multi
    text = servers.service.metrics.render().decode()
    assert 'status="client_drop"} 1.0' in text



# The overload plane on the real pipelines: both servers get the same
# admission controller, QoS controller or header, then the same requests.
def _overflow(pkg):
    res = importlib.import_module(f"{pkg}.runtime.resilience")
    return {"admission": res.AdmissionController(max_inflight=1, max_queue=0)}


def _quota(pkg):
    qos = importlib.import_module(f"{pkg}.llm.qos")
    return {"qos": qos.QosController(qos.QosConfig(rate=0.001, burst=1.0))}


def _brownout(pkg):
    qos = importlib.import_module(f"{pkg}.llm.qos")
    ctl = qos.QosController(qos.QosConfig(brownout=qos.BrownoutConfig(max_tokens_cap=3),
                                          tick_s=30.0))
    ctl.ladder.rung = 3  # caps max_tokens and sheds the batch class
    return {"qos": ctl}


def _sampler(pkg):
    tr = importlib.import_module(f"{pkg}.runtime.tracing")
    return {"tracing": tr.TraceSampler(tr.TracingConfig(sample=0.0))}


STREAM = dict(model="m", prompt=PROMPT, max_tokens=12, stream=True, nvext={"ignore_eos": True})
EDGE_CASES = {
    # (service attributes, [(headers, body)], concurrent)
    "overflow-429": (_overflow, [({}, dict(STREAM, max_tokens=40))] * 3, True),
    "quota-429": (_quota, [({"x-tenant": "t"}, STREAM)] * 2, False),
    "brownout-cap-and-batch-shed": (_brownout, [({}, dict(STREAM, max_tokens=9)),
                                                ({"x-priority": "batch"}, STREAM)], False),
    "deadline-504-unary": (None, [({"x-deadline-s": "0.000001"}, dict(STREAM, stream=False))],
                           False),
    "deadline-504-sse-event": (None, [({}, dict(STREAM, deadline_s=0.000001))], False),
    "traced-equals-untraced": (_sampler, [({"x-trace": "1"}, STREAM), ({}, STREAM)], False),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edge_paths_match_jax(servers, case):
    setup, requests, concurrent = EDGE_CASES[case]

    async def run(base):
        calls = [_post(base, "/v1/completions", body, headers=h) for h, body in requests]
        if concurrent:
            replies = await asyncio.gather(*calls)
        else:
            replies = [await c for c in calls]
        out = [(*_shape(st, ct, text), hdrs.get("Retry-After"), "x-trace-id" in hdrs)
               for st, ct, text, hdrs in replies]
        return sorted(out, key=json.dumps) if concurrent else out

    results = []
    for pkg, service, base in (("dynamo_tpu", servers.jax_service, servers.jax_base),
                               ("dynamo_tpu_torch", servers.service, servers.base)):
        saved = {"admission": service.admission, "qos": service.qos, "tracing": service.tracing}
        if setup is not None:
            for k, v in setup(pkg).items():
                setattr(service, k, v)
        try:
            results.append(servers.run(run(base)))
        finally:
            for k, v in saved.items():
                setattr(service, k, v)
    want, got = results
    assert got == want
    statuses = [r[0] for r in got]
    if case == "overflow-429":
        assert statuses == [200, 429, 429] and got[1][2] == "1"
    elif case == "quota-429":
        assert statuses == [200, 429] and got[1][2] == "999"
    elif case == "brownout-cap-and-batch-shed":
        assert statuses == [200, 429]
        assert got[0][1][-2][1]["usage"]["completion_tokens"] == 3  # capped from 9
    elif case.startswith("deadline"):
        assert "504" in json.dumps(got)
    else:
        assert got[0][1] == got[1][1] and [r[3] for r in got] == [True, False]


def test_traces_endpoints_404_without_aggregator_match_jax(servers):
    async def get(base, path):
        async with ClientSession() as http:
            async with http.get(base + path) as r:
                return r.status, await r.text()

    for path in ("/traces", "/traces?recent=2", "/traces/abc"):
        want = servers.run(get(servers.jax_base, path))
        got = servers.run(get(servers.base, path))
        assert got == want and got[0] == 404


# ---------------------------------------------------------------------- CLI


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "DYN_LOG": "warning"}


def test_cli_batch_matches_jax_cli(tmp_path):
    lines = [{"text": "hello"}, {"text": "héllo wörld, twice"}, {"text": ""}]
    rows = {}
    for pkg in ("dynamo_tpu", "dynamo_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "in.jsonl").write_text("\n".join(json.dumps(x) for x in lines) + "\n")
        p = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", "run", f"in=batch:{d / 'in.jsonl'}", "out=echocore",
             "--max-tokens", "12"],
            env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
        assert p.returncode == 0, p.stderr
        rows[pkg] = [dict(json.loads(x), elapsed_ms=None)
                     for x in (d / "output.jsonl").read_text().splitlines()]
    assert rows["dynamo_tpu_torch"] == rows["dynamo_tpu"]
    assert [r["finish_reason"] for r in rows["dynamo_tpu"]] == ["length"] * 3


# The card's machine has none of these; the port's CLI runs without them.
WITHOUT_ABSENT_PACKAGES = (
    "import sys\n"
    "for m in ('aiohttp', 'pydantic', 'prometheus_client', 'jinja2', 'tokenizers', 'xxhash'):\n"
    "    sys.modules[m] = None\n"
    "from dynamo_tpu_torch.cli import main\n"
    "main()\n"
)


def test_cli_serves_http_out_torch():
    """``run in=http out=torch`` as a user starts it, in an interpreter
    where aiohttp, pydantic, prometheus_client, jinja2, tokenizers and
    xxhash cannot be imported."""
    p = subprocess.Popen(
        [sys.executable, "-c", WITHOUT_ABSENT_PACKAGES, "run", "in=http", "out=torch",
         "--arch", "debug-tiny", "--dtype", "float32", "--device", "cpu", "--port", "0",
         "--host", "127.0.0.1", "--max-model-len", "128", "--num-blocks", "64"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = p.stdout.readline()
        assert line.startswith("serving 'echo' on http://127.0.0.1:"), (line, p.stderr.read())
        base = line.strip().split(" on ")[1]
        body = dict(model="echo", prompt=PROMPT, max_tokens=6, nvext={"ignore_eos": True})
        status, _, text, _ = asyncio.run(_post(base, "/v1/completions", body))
        assert status == 200, text
        assert json.loads(text)["usage"]["completion_tokens"] == 6
    finally:
        p.send_signal(signal.SIGINT)
        try:
            p.wait(timeout=30)
        finally:
            p.kill()
    assert p.returncode == 0


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--checkpoint", "x"], ["--kv-pull-mb", "8"],
                                  ["--sp", "2"], ["--lora", "a=random"], ["--nnodes", "2"],
                                  ["--tokenizer", "tok.json"]])
def test_cli_refuses_options_the_port_lacks(flag):
    from dynamo_tpu_torch import cli

    args = cli.parse_args(["run", "in=http", "out=torch", "--device", "cpu", *flag])
    with pytest.raises(SystemExit, match="ROADMAP"):
        asyncio.run(cli._run(args))
