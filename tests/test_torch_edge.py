"""The port's overload plane against the JAX package's: admission control,
deadlines, QoS (quotas, priority, brownout) and the HTTP edge's status
paths, on the CPU.

- the copied classes (``runtime/resilience.py``, ``llm/qos.py``,
  ``llm/metrics.py``'s ``TimedWindow`` and ``QosMetrics``,
  ``labels.hash_credential``, the ``qos`` and ``tracing`` config
  sections) are driven through the same sequences as the JAX ones,
  with an injected clock where time matters: decisions, Retry-After
  values, rungs, transitions and rendered metrics must be equal (the unit
  tests of ``tests/test_resilience.py`` and ``tests/test_qos.py`` that
  need no hub, run on both packages);
- one JAX ``HttpService`` and one port ``HttpService``, configured alike,
  each over its own package's stand-in engine, get the same requests:
  429 on admission overflow, 503 on an admission-wait timeout, 504 at
  dispatch, mid-generation and as the SSE error event mid-stream, the QoS
  quota, batch-shed and rung-4 sheds, ``/health``'s brownout field and
  ``/traces`` without an aggregator.  Statuses, bodies (ids masked),
  ``Retry-After`` and SSE event sequences must be equal.
"""

import asyncio
import importlib
import json
import random

import pytest
from aiohttp import ClientSession

pytestmark = pytest.mark.torch_port

PKGS = ("dynamo_tpu", "dynamo_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _reset_singletons():
    for pkg in PKGS:
        _mod(pkg, "runtime.resilience").metrics.reset()
        _mod(pkg, "llm.metrics").qos_metrics.reset()
    yield
    for pkg in PKGS:
        _mod(pkg, "runtime.resilience").metrics.reset()
        _mod(pkg, "llm.metrics").qos_metrics.reset()


def _both(fn, *args):
    """``fn(pkg, *args)`` for the JAX package, then the port."""
    return [fn(pkg, *args) for pkg in PKGS]


async def _both_async(fn, *args):
    return [await fn(pkg, *args) for pkg in PKGS]


# ------------------------------------------------------------- resilience


def _deadline_trace(pkg):
    res = _mod(pkg, "runtime.resilience")
    d = res.Deadline.after(1000)
    past = res.Deadline.after(-0.001)
    out = [d.expired, d.remaining() > 999, past.expired]
    try:
        past.check("unit")
    except res.DeadlineExceededError as e:
        out.append(str(e))

    class Ctx:
        deadline = d

    out.append(res.deadline_of(Ctx()) is d and res.deadline_of(object()) is None)

    async def slow():
        await asyncio.sleep(5)

    try:
        asyncio.run(res.Deadline.after(0.01).bound(slow(), "bound"))
    except res.DeadlineExceededError as e:
        out.append(str(e))
    return out


def test_deadline_matches_jax():
    jax_out, port_out = _both(_deadline_trace)
    assert port_out == jax_out
    assert port_out[-1] == "deadline exceeded (bound)"


async def _admission_trace(pkg):
    """The admission scenarios of tests/test_resilience.py and
    tests/test_qos.py on one package: every decision, status, message and
    Retry-After, then the rendered resilience metrics."""
    res = _mod(pkg, "runtime.resilience")
    out = []

    async def attempt(adm, priority="interactive"):
        try:
            await adm.acquire(priority)
            return ("ok", adm.inflight, adm.queued)
        except res.AdmissionRejected as e:
            return (e.status, e.message, e.retry_after_s, adm.inflight, adm.queued)

    # Shed and hand over.
    adm = res.AdmissionController(max_inflight=1, max_queue=1, queue_timeout_s=0.2)
    out.append(await attempt(adm))
    waiter = asyncio.ensure_future(attempt(adm))
    await asyncio.sleep(0.01)
    out.append((adm.queued, adm.saturated))
    out.append(await attempt(adm))
    adm.release()
    out.append(await waiter)
    adm.release()
    out.append((adm.inflight, adm.queued, adm.saturated))
    # The wait times out: 503.
    adm = res.AdmissionController(max_inflight=1, max_queue=2, queue_timeout_s=0.05)
    out.append(await attempt(adm))
    out.append(await attempt(adm))
    adm.release()
    out.append((adm.inflight, adm.queued))
    # Batch requests hold only the front half of the queue.
    adm = res.AdmissionController(max_inflight=1, max_queue=4, queue_timeout_s=5.0,
                                  batch_queue_frac=0.5)
    out.append(await attempt(adm))
    batch = [asyncio.ensure_future(attempt(adm, "batch")) for _ in range(2)]
    await asyncio.sleep(0)
    out.append(adm.queued)
    out.append(await attempt(adm, "batch"))
    inter = asyncio.ensure_future(attempt(adm))
    await asyncio.sleep(0)
    out.append(adm.queued)
    for _ in range(3):
        adm.release()
    out.append(await asyncio.gather(*batch, inter))
    # Disabled: everything admits.
    adm = res.AdmissionController()
    out.append([await attempt(adm) for _ in range(3)])
    out.append(res.metrics.render("dynamo_tpu"))
    return out


async def test_admission_controller_matches_jax():
    jax_out, port_out = await _both_async(_admission_trace)
    assert port_out == jax_out
    statuses = [x[0] for x in port_out if isinstance(x, tuple) and isinstance(x[0], int)]
    assert 429 in statuses and 503 in statuses
    assert 'admission_shed_total{status="429"} 2' in port_out[-1]


def _drain_trace(pkg):
    res = _mod(pkg, "runtime.resilience")
    now = [0.0]
    adm = res.AdmissionController(max_inflight=1, max_queue=8, queue_timeout_s=1.0,
                                  clock=lambda: now[0])
    out = [adm.estimate_retry_after(), adm.drain_rate()]
    adm._inflight = 5
    for i in range(12):
        now[0] += 0.5 if i % 3 else 0.25
        adm.release()
        out.append((adm.drain_rate(), adm.estimate_retry_after(), adm.estimate_retry_after(6),
                    adm.inflight))
    return out


def test_admission_drain_rate_retry_after_matches_jax():
    jax_out, port_out = _both(_drain_trace)
    assert port_out == jax_out
    assert port_out[0] == 1.0


def _admission_random_trace(pkg, seed):
    """AdmissionController through a seeded random sequence of acquires
    (both classes; no wait queue, so a full controller sheds at once),
    releases, clock steps and Retry-After estimates, then the rendered
    metrics."""
    res = _mod(pkg, "runtime.resilience")
    res.metrics.reset()
    rng = random.Random(seed)
    now = [0.0]
    adm = res.AdmissionController(max_inflight=rng.randint(1, 4), queue_timeout_s=2.0,
                                  clock=lambda: now[0])

    async def run():
        out = []
        for _ in range(80):
            op = rng.choice(["acquire", "batch", "release", "tick", "estimate"])
            if op in ("acquire", "batch"):
                try:
                    await adm.acquire("batch" if op == "batch" else "interactive")
                    res_ = "ok"
                except res.AdmissionRejected as e:
                    res_ = (e.status, e.message, e.retry_after_s)
            elif op == "release":
                adm.release()
                res_ = None
            elif op == "tick":
                now[0] += rng.uniform(0.0, 0.5)
                res_ = None
            else:
                res_ = adm.estimate_retry_after(rng.randint(1, 8))
            out.append((op, res_, adm.inflight, adm.saturated, adm.drain_rate()))
        return out

    out = asyncio.run(run())
    out.append(res.metrics.render("dynamo_tpu"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_random_sequence_matches_jax(seed):
    jax_out, port_out = _both(_admission_random_trace, seed)
    assert port_out == jax_out


# -------------------------------------------------------------------- QoS

TENANT_CASES = [
    ({"x-tenant": "a", "x-api-key": "b"}, {"model": "llama"}),
    ({"x-tenant": "  spaced  "}, {}),
    ({"x-api-key": "sk-secret"}, {"model": "llama"}),
    ({"authorization": "Bearer tok123"}, {}),
    ({"authorization": "Bearer   "}, {"nvext": {"tenant": "nv-t"}}),
    ({}, {"model": "llama", "nvext": {"tenant": "nv-t", "priority": "batch"}}),
    ({}, {"model": "llama", "nvext": None}),
    ({}, {"model": "llama"}),
    ({}, {}),
    ({"x-priority": "batch"}, {}),
    ({"x-priority": "BATCH"}, {"nvext": {"priority": "interactive"}}),
    ({"x-priority": "urgent!!"}, {"nvext": {"priority": "batch"}}),
    ({}, {"nvext": {"priority": 3}}),
]


@pytest.mark.parametrize("case", range(len(TENANT_CASES)))
def test_resolve_tenant_and_priority_match_jax(case):
    headers, body = TENANT_CASES[case]

    def run(pkg):
        qos = _mod(pkg, "llm.qos")
        return qos.resolve_tenant(headers, body), qos.resolve_priority(headers, body)

    jax_out, port_out = _both(run)
    assert port_out == jax_out
    labels = [_mod(pkg, "labels").hash_credential("sk-secret") for pkg in PKGS]
    assert labels[0] == labels[1] and labels[1].startswith("key:")


def _quota_trace(pkg, seed):
    qos = _mod(pkg, "llm.qos")
    rng = random.Random(seed)
    now = [0.0]
    quotas = qos.TenantQuotas(rate=2.0, burst=3.0, tenants={"gold": {"rate": 10.0, "burst": 20.0},
                                                           "slow": {"rate": 0.5}},
                              clock=lambda: now[0], max_tenants=4)
    out = []
    for _ in range(200):
        op = rng.random()
        tenant = rng.choice(["a", "b", "gold", "slow", "c", "d", "e"])
        if op < 0.6:
            out.append(("acquire", tenant, quotas.try_acquire(tenant, rng.choice([1.0, 2.0]))))
        elif op < 0.75:
            quotas.refund(tenant)
            out.append(("refund", tenant, quotas.level(tenant)))
        else:
            now[0] += rng.uniform(0.0, 1.5)
        out.append(sorted(quotas._buckets))
    out.append(qos.TenantQuotas(rate=None).try_acquire("x"))
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_tenant_quotas_match_jax(seed):
    jax_out, port_out = _both(_quota_trace, seed)
    assert port_out == jax_out


def _spike_trace(qos):
    sig = [qos.BrownoutSignals(queue_depth=1.0)] * 4
    sig += [qos.BrownoutSignals(queue_depth=40.0, ttft_p95_ms=900.0)] * 12
    sig += [qos.BrownoutSignals(queue_depth=0.0, kv_usage=0.5)] * 40
    return sig


def _ladder_trace(pkg, kind):
    qos = _mod(pkg, "llm.qos")
    if kind == "spike":
        ladder = qos.BrownoutLadder(qos.BrownoutConfig(queue_high=10.0, ttft_p95_ms=500.0))
        signals = _spike_trace(qos)
    elif kind == "band":  # pressure oscillating inside the hysteresis band
        ladder = qos.BrownoutLadder(qos.BrownoutConfig(queue_high=10.0))
        signals = [qos.BrownoutSignals(queue_depth=10.0 * (1.05 if i % 2 else 0.65))
                   for i in range(50)]
    else:  # seeded random walk over all three signals
        rng = random.Random(3)
        ladder = qos.BrownoutLadder(qos.BrownoutConfig.from_dict(
            {"queue_high": 8.0, "kv_high": 0.8, "ttft_p95_ms": 300.0, "cooldown": 2,
             "confirm_up": 1, "unknown_key": 1}))
        signals = [qos.BrownoutSignals(queue_depth=rng.uniform(0, 20), kv_usage=rng.random(),
                                       ttft_p95_ms=rng.choice([None, rng.uniform(0, 600)]))
                   for _ in range(300)]
    rungs = [(ladder.tick(s), ladder.pressure(s)) for s in signals]
    return rungs, list(ladder.transitions), ladder.state(), qos.RUNG_NAMES


@pytest.mark.parametrize("kind", ["spike", "band", "random"])
def test_brownout_ladder_matches_jax(kind):
    jax_out, port_out = _both(_ladder_trace, kind)
    assert port_out == jax_out
    rungs = [r for r, _ in port_out[0]]
    if kind == "spike":
        assert max(rungs) >= 2 and rungs[-1] == 0
    if kind == "band":
        assert port_out[1] == [] and rungs[-1] == 0


def _controller_trace(pkg):
    """tests/test_qos.py's admit/shape and quota scenarios in one trace."""
    qos = _mod(pkg, "llm.qos")
    out = []

    def admit(ctl, tenant, priority, drain=None):
        try:
            ctl.admit(tenant, priority, drain)
            return ("ok", ctl.quotas.level(tenant))
        except qos.QosShed as e:
            return (e.status, e.message, e.retry_after_s, e.reason, ctl.quotas.level(tenant))

    ctl = qos.QosController(qos.QosConfig(rate=1000.0, brownout=qos.BrownoutConfig(
        max_tokens_cap=32)), clock=lambda: 0.0)
    for rung in range(5):
        ctl.ladder.rung = rung
        out.append([admit(ctl, "t", p, d) for p in (qos.INTERACTIVE, qos.BATCH)
                    for d in (None, 2.0)])
        for body in ({"max_tokens": 999}, {}, {"max_tokens": 8, "max_completion_tokens": 99},
                     {"nvext": None}, {"nvext": {"spec_decode": True}}):
            out.append(ctl.shape(json.loads(json.dumps(body))))
    now = [0.0]
    ctl = qos.QosController(qos.QosConfig(rate=1.0, burst=1.0), clock=lambda: now[0])
    for dt in (0.0, 0.0, 0.3, 0.8, 0.0):
        now[0] += dt
        out.append(admit(ctl, "t", qos.INTERACTIVE))
    out.append(ctl.rung)
    for section in ({}, {"rate": 5, "burst": 9, "brownout": True, "tick_s": 0.2},
                    {"rate": 0, "brownout": {"queue_high": 4, "max_tokens_cap": 7}},
                    {"rate": "", "brownout": False, "tenants": {"g": {"rate": 2}}}):
        cfg = qos.QosConfig.from_dict(section)
        out.append((cfg.rate, cfg.burst, cfg.tenants, cfg.tick_s,
                    None if cfg.brownout is None else vars(cfg.brownout)))
    return out


def test_qos_controller_matches_jax():
    jax_out, port_out = _both(_controller_trace)
    assert port_out == jax_out


def _metrics_trace(pkg):
    metrics = _mod(pkg, "llm.metrics")
    qm = metrics.qos_metrics
    rng = random.Random(5)
    for _ in range(50):
        setattr(qm, rng.choice(["quota_shed_total", "batch_shed_total", "interactive_shed_total",
                                "capped_requests_total", "spec_standdowns_total",
                                "brownout_transitions_total"]), rng.randint(0, 9))
        qm.shed_tenant(rng.choice(["a", 'we"ird\nten}ant', "key:abc", "b"]))
    qm.brownout_rung = 3
    now = [0.0]
    w = metrics.TimedWindow(max_age_s=5.0, clock=lambda: now[0])
    series = []
    for i in range(30):
        now[0] += rng.uniform(0, 1.0)
        w.observe(rng.random())
        series.append((w.percentile(0.95), len(w)))
    now[0] += 6.0
    series.append((w.percentile(0.95), len(w)))
    return qm.render("dynamo_tpu"), qm.snapshot(), series


def test_qos_metrics_and_timed_window_match_jax():
    jax_out, port_out = _both(_metrics_trace)
    assert port_out == jax_out
    assert 'shed_by_tenant_total{tenant="we\\"ird\\nten}ant"}' in port_out[0]
    assert port_out[2][-1] == (None, 0)


def test_recent_ttft_window_feeds_the_ladder():
    """The edge's age-bounded TTFT window, as the brownout tick reads it."""
    outs = []
    for pkg in PKGS:
        metrics = _mod(pkg, "llm.metrics")
        m = metrics.Metrics("t")
        empty = m.recent_ttft_p95_ms()
        guard = m.guard("m", "completions", "stream")
        guard.on_token()
        guard.on_token()
        guard.finish(metrics.Status.SUCCESS)
        outs.append((empty, len(m.ttft_recent), m.recent_ttft_p95_ms() is not None))
    assert outs[0] == outs[1] == (None, 1, True)


@pytest.mark.parametrize("layers", ["env", "file+env"])
def test_runtime_config_edge_sections_match_jax(tmp_path, layers):
    env = {"DYN_QOS__RATE": "20", "DYN_QOS__BROWNOUT__QUEUE_HIGH": "32",
           "DYN_TRACING__SAMPLE": "0.25", "DYN_RESILIENCE__HTTP_MAX_INFLIGHT": "64",
           "DYN_QOS__TENANT_WEIGHTS": '{"gold": 3}'}
    path = None
    if layers == "file+env":
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"qos": {"burst": 5, "rate": 1}, "tracing": {"ring": 16},
                                    "resilience": {"http_admission_queue": 4}}))
    got = []
    for pkg in PKGS:
        cfg = _mod(pkg, "runtime.config").RuntimeConfig.from_layers(
            file_path=str(path) if path else None, environ=env)
        got.append((cfg.qos, cfg.tracing, cfg.spec_decode))
    assert got[1] == got[0]
    assert got[1][0]["rate"] == 20


# ------------------------------------------------ the two servers, alike


def _chunk(content):
    return {
        "id": "chatcmpl-test", "object": "chat.completion.chunk", "created": 0, "model": "echo",
        "choices": [{"index": 0, "delta": {"role": "assistant", "content": content},
                     "finish_reason": None}],
    }


def _final():
    c = _chunk("")
    c["choices"][0]["finish_reason"] = "stop"
    c["usage"] = {"prompt_tokens": 1, "completion_tokens": 2, "total_tokens": 3}
    return c


def _engines(pkg):
    """Stand-in engines on ``pkg``'s runtime: slow (0.3 s, then two
    chunks), stalled after one chunk, and one that checks its deadline at
    dispatch as a routed client does."""
    rt = _mod(pkg, "runtime.engine")

    class Slow(rt.AsyncEngine):
        async def generate(self, request):
            async def gen():
                await asyncio.sleep(0.3)
                yield _chunk("hi")
                yield _final()

            return rt.ResponseStream(gen(), request.ctx)

    class Stalls(rt.AsyncEngine):
        async def generate(self, request):
            async def gen():
                yield _chunk("first")
                await asyncio.sleep(5.0)
                yield _final()

            return rt.ResponseStream(gen(), request.ctx)

    class DispatchDeadline(rt.AsyncEngine):
        async def generate(self, request):
            await request.ctx.deadline.bound(asyncio.sleep(5.0), "dispatch")

    return {"slow": Slow(), "stalls": Stalls(), "dispatch": DispatchDeadline()}


async def _serve(pkg, scenario, **kw):
    """Start ``pkg``'s HttpService with ``kw``, run ``scenario(base,
    service)`` against it and return what it returned."""
    http = _mod(pkg, "llm.http_service")
    if "qos" in kw:
        kw["qos"] = kw["qos"](_mod(pkg, "llm.qos"))
    service = http.HttpService(host="127.0.0.1", port=0, **kw)
    for name, engine in _engines(pkg).items():
        service.models.add_chat_model(name, engine)
    await service.start()
    try:
        return await scenario(f"http://127.0.0.1:{service.port}", service, pkg)
    finally:
        await service.close()


def _shape(status, headers, text):
    """Status, Retry-After, and the body: SSE events in order (ids and
    timestamps masked) or the JSON body."""
    retry = headers.get("Retry-After")
    if headers.get("Content-Type", "").startswith("text/event-stream"):
        events = []
        for block in text.split("\n\n"):
            if block:
                lines = block.split("\n")
                data = lines[-1][len("data: "):]
                events.append((lines[:-1], data if data == "[DONE]" else json.loads(data)))
        return status, retry, events
    body = json.loads(text) if text else None
    if isinstance(body, dict):
        body.pop("id", None)
        body.pop("created", None)
    return status, retry, body


async def _post(http, base, model, headers=None, **body):
    async with http.post(f"{base}/v1/chat/completions", headers=headers or {},
                         json={"model": model, "messages": [{"role": "user", "content": "x"}],
                               **body}) as r:
        return _shape(r.status, r.headers, await r.text())


async def _get(http, base, path):
    async with http.get(base + path) as r:
        return r.status, r.headers.get("Retry-After"), await r.text()


async def _scenario_overflow(base, service, pkg):
    async with ClientSession() as http:
        replies = await asyncio.gather(*(_post(http, base, "slow") for _ in range(6)))
        async with http.get(f"{base}/metrics") as r:
            metrics = await r.text()
    shed = [line for line in metrics.splitlines() if "admission_shed_total{" in line]
    return sorted(replies, key=lambda x: (x[0], json.dumps(x[2]))), shed


async def _scenario_queue_timeout(base, service, pkg):
    async with ClientSession() as http:
        replies = await asyncio.gather(*(_post(http, base, "slow") for _ in range(3)))
    return sorted(replies, key=lambda x: (x[0], json.dumps(x[2])))


async def _scenario_deadlines(base, service, pkg):
    async with ClientSession() as http:
        return [
            await _post(http, base, "dispatch", headers={"x-deadline-s": "0.05"}),
            await _post(http, base, "stalls", deadline_s=0.05),
            await _post(http, base, "stalls", headers={"x-deadline-s": "0.05"}, stream=True),
            await _post(http, base, "slow", headers={"x-deadline-s": "bogus"}),
        ]


async def _scenario_default_deadline(base, service, pkg):
    async with ClientSession() as http:
        return [await _post(http, base, "stalls"),
                await _post(http, base, "stalls", headers={"x-deadline-s": "0.02"}, stream=True)]


async def _scenario_qos(base, service, pkg):
    ladder = service.qos.ladder
    out = []
    async with ClientSession() as http:
        for _ in range(3):  # quota: burst 2 under one tenant
            out.append(await _post(http, base, "slow", headers={"x-tenant": "hog"}))
        ladder.rung = 3  # batch sheds with the drain-scaled Retry-After
        out.append(await _post(http, base, "slow", headers={"x-priority": "batch",
                                                           "x-tenant": "b"}))
        out.append(await _post(http, base, "slow", headers={"x-tenant": "c"},
                               nvext={"priority": "batch"}))
        out.append(await _post(http, base, "slow", headers={"x-tenant": "d"}))
        ladder.rung = 4  # interactive sheds only while admission is saturated
        out.append(await _post(http, base, "slow", headers={"x-tenant": "e"}))
        await service.admission.acquire()
        try:
            out.append(await _post(http, base, "slow", headers={"x-tenant": "f"}))
            # A queued request shed by admission at rung 4 gets the drain
            # estimate times (1 + rung).
            ladder.rung = 1
            out.append(await _post(http, base, "slow", headers={"x-tenant": "g"}))
        finally:
            service.admission.release()
        status, retry, text = await _get(http, base, "/health")
        out.append((status, json.loads(text)))
        async with http.get(f"{base}/metrics") as r:
            text = await r.text()
    out.append([line for line in text.splitlines()
                if line.startswith("dynamo_tpu_qos_") or "admission_shed_total{" in line])
    return out


async def _scenario_traces_404(base, service, pkg):
    async with ClientSession() as http:
        return [await _get(http, base, "/traces"), await _get(http, base, "/traces?recent=3"),
                await _get(http, base, "/traces/abc")]


SERVER_CASES = {
    "overflow-429": (_scenario_overflow, dict(max_inflight=2, admission_queue=0)),
    "queue-timeout-503": (_scenario_queue_timeout,
                          dict(max_inflight=1, admission_queue=1, admission_timeout_s=0.05)),
    "deadline-504": (_scenario_deadlines, {}),
    "default-deadline-504": (_scenario_default_deadline, dict(default_deadline_s=0.05)),
    "qos-sheds": (_scenario_qos, dict(
        max_inflight=1, admission_queue=0,
        qos=lambda q: q.QosController(q.QosConfig(
            rate=1000.0, tenants={"hog": {"rate": 0.001, "burst": 2.0}},
            brownout=q.BrownoutConfig(), tick_s=30.0)))),
    "traces-404-without-aggregator": (_scenario_traces_404, {}),
}


@pytest.mark.parametrize("case", list(SERVER_CASES))
async def test_edge_status_paths_match_jax(case):
    scenario, kw = SERVER_CASES[case]
    want = await _serve(PKGS[0], scenario, **dict(kw))
    got = await _serve(PKGS[1], scenario, **dict(kw))
    assert got == want
    flat = json.dumps(got)
    expected = {
        "overflow-429": ["429", "admission queue full"],
        "queue-timeout-503": ["503", "wait timed out"],
        "deadline-504": ["deadline exceeded (dispatch)", "deadline exceeded (response)",
                         "event: error", "504"],
        "default-deadline-504": ["deadline exceeded (response)", "event: error"],
        "qos-sheds": ["over its request quota", "batch class shed", "interactive overflow",
                      "brownout"],
        "traces-404-without-aggregator": ["tracing aggregator not configured"],
    }[case]
    for needle in expected:
        assert needle in flat, (needle, got)


def test_cli_edge_sections_match_jax(monkeypatch):
    """``run in=http``'s edge wiring from the layered config: the QoS
    controller (its scheduler keys left to the engine), the tracing
    surfaces, and the engine's WFQ weights."""
    import argparse
    import dataclasses

    from dynamo_tpu import cli as jax_cli
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.engine import build_torch_engine

    monkeypatch.setenv("DYN_QOS__RATE", "5")
    monkeypatch.setenv("DYN_QOS__BROWNOUT__QUEUE_HIGH", "4")
    monkeypatch.setenv("DYN_QOS__TENANT_WEIGHTS", '{"gold": 3}')
    monkeypatch.setenv("DYN_TRACING__SAMPLE", "0.5")
    got, want = cli._edge_qos(), jax_cli._edge_qos(argparse.Namespace())
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert got.config.rate == 5.0
    assert got.ladder.config.queue_high == 4
    (sampler, agg, cfg), (_, jax_agg, jax_cfg) = cli._edge_tracing(), jax_cli._edge_tracing()
    assert vars(cfg) == vars(jax_cfg) and sampler.config.sample == 0.5
    asyncio.run(agg.stop())
    asyncio.run(jax_agg.stop())
    engine = build_torch_engine(argparse.Namespace(arch="debug-tiny", dtype="float32",
                                                   num_blocks=16, max_model_len=32,
                                                   device="cpu"))
    engine.programs.close()
    assert engine.cfg.qos.tenant_weights == {"gold": 3}
    monkeypatch.setenv("DYN_TRACING__ENABLED", "false")
    monkeypatch.delenv("DYN_QOS__RATE")
    monkeypatch.setenv("DYN_QOS__BROWNOUT", "false")
    assert cli._edge_tracing()[:2] == (None, None)
    assert cli._edge_qos() is None
