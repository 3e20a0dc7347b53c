"""The port's request tracing against the JAX package's, on the CPU.

- ``runtime/tracing.py`` and ``llm/trace_service.py`` are copies: the
  unit scenarios of ``tests/test_tracing.py`` that need no hub run on both
  packages with the same injected clock and RNG, and give equal wire
  forms, sampling decisions, ring contents, aggregator views, TTFT
  decompositions and rendered metrics;
- the engine's overhead contract, as
  ``test_engine_byte_identical_and_zero_new_compiles_with_tracing`` holds
  it for ``TpuEngine``: the same request traced and untraced gives the
  same stream and captures no new device program; decode records once
  per fused dispatch, never per token; and the traced request leaves the
  spans ``TpuEngine`` leaves on the same weights, by name and count;
- the HTTP edge end to end (``HttpService`` → preprocessor → backend →
  ``TorchEngine``): ``x-trace`` gives the same bytes plus an
  ``x-trace-id``, and ``/traces/{id}`` assembles the edge and engine spans
  with a TTFT rollup.
"""

import asyncio
import importlib
import json

import jax
import numpy as np
import pytest
from aiohttp import ClientSession

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.engine import collect as jax_collect
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context, collect
from test_torch_engine import _jax_params

pytestmark = pytest.mark.torch_port

PKGS = ("dynamo_tpu", "dynamo_tpu_torch")


def _tr(pkg):
    return importlib.import_module(f"{pkg}.runtime.tracing")


def _ts(pkg):
    return importlib.import_module(f"{pkg}.llm.trace_service")


@pytest.fixture(autouse=True)
def _reset_tracing_state():
    """Both packages' process-global collectors and metrics."""
    for pkg in PKGS:
        _tr(pkg).collector.drain()
        _tr(pkg).tracing_metrics.reset()
    yield
    for pkg in PKGS:
        _tr(pkg).collector.drain()
        _tr(pkg).tracing_metrics.reset()


def _both(fn):
    return [fn(pkg) for pkg in PKGS]


def _mask(spans):
    """Span dicts without the fields minted per run (ids, wall clocks)."""
    out = []
    for s in spans:
        s = dict(s)
        for k in ("trace_id", "span_id", "parent_id", "start_ms", "dur_ms", "proc"):
            s.pop(k, None)
        s["events"] = [e["name"] for e in s.get("events", [])]
        if "ttft_ms" in s.get("attrs", {}):
            s["attrs"] = dict(s["attrs"], ttft_ms="measured")
        out.append(s)
    return out


# ------------------------------------------------------------- wire + ring


def _wire(pkg):
    tr = _tr(pkg)
    tc = tr.TraceContext("t1", "s1")
    off = tr.TraceContext("t2", "s2", sampled=False)
    garbage = [None, "not a dict", {"span_id": "x"}, {"trace_id": "t", "span_id": "s",
                                                      "sampled": False},
               {"trace_id": "t", "span_id": "s"}, {"trace_id": 5, "span_id": 6}]
    parsed = [tr.parse_trace(g) for g in garbage]
    return (tc.to_dict(), off.to_dict(), tr.TraceContext.from_dict(off.to_dict()).sampled,
            [None if p is None else p.to_dict() for p in parsed],
            len(tr.new_id()), tr.TraceContext.new().sampled)


def test_trace_context_wire_matches_jax():
    jax_out, port_out = _both(_wire)
    assert port_out == jax_out
    assert port_out[0] == {"trace_id": "t1", "span_id": "s1"}


def _ring(pkg):
    tr = _tr(pkg)
    c = tr.SpanCollector(maxlen=4)
    tc = tr.TraceContext("t", "s")
    spans = [c.record(tc, f"s{i}", "t", 0.0, 1.0, attrs={"i": i} if i % 2 else None)
             for i in range(6)]
    out = [len(c), tr.tracing_metrics.spans_dropped_total, tr.tracing_metrics.spans_recorded_total,
           _mask(c.drain()), len(c), _mask(spans)]
    out.append(c.record(None, "x", "t", 0.0, 1.0))
    out.append(c.record(tr.TraceContext("a", "b", sampled=False), "x", "t", 0, 1))
    # Parenting and the span helper.
    sink = tr.SpanCollector(maxlen=8)
    with tr.span(tc, "child", "comp", sink=sink) as h:
        h.set(k="v")
        h.event("marker", n=3)
    sink.record(tc, "root", "comp", 0.0, 1.0, parent_id=None)
    try:
        with tr.span(tc, "op", "c", sink=sink):
            raise ValueError("boom")
    except ValueError:
        pass
    child, root, err = sink.drain()
    out.append((child["parent_id"] == tc.span_id, root["parent_id"], root["span_id"],
                _mask([child, root, err])))
    out.append(tr.span(None, "n", "c") is tr.NOOP_SPAN)
    out.append(tr.span(tr.TraceContext("t", "s", sampled=False), "n", "c") is tr.NOOP_SPAN)
    c.set_capacity(2)
    out.append(c._ring.maxlen)
    return out


def test_collector_and_span_helper_match_jax():
    jax_out, port_out = _both(_ring)
    assert port_out == jax_out
    assert port_out[0] == 4 and port_out[1] == 2


def _sampling(pkg):
    tr = _tr(pkg)
    ts = _ts(pkg)
    draws = iter([0.1, 0.9, 0.49, 0.5, 0.51, 0.0] * 4)
    out = []
    s = tr.TraceSampler(tr.TracingConfig(sample=0.5), rng=lambda: next(draws))
    out.append([s.decide({}, {}) is not None for _ in range(6)])
    s = tr.TraceSampler(tr.TracingConfig(sample=0.0))
    for headers, body in [({"x-trace": "1"}, {}), ({}, {"nvext": {"trace": True}}),
                          ({"x-trace": "0"}, {"nvext": {"trace": True}}), ({"x-trace": "off"}, {}),
                          ({"x-trace": ""}, {}), ({"x-trace": "FALSE"}, {}),
                          ({}, {"nvext": {"trace": "no"}}), ({}, {"nvext": None}), (None, None)]:
        out.append(s.decide(headers, body) is not None)
    out.append(tr.TraceSampler(tr.TracingConfig(enabled=False)).decide({"x-trace": "1"}, {}))
    for cfg in (dict(tail_keep=True, tail_slo_ttft_ms=100.0), dict(tail_keep=False),
                dict(tail_keep=True)):
        s = tr.TraceSampler(tr.TracingConfig(**cfg))
        out.append([s.tail_eligible(e, t) for e in (True, False) for t in (None, 50.0, 150.0)])
    for section in (None, {}, {"enabled": False, "sample": 7, "ring": 16, "ttl_s": 3,
                               "tail_slo_ttft_ms": "250"}, {"sample": -1, "tail_keep": 0}):
        out.append(vars(tr.TracingConfig.from_config(section)))
    # Tail keep at the edge: only errors and SLO misses leave spans.
    sampler = tr.TraceSampler(tr.TracingConfig(sample=0.0, tail_keep=True,
                                               tail_slo_ttft_ms=1e9))
    for status in ("error", "success", "rejected"):
        ert = ts.EdgeRequestTrace(sampler, {}, {})
        ert.admission_started()
        ert.admission_done()
        ert.on_first_token()
        ert.finish(status, model="m", endpoint="completions")
        ert.finish(status)  # idempotent
        out.append((status, ert.active, _mask(tr.collector.drain())))
    ert = ts.EdgeRequestTrace(sampler, {"x-trace": "1"}, {})
    ert.admission_started()  # shed while queued: the wait ends at finish
    ert.finish("rejected")
    out.append(("forced", ert.active, _mask(tr.collector.drain())))
    out.append(tr.tracing_metrics.snapshot())
    return out


def test_sampling_and_edge_trace_match_jax():
    jax_out, port_out = _both(_sampling)
    assert port_out == jax_out
    assert port_out[0] == [True, False, True, False, False, True]


def _span(tid, name="n", component="c", start=0.0, dur=1.0, parent="p", events=None):
    s = {"trace_id": tid, "span_id": f"{tid}-{name}", "parent_id": parent, "name": name,
         "component": component, "proc": "pid-x", "start_ms": start, "dur_ms": dur}
    if events:
        s["events"] = events
    return s


def _aggregation(pkg):
    ts = _ts(pkg)
    tr = _tr(pkg)
    now = [0.0]
    agg = ts.TraceAggregator(ttl_s=10.0, max_traces=3, clock=lambda: now[0])
    out = []
    steps = [("a", None, 0.0), ("b", "p", 5.0), ("a", "p", 6.0), ("c", None, 11.0),
             ("d", "p", 12.0), ("e", None, 13.0), ("f", None, 30.0)]
    for tid, parent, t in steps:
        now[0] = t
        agg.ingest({"proc": "p", "spans": [_span(tid, parent=parent)]})
        out.append((sorted(agg._traces), agg.stats(), agg.recent(5), agg.recent(0)))
    agg.ingest(None)
    agg.ingest({"spans": [{"name": "no id"}]})
    out.append(agg.get("f"))
    out.append(agg.get("nope"))
    out.append(tr.tracing_metrics.render("dynamo_tpu"))
    asyncio.run(agg.stop())
    out.append("aggregator_traces" in tr.tracing_metrics.render("dynamo_tpu"))
    return out


def test_aggregator_matches_jax():
    jax_out, port_out = _both(_aggregation)
    assert port_out == jax_out
    assert port_out[-1] is False


def _decomposition(pkg):
    ts = _ts(pkg)
    tid = "t"
    spans = [
        _span(tid, "edge.request", "edge", 1000.0, 500.0, parent=None),
        _span(tid, "edge.admission_wait", "edge", 1000.0, 50.0),
        _span(tid, "edge.preprocess", "edge", 1050.0, 50.0),
        _span(tid, "client.route", "client", 1100.0, 100.0),
        _span(tid, "engine.queue_wait", "engine", 1250.0, 50.0),
        _span(tid, "engine.prefill", "engine", 1300.0, 100.0,
              events=[{"name": "first_token", "t_ms": 1400.0}]),
        _span(tid, "engine.decode_chunk", "engine", 1350.0, 40.0),
        _span(tid, "engine.decode_chunk", "engine", 1440.0, 40.0),
        _span(tid, "engine.queue_wait", "engine", 1500.0, 30.0),
        _span(tid, "engine.prefill", "engine", 1530.0, 60.0,
              events=[{"name": "first_token", "t_ms": 1590.0}]),
    ]
    return [ts.ttft_decomposition(spans), ts.ttft_decomposition(spans[1:]),
            ts.ttft_decomposition([]), ts.TTFT_HOPS]


def test_ttft_decomposition_matches_jax():
    jax_out, port_out = _both(_decomposition)
    assert port_out == jax_out
    assert port_out[0]["ttft_ms"] == 400.0 and port_out[0]["unattributed_ms"] == 50.0


async def _export(pkg):
    tr = _tr(pkg)
    got = []

    class _Boom:
        def ingest(self, payload):
            raise RuntimeError("sink down")

    async def async_sink(payload):
        got.append(("async", len(payload["spans"])))

    exp = tr.SpanExporter([_Boom(), got.append, async_sink], interval_s=60.0, proc="edge-1")
    tc = tr.TraceContext.new()
    tr.collector.record(tc, "s1", "c", 0.0, 1.0)
    out = [await exp.flush(), [_mask(g["spans"]) if isinstance(g, dict) else g for g in got],
           tr.collector.proc]
    out.append(await exp.flush())
    await exp.start()
    tr.collector.record(tc, "s2", "c", 0.0, 1.0)
    await exp.stop(final_flush=True)
    out.append(len(got))
    out.append(tr.tracing_metrics.snapshot())
    return out


async def test_exporter_matches_jax():
    outs = []
    for pkg in PKGS:
        proc = _tr(pkg).collector.proc
        try:
            outs.append(await _export(pkg))
        finally:
            _tr(pkg).collector.proc = proc
    assert outs[1] == outs[0]
    assert outs[1][0] == 1 and outs[1][-1]["export_errors_total"] == 2


# ------------------------------------------ the engine's overhead contract

CFG = dict(model="debug-tiny", block_size=4, num_blocks=128, max_batch=4, max_model_len=512,
           prefill_chunk=64, dtype="float32", decode_steps=2, pipeline_depth=2)
PROMPTS = [list(range(1, 18)), [7] * 40 + [3, 1, 4], list(range(200, 130, -1))]


def _req(tokens, max_tokens=24, trace=None):
    d = PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
    ).to_dict()
    if trace is not None:
        d["annotations"] = {"trace": trace.to_dict()}
    return d


def _tokens(items):
    return [t for i in items for t in i.get("token_ids", [])]


async def _traced_run(pkg, engine, context, collect_fn):
    """Each prompt untraced twice (the second takes the prefix-hit shape
    the traced pass takes), then traced, then untraced, one at a time on
    one engine: the streams, the compile counts around the traced pass,
    and each traced request's spans (names, counts, decode steps)."""
    tr = _tr(pkg)
    out = []
    for prompt in PROMPTS:
        want = _tokens(await collect_fn(await engine.generate(context(_req(prompt)))))
        warm = _tokens(await collect_fn(await engine.generate(context(_req(prompt)))))
        counts = dict(engine.compile_counts())
        tr.collector.drain()
        tc = tr.TraceContext.new()
        ctx = context(_req(prompt, trace=tc))
        ctx.ctx.trace = tc
        got = _tokens(await collect_fn(await engine.generate(ctx)))
        spans = tr.collector.drain()
        again = _tokens(await collect_fn(await engine.generate(context(_req(prompt)))))
        names = sorted(s["name"] for s in spans)
        prefill = [s for s in spans if s["name"] == "engine.prefill"]
        out.append({
            "stream": want, "traced_equal": got == want == warm == again,
            "compiles_equal": dict(engine.compile_counts()) == counts,
            "one_trace": {s["trace_id"] for s in spans} == {tc.trace_id},
            "untraced_after": len(tr.collector) == 0,
            "names": names,
            "first_token_event": [[e["name"] for e in s.get("events", [])] for s in prefill],
            "decode_steps": sorted(s["attrs"]["steps"] for s in spans
                                   if s["name"] == "engine.decode_chunk"),
            "queue_wait_attrs": [sorted(s["attrs"]) for s in spans
                                 if s["name"] == "engine.queue_wait"],
            "prefill_attrs": [sorted(s["attrs"]) for s in prefill],
        })
    return out


async def test_engine_traced_streams_and_spans_match_tpu_engine():
    params = _jax_params()
    jeng = TpuEngine(JaxEngineConfig(**CFG), params=params)
    try:
        want = await _traced_run("dynamo_tpu", jeng, JaxContext, jax_collect)
    finally:
        await jeng.close()
    tree = jax.tree_util.tree_map(np.asarray, params)
    engine = TorchEngine(EngineConfig(**CFG), params=params_from_jax(tree, device="cpu"),
                         device="cpu")
    try:
        got = await _traced_run("dynamo_tpu_torch", engine, Context, collect)
    finally:
        await engine.close()
    assert got == want
    for r in got:
        assert r["traced_equal"] and r["compiles_equal"] and r["one_trace"]
        assert r["untraced_after"]
        assert r["names"].count("engine.queue_wait") == 1
        assert r["first_token_event"] == [["first_token"]]
        # Chunk granularity: at least one span, fewer than the tokens.
        assert 1 <= len(r["decode_steps"]) < len(r["stream"])
        assert set(r["decode_steps"]) == {CFG["decode_steps"]}


# --------------------------------------------------- the HTTP edge, traced


async def test_http_edge_traces_endpoints_and_headers():
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.llm.trace_service import TraceAggregator
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline
    from dynamo_tpu_torch.runtime.tracing import (SpanExporter, TraceSampler, TracingConfig,
                                                  tracing_metrics)

    engine = TorchEngine(EngineConfig(**CFG), device="cpu")
    agg = TraceAggregator()
    exporter = SpanExporter([agg], interval_s=60.0)
    service = HttpService(host="127.0.0.1", port=0, tracing=TraceSampler(TracingConfig()),
                          trace_aggregator=agg)
    tok = ByteTokenizer()
    service.models.add_completion_model(
        "m", build_pipeline([OpenAIPreprocessor(tok, "m"), Backend(tok)], engine))
    await service.start()
    base = f"http://127.0.0.1:{service.port}"
    body = {"model": "m", "prompt": PROMPTS[0], "max_tokens": 12, "stream": True,
            "nvext": {"ignore_eos": True}}
    try:
        async with ClientSession() as http:
            async with http.post(f"{base}/v1/completions", json=body) as r:
                assert r.status == 200 and "x-trace-id" not in r.headers
                plain = await r.text()
            async with http.post(f"{base}/v1/completions", json=body,
                                 headers={"x-trace": "1"}) as r:
                assert r.status == 200
                tid = r.headers["x-trace-id"]
                traced = await r.text()

            def texts(text):
                return [[(c.get("text"), c.get("finish_reason"))
                         for c in json.loads(line[6:]).get("choices", [])]
                        for line in text.splitlines()
                        if line.startswith("data: ") and line != "data: [DONE]"]

            assert texts(traced) == texts(plain)
            await exporter.flush()
            async with http.get(f"{base}/traces/{tid}") as r:
                assert r.status == 200
                trace = await r.json()
            names = [s["name"] for s in trace["spans"]]
            for name in ("edge.request", "edge.admission_wait", "edge.preprocess",
                         "engine.queue_wait", "engine.prefill", "engine.decode_chunk"):
                assert name in names, names
            assert trace["components"] == ["edge", "engine"]
            rollup = trace["rollup"]
            assert rollup["ttft_ms"] > 0 and set(rollup["hops"]) >= {
                "edge_queue", "preprocess", "engine_queue", "prefill_or_pull"}
            assert rollup["unattributed_ms"] <= rollup["ttft_ms"]
            async with http.get(f"{base}/traces?recent=5") as r:
                recent = (await r.json())["traces"]
            assert recent[0]["trace_id"] == tid and recent[0]["root"] == "edge.request"
            async with http.get(f"{base}/traces/nope") as r:
                assert r.status == 404
            async with http.get(f"{base}/metrics") as r:
                metrics = await r.text()
            assert "dynamo_tpu_tracing_traces_forced_total 1" in metrics
            assert "dynamo_tpu_tracing_aggregator_traces 1" in metrics
    finally:
        await exporter.stop(final_flush=False)
        await agg.stop()
        await service.close()
        await engine.close()
    assert tracing_metrics._aggregator_source is None
