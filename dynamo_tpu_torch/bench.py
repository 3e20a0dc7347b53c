"""Headline benchmark of the port: end-to-end engine decode throughput
(``python -m dynamo_tpu_torch.bench``).

The counterpart of the JAX package's ``bench.py``: the full native serving
path of ``TorchEngine`` — scheduler, paged KV manager, CUDA-graph step and
fused-decode programs with the hand-written attention kernels, sampling,
token streaming — on llama-3.1-8b (DeepSeek-R1-Distill-Llama-8B shapes) at
full width and depth under W8A8 weights and int8 KV pages (``kv_scale``
"auto"), ``max_batch`` 256, ISL 128, OSL 64, 8 fused decode steps, 8
dispatches in flight.  It prints ONE JSON line on stdout with the JAX
contract's keys (metric/value/unit/vs_baseline, decode and prefill MFU,
the kernels that served, the attention byte model, ``host_gap_frac``, the
dispatch percentiles and the pipeline counters); everything else goes to
stderr.

MFU is against the H100's published dense peaks: 989 TFLOP/s bf16, and
1979 TOP/s int8 under W8A8; stderr prints the card's name and power
limit (``nvidia-smi``) beside the figures.  ``vs_baseline`` is 1.0: the
port has no recorded prior.

The device rule holds: without ``--device`` the bench needs CUDA and
raises without it; ``--device cpu`` runs the JAX bench's own CPU geometry
(debug-tiny in f32, 8 requests of 32 + 16 tokens).

Modes (environment, as the JAX bench reads them):
  BENCH_SPEC=1     speculation off vs on (``spec_bench``)
  BENCH_CHURN=1    continuous batching vs forced rebuilds (``churn_bench``)
  BENCH_PREFIX=1   the tiered-KV prefix ladder (``prefix_bench``)
  BENCH_WARM_CHECK refused: the persistent XLA compilation cache
                   (``engine/xla_cache.py``) has no counterpart in the port
Knobs: BENCH_MODEL, BENCH_LAYERS, BENCH_REQUESTS, BENCH_ISL, BENCH_OSL,
BENCH_MAX_BATCH, BENCH_CTX, BENCH_QUANT, BENCH_KV, BENCH_DECODE_STEPS,
BENCH_PIPELINE_DEPTH, and each mode's own (see its function).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .device import default_device
from .engine.config import EngineConfig
from .engine.engine import TorchEngine
from .llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
from .models.config import get_config, register_config
from .runtime.engine import Context, collect

# The H100's published dense tensor-core peaks (SXM).
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
# What ``decode_kernel`` / ``prefill_kernel`` name, by the engine's route.
KERNEL_NAMES = {
    "cuda": ("csrc/decode_attention.cu", "csrc/prefill_attention.cu"),
    "plain": ("plain", "plain"),
}
# The one-line contract's keys (the JAX bench's).
HEADLINE_KEYS = frozenset({
    "metric", "value", "unit", "vs_baseline",
    "decode_mfu", "decode_kernel", "attention", "host_gap_frac",
    "dispatch", "pipeline",
    "prefill_mfu", "prefill_kernel", "prefill",
})


def err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "nvidia-smi gave nothing"


def engine_config(device: torch.device):
    """The bench geometry and workload: the JAX bench's CPU geometry on the
    CPU, else its accelerator geometry (env knobs as it reads them)."""
    if device.type == "cpu":
        return (EngineConfig(model="debug-tiny", block_size=4, num_blocks=256, max_batch=8,
                             max_model_len=256, prefill_chunk=128, dtype="float32"),
                {"isl": 32, "osl": 16, "requests": 8})
    env = os.environ.get
    model = env("BENCH_MODEL", "llama-3.1-8b")
    layers = int(env("BENCH_LAYERS", "0"))
    isl, osl = int(env("BENCH_ISL", "128")), int(env("BENCH_OSL", "64"))
    max_batch = int(env("BENCH_MAX_BATCH", "256"))
    max_model_len = max(256, 1 << (isl + osl + 16 - 1).bit_length())
    max_model_len = int(env("BENCH_CTX", str(max_model_len)))
    quant = env("BENCH_QUANT", "int8")
    quant = None if quant in ("", "none", "0") else quant
    kv_dtype = env("BENCH_KV", "int8" if quant else "")
    kv_dtype = "" if kv_dtype in ("", "none", "0") else kv_dtype
    cfg = EngineConfig(
        model=model, block_size=16,
        num_blocks=max_batch * ((max_model_len + 15) // 16) + 64,
        max_batch=max_batch, max_model_len=max_model_len, prefill_chunk=512,
        decode_steps=int(env("BENCH_DECODE_STEPS", "8")),
        pipeline_depth=int(env("BENCH_PIPELINE_DEPTH", "8")),
        weight_quant=quant, cache_dtype=kv_dtype or None,
        kv_scale="auto" if kv_dtype in ("int8", "float8_e4m3fn") else 1.0,
    )
    return cfg, {"isl": isl, "osl": osl,
                 "requests": int(env("BENCH_REQUESTS", str(max_batch))), "layers": layers}


def request(prompt: List[int], osl: int, temperature: float = 0.0, seed=None,
            annotations=None) -> Dict[str, Any]:
    return PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=temperature, seed=seed),
        annotations=dict(annotations or {}),
    ).to_dict()


def bench_prompt(i: int, isl: int, vocab: int) -> List[int]:
    """Token j of request i: (i·7919 + j·104729) % vocab."""
    return [(i * 7919 + j * 104729) % vocab for j in range(isl)]


async def run_requests(engine, isl: int, osl: int, n: int, vocab: int):
    """``n`` greedy requests at once; (tokens, per-request (tokens, first
    and last token times since the start, finish reason))."""
    t0 = time.perf_counter()

    async def one(i: int):
        toks, stamps, finish = [], [], None
        async for item in await engine.generate(Context(request(bench_prompt(i, isl, vocab), osl))):
            got = item.get("token_ids") or ()
            if got:
                stamps.append(time.perf_counter() - t0)
            toks.extend(got)
            finish = item.get("finish_reason") or finish
        return toks, stamps, finish

    streams = await asyncio.gather(*(one(i) for i in range(n)))
    return sum(len(t) for t, _, _ in streams), streams


def n_params(c) -> int:
    """The dense parameter count MFU is taken over."""
    p_layer = c.hidden_size * (c.q_size + 2 * c.kv_size + c.q_size) + 3 * c.hidden_size * c.intermediate_size
    return c.num_layers * p_layer + 2 * c.vocab_size * c.hidden_size


def cut_depth(cfg: EngineConfig, layers: int) -> EngineConfig:
    """``cfg`` on its model cut to ``layers`` layers (BENCH_LAYERS)."""
    mc = get_config(cfg.model)
    if not layers or layers == mc.num_layers:
        return cfg
    name = f"{cfg.model}-bench{layers}"
    register_config(mc.with_overrides(name=name, num_layers=layers))
    return dataclasses.replace(cfg, model=name)


def headline(cfg: EngineConfig, wl: Dict[str, Any], device: torch.device,
             before_timed: Optional[Callable[[Any], None]] = None,
             after_timed: Optional[Callable[[Any], None]] = None, params=None):
    """The headline run: build, capture every program (``warmup``), a short
    warm pass at the timed run's concurrency, then the timed run with the
    dispatch trace scoped to it.  ``before_timed(engine)`` runs just before
    the timed requests, ``after_timed(engine)`` just after, before the
    engine closes; ``params`` is a weight tree to serve (default: the
    engine's seeded draw).  Returns (the one-line dict, details)."""
    engine = TorchEngine(cfg, params=params, device=device)
    mc = engine.model_config
    details: Dict[str, Any] = {"calibration_s": engine.calibration_s}

    async def run():
        try:
            t0 = time.perf_counter()
            details["graphs"] = await engine.run_warmup()
            details["warm_s"] = time.perf_counter() - t0
            err(f"bench: warmup captured {details['graphs']} (buckets "
                f"{engine.reachable_token_buckets()}) in {details['warm_s']:.1f}s")
            if device.type == "cuda":
                err(f"bench: device memory {torch.cuda.memory_allocated(device) / 2**30:.2f} "
                    f"GiB allocated of the card's "
                    f"{torch.cuda.get_device_properties(device).total_memory / 2**30:.2f} GiB")
            await run_requests(engine, wl["isl"], 4, wl["requests"], mc.vocab_size)
            baseline = engine.compile_counts()
            engine.reset_dispatch_stats()
            spans = engine.prefill_spans
            pf0 = spans.seconds
            if before_timed is not None:
                before_timed(engine)
            t = time.perf_counter()
            total, streams = await run_requests(engine, wl["isl"], wl["osl"], wl["requests"],
                                                mc.vocab_size)
            dt = time.perf_counter() - t
            after = engine.compile_counts()
            summary, dispatch = engine.step_summary(), engine.dispatch_summary()
            dispatch["prefill"]["device_s"] = round(spans.seconds - pf0, 6)
            if after_timed is not None:
                after_timed(engine)
            if after != baseline:
                raise RuntimeError(f"graph captured inside the timed window: {baseline} -> "
                                   f"{after} (warmup must cover every reachable shape)")
            details.update(streams=streams, wall=dt, graphs_after=after, summary=summary,
                           dispatch=dispatch)
            return total, dt
        finally:
            await engine.close()

    total, dt = asyncio.run(run())
    summary, dispatch = details["summary"], details["dispatch"]
    err(f"bench: compile counts stable at {details['graphs_after']}")
    err(f"bench: {total} output tokens in {dt:.2f}s ({wl['requests']} reqs, isl={wl['isl']} "
        f"osl={wl['osl']})")
    device_s = sum(v["wall_s"] for v in summary.values())
    err(f"bench: dispatch summary {json.dumps(summary)}")
    err(f"bench: host gap {dt - device_s:.2f}s of {dt:.2f}s wall "
        f"({100 * (dt - device_s) / dt:.0f}%)")
    c = mc
    params = n_params(c)
    peak = PEAK_INT8 if cfg.weight_quant else PEAK_BF16
    peak_name = "int8 1979 TOP/s" if cfg.weight_quant else "bf16 989 TFLOP/s"
    where = card() if device.type == "cuda" else "the CPU: no H100 peak applies"
    mfu = 2 * params * total / (dt * peak)
    err(f"bench: ~{params / 1e9:.2f}B params, decode MFU {mfu * 100:.2f}% of the H100's dense "
        f"{peak_name} peak [{where}]")
    rows = min(wl["requests"], cfg.max_batch)
    mean_ctx = wl["isl"] + wl["osl"] / 2.0
    kv_itemsize = engine.cache.pages.element_size()
    w_itemsize = 1 if cfg.weight_quant else 2
    kv_bytes = rows * mean_ctx * 2 * c.kv_size * c.num_layers * kv_itemsize
    w_bytes = params * w_itemsize
    attn_share = kv_bytes / (kv_bytes + w_bytes)
    names = KERNEL_NAMES[dispatch["decode_kernel"]]
    err(f"bench: attention share (byte model) {attn_share * 100:.1f}% (kv {kv_bytes / 1e6:.0f}MB "
        f"vs weights {w_bytes / 1e6:.0f}MB per step, kernel={names[0]})")
    pf_kv_bytes = wl["isl"] / 2.0 * 2 * c.kv_size * c.num_layers * kv_itemsize
    pf_share = pf_kv_bytes / (pf_kv_bytes + w_bytes)
    # The port dispatches a unified step without waiting for it, so a
    # chunk's wall is its enqueue's: prefill MFU is taken over the
    # prefill steps' device time (their stream spans), the wall reported.
    pf = dispatch.get("prefill", {})
    pf_device, pf_tokens = pf.get("device_s", 0.0), pf.get("prompt_tokens", 0)
    pf_mfu = 2 * params * pf_tokens / (pf_device * peak) if pf_device else 0.0
    err(f"bench: prefill MFU {pf_mfu * 100:.2f}% of the same peak ({pf_tokens} prompt tokens over "
        f"{pf.get('chunks', 0)} chunks, {pf_device * 1e3:.3f} ms of device time, "
        f"{pf.get('wall_s', 0.0):.4f}s of dispatch wall, chunk p50 {pf.get('p50_ms', 0.0)}ms p99 "
        f"{pf.get('p99_ms', 0.0)}ms, kernel={names[1]}) [{where}]")
    line = {
        "metric": "engine_output_tokens_per_sec",
        "value": round(total / dt, 2),
        "unit": "tokens/s",
        "vs_baseline": 1.0,
        "decode_mfu": round(mfu, 4),
        "decode_kernel": names[0],
        "prefill_mfu": round(pf_mfu, 4),
        "prefill_kernel": names[1],
        "prefill": pf,
        "attention": {
            "share_est": round(attn_share, 4),
            "kv_bytes_per_step": int(kv_bytes),
            "weight_bytes_per_step": int(w_bytes),
            "prefill_share_est": round(pf_share, 4),
            "prefill_kv_bytes_per_chunk": int(pf_kv_bytes),
        },
        "host_gap_frac": round(max(0.0, dt - device_s) / dt, 4),
        "dispatch": {k: {"dispatches": v["dispatches"], "p50_ms": v["p50_ms"],
                         "p99_ms": v["p99_ms"]} for k, v in summary.items()},
        "pipeline": dispatch["pipeline"],
    }
    return line, details


def spec_prompts(kind: str, isl: int, n: int, vocab: int) -> List[List[int]]:
    """``repetitive``: period-8 templated prompts, greedy decode of which
    turns into loops the n-gram proposer mines; ``random``: pseudo-random
    prompts of jittered length."""
    prompts = []
    for i in range(n):
        if kind == "repetitive":
            pattern = [(i * 131 + j * 17 + 3) % vocab for j in range(8)]
            prompts.append((pattern * ((isl + 7) // 8))[:isl])
        else:
            isl_i = max(8, isl // 2 + (i * 2654435761) % isl)
            prompts.append([(i * 7919 + j * 104729 + 13) % vocab for j in range(isl_i)])
    return prompts


async def spec_run(engine, prompts, osl: int, temperature: float):
    """Every prompt at once, seed i·7+1: (tokens, wall, streams)."""
    async def one(i: int, prompt):
        items = await collect(await engine.generate(
            Context(request(prompt, osl, temperature, seed=i * 7 + 1))))
        return [t for it in items for t in it["token_ids"]]

    t0 = time.perf_counter()
    streams = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    return sum(len(s) for s in streams), time.perf_counter() - t0, streams


SPEC_KINDS = (("repetitive", 0.0), ("random", 0.7))


def spec_bench(cfg: EngineConfig, device: torch.device, hooks: Optional[Dict[str, Any]] = None,
               params=None):
    """BENCH_SPEC=1: speculation off, then on, each a fresh engine at the
    same config; the repetitive prompts greedy, the random ones seeded at
    0.7; per kind a 4-token warm pass, on CUDA a whole warm pass (it
    captures the sampled programs ``warmup`` leaves to first use), then
    the timed pass.  The streams must be identical between the modes.
    Env: BENCH_SPEC_ISL / _OSL / _REQUESTS / _K.  ``hooks``:
    ``before_timed(engine, kind, mode)``, ``after_timed(engine, kind,
    mode, tokens, wall, streams)``, and the coroutine ``after_mode(engine,
    mode)`` before an engine closes.  Returns (the one-line dict, results
    by (kind, mode), streams by (kind, mode))."""
    from .llm.metrics import spec_metrics

    hooks = hooks or {}
    env = os.environ.get
    isl, osl = int(env("BENCH_SPEC_ISL", "128")), int(env("BENCH_SPEC_OSL", "64"))
    n = int(env("BENCH_SPEC_REQUESTS", str(max(2, cfg.max_batch // 8))))
    k = int(env("BENCH_SPEC_K", "8"))
    vocab = get_config(cfg.model).vocab_size
    results: Dict[Any, Any] = {}
    streams: Dict[Any, Any] = {}

    async def one_mode(mode: str) -> None:
        engine = TorchEngine(dataclasses.replace(cfg, spec_decode={"enable": mode == "on", "k": k}),
                             params=params, device=device)
        try:
            await engine.run_warmup()
            for kind, temp in SPEC_KINDS:
                prompts = spec_prompts(kind, isl, n, vocab)
                await spec_run(engine, prompts, 4, temp)
                if device.type == "cuda":
                    await spec_run(engine, prompts, osl, temp)
                spec_metrics.reset()
                if "before_timed" in hooks:
                    hooks["before_timed"](engine, kind, mode)
                toks, dt, out = await spec_run(engine, prompts, osl, temp)
                snap = spec_metrics.snapshot()
                if "after_timed" in hooks:
                    hooks["after_timed"](engine, kind, mode, toks, dt, out)
                results[(kind, mode)] = dict(tok_s=toks / dt, tokens=toks, wall=dt, **snap)
                streams[(kind, mode)] = out
                err(f"bench[spec]: {kind}/{mode} {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s) "
                    f"acceptance={snap['acceptance_rate']:.3f} tok/dispatch="
                    f"{snap['tokens_per_dispatch']:.2f} dispatches={int(snap['dispatches_total'])}")
            if "after_mode" in hooks:
                await hooks["after_mode"](engine, mode)
        finally:
            await engine.close()

    for mode in ("off", "on"):
        asyncio.run(one_mode(mode))  # one loop per engine: its queues bind to it
    for kind, _ in SPEC_KINDS:
        if streams[(kind, "on")] != streams[(kind, "off")]:
            raise RuntimeError(f"speculation changed the {kind} token streams — the "
                               "exact-stream acceptance invariant is broken")
    err("bench[spec]: token streams identical on/off")
    rep = results[("repetitive", "on")]["tok_s"] / results[("repetitive", "off")]["tok_s"]
    rnd = results[("random", "on")]["tok_s"] / results[("random", "off")]["tok_s"]
    line = {
        "metric": "spec_decode_speedup_repetitive",
        "value": round(rep, 3), "unit": "x", "vs_baseline": round(rep, 3),
        "random_ratio": round(rnd, 3),
        "repetitive_tok_s": {m: round(results[("repetitive", m)]["tok_s"], 2) for m in ("off", "on")},
        "random_tok_s": {m: round(results[("random", m)]["tok_s"], 2) for m in ("off", "on")},
        "acceptance_rate": round(results[("repetitive", "on")]["acceptance_rate"], 4),
        "tokens_per_dispatch": round(results[("repetitive", "on")]["tokens_per_dispatch"], 2),
    }
    return line, results, streams


def churn_bench(cfg: EngineConfig, device: torch.device, params=None):
    """BENCH_CHURN=1: rows finishing at staggered lengths plus late arrivals
    landing inside a live fused session, with in-loop admission and
    retirement on (default) and off (``_continuous_decode = False``).  The
    streams must be identical.  ``compile_counts_stable`` is the JAX
    bench's: no program added after ``warmup``.  The port's ``warmup``
    captures the greedy programs and the trace's sampled rows key their
    own at first use, so here it reads false where the JAX engine's one
    jitted program reads true.  Env: BENCH_CHURN_ISL / _REQUESTS.  Returns
    (the one-line dict, results)."""
    isl = int(os.environ.get("BENCH_CHURN_ISL", "24"))
    n = int(os.environ.get("BENCH_CHURN_REQUESTS", "10"))
    vocab = get_config(cfg.model).vocab_size
    results: Dict[bool, Any] = {}

    async def run_mode(continuous: bool) -> None:
        engine = TorchEngine(cfg, params=params, device=device)
        engine._continuous_decode = continuous
        try:
            compiles0 = await engine.run_warmup()
            async def one(i: int, osl: int, late: bool):
                if late:
                    # Land inside a live fused session: wait until the
                    # pipeline has members (the same trigger in both modes).
                    for _ in range(2000):
                        if engine._pipeline_members:
                            break
                        await asyncio.sleep(0.002)
                items = await collect(await engine.generate(Context(request(
                    bench_prompt(i, isl, vocab), osl, 0.9, seed=i + 1))))
                return [t for it in items for t in it["token_ids"]]

            jobs = []
            for i in range(n):
                late = i >= (n + 1) // 2
                osl = (16 + 8 * (i % 3)) if not late else (6 + 3 * (i % 4))
                jobs.append(one(i, osl, late))
            t0 = time.perf_counter()
            streams = await asyncio.gather(*jobs)
            dt = time.perf_counter() - t0
            summary = engine.dispatch_summary()
            results[continuous] = {
                "streams": streams, "tok_s": sum(len(s) for s in streams) / dt,
                "compiles_stable": engine.compile_counts() == compiles0,
                "summary": summary,
                "decode_kernel": KERNEL_NAMES[summary["decode_kernel"]][0],
            }
        finally:
            await engine.close()

    for mode in (True, False):
        asyncio.run(run_mode(mode))
    on, off = results[True], results[False]
    if on["streams"] != off["streams"]:
        raise RuntimeError("continuous batching changed the token streams — the exact-stream "
                           "equivalence invariant is broken")
    err(f"bench[churn]: token streams identical on/off (decode_kernel={on['decode_kernel']})")
    pipe_on, pipe_off = on["summary"]["pipeline"], off["summary"]["pipeline"]
    for mode, r, pipe in (("on", on, pipe_on), ("off", off, pipe_off)):
        err(f"bench[churn]: continuous={mode} {r['tok_s']:.1f} tok/s sessions={pipe['sessions']} "
            f"rebuilds={pipe['rebuilds']} admissions={pipe['continuous_admissions']} "
            f"retired={pipe['continuous_retired']} host_gap={pipe['host_gap_frac']}")
    line = {
        "metric": "continuous_decode_rebuilds",
        "decode_kernel": on["decode_kernel"],
        "value": pipe_on["rebuilds"], "unit": "rebuilds",
        "vs_baseline": round(pipe_on["rebuilds"] / max(1, pipe_off["rebuilds"]), 3),
        "rebuilds": {"continuous": pipe_on["rebuilds"], "forced": pipe_off["rebuilds"]},
        "sessions": {"continuous": pipe_on["sessions"], "forced": pipe_off["sessions"]},
        "continuous_admissions": pipe_on["continuous_admissions"],
        "continuous_retired": pipe_on["continuous_retired"],
        "host_gap_frac": pipe_on["host_gap_frac"],
        "compile_counts_stable": bool(on["compiles_stable"] and off["compiles_stable"]),
        "dispatch": {k: {"dispatches": v["dispatches"], "p50_ms": v["p50_ms"],
                         "p99_ms": v["p99_ms"]} for k, v in on["summary"]["kinds"].items()},
        "tok_s": {"continuous": round(on["tok_s"], 2), "forced": round(off["tok_s"], 2)},
    }
    return line, results


def prefix_bench(cfg: EngineConfig, device: torch.device, params=None):
    """BENCH_PREFIX=1: a shared-system-prompt, two-turn trace replayed
    through four tier configurations — tiers off, host only, host + disk
    (a 4-block host window forces demotion) and a cross-worker pull (a
    fresh engine pulls the prefix a donor computed) — with per-mode TTFT
    and the share of second-turn prefill skipped through prefix hits.  All
    modes' streams must be identical.  Env: BENCH_PREFIX_SESSIONS / _SYS.
    Returns (the one-line dict, results by mode)."""
    from .llm.kv_router.pull import PrefixPuller

    sessions = int(os.environ.get("BENCH_PREFIX_SESSIONS", "5"))
    bs = 4
    sys_len = int(os.environ.get("BENCH_PREFIX_SYS", "40"))
    ctx_len, osl, extra = 12, 9, 3
    vocab = get_config(cfg.model).vocab_size
    base = dict(model=cfg.model, block_size=bs, num_blocks=48, max_batch=4, max_model_len=256,
                prefill_chunk=64, dtype=cfg.dtype, host_offload_interval=0.01)
    shared_sys = [(7 * j + 13) % vocab for j in range(sys_len)]

    def user(i: int, n: int, off: int = 0):
        return [(i * 7919 + (off + j) * 104729) % vocab for j in range(n)]

    async def gen(engine, tokens, max_tokens, annotations=None):
        t0 = time.perf_counter()
        out, ttft = [], None
        async for item in await engine.generate(Context(request(tokens, max_tokens,
                                                                annotations=annotations))):
            if ttft is None:
                ttft = (time.perf_counter() - t0) * 1e3
            out.extend(item.get("token_ids") or [])
        return out, ttft

    async def run_mode(mode: str, tmpdir: str) -> dict:
        over: dict = {}
        if mode in ("off", "pull"):
            over["host_cache_bytes"] = 0
        elif mode == "host":
            over["host_cache_bytes"] = 256 << 20
        elif mode == "disk":
            over.update(host_cache_bytes=1, disk_cache_bytes=256 << 20, disk_cache_dir=tmpdir)
        engine = TorchEngine(EngineConfig(**{**base, **over}), params=params, device=device)
        donor = None
        if mode == "disk":
            engine.host_kv.capacity_bytes = 4 * engine.block_nbytes()
        if mode == "pull":
            donor = TorchEngine(EngineConfig(**{**base, "host_cache_bytes": 0}),
                                params=engine.params, device=device)

            async def exporter(worker_id, data):
                return await donor.export_prompt_blocks(
                    data["token_ids"], start_block=data.get("start_block", 0),
                    max_blocks=data.get("max_blocks", 0), salt=data.get("salt"))

            engine.set_prefix_puller(PrefixPuller(engine, exporter))
        try:
            await engine.run_warmup()
            if donor is not None:
                await donor.run_warmup()
            streams, ttfts = [], []
            skipped = total = 0

            async def session(i: int, measured: bool):
                nonlocal skipped, total
                t1 = shared_sys + user(i, ctx_len)
                serve = donor if mode == "pull" else engine
                out1, _ = await gen(serve, t1, osl)
                await serve.drain_offload()
                # Filler prompts churn the engine's small pool between turns
                # (in pull mode the engine is the cold target; the donor
                # keeps its cache, as a remote peer would).
                for f in range(6):
                    await gen(engine, user(1000 + i * 11 + f, 32), 1)
                    await engine.drain_offload()
                t2 = t1 + out1 + user(i, extra, off=900)
                hint = None
                if mode == "pull":
                    hint = {"kv_pull": {"worker_id": 0, "blocks": donor.estimate_prefix_hit(t2) // bs}}
                lk0, mt0 = engine.kv.lookup_blocks, engine.kv.matched_blocks
                out2, ttft = await gen(engine, t2, osl, annotations=hint)
                if measured:
                    streams.append(out2)
                    ttfts.append(ttft)
                    skipped += engine.kv.matched_blocks - mt0
                    total += engine.kv.lookup_blocks - lk0

            await session(-1, False)  # priming: the tier paths' first use
            compiles_ref = engine.compile_counts()
            for i in range(sessions):
                await session(i, True)
            ttfts_s = sorted(ttfts)
            return {
                "streams": streams,
                "ttft_ms_p50": round(ttfts_s[len(ttfts_s) // 2], 2),
                "skip_frac": round(skipped / total, 4) if total else 0.0,
                "compile_stable": engine.compile_counts() == compiles_ref,
                "pulled_blocks": engine.kv.matched_blocks if mode == "pull" else 0,
            }
        finally:
            await engine.close()
            if donor is not None:
                await donor.close()

    results: Dict[str, Any] = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        for mode in ("off", "host", "disk", "pull"):
            results[mode] = r = asyncio.run(run_mode(mode, tmpdir))
            err(f"bench[prefix]: {mode:5s} ttft_p50={r['ttft_ms_p50']}ms skip={r['skip_frac']} "
                f"compile_stable={r['compile_stable']}")
    identical = all(results[m]["streams"] == results["off"]["streams"]
                    for m in ("host", "disk", "pull"))
    if not identical:
        raise RuntimeError("tiered/pulled prefix streams diverged from the no-tier control — "
                           "the exact-stream equivalence invariant is broken")
    err("bench[prefix]: streams identical across all modes")
    line = {
        "metric": "prefix_reuse_skip_frac",
        "value": results["host"]["skip_frac"], "unit": "frac", "vs_baseline": 0.0,
        "modes": {m: {k: v for k, v in r.items() if k != "streams"} for m, r in results.items()},
        "identical": identical,
        "compile_stable": all(r["compile_stable"] for r in results.values()),
        "pull_served_blocks": results["pull"]["pulled_blocks"],
    }
    return line, results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="cpu for the CPU geometry (default: CUDA, required)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    if os.environ.get("BENCH_WARM_CHECK"):
        raise SystemExit("bench: BENCH_WARM_CHECK measures the JAX package's persistent XLA "
                         "compilation cache (engine/xla_cache.py), which has no counterpart in "
                         "the port: its kernels persist in dynamo_tpu_torch/_build and CUDA graphs "
                         "cannot outlive their process")
    cfg, wl = engine_config(device)
    cfg = cut_depth(cfg, wl.get("layers") or 0)
    mc = get_config(cfg.model)
    err(f"bench: model={cfg.model} layers={mc.num_layers} quant={cfg.weight_quant or 'bf16'} "
        f"kv={cfg.cache_dtype} device={device} "
        f"[{card() if device.type == 'cuda' else 'no card'}]")
    if os.environ.get("BENCH_SPEC"):
        line, _, _ = spec_bench(cfg, device)
    elif os.environ.get("BENCH_CHURN"):
        line, _ = churn_bench(cfg, device)
    elif os.environ.get("BENCH_PREFIX"):
        line, _ = prefix_bench(cfg, device)
    else:
        line, _ = headline(cfg, wl, device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
