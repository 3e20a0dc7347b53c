#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-ab   # direct vs HTTP serve in turns only
    python3 chip_smoke.py --quant-ab   # phase c's traffic, W8A8 vs bf16 in turns only

Phases, any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from dynamo_tpu_torch/csrc with nvcc;
  3. check that the bf16 kernel bodies run on the tensor cores and the
     f32 bodies do not (HMMA instructions in cuobjdump's SASS); check each
     kernel against its plain PyTorch version at llama-3.1-8b attention
     geometry (H 32, KV 8, D 128, page size 16), at 64 rows and at the
     serve phase's own row count and table width: ragged lengths,
     zero-length and padding rows, decode contexts on and one past a
     partition boundary and across the whole 4096-token table, prefill
     chunks that are not multiples of a tile over prefixes ending mid-page,
     a mixed step's 1-token rows beside a 512-token chunk, bf16 q over
     bf16 / int8 / fp8 / f32 pages and f32 q over f32 pages, KV splits;
     rtol = atol = 1e-2 for bf16 outputs, 1e-4 for f32;
  4. time each kernel at the shapes the serving path gives it, beside its
     plain version, its bytes/flops bound, and one PyTorch library call of
     the same function (scaled_dot_product_attention over pre-gathered
     contiguous K/V at KV heads — a yardstick the port never calls); the
     kernel's output there is held against the plain version's and the
     library's; and the prefill kernel once more at a mixed step's shape
     (the 512-token chunk plus 7 one-token rows), beside a decode launch of
     those 7 rows;
  5. the paged model path in f32 (4 layers at full width, f32 pages)
     against a dense reference forward: chunked prefill over a prior
     prefix, then decode steps, at rtol = atol = 1e-4;
  6. build TorchEngine on llama-3.1-8b at full width and depth (random
     seeded bf16 weights, page size 16, decode_steps 8, prefill_chunk 512,
     pipeline_depth 2), capture every device program ahead of time
     (``run_warmup``: one CUDA graph per token bucket, two for the fused
     decode), then serve 8 concurrent greedy requests through the
     continuous pipeline, with both kernels' launch counters (advanced per
     graph replay) zeroed just before and read just after; check every
     stream, that the serve captured no graph, and the bf16 model's logits
     against the dense reference; then hold a captured prefill bucket and
     the captured fused decode (seeded and chained) against the eager
     calls on the same inputs, writes dropped: equal tokens, logprobs
     within 1e-3; then a churn serve on the same engine: 16 requests at
     max_batch 16, the back half arriving inside a live fused session, with
     staggered max_tokens, which must be admitted and retired in the loop
     with no rebuild and no new graph;
  7. serve the same model over HTTP through the CLI's own code
     (``run in=http out=torch``, a fresh engine warmed before the timed
     requests, the server's event loop in a thread of this process) to a
     standard-library client: /v1/models and /health, the same 8 prompts as
     streamed /v1/completions, one chat request unary and streamed (equal
     texts), an unknown model (404) and /metrics (the engine-dispatch
     group too), with both kernels' counters zeroed before and read after;
  a. W8A8 ops: ``qdot`` at each llama-3.1-8b projection shape (wqkv, wo,
     w_gateup, w_down, lm_head) and M = 16, 256, 2048: int32 accumulation
     equal to an exact integer reference, every output entry within 8
     standard deviations of the activations' rounding from
     x @ dequant(w), the largest error within 1.5 % of its largest entry;
     timed against bf16 ``torch.matmul`` and ``_int_mm``
     alone in both weight layouts, beside the bounds; then both kernels
     over int8 pages at the shapes of phases c and d, each held against
     its plain version and timed beside its plain version, its bound and
     SDPA over pre-gathered, dequantized K/V;
  b. the W8A8 model: llama-3.1-8b at 4 and 32 layers (int8 weights drawn
     by the engine, int8 KV scales calibrated at start — printed with the
     time calibration took) against its own tree dequantized to bf16: mean
     KL < 0.05 and decisive top-1 agreement at both depths; int8 pages vs
     bf16 pages on the W8A8 model: cosine > 0.99 at 4 layers, and at 32
     1 - cosine within 8x the bf16 tree's under the same scales;
  c. bench.py's geometry on one W8A8 + int8-KV ``auto`` engine (max_batch
     256, max_model_len 256, 4160 pages, prefill_chunk 512, decode_steps 8,
     pipeline_depth 8): 256 greedy requests, ISL 128, OSL 64, after
     ``run_warmup()``, with no graph captured during the serve;
  d. benchmarks/loadgen.py's self-hosted geometry through the port's
     HttpService → preprocessor → backend (W8A8 + int8 KV ``auto``,
     max_batch 24, max_model_len 4096, 6208 pages, prefill_chunk 2048,
     decode_steps 16, pipeline_depth 4): 24 concurrent streamed
     /v1/completions of 3000-token-id prompts, OSL 150, and /metrics;
  e. speculation as bench.py's ``_spec_bench`` runs it: a fresh W8A8
     engine at phase c's geometry per mode, off then on at k 8, 32
     requests of repetitive prompts (greedy) and of random prompts
     (temperature 0.7, seed i·7+1); the streams must be identical; then
     the same traffic on the spec-on engine with drafts forced from an
     oracle of the spec-off streams (one token wrong in every other
     8-token window): identical streams again, with verification
     dispatches and both accepted and rejected drafts;
  f. the serving edge's overload and observability plane, on phase 6's
     warm engine through three HttpService instances on free ports
     (preprocessor → backend → engine): admission (max_inflight 4, queue 2,
     wait 30 s) under a burst of 12 streamed /v1/completions of 512 ids and
     64 new tokens — exactly 6 whole streams, 6 429s with Retry-After,
     counted on /metrics; a stream with ``x-deadline-s: 0.5`` and
     max_tokens 2048 ends in the SSE 504 error event and its row leaves the
     engine within one fused dispatch, no KV block held; QoS at rate 1,
     burst 2: one tenant's three requests get 200, 200, 429 (quota) and
     the brownout ladder ticks off the engine's live KV usage; 4 requests
     with ``x-trace: 1`` (2048 ids, logprobs so the first token's chunk
     reaches the client) each assemble at /traces/{id} with the edge,
     preprocess, queue-wait, prefill (first_token) and decode-chunk spans
     in order, the TTFT decomposition's terms within 10 % of the client's
     TTFT; then 8 greedy requests a pass, one at a time, traced none /
     all / all / none after a concurrent pass that fills the prefix cache:
     identical token streams and no graph captured,
     with each pass's TTFT and ITL medians (the tracing overhead, not
     gated) and both kernels' launches in the phase;
  g. the KV memory tiers on engines sharing phase 6's weights (512 pages,
     1 GiB; host tier 1024 MiB pinned, disk 1024 MiB and object store
     2048 MiB in a temporary directory removed at the end): 12 greedy
     prompts of 2056 ids, 16 new tokens each, one at a time, the offload
     queue drained after each, so 1536 blocks demote host → disk → object
     store; then, each prompt's chain evicted from the device first, a
     re-serve whose first block is on disk under a ``kv_corrupt`` fault
     (quarantined: one disk corruption, nothing restored, the stream
     recomputed), and re-serves whose first block sits in host, on disk
     and in the object store (128 blocks restored ahead of admission);
     then a fresh engine on the same object store serves an
     object-store-resident prompt (scale from zero).  Every stream equals
     its first pass; a chosen block's restored pages equal the bytes read
     after its first prefill, bitwise; the restored counts equal the
     engine's counter and the /metrics text; the host restore's TTFT is
     below the first pass's; no graph is captured and no
     ``torch.cuda.synchronize`` runs while serving.  Then phase 6's 8
     concurrent requests on a host-tier engine and on one without tiers,
     in turns (the pump's cost on TTFT and ITL, not gated);
  8. print the kernels line (each kernel's int8 timings and its launches in
     phases c, d, e, f and g beside phase 6's and 7's), then the device line
     last.

Needs a CUDA device; without one it prints no result and exits 1.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak

H, KV, D, PS = 32, 8, 128, 16  # llama-3.1-8b attention geometry
G = H // KV
# The serving configuration of phase 6; phase 4 times the kernels at the
# shapes it gives them.
SERVE_CFG = dict(
    model="llama-3.1-8b", dtype="bfloat16", block_size=PS, num_blocks=2048,
    max_batch=16, max_model_len=4096, prefill_chunk=512, decode_steps=8,
    pipeline_depth=2, seed=0,
)


# The card's name and power limit as nvidia-smi gives them (set by main).
CARD = "not read"


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ inputs


def _pages(torch, gen, dev, P, dtype, scale):
    from dynamo_tpu_torch.ops.ragged_attention import quantize_for_cache

    vals = torch.randn((P, PS, 2 * KV, D), generator=gen, device=dev)
    return quantize_for_cache(vals / scale, dtype)


def decode_case(torch, gen, dev, lens, nvalid, PP, q_dtype, page_dtype, scale):
    S = len(lens)
    q = torch.randn((S, H, D), generator=gen, device=dev).to(q_dtype)
    pages = _pages(torch, gen, dev, S * PP + 8, page_dtype, scale)
    tables = torch.randperm(S * PP, generator=gen, device=dev).view(S, PP).int()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    num = torch.tensor([nvalid], dtype=torch.int32, device=dev)
    return q, pages, kv_lens, tables, num


def prefill_case(torch, gen, dev, priors, q_lens, S, T, q_dtype, page_dtype, scale):
    kv = [p + n for p, n in zip(priors, q_lens)]
    PP = max(1, math.ceil(max(kv) / PS))
    q = torch.randn((T, H, D), generator=gen, device=dev).to(q_dtype)
    pages = _pages(torch, gen, dev, S * PP + 8, page_dtype, scale)
    tables = torch.randperm(S * PP, generator=gen, device=dev).view(S, PP).int()
    kv_lens = torch.zeros(S, dtype=torch.int32, device=dev)
    kv_lens[: len(kv)] = torch.tensor(kv, dtype=torch.int32)
    cu = [0]
    for n in q_lens:
        cu.append(cu[-1] + n)
    cu += [cu[-1]] * (S + 1 - len(cu))
    cu_t = torch.tensor(cu, dtype=torch.int32, device=dev)
    num = torch.tensor([len(q_lens)], dtype=torch.int32, device=dev)
    return q, pages, kv_lens, tables, cu_t, num


# ------------------------------------------------------------------ timing


SPIN_CYCLES = 100_000_000  # ~50 ms at the H100's clocks


def cuda_ms(torch, fn, iters, flush, spin=True):
    """Mean device ms of ``fn`` over ``iters`` launches, each timed by CUDA
    events with the L2 cache flushed before it (the serving path reads each
    layer's KV once per step, cold).  With ``spin``, a spin kernel holds
    the stream while the host queues every launch, so a timed window holds
    the device's work and not the host's time to launch it; if the spin
    ends before the last launch is queued, the run is made again with a
    longer spin.  Without it (for a function that waits on the device
    itself), a window also holds the host's time inside ``fn``."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        if spin:
            torch.cuda._sleep(SPIN_CYCLES * 4**attempt)
        spun = torch.cuda.Event()
        spun.record()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        queued_in_time = not spin or not spun.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return sum(s.elapsed_time(e) for s, e in pairs) / iters
    raise RuntimeError("the host could not queue the timed launches within the spin")


TIMING_ROUNDS = 7


def alternating_ms(torch, kernel, library, flush):
    """Kernel and library call timed in turns, TIMING_ROUNDS rounds of 20
    launches each, so that a drift of the card's clocks reaches both
    alike: the median round of each, and every round's mean."""
    rounds = {"ms": [], "library_ms": []}
    for _ in range(TIMING_ROUNDS):
        rounds["ms"].append(cuda_ms(torch, kernel, 20, flush))
        rounds["library_ms"].append(cuda_ms(torch, library, 20, flush))
    return {k: statistics.median(v) for k, v in rounds.items()}, rounds


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel checks


def tensor_core_report(lib_path):
    """HMMA (tensor-core mma) instructions per kernel function in a built
    library's SASS, from cuobjdump: {function: count}, or None without the
    tool."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def check_tensor_cores(failures):
    """The bf16 bodies (``*_tc_kernel``) must run on the tensor cores and
    the f32 bodies (``*_f32_kernel``) must not."""
    from dynamo_tpu_torch.ops import _build

    for stem in ("decode_attention", "prefill_attention"):
        counts = tensor_core_report(_build._target(_build.CSRC / f"{stem}.cu"))
        if counts is None:
            log(f"sass {stem}: cuobjdump not found, not checked")
            continue
        for fn, n in sorted(counts.items()):
            m = re.search(r"\d+((?:prefill|decode)_(?:tc|f32)_kernel)I(\w+?)EEv", fn)
            if not m:
                continue
            ok = n > 0 if m.group(1).endswith("_tc_kernel") else n == 0
            log(f"sass {stem}: {m.group(1)}<{m.group(2)}> {n} HMMA {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{stem} {m.group(1)}<{m.group(2)}> tensor-core use")


class Tally:
    """Every comparison of a kernel with its plain version: the worst
    max-abs error per kernel and the labels of those that failed."""

    def __init__(self):
        self.worst = {"decode_attention": 0.0, "prefill_attention": 0.0}
        self.failures = []

    def compare(self, torch, name, label, got, want, tol, zero_rows=()):
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        self.worst[name] = max(self.worst[name], err)
        ok = bool(torch.isfinite(g).all()) and torch.allclose(g, w, rtol=tol, atol=tol)
        for r in zero_rows:
            ok = ok and bool((g[r] == 0).all())
        log(f"check {name} {label}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name} {label}")


# (q dtype, page dtype, kv_scale, tolerance) of every kernel check.
CHECK_DTYPES = [
    ("bfloat16", "bfloat16", 1.0, 1e-2),
    ("bfloat16", "int8", 0.02, 1e-2),
    ("bfloat16", "float8_e4m3fn", 0.01, 1e-2),
    ("bfloat16", "float32", 1.0, 1e-2),
    ("float32", "float32", 1.0, 1e-4),
]


def serving_decode_lens(cfg):
    """kv_lens of a fused decode dispatch of the serve phase: 8 live rows at
    576..2116 tokens, the other max_batch rows padding rows at kv_len 1."""
    live = [576 + 220 * i for i in range(8)]
    return live, live + [1] * (cfg.max_batch - len(live))


# Context lengths of the 7 decode rows that ride a mixed prefill/decode
# step beside a 512-token chunk: spread over the serve phase's decode
# lengths, 576..2116 tokens.
MIXED_DECODE_LENS = [576, 833, 1089, 1346, 1603, 1859, 2116]


def check_kernels(torch, dev, cfg, tally):
    """Phase 3: each kernel against its plain version, every page dtype."""
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sm = D**-0.5
    dt = {n: getattr(torch, n) for n in ("bfloat16", "int8", "float8_e4m3fn", "float32")}

    # Decode: S 64 with ragged kv_len up to 4096, zero-length rows and rows
    # past num_seqs; and the serve phase's own geometry (max_batch rows,
    # padding rows at kv_len 1, its table width), whose automatic split
    # count leaves an uneven last split.
    lens64 = [int(x) for x in torch.randint(1, 4097, (64,), generator=torch.Generator().manual_seed(1))]
    lens64[0], lens64[5], lens64[17] = 4096, 0, 1
    # Partition edges: kv_len on a partition boundary and one past it, a
    # row spanning the whole 4096-token table, padding rows at kv_len 1 and
    # rows past num_seqs.
    part = da.DECODE_PARTITION
    edges = [part, part + 1, 2 * part, 2 * part + 1, 4096, part - 1, 1, 1, 3000, 1]
    geometries = [
        ("S=64", lens64, 56, 4096 // PS),
        (f"S={cfg.max_batch} serving", serving_decode_lens(cfg)[1], cfg.max_batch,
         cfg.max_blocks_per_seq),
        (f"S={len(edges)} partition edges", edges, 8, 4096 // PS),
    ]
    for geo, lens, nvalid, PP in geometries:
        S = len(lens)
        zero = [r for r in range(S) if r >= nvalid or lens[r] == 0]
        for q_dt, p_dt, scale, tol in CHECK_DTYPES:
            q, pages, kv_lens, tables, num = decode_case(
                torch, gen, dev, lens, nvalid, PP, dt[q_dt], dt[p_dt], scale)
            want = da.decode_attention_plain(q, pages, kv_lens, tables, num, sm_scale=sm, kv_scale=scale)
            for splits in (1, None):
                got = da.decode_attention_cuda(q, pages, kv_lens, tables, num, sm_scale=sm,
                                               kv_scale=scale, num_kv_splits=splits)
                tally.compare(torch, "decode_attention",
                              f"{geo} q={q_dt} pages={p_dt} splits={splits or 'auto'}",
                              got, want, tol, zero)
            del q, pages, want, got

    # Prefill, at the serve phase's row count with rows past num_seqs and a
    # padded T bucket: ragged rows whose lengths are not multiples of the
    # kernel's q-block (16 tokens at G 4), of a warp's 16 rows or of its
    # 64-key tile, prior prefixes ending mid-page and on page edges, and a
    # mixed step's 512-token chunk beside 1-token rows up to 2116 tokens.
    S = cfg.max_batch
    cases = [
        ("ragged", [0, 1024, 77, 300, 2000], [37, 500, 1, 203, 61], 1024),
        ("tile edges", [16, 45, 64, 0, 1], [63, 65, 17, 128, 3], 512),
        ("mixed step", [1024] + [n - 1 for n in MIXED_DECODE_LENS], [512] + [1] * 7,
         cfg.bucket_tokens(519)),
    ]
    for label, priors, q_lens, T in cases:
        for q_dt, p_dt, scale, tol in CHECK_DTYPES:
            q, pages, kv_lens, tables, cu, num = prefill_case(
                torch, gen, dev, priors, q_lens, S, T, dt[q_dt], dt[p_dt], scale)
            want = pa.prefill_attention_plain(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                              kv_scale=scale)
            zero = list(range(sum(q_lens), T))
            for splits in (1, 3):
                got = pa.prefill_attention_cuda(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                                kv_scale=scale, num_kv_splits=splits)
                tally.compare(torch, "prefill_attention",
                              f"{label} S={S} T={T} q={q_dt} pages={p_dt} splits={splits}",
                              got, want, tol, zero)
            del q, pages, want, got
    torch.cuda.empty_cache()


# ------------------------------------------------------------ kernel timing


def time_decode(torch, dev, tally, flush, label, lens, n_live, PP, page_dtype, scale,
                lib_rtol=0.0):
    """Time one decode launch at ``lens`` (the first ``n_live`` rows real,
    the rest padding rows at kv_len 1), table width ``PP``, bf16 q over
    ``page_dtype`` pages stored at ``scale``: the kernel, held against its
    plain version, beside the plain version, the bound and the library
    yardstick — SDPA over the live rows' pre-gathered K/V, dequantized to
    bf16 and kept at KV heads, each KV head's G query heads as its G query
    positions (the gather is not timed)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    sm = D**-0.5
    S = len(lens)
    kv_scale = None if page_dtype == torch.bfloat16 else scale
    q, pages, kv_lens, tables, num = decode_case(
        torch, gen, dev, lens, S, PP, torch.bfloat16, page_dtype, scale)
    esize = pages.element_size()
    kv_bytes = sum(lens) * 2 * KV * D * esize + sum(math.ceil(n / PS) for n in lens) * 4
    b_ms, b_by = bound(kv_bytes + 2 * q.numel() * 2 + S * 4, sum(lens) * H * D * 4)

    def kernel():
        return da.decode_attention_cuda(q, pages, kv_lens, tables, num, sm_scale=sm,
                                        kv_scale=kv_scale)

    def plain():
        return da.decode_attention_plain(q, pages, kv_lens, tables, num, sm_scale=sm,
                                         kv_scale=kv_scale)

    got = kernel()
    tally.compare(torch, "decode_attention", f"{label} S={S} PP={PP} pages={page_dtype}",
                  got, plain(), 1e-2)
    W = max(lens[:n_live])
    ctx = torch.arange(W, device=dev)
    slots = tables[:n_live, (ctx // PS).clamp(max=PP - 1)].long() * PS + ctx % PS
    kvg = (pages.view(-1, 2 * KV, D)[slots].float() * (kv_scale or 1.0)).to(torch.bfloat16)
    k = kvg[:, :, 0::2].permute(0, 2, 1, 3).contiguous()  # [n, KV, W, D]
    v = kvg[:, :, 1::2].permute(0, 2, 1, 3).contiguous()
    del kvg
    mask = (ctx[None, :] < kv_lens[:n_live, None])[:, None, None, :]  # [n, 1, 1, W]
    qg = q[:n_live].reshape(n_live, KV, G, D)

    def library():
        return F.scaled_dot_product_attention(qg, k, v, attn_mask=mask, scale=sm)

    lib = library().reshape(n_live, H, D).float()
    lib_err = float((lib - got[:n_live].float()).abs().max())
    lib_ok = torch.allclose(lib, got[:n_live].float(), rtol=lib_rtol, atol=LIBRARY_ATOL)
    medians, rounds = alternating_ms(torch, kernel, library, flush)
    r = dict(**medians, rounds=rounds, plain_ms=cuda_ms(torch, plain, 3, flush, spin=False),
             library_err=lib_err, library_ok=lib_ok, lib_rtol=lib_rtol, bound_ms=b_ms,
             bound_by=b_by,
             shape=f"{label}: S={S} PP={PP} kv_lens {min(lens[:n_live])}..{W} "
                   f"({n_live} live) q bf16 pages {str(page_dtype).split('.')[-1]}; "
                   f"library: {n_live} live rows padded to {W}")
    del q, pages, k, v, got, lib
    return r


def time_prefill(torch, dev, tally, flush, label, S, T, priors, q_lens, page_dtype, scale,
                 lib_rtol=0.0):
    """Time one prefill launch of rows ``q_lens`` over prior prefixes
    ``priors`` in a ``T``-token bucket of ``S`` rows, bf16 q over
    ``page_dtype`` pages: the kernel against its plain version, beside the
    plain version, the bound and the library yardstick — one SDPA call
    over every row's pre-gathered, dequantized K/V at KV heads (query
    token t of head kv*G + g is row t*G + g of its KV head; rows padded to
    the longest, masked causally at prior + t)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import prefill_attention as pa

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    sm = D**-0.5
    kv_scale = None if page_dtype == torch.bfloat16 else scale
    q, pages, kv_lens, tables, cu, num = prefill_case(
        torch, gen, dev, priors, q_lens, S, T, torch.bfloat16, page_dtype, scale)
    ctxs = [p + n for p, n in zip(priors, q_lens)]
    nbytes = (sum(ctxs) * 2 * KV * D * pages.element_size() + 2 * sum(q_lens) * H * D * 2
              + sum(math.ceil(c / PS) for c in ctxs) * 4)
    flops = sum(sum(p + i + 1 for i in range(n)) for p, n in zip(priors, q_lens)) * H * D * 4
    b_ms, b_by = bound(nbytes, flops)

    def kernel():
        return pa.prefill_attention_cuda(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                         kv_scale=kv_scale)

    def plain():
        return pa.prefill_attention_plain(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                          kv_scale=kv_scale)

    got = kernel()
    tally.compare(torch, "prefill_attention", f"{label} T={T} S={S} pages={page_dtype}",
                  got, plain(), 1e-2, range(sum(q_lens), T))
    R, Qm, L = len(q_lens), max(q_lens), max(ctxs)
    ctx = torch.arange(L, device=dev)
    PP = tables.shape[1]
    slots = tables[:R, (ctx // PS).clamp(max=PP - 1)].long() * PS + ctx % PS  # [R, L]
    kvg = (pages.view(-1, 2 * KV, D)[slots].float() * (kv_scale or 1.0)).to(torch.bfloat16)
    k = kvg[:, :, 0::2].permute(0, 2, 1, 3).contiguous()  # [R, KV, L, D]
    v = kvg[:, :, 1::2].permute(0, 2, 1, 3).contiguous()
    del kvg
    qg = torch.zeros((R, Qm, H, D), dtype=q.dtype, device=dev)
    for r, (start, n) in enumerate(zip(cu.tolist(), q_lens)):
        qg[r, :n] = q[start:start + n]
    qg = qg.reshape(R, Qm, KV, G, D).permute(0, 2, 1, 3, 4).reshape(R, KV, Qm * G, D).contiguous()
    t = torch.arange(Qm, device=dev)
    prior = torch.tensor(priors, device=dev)
    # Padding query rows may see key 0 only, so they stay finite.
    limit = torch.where(t[None, :] < torch.tensor(q_lens, device=dev)[:, None],
                        prior[:, None] + t[None, :], 0).repeat_interleave(G, dim=1)
    pmask = (ctx[None, None, :] <= limit[:, :, None])[:, None]  # [R, 1, Qm*G, L]

    def library():
        return F.scaled_dot_product_attention(qg, k, v, attn_mask=pmask, scale=sm)

    lib = library().reshape(R, KV, Qm, G, D).permute(0, 2, 1, 3, 4).reshape(R, Qm, H, D)
    pairs = [(lib[r, :n].float(), got[s:s + n].float())
             for r, (s, n) in enumerate(zip(cu.tolist(), q_lens))]
    lib_err = max(float((a - b).abs().max()) for a, b in pairs)
    lib_ok = all(torch.allclose(a, b, rtol=lib_rtol, atol=LIBRARY_ATOL) for a, b in pairs)
    medians, rounds = alternating_ms(torch, kernel, library, flush)
    out = dict(**medians, rounds=rounds, plain_ms=cuda_ms(torch, plain, 3, flush, spin=False),
               library_err=lib_err, library_ok=lib_ok, lib_rtol=lib_rtol, bound_ms=b_ms,
               bound_by=b_by,
               shape=f"{label}: T={T} S={S}, rows {list(q_lens)} tokens over prefixes "
                     f"{list(priors)}, q bf16 pages {str(page_dtype).split('.')[-1]}")
    del q, pages, k, v, got, lib, pairs
    return out


LIBRARY_ATOL = 1e-2


def report_times(torch, out, tally):
    """Print each timing and hold the library yardstick to the kernel's
    output (it must compute the same function)."""
    for name, r in out.items():
        ok = r["library_ok"]
        log(f"time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms (kernel/library {r['ms'] / r['library_ms']:.3f}; "
            f"vs kernel max_abs_err {r['library_err']:.3e} (atol {LIBRARY_ATOL} rtol "
            f"{r['lib_rtol']}) {'ok' if ok else 'FAIL'}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"medians of {TIMING_ROUNDS} alternating rounds: kernel "
            f"{[round(x, 4) for x in r['rounds']['ms']]} library "
            f"{[round(x, 4) for x in r['rounds']['library_ms']]}")
        if not ok:
            tally.failures.append(f"{name.split(' ')[0]} library yardstick computes another function")


def time_kernels(torch, dev, cfg, tally):
    """Phase 4, at the serving path's shapes: the rows of a fused decode
    dispatch (serving_decode_lens) and a 512-token prefill chunk over a
    1024-token prior prefix in its token bucket; then the prefill kernel at
    a mixed step's shape beside a decode launch of its one-token rows."""
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    sm = D**-0.5
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    S, PP = cfg.max_batch, cfg.max_blocks_per_seq
    live, lens = serving_decode_lens(cfg)
    out = {
        "decode_attention": time_decode(torch, dev, tally, flush, "serving shape", lens,
                                        len(live), PP, torch.bfloat16, 1.0),
        "prefill_attention": time_prefill(torch, dev, tally, flush, "serving shape", S,
                                          cfg.bucket_tokens(cfg.prefill_chunk), [1024],
                                          [cfg.prefill_chunk], torch.bfloat16, 1.0),
    }
    prior, ql = 1024, cfg.prefill_chunk

    # A mixed step: the serve cadence's 512-token chunk over its 1024-token
    # prefix beside 7 one-token decode rows (MIXED_DECODE_LENS), one prefill
    # launch.  No single library call computes it: library not measured.
    priors = [prior] + [n - 1 for n in MIXED_DECODE_LENS]
    q_lens = [ql] + [1] * len(MIXED_DECODE_LENS)
    Tm = cfg.bucket_tokens(sum(q_lens))
    q, pages, kv_lens, tables, cu, num = prefill_case(
        torch, gen, dev, priors, q_lens, S, Tm, torch.bfloat16, torch.bfloat16, 1.0)
    ctxs = [p + n for p, n in zip(priors, q_lens)]
    nbytes = (sum(ctxs) * 2 * KV * D * 2 + 2 * sum(q_lens) * H * D * 2
              + sum(math.ceil(c / PS) for c in ctxs) * 4)
    flops = (sum(prior + i + 1 for i in range(ql)) + sum(MIXED_DECODE_LENS)) * H * D * 4
    b_ms, b_by = bound(nbytes, flops)

    def kernel():
        return pa.prefill_attention_cuda(q, pages, kv_lens, tables, cu, num, sm_scale=sm)

    def plain():
        return pa.prefill_attention_plain(q, pages, kv_lens, tables, cu, num, sm_scale=sm)

    got = kernel()
    tally.compare(torch, "prefill_attention", f"mixed step shape T={Tm} S={S} bf16",
                  got, plain(), 1e-2, range(sum(q_lens), Tm))
    # What the 7 rows cost as a decode-shaped launch of their own (16 rows,
    # the rest padding rows at kv_len 1), for comparison.
    dq, dpages, dlens, dtables, dnum = decode_case(
        torch, gen, dev, MIXED_DECODE_LENS + [1] * (S - len(MIXED_DECODE_LENS)), S, PP,
        torch.bfloat16, torch.bfloat16, 1.0)

    def decode_rows():
        return da.decode_attention_cuda(dq, dpages, dlens, dtables, dnum, sm_scale=sm)

    rounds, drounds = [], []
    for _ in range(TIMING_ROUNDS):
        rounds.append(cuda_ms(torch, kernel, 20, flush))
        drounds.append(cuda_ms(torch, decode_rows, 20, flush))
    mixed = dict(ms=statistics.median(rounds), bound_ms=b_ms, bound_by=b_by,
                 plain_ms=cuda_ms(torch, plain, 3, flush, spin=False),
                 decode_rows_ms=statistics.median(drounds))
    log(f"time prefill_attention mixed step [T={Tm} S={S}: a {ql}-token chunk over a "
        f"{prior}-token prefix and 7 one-token rows at {MIXED_DECODE_LENS[0]}.."
        f"{MIXED_DECODE_LENS[-1]} tokens, bf16]: kernel {mixed['ms']:.4f} ms, plain "
        f"{mixed['plain_ms']:.4f} ms, library not measured (no single call computes it), "
        f"bound {b_ms:.4f} ms ({b_by}); the 7 rows as a decode launch "
        f"{mixed['decode_rows_ms']:.4f} ms; rounds {[round(x, 4) for x in rounds]} / "
        f"{[round(x, 4) for x in drounds]}")
    out["prefill_attention"]["mixed"] = mixed
    del q, pages, got, dq, dpages, flush
    torch.cuda.empty_cache()
    report_times(torch, out, tally)
    return out


# The int8-page shapes of this slice's two serving geometries (phases c
# and d): a fused decode step and a prefill step of each.
INT8_KV_SCALE = 0.02
# The library yardstick against the kernel there: a query early in a short
# causal context averages few values of up to ±2.54 (int8 · 0.02), where
# one bf16 ulp is 0.0156, so the check is relative as well.
INT8_LIB_RTOL = 1e-2


def time_int8_kernels(torch, dev, tally):
    """Both kernels over int8 pages (scale INT8_KV_SCALE) at the shapes of
    phase c (bench.py: 256 rows at 129..192 tokens over 16-page tables; a
    512-token step of four 128-token prompts) and phase d (loadgen: 24 rows
    at 3000..3138 tokens over 256-page tables; a 2048-token step packing a
    prompt's last 952 tokens over its 2048-token prefix with the next
    prompt's first 1096), each held against its plain version.  Returns
    {geometry: {kernel: timing}}."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    i8, sc = torch.int8, INT8_KV_SCALE
    bench_lens = [129 + (7 * i) % 64 for i in range(256)]
    loadgen_lens = [3000 + 6 * i for i in range(24)]
    out = {
        "bench": {
            "decode_attention": time_decode(torch, dev, tally, flush, "phase c fused step",
                                            bench_lens, 256, 16, i8, sc, INT8_LIB_RTOL),
            "prefill_attention": time_prefill(torch, dev, tally, flush, "phase c prefill step",
                                              256, 512, [0] * 4, [128] * 4, i8, sc,
                                              INT8_LIB_RTOL),
        },
        "loadgen": {
            "decode_attention": time_decode(torch, dev, tally, flush, "phase d fused step",
                                            loadgen_lens, 24, 256, i8, sc, INT8_LIB_RTOL),
            "prefill_attention": time_prefill(torch, dev, tally, flush, "phase d prefill step",
                                              24, 2048, [2048, 0], [952, 1096], i8, sc,
                                              INT8_LIB_RTOL),
        },
    }
    del flush
    torch.cuda.empty_cache()
    for geo, r in out.items():
        report_times(torch, {f"{k} int8 {geo}": v for k, v in r.items()}, tally)
    return out


# ------------------------------------------------------------- the model


def reference_logits(torch, params, mc, tokens):
    """Dense (unpaged) forward of one prompt through plain PyTorch math,
    attention in f32: the logits at every position, [n, vocab]."""
    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.ops.rope import apply_rope, rope_frequencies

    p = params
    dev = p["embed"].device
    n, nh, nkv, hd = len(tokens), mc.num_heads, mc.num_kv_heads, mc.head_dim
    ids = torch.tensor(tokens, device=dev)
    pos = torch.arange(n, device=dev)
    inv = rope_frequencies(mc.head_dim, mc.rope_theta, mc.rope_scaling, device=dev)
    causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    h = tl.embed_lookup(p, ids, tl.torch_dtype(mc.dtype))
    for l in range(mc.num_layers):
        lp = {k: w[l] for k, w in p["layers"].items()}
        x = tl.rms_norm(h, lp["attn_norm"], mc.rms_norm_eps)
        q, k, v = tl.qkv_proj(x, lp, nh * hd, nkv * hd)
        q = apply_rope(q.reshape(n, nh, hd), pos, inv).float()
        k = apply_rope(k.reshape(n, nkv, hd), pos, inv).float().repeat_interleave(nh // nkv, dim=1)
        v = v.reshape(n, nkv, hd).float().repeat_interleave(nh // nkv, dim=1)
        s = torch.einsum("thd,uhd->htu", q, k) * hd**-0.5
        s = s.masked_fill(~causal, float("-inf")).softmax(-1)
        a = torch.einsum("htu,uhd->thd", s, v).to(h.dtype)
        h = h + tl.linear(a.reshape(n, nh * hd), lp, "wo")
        h = h + tl.mlp(tl.rms_norm(h, lp["mlp_norm"], mc.rms_norm_eps), lp)
    h = tl.rms_norm(h, p["final_norm"], mc.rms_norm_eps)
    return tl.lm_logits(p, h)


def one_row_batch(torch, dev, S, table, tokens, start, decode, kv_len=None):
    """A RaggedBatch whose row 0 holds ``tokens`` at positions start.. in
    the pages of ``table``, the other rows padded as the engine pads them:
    a prefill step's at kv_len 0 past num_seqs, a fused decode step's as
    1-token rows at kv_len 1.  ``kv_len`` overrides row 0's."""
    from dynamo_tpu_torch.models.llama import RaggedBatch

    n = len(tokens)
    T = S if decode else max(16, 1 << (n - 1).bit_length())
    pos = list(range(start, start + n))
    slots = [table[p // PS] * PS + p % PS for p in pos]
    row0 = start + n if kv_len is None else kv_len
    if decode:
        kv_lens, cu, num = [row0] + [1] * (S - 1), list(range(S + 1)), S
    else:
        kv_lens, cu, num = [row0] + [0] * (S - 1), [0] + [n] * S, 1

    def t(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    return RaggedBatch(
        token_ids=t(tokens + [0] * (T - n)),
        positions=t(pos + [0] * (T - n)),
        slot_mapping=t(slots + [-1] * (T - n)),
        kv_lens=t(kv_lens),
        page_indices=t([table] + [[0] * len(table)] * (S - 1)),
        cu_q_lens=t(cu),
        num_seqs=t([num]),
    )


MODEL_CHECK_LAYERS = 4
MODEL_CHECK_TOL = 1e-4


def model_check(torch, dev, cfg):
    """Phase 5: the paged model path in f32 — llama-3.1-8b at full width,
    its first MODEL_CHECK_LAYERS layers, f32 weights (seed 0) and f32
    pages — against the dense reference: a 300-token prompt prefilled in two chunks (the
    second over a 200-token prior prefix), then two fused-decode-shaped
    steps, through both kernels at the serve phase's row count.  Returns
    ok.  The check must not be blind: a run whose row is told one position
    fewer than it has (as a kernel that drops the newest K/V would compute)
    is made too, and must miss the reference by 10x the tolerance."""
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.llama import (
        PagedKVCache, forward_ragged, fuse_projections, init_params,
    )

    mc = get_config("llama-3.1-8b").with_overrides(dtype="float32", num_layers=MODEL_CHECK_LAYERS)
    params = fuse_projections(init_params(mc, 0, dev))
    S, PP = cfg.max_batch, 32
    cache = PagedKVCache.create(mc, 2 * PP, PS, torch.float32, dev)
    table = torch.randperm(2 * PP, generator=torch.Generator().manual_seed(3))[:PP].tolist()
    tokens = torch.randint(1, mc.vocab_size, (302,), generator=torch.Generator().manual_seed(4)).tolist()
    want = reference_logits(torch, params, mc, tokens)

    def run(part, start, decode, kv_len=None):
        rb = one_row_batch(torch, dev, S, table, part, start, decode, kv_len)
        return forward_ragged(params, mc, rb, cache, decode=decode)[0]

    ok = True
    forward_ragged(params, mc, one_row_batch(torch, dev, S, table, tokens[:200], 0, False), cache)
    steps = [
        ("prefill chunk 200..300 over 200", run(tokens[200:300], 200, False), 299),
        ("decode at 300", run(tokens[300:301], 300, True), 300),
        ("decode at 301", run(tokens[301:302], 301, True), 301),
    ]
    for label, got, row in steps:
        w = want[row]
        err = float((got - w).abs().max())
        good = bool(torch.isfinite(got).all()) and got.shape == w.shape and torch.allclose(
            got, w, rtol=MODEL_CHECK_TOL, atol=MODEL_CHECK_TOL)
        ok = ok and good
        log(f"model f32 {MODEL_CHECK_LAYERS} layers, {label}: max_abs_err {err:.3e} "
            f"(logits max |x| {float(w.abs().max()):.3f}) tol {MODEL_CHECK_TOL} "
            f"{'ok' if good else 'FAIL'}")
    # Sensitivity: the last decode step again, its row told one position
    # fewer than it has (the newest K/V left out).
    off = run(tokens[301:302], 301, True, kv_len=301)
    miss = float((off - want[301]).abs().max())
    sensitive = miss > 10 * MODEL_CHECK_TOL
    log(f"model f32 sensitivity: dropping the newest position moves the logits by {miss:.3e} "
        f"({'> 10x tol, ok' if sensitive else 'within 10x tol: the check is blind — FAIL'})")
    del params, cache, want
    torch.cuda.empty_cache()
    return ok and sensitive


SERVE_MAX_TOKENS = 64


def serve_prompts(torch):
    """The serve phases' 8 prompts: 512, 731, ..., 2045 random ids (seed 7)."""
    rng = torch.Generator().manual_seed(7)
    return [torch.randint(1, 128000, (512 + 219 * i,), generator=rng).tolist() for i in range(8)]


async def serve(torch, engine, prompts, max_tokens):
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(p):
        req = PreprocessedRequest(
            token_ids=p,
            stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
        ).to_dict()
        t0 = time.perf_counter()
        stream = await engine.generate(Context(req))
        toks, stamps, finish = [], [], None
        async for item in stream:
            now = time.perf_counter()
            for tok in item["token_ids"]:
                toks.append(tok)
                stamps.append(now - t0)
            finish = item.get("finish_reason") or finish
        return toks, stamps, finish

    return await asyncio.gather(*(one(p) for p in prompts))


def kernel_counts():
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    return {"decode_attention": da.decode_attention_cuda.launches,
            "prefill_attention": pa.prefill_attention_cuda.launches}


def zero_kernel_counts():
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    da.decode_attention_cuda.launches = 0
    pa.prefill_attention_cuda.launches = 0


GRAPH_CHECK_TOL = 1e-3


def graph_check(torch, dev, engine):
    """A captured prefill bucket and the captured fused decode, seeded from
    the host and chained to the device carry, each against the eager call
    on the same inputs, every write dropped (prefill slots -1; decode
    limits at the rows' positions, so no step is writable), with and
    without logprobs.  Tokens must be equal, logprobs within
    GRAPH_CHECK_TOL.  Returns ok."""
    import numpy as np

    from dynamo_tpu_torch.models.llama import RaggedBatch

    cfg = engine.cfg
    S, PP, T_steps = cfg.max_batch, cfg.max_blocks_per_seq, cfg.decode_steps
    rng = np.random.default_rng(11)
    V = engine.model_config.vocab_size
    ok = True

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(label, got, want, lp):
        nonlocal ok
        torch.cuda.synchronize()
        same = bool(torch.equal(got.tokens, want.tokens))
        err = float((got.logprob - want.logprob).abs().max()) if lp else 0.0
        top = float((got.top_logprobs - want.top_logprobs).abs().max()) if lp else 0.0
        good = same and err <= GRAPH_CHECK_TOL and top <= GRAPH_CHECK_TOL
        bitwise = same and (not lp or (torch.equal(got.logprob, want.logprob)
                                       and torch.equal(got.top_logprobs, want.top_logprobs)))
        ok = ok and good
        log(f"graph {label}: tokens equal {same}, logprob max_abs_err {err:.3e}, top-20 "
            f"{top:.3e} (tol {GRAPH_CHECK_TOL}), bitwise {bitwise} {'ok' if good else 'FAIL'}")

    def snap(out):
        return type(out)(*(x.clone() for x in out))

    with torch.inference_mode():
        for lp in (False, True):
            base = engine._sampling_arrays([])
            samp = base._replace(flags=base.flags._replace(need_logprobs=lp))
            sp = engine._samp_params({k: t(v) for k, v in samp.arrays.items()}, samp.flags)
            # Prefill: a 300-token chunk over a 200-token prefix of row 0,
            # in the 512-token bucket; the pages hold the earlier serve's KV.
            n, prior = 300, 200
            T = cfg.bucket_tokens(n)
            tok = np.zeros(T, np.int64)
            tok[:n] = rng.integers(1, V, n)
            pos = np.zeros(T, np.int32)
            pos[:n] = np.arange(prior, prior + n)
            tables = np.zeros((S, PP), np.int32)
            tables[0] = rng.permutation(cfg.num_blocks)[:PP]
            cu = np.zeros(S + 1, np.int32)
            cu[1:] = n
            rb = dict(token_ids=tok, positions=pos, slot_mapping=np.full(T, -1, np.int32),
                      kv_lens=np.asarray([prior + n] + [0] * (S - 1), np.int32),
                      page_indices=tables, cu_q_lens=cu, num_seqs=np.asarray([1], np.int32))
            got = snap(engine._run_step(rb, samp))
            want = engine._step(RaggedBatch(**{k: t(v) for k, v in rb.items()}), sp)
            compare(f"step T={T} need_logprobs={lp} vs eager", got, want, lp)
            # Fused decode over every row, positions 500.., limits at the
            # positions: kv_len stays at the limit and nothing is written.
            pos0 = (500 + 97 * np.arange(S)).astype(np.int32)
            tabs = np.stack([rng.permutation(cfg.num_blocks)[:PP] for _ in range(S)]).astype(np.int32)
            tok0 = rng.integers(1, V, S).astype(np.int64)
            got = snap(engine._run_multi(tok0, pos0, tabs, pos0.copy(), samp))
            want, carry = engine._multi(t(tok0), sp.steps, engine._zero_counts, t(pos0), t(tabs),
                                        t(pos0), sp)
            compare(f"multi seeded need_logprobs={lp} vs eager", got, want, lp)
            pos0b = pos0 + T_steps
            got = snap(engine._run_multi(None, pos0b, tabs, pos0.copy(), samp))
            want, _ = engine._multi(*carry, t(pos0b), t(tabs), t(pos0), sp)
            compare(f"multi chained need_logprobs={lp} vs eager", got, want, lp)
    return ok


def main_path(torch, dev):
    """Phase 6: TorchEngine serving llama-3.1-8b after warmup, the graph
    check and the churn serve, then phase f (edge_path) on the same warm
    engine and phase g (tier_path) on its weights.  Returns (ok, launches,
    edge ok, edge numbers, tiers ok, tier numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = EngineConfig(**SERVE_CFG)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"engine: llama-3.1-8b, {engine.model_config.num_layers} layers, bf16 random "
        f"weights (seed 0), init {time.perf_counter() - t0:.1f} s, "
        f"kernels decode={engine.dispatch_summary()['decode_kernel']} "
        f"prefill={engine.dispatch_summary()['prefill_kernel']}")
    prompts = serve_prompts(torch)
    lens = [len(p) for p in prompts]
    max_tokens = SERVE_MAX_TOKENS
    out = {}

    async def run():
        try:
            t = time.perf_counter()
            out["warm"] = await engine.run_warmup()
            out["warm_s"] = time.perf_counter() - t
            zero_kernel_counts()
            t = time.perf_counter()
            results = await serve(torch, engine, prompts, max_tokens)
            out["wall"] = time.perf_counter() - t
            out["launches"] = kernel_counts()
            out["after"] = engine.compile_counts()
            out["ok"] = report_serve(torch, engine, results, out, lens)
            # Diagnostics on the warm engine, with no request in flight.
            out["ok"] = graph_check(torch, dev, engine) and out["ok"]
            out["ok"] = (await churn_path(torch, engine)) and out["ok"]
            out["ok"] = slice_counters_zero(torch, dev) and out["ok"]
            # Phase f on the same warm engine.
            out["edge_ok"], out["edge"] = await edge_path(torch, engine)
            # Phase g on engines of its own sharing this one's weights.
            out["tiers_ok"], out["tiers"] = await tier_path(torch, engine)
        finally:
            await engine.close()

    asyncio.run(run())
    ok, launches = out["ok"], out["launches"]
    # The served model's output in bf16 at full depth: finite logits of the
    # expected shape, near the dense reference's.  Random weights give a
    # flat top of the vocabulary, so bf16 rounding over 32 layers may swap
    # the top two; the top-2 gap is printed beside the drift.  The f32
    # model check (model_check) is the tight one.
    from dynamo_tpu_torch.models.llama import forward_ragged

    with torch.inference_mode():
        prompt = prompts[0][:100]
        table = list(range(cfg.max_blocks_per_seq))
        rb = one_row_batch(torch, dev, cfg.max_batch, table, prompt, 0, False)
        got = forward_ragged(engine.params, engine.model_config, rb, engine.cache)[0]
        want = reference_logits(torch, engine.params, engine.model_config, prompt)[-1]
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    cos = float(torch.nn.functional.cosine_similarity(got, want, dim=0))
    err = float((got - want).abs().max())
    top2 = want.topk(2).values
    log(f"logits bf16 {engine.model_config.num_layers} layers: shape {tuple(got.shape)} "
        f"finite={finite} cosine vs dense reference {cos:.6f} max_abs_err {err:.4f} "
        f"(reference max |x| {float(want.abs().max()):.3f}, top-2 gap "
        f"{float(top2[0] - top2[1]):.4f}) same argmax {int(got.argmax()) == int(want.argmax())}")
    ok = ok and finite and got.shape == (engine.model_config.vocab_size,) and cos > 0.99
    return ok, launches, out["edge_ok"], out["edge"], out["tiers_ok"], out["tiers"]


def slice_counters_zero(torch, dev):
    """The prefill kernel's self-resetting arrival counters: one scratch a
    stream, shared by every graph captured on that stream.  After the
    serve's, the graph check's and the churn's replays (mixed steps among
    them) every counter must be back at zero.  Returns ok."""
    from dynamo_tpu_torch.ops import prefill_attention as pa

    torch.cuda.synchronize(dev)
    left = [int(cnt.count_nonzero()) for _, _, cnt in pa._slice_scratch.values()]
    ok = bool(left) and not any(left)
    log(f"prefill slice counters after the replays: {len(left)} scratch buffers, "
        f"nonzero counters {left} {'ok' if ok else 'FAIL'}")
    return ok


def report_serve(torch, engine, results, out, lens):
    """Print phase 6's serve line and the warmup line; returns whether
    every stream is whole, both kernels ran and no graph was captured."""
    cfg = engine.cfg
    max_tokens = SERVE_MAX_TOKENS
    launches, wall = out["launches"], out["wall"]
    per_graph = {name: {str(k): v for k, v in getattr(engine.programs, name)
                        .captured_launches().items()} for name in ("step", "multi")}
    log(f"warmup: {out['warm_s']:.2f} s, graphs per entry {out['warm']} (buckets "
        f"{engine.reachable_token_buckets()}); kernel launches a replay, by key {per_graph}")
    ok = out["after"] == out["warm"]
    if not ok:
        log(f"compile counts grew during the serve: {out['warm']} -> {out['after']} — FAIL")
    for i, (toks, stamps, finish) in enumerate(results):
        good = len(toks) == max_tokens and finish == "length"
        ok = ok and good
        if not good:
            log(f"request {i}: {len(toks)} tokens, finish {finish!r} — FAIL")
    ttft = sorted(s[0] for _, s, _ in results)
    itl = [(s[-1] - s[0]) / (len(s) - 1) for _, s, _ in results if len(s) > 1]
    total = sum(len(t) for t, _, _ in results)
    dec, pre = engine.decode_spans, engine.prefill_spans
    step_ms = dec.seconds / max(1, dec.count * cfg.decode_steps) * 1e3
    chunk_ms = pre.seconds / max(1, pre.count) * 1e3
    summ = engine.dispatch_summary()
    kinds = {k: (v["dispatches"], v["p50_ms"]) for k, v in summ["kinds"].items()}
    pipe = {k: v for k, v in summ["pipeline"].items() if k != "last_stall"}
    log(f"serve: 8 requests, prompts {lens[0]}..{lens[-1]} tokens, {max_tokens} new each, "
        f"wall {wall:.3f} s, {total / wall:.2f} output tok/s; TTFT p50 "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms; ITL mean "
        f"{sum(itl) / len(itl) * 1e3:.2f} ms; decode dispatches {dec.count} at "
        f"{step_ms:.2f} ms a fused step, prefill steps {pre.count} at {chunk_ms:.2f} ms "
        f"each (stream time); host_gap_frac {pipe['host_gap_frac']}; pipeline {pipe}; "
        f"dispatch kinds (count, p50 ms) {kinds}; launches {launches} (per replay); "
        f"graphs {out['after']}")
    return ok and all(v > 0 for v in launches.values())


CHURN_REQUESTS = 16


async def churn_path(torch, engine):
    """The churn serve on the warm phase-6 engine: 16 greedy requests at
    max_batch 16, prompts 128..848 tokens; the first 8 (48 or 64 new
    tokens) start together, the back 8 (8, 16 or 24 new tokens) are sent
    once a fused session is live.  Every stream must have its length and
    finish ``length``; the engine must admit and retire inside the loop
    with no rebuild, and capture no graph.  Returns ok."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    rng = torch.Generator().manual_seed(13)
    prompts = [torch.randint(1, 128000, (128 + 48 * i,), generator=rng).tolist()
               for i in range(CHURN_REQUESTS)]
    half = CHURN_REQUESTS // 2
    osl = [48 + 16 * (i % 2) if i < half else 8 + 8 * (i % 3) for i in range(CHURN_REQUESTS)]

    async def one(i):
        if i >= half:
            while not engine._pipeline_members:  # land inside a live session
                await asyncio.sleep(0.001)
        req = PreprocessedRequest(
            token_ids=prompts[i],
            stop_conditions=StopConditions(max_tokens=osl[i], ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
        ).to_dict()
        toks, finish = [], None
        async for item in await engine.generate(Context(req)):
            toks += item["token_ids"]
            finish = item.get("finish_reason") or finish
        return toks, finish

    async def run():
        before = engine.compile_counts()
        engine.reset_dispatch_stats()
        zero_kernel_counts()
        t = time.perf_counter()
        results = await asyncio.gather(*(one(i) for i in range(CHURN_REQUESTS)))
        return results, time.perf_counter() - t, kernel_counts(), before, engine.compile_counts()

    results, wall, launches, before, after = await run()
    pipe = engine.dispatch_summary()["pipeline"]
    ok = all(len(t) == n and f == "length" for (t, f), n in zip(results, osl))
    ok = ok and pipe["continuous_admissions"] >= 1 and pipe["continuous_retired"] >= 1
    ok = ok and pipe["rebuilds"] == 0 and after == before and all(v > 0 for v in launches.values())
    log(f"churn: {CHURN_REQUESTS} requests at max_batch {engine.cfg.max_batch}, prompts "
        f"{len(prompts[0])}..{len(prompts[-1])} tokens, new tokens {osl}, back half sent into a "
        f"live session; wall {wall:.3f} s; lengths {[len(t) for t, _ in results]} finishes "
        f"{sorted(set(f for _, f in results))}; admissions {pipe['continuous_admissions']} retired "
        f"{pipe['continuous_retired']} rebuilds {pipe['rebuilds']} sessions {pipe['sessions']} "
        f"host_gap_frac {pipe['host_gap_frac']}; graphs {before} -> {after}; launches {launches} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


# ------------------------------------------------------------ the HTTP path

HTTP_MODEL = "llama-3.1-8b"
HTTP_ARGV = [
    "run", "in=http", "out=torch", "--arch", "llama-3.1-8b", "--dtype", "bfloat16",
    "--block-size", "16", "--num-blocks", "2048", "--max-batch", "16", "--max-model-len", "4096",
    "--prefill-chunk", "512", "--decode-steps", "8", "--port", "0", "--model", HTTP_MODEL,
]
CHAT_BODY = {
    "model": HTTP_MODEL, "max_tokens": 16, "temperature": 0,
    "messages": [{"role": "user", "content": "Name three colours of the sea."}],
}


class CliServer:
    """``cli._run`` of the port on an event loop in a thread of this
    process, so this process's kernel launch counters see its work.  The
    engine the CLI builds is kept (``engine``) so it can be warmed."""

    def __init__(self, argv, timeout=900):
        from dynamo_tpu_torch import cli

        args = cli.parse_args(argv)
        ready = concurrent.futures.Future()
        self.loop = asyncio.new_event_loop()
        self.engine = None
        build = cli._build_engine

        def keep(out, a):
            engine, level = build(out, a)
            self.engine = engine
            return engine, level

        cli._build_engine = keep

        async def run():
            try:
                await cli._run(args, on_serving=ready.set_result)
            except BaseException as e:
                if not ready.done():
                    ready.set_exception(e)
                raise

        self.task = self.loop.create_task(run())

        def drive():
            try:
                self.loop.run_until_complete(self.task)
            except BaseException:  # the task's outcome is read by stop()
                pass

        self.thread = threading.Thread(target=drive, name="cli-server", daemon=True)
        self.thread.start()
        try:
            self.service = ready.result(timeout=timeout)
        finally:
            cli._build_engine = build

    def warmup(self):
        """The engine's ``run_warmup`` on the server's loop; returns its
        compile counts."""
        return asyncio.run_coroutine_threadsafe(self.engine.run_warmup(), self.loop).result(900)

    def stop(self):
        """Cancel the server (it closes its service and engine) and raise
        whatever else ended it."""
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(120)
        if self.thread.is_alive():
            raise RuntimeError("the HTTP server did not stop")
        self.loop.close()
        if not self.task.cancelled() and self.task.exception() is not None:
            raise self.task.exception()


async def http_call(port, method, path, body=None, headers=None):
    """One HTTP/1.1 request over a fresh connection (standard library
    only), with extra request ``headers``.  Returns (status, headers, body
    bytes, SSE events) with each SSE event stamped on arrival, in seconds
    after the request was sent."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    head = (f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n{extra}"
            f"Content-Type: application/json\r\nContent-Length: {len(payload)}\r\n\r\n")
    t0 = time.perf_counter()
    try:
        writer.write(head.encode() + payload)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        headers = {}
        while True:
            line = (await reader.readline()).decode("latin-1").strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        data, events, pending = b"", [], b""
        if headers.get("transfer-encoding") == "chunked":
            while True:
                size = int((await reader.readline()).strip(), 16)
                if size == 0:
                    await reader.readline()
                    break
                part = await reader.readexactly(size)
                await reader.readexactly(2)
                now = time.perf_counter() - t0
                data += part
                pending += part
                while b"\n\n" in pending:
                    ev, pending = pending.split(b"\n\n", 1)
                    events.append((now, ev.decode()))
        else:
            data = await reader.readexactly(int(headers.get("content-length", "0")))
        return status, headers, data, events
    finally:
        writer.close()
        await writer.wait_closed()


def parse_prometheus(text):
    """Samples of a Prometheus text exposition: {(name, ((label, value), ...)):
    value}.  Raises ValueError on a line that is not a comment or a sample."""
    sample = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = sample.fullmatch(line)
        if m is None:
            raise ValueError(f"not a sample line: {line!r}")
        labels, rest = [], m.group(3) or ""
        while rest:
            lm = label.match(rest)
            if lm is None:
                raise ValueError(f"bad labels in {line!r}")
            labels.append((lm.group(1), lm.group(2)))
            rest = rest[lm.end():]
        out[(m.group(1), tuple(sorted(labels)))] = float(m.group(4))
    return out


def sse_data(events):
    """The JSON chunks of an SSE stream and whether it ended with [DONE];
    raises ValueError on an event that is not a data line of JSON."""
    chunks, done = [], False
    for t, ev in events:
        if not ev.startswith("data: "):
            raise ValueError(f"unexpected SSE event {ev[:80]!r}")
        data = ev[len("data: "):]
        if data == "[DONE]":
            done = True
            continue
        chunks.append((t, json.loads(data)))
    return chunks, done


def http_path(torch):
    """Phase 7: llama-3.1-8b served over HTTP by ``run in=http out=torch``.
    Returns (ok, launches, numbers)."""
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    fails = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"http check FAILED: {what}")

    t0 = time.perf_counter()
    server = CliServer(HTTP_ARGV)
    port = server.service.port
    log(f"http: server up on port {port} in {time.perf_counter() - t0:.1f} s "
        f"({' '.join(HTTP_ARGV)})")
    t0 = time.perf_counter()
    warm = server.warmup()
    log(f"http: engine warmed in {time.perf_counter() - t0:.1f} s, graphs {warm}")
    prompts = serve_prompts(torch)
    out = {}

    async def phase():
        st, _, body, _ = await http_call(port, "GET", "/v1/models")
        check(st == 200 and [m["id"] for m in json.loads(body)["data"]] == [HTTP_MODEL],
              f"/v1/models lists {HTTP_MODEL} ({st} {body[:200]!r})")
        st, _, body, _ = await http_call(port, "GET", "/health")
        check(st == 200, f"/health 200 ({st})")

        async def complete(p):
            return await http_call(port, "POST", "/v1/completions", {
                "model": HTTP_MODEL, "prompt": p, "max_tokens": SERVE_MAX_TOKENS,
                "temperature": 0, "stream": True, "nvext": {"ignore_eos": True}})

        da.decode_attention_cuda.launches = 0
        pa.prefill_attention_cuda.launches = 0
        t = time.perf_counter()
        results = await asyncio.gather(*(complete(p) for p in prompts))
        out["wall"] = time.perf_counter() - t
        ttft, itl, n_chunks = [], [], []
        for i, (st, headers, _, events) in enumerate(results):
            check(st == 200 and headers.get("content-type") == "text/event-stream",
                  f"request {i}: 200 text/event-stream ({st}, {headers.get('content-type')})")
            try:
                chunks, done = sse_data(events)
            except ValueError as e:
                check(False, f"request {i}: every chunk is JSON ({e})")
                continue
            check(done, f"request {i}: stream ends with data: [DONE]")
            final = chunks[-1][1] if chunks else {}
            fin = (final.get("choices") or [{}])[0].get("finish_reason")
            used = (final.get("usage") or {}).get("completion_tokens")
            check(fin == "length" and used == SERVE_MAX_TOKENS,
                  f"request {i}: final chunk length/{SERVE_MAX_TOKENS} (got {fin}/{used})")
            content = [t for t, c in chunks if c["choices"] and c["choices"][0]["text"]]
            if content:
                ttft.append(content[0])
                itl.append((chunks[-1][0] - content[0]) / (SERVE_MAX_TOKENS - 1))
                n_chunks.append(len(content))
                out.setdefault("stamps", []).append((content[0], chunks[-1][0]))
        out.update(ttft=sorted(ttft), itl=itl, chunks=n_chunks)

        # One chat request, alone: first to warm the prompt's prefix cache,
        # then unary and streamed, both over the same cached prefix.
        texts = {}
        for label, stream in (("warm", True), ("unary", False), ("stream", True)):
            st, _, body, events = await http_call(
                port, "POST", "/v1/chat/completions", dict(CHAT_BODY, stream=stream))
            check(st == 200, f"chat {label}: 200 ({st} {body[:200]!r})")
            if st != 200:
                continue
            if stream:
                chunks, done = sse_data(events)
                check(done, f"chat {label}: ends with [DONE]")
                texts[label] = "".join(c["choices"][0]["delta"].get("content") or ""
                                       for _, c in chunks if c["choices"])
            else:
                texts[label] = json.loads(body)["choices"][0]["message"]["content"]
        out["chat"] = texts
        check(texts.get("unary") is not None and texts.get("unary") == texts.get("stream"),
              f"chat unary text == streamed deltas ({texts.get('unary')!r} vs "
              f"{texts.get('stream')!r})")

        st, _, body, _ = await http_call(port, "POST", "/v1/completions",
                                         {"model": "no-such-model", "prompt": [1, 2, 3]})
        err = json.loads(body).get("error", {}) if body else {}
        check(st == 404 and err.get("code") == "model_not_found",
              f"unknown model: 404 model_not_found ({st} {body[:200]!r})")

        st, _, body, _ = await http_call(port, "GET", "/metrics")
        try:
            samples = parse_prometheus(body.decode())
        except ValueError as e:
            check(False, f"/metrics parses as Prometheus text ({e})")
            samples = {}

        def total(name, **want):
            return sum(v for (n, labels), v in samples.items()
                       if n == name and all(dict(labels).get(k) == w for k, w in want.items()))

        ns = "dynamo_tpu_http_service"
        got = total(f"{ns}_requests_total", model=HTTP_MODEL, endpoint="completions",
                    request_type="stream", status="success")
        check(got == len(prompts), f"/metrics counts {len(prompts)} streamed completions ({got})")
        got = total(f"{ns}_requests_total", model=HTTP_MODEL, endpoint="chat_completions",
                    status="success")
        check(got == 3, f"/metrics counts 3 chat requests ({got})")
        got = total(f"{ns}_time_to_first_token_seconds_count", model=HTTP_MODEL)
        check(got >= len(prompts), f"/metrics has {ns}_time_to_first_token_seconds ({got})")
        got = total("dynamo_tpu_engine_dispatch_pipeline_sessions_total")
        check(got >= 1, f"/metrics has the engine's fused sessions ({got})")
        out["host_gap_frac"] = total("dynamo_tpu_engine_dispatch_host_gap_frac")

    try:
        asyncio.run(phase())
    finally:
        launches = {
            "decode_attention": da.decode_attention_cuda.launches,
            "prefill_attention": pa.prefill_attention_cuda.launches,
        }
        server.stop()
    check(all(v > 0 for v in launches.values()), f"both kernels launched ({launches})")
    ttft, itl = out.get("ttft") or [float("nan")], out.get("itl") or [float("nan")]
    total_tokens = len(prompts) * SERVE_MAX_TOKENS
    out.update(ttft_p50_ms=ttft[len(ttft) // 2] * 1e3, ttft_max_ms=ttft[-1] * 1e3,
               itl_mean_ms=sum(itl) / len(itl) * 1e3,
               tok_s=total_tokens / out["wall"] if "wall" in out else float("nan"))
    log(f"http: {len(prompts)} streamed /v1/completions, prompts {len(prompts[0])}.."
        f"{len(prompts[-1])} tokens as ids, {SERVE_MAX_TOKENS} new each, wall "
        f"{out.get('wall', float('nan')):.3f} s, {out['tok_s']:.2f} output tok/s; TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms max {out['ttft_max_ms']:.1f} ms (request sent -> first "
        f"SSE content chunk); ITL mean {out['itl_mean_ms']:.2f} ms (finish chunk - first content "
        f"chunk, over {SERVE_MAX_TOKENS - 1}); SSE content chunks a request "
        f"{out.get('chunks')}; chat unary/stream {out.get('chat', {}).get('unary')!r} / "
        f"{out.get('chat', {}).get('stream')!r} (cold first run "
        f"{out.get('chat', {}).get('warm')!r}); launches {launches}; host_gap_frac "
        f"{out.get('host_gap_frac')} (/metrics); host clock, one call")
    return not fails, launches, out


# ---------------------------------------------- f. the serving edge's overload plane

EDGE_MODEL = "llama-3.1-8b"
EDGE_BURST, EDGE_ISL, EDGE_OSL = 12, 512, 64
EDGE_INFLIGHT, EDGE_QUEUE, EDGE_QUEUE_TIMEOUT_S = 4, 2, 30.0
EDGE_DEADLINE_S, EDGE_DEADLINE_TOKENS = 0.5, 2048
EDGE_TRACED, EDGE_TRACED_ISL, EDGE_TRACED_OSL = 4, 2048, 16
EDGE_TTFT_TOL = 0.10
EDGE_PASSES = ("warm", "none", "all", "all", "none")


def edge_prompts(torch, vocab, lens, seed):
    """Random prompt ids below the vocabulary, one per length (seeded)."""
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(1, min(128000, vocab), (n,), generator=rng).tolist() for n in lens]


class _Recorder:
    """The engine under the HTTP pipeline, recording the token ids each
    request's stream carried, keyed by its request id."""

    def __init__(self, engine):
        self.engine = engine
        self.streams = {}

    async def generate(self, request):
        from dynamo_tpu_torch.runtime.engine import ResponseStream

        stream = await self.engine.generate(request)
        toks = self.streams.setdefault(request.id, [])

        async def gen():
            try:
                async for item in stream:
                    toks.extend(item.get("token_ids") or ())
                    yield item
            finally:
                await stream.aclose()

        return ResponseStream(gen(), request.ctx)


async def edge_path(torch, engine):
    """Phase f: the port's HttpService → preprocessor → backend on the warm
    phase-6 engine, three services on free ports sharing one pipeline:
    admission control, per-request deadlines, QoS quotas with the brownout
    ladder, and request tracing with /traces.  Every check fails the phase.
    Returns (ok, numbers)."""
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.qos import BrownoutConfig, QosConfig, QosController
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.llm.trace_service import TraceAggregator
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline
    from dynamo_tpu_torch.runtime.resilience import metrics as resilience_metrics
    from dynamo_tpu_torch.runtime.tracing import SpanExporter, TraceSampler, TracingConfig

    fails, out = [], {}
    vocab = engine.model_config.vocab_size

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"edge check FAILED: {what}")

    tok = ByteTokenizer()
    recorder = _Recorder(engine)
    pipeline = build_pipeline([OpenAIPreprocessor(tok, EDGE_MODEL), Backend(tok)], recorder)
    aggregator = TraceAggregator()
    exporter = await SpanExporter([aggregator], interval_s=0.05).start()
    qos = QosController(QosConfig(rate=1.0, burst=2.0, brownout=BrownoutConfig()))
    kv_seen = []  # what the ladder read, tick by tick, over the whole phase

    def kv_usage():
        kv_seen.append(engine.metrics().gpu_cache_usage_perc)
        return kv_seen[-1]

    services = {
        "admission": HttpService(host="127.0.0.1", port=0, max_inflight=EDGE_INFLIGHT,
                                 admission_queue=EDGE_QUEUE,
                                 admission_timeout_s=EDGE_QUEUE_TIMEOUT_S),
        "qos": HttpService(host="127.0.0.1", port=0, qos=qos, kv_usage_fn=kv_usage),
        "tracing": HttpService(host="127.0.0.1", port=0, tracing=TraceSampler(TracingConfig()),
                               trace_aggregator=aggregator),
    }
    for svc in services.values():
        svc.models.add_completion_model(EDGE_MODEL, pipeline)
        await svc.start()
    port = {k: svc.port for k, svc in services.items()}

    def completion(prompt, max_tokens, **kw):
        return dict(model=EDGE_MODEL, prompt=prompt, max_tokens=max_tokens, temperature=0,
                    stream=True, nvext={"ignore_eos": True}, **kw)

    def whole(result, max_tokens):
        st, _, _, events = result
        try:
            chunks, done = sse_data(events)
        except ValueError:
            return False
        final = chunks[-1][1] if chunks else {}
        return (st == 200 and done and (final.get("usage") or {}).get("completion_tokens")
                == max_tokens and final["choices"][0].get("finish_reason") == "length")

    def metric(name, **want):
        samples = parse_prometheus(out["metrics_text"])
        return sum(v for (n, labels), v in samples.items()
                   if n == name and all(dict(labels).get(k) == w for k, w in want.items()))

    async def get_trace(tid):
        """/traces/{tid} once the exporter has delivered its edge span."""
        trace = {}
        for _ in range(200):
            await exporter.flush()
            st, _, body, _ = await http_call(port["tracing"], "GET", f"/traces/{tid}")
            trace = json.loads(body) if st == 200 else {}
            if any(s["name"] == "edge.request" for s in trace.get("spans", ())):
                break
            await asyncio.sleep(0.01)
        return trace

    t_phase = time.perf_counter()
    zero_kernel_counts()
    try:
        # Admission: 4 in flight, 2 queued, the other 6 shed with 429.
        shed0 = resilience_metrics.admission_shed.get("429", 0)
        burst = edge_prompts(torch, vocab, [EDGE_ISL] * EDGE_BURST, 9001)
        t = time.perf_counter()
        results = await asyncio.gather(*(
            http_call(port["admission"], "POST", "/v1/completions", completion(p, EDGE_OSL))
            for p in burst))
        out["burst_wall_s"] = time.perf_counter() - t
        served = [r for r in results if whole(r, EDGE_OSL)]
        shed = [r for r in results if r[0] == 429 and r[1].get("retry-after")
                and b"admission queue full" in r[2]]
        check(len(served) == EDGE_INFLIGHT + EDGE_QUEUE and len(shed) == EDGE_BURST - len(served),
              f"admission: {EDGE_INFLIGHT + EDGE_QUEUE} whole streams and "
              f"{EDGE_BURST - EDGE_INFLIGHT - EDGE_QUEUE} 429s with Retry-After "
              f"(statuses {sorted(r[0] for r in results)}, whole {len(served)})")
        out["metrics_text"] = (await http_call(port["admission"], "GET", "/metrics"))[2].decode()
        counted = metric("dynamo_tpu_resilience_admission_shed_total", status="429") - shed0
        check(counted == len(shed), f"/metrics admission_shed_total{{status=\"429\"}} counts "
                                    f"{len(shed)} ({counted})")
        out["admission"] = {"statuses": sorted(r[0] for r in results), "whole": len(served),
                            "retry_after": sorted({r[1].get("retry-after") for r in shed}),
                            "counted": counted}

        # Deadlines: a long traced stream cut at 0.5 s ends in the SSE 504
        # event.  No fused dispatch takes its row once the deadline has
        # passed (its trace's decode-chunk spans all start before) and none
        # runs at all after the event.  The row leaves once the dispatches
        # already in flight have landed (its KV blocks are held until then:
        # the pipeline's write barrier): they land within pipeline_depth
        # dispatch periods (an event recorded behind them on the stream),
        # and the row is gone within half a period after, before another
        # dispatch could have run.  The period is read off this stream: one
        # SSE chunk a fused dispatch, the longest gap between two of its
        # chunks after the first.
        (prompt,) = edge_prompts(torch, vocab, [EDGE_ISL], 9002)
        d_start = engine.decode_spans.count
        st, headers, _, events = await http_call(
            port["tracing"], "POST", "/v1/completions", completion(prompt, EDGE_DEADLINE_TOKENS),
            headers={"x-deadline-s": str(EDGE_DEADLINE_S), "x-request-id": "deadline",
                     "x-trace": "1"})
        t_end, d_end = time.perf_counter(), engine.decode_spans.count
        # The engine's dispatches replay on the default stream; on the CPU
        # (a rehearsal) they have run when they return.
        landed = torch.cuda.Event() if engine.device.type == "cuda" else None
        if landed is not None:
            landed.record()
        t_landed = None
        sched = engine.scheduler
        while True:  # landing is read first: one poll may see both
            now = time.perf_counter()
            if t_landed is None and (landed is None or landed.query()):
                t_landed = now
            if not (sched.num_running or sched.num_waiting) or now - t_end >= 10:
                break
            await asyncio.sleep(0.001)
        t_left = time.perf_counter()
        if t_landed is None:  # the row left first: the check below fails
            if landed is not None:
                landed.synchronize()
            t_landed = time.perf_counter()
        left_ms, landed_ms = (t_left - t_end) * 1e3, (t_landed - t_end) * 1e3
        extra = engine.decode_spans.count - d_end
        last = events[-1][1].split("\n") if events else []
        err = json.loads(last[1][len("data: "):]) if len(last) == 2 else None
        check(st == 200 and last[:1] == ["event: error"]
              and err == {"error": "deadline exceeded", "code": 504},
              f"deadline: the stream ends in the SSE 504 event ({st}, {last})")
        spans = (await get_trace(headers.get("x-trace-id"))).get("spans", [])
        root = next((s["start_ms"] for s in spans if s["name"] == "edge.request"), None)
        chunks_ms = [s["start_ms"] - root for s in spans
                     if s["name"] == "engine.decode_chunk" and root is not None]
        late = [c for c in chunks_ms if c >= EDGE_DEADLINE_S * 1e3]
        data_t = [t for t, ev in events if ev.startswith("data: ")]
        gaps_ms = [(b - a) * 1e3 for a, b in zip(data_t[1:], data_t[2:])]
        period_ms = max(gaps_ms) if gaps_ms else float("nan")
        depth = engine.cfg.pipeline_depth
        check(len(chunks_ms) >= 2 and not late,
              f"deadline: no fused dispatch takes the row after its deadline (decode chunks "
              f"at {[round(c, 1) for c in chunks_ms]} ms after the request)")
        check(len(gaps_ms) >= 2 and not sched.num_running and not sched.num_waiting
              and extra == 0 and landed_ms <= depth * period_ms
              and 0 <= left_ms - landed_ms <= period_ms / 2 and engine.kv.active_blocks == 0,
              f"deadline: no fused dispatch after the 504 event, the dispatches in flight "
              f"landed within pipeline_depth {depth} periods of {period_ms:.1f} ms and the "
              f"row gone within half a period after ({extra} dispatches, landed "
              f"{landed_ms:.1f} ms, gone {left_ms:.1f} ms, running {sched.num_running}, "
              f"active blocks {engine.kv.active_blocks})")
        tokens = sum(len(v) for k, v in recorder.streams.items() if k.startswith("deadline-"))
        out["deadline"] = {"events": len(events), "dispatches": d_end - d_start,
                           "tokens": tokens, "decode_chunks_ms": [round(c, 3) for c in chunks_ms],
                           "chunk_gaps_ms": [round(g, 3) for g in gaps_ms],
                           "extra_dispatches": extra, "landed_after_ms": landed_ms,
                           "empty_after_ms": left_ms, "bound_ms": depth * period_ms}

        # QoS: rate 1, burst 2 under one tenant; the ladder ticks off the
        # engine's live KV usage.
        short = edge_prompts(torch, vocab, [16], 9003)[0]
        quota = []
        for _ in range(3):
            quota.append(await http_call(port["qos"], "POST", "/v1/completions",
                                         dict(model=EDGE_MODEL, prompt=short, max_tokens=1),
                                         headers={"x-tenant": "edge-qos"}))
        check([r[0] for r in quota] == [200, 200, 429] and quota[2][1].get("retry-after")
              and b"over its request quota" in quota[2][2],
              f"qos: 200, 200, 429 quota with Retry-After ({[r[0] for r in quota]} "
              f"{quota[2][2][:120]!r})")
        ticks0 = qos.ladder.tick_count
        rungs = [services["qos"].qos_tick() for _ in range(3)]
        health = json.loads((await http_call(port["qos"], "GET", "/health"))[2])
        check(rungs == [0, 0, 0] and qos.ladder.tick_count >= ticks0 + 3
              and len(kv_seen) == qos.ladder.tick_count
              and health.get("brownout", {}).get("rung") == 0,
              f"qos: the ladder ticks off the live KV usage ({rungs}, {len(kv_seen)} reads, "
              f"{health.get('brownout')})")
        out["metrics_text"] = (await http_call(port["qos"], "GET", "/metrics"))[2].decode()
        check(metric("dynamo_tpu_qos_quota_shed_total") >= 1, "qos: /metrics counts the quota shed")
        out["qos"] = {"statuses": [r[0] for r in quota], "retry_after": quota[2][1].get("retry-after"),
                      "kv_usage_max": max(kv_seen), "ticks": qos.ladder.tick_count,
                      "rung": qos.ladder.rung}

        # Tracing: 4 traced requests of 2048 ids; each asks for logprobs, so
        # the chunk of its first token reaches the client even where the
        # byte tokenizer holds the text back.  Warmed first untraced.
        def traced_body(p):
            return completion(p, EDGE_TRACED_OSL, logprobs=1)

        for seed, headers in ((9004, None), (9005, {"x-trace": "1"})):
            prompts = edge_prompts(torch, vocab, [EDGE_TRACED_ISL] * EDGE_TRACED, seed)
            traced = await asyncio.gather(*(
                http_call(port["tracing"], "POST", "/v1/completions", traced_body(p),
                          headers=headers) for p in prompts))
        out["traces"] = []
        for st, headers, _, events in traced:
            tid = headers.get("x-trace-id")
            check(st == 200 and tid and whole((st, headers, None, events), EDGE_TRACED_OSL),
                  f"tracing: a whole traced stream with x-trace-id ({st}, {tid})")
            if not tid:
                continue
            client_ttft_ms = events[0][0] * 1e3
            trace = await get_trace(tid)
            spans = trace.get("spans", [])
            names = [s["name"] for s in spans]
            order = ["edge.request", "edge.admission_wait", "edge.preprocess",
                     "engine.queue_wait", "engine.prefill"]
            starts = [next((s["start_ms"] for s in spans if s["name"] == n), None) for n in order]
            prefill = next((s for s in spans if s["name"] == "engine.prefill"), {})
            rollup = trace.get("rollup", {})
            terms = sum(rollup.get("hops", {}).values()) + rollup.get("unattributed_ms", 0.0)
            check(None not in starts and starts == sorted(starts)
                  and any(e["name"] == "first_token" for e in prefill.get("events", ()))
                  and names.count("engine.decode_chunk") >= 1,
                  f"tracing: /traces/{tid} holds the edge, preprocess, queue-wait, prefill "
                  f"(first_token) and decode-chunk spans in order ({names})")
            check(abs(terms - client_ttft_ms) <= EDGE_TTFT_TOL * client_ttft_ms,
                  f"tracing: ttft_decomposition's terms {terms:.3f} ms within "
                  f"{EDGE_TTFT_TOL:.0%} of the client's TTFT {client_ttft_ms:.3f} ms")
            out["traces"].append({"client_ttft_ms": round(client_ttft_ms, 3),
                                  "terms_ms": round(terms, 3), "rollup": rollup,
                                  "decode_chunks": names.count("engine.decode_chunk"),
                                  "spans": len(spans)})

        # Tracing on and off: 8 greedy requests a pass, identical streams, no
        # graph captured.  The first pass, concurrent, only fills the prefix
        # cache; the measured passes send one request at a time, so every
        # pass runs the same steps: a position's logits on the card depend on
        # the rows that share its step (GEMM kernels are chosen by row
        # count), and a random model's flat top tokens follow them.
        prompts = edge_prompts(torch, vocab, [512 + 219 * i for i in range(8)], 9006)
        passes, graphs0 = [], None
        for p_i, mode in enumerate(EDGE_PASSES):
            if p_i == 1:
                graphs0 = dict(engine.compile_counts())
            headers = {"x-trace": "1"} if mode == "all" else {}
            calls = [http_call(port["tracing"], "POST", "/v1/completions",
                               completion(p, EDGE_OSL),
                               headers=dict(headers, **{"x-request-id": f"p{p_i}r{i}"}))
                     for i, p in enumerate(prompts)]
            if mode == "warm":
                await asyncio.gather(*calls)
                continue
            results = [await c for c in calls]
            ttft, itl = [], []
            for st, headers_, _, events in results:
                check(whole((st, headers_, None, events), EDGE_OSL)
                      and ("x-trace-id" in headers_) == (mode == "all"),
                      f"tracing {mode}: a whole stream, x-trace-id only when traced ({st})")
                chunks, _ = sse_data(events)
                ttft.append(chunks[0][0])
                itl.append((chunks[-1][0] - chunks[0][0]) / (EDGE_OSL - 1))
            streams = [recorder.streams[k] for i in range(len(prompts)) for k in recorder.streams
                       if k.startswith(f"p{p_i}r{i}-")]
            passes.append({"mode": mode, "streams": streams,
                           "ttft_p50_ms": statistics.median(ttft) * 1e3,
                           "itl_p50_ms": statistics.median(itl) * 1e3})
        graphs1 = dict(engine.compile_counts())
        same = all(p["streams"] == passes[0]["streams"] for p in passes)
        differ = [sum(a != b for a, b in zip(p["streams"], passes[0]["streams"]))
                  for p in passes]
        check(same and all(len(s) == EDGE_OSL for s in passes[0]["streams"])
              and len(passes[0]["streams"]) == len(prompts),
              f"tracing on/off: identical greedy streams in every pass (streams differing "
              f"from the first measured pass, by pass: {differ})")
        check(graphs1 == graphs0, f"tracing on/off: no graph captured ({graphs0} -> {graphs1})")
        out["passes"] = [{k: v for k, v in p.items() if k != "streams"} for p in passes]
    finally:
        out["launches"] = kernel_counts()
        await exporter.stop(final_flush=False)
        await aggregator.stop()
        for svc in services.values():
            await svc.close()
    out["wall_s"] = time.perf_counter() - t_phase
    check(all(v > 0 for v in out["launches"].values()), f"edge: both kernels launched "
                                                        f"({out['launches']})")
    med = {mode: [p for p in out.get("passes", []) if p["mode"] == mode]
           for mode in ("none", "all")}
    log(f"edge (phase f, card {CARD}): admission {out.get('admission')}; deadline "
        f"{out.get('deadline')}; qos {out.get('qos')}; traces {out.get('traces')}")
    log(f"edge tracing overhead (card {CARD}; 8 greedy streams of {EDGE_OSL} a pass, one at a "
        f"time, prompts 512..2045, prefix-cached; client clock, one call): " + "; ".join(
            f"{mode} TTFT p50 {[round(p['ttft_p50_ms'], 3) for p in ps]} ms ITL p50 "
            f"{[round(p['itl_p50_ms'], 3) for p in ps]} ms" for mode, ps in med.items())
        + f"; phase wall {out['wall_s']:.2f} s; launches {out['launches']} "
        f"{'ok' if not fails else 'FAIL: ' + '; '.join(fails)}")
    return not fails, out


# ------------------------------------------------------- phase g: KV tiers

# Phase 6's geometry on a 512-page pool (1 GiB at llama-3.1-8b: a 16-token
# page is 2 MiB over 32 layers) with the three tiers below it.
TIER_CFG = dict(SERVE_CFG, num_blocks=512, host_cache_bytes=1024 << 20,
                disk_cache_bytes=1024 << 20, object_store_bytes=2048 << 20)
TIER_PROMPTS, TIER_LEN, TIER_NEW = 12, 2056, 16  # 128 full blocks + 8 ids each
TIER_CHECK_BLOCK = 100  # the block whose pages are held bitwise across restores
PUMP_TURNS = ("on", "off", "off", "on", "on", "off")


def tier_prompts(torch, n, seed):
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(1, 128000, (TIER_LEN,), generator=rng).tolist() for _ in range(n)]


async def drain_offload(engine):
    """The explicit drains of phase g: until the offload queue is empty."""
    while engine._offload_queue:
        await engine.drain_offload()


async def block_pages(engine, seq_hash):
    """A sealed block's pages [L, ps, 2KV, D] read back to the host by the
    harness (a stream-ordered copy under the device lock), or None."""
    async with engine._device_lock:
        bid = engine.kv._by_hash.get(seq_hash)
        return None if bid is None else engine.cache.pages[:, bid].to("cpu", copy=True)


class TierTimers:
    """Host wall of the tier work inside a restore, by part, from wrappers
    around the engine's methods (phase g's breakdown; the parts nest:
    ``promote`` holds the reads and the demotion cascade its host-tier
    puts set off)."""

    PARTS = ("promote", "disk_read", "objstore_read", "demote_to_disk", "demote_to_objstore",
             "host_verify", "upload_enqueue", "scatter_enqueue")

    def __init__(self, engine):
        from dynamo_tpu_torch.engine import offload

        self.ms = dict.fromkeys(self.PARTS, 0.0)
        self._undo = []

        def wrap(obj, attr, part):
            fn = getattr(obj, attr)

            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.ms[part] += (time.perf_counter() - t0) * 1e3

            setattr(obj, attr, timed)
            self._undo.append((obj, attr, fn))

        wrap(engine, "_promote_blocks", "promote")
        wrap(engine.disk_kv, "read", "disk_read")
        wrap(engine.object_kv, "read", "objstore_read")
        wrap(engine.host_kv, "on_evict", "demote_to_disk")
        wrap(engine.disk_kv, "on_evict", "demote_to_objstore")
        wrap(offload, "block_checksums", "host_verify")
        wrap(engine, "_restore_upload", "upload_enqueue")
        wrap(engine, "_restore_scatter", "scatter_enqueue")

    def take(self):
        out, self.ms = self.ms, dict.fromkeys(self.PARTS, 0.0)
        return {k: round(v, 3) for k, v in out.items()}

    def close(self):
        for obj, attr, fn in reversed(self._undo):
            setattr(obj, attr, fn)


async def tier_path(torch, phase6):
    """Phase g: the KV memory tiers at llama-3.1-8b with phase 6's weights.
    12 prompts of 2056 ids (16 new tokens each) one at a time, the offload
    queue drained after each: 1536 blocks, three times the device pool, so
    blocks demote host → disk → object store.  Then re-serves whose first
    block sits on disk under a ``kv_corrupt`` fault (quarantined,
    recomputed), in host, on disk and in the object store (restored ahead of
    admission), a scale-from-zero engine on the same object store, and the
    write-behind pump's cost on phase 6's 8 concurrent requests, host tier
    on and off in turns (not gated).  Returns (ok, numbers)."""
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm import metrics as tm
    from dynamo_tpu_torch.runtime.faultinject import faults
    from dynamo_tpu_torch.tokens import hash_token_blocks

    fails, out = [], {"rows": []}
    dev, params = phase6.device, phase6.params

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"tiers check FAILED: {what}")

    root = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    def new_engine(disk_dir, **over):
        cfg = dict(TIER_CFG, host_offload_interval=3600.0,  # drained explicitly
                   disk_cache_dir=os.path.join(root, disk_dir),
                   object_store_dir=os.path.join(root, "objects"))
        cfg.update(over)
        return TorchEngine(EngineConfig(**cfg), params=params, device=dev)

    prompts = tier_prompts(torch, TIER_PROMPTS, 17)
    chains = [[tb.sequence_hash for tb in hash_token_blocks(p, PS)] for p in prompts]
    n_blocks = TIER_LEN // PS
    first, saved = [], []
    t_phase = time.perf_counter()
    engine = new_engine("disk")
    try:
        t = time.perf_counter()
        graphs0 = await engine.run_warmup()
        out["warm_s"] = time.perf_counter() - t
        for m in (tm.kv_tier_metrics, tm.kv_integrity_metrics, tm.objstore_metrics):
            m.reset()
        zero_kernel_counts()
        torch.cuda.synchronize = counting_sync
        t = time.perf_counter()
        for i, p in enumerate(prompts):
            toks, stamps, finish = (await serve(torch, engine, [p], TIER_NEW))[0]
            check(len(toks) == TIER_NEW and finish == "length", f"fill {i}: {len(toks)} tokens")
            first.append((toks, stamps[0]))
            saved.append(await block_pages(engine, chains[i][TIER_CHECK_BLOCK]))
            await drain_offload(engine)
        out["fill_s"] = time.perf_counter() - t
        out["fill_copies"] = engine.copy_summary()
        tiers = [engine._tier_of(c[0]) for c in chains]
        out["tiers_after_fill"] = tiers
        out["summary_after_fill"] = {k: v for k, v in engine.kv_tier_summary().items()
                                     if k != "prefix_hit_rate"}
        check("objstore" in tiers and "disk" in tiers and "host" in tiers,
              f"fill: first blocks in host, disk and object store ({tiers})")
        used = set()
        timers = TierTimers(engine)

        def pick(tier):
            """The most recent unused prompt whose first block is in ``tier``,
            one with its whole prefix there first."""
            cands = [i for i in reversed(range(TIER_PROMPTS))
                     if i not in used and engine._tier_of(chains[i][0]) == tier]
            whole = [i for i in cands if all(engine._tier_of(h) == tier for h in chains[i][:n_blocks])]
            return (whole or cands or [None])[0]

        async def reserve(label, i):
            """Re-serve prompt ``i`` alone, its chain off the device first, and
            hold it against the first pass."""
            used.add(i)
            engine.kv.evict_hashes(chains[i])
            r0, m0 = engine.host_kv.restored_blocks, tm.kv_tier_metrics.restored_blocks_total
            c0 = engine.copy_summary()
            timers.take()
            toks, stamps, _ = (await serve(torch, engine, [prompts[i]], TIER_NEW))[0]
            parts = timers.take()
            c1 = engine.copy_summary()
            restored = engine.host_kv.restored_blocks - r0
            scraped = parse_prometheus(tm.kv_tier_metrics.render())
            metric = scraped[("dynamo_tpu_kv_tier_restored_blocks_total", ())] - m0
            pages = await block_pages(engine, chains[i][TIER_CHECK_BLOCK])
            await drain_offload(engine)
            row = {"label": label, "prompt": i, "restored": restored, "metric": metric,
                   "counter": tm.kv_tier_metrics.restored_blocks_total - m0,
                   "ttft_ms": stamps[0] * 1e3, "first_ttft_ms": first[i][1] * 1e3,
                   "identical": toks == first[i][0],
                   "bitwise": pages is not None and torch.equal(pages, saved[i]),
                   "h2d_bytes": c1["h2d_bytes"] - c0["h2d_bytes"],
                   "h2d_ms": c1["h2d_ms"] - c0["h2d_ms"], "parts_ms": parts}
            out["rows"].append(row)
            check(row["identical"], f"{label}: stream identical to the first pass")
            check(row["bitwise"] or not restored,  # a recompute is reported, not held
                  f"{label}: block {TIER_CHECK_BLOCK}'s restored pages bitwise equal to the "
                  f"first prefill's")
            check(restored == row["counter"] == metric,
                  f"{label}: restored blocks {restored} = counter {row['counter']} = /metrics "
                  f"{metric}")
            return row

        # A kv_corrupt fault on one disk file: quarantined, recomputed.
        i = pick("disk")
        check(i is not None, "a prompt whose first block is on disk")
        if i is not None:
            integ = tm.kv_integrity_metrics
            c0, r0 = integ.corrupt_total["disk"], integ.recomputed_total
            faults.arm("kv_corrupt", match="disk", count=1)
            try:
                row = await reserve("disk, kv_corrupt", i)
            finally:
                faults.reset()
            check(row["restored"] == 0, f"disk fault: nothing restored ({row['restored']})")
            check(integ.corrupt_total["disk"] == c0 + 1 and integ.recomputed_total == r0 + 1,
                  f"disk fault: one disk corruption, one recompute ({integ.snapshot()})")
            check(engine.integrity.banned(chains[i][0]) and not engine.disk_kv.contains(chains[i][0]),
                  "disk fault: the block quarantined (negative-cached, file gone)")
        for tier in ("host", "disk", "objstore"):
            i = pick(tier)
            check(i is not None, f"a prompt whose first block is in {tier}")
            if i is None:
                continue
            row = await reserve(tier, i)
            check(row["restored"] == n_blocks, f"{tier}: {row['restored']} of {n_blocks} restored")
            if tier == "host":
                check(row["ttft_ms"] < row["first_ttft_ms"],
                      f"host restore TTFT {row['ttft_ms']:.1f} ms below the first pass's "
                      f"{row['first_ttft_ms']:.1f} ms")
        timers.close()
        out["graphs"] = (graphs0, engine.compile_counts())
        check(engine.compile_counts() == graphs0, f"no graph captured ({out['graphs']})")
        out["copies"] = engine.copy_summary()
        out["integrity"] = tm.kv_integrity_metrics.snapshot()
        out["objstore"] = tm.objstore_metrics.snapshot()
        out["tier_counters"] = {k: v for k, v in tm.kv_tier_metrics.snapshot().items()
                                if k.endswith("_total") and "pull" not in k}
        # Scale from zero: a fresh engine, empty device, host and disk, on
        # the same object store.
        whole = [i for i in range(TIER_PROMPTS) if i not in used
                 and all(engine.object_kv.contains(h) for h in chains[i][:n_blocks])]
        s0 = whole[0] if whole else None
        check(s0 is not None, "a prompt whose whole prefix is in the object store")
        torch.cuda.synchronize = real_sync
        await engine.close()
        engine = None
        if s0 is not None:
            fresh = new_engine("disk2")
            try:
                g0 = await fresh.run_warmup()
                timers = TierTimers(fresh)
                check(len(fresh.host_kv) == len(fresh.disk_kv) == 0
                      and len(fresh.object_kv) > 0, "scale from zero: only the object store holds blocks")
                torch.cuda.synchronize = counting_sync
                toks, stamps, _ = (await serve(torch, fresh, [prompts[s0]], TIER_NEW))[0]
                pages = await block_pages(fresh, chains[s0][TIER_CHECK_BLOCK])
                torch.cuda.synchronize = real_sync
                timers.close()
                row = {"label": "scale from zero", "prompt": s0,
                       "restored": fresh.host_kv.restored_blocks,
                       "ttft_ms": stamps[0] * 1e3, "first_ttft_ms": first[s0][1] * 1e3,
                       "identical": toks == first[s0][0],
                       "bitwise": pages is not None and torch.equal(pages, saved[s0]),
                       "h2d_bytes": fresh.copy_summary()["h2d_bytes"],
                       "h2d_ms": fresh.copy_summary()["h2d_ms"], "parts_ms": timers.take()}
                out["rows"].append(row)
                check(row["identical"], "scale from zero: stream identical to the first pass")
                check(row["bitwise"], "scale from zero: restored pages bitwise equal")
                check(row["restored"] == n_blocks, f"scale from zero: {row['restored']} restored")
                check(fresh.compile_counts() == g0, "scale from zero: no graph captured")
            finally:
                torch.cuda.synchronize = real_sync
                await fresh.close()
        out["launches"] = kernel_counts()
        out["syncs"] = syncs[0]
        check(syncs[0] == 0, f"no torch.cuda.synchronize() while serving ({syncs[0]} calls)")
        check(all(v > 0 for v in out["launches"].values()), f"tiers: both kernels launched "
                                                            f"({out['launches']})")
        out["pump"] = await pump_ab(torch, dev, params)
    finally:
        torch.cuda.synchronize = real_sync
        if engine is not None:
            await engine.close()
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    gib = 1 << 30
    log(f"tiers (phase g, card {CARD}): warmup {out['warm_s']:.2f} s; fill 12 x {TIER_LEN} ids "
        f"{out.get('fill_s', 0):.2f} s, first blocks by tier {out.get('tiers_after_fill')}, "
        f"tiers {out.get('summary_after_fill')}; fill copies {out.get('fill_copies')}")
    for r in out["rows"]:
        h2d = r["h2d_bytes"] / gib / (r["h2d_ms"] / 1e3) if r["h2d_ms"] else 0.0
        log(f"tiers restore [{r['label']}] prompt {r['prompt']}: restored {r['restored']} blocks, "
            f"TTFT {r['ttft_ms']:.1f} ms vs first pass {r['first_ttft_ms']:.1f} ms, identical "
            f"{r['identical']}, bitwise {r['bitwise']}, host->device {r['h2d_bytes']} B in "
            f"{r['h2d_ms']:.3f} ms stream time ({h2d:.2f} GiB/s); host wall by part (ms, "
            f"nested) {r['parts_ms']}")
    log(f"tiers totals: copies {out.get('copies')}; tier counters {out.get('tier_counters')}; "
        f"integrity {out.get('integrity')}; objstore {out.get('objstore')}; graphs "
        f"{out.get('graphs')}; torch.cuda.synchronize calls while serving {out.get('syncs')}; "
        f"launches {out.get('launches')}; phase wall {out['wall_s']:.2f} s "
        f"{'ok' if not fails else 'FAIL: ' + '; '.join(fails)}")
    return not fails, out


async def pump_ab(torch, dev, params):
    """Phase g step 4: phase 6's 8 concurrent greedy requests (64 new
    tokens) on a host-tier engine (the write-behind pump at its default
    interval) and on one without tiers, in turns; fresh prompts of phase
    6's lengths each pair.  Not gated.  Returns the turns."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    engines = {
        "on": TorchEngine(EngineConfig(**dict(SERVE_CFG, num_blocks=512,
                                              host_cache_bytes=1024 << 20)), params=params, device=dev),
        "off": TorchEngine(EngineConfig(**dict(SERVE_CFG, num_blocks=512)), params=params, device=dev),
    }
    turns = []
    try:
        for e in engines.values():
            await e.run_warmup()
        for k, mode in enumerate(PUMP_TURNS):
            rng = torch.Generator().manual_seed(1000 + k // 2)
            prompts = [torch.randint(1, 128000, (512 + 219 * i,), generator=rng).tolist()
                       for i in range(8)]
            t0 = time.perf_counter()
            results = await serve(torch, engines[mode], prompts, SERVE_MAX_TOKENS)
            wall = time.perf_counter() - t0
            ttft = [s[0] for _, s, _ in results]
            itl = [(s[-1] - s[0]) / (len(s) - 1) for _, s, _ in results if len(s) > 1]
            turns.append({"mode": mode, "ttft_p50_ms": statistics.median(ttft) * 1e3,
                          "itl_mean_ms": statistics.fmean(itl) * 1e3, "wall_s": wall,
                          "host_blocks": len(engines[mode].host_kv or ())})
    finally:
        for e in engines.values():
            await e.close()
    for mode in ("on", "off"):
        ts = [t for t in turns if t["mode"] == mode]
        log(f"tiers pump cost (card {CARD}), host tier {mode}: TTFT p50 "
            f"{[round(t['ttft_p50_ms'], 3) for t in ts]} ms, ITL mean "
            f"{[round(t['itl_mean_ms'], 3) for t in ts]} ms, wall "
            f"{[round(t['wall_s'], 3) for t in ts]} s, host blocks "
            f"{[t['host_blocks'] for t in ts]}")
    return turns


# ------------------------------------------------ direct vs HTTP, in turns


def direct_stamps(torch, dev):
    """One direct serve of the 8 prompts on a fresh, warmed engine, read where the
    HTTP client reads: per request (first text, last token) in seconds,
    the first text being the token at which the byte tokenizer's
    detokenizer first releases text (it holds U+FFFD back up to 4 ids).
    Returns (wall s, stamps, first-token seconds)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    engine = TorchEngine(EngineConfig(**SERVE_CFG), device=dev)

    async def run():
        try:
            await engine.run_warmup()  # as the HTTP phase's engine is warmed
            t0 = time.perf_counter()
            results = await serve(torch, engine, serve_prompts(torch), SERVE_MAX_TOKENS)
            return results, time.perf_counter() - t0
        finally:
            await engine.close()

    results, wall = asyncio.run(run())
    stamps, first_token = [], []
    for toks, times, _ in results:
        ds = ByteTokenizer().decode_stream()
        first_text = next((i for i, t in enumerate(toks) if ds.step(t)), len(toks) - 1)
        stamps.append((times[first_text], times[-1]))
        first_token.append(times[0])
    return wall, stamps, first_token


def serve_ab(torch, dev):
    """``--serve-ab``: the direct serve and the HTTP serve in turns in one
    process — a cold direct serve first (discarded), then direct, HTTP,
    HTTP, direct — each read at the client's points: first text, ITL
    (last − first text) / (tokens − 1), and the request's end."""
    def summary(label, wall, stamps, extra=""):
        first = sorted(a for a, _ in stamps)
        done = sorted(b for _, b in stamps)
        itl = [(b - a) / (SERVE_MAX_TOKENS - 1) for a, b in stamps]
        log(f"ab {label}: wall {wall:.3f} s, {len(stamps) * SERVE_MAX_TOKENS / wall:.2f} tok/s; "
            f"first text p50 {first[len(first) // 2] * 1e3:.1f} max {first[-1] * 1e3:.1f} ms; "
            f"ITL mean {sum(itl) / len(itl) * 1e3:.2f} ms; end p50 "
            f"{done[len(done) // 2] * 1e3:.1f} max {done[-1] * 1e3:.1f} ms{extra}")

    direct_stamps(torch, dev)  # warm-up
    ok = True
    for label in ("direct", "http", "http", "direct"):
        gc.collect()
        torch.cuda.empty_cache()
        if label == "direct":
            wall, stamps, first_token = direct_stamps(torch, dev)
            ft = sorted(first_token)
            summary(label, wall, stamps, f"; first token p50 {ft[len(ft) // 2] * 1e3:.1f} "
                    f"max {ft[-1] * 1e3:.1f} ms")
        else:
            good, _, out = http_path(torch)
            ok = ok and good
            summary(label, out["wall"], out.get("stamps", []))
    return ok


# -------------------------------------------- W8A8, int8 KV, speculation

INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
# llama-3.1-8b's projections as the engine runs them (fused q|k|v and
# gate|up): (leaf, K, N).  gate|up and the head write f32, the rest bf16.
PROJECTIONS = [("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gateup", 4096, 28672),
               ("w_down", 14336, 4096), ("lm_head", 4096, 128256)]
F32_OUT = ("w_gateup", "lm_head")
GEMM_ROWS = (16, 256, 2048)
# qdot's error bars (phase a): per entry, standard deviations of the
# activations' rounding (the largest of the ~4e8 entries lies near 6); and
# the largest error's share of the largest |x @ dequant(w)|.
QDOT_SIGMAS = 8.0
QDOT_MAX_SHARE = 0.015


def w8a8_ops(torch, dev):
    """Phase a: ``qdot`` at each projection shape of llama-3.1-8b and M =
    16, 256 and 2048 rows, bf16 activations.  Its int32 accumulation must
    equal an exact integer reference of the same codes (f64 products,
    exact below 2^53).  Against ``x @ dequant(w)`` in f32 two bars hold:
    every entry within ``QDOT_SIGMAS`` standard deviations of the
    activations' rounding (each code is off by at most half a row step s,
    uniformly, so an entry's error has sd s / sqrt(12) times the column's
    L2 norm) plus the output dtype's rounding; and the largest error
    within ``QDOT_MAX_SHARE`` of the largest |x @ dequant(w)|
    (tests/test_weight_quant.py holds 1 % at 16 x 64 x 48, where a row's
    largest entry is ~2.4 sigma; at K = 4096..14336 it is ~3.8 sigma, the
    row step larger, and the share 0.87-1.11 % on the card).  Timed (L2 flushed before
    each launch): qdot (quantize + ``torch._int_mm`` + rescale), ``_int_mm``
    alone on the column-major weight the port stores and on a row-major
    copy, and bf16 ``torch.matmul`` on the dequantized weight, beside the
    bounds: max(bytes / 3.35 TB/s, 2·M·N·K / peak) with the int8 and the
    bf16 peaks.  Returns ok."""
    from dynamo_tpu_torch.models.quant import operand_layout
    from dynamo_tpu_torch.ops import quant_matmul as qm

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 reference in full f32
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ok = True
    for name, K, N in PROJECTIONS:
        w_rm = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        w_cm = operand_layout(w_rm)
        scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        w_bf = (w_rm.float() * scale).to(torch.bfloat16)
        out_dtype = torch.float32 if name in F32_OUT else None
        for M in GEMM_ROWS:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            codes, row_scale = qm.quantize_rows(x)
            acc = qm.int_mm(codes, w_cm)
            int_ok = bool(torch.equal(acc.double(), codes.double() @ w_rm.double()))
            got = qm.qdot(x, w_cm, scale, out_dtype=out_dtype)
            w_deq = w_rm.float() * scale
            ref = x.float() @ w_deq
            err = (got.float() - ref).abs()
            out_eps = 2.0**-8 if out_dtype is None else 1e-6  # bf16 / f32 output rounding
            sd = row_scale * (w_deq.norm(dim=0) / math.sqrt(12.0))
            limit = QDOT_SIGMAS * sd + out_eps * ref.abs() + 1e-5 * ref.abs().max()
            within = bool((err <= limit).all())
            sigmas = float((err / sd).max())
            rel = float(err.max() / ref.abs().max())
            good = (int_ok and within and rel <= QDOT_MAX_SHARE
                    and bool(torch.isfinite(got).all()))
            ok = ok and good
            del acc, got, ref, err, limit, w_deq, sd
            t = {
                "qdot": cuda_ms(torch, lambda: qm.qdot(x, w_cm, scale, out_dtype=out_dtype), 10,
                                flush),
                "int_mm": cuda_ms(torch, lambda: qm.int_mm(codes, w_cm), 10, flush),
                "bf16": cuda_ms(torch, lambda: torch.matmul(x, w_bf), 10, flush),
            }
            try:  # a layout the port never passes: reported, not required
                t["int_mm_row_major"] = cuda_ms(torch, lambda: qm.int_mm(codes, w_rm), 10, flush)
            except RuntimeError as e:
                t["int_mm_row_major"] = f"refused ({str(e).splitlines()[0][:80]})"
            out_b = 4 if out_dtype else 2
            q_bound = max((M * K * 2 + K * N + N * 4 + M * N * out_b) / HBM_BYTES_PER_S,
                          2 * M * N * K / INT8_OPS) * 1e3
            bf_bound = max((M * K * 2 + K * N * 2 + M * N * 2) / HBM_BYTES_PER_S,
                           2 * M * N * K / BF16_FLOPS) * 1e3
            fmt = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in t.items()}
            log(f"w8a8 {name} M={M} K={K} N={N}: int32 accumulation exact {int_ok}, every "
                f"entry within {QDOT_SIGMAS:g} sd of the activations' rounding {within} (largest "
                f"{sigmas:.2f} sd), max err {rel:.2e} of max |x @ dequant(w)| (bar "
                f"{QDOT_MAX_SHARE:g}) {'ok' if good else 'FAIL'}; "
                f"ms {fmt}; bound W8A8 {q_bound:.4f} ms, bf16 {bf_bound:.4f} ms; "
                f"qdot/bf16 {t['qdot'] / t['bf16']:.3f}")
            del x, codes
        del w_rm, w_cm, w_bf
        torch.cuda.empty_cache()
    return ok


W8A8 = dict(weight_quant="int8", cache_dtype="int8", kv_scale="auto")
MODEL_CHECK_ROWS, MODEL_CHECK_TOKENS = 8, 64
KL_TOL = 0.05
KV_COSINE = 0.99
# Full depth: the W8A8 model's int8-page 1 - cosine against its witness, the
# bf16 tree's under the same scales (~5x on the card at 4 and at 32 layers:
# W8A8's rounding turns the KV noise into whole-step code changes).
KV_DRIFT_WITNESS = 8.0


def rows_batch(torch, dev, prompts, tables):
    """A prefill RaggedBatch of one row per prompt (positions from 0) in
    the pages of its table."""
    from dynamo_tpu_torch.models.llama import RaggedBatch

    n = sum(len(p) for p in prompts)
    T = max(16, 1 << (n - 1).bit_length())
    tok, pos, slots, cu = [], [], [], [0]
    for p, table in zip(prompts, tables):
        tok += p
        pos += list(range(len(p)))
        slots += [table[i // PS] * PS + i % PS for i in range(len(p))]
        cu.append(cu[-1] + len(p))

    def t(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    return RaggedBatch(
        token_ids=t(tok + [0] * (T - n)), positions=t(pos + [0] * (T - n)),
        slot_mapping=t(slots + [-1] * (T - n)), kv_lens=t([len(p) for p in prompts]),
        page_indices=t(tables), cu_q_lens=t(cu), num_seqs=t([len(prompts)]))


def w8a8_model_check(torch, dev):
    """Phase b: llama-3.1-8b at full width, W8A8 (an engine's
    ``init_params_quantized`` tree, int8 KV scales calibrated at start),
    against the same quantized tree dequantized to bf16, on 8 prompts of 64
    tokens in one prefill step, as tests/test_weight_quant.py holds it:
    mean KL below KL_TOL, and the top-1 tokens agree wherever the
    reference's top-2 gap is decisive (> 3x the largest logit error; a
    random model's top-2 gap rarely is, and the line says when the check
    was vacuous).  Then int8 pages under the calibrated scales against
    bf16 pages on the same W8A8 model, at MODEL_CHECK_LAYERS layers (the
    paged f32 check's depth): cosine above KV_COSINE on every row.  At all
    32 layers the KL bar holds as well, and the int8-page drift is held
    against its witness, the bf16 tree's drift under the same scales:
    1 - cosine within KV_DRIFT_WITNESS times the witness's, since a random
    32-layer model amplifies any perturbation (1 - cosine grows
    with the square of the per-layer noise).  Returns ok."""
    import numpy as np

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.llama import PagedKVCache, forward_ragged
    from dynamo_tpu_torch.models.quant import dequantize_params

    t0 = time.perf_counter()
    engine = TorchEngine(EngineConfig(model="llama-3.1-8b", dtype="bfloat16", block_size=PS,
                                      num_blocks=64, max_batch=MODEL_CHECK_ROWS,
                                      max_model_len=1024, seed=0, **W8A8), device=dev)
    torch.cuda.synchronize()
    mc, scales = engine.model_config, np.asarray(engine.kv_scale)
    ok = scales.shape == (mc.num_layers,) and bool(np.all(np.isfinite(scales) & (scales > 0)))
    log(f"w8a8 engine: init {time.perf_counter() - t0:.1f} s; {len(scales)} calibrated int8 KV "
        f"scales min {scales.min():.6g} max {scales.max():.6g}, calibration "
        f"{engine.calibration_s:.3f} s {'ok' if ok else 'FAIL'}")
    gen = torch.Generator().manual_seed(17)
    prompts = torch.randint(1, 128000, (MODEL_CHECK_ROWS, MODEL_CHECK_TOKENS), generator=gen).tolist()
    PP = MODEL_CHECK_TOKENS // PS
    tables = [list(range(r * PP, (r + 1) * PP)) for r in range(MODEL_CHECK_ROWS)]
    rb = rows_batch(torch, dev, prompts, tables)
    with torch.inference_mode():
        deq = dequantize_params(engine.params, torch.bfloat16)
    for depth in sorted({min(MODEL_CHECK_LAYERS, mc.num_layers), mc.num_layers}):
        mcd = mc.with_overrides(num_layers=depth)

        def logits(params, dtype, kv_scale):
            sub = dict(params, layers={k: v[:depth] for k, v in params["layers"].items()})
            cache = PagedKVCache.create(mcd, MODEL_CHECK_ROWS * PP, PS, dtype, dev)
            return forward_ragged(sub, mcd, rb, cache, kv_scale=kv_scale).double().cpu()

        with torch.inference_mode():
            lq = logits(engine.params, torch.bfloat16, None)
            lq8 = logits(engine.params, torch.int8, scales[:depth])
            lr = logits(deq, torch.bfloat16, None)
            lr8 = logits(deq, torch.int8, scales[:depth])
        kls, agree, decisive = [], 0, 0
        for a, b in zip(lq, lr):
            pq, pr = a.softmax(-1), b.softmax(-1)
            kls.append(float((pr * (pr.clamp_min(1e-300).log() - pq.clamp_min(1e-300).log())).sum()))
            top2 = b.topk(2).values
            if float(top2[0] - top2[1]) > 3 * float((a - b).abs().max()):
                decisive += 1
                agree += int(a.argmax() == b.argmax())

        def cosines(x, y):
            return [float(torch.nn.functional.cosine_similarity(a, b, dim=0)) for a, b in zip(x, y)]

        cos_q, cos_r = cosines(lq8, lq), cosines(lr8, lr)
        finite = all(bool(torch.isfinite(t).all()) for t in (lq, lq8, lr, lr8))
        shallow = depth == min(MODEL_CHECK_LAYERS, mc.num_layers)
        good_w = float(np.mean(kls)) < KL_TOL and agree == decisive
        drift_q, drift_r = 1 - min(cos_q), 1 - min(cos_r)
        good_kv = (min(cos_q) > KV_COSINE if shallow
                   else drift_q <= KV_DRIFT_WITNESS * drift_r)
        good = finite and good_w and good_kv
        ok = ok and good
        kv_bar = (f"bar {KV_COSINE}" if shallow else
                  f"1 - cosine {drift_q / max(drift_r, 1e-12):.2f}x the bf16 tree's, bar "
                  f"{KV_DRIFT_WITNESS:g}x")
        top1 = (f"{agree}/{decisive} decisive rows" if decisive else
                "vacuous (no row's top-2 gap is decisive)")
        log(f"w8a8 model {depth} layers vs its dequantized bf16 tree, {MODEL_CHECK_ROWS} prompts "
            f"of {MODEL_CHECK_TOKENS}: mean KL {np.mean(kls):.3e} (bar {KL_TOL}), top-1 agreement "
            f"{top1}, max logit err {float((lq - lr).abs().max()):.4f} "
            f"(max |logit| {float(lr.abs().max()):.3f}); int8 pages (calibrated) vs bf16 pages: "
            f"cosine min {min(cos_q):.6f} on the W8A8 model ({kv_bar}), "
            f"{min(cos_r):.6f} on the bf16 tree; same argmax "
            f"{sum(int(a.argmax() == b.argmax()) for a, b in zip(lq8, lq))}/{MODEL_CHECK_ROWS} "
            f"{'ok' if good else 'FAIL'}")
    del deq
    asyncio.run(engine.close())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return ok


# bench.py's geometry (phase c): full-depth llama-3.1-8b, 256 rows.
BENCH_CFG = dict(model="llama-3.1-8b", dtype="bfloat16", block_size=PS, num_blocks=4160,
                 max_batch=256, max_model_len=256, prefill_chunk=512, decode_steps=8,
                 pipeline_depth=8, seed=0)
BENCH_ISL, BENCH_OSL = 128, 64


def bench_prompts(vocab, n):
    """bench.py's prompts: token j of request i is (i·7919 + j·104729) % vocab."""
    return [[(i * 7919 + j * 104729) % vocab for j in range(BENCH_ISL)] for i in range(n)]


def bench_serve(torch, dev, quant):
    """One engine at BENCH_CFG (W8A8 with int8 KV ``auto``, or bf16 weights
    and bf16 KV), warmed (``run_warmup``), then 256 greedy requests of
    BENCH_ISL tokens with BENCH_OSL new each and ``ignore_eos``, kernel
    counters zeroed just before and read just after.  Returns (ok,
    numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = EngineConfig(**BENCH_CFG, **(W8A8 if quant else {}))
    label = "W8A8 + int8 KV auto" if quant else "bf16 + bf16 KV"
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, device=dev)
    torch.cuda.synchronize()
    out = {"label": label, "init_s": time.perf_counter() - t0,
           "calibration_s": engine.calibration_s}
    prompts = bench_prompts(engine.model_config.vocab_size, cfg.max_batch)

    async def run():
        try:
            t = time.perf_counter()
            out["warm"] = await engine.run_warmup()
            out["warm_s"] = time.perf_counter() - t
            zero_kernel_counts()
            t = time.perf_counter()
            results = await serve(torch, engine, prompts, BENCH_OSL)
            out["wall"] = time.perf_counter() - t
            out["launches"] = kernel_counts()
            out["after"] = engine.compile_counts()
            out["per_replay"] = {name: {str(k): v for k, v in getattr(engine.programs, name)
                                        .captured_launches().items()} for name in ("step", "multi")}
            dec, pre = engine.decode_spans, engine.prefill_spans
            out["fused_step_ms"] = dec.seconds / max(1, dec.count * cfg.decode_steps) * 1e3
            out["prefill_step_ms"] = pre.seconds / max(1, pre.count) * 1e3
            out["summary"] = engine.dispatch_summary()
            return results
        finally:
            await engine.close()

    results = asyncio.run(run())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ttft = sorted(s[0] for _, s, _ in results)
    itl = [(s[-1] - s[0]) / (len(s) - 1) for _, s, _ in results if len(s) > 1]
    total = sum(len(t) for t, _, _ in results)
    whole = all(len(t) == BENCH_OSL and f == "length" for t, _, f in results)
    ok = whole and out["after"] == out["warm"] and all(v > 0 for v in out["launches"].values())
    pipe = out["summary"]["pipeline"]
    out.update(tok_s=total / out["wall"], ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
               ttft_max_ms=ttft[-1] * 1e3, itl_ms=sum(itl) / len(itl) * 1e3,
               host_gap_frac=pipe["host_gap_frac"])
    log(f"bench {label}: {len(results)} requests, ISL {BENCH_ISL} OSL {BENCH_OSL}, "
        f"max_batch {cfg.max_batch}, decode_steps {cfg.decode_steps}, pipeline_depth "
        f"{cfg.pipeline_depth}; init {out['init_s']:.1f} s (calibration "
        f"{out['calibration_s']:.3f} s), warmup {out['warm_s']:.2f} s for graphs {out['warm']}; "
        f"wall {out['wall']:.3f} s, {out['tok_s']:.2f} output tok/s; TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms max {out['ttft_max_ms']:.1f} ms; ITL mean "
        f"{out['itl_ms']:.2f} ms; fused step {out['fused_step_ms']:.2f} ms and prefill step "
        f"{out['prefill_step_ms']:.2f} ms (stream time); host_gap_frac {out['host_gap_frac']}; "
        f"sessions {pipe['sessions']} rebuilds {pipe['rebuilds']}; launches {out['launches']}; "
        f"per replay {out['per_replay']}; graphs after the serve {out['after']}; streams whole "
        f"{whole} {'ok' if ok else 'FAIL'}")
    return ok, out


def quant_ab(torch, dev):
    """``--quant-ab``: phase c's traffic on W8A8 + int8 KV and on bf16 +
    bf16 KV, engines one after the other in one process, in turns (W8A8,
    bf16, bf16, W8A8)."""
    ok = True
    for quant in (True, False, False, True):
        good, _ = bench_serve(torch, dev, quant)
        ok = ok and good
    return ok


# benchmarks/loadgen.py's self-hosted geometry (phase d).
LOADGEN_CFG = dict(model="llama-3.1-8b", dtype="bfloat16", block_size=PS, num_blocks=6208,
                   max_batch=24, max_model_len=4096, prefill_chunk=2048, decode_steps=16,
                   pipeline_depth=4, prefill_chunks_per_burst=24, seed=0, **W8A8)
LOADGEN_ISL, LOADGEN_OSL, LOADGEN_CONC = 3000, 150, 24


def loadgen_prompt(i, vocab):
    """benchmarks/loadgen.py's ``_prompt_tokens``: distinct per request."""
    return [(i * 7919 + j * 104729 + 11) % (vocab - 2) + 1 for j in range(LOADGEN_ISL)]


def pct(xs, p):
    """benchmarks/loadgen.py's percentile."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p))] if xs else float("nan")


def loadgen_http(torch, dev):
    """Phase d: the port's HttpService → OpenAIPreprocessor → Backend →
    TorchEngine built in-process as benchmarks/loadgen.py builds its
    self-hosted stack, at LOADGEN_CFG, the server's event loop in a thread
    of this process; 24 concurrent streamed /v1/completions of 3000-token-id
    prompts with 150 new tokens and ``nvext.ignore_eos``, read at the
    client as loadgen reads them (a token per SSE chunk, stamped on
    arrival); then ``/metrics``.  Returns (ok, numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.metrics import engine_dispatch_metrics
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline

    t0 = time.perf_counter()
    engine = TorchEngine(EngineConfig(**LOADGEN_CFG), device=dev)
    out = {"init_s": time.perf_counter() - t0, "calibration_s": engine.calibration_s}
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="loadgen-server", daemon=True)
    thread.start()

    def on_server(coro, timeout=1200):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    async def start():
        tok = ByteTokenizer()
        pipeline = build_pipeline([OpenAIPreprocessor(tok, "bench"), Backend(tok)], engine)
        service = HttpService(host="127.0.0.1", port=0)
        service.models.add_completion_model("bench", pipeline)
        service.models.add_chat_model("bench", pipeline)
        return await service.start()

    vocab = engine.model_config.vocab_size
    fails = []
    service = None
    try:
        t = time.perf_counter()
        out["warm"] = on_server(engine.run_warmup())
        out["warm_s"] = time.perf_counter() - t
        engine_dispatch_metrics.set_source(engine.dispatch_summary)
        service = on_server(start())

        async def client():
            async def one(i):
                return await http_call(service.port, "POST", "/v1/completions", {
                    "model": "bench", "prompt": loadgen_prompt(i, vocab),
                    "max_tokens": LOADGEN_OSL, "stream": True, "nvext": {"ignore_eos": True}})

            zero_kernel_counts()
            t = time.perf_counter()
            results = await asyncio.gather(*(one(i) for i in range(LOADGEN_CONC)))
            out["wall"] = time.perf_counter() - t
            out["launches"] = kernel_counts()
            out["metrics"] = (await http_call(service.port, "GET", "/metrics"))[2].decode()
            return results

        results = asyncio.run(client())
        out["after"] = engine.compile_counts()
        dec, pre = engine.decode_spans, engine.prefill_spans
        out["fused_step_ms"] = dec.seconds / max(1, dec.count * LOADGEN_CFG["decode_steps"]) * 1e3
        out["prefill_step_ms"] = pre.seconds / max(1, pre.count) * 1e3
        out["per_replay"] = {name: {str(k): v for k, v in getattr(engine.programs, name)
                                    .captured_launches().items()} for name in ("step", "multi")}
    finally:
        engine_dispatch_metrics.set_source(None)
        if service is not None:
            on_server(service.close())
        on_server(engine.close())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ttfts, itls, per_token, tokens, n_chunks = [], [], [], 0, []
    for i, (st, _, _, events) in enumerate(results):
        chunks, done = sse_data(events)
        final = chunks[-1][1] if chunks else {}
        used = (final.get("usage") or {}).get("completion_tokens")
        fin = (final.get("choices") or [{}])[0].get("finish_reason")
        if st != 200 or not done or fin != "length" or used != LOADGEN_OSL:
            fails.append(f"request {i}: {st} done={done} {fin}/{used}")
            continue
        tokens += used
        stamps = [t for t, c in chunks
                  if c.get("choices") and not c["choices"][0].get("finish_reason")]
        ttfts.append(stamps[0])
        itls += [b - a for a, b in zip(stamps, stamps[1:])]
        per_token.append((chunks[-1][0] - stamps[0]) / (used - 1))
        n_chunks.append(len(stamps))
    samples = parse_prometheus(out["metrics"])
    gap = [v for (n, _), v in samples.items() if n == "dynamo_tpu_engine_dispatch_host_gap_frac"]
    has_spec = any(n == "dynamo_tpu_spec_decode_acceptance_rate" for n, _ in samples)
    if out["after"] != out["warm"]:
        fails.append(f"graphs captured during the serve: {out['warm']} -> {out['after']}")
    if not all(v > 0 for v in out["launches"].values()):
        fails.append(f"a kernel never launched: {out['launches']}")
    if not gap or not has_spec:
        fails.append("/metrics lacks the engine-dispatch or the spec-decode group")
    out.update(tok_s=tokens / out["wall"], ttft_p50_ms=pct(ttfts, 0.5) * 1e3,
               ttft_p99_ms=pct(ttfts, 0.99) * 1e3, itl_p50_ms=pct(itls, 0.5) * 1e3,
               itl_p99_ms=pct(itls, 0.99) * 1e3, host_gap_frac=gap[0] if gap else None,
               itl_per_token_ms=sum(per_token) / max(1, len(per_token)) * 1e3)
    log(f"loadgen W8A8 + int8 KV auto over HTTP: {LOADGEN_CONC} concurrent streamed "
        f"/v1/completions, ISL {LOADGEN_ISL} OSL {LOADGEN_OSL}, max_batch "
        f"{LOADGEN_CFG['max_batch']}, prefill_chunk {LOADGEN_CFG['prefill_chunk']}, decode_steps "
        f"{LOADGEN_CFG['decode_steps']}, pipeline_depth {LOADGEN_CFG['pipeline_depth']}; init "
        f"{out['init_s']:.1f} s (calibration {out['calibration_s']:.3f} s), warmup "
        f"{out['warm_s']:.2f} s for graphs {out['warm']}; wall {out['wall']:.3f} s, "
        f"{out['tok_s']:.2f} output tok/s; TTFT p50 {out['ttft_p50_ms']:.1f} ms p99 "
        f"{out['ttft_p99_ms']:.1f} ms; ITL p50 {out['itl_p50_ms']:.2f} ms p99 "
        f"{out['itl_p99_ms']:.2f} ms (client, per SSE chunk; chunks a request {min(n_chunks, default=0)}"
        f"..{max(n_chunks, default=0)}), per token {out['itl_per_token_ms']:.2f} ms (end - first "
        f"chunk over {LOADGEN_OSL - 1}); fused step {out['fused_step_ms']:.2f} ms, prefill step "
        f"{out['prefill_step_ms']:.2f} ms (stream time); host_gap_frac "
        f"{out['host_gap_frac']} (/metrics); launches {out['launches']}; per replay "
        f"{out['per_replay']}; graphs after {out['after']} "
        f"{'ok' if not fails else 'FAIL: ' + '; '.join(fails)}")
    return not fails, out


SPEC_K = 8


def spec_oracle(prompts, streams, vocab):
    """A stand-in for ``engine.spec.propose_ngram`` that drafts each
    request's own spec-off stream from its position (the request is found
    by its prompt's first 8 tokens, unique in both workloads), with one
    token made wrong in every other 8-token window of output, so drafts
    are both accepted and rejected on the card whatever the random model
    emits."""
    import numpy as np

    refs = {tuple(p[:8]): (len(p), out) for p, out in zip(prompts, streams)}

    def oracle(hist, ngram_min, ngram_max, k):
        n_prompt, ref = refs[tuple(int(t) for t in hist[:8])]
        pos = len(hist) - n_prompt  # output tokens committed so far
        d = [int(t) for t in ref[pos: pos + k]]
        if d and (pos // 8) % 2:
            j = min(2, len(d) - 1)
            d[j] = (d[j] + 1) % vocab
        return np.asarray(d, np.int64)

    return oracle


def spec_prompts(kind, n, vocab):
    """bench.py's ``_spec_prompts``: ``repetitive`` period-8 templated
    prompts, or ``random`` prompts with a jittered length."""
    prompts = []
    for i in range(n):
        if kind == "repetitive":
            pattern = [(i * 131 + j * 17 + 3) % vocab for j in range(8)]
            prompts.append((pattern * ((BENCH_ISL + 7) // 8))[:BENCH_ISL])
        else:
            isl_i = max(8, BENCH_ISL // 2 + (i * 2654435761) % BENCH_ISL)
            prompts.append([(i * 7919 + j * 104729 + 13) % vocab for j in range(isl_i)])
    return prompts


async def spec_run(engine, prompts, osl, temperature):
    """bench.py's ``_spec_run``: every prompt at once, seed i·7+1."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context, collect

    async def one(i, prompt):
        req = PreprocessedRequest(
            token_ids=prompt,
            stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=temperature, seed=i * 7 + 1),
        ).to_dict()
        items = await collect(await engine.generate(Context(req)))
        return [t for it in items for t in it["token_ids"]]

    t0 = time.perf_counter()
    streams = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    return sum(len(s) for s in streams), time.perf_counter() - t0, streams


def spec_phase(torch, dev):
    """Phase e, as bench.py's ``_spec_bench`` runs it: a fresh W8A8 + int8
    KV engine at BENCH_CFG per mode (speculation off, then on at k
    SPEC_K), n = max_batch // 8 requests of BENCH_ISL tokens with
    BENCH_OSL new each — the repetitive prompts greedy, the random ones at
    temperature 0.7 — each after bench.py's 4-token warm pass (which fills
    the prefix cache) and a second, whole warm pass over the cached
    prompts, which captures the sampled programs ``run_warmup`` leaves to
    first use (the graphs a timed pass still captured are printed).  The streams must be
    identical between the modes.  The random model's greedy output seldom
    gives the n-gram proposer a match, so the spec-on engine then serves
    both workloads once more with drafts forced (``spec_oracle``): the
    streams must again equal the spec-off ones, with verification
    dispatches, accepted and rejected drafts all above 0.  Returns (ok,
    numbers)."""
    from dynamo_tpu_torch.engine import spec as spec_mod
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.metrics import spec_metrics

    n = max(2, BENCH_CFG["max_batch"] // 8)
    res, streams, kv_scales = {}, {}, {}
    for mode in ("off", "on"):
        engine = TorchEngine(EngineConfig(**BENCH_CFG, **W8A8,
                                          spec_decode={"enable": mode == "on", "k": SPEC_K}),
                             device=dev)
        vocab = engine.model_config.vocab_size
        kv_scales[mode] = [float(s) for s in engine.kv_scale]

        async def run():
            try:
                await engine.run_warmup()
                for kind, temp in (("repetitive", 0.0), ("random", 0.7)):
                    prompts = spec_prompts(kind, n, vocab)
                    await spec_run(engine, prompts, 4, temp)  # bench.py's warm pass
                    await spec_run(engine, prompts, BENCH_OSL, temp)
                    spec_metrics.reset()
                    zero_kernel_counts()
                    before = engine.compile_counts()
                    toks, dt, out = await spec_run(engine, prompts, BENCH_OSL, temp)
                    snap = spec_metrics.snapshot()
                    captured = sum(engine.compile_counts().values()) - sum(before.values())
                    res[(kind, mode)] = dict(tok_s=toks / dt, tokens=toks, wall=dt,
                                             launches=kernel_counts(), captured=captured, **snap)
                    streams[(kind, mode)] = out
                    log(f"spec {kind}/{mode}: {n} requests, {toks} tokens in {dt:.3f} s "
                        f"({toks / dt:.2f} tok/s), acceptance {snap['acceptance_rate']:.3f}, "
                        f"tokens/dispatch {snap['tokens_per_dispatch']:.2f}, verification "
                        f"dispatches {int(snap['dispatches_total'])}, fallbacks "
                        f"{int(snap['fallback_total'])}, launches {res[(kind, mode)]['launches']}, "
                        f"graphs captured in the timed pass {captured}")
                if mode == "on":
                    await forced(engine, vocab)
            finally:
                await engine.close()

        async def forced(engine, vocab):
            """Drafts forced on the card: the proposer replaced by
            ``spec_oracle`` over the spec-off streams."""
            saved = spec_mod.propose_ngram
            try:
                for kind, temp in (("repetitive", 0.0), ("random", 0.7)):
                    prompts = spec_prompts(kind, n, vocab)
                    spec_mod.propose_ngram = spec_oracle(prompts, streams[(kind, "off")], vocab)
                    spec_metrics.reset()
                    zero_kernel_counts()
                    toks, dt, out = await spec_run(engine, prompts, BENCH_OSL, temp)
                    snap = spec_metrics.snapshot()
                    rejected = snap["drafted_total"] - snap["accepted_total"]
                    same = out == streams[(kind, "off")]
                    good = (same and snap["dispatches_total"] > 0 and snap["accepted_total"] > 0
                            and rejected > 0)
                    res[(kind, "forced")] = dict(tok_s=toks / dt, identical=same, ok=good,
                                                 launches=kernel_counts(), **snap)
                    log(f"spec {kind}/forced drafts ({'greedy' if temp == 0 else f'temperature {temp}'}"
                        f", oracle of the spec-off stream, one token wrong in every other "
                        f"window): streams identical to spec off {same}; {toks / dt:.2f} tok/s, "
                        f"verification dispatches {int(snap['dispatches_total'])}, drafted "
                        f"{int(snap['drafted_total'])}, accepted {int(snap['accepted_total'])}, "
                        f"rejected {int(rejected)}, acceptance {snap['acceptance_rate']:.3f}, "
                        f"tokens/dispatch {snap['tokens_per_dispatch']:.2f}, launches "
                        f"{res[(kind, 'forced')]['launches']} {'ok' if good else 'FAIL'}")
            finally:
                spec_mod.propose_ngram = saved

        asyncio.run(run())
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    # A warm start from the object store restores int8 codes without their
    # scales: it relies on two fresh engines of one seed calibrating the
    # same scales (reported, not gated).
    diff = max(abs(a - b) for a, b in zip(kv_scales["off"], kv_scales["on"]))
    log(f"int8 kv scales (kv_scale auto), two fresh engines of one seed: equal "
        f"{kv_scales['off'] == kv_scales['on']}, max |diff| {diff:.3e} over "
        f"{len(kv_scales['off'])} layers")
    ok = True
    for kind in ("repetitive", "random"):
        same = streams[(kind, "on")] == streams[(kind, "off")]
        whole = all(len(s) == BENCH_OSL for s in streams[(kind, "on")])
        ok = ok and same and whole
        ratio = res[(kind, "on")]["tok_s"] / res[(kind, "off")]["tok_s"]
        res[kind] = dict(ratio=ratio, identical=same)
        log(f"spec {kind}: streams identical on/off {same}, whole {whole}; tok/s off "
            f"{res[(kind, 'off')]['tok_s']:.2f} on {res[(kind, 'on')]['tok_s']:.2f}, ratio "
            f"{ratio:.3f} {'ok' if same and whole else 'FAIL'}")
    # Whether drafts engage depends on the random model's output turning
    # repetitive; it is reported, the streams and launches are checked.
    launched = all(all(v > 0 for v in res[(k, m)]["launches"].values())
                   for k in ("repetitive", "random") for m in ("off", "on"))
    forced_ok = all(res[(k, "forced")]["ok"] for k in ("repetitive", "random"))
    ok = ok and launched and forced_ok
    rep = res[("repetitive", "on")]
    # What the proposer can match: output positions whose bigram (previous
    # token, token) already occurred in the prompt or earlier output.
    hits = 0
    for prompt, out in zip(spec_prompts("repetitive", n, vocab), streams[("repetitive", "off")]):
        hist = prompt + out
        seen = {(a, b) for a, b in zip(prompt, prompt[1:])}
        for j in range(len(prompt), len(hist)):
            pair = (hist[j - 1], hist[j])
            hits += pair in seen
            seen.add(pair)
    log(f"spec: both kernels launched in every timed pass {launched}; verification dispatches "
        f"on the repetitive traffic {int(rep['dispatches_total'])}, acceptance "
        f"{rep['acceptance_rate']:.3f}, tokens/dispatch {rep['tokens_per_dispatch']:.2f}; output "
        f"tokens whose bigram was already in the history {hits} of {n * BENCH_OSL} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    if not (REPO / "dynamo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: dynamo_tpu_torch is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        from dynamo_tpu_torch.ops import _build

        dev = torch.device("cuda", 0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        global CARD
        CARD = smi[0] if smi else "nvidia-smi gave nothing"
        log(f"card: {CARD}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

        t0 = time.perf_counter()
        report = _build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(report) or 'cached libraries'}")
        for stem, r in report.items():
            for line in str(r["log"]).splitlines():
                if "registers" in line or "spill" in line.lower():
                    log(f"ptxas {stem}: {line.strip()}")
        if sys.argv[1:] == ["--serve-ab"]:
            return 0 if serve_ab(torch, dev) else 1
        if sys.argv[1:] == ["--quant-ab"]:
            return 0 if quant_ab(torch, dev) else 1

        from dynamo_tpu_torch.engine.config import EngineConfig

        cfg = EngineConfig(**SERVE_CFG)
        tally = Tally()
        check_tensor_cores(tally.failures)
        with torch.inference_mode():
            check_kernels(torch, dev, cfg, tally)
            times = time_kernels(torch, dev, cfg, tally)
            ok_model = model_check(torch, dev, cfg)
        ok_path, launches, ok_edge, edge, ok_tiers, tiers = main_path(torch, dev)
        # Phase 7 builds its own engine: free the direct serve's first
        # (16 GB of weights and 4 GiB of KV pages).
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the HTTP phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated")
        ok_http, http_launches, _ = http_path(torch)
        gc.collect()
        torch.cuda.empty_cache()

        # This slice: W8A8 weights, calibrated int8 KV pages, speculation.
        with torch.inference_mode():
            ok_ops = w8a8_ops(torch, dev)
            int8_times = time_int8_kernels(torch, dev, tally)
        ok_w8a8_model = w8a8_model_check(torch, dev)
        ok_bench, bench = bench_serve(torch, dev, quant=True)
        ok_loadgen, loadgen = loadgen_http(torch, dev)
        ok_spec, spec = spec_phase(torch, dev)
        slice_ok = {"w8a8 ops (a)": ok_ops, "w8a8 model (b)": ok_w8a8_model,
                    "bench geometry (c)": ok_bench, "loadgen geometry (d)": ok_loadgen,
                    "speculation (e)": ok_spec, "edge (f)": ok_edge, "kv tiers (g)": ok_tiers}

        sources = {
            "decode_attention": ("dynamo_tpu_torch/csrc/decode_attention.cu",
                                 "dynamo_tpu/ops/decode_attention.py:330"),
            "prefill_attention": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                                  "dynamo_tpu/ops/prefill_attention.py:285"),
        }
        kernels = []
        for name, (src, rep) in sources.items():
            tm = times[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "http_launches": http_launches[name],
                "max_abs_err": tally.worst[name],
                "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
                "checks_passed": not any(f.startswith(name) for f in tally.failures),
            })
            for geo, serve_out in (("bench", bench), ("loadgen", loadgen)):
                it = int8_times[geo][name]
                kernels[-1][f"int8_{geo}"] = {
                    "launches": serve_out["launches"][name], "ms": it["ms"],
                    "plain_ms": it["plain_ms"], "bound_ms": it["bound_ms"],
                    "bound_by": it["bound_by"], "library_ms": it["library_ms"]}
            kernels[-1]["spec_launches"] = spec[("repetitive", "on")]["launches"][name]
            kernels[-1]["spec_forced_launches"] = spec[("repetitive", "forced")]["launches"][name]
            kernels[-1]["edge_launches"] = edge["launches"][name]
            kernels[-1]["tier_launches"] = tiers["launches"][name]
            if "mixed" in tm:
                kernels[-1].update(mixed_step_ms=tm["mixed"]["ms"],
                                   mixed_step_plain_ms=tm["mixed"]["plain_ms"],
                                   mixed_step_bound_ms=tm["mixed"]["bound_ms"],
                                   mixed_step_library_ms=None,
                                   mixed_step_decode_rows_ms=tm["mixed"]["decode_rows_ms"])
        log(json.dumps({"kernels": kernels}))
        if tally.failures or not ok_model or not ok_path or not ok_http or not all(
                slice_ok.values()):
            log(f"FAILED: kernel checks {tally.failures or 'ok'}; f32 model check "
                f"{'ok' if ok_model else 'failed'}; main path {'ok' if ok_path else 'failed'}; "
                f"HTTP path {'ok' if ok_http else 'failed'}; "
                f"{ {k: 'ok' if v else 'failed' for k, v in slice_ok.items()} }")
            return 1
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
