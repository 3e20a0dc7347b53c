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
  h. the README's distributed stack (``cli hub``; ``run in=dyn://…
     out=torch`` workers; ``http --router kv``) serving llama-3.1-8b at
     phase 6's geometry: the hub, a KV-routed and a round-robin frontend
     and worker B are subprocesses of the CLI; worker A runs the CLI's own
     ``run in=dyn://`` code in this process (its launches counted), warmed
     before traffic; both draw the weights from seed 0.  8 greedy prompts
     of 1024 ids, 64 new tokens, one at a time through the kv frontend,
     each identical to the colocated engine's stream served alone (its
     text, and the output ids through the sealed blocks' chained hashes
     on the kv_events subject); then each 1024-id prefix plus 32 new ids,
     which the router's ``KVHitRateEvent`` must send to the worker of its
     first pass with at least 64 blocks of overlap, that worker's prefix
     hits rising; repeat TTFT through kv against round_robin on fresh
     prefixes in 3 turns (reported); 16 concurrent streams of 512–2048
     ids, all whole, each worker taking at least 4; then 4 greedy streams
     whose prefixes live on B, B SIGKILLed once each has 8 tokens: all 4
     finish whole on A, the frontend's resume counter rises by 4, B leaves
     discovery within the lease TTL plus 1 s and the router's index holds
     none of its blocks; on A no graph is captured and no
     ``torch.cuda.synchronize`` runs while serving, and both kernels
     launch; the router's hashing of 2048 ids is timed on this host;
  i. the README's disaggregated deployment (``cli hub``; ``run
     in=dyn://… --disagg prefill``; ``run in=dyn://… --disagg decode
     --max-local-prefill 512``; ``http``) at phase 6's geometry: the hub,
     the frontend and the prefill worker P are subprocesses of the CLI; the
     decode worker D runs the CLI's own ``--disagg decode`` code in this
     process (its launches counted), warmed before traffic.  8 greedy
     prompts of 2040 ids (127 full blocks and an 8-id tail), 64 new tokens,
     one at a time through the frontend: each prefilled on P, its blocks
     pushed chunk by chunk into D's pages, 8 remote prefills and none
     local or degraded, 8 x 127 blocks wire-verified, each stream
     identical to D's engine serving the prompt alone in the same shapes,
     and an imported block's pages bitwise equal to D's own; the live
     threshold (``publish_config`` 4096, then 512: 4 prompts local, 4
     remote); 4 remote prompts while a long stream decodes (decode
     dispatches between D's inject entries; each inject's lock hold beside
     the fused dispatch); a byte flipped on the wire in one chunk (the
     verified prefix seals and hits, D prefills the rest, the stream
     identical, one corruption on the integrity /metrics group); no graph
     captured and no ``torch.cuda.synchronize`` on D, both kernels
     launched.  Then, P stopped, a prefill engine P' in this process and
     ``transfer_blocks_device`` of 127 blocks into D: pages bitwise equal,
     no host bytes, no graph, no sync; timed beside the host-staged path
     for the same blocks (P''s export, the wire into D's ``kv_import``,
     D's inject, by part), with the remote against local TTFT and the
     chunk sizes P's adaptive sizing reached;
  j. the sampler's noise kernel (csrc/threefry_gumbel.cu, ``jax.random``'s
     threefry Gumbel noise bit for bit) against its plain version at 16 and
     256 rows over the 128256-id vocabulary: uint32 bits exactly equal,
     values within 2 ulp at the scale max(|g|, 1), the sampled tokens of
     random logits equal; timed beside its plain version and its bound.
     Then the distributed stack again (``cli hub``, ``http --router kv``
     and worker B as subprocesses, worker A the CLI's own ``run in=dyn://``
     code in this process with ``--kv-pull-mb 192``): a greedy and a
     sampled fused dispatch's device time on A; 4 streams of 2048-id
     prompts (2 greedy, 2 seeded at temperature 0.7) through the frontend
     on A, migrated to B by A's ``migrate_out`` once each has 32 tokens:
     every stream whole, 4 splices on the frontend's /metrics, A's rows and
     blocks released, sampled migrated blocks bitwise equal on B, each
     stream equal to its resume request served on B (how many also equal
     the never-migrated stream is reported), no graph and no
     ``torch.cuda.synchronize`` on A, all three kernels launched there;
     copy rounds, blocks, freeze-to-quiescence, the stall across the
     cutover and the wall to cutover reported; then B holds a 2048-id
     prefix and A, hinted with ``kv_pull``, pulls it at 64 and 192 MiB: the
     pulled count min(peer - local, budget), pages bitwise B's, the stream
     equal to the same split computed on A, TTFT beside A's recompute and
     B's prefix hit; a dead peer's pull prefills locally; then (after
     phase k) A is stopped with 2 live streams and drains them to B
     through migration, whole.  Phase j's transfers ride the service
     plane although every process runs with ``DYN_BULK_PLANE=1``: A's two
     bulk producers are switched to the service plane for it;
  k. on phase j's stack, before its drain, A's producers on the bulk
     plane (``bulk_health_path``): A's and B's ``bulk/addr`` and the
     frontend's ``bulk/sink/traces`` in the hub; B's kv_export fetches
     under ``bulk_conn_drop`` (B started with ``DYN_FAULTS``): dropped
     after every chunk, one fallback tick and the service plane pulls the
     same pages; dropped once, resumed with no fallback; A pulls 32 and 96
     blocks of a 2048-id prefix B holds, in turns over the bulk plane and
     the service plane (3 each): the count min(peer - local, budget), pages
     bitwise B's, the stream equal to the same split on A, the bulk bytes
     on ``dynamo_tpu_bulk_bytes_total`` with no fallback, TTFT and the
     pull's wall, and during each 96-block pull the gaps of a stream
     decoding on B (the donor) and B's resident memory; 2 streams (greedy,
     seeded at 0.7) migrated A -> B over the bulk plane through the
     frontend: whole, 2 splices, blocks bitwise on B, each equal to its
     resume request on B, the copy stream's bytes on the bulk counter and
     not on the hub's publish bytes, move times and stalls beside phase
     j's; traced requests on B with B's spans at the frontend's /traces
     through the bulk sink and no fallback; a ``HealthWatchdog`` in this
     process (default prober, drainer and latency source, fed by this
     process's routed client; an echo worker is the fleet's third member,
     since the fleet median of two workers is the slower one's own p50):
     ``slow_stream`` on A with A's decode paced to its slowed wire while A
     serves 2 streams: A quarantined as a straggler, its marker written,
     the default drainer moving both streams to B over the bulk plane,
     whole; disarmed, A reinstated before the grace ends, the marker
     cleared; then A's ``__health__`` stalled past the probe timeout with a
     1 s grace: A ejected, its registration deleted, the frontend routing
     only to B (all 200), the marker ``ejected``; A re-registered and reset;
     the ``dynamo_tpu_health_*`` counters equal to the transitions; no
     graph and no sync on A, all three kernels launched;
  8. print the kernels line (each kernel's int8 timings and its launches in
     phases c, d, e, f, g, h, i, j and k beside phase 6's and 7's; the noise
     kernel's in phases j, k and e), then the device line last.

Needs a CUDA device; without one it prints no result and exits 1.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import gc
import json
import math
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

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
        self.worst = {"decode_attention": 0.0, "prefill_attention": 0.0, "threefry_gumbel": 0.0}
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


async def http_call(port, method, path, body=None, headers=None, on_event=None):
    """One HTTP/1.1 request over a fresh connection (standard library
    only), with extra request ``headers``.  Returns (status, headers, body
    bytes, SSE events) with each SSE event stamped on arrival, in seconds
    after the request was sent; ``on_event(t, event)`` sees each as it
    arrives."""
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
                    if on_event is not None:
                        on_event(now, events[-1][1])
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
                    zero_noise_launches()
                    before = engine.compile_counts()
                    toks, dt, out = await spec_run(engine, prompts, BENCH_OSL, temp)
                    snap = spec_metrics.snapshot()
                    captured = sum(engine.compile_counts().values()) - sum(before.values())
                    res[(kind, mode)] = dict(tok_s=toks / dt, tokens=toks, wall=dt,
                                             launches=kernel_counts(), noise=noise_launches(),
                                             captured=captured, **snap)
                    streams[(kind, mode)] = out
                    log(f"spec {kind}/{mode}: {n} requests, {toks} tokens in {dt:.3f} s "
                        f"({toks / dt:.2f} tok/s), acceptance {snap['acceptance_rate']:.3f}, "
                        f"tokens/dispatch {snap['tokens_per_dispatch']:.2f}, verification "
                        f"dispatches {int(snap['dispatches_total'])}, fallbacks "
                        f"{int(snap['fallback_total'])}, launches {res[(kind, mode)]['launches']}, "
                        f"noise kernel launches {res[(kind, mode)]['noise']}, graphs captured in "
                        f"the timed pass {captured}")
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
    # The sampled (random) passes draw their noise from the threefry kernel;
    # the all-greedy (repetitive) passes do no key work at all.
    noise_ok = all(res[("random", m)]["noise"] > 0 and res[("repetitive", m)]["noise"] == 0
                   for m in ("off", "on"))
    forced_ok = all(res[(k, "forced")]["ok"] for k in ("repetitive", "random"))
    ok = ok and launched and forced_ok and noise_ok
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
    log(f"spec: both kernels launched in every timed pass {launched}; the noise kernel in the "
        f"sampled passes only {noise_ok}; verification dispatches "
        f"on the repetitive traffic {int(rep['dispatches_total'])}, acceptance "
        f"{rep['acceptance_rate']:.3f}, tokens/dispatch {rep['tokens_per_dispatch']:.2f}; output "
        f"tokens whose bigram was already in the history {hits} of {n * BENCH_OSL} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, res


# ------------------------------------------------- h. the distributed serving path

DIST_MODEL = "llama-3.1-8b"
DIST_ENDPOINT = "dyn://dynamo.TorchWorker.generate"
# Phase 6's geometry, as CLI flags (seed 0 is the CLI's default, so both
# workers draw identical weights).
DIST_ENGINE_ARGV = [
    "out=torch", "--arch", "llama-3.1-8b", "--model", DIST_MODEL, "--dtype", "bfloat16",
    "--block-size", "16", "--num-blocks", "2048", "--max-batch", "16",
    "--max-model-len", "4096", "--prefill-chunk", "512", "--decode-steps", "8",
    "--pipeline-depth", "2",
]
DIST_PROMPTS, DIST_ISL, DIST_OSL = 8, 1024, 64
DIST_REPEAT_NEW, DIST_REPEAT_OSL = 32, 8
DIST_TURNS, DIST_TURN_PROMPTS = 3, 4
DIST_LOAD, DIST_LOAD_MIN_PER_WORKER = 16, 4
DIST_LOAD_ISL = (512, 2048)
DIST_FAILOVER, DIST_KILL_AFTER = 4, 8
DIST_LEASE_TTL_S = 10.0  # the runtime's DEFAULT_LEASE_TTL
DIST_HASH_IDS, DIST_HASH_CALLS = 2048, 50
DIST_VOCAB = 128000  # prompt ids are drawn below this


class Child:
    """A CLI subprocess of this checkout; its output lines are collected by
    a thread (the pipe never fills) and searched with ``wait_line``."""

    def __init__(self, name, argv, env=None):
        self.name = name
        self.p = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.cli", *argv],
                                  cwd=str(REPO), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=None if env is None else {**os.environ, **env})
        self.lines = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_line(self, prefix, timeout):
        end = time.time() + timeout
        while time.time() < end:
            for line in self.lines:
                if line.startswith(prefix):
                    return line
            if self.p.poll() is not None:
                break
            time.sleep(0.1)
        raise RuntimeError(f"{self.name}: no {prefix!r} line; last output {self.lines[-15:]}")

    def stop(self, sig=signal.SIGTERM):
        if self.p.poll() is None:
            self.p.send_signal(sig)
            try:
                self.p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait(timeout=30)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_prompts(n, isl, seed):
    rng = random.Random(seed)
    return [[rng.randrange(1, DIST_VOCAB) for _ in range(isl)] for _ in range(n)]


def dist_text(tokens):
    """The text the edge streams for ``tokens`` of a ``max_tokens`` =
    len(tokens) request (the Backend's Decoder over the byte tokenizer:
    text held back at the length limit is not sent)."""
    from dynamo_tpu_torch.llm.backend import Decoder
    from dynamo_tpu_torch.llm.protocols import StopConditions
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    dec = Decoder(ByteTokenizer(), StopConditions(max_tokens=len(tokens), ignore_eos=True))
    text = []
    for t in tokens:
        delta, finish = dec.step(t)
        text.append(delta)
        if finish is not None:
            break
    return "".join(text)


async def dist_engine_alone(engine, prompt, n):
    """``prompt`` served alone on the colocated engine, under a KV salt so
    that it neither hits nor leaves a prefix the router could match.
    Returns (tokens, ttft_s, itl_s)."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    req = PreprocessedRequest(
        token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
        annotations={"kv_salt": "colocated-reference"},
    ).to_dict()
    t0 = time.perf_counter()
    toks, stamps = [], []
    async for item in await engine.generate(Context(req)):
        now = time.perf_counter() - t0
        for tok in item["token_ids"]:
            toks.append(tok)
            stamps.append(now)
    return toks, stamps[0], (stamps[-1] - stamps[0]) / max(1, len(stamps) - 1)


async def dist_complete(port, prompt, max_tokens, on_text=None, temperature=0, seed=None,
                        logprobs=None):
    """A streamed completion (greedy unless ``temperature``; with
    ``logprobs`` every token's chunk is sent, text or not); returns
    (status, text, finish, usage tokens, ttft_s, itl_s, longest gap between
    content chunks in s).  ``on_text(text so far)`` runs on every chunk."""
    text = []
    stamps = []

    def on_event(t, ev):
        if not ev.startswith("data: ") or ev == "data: [DONE]":
            return
        c = json.loads(ev[len("data: "):])
        for ch in c.get("choices") or []:
            if ch.get("text"):
                text.append(ch["text"])
                stamps.append(t)
        if on_text is not None:
            on_text("".join(text))

    body = {"model": DIST_MODEL, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": temperature, "stream": True, "nvext": {"ignore_eos": True}}
    if seed is not None:
        body["seed"] = seed
    if logprobs is not None:
        body["logprobs"] = logprobs
    st, _, body, events = await http_call(port, "POST", "/v1/completions", body,
                                          on_event=on_event)
    finish, used = None, None
    try:
        chunks, _ = sse_data(events)
        final = chunks[-1][1] if chunks else {}
        finish = (final.get("choices") or [{}])[0].get("finish_reason")
        used = (final.get("usage") or {}).get("completion_tokens")
    except ValueError:
        pass
    ttft = stamps[0] if stamps else float("nan")
    itl = (stamps[-1] - stamps[0]) / max(1, max_tokens - 1) if stamps else float("nan")
    gap = max((b - a for a, b in zip(stamps, stamps[1:])), default=float("nan"))
    return st, "".join(text), finish, used, ttft, itl, gap


async def dist_colocated_http(engine, prompts):
    """``prompts`` one at a time through an HttpService on ``engine``'s own
    loop (preprocessor → backend → engine, no hop); (TTFT ms, ITL ms)."""
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline

    tok = ByteTokenizer()
    service = await HttpService(host="127.0.0.1", port=0).start()
    service.models.add_completion_model(
        DIST_MODEL, build_pipeline([OpenAIPreprocessor(tok, DIST_MODEL), Backend(tok)], engine))
    ttft, itl = [], []
    try:
        for p in prompts:
            r = await dist_complete(service.port, p, DIST_OSL)
            ttft.append(r[4] * 1e3)
            itl.append(r[5] * 1e3)
    finally:
        await service.close()
    return ttft, itl


def dist_path(torch):
    """Phase h: the README's distributed stack on the card.  Returns (ok,
    launches, numbers)."""
    from dynamo_tpu_torch import tokens as tok_mod
    from dynamo_tpu_torch.llm.kv_router.router import KvRouterCore
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.transports.hub import HubClient

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"dist check FAILED: {what}")

    hub_port = _free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    children, server = [], None
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    t_phase = time.perf_counter()
    try:
        children.append(Child("hub", ["hub", "--host", "127.0.0.1", "--port", str(hub_port)]))
        children[-1].wait_line("hub listening", 120)
        worker_b = Child("worker B", ["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV,
                                      "--hub", hub_addr])
        children.append(worker_b)
        fronts = {}
        for router in ("kv", "round_robin"):
            c = Child(f"http {router}", ["http", "--hub", hub_addr, "--host", "127.0.0.1",
                                         "--port", "0", "--router", router])
            children.append(c)
            fronts[router] = c
        for router, c in fronts.items():
            fronts[router] = int(c.wait_line("OpenAI frontend on", 120).rsplit(":", 1)[1])
        # Worker A: the CLI's own ``run in=dyn://`` code in this process,
        # so its kernel launches are counted; warmed before any traffic.
        t = time.perf_counter()
        server = CliServer(["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV, "--hub", hub_addr])
        wid_a = server.service.worker_id
        graphs = server.warmup()
        out["a_up_s"] = time.perf_counter() - t
        wid_b = int(worker_b.wait_line("worker ", 300).split()[1])
        out["b_up_s"] = time.perf_counter() - t_phase
        engine = server.engine
        log(f"dist: hub {hub_addr}, frontends kv :{fronts['kv']} round_robin "
            f":{fronts['round_robin']}, worker A {wid_a} (in this process, up and warmed in "
            f"{out['a_up_s']:.1f} s, graphs {graphs}), worker B {wid_b} (pid {worker_b.p.pid}, "
            f"registered {out['b_up_s']:.1f} s after the phase began)")
        name = {wid_a: "A", wid_b: "B"}

        # The router's hot path on this host: fast_sequence_hashes at 2048
        # ids, on the path this host takes and on the numpy one (the path
        # without xxhash).
        ids = dist_prompts(1, DIST_HASH_IDS, 3)[0]
        out["hash_path"] = "xxhash" if tok_mod.USING_XXHASH else "numpy lanes + Python chain"
        installed = tok_mod.USING_XXHASH
        for key, flag in (("hash_ms", installed), ("hash_numpy_ms", False)):
            tok_mod.USING_XXHASH = flag
            times = []
            try:
                for _ in range(DIST_HASH_CALLS):
                    t = time.perf_counter()
                    tok_mod.fast_sequence_hashes(ids, PS)
                    times.append(time.perf_counter() - t)
            finally:
                tok_mod.USING_XXHASH = installed
            out[key] = statistics.median(times) * 1e3

        prompts = dist_prompts(DIST_PROMPTS, DIST_ISL, 11)

        async def phase():
            rt = await DistributedRuntime.connect(hub_addr)
            hub = rt.hub
            ns, comp, ep = parse_endpoint_path(DIST_ENDPOINT)
            endpoint = rt.namespace(ns).component(comp).endpoint(ep)
            client = await endpoint.client()
            # A router core of this process on the same event stream: its
            # index is what the kv frontend's holds, and can be read here.
            core = await KvRouterCore(endpoint.component, client, PS,
                                      publish_hit_rate=False).start()
            hits = await endpoint.component.subscribe("kv-hit-rate")
            kv_sub = await endpoint.component.subscribe("kv_events")
            fpm_sub = await endpoint.component.subscribe("kv_metrics")
            stored = {wid_a: set(), wid_b: set()}
            latest = {}

            async def pump_events():
                async for _, msg in kv_sub:
                    data = (msg.get("event") or {}).get("data") or {}
                    for blk in (data.get("stored") or {}).get("blocks", ()):
                        stored.setdefault(msg["worker_id"], set()).add(blk["block_hash"])

            async def pump_metrics():
                async for _, msg in fpm_sub:
                    latest[msg["worker_id"]] = msg["metrics"]

            tasks = [asyncio.ensure_future(pump_events()), asyncio.ensure_future(pump_metrics())]

            async def next_hit():
                _, h = await asyncio.wait_for(hits.__anext__(), 120)
                return h

            try:
                for _ in range(600):
                    if set(client.instance_ids) == {wid_a, wid_b}:
                        break
                    await asyncio.sleep(0.1)
                check(set(client.instance_ids) == {wid_a, wid_b},
                      f"both workers discovered ({client.instance_ids})")
                core.select(prompts[0])  # the core learns the live set
                kv, rr = fronts["kv"], fronts["round_robin"]
                st, _, body, _ = await http_call(kv, "GET", "/health")
                health = json.loads(body) if st == 200 else {}
                check(health.get("hub_shards") == [{"shard": hub_addr, "connected": True}],
                      f"/health hub_shards ({st} {body[:200]!r})")

                # The colocated references, served alone before any traffic.
                refs = [await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    dist_engine_alone(engine, p, DIST_OSL), server.loop)) for p in prompts]
                # The same traffic through a colocated HTTP edge on A's
                # engine (fresh prompts of the same length, one at a time):
                # the distributed path's cost over it is the hop's.
                colocated = asyncio.run_coroutine_threadsafe(
                    dist_colocated_http(engine, dist_prompts(DIST_PROMPTS, DIST_ISL, 13)),
                    server.loop)
                out["colocated_http_ttft_ms"], out["colocated_http_itl_ms"] = (
                    await asyncio.wrap_future(colocated))
                # Warm B's programs (it captures at first use) and both
                # workers' paths: the round-robin frontend alternates.
                warm = dist_prompts(4, DIST_ISL, 5)
                for p in warm:
                    await dist_complete(rr, p, DIST_OSL)
                await asyncio.sleep(1.5)

                graphs0 = dict(engine.compile_counts())
                zero_kernel_counts()
                torch.cuda.synchronize = counting_sync
                t_traffic = time.perf_counter()

                # 1. prefix routing: first passes, then each prefix again.
                first, first_ttft, first_itl = [], [], []
                for i, p in enumerate(prompts):
                    st, text, fin, used, ttft, itl, _ = await dist_complete(kv, p, DIST_OSL)
                    h = await next_hit()
                    first.append(h["worker_id"])
                    first_ttft.append(ttft)
                    first_itl.append(itl)
                    check(st == 200 and fin == "length" and used == DIST_OSL,
                          f"first pass {i}: {st} {fin}/{used}")
                    ref_toks = refs[i][0]
                    same_text = text == dist_text(ref_toks)
                    # The sealed blocks of prompt + output (the last token
                    # is never fed back) name the output ids through their
                    # chained hashes; wait for the worker's last events.
                    chain = set(tok_mod.fast_sequence_hashes(p + ref_toks[:DIST_OSL - 1], PS))
                    for _ in range(50):
                        if chain <= stored.get(h["worker_id"], set()):
                            break
                        await asyncio.sleep(0.1)
                    same_chain = chain <= stored.get(h["worker_id"], set())
                    check(same_text and same_chain,
                          f"first pass {i} on {name.get(h['worker_id'])}: identical to the "
                          f"colocated stream (text {same_text}, sealed chain of "
                          f"{len(chain)} blocks {same_chain})")
                before_b = (latest.get(wid_b) or {}).get("gpu_prefix_cache_hit_rate", 0.0)
                repeats = []
                for i, p in enumerate(prompts):
                    a0 = engine.kv.matched_blocks
                    rp = p + dist_prompts(1, DIST_REPEAT_NEW, 100 + i)[0]
                    st, _, fin, used, ttft, _, _ = await dist_complete(kv, rp, DIST_REPEAT_OSL)
                    h = await next_hit()
                    repeats.append((h["worker_id"], h["overlap_blocks"], ttft))
                    gained = engine.kv.matched_blocks - a0
                    check(st == 200 and h["worker_id"] == first[i]
                          and h["overlap_blocks"] >= DIST_ISL // PS,
                          f"repeat {i}: routed to {name.get(h['worker_id'])} with "
                          f"{h['overlap_blocks']} blocks (first pass on {name.get(first[i])})")
                    if first[i] == wid_a:
                        check(gained >= DIST_ISL // PS, f"repeat {i}: A's prefix hits +{gained}")
                    else:
                        check(gained == 0, f"repeat {i}: A's prefix hits unchanged ({gained})")
                if wid_b in first:
                    await asyncio.sleep(1.5)  # one metrics period
                    after_b = (latest.get(wid_b) or {}).get("gpu_prefix_cache_hit_rate", 0.0)
                    check(after_b > before_b, f"B's prefix hit rate rose ({before_b} -> {after_b})")
                out["first"] = [name.get(w) for w in first]
                out["first_ttft_ms"] = [x * 1e3 for x in first_ttft]
                out["first_itl_ms"] = [x * 1e3 for x in first_itl]
                out["repeats"] = [(name.get(w), o, t * 1e3) for w, o, t in repeats]
                out["colocated_ttft_ms"] = [r[1] * 1e3 for r in refs]
                out["colocated_itl_ms"] = [r[2] * 1e3 for r in refs]

                # Repeat TTFT, kv against round_robin, on fresh prefixes.
                turns = []
                for turn in range(DIST_TURNS):
                    fresh = dist_prompts(DIST_TURN_PROMPTS, DIST_ISL, 200 + turn)
                    for p in fresh:
                        await dist_complete(kv, p, 1)
                        await next_hit()
                    ttfts = {"kv": [], "round_robin": []}
                    order = ("round_robin", "kv") if turn % 2 == 0 else ("kv", "round_robin")
                    for router in order:
                        for j, p in enumerate(fresh):
                            rp = p + dist_prompts(1, DIST_REPEAT_NEW, 300 + 10 * turn + j)[0]
                            r = await dist_complete(fronts[router], rp, DIST_REPEAT_OSL)
                            check(r[0] == 200, f"turn {turn} {router} repeat {j}: {r[0]}")
                            ttfts[router].append(r[4] * 1e3)
                            if router == "kv":
                                await next_hit()
                    turns.append({k: statistics.median(v) for k, v in ttfts.items()})
                out["turns"] = turns

                # 2. load: concurrent streams of 512-2048 ids.
                await asyncio.sleep(1.5)  # idle metrics before the burst
                rng = random.Random(21)
                load = [dist_prompts(1, rng.randrange(DIST_LOAD_ISL[0], DIST_LOAD_ISL[1] + 1), 400 + i)[0]
                        for i in range(DIST_LOAD)]
                t = time.perf_counter()
                results = await asyncio.gather(*(dist_complete(kv, p, DIST_OSL) for p in load))
                out["load_wall_s"] = time.perf_counter() - t
                load_hits = [await next_hit() for _ in load]
                per = {n: sum(1 for h in load_hits if h["worker_id"] == w) for w, n in name.items()}
                out["load_per_worker"] = per
                out["load_tok_s"] = DIST_LOAD * DIST_OSL / out["load_wall_s"]
                for i, r in enumerate(results):
                    check(r[0] == 200 and r[2] == "length" and r[3] == DIST_OSL,
                          f"load stream {i}: {r[0]} {r[2]}/{r[3]}")
                check(all(v >= DIST_LOAD_MIN_PER_WORKER for v in per.values()),
                      f"each worker took at least {DIST_LOAD_MIN_PER_WORKER} streams ({per})")
                out["launches"] = kernel_counts()
                out["traffic_s"] = time.perf_counter() - t_traffic

                # 3. failover: streams whose prefixes live on B (by the
                # index), one greedy stream each; B is killed mid-stream.
                def on_b(p):
                    scores = core.indexer.find_matches(p).scores
                    return scores.get(wid_b, 0) >= len(p) // PS - 1 and not scores.get(wid_a)

                victims = [p for p in load + prompts if on_b(p)][:DIST_FAILOVER]
                check(len(victims) == DIST_FAILOVER, f"{len(victims)} prefixes on B to fail over")
                b_blocks = len(core.indexer._index._by_worker.get(wid_b, ()))
                st, _, body, _ = await http_call(kv, "GET", "/metrics")
                resumes0 = parse_prometheus(body.decode()).get(
                    ("dynamo_tpu_resilience_stream_resumes_total", ()), 0.0)
                glyphs = [0] * len(victims)
                killed = {}

                def on_text(i):
                    def f(text):
                        glyphs[i] = len(text)
                        if not killed and min(glyphs) >= DIST_KILL_AFTER:
                            worker_b.p.send_signal(signal.SIGKILL)
                            killed["at"] = time.monotonic()
                            killed["glyphs"] = list(glyphs)
                    return f

                ref_fail = [await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    dist_engine_alone(engine, p, DIST_OSL), server.loop)) for p in victims]
                t = time.perf_counter()
                fo = await asyncio.gather(*(dist_complete(kv, p, DIST_OSL, on_text(i))
                                            for i, p in enumerate(victims)))
                out["failover_wall_s"] = time.perf_counter() - t
                fo_hits = [await next_hit() for _ in victims]
                check(all(h["worker_id"] == wid_b for h in fo_hits),
                      f"the failover streams were routed to B "
                      f"({[name.get(h['worker_id']) for h in fo_hits]})")
                check(bool(killed), "B was killed mid-stream")
                for i, r in enumerate(fo):
                    check(r[0] == 200 and r[2] == "length" and r[3] == DIST_OSL,
                          f"failover stream {i}: {r[0]} {r[2]}/{r[3]}")
                out["failover_identical"] = [r[1] == dist_text(ref[0])
                                             for r, ref in zip(fo, ref_fail)]
                # The resume's stall as the client sees it: each stream's
                # longest wait between content chunks (B's death, the
                # re-dispatch, A's prefill of prompt + delivered tokens).
                out["failover_gap_ms"] = [r[6] * 1e3 for r in fo]
                out["failover_kill_glyphs"] = killed.get("glyphs")
                st, _, body, _ = await http_call(kv, "GET", "/metrics")
                resumes1 = parse_prometheus(body.decode()).get(
                    ("dynamo_tpu_resilience_stream_resumes_total", ()), 0.0)
                out["resumes"] = resumes1 - resumes0
                check(resumes1 - resumes0 == DIST_FAILOVER,
                      f"/metrics stream resumes rose by {DIST_FAILOVER} ({resumes0} -> {resumes1})")
                out["graphs"] = (graphs0, dict(engine.compile_counts()))
                out["syncs"] = syncs[0]
                torch.cuda.synchronize = real_sync
                # B leaves discovery within the lease TTL plus 1 s.
                gone = None
                while killed and time.monotonic() - killed["at"] < DIST_LEASE_TTL_S + 5:
                    keys = await hub.kv_get_prefix(f"instances/{ns}/{comp}/{ep}/")
                    if not any(k.endswith(f"/{wid_b}") for k in keys):
                        gone = time.monotonic() - killed["at"]
                        break
                    await asyncio.sleep(0.1)
                out["b_gone_s"] = gone
                check(gone is not None and gone <= DIST_LEASE_TTL_S + 1,
                      f"B left discovery within {DIST_LEASE_TTL_S + 1} s of the kill ({gone})")
                for _ in range(50):
                    if wid_b not in client.instance_ids:
                        break
                    await asyncio.sleep(0.1)
                core.select(victims[0])  # the router prunes departed workers here
                left = len(core.indexer._index._by_worker.get(wid_b, ()))
                out["b_index_blocks"] = (b_blocks, left)
                check(b_blocks > 0 and left == 0,
                      f"the router index holds no block of B afterwards ({b_blocks} -> {left})")
                r = await dist_complete(kv, victims[0], 8)
                h = await next_hit()
                check(r[0] == 200 and h["worker_id"] == wid_a,
                      f"after B left, its prefix routes to A ({r[0]}, {name.get(h['worker_id'])})")
            finally:
                torch.cuda.synchronize = real_sync
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                for sub in (hits, kv_sub, fpm_sub):
                    await sub.aclose()
                await core.stop()
                await client.close()
                await rt.close()

        asyncio.run(phase())
    finally:
        torch.cuda.synchronize = real_sync
        try:
            if server is not None:
                server.stop()
        finally:
            for c in reversed(children):
                c.stop()
    launches = out.get("launches") or {"decode_attention": 0, "prefill_attention": 0}
    check(all(v > 0 for v in launches.values()), f"worker A launched both kernels ({launches})")
    g0, g1 = out.get("graphs", ({}, {}))
    check(g0 == g1, f"worker A captured no graph while serving ({g0} -> {g1})")
    check(out.get("syncs") == 0, f"no torch.cuda.synchronize on worker A while serving "
                                 f"({out.get('syncs')})")
    out["wall_s"] = time.perf_counter() - t_phase

    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    numbers = {
        "card": CARD, "hash_ms_2048_ids": out.get("hash_ms"), "hash_path": out.get("hash_path"),
        "hash_numpy_ms_2048_ids": out.get("hash_numpy_ms"),
        "colocated_http_ttft_ms_p50": med(out.get("colocated_http_ttft_ms", [])),
        "colocated_http_itl_ms_p50": med(out.get("colocated_http_itl_ms", [])),
        "first_pass_workers": out.get("first"),
        "first_pass_ttft_ms_p50": med(out.get("first_ttft_ms", [])),
        "first_pass_itl_ms_p50": med(out.get("first_itl_ms", [])),
        "colocated_alone_ttft_ms_p50": med(out.get("colocated_ttft_ms", [])),
        "colocated_alone_itl_ms_p50": med(out.get("colocated_itl_ms", [])),
        "repeats": out.get("repeats"), "repeat_ttft_turns_ms": out.get("turns"),
        "load_tok_s": out.get("load_tok_s"), "load_per_worker": out.get("load_per_worker"),
        "failover_resumes": out.get("resumes"),
        "failover_identical": out.get("failover_identical"),
        "failover_wall_s": out.get("failover_wall_s"),
        "failover_gap_ms": out.get("failover_gap_ms"),
        "failover_kill_glyphs": out.get("failover_kill_glyphs"), "b_gone_s": out.get("b_gone_s"),
        "b_index_blocks": out.get("b_index_blocks"), "launches_a": launches,
        "graphs_a": out.get("graphs"), "syncs_a": out.get("syncs"),
        "phase_s": out["wall_s"],
    }
    log("dist " + json.dumps(numbers))
    return not fails, launches, numbers


DISAGG_PREFILL_ENDPOINT = "dyn://dynamo.TorchWorker.prefill"
DISAGG_THRESHOLD = 512  # --max-local-prefill of the decode worker
DISAGG_ISL = 2040  # 127 full blocks and an 8-id tail: D prefills the tail
DISAGG_OSL = 64
DISAGG_PROMPTS, DISAGG_LIVE, DISAGG_OVERLAP, DISAGG_WARM = 8, 4, 4, 2
DISAGG_LONG_ISL, DISAGG_LONG_OSL = 256, 1536  # the stream decoding under the imports
DISAGG_CHECK_BLOCK = 100  # the block whose pages are held bitwise
DISAGG_CHUNK_RE = re.compile(r"next chunk to \S+: (\d+) blocks")


def disagg_path(torch):
    """Phase i: the README's disaggregated deployment on the card.  Returns
    (ok, launches, numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.integrity import block_checksum
    from dynamo_tpu_torch.engine.transfer import transfer_blocks_device
    from dynamo_tpu_torch.llm.disagg import KV_IMPORT_ENDPOINT, DisaggConfig, publish_config
    from dynamo_tpu_torch.llm.metrics import kv_integrity_metrics
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.client import Client
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.engine import Context, collect
    from dynamo_tpu_torch.runtime.faultinject import faults
    from dynamo_tpu_torch.tokens import hash_token_blocks

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"disagg check FAILED: {what}")

    hub_port = _free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    children, server, prefill = [], None, None
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    def on_d(coro, timeout=600):
        """Run ``coro`` on D's event loop (its engine's locks live there)."""
        return asyncio.run_coroutine_threadsafe(coro, server.loop).result(timeout)

    async def alone(engine, prompt, n, salt=None):
        req = PreprocessedRequest(
            token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
            annotations={"kv_salt": salt} if salt else {},
        ).to_dict()
        return [t for item in await collect(await engine.generate(Context(req)))
                for t in item["token_ids"]]

    t_phase = time.perf_counter()
    try:
        children.append(Child("hub", ["hub", "--host", "127.0.0.1", "--port", str(hub_port)]))
        children[-1].wait_line("hub listening", 120)
        front = Child("http", ["http", "--hub", hub_addr, "--host", "127.0.0.1", "--port", "0"])
        children.append(front)
        prefill = Child("prefill worker P", ["run", f"in={DISAGG_PREFILL_ENDPOINT}",
                                             *DIST_ENGINE_ARGV, "--hub", hub_addr,
                                             "--disagg", "prefill"])
        children.append(prefill)
        fport = int(front.wait_line("OpenAI frontend on", 120).rsplit(":", 1)[1])
        # D: the CLI's own ``--disagg decode`` code in this process, so its
        # kernel launches are counted; warmed before any traffic.
        t = time.perf_counter()
        server = CliServer(["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV, "--hub", hub_addr,
                            "--disagg", "decode", "--max-local-prefill", str(DISAGG_THRESHOLD)])
        graphs = server.warmup()
        out["d_up_s"] = time.perf_counter() - t
        engine = server.engine
        wid_p = int(prefill.wait_line("worker ", 300).split()[1])
        out["p_up_s"] = time.perf_counter() - t_phase
        log(f"disagg: hub {hub_addr}, frontend :{fport}, decode worker D "
            f"{server.service.worker_id} (in this process, up and warmed in {out['d_up_s']:.1f} "
            f"s, graphs {graphs}), prefill worker P {wid_p} (pid {prefill.p.pid}, registered "
            f"{out['p_up_s']:.1f} s after the phase began)")

        prompts = dist_prompts(DISAGG_PROMPTS, DISAGG_ISL, 31)
        live = dist_prompts(2 * DISAGG_LIVE, DISAGG_ISL, 32)
        overlap = dist_prompts(DISAGG_OVERLAP, DISAGG_ISL, 33)
        fault_prompt = dist_prompts(1, DISAGG_ISL, 34)[0]
        warm = dist_prompts(DISAGG_WARM, DISAGG_ISL, 35)
        long_prompt = dist_prompts(1, DISAGG_LONG_ISL, 36)[0]
        chain0 = [tb.sequence_hash for tb in hash_token_blocks(prompts[0], PS)]
        salt = "disagg-reference"
        full = DISAGG_ISL // PS

        async def reference(p, hit_blocks=None, pages_of=None):
            """D's engine serving ``p`` alone, under a KV salt (no prefix
            the traffic could hit), in the shapes the path under test gives
            it (the card's GEMMs are not batch-invariant): with
            ``hit_blocks`` None one pass, prefilling the whole prompt in
            512-id chunks (local prefill); otherwise a first pass prefills
            it so in P's chunking and seals its blocks, those from
            ``hit_blocks`` on are evicted, and the stream then hits the
            rest and prefills the remainder (the remote path: all full
            blocks hit, the 8-id tail prefilled).  ``pages_of``: a block
            whose pages after the first pass are returned too."""
            pages = None
            if hit_blocks is not None:
                await alone(engine, p, 1, salt=salt)
                chain = [tb.sequence_hash for tb in hash_token_blocks(p, PS, salt)]
                if pages_of is not None:
                    pages = await block_pages(engine, chain[pages_of])
                engine.kv.evict_hashes(chain[hit_blocks:])
            return await alone(engine, p, DISAGG_OSL, salt=salt), pages

        refs = {}
        t = time.perf_counter()
        refs[tuple(prompts[0])], ref_pages = on_d(reference(prompts[0], full, DISAGG_CHECK_BLOCK))
        check(ref_pages is not None, "the reference block's pages were read")
        for p in prompts[1:] + live[DISAGG_LIVE:] + overlap:
            refs[tuple(p)] = on_d(reference(p, full))[0]
        for p in live[:DISAGG_LIVE]:
            refs[tuple(p)] = on_d(reference(p))[0]
        out["refs_s"] = time.perf_counter() - t

        async def phase():
            rt = await DistributedRuntime.connect(hub_addr)
            ns, comp, _ = parse_endpoint_path(DIST_ENDPOINT)
            stats_client = await rt.namespace(ns).component(comp).endpoint(
                "disagg_stats").client()
            await stats_client.wait_for_instances(30)

            async def stats():
                return (await collect(await stats_client.generate(Context({}))))[0]

            async def serve(p, n=DISAGG_OSL, what=""):
                r = await dist_complete(fport, p, n)
                check(r[0] == 200 and r[2] == "length" and r[3] == n,
                      f"{what}: {r[0]} {r[2]}/{r[3]}")
                return r

            def same(r, p, what):
                ok = r[1] == dist_text(refs[tuple(p)])
                check(ok, f"{what}: identical to D's local-prefill stream served alone")
                return ok

            try:
                for _ in range(300):
                    if (await rt.hub.kv_get_prefix("models/")):
                        break
                    await asyncio.sleep(0.1)
                # Warm P's programs (it captures at first use) through the
                # remote path.
                for p in warm:
                    await serve(p, 8, "warm-up")
                s0 = await stats()
                v0 = kv_integrity_metrics.verified_total["wire"]
                graphs0 = dict(engine.compile_counts())
                n_parts0 = len(engine.transfer_parts)
                zero_kernel_counts()
                torch.cuda.synchronize = counting_sync
                t_traffic = time.perf_counter()

                # 1. remote prefill, one prompt at a time.
                remote_ttft, remote_itl, identical = [], [], []
                for i, p in enumerate(prompts):
                    r = await serve(p, what=f"remote {i}")
                    remote_ttft.append(r[4] * 1e3)
                    remote_itl.append(r[5] * 1e3)
                    identical.append(same(r, p, f"remote {i}"))
                    if i == 0:
                        got = await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                            block_pages(engine, chain0[DISAGG_CHECK_BLOCK]), server.loop))
                        out["pages_equal"] = (
                            got is not None and ref_pages is not None
                            and block_checksum(got) == block_checksum(ref_pages)
                            and torch.equal(got.view(torch.uint8), ref_pages.view(torch.uint8)))
                        check(out["pages_equal"], f"imported block {DISAGG_CHECK_BLOCK}'s "
                                                  "pages bitwise equal to D's own")
                s1 = await stats()
                v1 = kv_integrity_metrics.verified_total["wire"]
                out["remote"] = {k: s1[k] - s0[k] for k in
                                 ("remote_prefills", "local_prefills", "degraded_fallbacks")}
                check(out["remote"] == {"remote_prefills": DISAGG_PROMPTS, "local_prefills": 0,
                                        "degraded_fallbacks": 0},
                      f"{DISAGG_PROMPTS} remote prefills, none local or degraded ({out['remote']})")
                out["wire_verified"] = v1 - v0
                check(v1 - v0 == DISAGG_PROMPTS * (DISAGG_ISL // PS),
                      f"wire-verified blocks {v1 - v0} == {DISAGG_PROMPTS} x {DISAGG_ISL // PS}")
                parts = list(engine.transfer_parts)[n_parts0:]
                out["chunks"] = [n for kind, n, _ in parts if kind == "inject"]
                out["inject_parts_ms"] = {
                    k: statistics.median(pp[k] for kind, _, pp in parts if kind == "inject") * 1e3
                    for k in ("parse", "verify", "upload", "hold")}
                out["remote_ttft_ms"], out["remote_itl_ms"] = remote_ttft, remote_itl

                # 2. the live threshold: 4096 (local), then back to 512.
                live_ttft = {"local": [], "remote": []}
                for j, (limit, kind) in enumerate(((4096, "local"), (DISAGG_THRESHOLD, "remote"))):
                    await publish_config(rt.hub, DIST_MODEL,
                                         DisaggConfig(max_local_prefill_length=limit))
                    await asyncio.sleep(0.5)  # the hub's watch delivers the new threshold
                    sa = await stats()
                    for p in live[j * DISAGG_LIVE:(j + 1) * DISAGG_LIVE]:
                        r = await serve(p, what=f"live {kind}")
                        live_ttft[kind].append(r[4] * 1e3)
                        same(r, p, f"live {kind}")
                    sb = await stats()
                    moved = (sb["remote_prefills"] - sa["remote_prefills"],
                             sb["local_prefills"] - sa["local_prefills"])
                    want = (0, DISAGG_LIVE) if kind == "local" else (DISAGG_LIVE, 0)
                    check(moved == want, f"threshold {limit}: (remote, local) {moved} == {want}")
                out["live_ttft_ms"] = live_ttft

                # 3. the overlap: imports while a long stream decodes.
                engine.step_trace.clear()
                long_task = asyncio.ensure_future(dist_complete(fport, long_prompt, DISAGG_LONG_OSL))
                await asyncio.sleep(1.0)
                for p in overlap:
                    r = await serve(p, what="overlap")
                    same(r, p, "overlap")
                long_done = long_task.done()
                lr = await long_task
                check(lr[0] == 200 and lr[3] == DISAGG_LONG_OSL, f"the long stream: {lr[0]} {lr[3]}")
                check(not long_done, "the long stream was still decoding after the imports")
                trace = list(engine.step_trace)
                kinds = [k for k, *_ in trace]
                inj = [i for i, k in enumerate(kinds) if k == "inject"]
                between = [k for k in kinds[inj[0]:inj[-1]] if k in ("decode_dispatch", "decode_wait")] \
                    if inj else []
                check(len(inj) >= DISAGG_OVERLAP and between,
                      f"decode dispatches between D's inject entries ({len(inj)} injects, "
                      f"{len(between)} decode entries between)")
                holds = [t for k, t, *_ in trace if k == "inject"]
                waits = [t for k, t, *_ in trace if k == "decode_wait"]
                out["overlap"] = {"injects": len(inj), "decode_between": len(between),
                                  "hold_ms_max": max(holds) * 1e3 if holds else None,
                                  "hold_ms_p50": statistics.median(holds) * 1e3 if holds else None,
                                  "decode_wait_ms_p50": statistics.median(waits) * 1e3 if waits else None,
                                  "fused_ms": engine.decode_spans.seconds * 1e3
                                  / max(1, engine.decode_spans.count)}

                # 4. the wire fault: a byte flipped in the second chunk.
                calls, armed = [0], {}
                inject = engine.inject_blocks

                async def faulty(tokens, payload, salt=None, donor=None):
                    calls[0] += 1
                    last = int(payload.get("start_block", 0)) + int(payload["n_blocks"]) >= \
                        DISAGG_ISL // PS
                    if not armed and (calls[0] == 2 or last):
                        armed["start"] = int(payload.get("start_block", 0))
                        faults.arm("kv_corrupt", match="wire", count=1)
                    return await inject(tokens, payload, salt, donor)

                engine.inject_blocks = faulty
                refs.pop(tuple(fault_prompt), None)
                wire_key = ("dynamo_tpu_kv_integrity_corrupt_total", (("plane", "wire"),))
                c0 = kv_integrity_metrics.corrupt_total["wire"]
                mc0 = parse_prometheus(kv_integrity_metrics.render()).get(wire_key)
                m0 = engine.kv.matched_blocks
                try:
                    r = await serve(fault_prompt, what="wire fault")
                finally:
                    engine.inject_blocks = inject
                    faults.reset()
                prefix = engine.kv.matched_blocks - m0
                fault_stream = r
                # The integrity group as this process's /metrics renders it.
                mc1 = parse_prometheus(kv_integrity_metrics.render()).get(wire_key)
                out["fault"] = {"armed_at_block": armed.get("start"), "prefix_hit": prefix,
                                "corrupt": kv_integrity_metrics.corrupt_total["wire"] - c0,
                                "metrics_corrupt": None if mc0 is None else mc1 - mc0}
                check(out["fault"]["corrupt"] == 1 and prefix == armed.get("start"),
                      f"the wire fault: the verified prefix ({armed.get('start')} blocks) sealed "
                      f"and hit ({prefix}), one corruption counted ({out['fault']['corrupt']})")
                check(out["fault"]["metrics_corrupt"] == 1,
                      f"the wire corruption on the integrity /metrics group "
                      f"({out['fault']['metrics_corrupt']})")
                s2 = await stats()
                out["degraded_total"] = s2["degraded_fallbacks"] - s0["degraded_fallbacks"]
                check(out["degraded_total"] == 0, f"no degraded fallback ({out['degraded_total']})")
                out["launches"] = kernel_counts()
                out["graphs"] = (graphs0, dict(engine.compile_counts()))
                out["syncs"] = syncs[0]
                torch.cuda.synchronize = real_sync
                out["traffic_s"] = time.perf_counter() - t_traffic
                # The fault's reference (after the counted window): the
                # verified prefix hit, the rest prefilled.
                refs[tuple(fault_prompt)] = (await asyncio.wrap_future(
                    asyncio.run_coroutine_threadsafe(
                        reference(fault_prompt, armed.get("start", 0)), server.loop)))[0]
                same(fault_stream, fault_prompt, "wire fault")
                out["import_path"] = (await rt.hub.kv_get_prefix(
                    f"instances/{ns}/{comp}/{KV_IMPORT_ENDPOINT}/"))
            finally:
                torch.cuda.synchronize = real_sync
                await stats_client.close()
                await rt.close()

        asyncio.run(phase())
        # The largest chunk P's adaptive sizing reached, from its log.
        sizes = [int(m.group(1)) for line in prefill.lines
                 for m in [DISAGG_CHUNK_RE.search(line)] if m]
        out["p_chunk_sizes"] = sizes
        prefill.stop()

        # 5. the same-process direct path: P' beside D in this process.
        t = time.perf_counter()
        src = TorchEngine(EngineConfig(**SERVE_CFG), device=engine.device)
        out["p2_up_s"] = time.perf_counter() - t
        direct = dist_prompts(1, DISAGG_ISL, 37)[0]
        info = next(iter(out["import_path"].values()))

        async def direct_phase():
            await alone(src, direct, 1)
            chain = [tb.sequence_hash for tb in hash_token_blocks(direct, PS)]
            g0 = (dict(src.compile_counts()), dict(engine.compile_counts()))
            c0 = (src.copy_summary(), engine.copy_summary())
            torch.cuda.synchronize = counting_sync
            s0 = syncs[0]
            try:
                # Twice: cold (the first gather of this shape), then warm,
                # D's copy dropped in between.
                t_direct = []
                for _ in range(2):
                    engine.kv.evict_hashes(chain)
                    t0 = time.perf_counter()
                    covered = await transfer_blocks_device(src, engine, direct)
                    t_direct.append((time.perf_counter() - t0) * 1e3)
            finally:
                torch.cuda.synchronize = real_sync
            res = {"covered_blocks": covered // PS, "direct_ms": t_direct,
                   "syncs": syncs[0] - s0,
                   "graphs_same": g0 == (dict(src.compile_counts()), dict(engine.compile_counts()))}
            c1 = (src.copy_summary(), engine.copy_summary())
            res["host_bytes"] = sum(b[k] - a[k] for a, b in zip(c0, c1)
                                    for k in ("h2d_bytes", "d2h_bytes"))
            mism = 0
            for h in chain:
                a = await block_pages(src, h)
                b = await block_pages(engine, h)
                mism += int(a is None or b is None or not torch.equal(
                    a.view(torch.uint8), b.view(torch.uint8)))
            res["pages_mismatched"] = mism
            # The host-staged path for the same 127 blocks: P''s export,
            # then the wire into D's kv_import endpoint (codec and TCP),
            # then D's inject; D's copy dropped first.
            engine.kv.evict_hashes(chain)
            n0 = len(engine.transfer_parts)
            t0 = time.perf_counter()
            payload = await src.export_prompt_blocks(direct)
            t_export = time.perf_counter() - t0
            client = Client.static(info["address"], info["path"])
            t0 = time.perf_counter()
            acks = await collect(await client.generate(Context({
                "transfer_id": "direct-vs-host", "token_ids": list(direct),
                "payload": payload, "last": True})))
            t_wire_inject = time.perf_counter() - t0
            inj = [pp for kind, _, pp in list(engine.transfer_parts)[n0:] if kind == "inject"]
            exp = [pp for kind, _, pp in list(src.transfer_parts) if kind == "export"][-1]
            inject_s = sum(inj[-1].values()) if inj else float("nan")
            res.update(host_export_ms=t_export * 1e3,
                       host_export_parts_ms={k: v * 1e3 for k, v in exp.items()},
                       host_wire_ms=(t_wire_inject - inject_s) * 1e3,
                       host_inject_parts_ms={k: v * 1e3 for k, v in (inj[-1] if inj else {}).items()},
                       host_total_ms=(t_export + t_wire_inject) * 1e3,
                       host_acked_tokens=acks[0].get("tokens_covered") if acks else None,
                       payload_mib=2 * len(payload["k"]) / 2**20)
            await src.close()
            return res

        out["direct"] = on_d(direct_phase())
        d = out["direct"]
        check(d["covered_blocks"] == DISAGG_ISL // PS,
              f"direct transfer covered {d['covered_blocks']} blocks")
        check(d["pages_mismatched"] == 0, f"direct: pages bitwise equal "
                                          f"({d['pages_mismatched']} blocks differ)")
        check(d["host_bytes"] == 0, f"direct: no host bytes copied ({d['host_bytes']})")
        check(d["graphs_same"], "direct: no graph captured")
        check(d["syncs"] == 0, f"direct: no torch.cuda.synchronize ({d['syncs']})")
        check(d["host_acked_tokens"] == (DISAGG_ISL // PS) * PS,
              f"host-staged: D acked {d['host_acked_tokens']} tokens")
    finally:
        torch.cuda.synchronize = real_sync
        try:
            if server is not None:
                server.stop()
        finally:
            for c in reversed(children):
                c.stop()
    launches = out.get("launches") or {"decode_attention": 0, "prefill_attention": 0}
    check(all(v > 0 for v in launches.values()), f"D launched both kernels ({launches})")
    g0, g1 = out.get("graphs", ({}, {}))
    check(g0 == g1, f"D captured no graph while serving ({g0} -> {g1})")
    check(out.get("syncs") == 0, f"no torch.cuda.synchronize on D while serving "
                                 f"({out.get('syncs')})")
    out["wall_s"] = time.perf_counter() - t_phase

    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    live = out.get("live_ttft_ms", {})
    numbers = {
        "card": CARD, "remote": out.get("remote"), "wire_verified": out.get("wire_verified"),
        "pages_equal": out.get("pages_equal"),
        "remote_ttft_ms_p50": med(out.get("remote_ttft_ms", [])),
        "remote_itl_ms_p50": med(out.get("remote_itl_ms", [])),
        "live_local_ttft_ms_p50": med(live.get("local", [])),
        "live_remote_ttft_ms_p50": med(live.get("remote", [])),
        "chunks_at_d": out.get("chunks"), "p_chunk_sizes": out.get("p_chunk_sizes"),
        "inject_parts_ms_p50": out.get("inject_parts_ms"), "overlap": out.get("overlap"),
        "fault": out.get("fault"), "direct": out.get("direct"), "launches_d": launches,
        "graphs_d": out.get("graphs"), "syncs_d": out.get("syncs"),
        "d_up_s": out.get("d_up_s"), "p_up_s": out.get("p_up_s"), "phase_s": out["wall_s"],
    }
    log("disagg " + json.dumps(numbers))
    return not fails, launches, numbers


# ------------------------------ j. live migration, the prefix pull, the noise


NOISE_V = 128256  # llama-3.1-8b's vocabulary
NOISE_ROWS = (16, 256)  # a serve dispatch's rows and phase c/e's
NOISE_ULP = 2.0  # Gumbel values: within 2 ulp at the scale max(|g|, 1)
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
# Operations of one noise element: threefry-2x32's 20 rounds (add, rotate,
# xor: 3 each), 5 key injections (3 each) and the 2 counter adds, the xor of
# the halves, the uniform (shift, or, subtract, multiply-add, max) and the
# Gumbel (two logs, two negations).
NOISE_OPS = 20 * 3 + 5 * 3 + 2 + 1 + 5 + 4


def noise_launches():
    from dynamo_tpu_torch.ops import sampling as smp

    return smp.gumbel_noise_cuda.launches


def zero_noise_launches():
    from dynamo_tpu_torch.ops import sampling as smp

    smp.gumbel_noise_cuda.launches = 0


def check_noise_kernel(torch, dev, tally):
    """Phase j, part 1: csrc/threefry_gumbel.cu against its plain version
    at B = 16 and 256 over the llama-3.1-8b vocabulary, on ragged seeds and
    steps (0 and 2**32 - 1 among them): the uint32 bits exactly, the Gumbel
    values within NOISE_ULP ulp at the scale max(|g|, 1), and the sampled
    token of ``argmax(logits + g)`` on random logits; then timed (rounds of
    20 launches, L2 flushed) beside the plain version and the bound (the
    [B, V] f32 write against NOISE_OPS operations an element).  Returns
    {B: timings}."""
    from dynamo_tpu_torch.ops import sampling as smp

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for B in NOISE_ROWS:
        seeds = torch.randint(0, 2**32, (B,), generator=gen, device=dev, dtype=torch.int64)
        steps = torch.randint(0, 4096, (B,), generator=gen, device=dev, dtype=torch.int64)
        seeds[0], steps[0] = 2**32 - 1, 0
        seeds[1], steps[1] = 0, 2**32 - 1
        bits = torch.empty((B, NOISE_V), dtype=torch.int32, device=dev)
        got = smp.gumbel_noise_cuda(seeds, steps, NOISE_V, bits=bits)
        want_bits = smp.random_bits_plain(seeds, steps, NOISE_V)
        want = smp.gumbel_from_bits(want_bits)
        torch.cuda.synchronize()
        bits_ok = torch.equal(bits.to(torch.int64) & 0xFFFFFFFF, want_bits)
        scale = torch.maximum(want.abs(), torch.ones_like(want))
        ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
        ulps = float(((got.double() - want.double()).abs() / ulp.double()).max())
        err = float((got - want).abs().max())
        logits = torch.randn((B, NOISE_V), generator=gen, device=dev) * 3
        tokens_ok = torch.equal((logits + got).argmax(-1), (logits + want).argmax(-1))
        ok = bits_ok and ulps <= NOISE_ULP and tokens_ok and bool(torch.isfinite(got).all())
        tally.worst["threefry_gumbel"] = max(tally.worst["threefry_gumbel"], err)
        log(f"check threefry_gumbel B={B} V={NOISE_V}: bits equal {bits_ok}, gumbel "
            f"max_abs_err={err:.3e} ({ulps:.2f} ulp at max(|g|,1), tol {NOISE_ULP}), "
            f"categorical tokens equal {tokens_ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            tally.failures.append(f"threefry_gumbel B={B}")
        del bits, want_bits, want, scale, ulp, logits, got

        def kernel():
            return smp.gumbel_noise_cuda(seeds, steps, NOISE_V)

        def plain():
            return smp.gumbel_noise_plain(seeds, steps, NOISE_V)

        rounds = [cuda_ms(torch, kernel, 20, flush) for _ in range(TIMING_ROUNDS)]
        nbytes = B * NOISE_V * 4 + 2 * B * 8
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = B * NOISE_V * NOISE_OPS / F32_FLOPS * 1e3
        r = dict(ms=statistics.median(rounds), rounds=rounds, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 plain_ms=cuda_ms(torch, plain, 3, flush, spin=False), library_ms=None)
        log(f"time threefry_gumbel [B={B} V={NOISE_V}, int64 seeds/steps -> f32]: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library none (PyTorch has no "
            f"threefry), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {nbytes / 1e6:.1f} MB "
            f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = {t_bytes:.4f} ms, {NOISE_OPS} operations "
            f"an element at {F32_FLOPS / 1e12:.0f} TFLOP/s = {t_ops:.4f} ms); rounds "
            f"{[round(x, 4) for x in rounds]}")
        out[B] = r
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


MIGRATE_STREAMS, MIGRATE_ISL, MIGRATE_OSL, MIGRATE_AFTER = 4, 2048, 2040, 32
MIGRATE_TEMPERATURE = 0.7
MIGRATE_LOGPROBS = 1  # every token's chunk reaches the client: the stall is timed by token
MIGRATE_SEEDS = (None, None, 4242, 4343)  # 2 greedy, 2 seeded at MIGRATE_TEMPERATURE
MIGRATE_CHECK_BLOCKS = (0, 64)  # plus each stream's last full block B did not rewrite
DRAIN_STREAMS, DRAIN_OSL, DRAIN_AFTER = 2, 1024, 16
PULL_ISL, PULL_NEW, PULL_OSL = 2048, 32, 16
PULL_BUDGETS_MB = (64, 192)  # the EngineConfig default, then A's --kv-pull-mb 192
DISPATCH_PROMPTS, DISPATCH_ISL, DISPATCH_OSL = 4, 256, 64


def migrate_pull_path(torch, noise_times):
    """Phases j and k on one stack: live migration through the KV
    frontend, the cross-worker prefix pull and the drain through migration
    (j), and the bulk plane with its three consumers and the health
    watchdog (k, ``bulk_health_path``, before j's drain), on the README's
    distributed stack at phase 6's geometry with ``DYN_BULK_PLANE=1`` in
    every process: the hub, the KV frontend, worker B and an echo worker
    are CLI subprocesses; worker A runs the CLI's own ``run in=dyn://``
    code in this process (its launches counted), started with
    ``--kv-pull-mb 192``.  Phase j's transfers ride the service plane: A's
    two bulk producers (the puller's exporter, ``MigratableWorker.bulk``)
    are switched to it for j and to the bulk plane for k.  Returns
    ((ok, launches, numbers) of j, the same of k)."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.kv_router.pull import make_client_exporter
    from dynamo_tpu_torch.llm.metrics import kv_tier_metrics, migration_metrics
    from dynamo_tpu_torch.llm.migration import request_migrate_out, target_from_instance
    from dynamo_tpu_torch.llm.migration.worker import MigratableWorker
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.engine import Context, collect

    fails = []
    out = {"noise": {B: {k: v for k, v in r.items() if k != "rounds"}
                     for B, r in noise_times.items()}}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"migrate check FAILED: {what}")

    hub_port = _free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    children, server, stopped = [], None, []
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    # Harness instrumentation of A's migrations (this process): per stream
    # the wall of ``migrate_out``, its pushes (copy rounds, then the final
    # delta) and blocks, and the freeze's wait for quiescence.
    per_rid, current = {}, {}
    real_migrate_out, real_push = MigratableWorker.migrate_out, MigratableWorker._push_blocks

    async def timed_migrate_out(self, request_id, target):
        current["rid"] = request_id
        rec = per_rid.setdefault(request_id, {"pushes": 0, "blocks": 0})
        rec["t0"] = time.perf_counter()
        ok = await real_migrate_out(self, request_id, target)
        rec.update(t1=time.perf_counter(), ok=ok)
        return ok

    async def counted_push(self, target, tokens, cursor, salt=None, trace=None):
        n = await real_push(self, target, tokens, cursor, salt, trace)
        rec = per_rid.get(current.get("rid"))
        if rec is not None:
            rec["pushes"] += 1
            rec["blocks"] += n
        return n

    def request(prompt, n, temperature=0.0, seed=None, annotations=None, logprobs=None):
        return PreprocessedRequest(
            token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=temperature, seed=seed,
                                             logprobs=logprobs),
            annotations=dict(annotations or {}),
        ).to_dict()

    t_phase = time.perf_counter()
    MigratableWorker.migrate_out, MigratableWorker._push_blocks = timed_migrate_out, counted_push
    # Every process of the stack runs with the bulk plane (A reads it
    # when the CLI wires its worker, the children inherit it).
    env_bulk = os.environ.get("DYN_BULK_PLANE")
    os.environ["DYN_BULK_PLANE"] = "1"
    roles_seen, real_start_decode = [], cli.WorkerRoles.start_decode

    async def recording_start_decode(self, disagg):
        roles_seen.append(self)
        return await real_start_decode(self, disagg)

    cli.WorkerRoles.start_decode = recording_start_decode
    k_result = (False, None, {})
    import logging

    mig_log = logging.getLogger("dynamo_tpu_torch.llm.migration")
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("migration log: %(levelname)s %(message)s"))
    mig_log.addHandler(handler)
    mig_log.setLevel(logging.INFO)
    try:
        children.append(Child("hub", ["hub", "--host", "127.0.0.1", "--port", str(hub_port)]))
        children[-1].wait_line("hub listening", 120)
        # B's kv_export bulk fetches meet BULK_FAULT_SPEC's drops (phase k).
        worker_b = Child("worker B", ["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV,
                                      "--hub", hub_addr], env={"DYN_FAULTS": BULK_FAULT_SPEC})
        children.append(worker_b)
        front = Child("http kv", ["http", "--hub", hub_addr, "--host", "127.0.0.1", "--port",
                                  "0", "--router", "kv"])
        children.append(front)
        # The watchdog's third fleet member (phase k): an echo worker.
        echo = Child("echo worker", ["run", f"in={ECHO_ENDPOINT}", "out=echocore", "--hub",
                                     hub_addr, "--model", "echo"])
        children.append(echo)
        fport = int(front.wait_line("OpenAI frontend on", 120).rsplit(":", 1)[1])
        t = time.perf_counter()
        server = CliServer(["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV, "--hub", hub_addr,
                            "--kv-pull-mb", str(PULL_BUDGETS_MB[1])])
        wid_a = server.service.worker_id
        graphs = server.warmup()
        engine = server.engine
        out["a_up_s"] = time.perf_counter() - t
        wid_b = int(worker_b.wait_line("worker ", 300).split()[1])
        wid_echo = int(echo.wait_line("worker ", 120).split()[1])
        log(f"migrate: hub {hub_addr}, kv frontend :{fport}, worker A {wid_a} (in this "
            f"process, up and warmed in {out['a_up_s']:.1f} s, graphs {graphs}), worker B "
            f"{wid_b} (pid {worker_b.p.pid})")
        released, freezes = {}, {}
        real_finish, real_freeze = engine.finish_migrated, engine.freeze_sequence

        def recording_finish(request_id, item=None):
            released[request_id] = item
            return real_finish(request_id, item)

        async def timed_freeze(request_id, timeout=10.0):
            t0 = time.perf_counter()
            seq = await real_freeze(request_id, timeout)
            freezes[request_id] = (time.perf_counter() - t0) * 1e3
            return seq

        engine.finish_migrated, engine.freeze_sequence = recording_finish, timed_freeze
        # A's two bulk producers, and their service-plane counterparts.
        handles = roles_seen[0]._handles["decode"]
        mig_a = handles["mig"]
        puller_a = engine._prefix_puller
        planes = {"bulk": (mig_a.bulk, puller_a.exporter),
                  "service": (None, make_client_exporter(handles["pull_client"]))}

        def set_plane(name):
            mig_a.bulk, puller_a.exporter = planes[name]

        set_plane("service")

        async def on_a(coro):
            """Await ``coro`` on A's event loop (its engine lives there)."""
            return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(coro, server.loop))

        async def a_state(fn):
            async def read():
                return fn()
            return await on_a(read())

        async def alone(req):
            """``req`` on A's engine directly; its tokens."""
            return [t for item in await collect(await engine.generate(Context(req)))
                    for t in item.get("token_ids", [])]

        async def together(reqs):
            """``reqs`` on A's engine at once; their tokens."""
            return await asyncio.gather(*(alone(r) for r in reqs))

        async def phase():
            nonlocal k_result
            rt = await DistributedRuntime.connect(hub_addr)
            ns, comp, ep = parse_endpoint_path(DIST_ENDPOINT)
            endpoint = rt.namespace(ns).component(comp).endpoint(ep)
            client = await endpoint.client()
            export = await endpoint.component.endpoint("kv_export").client()

            async def direct(wid, req, first=None):
                """``req`` direct-routed to worker ``wid``: (tokens, TTFT s)."""
                t0 = time.perf_counter()
                toks, ttft = [], None
                async for item in await client.generate(Context(req), worker_id=wid):
                    if ttft is None and item.get("token_ids"):
                        ttft = time.perf_counter() - t0
                        if first is not None:
                            first.set()
                    toks += item.get("token_ids", [])
                return toks, ttft

            async def b_block(tokens, i):
                """Block ``i`` of ``tokens`` exported from B's kv_export."""
                items = await collect(await export.generate(Context(
                    {"token_ids": list(tokens), "start_block": i, "max_blocks": 1}),
                    worker_id=wid_b))
                return (items[0] or {}).get("payload") if items else None

            async def same_block(tokens, i):
                pa_ = await on_a(engine.export_prompt_blocks(list(tokens), start_block=i,
                                                             max_blocks=1))
                pb_ = await b_block(tokens, i)
                return (pa_ is not None and pb_ is not None
                        and int(pa_["n_blocks"]) == int(pb_["n_blocks"]) == 1
                        and pa_["k"] == pb_["k"] and pa_["v"] == pb_["v"])

            async def splices(name="migration_splices_total"):
                _, _, body, _ = await http_call(fport, "GET", "/metrics")
                return parse_prometheus(body.decode()).get(
                    (f"dynamo_tpu_resilience_{name}", ()), 0.0)

            async def wait_live(n, after):
                def enough():
                    rids = engine.live_request_ids()
                    seqs = [engine.find_sequence(r) for r in rids]
                    return len(rids) == n and all(
                        s is not None and s.num_output_tokens >= after for s in seqs)
                for _ in range(3000):
                    if await a_state(enough):
                        return True
                    await asyncio.sleep(0.01)
                return False

            async def verify_moved(rids, prompts, results, label, also=None):
                """Streams ``rids`` (of ``prompts``; ``results`` the
                client's) moved A -> B, against B: every cutover carried
                its resume request; the moved blocks are bitwise B's (the
                last full block of a resume that ends on a block boundary
                is rewritten at its last position by B's admission, so the
                block before it is taken); each stream equals its resume
                request served on B, submitted in cutover order once the
                previous one's first token is out (as the cutovers
                arrived).  ``also()`` runs beside those references.
                Returns (rids in cutover order, resumes, stream -> rid,
                equal per stream, what ``also`` returned)."""
                resumes = {rid: ((released.get(rid) or {}).get("migrated") or {}).get("request")
                           for rid in rids}
                check(all(resumes.values()), f"{label}: every cutover carried its resume request")
                order = sorted([r for r in rids if resumes.get(r)],
                               key=lambda r: per_rid.get(r, {}).get("t0", 0.0))
                by_prompt = {tuple(resumes[rid]["token_ids"][:MIGRATE_ISL]): rid for rid in order}
                stream_rid = [by_prompt.get(tuple(p)) for p in prompts]
                pages_ok = []
                for rid in order:
                    toks = resumes[rid]["token_ids"]
                    last = len(toks) // PS - (1 if len(toks) % PS else 2)
                    for i in (*MIGRATE_CHECK_BLOCKS, last):
                        pages_ok.append(await same_block(toks, i))
                check(bool(pages_ok) and all(pages_ok),
                      f"{label}: migrated blocks bitwise equal on B ({pages_ok})")
                firsts = []
                for rid in order:
                    ev = asyncio.Event()
                    firsts.append(asyncio.ensure_future(direct(wid_b, dict(resumes[rid]), ev)))
                    await asyncio.wait_for(ev.wait(), 120)
                extra = asyncio.ensure_future(also()) if also is not None else None
                refs = {rid: (await task)[0] for rid, task in zip(order, firsts)}
                extra = await extra if extra is not None else None
                same = []
                for i, r in enumerate(results):
                    rid = stream_rid[i]
                    if rid is not None:
                        full = resumes[rid]["token_ids"][MIGRATE_ISL:] + refs.get(rid, [])
                        same.append(len(full) == MIGRATE_OSL and r[1] == dist_text(full))
                check(len(same) == len(prompts) and all(same),
                      f"{label}: each stream equals its resume request served on B ({same})")
                return order, resumes, stream_rid, same, extra

            try:
                for _ in range(600):
                    if set(client.instance_ids) == {wid_a, wid_b}:
                        break
                    await asyncio.sleep(0.1)
                check(set(client.instance_ids) == {wid_a, wid_b},
                      f"both workers discovered ({client.instance_ids})")
                infos = {v["worker_id"]: v for v in
                         (await rt.hub.kv_get_prefix(f"instances/{ns}/{comp}/{ep}/")).values()}
                target_b = target_from_instance(infos.get(wid_b) or {})
                check(target_b is not None
                      and bool(((infos.get(wid_a) or {}).get("metadata") or {}).get("migrate")),
                      "both workers advertise migrate")

                # -- the sampler in a fused dispatch, on A's engine --------
                async def dispatch_ms(temperature):
                    spans = engine.decode_spans
                    s0, c0 = spans.seconds, spans.count
                    prompts = dist_prompts(DISPATCH_PROMPTS, DISPATCH_ISL, 60)
                    await together([request(p, DISPATCH_OSL, temperature,
                                            100 + i if temperature else None)
                                    for i, p in enumerate(prompts)])
                    return (spans.seconds - s0) / max(1, spans.count - c0) * 1e3, spans.count - c0

                # The first sampled pass captures the sampled programs' graphs;
                # the second of each is the one reported.
                n_disp = {}
                for temp in (0.0, MIGRATE_TEMPERATURE) * 2:
                    key = "dispatch_greedy_ms" if temp == 0.0 else "dispatch_sampled_ms"
                    out[key], n_disp[key] = await on_a(dispatch_ms(temp))
                n_g, n_s = n_disp["dispatch_greedy_ms"], n_disp["dispatch_sampled_ms"]
                log(f"migrate: a fused dispatch ({DISPATCH_PROMPTS} live rows of 16, 8 steps) "
                    f"greedy {out['dispatch_greedy_ms']:.3f} ms ({n_g} dispatches), sampled at "
                    f"temperature {MIGRATE_TEMPERATURE} {out['dispatch_sampled_ms']:.3f} ms "
                    f"({n_s}); the noise kernel at 16 rows {noise_times[16]['ms']:.4f} ms a step")

                # -- live migration through the KV frontend ----------------
                prompts = dist_prompts(MIGRATE_STREAMS, MIGRATE_ISL, 61)
                temps = [0.0 if s is None else MIGRATE_TEMPERATURE for s in MIGRATE_SEEDS]
                # A holds each prompt's blocks, so the router sends the
                # streams there, and has captured the programs this traffic
                # reaches (the same prompts, sampled and greedy, together).
                # Each alone twice (a prefill, then a prefix hit: greedy-only
                # and sampled-only steps and fused dispatches), then all
                # together (mixed ones).
                warm = [request(p, 40, temps[i], MIGRATE_SEEDS[i], logprobs=MIGRATE_LOGPROBS)
                        for i, p in enumerate(prompts)]
                for r in warm + warm:
                    await on_a(alone(r))
                await on_a(together(warm))
                # B captures its graphs at first use: the same traffic on
                # other prompts first, so the cutovers do not wait on
                # captures there.
                warm_b = [request(p, 40, temps[i], MIGRATE_SEEDS[i], logprobs=MIGRATE_LOGPROBS)
                          for i, p in enumerate(dist_prompts(MIGRATE_STREAMS, MIGRATE_ISL, 62))]
                for r in warm_b + warm_b:
                    await direct(wid_b, r)
                await asyncio.gather(*(direct(wid_b, r) for r in warm_b))
                await asyncio.sleep(1.5)  # the router's index takes A's events
                splices0 = await splices()
                migration_metrics.reset()
                graphs0 = dict(engine.compile_counts())
                zero_kernel_counts()
                zero_noise_launches()
                torch.cuda.synchronize = counting_sync
                stamps = [[] for _ in prompts]

                def on_text(i):
                    return lambda text: stamps[i].append(time.perf_counter())

                t_streams = time.perf_counter()
                streams = [asyncio.ensure_future(dist_complete(
                    fport, p, MIGRATE_OSL, on_text(i), temps[i], MIGRATE_SEEDS[i],
                    MIGRATE_LOGPROBS)) for i, p in enumerate(prompts)]
                check(await wait_live(MIGRATE_STREAMS, MIGRATE_AFTER),
                      f"the {MIGRATE_STREAMS} streams live on A with {MIGRATE_AFTER}+ tokens")
                rids = await a_state(lambda: list(engine.live_request_ids()))
                t_req = time.perf_counter()
                resp = await request_migrate_out(infos[wid_a], target_b)
                out["migrate_request_s"] = time.perf_counter() - t_req
                results = await asyncio.gather(*streams)
                out["streams_wall_s"] = time.perf_counter() - t_streams
                out["launches"] = {**kernel_counts(), "threefry_gumbel": noise_launches()}
                out["graphs"] = (graphs0, dict(engine.compile_counts()))
                out["syncs"] = syncs[0]
                torch.cuda.synchronize = real_sync
                check(resp.get("ok") and sorted(resp.get("migrated") or []) == sorted(rids)
                      and not resp.get("failed"), f"migrate_out moved all {len(rids)} ({resp})")
                for i, r in enumerate(results):
                    check(r[0] == 200 and r[2] == "length" and r[3] == MIGRATE_OSL,
                          f"migrated stream {i}: {r[0]} {r[2]}/{r[3]}")
                n_spliced = await splices() - splices0
                check(n_spliced == MIGRATE_STREAMS,
                      f"{MIGRATE_STREAMS} splices on the frontend's /metrics ({n_spliced})")
                held = await a_state(lambda: (engine.scheduler.num_running,
                                              engine.scheduler.num_waiting,
                                              engine.kv.active_blocks))
                check(held == (0, 0, 0), f"A released the rows and blocks (running, waiting, "
                                         f"active blocks: {held})")
                log(f"migrate: per stream {[(r[:8], per_rid.get(r), freezes.get(r)) for r in rids]}")
                # Beside the references on B: the never-migrated requests
                # on A (reported).
                order, resumes, stream_rid, same, never = await verify_moved(
                    rids, prompts, results, "migrate", also=lambda: on_a(together([request(
                        p, MIGRATE_OSL, temps[i], MIGRATE_SEEDS[i], logprobs=MIGRATE_LOGPROBS)
                        for i, p in enumerate(prompts)])))
                same_never = [r[1] == dist_text(never[i]) for i, r in enumerate(results)
                              if stream_rid[i] is not None]
                recs = [per_rid.get(rid, {}) for rid in order]
                out.update(
                    identical_to_resume_reference=same,
                    identical_to_never_migrated=sum(same_never),
                    temperatures=[temps[prompts.index(list(resumes[rid]["token_ids"][
                        :MIGRATE_ISL]))] for rid in order],
                    copy_rounds=[x.get("pushes", 0) - 1 for x in recs],
                    blocks_pushed=[x.get("blocks", 0) for x in recs],
                    freeze_to_quiescence_ms=[freezes.get(rid) for rid in order],
                    cutover_pause_ms=[migration_metrics.cutover_pause_ms.percentile(q)
                                      for q in (0.5, 1.0)],
                    migrate_out_s=[x.get("t1", 0.0) - x.get("t0", 0.0) for x in recs],
                    request_to_cutover_s=[x.get("t1", 0.0) - t_req for x in recs],
                    stall_ms=[max((b - a for a, b in zip(s, s[1:])), default=float("nan")) * 1e3
                              for s in stamps],
                    spliced=n_spliced,
                )

                # -- the prefix pull: B holds a prefix, A pulls it ---------
                puller = await a_state(lambda: engine._prefix_puller)
                check(puller is not None and puller.max_bytes == PULL_BUDGETS_MB[1] << 20,
                      "A's puller at --kv-pull-mb 192")
                pulls = []
                for j, mb in enumerate(PULL_BUDGETS_MB):
                    puller.max_bytes = mb << 20  # the default budget first, then the flag's
                    prefix = dist_prompts(1, PULL_ISL, 70 + j)[0]
                    full_req = prefix + dist_prompts(1, PULL_NEW, 80 + j)[0]
                    await direct(wid_b, request(prefix, 1))
                    # B's prefix hit, the second run (the first may capture).
                    for _ in range(2):
                        _, hit_ttft = await direct(wid_b, request(full_req, 1))
                    local = await a_state(lambda: engine.local_prefix_blocks(full_req))
                    want = min(PULL_ISL // PS - local, (mb << 20) // engine.block_nbytes())
                    b0, f0 = kv_tier_metrics.pulled_blocks_total, kv_tier_metrics.pulls_failed_total
                    toks, ttft = await direct(wid_a, request(full_req, PULL_OSL, annotations={
                        "kv_pull": {"worker_id": wid_b, "blocks": PULL_ISL // PS}}))
                    got = kv_tier_metrics.pulled_blocks_total - b0
                    check(got == want and kv_tier_metrics.pulls_failed_total == f0,
                          f"pull at {mb} MiB: {got} blocks (min(peer - local, budget) = {want})")
                    page_ok = [await same_block(full_req, i) for i in (0, want // 2, want - 1)]
                    check(all(page_ok), f"pull at {mb} MiB: pulled pages bitwise B's ({page_ok})")
                    # The same split on A: its first ``want`` blocks computed
                    # as B computed them (512-id chunks), under a salt, then
                    # the request over them.
                    salt = {"kv_salt": f"pull-reference-{j}"}
                    await on_a(alone(request(full_req[: want * PS], 1, annotations=salt)))
                    ref = await on_a(alone(request(full_req, PULL_OSL, annotations=salt)))
                    check(len(toks) == PULL_OSL and toks == ref,
                          f"pull at {mb} MiB: the stream whole and equal to the same-split "
                          f"reference ({len(toks)} tokens)")
                    # A's recompute: a fresh prompt of the same shape, no hint.
                    _, recompute = await direct(wid_a, request(
                        dist_prompts(1, PULL_ISL + PULL_NEW, 90 + j)[0], 1))
                    pulls.append({"budget_mb": mb, "blocks": got, "want": want,
                                  "frame_mib": got * engine.block_nbytes() / 2**20,
                                  "ttft_pull_ms": ttft * 1e3,
                                  "ttft_a_recompute_ms": recompute * 1e3,
                                  "ttft_b_prefix_hit_ms": hit_ttft * 1e3})
                f0 = kv_tier_metrics.pulls_failed_total
                toks, dead_ttft = await direct(wid_a, request(
                    dist_prompts(1, PULL_ISL + PULL_NEW, 99)[0], PULL_OSL,
                    annotations={"kv_pull": {"worker_id": wid_b + 7919, "blocks": 128}}))
                check(len(toks) == PULL_OSL and kv_tier_metrics.pulls_failed_total == f0 + 1,
                      f"a pull from a dead peer prefilled locally ({len(toks)} tokens, failed "
                      f"+{kv_tier_metrics.pulls_failed_total - f0})")
                out["pulls"] = pulls
                out["dead_peer_ttft_ms"] = dead_ttft * 1e3

                # -- phase k on this stack, then j's drain on the service plane
                k_result = await bulk_health_path(torch, SimpleNamespace(
                    engine=engine, server=server, wid_a=wid_a, wid_b=wid_b, wid_echo=wid_echo,
                    worker_b=worker_b, fport=fport, rt=rt, client=client, infos=infos,
                    target_b=target_b, endpoint=(ns, comp, ep), request=request,
                    direct=direct, on_a=on_a, a_state=a_state, alone=alone,
                    together=together, same_block=same_block, splices=splices,
                    wait_live=wait_live, verify_moved=verify_moved, per_rid=per_rid,
                    freezes=freezes, set_plane=set_plane, puller=puller_a,
                    mig=mig_a, bulk_srv=handles.get("bulk_srv"), syncs=syncs,
                    counting_sync=counting_sync, real_sync=real_sync,
                    j_out=out))
                await a_state(lambda: set_plane("service"))

                # -- the drain: A stopped with live streams -----------------
                drain = dist_prompts(DRAIN_STREAMS, MIGRATE_ISL, 95)
                for p in drain:
                    await on_a(alone(request(p, 1)))
                await asyncio.sleep(1.5)
                splices0 = await splices()
                resumes0 = await splices("stream_resumes_total")
                dstreams = [asyncio.ensure_future(dist_complete(fport, p, DRAIN_OSL))
                            for p in drain]
                check(await wait_live(DRAIN_STREAMS, DRAIN_AFTER),
                      f"the {DRAIN_STREAMS} drain streams live on A")
                drain_rids = await a_state(lambda: list(engine.live_request_ids()))
                t0 = time.perf_counter()
                await asyncio.get_running_loop().run_in_executor(None, server.stop)
                stopped.append(True)
                out["drain_stop_s"] = time.perf_counter() - t0
                for i, r in enumerate(await asyncio.gather(*dstreams)):
                    check(r[0] == 200 and r[2] == "length" and r[3] == DRAIN_OSL,
                          f"drained stream {i}: {r[0]} {r[2]}/{r[3]}")
                # Both cut over to B; the frontend splices each, unless A's
                # shutdown right after the drain cuts a marker off, when the
                # stream resumes on B instead (reported).
                moved = [per_rid.get(r, {}).get("ok") for r in drain_rids]
                check(moved == [True] * DRAIN_STREAMS, f"the drain moved both to B ({moved})")
                out["drain_spliced"] = await splices() - splices0
                out["drain_resumed"] = await splices("stream_resumes_total") - resumes0
                check(out["drain_spliced"] + out["drain_resumed"] == DRAIN_STREAMS,
                      f"the frontend spliced or resumed both ({out['drain_spliced']} + "
                      f"{out['drain_resumed']})")
            finally:
                torch.cuda.synchronize = real_sync
                await export.close()
                await client.close()
                await rt.close()

        asyncio.run(phase())
    finally:
        torch.cuda.synchronize = real_sync
        MigratableWorker.migrate_out, MigratableWorker._push_blocks = real_migrate_out, real_push
        cli.WorkerRoles.start_decode = real_start_decode
        if env_bulk is None:
            os.environ.pop("DYN_BULK_PLANE", None)
        else:
            os.environ["DYN_BULK_PLANE"] = env_bulk
        mig_log.removeHandler(handler)
        try:
            if server is not None and not stopped:
                server.stop()
        finally:
            for c in reversed(children):
                c.stop()
    launches = out.get("launches") or {"decode_attention": 0, "prefill_attention": 0,
                                       "threefry_gumbel": 0}
    check(all(v > 0 for v in launches.values()), f"A launched all three kernels ({launches})")
    g0, g1 = out.get("graphs", ({}, {}))
    check(g0 == g1, f"A captured no graph while serving ({g0} -> {g1})")
    check(out.get("syncs") == 0, f"no torch.cuda.synchronize on A while serving "
                                 f"({out.get('syncs')})")
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = CARD
    log("migrate " + json.dumps(out, default=str))
    return (not fails, launches, out), k_result


BULK_FAULT_SPEC = "bulk_conn_drop:kv_export#5"  # B's: 4 drops end its first bulk fetch, 1 the next
BULK_PULL_BUDGETS_MB = (64, 192)  # 32 and 96 blocks of llama-3.1-8b
BULK_PULL_TURNS = ("bulk", "service", "service", "bulk", "bulk", "service")
BULK_STALL_ISL, BULK_STALL_OSL = 256, 256  # B's stream during each 96-block pull
BULK_MIGRATE_SEEDS = (None, 4444)  # greedy, and seeded at MIGRATE_TEMPERATURE
SPAN_REQUESTS, SPAN_ISL, SPAN_OSL = 3, 512, 8
ECHO_ENDPOINT = "dyn://dynamo.EchoWorker.generate"
WATCH_ISL, WATCH_OSL = 512, 400
# slow_stream on A: before every item it sends.  An item is a fused
# dispatch's tokens, ~75 ms apart on a healthy worker, so 0.3 s is past
# straggler_factor 3.0 times the fleet median.
WATCH_STREAM_DELAY_S = 0.3
WATCH_PACE_S = 0.35  # A's decode paced so that its slowed wire keeps up
WATCH_FAST, WATCH_FAST_ISL, WATCH_FAST_OSL = 4, 64, 32
WATCH_CFG = dict(probe_interval_s=0.25, probe_timeout_s=0.5, eject_grace_s=60.0)
WATCH_EJECT_GRACE_S = 1.0
WATCH_HEALTH_DELAY_S = 2.0  # A's __health__ answers after the probe's timeout: A stays sick


class RssPeak:
    """Peak resident set of process ``pid`` between ``start`` and
    ``stop`` (``/proc/<pid>/status`` read every 5 ms), beside its value at
    ``start``, in MiB."""

    def __init__(self, pid):
        self.path = f"/proc/{pid}/status"
        self.peak = self.base = 0.0
        self._stop = threading.Event()
        self._thread = None

    def _read(self):
        with open(self.path) as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
        return 0.0

    def start(self):
        self.base = self.peak = self._read()

        def run():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self._read())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(5)
        return self.base, self.peak


async def bulk_health_path(torch, c):
    """Phase k, on phase j's stack (``migrate_pull_path``) before j's
    drain, with A's producers on the bulk plane.  Returns (ok, launches,
    numbers)."""
    from dynamo_tpu_torch.llm.metrics import bulk_metrics, kv_tier_metrics, migration_metrics
    from dynamo_tpu_torch.llm.migration import request_migrate_out
    from dynamo_tpu_torch.llm.trace_service import BULK_TRACES_SINK
    from dynamo_tpu_torch.runtime.transports.bulk import bulk_addr_key, bulk_sink_prefix
    from dynamo_tpu_torch.runtime.transports.shard import shard_metrics

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"bulk check FAILED: {what}")

    async def until(cond, timeout):
        end = time.perf_counter() + timeout
        while not cond():
            if time.perf_counter() > end:
                return False
            await asyncio.sleep(0.02)
        return True

    engine, rt, client, request = c.engine, c.rt, c.client, c.request
    wid_a, wid_b = c.wid_a, c.wid_b
    ns, comp, ep = c.endpoint
    nb = engine.block_nbytes()
    t_phase = time.perf_counter()
    next_seed = [200]
    stall_prompts = {}

    def b_fallback_lines():
        return sum("falling back to the hub path" in line for line in c.worker_b.lines)

    # The pull's own walls on A: the exporter's (the transfer) and the
    # puller's (the transfer and the inject).
    export_walls, pull_walls = [], []
    real_pull = c.puller.pull

    async def timed_pull(*a, **kw):
        t0 = time.perf_counter()
        try:
            return await real_pull(*a, **kw)
        finally:
            pull_walls.append(time.perf_counter() - t0)

    def use(plane, mb):
        c.set_plane(plane)
        inner = c.puller.exporter

        async def timed_exporter(worker_id, data):
            t0 = time.perf_counter()
            try:
                return await inner(worker_id, data)
            finally:
                export_walls.append(time.perf_counter() - t0)

        c.puller.exporter = timed_exporter
        c.puller.max_bytes = mb << 20
        c.puller.pull = timed_pull

    async def pull(mb, plane, stall=False):
        """A pulls a fresh 2048-id prefix B holds, at ``mb`` MiB, over
        ``plane``; with ``stall``, a stream decodes on B meanwhile."""
        await c.a_state(lambda: use(plane, mb))
        j = next_seed[0]
        next_seed[0] += 1
        prefix = dist_prompts(1, PULL_ISL, 1000 + j)[0]
        full = prefix + dist_prompts(1, PULL_NEW, 2000 + j)[0]
        await c.direct(wid_b, request(prefix, 1))
        local = await c.a_state(lambda: engine.local_prefix_blocks(full))
        want = min(PULL_ISL // PS - local, (mb << 20) // nb)
        m0, b0 = bulk_metrics.snapshot(), kv_tier_metrics.pulled_blocks_total
        f0 = kv_tier_metrics.pulls_failed_total
        del export_walls[:], pull_walls[:]
        bstream = rss = None
        if stall:
            # A stream decoding on B meanwhile, through the frontend (its
            # prompt's prefix is B's): an SSE event per token.
            first, st = asyncio.Event(), []

            def on_event(text):
                st.append(time.perf_counter())
                first.set()

            bstream = asyncio.ensure_future(dist_complete(
                c.fport, stall_prompts[(mb, j)], BULK_STALL_OSL, on_event,
                logprobs=MIGRATE_LOGPROBS))
            await asyncio.wait_for(first.wait(), 60)
            await asyncio.sleep(0.3)
            rss = RssPeak(c.worker_b.p.pid).start()
        t0 = time.perf_counter()
        toks, ttft = await c.direct(wid_a, request(full, PULL_OSL, annotations={
            "kv_pull": {"worker_id": wid_b, "blocks": PULL_ISL // PS}}))
        m1 = bulk_metrics.snapshot()
        rec = {"plane": plane, "budget_mb": mb, "blocks": kv_tier_metrics.pulled_blocks_total - b0,
               "want": want, "failed": kv_tier_metrics.pulls_failed_total - f0,
               "ttft_ms": ttft * 1e3, "export_ms": sum(export_walls) * 1e3,
               "pull_ms": sum(pull_walls) * 1e3, "tokens": len(toks),
               **{k: m1[k] - m0[k] for k in m1}}
        if stall:
            base, peak = rss.stop()
            r = await bstream
            check(r[0] == 200 and r[3] == BULK_STALL_OSL, f"B's stream during the pull: {r[:4]}")
            gaps = [(b - a, a, b) for a, b in zip(st, st[1:])]
            during = [g for g, a, b in gaps if b >= t0 and a <= t0 + ttft]
            before = sorted(g for g, a, b in gaps if b < t0)
            rec.update(donor_itl_max_during_ms=max(during, default=float("nan")) * 1e3,
                       donor_itl_p50_before_ms=(before[len(before) // 2] * 1e3 if before
                                                else float("nan")),
                       donor_itl_max_before_ms=max(before, default=float("nan")) * 1e3,
                       donor_rss_mib=(round(base, 1), round(peak, 1)))
        return rec, full, toks

    async def pages_equal(full, n):
        return [await c.same_block(full, i) for i in sorted({0, n // 2, max(0, n - 1)})]

    await c.a_state(lambda: c.set_plane("bulk"))
    graphs0 = dict(engine.compile_counts())
    keys0 = {n: set(getattr(engine.programs, n)._signatures) for n in engine.programs.NAMES}
    zero_kernel_counts()
    zero_noise_launches()
    c.syncs[0] = 0
    torch.cuda.synchronize = c.counting_sync
    try:
        # -- 1. rendezvous ------------------------------------------------
        addrs = {n: await rt.hub.kv_get(bulk_addr_key(w)) for n, w in (("A", wid_a), ("B", wid_b))}
        sinks = await rt.hub.kv_get_prefix(bulk_sink_prefix(BULK_TRACES_SINK))
        check(all(isinstance(r, dict) and r.get("address") for r in addrs.values())
              and addrs["A"]["address"] == c.bulk_srv.address,
              f"bulk/addr of A and B in the hub ({addrs})")
        check(len(sinks) == 1 and all(r.get("address") for r in sinks.values()),
              f"the frontend's bulk/sink/traces in the hub ({sinks})")
        out["rendezvous"] = {"A": addrs["A"], "B": addrs["B"], "traces": sinks}

        # -- 3. faults on B's kv_export (BULK_FAULT_SPEC) ------------------
        fired0 = sum("fault fired: bulk_conn_drop" in line for line in c.worker_b.lines)
        faults_out = {}
        for case, want_fb, want_res in (("every chunk", 1, 3), ("once", 0, 1)):
            rec, full, toks = await pull(BULK_PULL_BUDGETS_MB[0], "bulk")
            pages = await pages_equal(full, rec["want"])
            check(rec["fallbacks_total"] == want_fb and rec["resumes_total"] == want_res
                  and rec["blocks"] == rec["want"] and rec["failed"] == 0 and all(pages)
                  and rec["tokens"] == PULL_OSL,
                  f"bulk_conn_drop {case}: fallbacks {rec['fallbacks_total']} (want {want_fb}), "
                  f"resumes {rec['resumes_total']} (want {want_res}), {rec['blocks']} of "
                  f"{rec['want']} blocks, pages {pages}, {rec['tokens']} tokens")
            faults_out[case] = rec
        fired = sum("fault fired: bulk_conn_drop" in line for line in c.worker_b.lines) - fired0
        check(fired == 5, f"B's bulk_conn_drop fired 5 times ({fired})")
        out["faults"] = faults_out

        # -- 2. the pull over the bulk plane, in turns with the service plane
        pulls = {}
        for mb in BULK_PULL_BUDGETS_MB:
            if mb == BULK_PULL_BUDGETS_MB[-1]:
                # The streams that decode on B during the 96-block pulls:
                # their prompts prefilled on B (with their programs), so the
                # frontend's KV router sends them there.
                stall_prompts.update(((mb, j), p) for j, p in zip(
                    range(next_seed[0], next_seed[0] + len(BULK_PULL_TURNS)),
                    dist_prompts(len(BULK_PULL_TURNS), BULK_STALL_ISL, 3000 + mb)))
                for p in stall_prompts.values():
                    await c.direct(wid_b, request(p, 1, logprobs=MIGRATE_LOGPROBS))
                await asyncio.sleep(1.5)
            for turn, plane in enumerate(BULK_PULL_TURNS):
                rec, full, toks = await pull(mb, plane, stall=mb == BULK_PULL_BUDGETS_MB[-1])
                ok = rec["blocks"] == rec["want"] and rec["failed"] == 0 and len(toks) == PULL_OSL
                if plane == "bulk":
                    ok = ok and rec["fallbacks_total"] == 0 and rec["bytes_total"] >= rec["blocks"] * nb
                else:
                    ok = ok and rec["bytes_total"] == 0
                check(ok, f"pull at {mb} MiB over {plane} (turn {turn}): {rec}")
                if turn == 0:
                    pages = await pages_equal(full, rec["want"])
                    salt = {"kv_salt": f"bulk-pull-reference-{mb}"}
                    await c.on_a(c.alone(request(full[: rec["want"] * PS], 1, annotations=salt)))
                    ref = await c.on_a(c.alone(request(full, PULL_OSL, annotations=salt)))
                    check(all(pages) and toks == ref,
                          f"bulk pull at {mb} MiB: pages bitwise B's ({pages}), the stream "
                          f"equal to the same-split reference")
                pulls.setdefault(mb, []).append(rec)
        out["pulls"] = pulls
        await c.a_state(lambda: c.set_plane("bulk"))

        # -- 4. migration over the bulk plane ------------------------------
        mprompts = dist_prompts(2, MIGRATE_ISL, 66)
        temps = [0.0 if s is None else MIGRATE_TEMPERATURE for s in BULK_MIGRATE_SEEDS]
        # A holds the prompts and has run their programs (as in phase j:
        # each alone twice, then together).
        warm = [request(p, 40, temps[i], BULK_MIGRATE_SEEDS[i], logprobs=MIGRATE_LOGPROBS)
                for i, p in enumerate(mprompts)]
        for r in warm + warm:
            await c.on_a(c.alone(r))
        await c.on_a(c.together(warm))
        await asyncio.sleep(1.5)  # the router's index takes A's events
        splices0 = await c.splices()
        bb0, mm0 = bulk_metrics.snapshot(), (migration_metrics.blocks_total,
                                             migration_metrics.bytes_total)
        pub0 = sum(shard_metrics.publish_bytes.values())
        stamps = [[] for _ in mprompts]
        streams = [asyncio.ensure_future(dist_complete(
            c.fport, p, MIGRATE_OSL, lambda text, i=i: stamps[i].append(time.perf_counter()),
            temps[i], BULK_MIGRATE_SEEDS[i], MIGRATE_LOGPROBS)) for i, p in enumerate(mprompts)]
        check(await c.wait_live(len(mprompts), MIGRATE_AFTER),
              f"the {len(mprompts)} streams live on A with {MIGRATE_AFTER}+ tokens")
        rids = await c.a_state(lambda: list(engine.live_request_ids()))
        t_req = time.perf_counter()
        resp = await request_migrate_out(c.infos[wid_a], c.target_b)
        results = await asyncio.gather(*streams)
        bb1 = bulk_metrics.snapshot()
        pub = sum(shard_metrics.publish_bytes.values()) - pub0
        mig_blocks = migration_metrics.blocks_total - mm0[0]
        mig_bytes = migration_metrics.bytes_total - mm0[1]
        check(resp.get("ok") and sorted(resp.get("migrated") or []) == sorted(rids)
              and not resp.get("failed"), f"migrate_out moved both over the bulk plane ({resp})")
        for i, r in enumerate(results):
            check(r[0] == 200 and r[2] == "length" and r[3] == MIGRATE_OSL,
                  f"bulk-migrated stream {i}: {r[0]} {r[2]}/{r[3]}")
        n_spliced = await c.splices() - splices0
        check(n_spliced == len(mprompts), f"{len(mprompts)} splices ({n_spliced})")
        bulk_bytes = bb1["bytes_total"] - bb0["bytes_total"]
        check(bb1["fallbacks_total"] == bb0["fallbacks_total"] and bulk_bytes >= mig_bytes > 0
              and pub * 100 < bulk_bytes,
              f"the copy stream on the bulk plane: {bulk_bytes} bulk bytes for {mig_bytes} KV "
              f"bytes, {pub} hub publish bytes, fallbacks "
              f"{bb1['fallbacks_total'] - bb0['fallbacks_total']}")
        order, _, _, same, _ = await c.verify_moved(rids, mprompts, results, "bulk migration")
        recs = [c.per_rid.get(rid, {}) for rid in order]
        out["migrate"] = dict(
            blocks_pushed=[x.get("blocks", 0) for x in recs],
            copy_rounds=[x.get("pushes", 0) - 1 for x in recs],
            migrate_out_s=[x.get("t1", 0.0) - x.get("t0", 0.0) for x in recs],
            request_to_cutover_s=[x.get("t1", 0.0) - t_req for x in recs],
            freeze_to_quiescence_ms=[c.freezes.get(rid) for rid in order],
            stall_ms=[max((b - a for a, b in zip(s, s[1:])), default=float("nan")) * 1e3
                      for s in stamps],
            bulk_bytes=bulk_bytes, bulk_transfers=bb1["transfers_total"] - bb0["transfers_total"],
            kv_bytes=mig_bytes, kv_blocks=mig_blocks, hub_publish_bytes=pub, spliced=n_spliced,
            identical_to_resume_reference=same,
            service_plane_j={k: c.j_out.get(k) for k in ("migrate_out_s", "stall_ms",
                                                         "blocks_pushed")})

        # -- 5. spans over the bulk sink -----------------------------------
        fb_lines0, fb0 = b_fallback_lines(), bulk_metrics.fallbacks_total
        sprompts = dist_prompts(SPAN_REQUESTS, SPAN_ISL, 71)
        for p in sprompts:
            await c.direct(wid_b, request(p, 1))
        await asyncio.sleep(1.5)
        spans_out = []
        for p in sprompts:
            st, hdrs, _, _ = await http_call(c.fport, "POST", "/v1/completions", {
                "model": DIST_MODEL, "prompt": p + [11, 12, 13, 14], "max_tokens": SPAN_OSL,
                "nvext": {"ignore_eos": True}}, headers={"x-trace": "1"})
            tid = hdrs.get("x-trace-id")
            trace = None
            for _ in range(200):
                s_, _, body, _ = await http_call(c.fport, "GET", f"/traces/{tid}")
                trace = json.loads(body) if s_ == 200 else None
                if trace and f"worker-{wid_b}" in trace.get("procs", []):
                    break
                await asyncio.sleep(0.05)
            procs = (trace or {}).get("procs", [])
            spans_out.append({"status": st, "trace_id": tid, "procs": procs,
                              "b_spans": sum(s.get("proc") == f"worker-{wid_b}"
                                             for s in (trace or {}).get("spans", []))})
        # The router sends each to B, which holds its prefix; a trace the
        # router sent to A carries A's spans instead (through A's sink).
        check(all(s["status"] == 200 and any(p.startswith("worker-") for p in s["procs"])
                  for s in spans_out) and any(s["b_spans"] > 0 for s in spans_out)
              and b_fallback_lines() == fb_lines0 and bulk_metrics.fallbacks_total == fb0,
              f"traced requests: the serving worker's spans at /traces through the bulk sink, "
              f"B's among them, no fallback ({spans_out}; B's fallback log lines "
              f"+{b_fallback_lines() - fb_lines0})")
        out["spans"] = spans_out

        # -- 6. the watchdog, on A's loop ------------------------------------
        # Two event loops of one process must not talk to one service
        # address at once (the service plane keeps one connection per
        # address per process, and a loop dialing it closes the other
        # loop's): the watchdog, its client and the streams it watches run
        # on A's loop, beside A's own clients.
        await c.on_a(watch_step(c, check, until, out, temps))

    finally:
        torch.cuda.synchronize = c.real_sync
        c.puller.__dict__.pop("pull", None)
    launches = {**kernel_counts(), "threefry_gumbel": noise_launches()}
    check(all(v > 0 for v in launches.values()), f"A launched all three kernels ({launches})")
    graphs1 = dict(engine.compile_counts())
    new_keys = {n: [str(k) for k in set(getattr(engine.programs, n)._signatures) - keys0[n]]
                for n in engine.programs.NAMES}
    check(graphs0 == graphs1, f"A captured no graph while serving ({graphs0} -> {graphs1}, new "
                              f"keys {new_keys})")
    check(c.syncs[0] == 0, f"no torch.cuda.synchronize on A while serving ({c.syncs[0]})")
    out.update(launches=launches, syncs=c.syncs[0], phase_s=time.perf_counter() - t_phase,
               card=CARD, failures=fails)
    log("bulk " + json.dumps(out, default=str))
    return not fails, launches, out


async def watch_step(c, check, until, out, temps):
    """Phase k, step 6, on worker A's event loop: a ``HealthWatchdog``
    over the stack's generate instances with its default prober, drainer
    and latency source, fed by a routed client on this loop; A made a
    straggler, quarantined, drained, reinstated, then made sick, ejected
    and re-registered."""
    from dynamo_tpu_torch.llm.metrics import bulk_metrics
    from dynamo_tpu_torch.runtime.engine import Context, collect
    from dynamo_tpu_torch.runtime.faultinject import faults
    from dynamo_tpu_torch.runtime.health import (
        HealthConfig, HealthWatchdog, health_metrics, quarantine_key, worker_latency)
    from dynamo_tpu_torch.runtime.resilience import metrics as res_metrics

    engine, request, art = c.engine, c.request, c.server.service
    wid_a, wid_b = c.wid_a, c.wid_b
    ns, comp, ep = c.endpoint
    client = await art.namespace(ns).component(comp).endpoint(ep).client()
    echo_client = await art.namespace("dynamo").component("EchoWorker").endpoint(
        "generate").client()
    dog = None

    async def direct(wid, req):
        return await collect(await client.generate(Context(dict(req)), worker_id=wid))

    try:
        await echo_client.wait_for_instances(30)
        wprompts = dist_prompts(2, WATCH_ISL, 75)
        wseeds = (None, 4545)
        wreqs = [request(p, WATCH_OSL, temps[i], wseeds[i], logprobs=MIGRATE_LOGPROBS)
                 for i, p in enumerate(wprompts)]
        warm = [request(p, 40, temps[i], wseeds[i], logprobs=MIGRATE_LOGPROBS)
                for i, p in enumerate(wprompts)]
        for r in warm + warm:
            await c.alone(r)
        await c.together(warm)
        pace_prompts = dist_prompts(2 * WATCH_FAST + 1, WATCH_FAST_ISL, 76)
        await direct(wid_b, request(pace_prompts[0], 24))  # B's programs for this shape

        async def fleet_pace(prompts):
            """A fresh latency window: the fleet's pace as this client sees
            it, B's and the echo worker's."""
            worker_latency.reset()
            for p in prompts:
                await direct(wid_b, request(p, 24))
            await collect(await echo_client.generate(Context(request(list(range(1, 25)), 24))))

        health_metrics.reset()
        await fleet_pace(pace_prompts[1:WATCH_FAST + 1])
        a_addr = c.infos[wid_a]["address"]
        splices0 = res_metrics.migration_splices_total
        bw0 = bulk_metrics.snapshot()

        async def pace():
            await asyncio.sleep(WATCH_PACE_S)

        engine.pace_hook = pace
        faults.arm("slow_stream", match=a_addr, delay_s=WATCH_STREAM_DELAY_S)
        t_arm = time.perf_counter()
        wres = [[] for _ in wreqs]

        async def consume(i):
            async for item in await client.generate(Context(dict(wreqs[i])), worker_id=wid_a):
                wres[i].append(item)

        wtasks = [asyncio.ensure_future(consume(i)) for i in range(len(wreqs))]
        dog = await HealthWatchdog(art.hub, f"instances/{ns}/{comp}/{ep}/",
                                   config=HealthConfig(**WATCH_CFG)).start()

        def state(wid):
            rec = dog.workers.get(wid)
            return rec.state if rec is not None else None

        check(await until(lambda: state(wid_a) == "quarantined", 60),
              f"A quarantined as a straggler ({state(wid_a)})")
        t_q = time.perf_counter()
        snap = worker_latency.snapshot()
        marker = await art.hub.kv_get(quarantine_key(wid_a))
        check((marker or {}).get("state") == "quarantined"
              and dog.workers[wid_a].reason == "latency_outlier",
              f"A's quarantine marker ({marker}, {dog.workers[wid_a].reason})")
        check(await until(lambda: health_metrics.drained_sequences_total >= 2, 120),
              f"the default drainer moved A's 2 live streams "
              f"({health_metrics.drained_sequences_total})")
        t_drained = time.perf_counter()
        bw1 = bulk_metrics.snapshot()
        check(bw1["transfers_total"] > bw0["transfers_total"]
              and bw1["fallbacks_total"] == bw0["fallbacks_total"],
              f"the drain's copy stream rode the bulk plane ({bw0} -> {bw1})")
        engine.pace_hook = None
        faults.disarm("slow_stream")
        await asyncio.gather(*wtasks)
        for i, items in enumerate(wres):
            n = sum(len(it.get("token_ids", [])) for it in items)
            check(n == WATCH_OSL and items and items[-1].get("finish_reason") == "length",
                  f"drained stream {i} whole ({n} tokens)")
        spliced = res_metrics.migration_splices_total - splices0
        check(spliced == 2, f"this client spliced both drained streams ({spliced})")
        check(state(wid_b) == "healthy", f"B healthy ({state(wid_b)})")
        # A's own streams are back at the fleet's pace; the window that
        # held its slow samples (and the drained streams' catch-up) is
        # replaced by a fresh one.
        await fleet_pace(pace_prompts[WATCH_FAST + 1:])
        for i in range(WATCH_FAST):
            await direct(wid_a, request(dist_prompts(1, WATCH_FAST_ISL, 77 + i)[0],
                                        WATCH_FAST_OSL))
        check(await until(lambda: state(wid_a) == "healthy", 30), f"A reinstated ({state(wid_a)})")
        t_r = time.perf_counter()
        check(t_r - t_q < WATCH_CFG["eject_grace_s"]
              and await art.hub.kv_get(quarantine_key(wid_a)) is None,
              "A reinstated before the grace ended, its marker cleared")
        # Ejection: A's __health__ answers only after the probe's timeout.
        dog.config.eject_grace_s = WATCH_EJECT_GRACE_S
        akey = sorted(dog.workers[wid_a].keys)[0]
        calls = [0]
        real_generate = engine.generate

        async def counting_generate(req):
            calls[0] += 1
            return await real_generate(req)

        engine.generate = counting_generate
        faults.arm("delay", match="__health__", delay_s=WATCH_HEALTH_DELAY_S)
        t_sick = time.perf_counter()
        check(await until(lambda: state(wid_a) == "ejected", 30), f"A ejected ({state(wid_a)})")
        t_e = time.perf_counter()
        marker = await art.hub.kv_get(quarantine_key(wid_a))
        gone = await art.hub.kv_get(akey) is None
        check(gone and (marker or {}).get("state") == "ejected" and state(wid_b) == "healthy",
              f"A's registration deleted ({gone}), its marker ejected ({marker}), B "
              f"{state(wid_b)}")
        calls0 = calls[0]
        eresults = [await dist_complete(c.fport, dist_prompts(1, WATCH_FAST_ISL, 77 + i)[0], 8)
                    for i in range(WATCH_FAST)]
        check(all(r[0] == 200 and r[3] == 8 for r in eresults) and calls[0] == calls0,
              f"after the eject the frontend routes to B only: {[r[0] for r in eresults]}, "
              f"A served {calls[0] - calls0}")
        del engine.generate
        faults.disarm("delay")
        # The operator brings A back: its registration is put again.
        await art.register_key(akey, art._registrations[akey])
        check(await until(lambda: state(wid_a) == "healthy", 10)
              and await art.hub.kv_get(quarantine_key(wid_a)) is None,
              f"re-registration reset A ({state(wid_a)})")
        hm = health_metrics
        counts = dict(quarantines=hm.quarantines_total, recoveries=hm.recoveries_total,
                      ejections=hm.ejections_total, drains=hm.drains_total,
                      drained_sequences=hm.drained_sequences_total,
                      stragglers_detected=hm.stragglers_detected_total,
                      probes=hm.probes_total, probe_failures=hm.probe_failures_total,
                      corruption_quarantines=hm.corruption_quarantines_total,
                      states=dict(hm.state_counts))
        check(counts["quarantines"] == 2 and counts["recoveries"] == 1
              and counts["ejections"] == 1 and counts["drains"] == 2
              and counts["drained_sequences"] == 2 and counts["stragglers_detected"] >= 2
              and counts["probe_failures"] >= 2 and counts["corruption_quarantines"] == 0
              and counts["states"] == {"healthy": 2},
              f"dynamo_tpu_health_* match the transitions ({counts})")
        out["watchdog"] = dict(
            counts=counts, a_itl_p50_ms=(snap.get(wid_a) or {}).get("itl_p50_ms"),
            a_ttft_p50_ms=(snap.get(wid_a) or {}).get("ttft_p50_ms"),
            fleet_itl_p50_ms={str(w): (v or {}).get("itl_p50_ms") for w, v in snap.items()},
            fleet_ttft_p50_ms={str(w): (v or {}).get("ttft_p50_ms") for w, v in snap.items()},
            drain_bulk_bytes=bw1["bytes_total"] - bw0["bytes_total"],
            arm_to_quarantine_s=t_q - t_arm, quarantine_to_drained_s=t_drained - t_q,
            quarantine_to_reinstated_s=t_r - t_q, sick_to_ejected_s=t_e - t_sick,
            render_lines=len(hm.render().splitlines()))
    finally:
        engine.pace_hook = None
        engine.__dict__.pop("generate", None)
        faults.disarm("slow_stream")
        faults.disarm("delay")
        if dog is not None:
            await dog.stop()
        await echo_client.close()
        await client.close()


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
        # Phase h runs two llama-3.1-8b workers on this card (one in this
        # process): free what the earlier phases left first.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the distributed phase: {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        ok_dist, dist_launches, _ = dist_path(torch)
        # Phase i runs two llama-3.1-8b workers on this card again.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the disaggregated phase: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        ok_disagg, disagg_launches, _ = disagg_path(torch)
        # Phase j: the sampler's noise kernel, then two workers again.
        gc.collect()
        torch.cuda.empty_cache()
        with torch.inference_mode():
            noise_times = check_noise_kernel(torch, dev, tally)
        log(f"memory before the migration phase: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        (ok_migrate, migrate_launches, _), (ok_bulk, bulk_launches, _) = migrate_pull_path(
            torch, noise_times)
        slice_ok = {"w8a8 ops (a)": ok_ops, "w8a8 model (b)": ok_w8a8_model,
                    "bench geometry (c)": ok_bench, "loadgen geometry (d)": ok_loadgen,
                    "speculation (e)": ok_spec, "edge (f)": ok_edge, "kv tiers (g)": ok_tiers,
                    "distributed (h)": ok_dist, "disaggregated (i)": ok_disagg,
                    "migration and pull (j)": ok_migrate,
                    "bulk plane and watchdog (k)": ok_bulk}

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
            kernels[-1]["dist_launches"] = dist_launches[name]
            kernels[-1]["disagg_launches"] = disagg_launches[name]
            kernels[-1]["migrate_launches"] = migrate_launches[name]
            kernels[-1]["bulk_launches"] = bulk_launches[name]
            if "mixed" in tm:
                kernels[-1].update(mixed_step_ms=tm["mixed"]["ms"],
                                   mixed_step_plain_ms=tm["mixed"]["plain_ms"],
                                   mixed_step_bound_ms=tm["mixed"]["bound_ms"],
                                   mixed_step_library_ms=None,
                                   mixed_step_decode_rows_ms=tm["mixed"]["decode_rows_ms"])
        # The sampler's noise kernel has no Pallas counterpart (the JAX
        # package draws jax.random's noise in XLA); its path is the sampled
        # traffic, so its launches are phase j's (worker A) and phase e's.
        nt = noise_times[max(NOISE_ROWS)]
        kernels.append({
            "name": "threefry_gumbel", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/threefry_gumbel.cu",
            "replaces": "dynamo_tpu/ops/sampling.py:105 (jax.random in XLA, no Pallas kernel)",
            "launches": migrate_launches["threefry_gumbel"],
            "max_abs_err": tally.worst["threefry_gumbel"],
            "ms": nt["ms"], "plain_ms": nt["plain_ms"], "bound_ms": nt["bound_ms"],
            "bound_by": nt["bound_by"], "library_ms": None,
            "checks_passed": not any(f.startswith("threefry_gumbel") for f in tally.failures),
            "shape": f"B={max(NOISE_ROWS)} V={NOISE_V}",
            "rows16": {k: noise_times[16][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "spec_launches": {k: spec[(k, "on")]["noise"] for k in ("repetitive", "random")},
            "migrate_launches": migrate_launches["threefry_gumbel"],
            "bulk_launches": bulk_launches["threefry_gumbel"],
        })
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
