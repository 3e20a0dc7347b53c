"""Where a serving step's time goes on the card: one fused decode dispatch
and one prefill chunk of TorchEngine on llama-3.1-8b, under torch.profiler,
each as the eager calls and as the replay of its captured CUDA graph (what
the serving loop dispatches), for bf16 weights with bf16 KV pages and for
W8A8 int8 weights with int8 KV pages under calibrated scales.

    python -m dynamo_tpu_torch.engine.profile_step [--rows 8] [--steps 8] [--configs bf16,w8a8]

Prints, for each, the host wall time of an unprofiled run (ending in a
device synchronize), the summed device time of the kernels of a profiled
run, the device's idle share of the unprofiled wall (1 - busy / wall), the
kernels a run holds, whether the two attention kernels are among them, and
the kernels with the most device time.  Under W8A8 the eager runs also
report the int8 linears' three parts on their own — the activation
quantize, the int8 GEMM and the rescale — from the profiler ranges that
``ops/quant_matmul.qdot`` opens around each part.  Random seeded weights at
full width and depth; the KV pages the rows attend over are written by real
prefill steps first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import default_device
from ..models.llama import RaggedBatch
from ..ops.quant_matmul import QDOT_PARTS
from .config import EngineConfig
from .engine import TorchEngine

def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kernel_us(evt) -> float:
    """Device time of the kernels a host-side profiler event launched,
    its children's included."""
    own = sum(float(getattr(k, "duration", 0.0)) for k in getattr(evt, "kernels", []))
    return own + sum(_kernel_us(c) for c in evt.cpu_children)


def _profile(label: str, fn, top: int) -> None:
    fn()  # warm: allocator, cuBLAS handles, kernel libraries
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3  # the profiler slows the host
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel-level rows only: operator rows (aten::mm, ...) carry their
    # kernels' device time too and would count it twice.
    cuda = torch.autograd.DeviceType.CUDA
    rows = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == cuda and _device_us(e) > 0
        and e.key not in QDOT_PARTS  # the ranges' device-side spans are not kernels
    ]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    seen = {k: any(k in e.key for e in rows) for k in ("prefill_tc_kernel", "decode_tc_kernel")}
    print(f"{label}: wall {plain_ms:.3f} ms unprofiled ({wall_ms:.3f} ms profiled), "
          f"device busy {busy_ms:.3f} ms, idle share of the unprofiled wall "
          f"{max(0.0, 1 - busy_ms / plain_ms):.3f}, {launches} kernels; attention kernels "
          f"in the kernel rows {seen}")
    # Each range's kernels: the device time of the kernels launched inside
    # its host-side event (children included), not the range's span on the
    # device, which also holds the device's waits for the host.
    parts = {name: [0.0, 0] for name in QDOT_PARTS}
    for e in prof.events():
        if e.name in parts and getattr(e, "device_type", None) != cuda:
            parts[e.name][0] += _kernel_us(e)
            parts[e.name][1] += 1
    for name, (us, calls) in parts.items():
        if calls:
            print(f"  {name:14s} {us / 1e3:9.3f} ms of kernels in {calls} calls, "
                  f"{us / 1e3 / busy_ms if busy_ms else 0.0:.3f} of device busy")
    for e in sorted(rows, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


CONFIGS = {
    "bf16": dict(),
    "w8a8": dict(weight_quant="int8", cache_dtype="int8", kv_scale="auto"),
}


def profile_config(name: str, rows: int, steps: int, top: int) -> None:
    """Profile one prefill chunk and one fused decode dispatch of an engine
    at ``CONFIGS[name]``, eager and as a graph replay."""
    dev = default_device()
    cfg = EngineConfig(
        model="llama-3.1-8b", dtype="bfloat16", block_size=16, num_blocks=2048,
        max_batch=16, max_model_len=4096, prefill_chunk=512,
        decode_steps=steps, seed=0, **CONFIGS[name],
    )
    eng = TorchEngine(cfg, device=dev)
    print(f"== {name}: kv_scale {'none' if eng.kv_scale is None else 'calibrated'}"
          f"{'' if eng.kv_scale is None else f' {np.min(eng.kv_scale):.4g}..{np.max(eng.kv_scale):.4g}'}")
    S, bs, PP = cfg.max_batch, cfg.block_size, cfg.max_blocks_per_seq
    rng = np.random.default_rng(0)
    ctx = [1024 + 128 * i for i in range(rows)]
    tables = np.zeros((S, PP), np.int32)
    for i, n in enumerate(ctx):  # disjoint pages per row
        tables[i, : PP] = np.arange(i * PP, (i + 1) * PP) % cfg.num_blocks
    d = eng._to_device
    hs = eng._sampling_arrays([None] * S)
    samp = eng._samp_params({k: d(v) for k, v in hs.arrays.items()}, hs.flags)

    def chunk(row: int, start: int, n: int):
        """Host arrays of a prefill chunk of ``row`` (RaggedBatch fields)."""
        T = cfg.bucket_tokens(n)
        pos = np.arange(start, start + n, dtype=np.int32)
        tok = np.zeros(T, np.int64)
        tok[:n] = rng.integers(1, 128000, size=n)
        posp = np.zeros(T, np.int32)
        posp[:n] = pos
        slots = np.full(T, -1, np.int32)
        slots[:n] = tables[row, pos // bs] * bs + pos % bs
        kv = np.zeros(S, np.int32)
        kv[0] = start + n
        tab = np.zeros((S, PP), np.int32)
        tab[0] = tables[row]
        cu = np.zeros(S + 1, np.int32)
        cu[1:] = n
        return dict(token_ids=tok, positions=posp, slot_mapping=slots, kv_lens=kv,
                    page_indices=tab, cu_q_lens=cu, num_seqs=np.asarray([1], np.int32))

    def eager_batch(rb) -> RaggedBatch:
        return RaggedBatch(**{k: d(v) for k, v in rb.items()})

    with torch.inference_mode():
        for i, n in enumerate(ctx):  # real K/V for every context position
            for start in range(0, n, cfg.prefill_chunk):
                rb = chunk(i, start, min(cfg.prefill_chunk, n - start))
                eng._step(eager_batch(rb), samp)
        torch.cuda.synchronize()
        pre = chunk(0, 512, 512)  # a 512-token chunk over a 512-token prefix
        _profile(f"{name} prefill chunk (512 tokens over 512, one row), eager",
                 lambda: eng._step(eager_batch(pre), samp).tokens.cpu(), top)
        _profile(f"{name} prefill chunk (512 tokens over 512, one row), graph replay",
                 lambda: eng._start_d2h(eng._run_step(pre, hs), False).result(), top)
        pos0 = np.full(S, -1, np.int32)
        pos0[:rows] = ctx
        limits = np.zeros(S, np.int32)
        limits[:rows] = PP * bs
        tok0 = np.zeros(S, np.int64)
        label = f"{name} fused decode dispatch ({rows} live rows of {S}, {steps} steps)"

        def eager_multi():
            outs, _ = eng._multi(d(tok0), samp.steps, eng._zero_counts, d(pos0), d(tables),
                                 d(limits), samp)
            return outs.tokens.cpu()

        _profile(f"{label}, eager", eager_multi, top)
        _profile(f"{label}, graph replay",
                 lambda: eng._start_d2h(eng._run_multi(tok0, pos0, tables, limits, hs),
                                        False).result(), top)
    eng.programs.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=8, help="live decode rows")
    ap.add_argument("--steps", type=int, default=8, help="decode_steps per dispatch")
    ap.add_argument("--top", type=int, default=12, help="kernels listed per phase")
    ap.add_argument("--configs", default="bf16,w8a8",
                    help=f"comma-separated, of {sorted(CONFIGS)}")
    args = ap.parse_args()
    for name in args.configs.split(","):
        profile_config(name, args.rows, args.steps, args.top)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
