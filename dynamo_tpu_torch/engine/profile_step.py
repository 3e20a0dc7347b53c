"""Where a serving step's time goes on the card: one fused decode dispatch
and one prefill chunk of TorchEngine on llama-3.1-8b, under torch.profiler.

    python -m dynamo_tpu_torch.engine.profile_step [--rows 8] [--steps 8]

Prints, for each of the two, the host wall time of an unprofiled run
(ending in a device synchronize), the summed device time of the kernels of
a profiled run, the device's idle share of the unprofiled wall
(1 - busy / wall), and the kernels with the most device time.  Random seeded bf16 weights at full width and depth; the KV
pages the rows attend over are written by real prefill steps first.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import default_device
from ..models.llama import RaggedBatch
from .config import EngineConfig
from .engine import TorchEngine


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


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
    ]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    print(f"{label}: wall {plain_ms:.3f} ms unprofiled ({wall_ms:.3f} ms profiled), "
          f"device busy {busy_ms:.3f} ms, idle share of the unprofiled wall "
          f"{max(0.0, 1 - busy_ms / plain_ms):.3f}, {launches} kernels")
    for e in sorted(rows, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=8, help="live decode rows")
    ap.add_argument("--steps", type=int, default=8, help="decode_steps per dispatch")
    ap.add_argument("--top", type=int, default=12, help="kernels listed per phase")
    args = ap.parse_args()
    dev = default_device()
    cfg = EngineConfig(
        model="llama-3.1-8b", dtype="bfloat16", block_size=16, num_blocks=2048,
        max_batch=16, max_model_len=4096, prefill_chunk=512,
        decode_steps=args.steps, seed=0,
    )
    eng = TorchEngine(cfg, device=dev)
    S, bs, PP = cfg.max_batch, cfg.block_size, cfg.max_blocks_per_seq
    rng = np.random.default_rng(0)
    ctx = [1024 + 128 * i for i in range(args.rows)]
    tables = np.zeros((S, PP), np.int32)
    for i, n in enumerate(ctx):  # disjoint pages per row
        tables[i, : PP] = np.arange(i * PP, (i + 1) * PP) % cfg.num_blocks
    d = eng._to_device
    samp = eng._sampling_arrays([None] * S)

    def chunk(row: int, start: int, n: int) -> RaggedBatch:
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
        return RaggedBatch(d(tok), d(posp), d(slots), d(kv), d(tab), d(cu),
                           d(np.asarray([1], np.int32)))

    with torch.inference_mode():
        for i, n in enumerate(ctx):  # real K/V for every context position
            for start in range(0, n, cfg.prefill_chunk):
                eng._step(chunk(i, start, min(cfg.prefill_chunk, n - start)), samp)
        torch.cuda.synchronize()
        pre = chunk(0, 512, 512)  # a 512-token chunk over a 512-token prefix
        _profile("prefill chunk (512 tokens over 512, one row)",
                 lambda: eng._fetch(eng._step(pre, samp), False), args.top)
        pos0 = np.full(S, -1, np.int32)
        pos0[: args.rows] = ctx
        limits = np.zeros(S, np.int32)
        limits[: args.rows] = PP * bs
        tok0 = np.zeros(S, np.int64)
        margs = (d(tok0), d(pos0), d(tables), d(limits))
        _profile(f"fused decode dispatch ({args.rows} live rows of {S}, {args.steps} steps)",
                 lambda: eng._fetch(eng._multi(*margs, samp), False), args.top)


if __name__ == "__main__":
    main()
