"""Where a serving step's time goes on the card: one fused decode dispatch
and one prefill chunk of TorchEngine on llama-3.1-8b, under torch.profiler,
each as the eager calls and as the replay of its captured CUDA graph (what
the serving loop dispatches).

    python -m dynamo_tpu_torch.engine.profile_step [--rows 8] [--steps 8]

Prints, for each, the host wall time of an unprofiled run (ending in a
device synchronize), the summed device time of the kernels of a profiled
run, the device's idle share of the unprofiled wall (1 - busy / wall), the
kernels a run holds, whether the two attention kernels are among them, and
the kernels with the most device time.  Random seeded bf16 weights at full
width and depth; the KV pages the rows attend over are written by real
prefill steps first.  Needs a CUDA device.
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
    seen = {k: any(k in e.key for e in rows) for k in ("prefill_tc_kernel", "decode_tc_kernel")}
    print(f"{label}: wall {plain_ms:.3f} ms unprofiled ({wall_ms:.3f} ms profiled), "
          f"device busy {busy_ms:.3f} ms, idle share of the unprofiled wall "
          f"{max(0.0, 1 - busy_ms / plain_ms):.3f}, {launches} kernels; attention kernels "
          f"in the kernel rows {seen}")
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
        _profile("prefill chunk (512 tokens over 512, one row), eager",
                 lambda: eng._step(eager_batch(pre), samp).tokens.cpu(), args.top)
        _profile("prefill chunk (512 tokens over 512, one row), graph replay",
                 lambda: eng._start_d2h(eng._run_step(pre, hs), False).result(), args.top)
        pos0 = np.full(S, -1, np.int32)
        pos0[: args.rows] = ctx
        limits = np.zeros(S, np.int32)
        limits[: args.rows] = PP * bs
        tok0 = np.zeros(S, np.int64)
        label = f"fused decode dispatch ({args.rows} live rows of {S}, {args.steps} steps)"

        def eager_multi():
            outs, _ = eng._multi(d(tok0), samp.steps, eng._zero_counts, d(pos0), d(tables),
                                 d(limits), samp)
            return outs.tokens.cpu()

        _profile(f"{label}, eager", eager_multi, args.top)
        _profile(f"{label}, graph replay",
                 lambda: eng._start_d2h(eng._run_multi(tok0, pos0, tables, limits, hs),
                                        False).result(), args.top)
    eng.programs.close()


if __name__ == "__main__":
    main()
