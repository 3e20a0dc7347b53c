"""Launch-shape tuner of the port's attention kernels
(``python -m dynamo_tpu_torch.tools.tune_decode``).

The counterpart of the JAX package's ``tools/tune_decode.py``: it sweeps
the kernels' launch knobs at one (model, batch, page-size) geometry and
writes the winners into the JSON table that engine init loads
(``ops/decode_attention.install_tuned_hints``); a geometry with no entry
keeps the built-in launch.  Two families are swept:

- **decode** (``csrc/decode_attention.cu``): ``splits`` (page-aligned runs
  a row's table is cut into; 0 = auto) and ``ppcb`` (pages a partition
  holds when ``splits`` is auto), combined as
  ``ops/decode_attention.decode_partitions`` combines them;
- **prefill** (``csrc/prefill_attention.cu``): ``prefill_splits`` (KV
  splits of a chunk), at a chunked-prefill geometry: every row computing
  the last ``--prefill-chunk`` tokens of a full paged chain.

The JAX tool's stock-kernel family (``--nq``, ``--nkv-mb``) and prefill
tiles (``--prefill-qb``, ``--prefill-ppcb``) have no counterpart: the port
has no stock kernel, and its tiles are fixed when a kernel is compiled.
Those flags are accepted and reported, not swept, so a JAX command line
runs unchanged.

Every case is full chains (the longest context of the geometry), its
inputs drawn with numpy from ``--seed``.  On the card (the default device)
each combination is timed with CUDA events as ``chip_smoke.py`` times the
kernels: the L2 flushed before every launch, a spin kernel holding the
stream while the host queues a round of ``--iters`` launches, the median
of ROUNDS rounds' means.  Each combination's output is held against the
plain version at the kernel's tolerance (1e-2: bf16 queries); one that
fails, or that the kernel refuses, is reported and cannot win.  The
built-in launch is timed beside them (the row marked ``default``).  With
``--device cpu`` every combination runs the plain versions and the write
path, and the timings mean nothing: a smoke, as the JAX tool's interpret
mode.  Resolution order stays env var > tuned table > default, so a sweep
never overrides an operator's pin; the sweep itself runs with neither.

Example (the card):
    python -m dynamo_tpu_torch.tools.tune_decode --model llama-3.1-8b \\
        --batch 256 --page-size 16 --pages-per-seq 16 --cache-dtype int8 \\
        --out ~/.cache/dynamo_tpu_torch/decode_tune.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from ..models.config import get_config
from ..ops import decode_attention as da
from ..ops import prefill_attention as pa
from ..ops.ragged_attention import quantize_for_cache

ROUNDS = 7  # timed rounds of a combination; its time is their median
TOL = 1e-2  # the kernels' tolerance against their plain versions (bf16 q)
SPIN_CYCLES = 10_000_000  # ~5 ms at an H100's clocks: the host queues a round meanwhile
FLUSH_BYTES = 64 << 20  # more than an H100's 50 MB of L2
KNOB_ENV = ("DYN_DECODE_SPLITS", "DYN_DECODE_FUSED_PPCB", "DYN_PREFILL_SPLITS")


def _pages(rng, P: int, page_size: int, KV: int, D: int, cache_dtype: str):
    """Pages ``[P, ps, 2KV, D]`` of N(0, 1) values and their scale, as the
    JAX tool draws them: int8 pages store 40x the values (scale 1/40)."""
    vals = rng.standard_normal((P, page_size, 2 * KV, D), dtype=np.float32)
    if cache_dtype == "int8":
        q8 = np.clip(np.round(vals * 40.0), -127, 127).astype(np.int8)
        return torch.from_numpy(q8), 1.0 / 40.0
    return quantize_for_cache(torch.from_numpy(vals), getattr(torch, cache_dtype)), None


def _tables(rng, batch: int, pages_per_seq: int) -> torch.Tensor:
    return torch.from_numpy(
        rng.permutation(batch * pages_per_seq).reshape(batch, pages_per_seq).astype(np.int32))


def _build_case(model: str, batch: int, page_size: int, pages_per_seq: int,
                cache_dtype: str, seed: int, device=None):
    """A decode step of ``batch`` rows, each at the full ``pages_per_seq``
    chain: (q, pages, kv_lens, tables, num, sm_scale, kv_scale)."""
    dev = default_device(device)
    c = get_config(model)
    H, KV, D = c.num_heads, c.num_kv_heads, c.head_dim
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((batch, H, D), dtype=np.float32)).to(torch.bfloat16)
    pages, kv_scale = _pages(rng, batch * pages_per_seq + 1, page_size, KV, D, cache_dtype)
    tables = _tables(rng, batch, pages_per_seq)
    kv_lens = torch.full((batch,), pages_per_seq * page_size, dtype=torch.int32)
    num = torch.tensor([batch], dtype=torch.int32)
    q, pages, kv_lens, tables, num = (t.to(dev) for t in (q, pages, kv_lens, tables, num))
    return q, pages, kv_lens, tables, num, D**-0.5, kv_scale


def _build_prefill_case(model: str, batch: int, page_size: int, pages_per_seq: int,
                        cache_dtype: str, chunk: int, seed: int, device=None):
    """Chunked-prefill geometry: every row is computing its LAST ``chunk``
    prompt tokens against a full paged chain (prefix + own chunk already
    in cache): (q, pages, kv_lens, tables, cu, num, sm_scale, kv_scale)."""
    dev = default_device(device)
    c = get_config(model)
    H, KV, D = c.num_heads, c.num_kv_heads, c.head_dim
    chunk = min(chunk, pages_per_seq * page_size)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(
        rng.standard_normal((batch * chunk, H, D), dtype=np.float32)).to(torch.bfloat16)
    pages, kv_scale = _pages(rng, batch * pages_per_seq + 1, page_size, KV, D, cache_dtype)
    tables = _tables(rng, batch, pages_per_seq)
    kv_lens = torch.full((batch,), pages_per_seq * page_size, dtype=torch.int32)
    cu = torch.arange(batch + 1, dtype=torch.int32) * chunk
    num = torch.tensor([batch], dtype=torch.int32)
    q, pages, kv_lens, tables, cu, num = (t.to(dev) for t in (q, pages, kv_lens, tables, cu, num))
    return q, pages, kv_lens, tables, cu, num, D**-0.5, kv_scale


@contextlib.contextmanager
def _knobs_unset():
    """The sweep's launches take only the knobs it passes: the knobs' env
    pins are lifted for its duration and any installed entry is cleared."""
    saved = {k: os.environ.pop(k) for k in KNOB_ENV if k in os.environ}
    da.clear_tuned_hints()
    try:
        yield
    finally:
        os.environ.update(saved)


_flush: Dict[torch.device, torch.Tensor] = {}


def _time_fn(fn, iters: int) -> float:
    """Median microseconds a call (after one warmup call).  On CUDA: each
    launch between CUDA events with the L2 flushed before it, a spin kernel
    holding the stream while the host queues a round of ``iters`` (a round
    is made again with a longer spin if the spin ends first); the median
    of ROUNDS rounds' means.  Elsewhere: the median wall time of ``iters``
    calls."""
    out = fn()
    if out.device.type != "cuda":
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(samples)
    dev = out.device
    flush = _flush.get(dev)
    if flush is None:
        flush = _flush[dev] = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    torch.cuda.synchronize(dev)
    rounds = []
    for _ in range(ROUNDS):
        for attempt in range(4):
            torch.cuda._sleep(SPIN_CYCLES * 4**attempt)
            spun = torch.cuda.Event()
            spun.record()
            pairs = []
            for _ in range(iters):
                flush.zero_()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                pairs.append((a, b))
            queued_in_time = not spun.query()
            torch.cuda.synchronize(dev)
            if queued_in_time:
                rounds.append(sum(a.elapsed_time(b) for a, b in pairs) * 1e3 / iters)
                break
        else:
            raise RuntimeError("the host could not queue a timed round within the spin")
    return statistics.median(rounds)


def _measure(fn, want: torch.Tensor, iters: int) -> Dict[str, Any]:
    """One launch configuration: its output against the plain version's,
    then its time (a configuration that fails its check is not timed)."""
    got = fn().float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
    out: Dict[str, Any] = {"max_abs_err": err, "ok": ok}
    if ok:
        out["us"] = round(_time_fn(fn, iters), 2)
    return out


def _line(r: Dict[str, Any]) -> str:
    if "rejected" in r:
        return f"rejected: {r['rejected']}"
    t = f"{r['us']:.2f}us" if "us" in r else "not timed"
    return f"{t}, max_abs_err {r['max_abs_err']:.3e} {'ok' if r['ok'] else 'check failed'}"


def _best(results: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    ok = [r for r in results if r.get("ok") and not r.get("default")]
    return min(ok, key=lambda r: r["us"]) if ok else None


def sweep_fused(case, splits_list: List[int], ppcb_list: List[int],
                iters: int) -> Tuple[Optional[Dict[str, Any]], List[Dict]]:
    """The decode family: every (splits, ppcb) pair with ppcb at most the
    table width, and the built-in launch first (``default``: timed, never
    a winner).  Pairs that give the same launch are measured once."""
    q, pages, kv_lens, tables, num, sm, kv_scale = case
    PP, ps = tables.shape[1], pages.shape[1]

    def run(s, p):
        return lambda: da.decode_attention(q, pages, kv_lens, tables, num, sm_scale=sm,
                                           kv_scale=kv_scale, num_kv_splits=s, pages_per_block=p)

    with _knobs_unset():
        want = da.decode_attention_plain(q, pages, kv_lens, tables, num, sm_scale=sm,
                                         kv_scale=kv_scale).float()
        part, J = da.decode_partitions(PP, ps)
        results = [{"splits": None, "ppcb": None, "part": part, "J": J, "default": True,
                    **_measure(run(None, None), want, iters)}]
        print(f"tune: fused built-in launch (part {part} x {J}): {_line(results[0])}",
              file=sys.stderr)
        seen: Dict[Tuple[int, int], Dict[str, Any]] = {}
        for s in splits_list:
            for p in ppcb_list:
                if p > PP:
                    continue
                try:
                    plan = da.decode_partitions(PP, ps, s, p)
                except ValueError as e:
                    r = {"splits": s, "ppcb": p, "rejected": str(e)}
                else:
                    if plan not in seen:
                        seen[plan] = _measure(run(s, p), want, iters)
                    r = {"splits": s, "ppcb": p, "part": plan[0], "J": plan[1], **seen[plan]}
                results.append(r)
                plan_text = f" (part {r['part']} x {r['J']})" if "part" in r else ""
                print(f"tune: fused splits={s} ppcb={p}{plan_text}: {_line(r)}", file=sys.stderr)
    return _best(results), results


def sweep_prefill(case, splits_list: List[int],
                  iters: int) -> Tuple[Optional[Dict[str, Any]], List[Dict]]:
    """The prefill family: every KV-split count, and the built-in launch
    first (``default``).  Counts that give the same launch are measured
    once."""
    q, pages, kv_lens, tables, cu, num, sm, kv_scale = case
    PP = tables.shape[1]

    def run(s):
        return lambda: pa.prefill_attention(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                            kv_scale=kv_scale, num_kv_splits=s)

    with _knobs_unset():
        want = pa.prefill_attention_plain(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                          kv_scale=kv_scale).float()
        split_pages, J = pa.prefill_partitions(PP)
        results = [{"splits": None, "split_pages": split_pages, "J": J, "default": True,
                    **_measure(run(None), want, iters)}]
        print(f"tune: prefill built-in launch ({J} x {split_pages} pages): {_line(results[0])}",
              file=sys.stderr)
        seen: Dict[Tuple[int, int], Dict[str, Any]] = {}
        for s in splits_list:
            plan = pa.prefill_partitions(PP, s)
            if plan not in seen:
                seen[plan] = _measure(run(s), want, iters)
            r = {"splits": s, "split_pages": plan[0], "J": plan[1], **seen[plan]}
            results.append(r)
            print(f"tune: prefill splits={s} ({plan[1]} x {plan[0]} pages): {_line(r)}",
                  file=sys.stderr)
    return _best(results), results


def write_entry(path: str, key: str, entry: Dict[str, Any]) -> None:
    """Merge one geometry's entry into the table (other keys preserved)."""
    table: Dict[str, Any] = {}
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        pass
    if not isinstance(table, dict):
        table = {}
    table[key] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="debug-tiny")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--pages-per-seq", type=int, default=64)
    ap.add_argument("--cache-dtype", default="int8")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--splits", default="0,1,2,4,8,16",
                    help="decode KV-split candidates, 0 = auto (comma list)")
    ap.add_argument("--ppcb", default="4,8,16,32,64",
                    help="decode pages-per-partition candidates (when splits is auto)")
    ap.add_argument("--nq", default="8,16,32",
                    help="the TPU stock kernel's query blocks: no counterpart, not swept")
    ap.add_argument("--nkv-mb", default="2,4,8",
                    help="the TPU stock kernel's KV budgets: no counterpart, not swept")
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="prompt tokens per row in the prefill sweep case")
    ap.add_argument("--prefill-qb", default="64,128,256",
                    help="prefill query blocks: compiled into the kernel here, not swept")
    ap.add_argument("--prefill-splits", default="1,2,4",
                    help="prefill KV-split candidates")
    ap.add_argument("--prefill-ppcb", default="1,2,4,8",
                    help="prefill pages per compute block: compiled into the kernel here, "
                         "not swept")
    ap.add_argument("--out", default=None,
                    help="table path (default: DYN_DECODE_TUNE_TABLE or "
                         "~/.cache/dynamo_tpu_torch/decode_tune.json)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; needs a card) or cpu (a smoke: the plain versions)")
    args = ap.parse_args(argv)

    ints = lambda s: [int(x) for x in str(s).split(",") if x.strip()]  # noqa: E731
    dev = default_device(args.device)
    not_swept = {"nq": ints(args.nq), "nkv_mb": ints(args.nkv_mb),
                 "prefill_qb": ints(args.prefill_qb), "prefill_ppcb": ints(args.prefill_ppcb)}
    print(f"tune: not swept (no counterpart in the port): {not_swept}", file=sys.stderr)
    with torch.inference_mode():
        case = _build_case(args.model, args.batch, args.page_size, args.pages_per_seq,
                           args.cache_dtype, args.seed, dev)
        fused_best, fused_all = sweep_fused(case, ints(args.splits), ints(args.ppcb), args.iters)
        del case
        prefill_case = _build_prefill_case(
            args.model, args.batch, args.page_size, args.pages_per_seq, args.cache_dtype,
            args.prefill_chunk, args.seed, dev,
        )
        prefill_best, prefill_all = sweep_prefill(prefill_case, ints(args.prefill_splits),
                                                  args.iters)
        del prefill_case
    if fused_best is None and prefill_best is None:
        print("tune: no combo survived — nothing written", file=sys.stderr)
        return 1

    entry: Dict[str, Any] = {
        "geometry": {
            "model": args.model, "batch": args.batch,
            "page_size": args.page_size, "pages_per_seq": args.pages_per_seq,
            "cache_dtype": args.cache_dtype,
        },
        "backend": "gpu" if dev.type == "cuda" else "cpu",
        "iters": args.iters,
    }
    if fused_best:
        entry.update(splits=fused_best["splits"], ppcb=fused_best["ppcb"],
                     fused_us=fused_best["us"])
    if prefill_best:
        # Keys match resolve_hint's tuned_key names in the ops modules, so
        # install_tuned_hints serves them with no extra plumbing.
        entry.update(prefill_splits=prefill_best["splits"], prefill_us=prefill_best["us"])
    path = args.out or da.default_table_path()
    key = da.hint_key(args.model, args.batch, args.page_size)
    write_entry(path, key, entry)
    print(json.dumps({"key": key, "path": path, "entry": entry,
                      "fused_sweep": fused_all, "stock_sweep": [],
                      "prefill_sweep": prefill_all, "not_swept": not_swept}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
