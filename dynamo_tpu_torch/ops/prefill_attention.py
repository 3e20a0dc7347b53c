"""Ragged chunked paged PREFILL attention: the hand-written Hopper kernel's
wrapper and its plain PyTorch version.

Replaces ``dynamo_tpu/ops/prefill_attention.py::fused_prefill_attention``
(a Pallas TPU kernel).  Row ``s``'s queries are the LAST
``q_len = cu[s+1] - cu[s]`` tokens of its ``kv_len``-token context, whose
K/V already sit in the pages; causal mask ``ctx <= kv_len - q_len + t``;
quantized pages dequantized in-kernel by a scalar ``kv_scale``; exact zeros
for tokens at or past ``cu_q_lens[num_seqs]``.  The kernel and its design
notes are in ``csrc/prefill_attention.cu``.

``prefill_attention`` routes by the tensors' device: CUDA tensors launch
the kernel (or raise), CPU tensors take ``prefill_attention_plain``, a port
of the XLA path of the JAX package's ``ragged_attention``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .decode_attention import HEAD_DIM, NEG_INF, check_paged_inputs, gather_rows, resolve_hint

ROWS = 64  # csrc/prefill_attention.cu ROWS: query-head rows per block
SMALL_ROWS = 16  # csrc/prefill_attention.cu RW: rows of a small q-block
SMALL_SLICES = 4  # csrc/prefill_attention.cu SMALL_SLICES


def prefill_attention_plain(
    q: torch.Tensor,  # [T, H, D]
    pages: torch.Tensor,  # [P, ps, 2KV, D]
    kv_lens: torch.Tensor,  # [S] int32
    page_indices: torch.Tensor,  # [S, PP] int32
    cu_q_lens: torch.Tensor,  # [S+1] int32
    num_seqs: torch.Tensor,  # [1] int32
    *,
    sm_scale: float,
    kv_scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-and-softmax reference in f32, one row at a time: each row's
    ``kv_len`` context is gathered once for all of its query tokens (the
    XLA path gathers the whole table width per token; the masked result is
    the same, at a fraction of the memory)."""
    T, H, D = q.shape
    ps, KV = pages.shape[1], pages.shape[2] // 2
    G = H // KV
    dev = q.device
    flat = pages.reshape(-1, 2 * KV, D)
    out = torch.zeros((T, H, D), dtype=torch.float32, device=dev)
    n = int(num_seqs[0])
    cu = cu_q_lens.tolist()
    lens = kv_lens.tolist()
    for s in range(n):
        a, b, L = cu[s], cu[s + 1], lens[s]
        ql = b - a
        if ql <= 0 or L <= 0:
            continue
        ctx = torch.arange(L, device=dev)
        slots = page_indices[s, ctx // ps].long() * ps + ctx % ps
        kv = gather_rows(flat, slots)  # [L, 2KV, D]
        k = kv[:, 0::2].float()
        v = kv[:, 1::2].float()
        if kv_scale is not None and float(kv_scale) != 1.0:
            k = k * float(kv_scale)
            v = v * float(kv_scale)
        qf = q[a:b].reshape(ql, KV, G, D).float() * sm_scale
        logits = torch.einsum("tkgd,wkd->tkgw", qf, k)  # [ql, KV, G, L]
        qpos = L - ql + torch.arange(ql, device=dev)
        mask = ctx[None, :] <= qpos[:, None]  # [ql, L]
        logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m) * mask[:, None, None, :]
        o = torch.einsum("tkgw,wkd->tkgd", p, v) / (p.sum(-1, keepdim=True) + 1e-30)
        out[a:b] = o.reshape(ql, H, D)
    return out.to(q.dtype)


def prefill_slots(T: int, S: int, G: int, tensor_cores: bool) -> int:
    """Block slots a prefill launch needs per KV head and split, from the
    shapes alone (no host read of ``cu_q_lens``): one per 64-row q-block of
    the T-token bucket, plus what the ragged rows' partial q-blocks can add
    — at most one more a row, which the tensor-core body cuts into
    ``SMALL_SLICES`` key slices when it fits one warp.  The kernel maps
    slots to q-blocks on the device; the slots left over zero the padding
    tokens, and there are always enough of them."""
    qb = ROWS // G
    return -(-T // qb) + S * (SMALL_SLICES if tensor_cores else 1)


def prefill_partitions(PP: int, num_kv_splits: Optional[int] = None) -> Tuple[int, int]:
    """``(split_pages, n_splits)`` of a prefill launch: the table's ``PP``
    pages cut into ``n_splits`` page-aligned runs of ``split_pages``,
    empty tail runs dropped, as the JAX kernel cuts them
    (``dynamo_tpu/ops/prefill_attention.py:325-331``; the port has no
    ``prefill_ppcb``, so only ``PP`` caps the count).  None or a count
    below 1 means 1: the q-block grid already spreads a chunk over the
    SMs."""
    J = max(1, min(num_kv_splits or 1, PP))
    split_pages = -(-PP // J)
    return split_pages, -(-PP // split_pages)


def prefill_plan(PP: int, num_kv_splits: Optional[int] = None) -> Tuple[int, int]:
    """The launch's ``(split_pages, n_splits)`` with its knob resolved: an
    explicit ``num_kv_splits``, else ``DYN_PREFILL_SPLITS`` / tuned
    ``prefill_splits``."""
    return prefill_partitions(
        PP, num_kv_splits or resolve_hint("DYN_PREFILL_SPLITS", "prefill_splits", 0))


_slice_scratch: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def slice_scratch(device: torch.device, n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scratch of the small q-blocks' key slices for ``n`` (split, row, KV
    head) triples, for launches on ``device``'s current stream: partial
    outputs, their (m, l), and int32 arrival counters.  One buffer serves
    every launch on that stream, which runs them in order: the counters are
    zero before a launch and left zero after it (the last slice of a
    q-block to arrive resets its counter).  Each stream has its own, so
    launches on two streams never share counters.  Grown, with fresh zero
    counters, when a launch needs more."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    have = _slice_scratch.get(key)
    if have is None or have[2].numel() < n:
        n = max(n, 256)
        have = (
            torch.empty((n, SMALL_SLICES, SMALL_ROWS, HEAD_DIM), dtype=torch.float32, device=device),
            torch.empty((n, SMALL_SLICES, SMALL_ROWS, 2), dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.int32, device=device),
        )
        _slice_scratch[key] = have
    return have


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("prefill_attention")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.prefill_attention_launch.argtypes = [vp] * 13 + [ci] * 12 + [cf, cf, vp]
    lib.prefill_attention_launch.restype = ci
    return lib


def prefill_attention_cuda(
    q: torch.Tensor,
    pages: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    *,
    sm_scale: float,
    kv_scale: Optional[float] = None,
    num_kv_splits: Optional[int] = None,
) -> torch.Tensor:
    """Launch csrc/prefill_attention.cu on the current stream (no sync).
    ``num_kv_splits`` None takes the resolved knob (``prefill_plan``), 1
    when unset: the q-block grid already spreads a chunk over the SMs, and
    the kernel then writes ``out`` itself with no combine pass.  bf16
    queries run on the tensor cores, f32 queries on the f32 CUDA-core
    body."""
    check_paged_inputs(q, pages, (kv_lens, page_indices, cu_q_lens, num_seqs))
    T, H, D = q.shape
    P, ps, KV2, _ = pages.shape
    KV = KV2 // 2
    G = H // KV
    S, PP = page_indices.shape
    if ROWS % G:
        raise ValueError(f"prefill kernel needs {ROWS} % G == 0, got G={G}")
    if kv_lens.shape != (S,) or cu_q_lens.shape != (S + 1,) or num_seqs.shape != (1,):
        raise ValueError("kv_lens / cu_q_lens / num_seqs do not match page_indices' rows")
    split_pages, J = prefill_plan(PP, num_kv_splits)
    dev = q.device
    o_part = m_part = l_part = None  # one partition: the kernel writes ``out`` itself
    if J > 1:
        o_part = torch.empty((J, T, H, D), dtype=torch.float32, device=dev)
        m_part = torch.empty((J, T, H), dtype=torch.float32, device=dev)
        l_part = torch.empty((J, T, H), dtype=torch.float32, device=dev)
    slice_o = slice_ml = slice_cnt = None  # key slices of small q-blocks (bf16 q)
    if q.dtype == torch.bfloat16:
        slice_o, slice_ml, slice_cnt = slice_scratch(dev, J * S * KV)
    out = torch.empty_like(q)
    lib = _lib()
    p = _build.ptr
    code = lib.prefill_attention_launch(
        p(q), p(pages), p(kv_lens), p(page_indices), p(cu_q_lens), p(num_seqs),
        p(o_part), p(m_part), p(l_part), p(out), p(slice_o), p(slice_ml), p(slice_cnt),
        prefill_slots(T, S, G, q.dtype == torch.bfloat16), T, S, KV, G, P, ps, PP, J, split_pages,
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[pages.dtype],
        float(sm_scale), 1.0 if kv_scale is None else float(kv_scale),
        _build.stream_ptr(dev),
    )
    _build.check(lib, code, "prefill_attention")
    prefill_attention_cuda.launches += 1
    prefill_attention_cuda.last_plan = (split_pages * ps, J)
    return out


prefill_attention_cuda.launches = 0  # kernel launches (chip_smoke.py reads it)
prefill_attention_cuda.last_plan = None  # the last launch's (split positions, n_splits)


def prefill_attention(q, pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
                      sm_scale, kv_scale=None, num_kv_splits=None) -> torch.Tensor:
    """Route by device: CUDA tensors launch the kernel, CPU tensors take the
    plain version.  No fallback: a kernel that fails to build or launch
    raises."""
    if q.device.type == "cuda":
        return prefill_attention_cuda(
            q, pages, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale=sm_scale, kv_scale=kv_scale, num_kv_splits=num_kv_splits,
        )
    if q.device.type == "cpu":
        return prefill_attention_plain(
            q, pages, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale=sm_scale, kv_scale=kv_scale,
        )
    raise ValueError(f"no prefill attention for device {q.device}")
