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
from typing import Optional

import torch

from . import _build
from .decode_attention import NEG_INF, check_paged_inputs, gather_rows

ROWS = 64  # csrc/prefill_attention.cu ROWS: query-head rows per block


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("prefill_attention")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.prefill_attention_launch.argtypes = [vp] * 10 + [ci] * 11 + [cf, cf, vp]
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
    ``num_kv_splits`` None means 1: the q-block grid already spreads a
    chunk over the SMs."""
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
    J = max(1, min(num_kv_splits or 1, PP))
    split_pages = -(-PP // J)
    J = -(-PP // split_pages)
    dev = q.device
    o_part = torch.empty((J, T, H, D), dtype=torch.float32, device=dev)
    m_part = torch.empty((J, T, H), dtype=torch.float32, device=dev)
    l_part = torch.empty((J, T, H), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = _lib()
    p = _build.ptr
    code = lib.prefill_attention_launch(
        p(q), p(pages), p(kv_lens), p(page_indices), p(cu_q_lens), p(num_seqs),
        p(o_part), p(m_part), p(l_part), p(out),
        T, S, KV, G, P, ps, PP, J, split_pages,
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[pages.dtype],
        float(sm_scale), 1.0 if kv_scale is None else float(kv_scale),
        _build.stream_ptr(dev),
    )
    _build.check(lib, code, "prefill_attention")
    prefill_attention_cuda.launches += 1
    return out


prefill_attention_cuda.launches = 0  # kernel launches (chip_smoke.py reads it)


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
