"""Paged DECODE attention: the hand-written Hopper kernel's wrapper and its
plain PyTorch version.

Replaces ``dynamo_tpu/ops/decode_attention.py::fused_decode_attention``
(a Pallas TPU kernel).  One query token per row at context position
``kv_len - 1``; pages ``[P, ps, 2*KV, D]`` with K at even and V at odd
combined-head indices; quantized pages dequantized in-kernel by a scalar
``kv_scale``; exact zeros for rows past ``num_seqs`` and rows with
``kv_len`` 0.  The kernel and its design notes are in
``csrc/decode_attention.cu``.

``decode_attention`` routes by the tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors take ``decode_attention_plain``, a port of
the JAX package's XLA path ``ragged_decode_attention``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30  # the JAX package's mask value
HEAD_DIM = 128  # csrc/common.cuh HEAD_DIM
MAX_G = 8  # csrc/decode_attention.cu MAX_G
DECODE_PARTITION = 256  # context positions a decode block reads (a multiple of 16)


def gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat[idx]`` through a same-width integer view, so every page dtype
    (fp8 included) gathers with the same index kernel."""
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[flat.element_size()]
    return flat.view(as_int)[idx].view(flat.dtype)


def decode_attention_plain(
    q: torch.Tensor,  # [S, H, D]
    pages: torch.Tensor,  # [P, ps, 2KV, D]
    kv_lens: torch.Tensor,  # [S] int32
    page_indices: torch.Tensor,  # [S, PP] int32
    num_seqs: torch.Tensor,  # [1] int32
    *,
    sm_scale: float,
    kv_scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-and-softmax reference: each row's whole table width
    ``W = PP * ps`` is gathered, masked at ``ctx < kv_len``, in f32."""
    S, H, D = q.shape
    ps, KV = pages.shape[1], pages.shape[2] // 2
    G = H // KV
    W = page_indices.shape[1] * ps
    dev = q.device
    ctx = torch.arange(W, device=dev)
    slots = page_indices[:, ctx // ps].long() * ps + ctx % ps  # [S, W]
    kv = gather_rows(pages.reshape(-1, 2 * KV, D), slots)  # [S, W, 2KV, D]
    k = kv[:, :, 0::2].float()
    v = kv[:, :, 1::2].float()
    if kv_scale is not None and float(kv_scale) != 1.0:
        k = k * float(kv_scale)
        v = v * float(kv_scale)
    valid = torch.arange(S, device=dev) < num_seqs[0]
    qf = q.reshape(S, KV, G, D).float() * sm_scale
    logits = torch.einsum("skgd,swkd->skgw", qf, k)
    mask = (ctx[None, :] < kv_lens[:, None]) & valid[:, None]  # [S, W]
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask[:, None, None, :]
    out = torch.einsum("skgw,swkd->skgd", p, v) / (p.sum(-1, keepdim=True) + 1e-30)
    return out.reshape(S, H, D).to(q.dtype)


def check_paged_inputs(q, pages, index_tensors) -> None:
    """What the CUDA kernels take, checked before any pointer is passed."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    if pages.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"page dtype {pages.dtype} not supported")
    if q.dim() != 3 or pages.dim() != 4:
        raise ValueError(f"bad ranks q{tuple(q.shape)} pages{tuple(pages.shape)}")
    if q.shape[2] != HEAD_DIM or pages.shape[3] != HEAD_DIM:
        raise ValueError(f"head_dim must be {HEAD_DIM}, got {q.shape[2]}/{pages.shape[3]}")
    KV2 = pages.shape[2]
    if KV2 % 2 or q.shape[1] % (KV2 // 2):
        raise ValueError(f"{q.shape[1]} query heads do not group over {KV2 // 2} KV heads")
    for t in (q, pages, *index_tensors):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for t in index_tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")


def decode_partitions(PP: int, ps: int, num_kv_splits: Optional[int] = None) -> Tuple[int, int]:
    """``(part_tokens, n_parts)`` of a decode launch: each row's context is
    cut into runs of ``part_tokens`` positions, and the grid holds
    ``n_parts`` of them per (row, KV head) — enough for the whole table
    width ``PP * ps``, so the launch never reads ``kv_lens`` on the host.
    ``num_kv_splits`` (tests) cuts the table into that many page-aligned
    runs instead."""
    if num_kv_splits:
        J = max(1, min(num_kv_splits, PP))
        part = -(-PP // J) * ps
    else:
        part = DECODE_PARTITION
    return part, -(-PP * ps // part)


def covered_partitions(kv_len: int, part_tokens: int) -> int:
    """Partitions that hold a position of a ``kv_len`` context: the blocks
    of a row that do work, and the partials its combine reads (a row with
    one is written by its block, with none by the zero path)."""
    return -(-max(kv_len, 0) // part_tokens)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = [vp] * 9 + [ci] * 10 + [cf, cf, vp]
    lib.decode_attention_launch.restype = ci
    return lib


def decode_attention_cuda(
    q: torch.Tensor,
    pages: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    num_seqs: torch.Tensor,
    *,
    sm_scale: float,
    kv_scale: Optional[float] = None,
    num_kv_splits: Optional[int] = None,
) -> torch.Tensor:
    """Launch csrc/decode_attention.cu on the current stream (no sync).
    ``num_kv_splits`` None partitions by ``DECODE_PARTITION`` positions
    (``decode_partitions``)."""
    check_paged_inputs(q, pages, (kv_lens, page_indices, num_seqs))
    S, H, D = q.shape
    P, ps, KV2, _ = pages.shape
    KV = KV2 // 2
    G = H // KV
    PP = page_indices.shape[1]
    if G > MAX_G:
        raise ValueError(f"decode kernel takes at most {MAX_G} query heads per KV head, got {G}")
    if kv_lens.shape != (S,) or page_indices.shape[0] != S or num_seqs.shape != (1,):
        raise ValueError("kv_lens / page_indices / num_seqs do not match q's rows")
    part, J = decode_partitions(PP, ps, num_kv_splits)
    dev = q.device
    o_part = m_part = l_part = None  # one partition: the kernel writes ``out`` itself
    if J > 1:
        o_part = torch.empty((J, S, H, D), dtype=torch.float32, device=dev)
        m_part = torch.empty((J, S, H), dtype=torch.float32, device=dev)
        l_part = torch.empty((J, S, H), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = _lib()
    p = _build.ptr
    code = lib.decode_attention_launch(
        p(q), p(pages), p(kv_lens), p(page_indices), p(num_seqs),
        p(o_part), p(m_part), p(l_part), p(out),
        S, KV, G, P, ps, PP, J, part,
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[pages.dtype],
        float(sm_scale), 1.0 if kv_scale is None else float(kv_scale),
        _build.stream_ptr(dev),
    )
    _build.check(lib, code, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0  # kernel launches (chip_smoke.py reads it)


def decode_attention(q, pages, kv_lens, page_indices, num_seqs, *, sm_scale,
                     kv_scale=None, num_kv_splits=None) -> torch.Tensor:
    """Route by device: CUDA tensors launch the kernel, CPU tensors take the
    plain version.  No fallback: a kernel that fails to build or launch
    raises."""
    if q.device.type == "cuda":
        return decode_attention_cuda(
            q, pages, kv_lens, page_indices, num_seqs, sm_scale=sm_scale,
            kv_scale=kv_scale, num_kv_splits=num_kv_splits,
        )
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, pages, kv_lens, page_indices, num_seqs, sm_scale=sm_scale,
            kv_scale=kv_scale,
        )
    raise ValueError(f"no decode attention for device {q.device}")
