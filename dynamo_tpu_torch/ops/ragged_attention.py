"""Unified ragged paged attention: the KV write and the dispatch to the two
attention kernels.

A step is a flat run of tokens — any mix of prompt chunks and decode tokens
— described by ``cu_q_lens`` row boundaries (the JAX package's
``ops/ragged_attention.py`` contract).  Cache layout per layer:
``[num_pages, page_size, 2 * kv_heads, head_dim]`` with K at even and V at
odd combined-head indices.

Routing follows the tensors' device and nothing else: CUDA tensors go to
the hand-written kernels (ops/decode_attention.py, ops/prefill_attention.py),
CPU tensors to their plain versions.  There is no selector that could pick
a different implementation on the same device and no fallback on failure.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .decode_attention import decode_attention
from .prefill_attention import prefill_attention

def kernel_route(device: torch.device) -> str:
    """The attention route of tensors on ``device``: ``cuda`` (the
    hand-written Hopper kernels, dynamo_tpu_torch/csrc) on a CUDA device,
    ``plain`` (their PyTorch reference versions) anywhere else."""
    return "cuda" if device.type == "cuda" else "plain"


def quantize_for_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Make already-scaled values representable in a page dtype.

    int8: round half to even (``torch.round``, as ``jnp.round``), then
    clip — a bare cast truncates toward zero and wraps on overflow.
    float8 e4m3fn: clip to ±finfo.max first — the format has no inf, so an
    overflowing cast becomes NaN and one NaN K row poisons every later read
    of its page."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = torch.round(x.float()).clamp(info.min, info.max)
    elif dtype.itemsize == 1:
        fmax = float(torch.finfo(dtype).max)
        x = x.float().clamp(-fmax, fmax)
    return x.to(dtype)


_SAME_WIDTH_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


class KvWritePlan(NamedTuple):
    """Where a step's K/V rows go — the same for every layer, so the model
    computes it once per step (``kv_write_plan``)."""

    dst: torch.Tensor  # [T] int64 destination slot of every row
    keep: torch.Tensor  # [T] bool: slot >= 0
    first: torch.Tensor  # [1] index of the first kept row (0 if none)
    any_keep: torch.Tensor  # [1] bool


def kv_write_plan(slot_mapping: torch.Tensor) -> KvWritePlan:
    """Rows with slot -1 are dropped without a host sync: they are
    redirected to repeat the first kept row's write (``index_copy_`` with
    duplicate indices is well defined when the duplicates carry equal
    values), or, when no row is kept, to rewrite slot 0 with its own
    contents.  ``index_select``, never a 0-dim tensor index, which would
    read the index back to the host and stall the stream."""
    slots = slot_mapping.long()
    keep = slots >= 0
    first = torch.argmax(keep.to(torch.uint8)).reshape(1)
    any_keep = keep.index_select(0, first)
    dst = torch.where(keep, slots, torch.where(any_keep, slots.index_select(0, first), 0))
    return KvWritePlan(dst, keep, first, any_keep)


def write_kv_ragged(
    pages: torch.Tensor,  # [num_pages, page_size, 2*kv_heads, head_dim]
    k_new: torch.Tensor,  # [T, kv_heads, head_dim]
    v_new: torch.Tensor,  # [T, kv_heads, head_dim]
    slot_mapping: torch.Tensor,  # [T] int32 flat slot ids; -1 = padding (dropped)
    kv_scale: Optional[float] = None,  # quantized cache: store value / scale
    plan: Optional[KvWritePlan] = None,  # kv_write_plan(slot_mapping), if made
) -> torch.Tensor:
    """Scatter new K/V rows into their cache slots, IN PLACE (the JAX
    package threaded the slab functionally); returns ``pages``.  Slot -1
    rows are dropped (see ``kv_write_plan``)."""
    if not pages.is_contiguous():
        raise ValueError("pages must be contiguous for the in-place write")
    P, ps, KV2, D = pages.shape
    T = k_new.shape[0]
    # [T, KV, 2, D] -> [T, 2KV, D]: k_h at combined index 2h, v_h at 2h+1.
    comb = torch.stack([k_new, v_new], dim=2).reshape(T, KV2, D)
    if kv_scale is not None:
        comb = comb.float() / float(kv_scale)
    comb = quantize_for_cache(comb, pages.dtype)
    as_int = _SAME_WIDTH_INT[pages.element_size()]
    flat = pages.view(P * ps, KV2, D).view(as_int)
    src = comb.view(as_int)
    dst, keep, first, any_keep = plan if plan is not None else kv_write_plan(slot_mapping)
    fill = torch.where(any_keep[:, None, None], src.index_select(0, first), flat[:1])
    src = torch.where(keep[:, None, None], src, fill)
    flat.index_copy_(0, dst, src)
    return pages


class SingleRowPlan(NamedTuple):
    """Which rows of a step are single tokens, and where their decode-op
    outputs go — the same for every layer, so the model computes it once per
    step (``single_row_plan``)."""

    at: torch.Tensor  # [S] int64 each row's first token (clamped into the step)
    single: torch.Tensor  # [S] bool: a live row of one token
    kv_prefill: torch.Tensor  # [S] int32 the prefill op's context lengths
    kv_decode: torch.Tensor  # [S] int32 the decode op's context lengths
    src: torch.Tensor  # [S] int64 decode-op row each row's write takes
    dst: torch.Tensor  # [S] int64 token each row's write lands on
    any_single: torch.Tensor  # [1] bool


def single_row_plan(kv_lens: torch.Tensor, cu_q_lens: torch.Tensor, num_seqs: torch.Tensor,
                    num_tokens: int) -> SingleRowPlan:
    """The prefill op sees the single-token rows with a 1-token context
    (their output is replaced) and the decode op every other row with an
    empty one.  The single rows' outputs go back with one ``index_copy_``
    and no host sync: the other rows repeat the first single row's write
    (duplicate indices carrying equal values, as in ``kv_write_plan``), or
    rewrite token 0 with its own value when no row is single."""
    at = cu_q_lens[:-1].long().clamp(max=num_tokens - 1)
    single = ((cu_q_lens[1:] - cu_q_lens[:-1]) == 1) & (kv_lens > 0)
    single &= torch.arange(single.shape[0], device=kv_lens.device) < num_seqs.long()
    first = torch.argmax(single.to(torch.uint8)).reshape(1)
    any_single = single.index_select(0, first)
    rows = torch.arange(single.shape[0], device=kv_lens.device)
    return SingleRowPlan(
        at=at, single=single,
        kv_prefill=torch.where(single, torch.ones_like(kv_lens), kv_lens),
        kv_decode=torch.where(single, kv_lens, torch.zeros_like(kv_lens)),
        src=torch.where(single, rows, first),
        dst=torch.where(single, at, torch.where(any_single, at.index_select(0, first), 0)),
        any_single=any_single,
    )


def ragged_attention(
    q: torch.Tensor,  # [T, num_heads, head_dim]
    pages: torch.Tensor,  # [num_pages, page_size, 2*kv_heads, head_dim]
    kv_lens: torch.Tensor,  # [S] int32 context length per row
    page_indices: torch.Tensor,  # [S, pages_per_seq] int32
    cu_q_lens: torch.Tensor,  # [S+1] int32 cumulative query lengths
    num_seqs: torch.Tensor,  # [1] int32 valid rows
    *,
    sm_scale: float,
    kv_scale: Optional[float] = None,  # quantized pages: value = stored * scale
    decode: bool = False,  # every row is a 1-token decode row
    rows: Optional[SingleRowPlan] = None,  # single_row_plan(...), if made
) -> torch.Tensor:
    """Causal attention of each token against its row's paged context (the
    K/V must already be written — callers run write_kv_ragged first).
    ``kv_scale`` is applied inside the kernels (in-kernel dequant).

    ``decode=True`` routes to the decode kernel, whose rows are single
    tokens at position ``kv_len - 1`` (``cu_q_lens`` is then the identity
    and unused).  Otherwise rows of several tokens go to the prefill kernel
    and single-token rows to the decode kernel, so a decode position's
    output depends on its row's context alone, not on the step that carries
    it: a fused decode dispatch, a prefill chunk's step, or a speculative
    verification step (whose draft rows are single-token rows).  The two
    kernels agree only to rounding, and at a near-tie of the top logits
    that decides a token; without this, speculation on and off would give
    different streams on the card."""
    if decode:
        return decode_attention(
            q, pages, kv_lens, page_indices, num_seqs,
            sm_scale=sm_scale, kv_scale=kv_scale,
        )
    if rows is None:
        rows = single_row_plan(kv_lens, cu_q_lens, num_seqs, q.shape[0])
    out = prefill_attention(
        q, pages, rows.kv_prefill, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, kv_scale=kv_scale,
    )
    dec = decode_attention(
        q.index_select(0, rows.at), pages, rows.kv_decode, page_indices, num_seqs,
        sm_scale=sm_scale, kv_scale=kv_scale,
    )
    vals = torch.where(rows.any_single[:, None, None], dec.index_select(0, rows.src), out[:1])
    out.index_copy_(0, rows.dst, vals)
    return out
