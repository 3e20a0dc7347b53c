"""W8A8-dynamic int8 matmul: the product behind quantized weights.

Port of the JAX package's ``ops/quant_matmul.py`` (``quantize_rows``,
``qdot``): dynamic symmetric per-row int8 activations times static
per-output-channel int8 weights, int32 accumulation, f32 rescale.  The JAX
package left all of it to XLA (no Pallas kernel), so here the int8 product
is one library call, ``torch._int_mm`` (cuBLASLt's int8 GEMM on CUDA, a
plain int8 GEMM on the CPU), and the quantize and rescale are plain torch
elementwise ops.  Fusing them (a row-quantize pass, a GEMM epilogue) is a
later item of ROADMAP queue 2.

On CUDA, cuBLASLt's int8 path takes K and N as multiples of 8 and more
than 16 rows: ``qdot`` pads the rows (zero rows quantize to zero) and
raises on a K or N it cannot take; it never falls back to a float matmul.
Weights are best stored column-major (``[N, K]`` contiguous seen as
``[K, N]``), the layout models/quant.py gives every int8 weight leaf.

int32 accumulation is exact for K up to ~130k (|acc| <= K * 127^2 < 2^31).
``qdot_batched``/``expert_linear`` are the MoE experts' batched products
(models/moe.py): rows quantized over ``[E, C, K]``, then one ``int_mm`` per
expert, the JAX package's ``einsum("eck,ekn->ecn")``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# qdot's three parts as named profiler ranges (engine/profile_step.py reads
# them); a range costs the host a few microseconds an eager call and nothing
# in a graph replay.
QDOT_PARTS = ("w8a8.quantize", "w8a8.int_mm", "w8a8.rescale")

# cuBLASLt's int8 GEMM: rows > 16; K and N multiples of 8.
_CUDA_MIN_ROWS = 17
_CUDA_ALIGN = 8


def quantize_rows(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8: returns (x_q int8, row_scale f32
    ``[..., 1]``).  Rows of zeros get scale 1e-9 and quantize to zeros.
    Rounds half to even (``torch.round``, as ``jnp.round``) and clips to
    ±127 before the cast.  The scale is ``max|x|`` times the f32
    reciprocal of 127: XLA compiles the JAX package's ``max / 127.0`` so
    inside its jitted forward (an eager division can differ by one ulp).

    With ``group`` (parallel/distributed.AxisGroup), ``x`` holds this
    rank's slice of every row (a row-parallel product's input):
    the row maximum is all-reduced (MAX) first, so every rank quantizes
    with the whole row's scale, as the sharded JAX product does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        amax = group.all_reduce(amax, "max")
    ax = torch.clamp(amax * (1.0 / 127.0), min=1e-9)
    xq = torch.clamp(torch.round(xf / ax), -127, 127).to(torch.int8)
    return xq, ax


def cuda_gemm_rows(M: int, K: int, N: int) -> int:
    """Rows an ``[M, K] x [K, N]`` int8 product is given on CUDA: more than
    16 and a multiple of 8 (the caller pads with zero rows).  Raises when K
    or N is not a multiple of 8."""
    if K % _CUDA_ALIGN or N % _CUDA_ALIGN:
        raise ValueError(f"int8 GEMM on CUDA needs K and N multiples of 8, got K={K} N={N}")
    return -(-max(_CUDA_MIN_ROWS, M) // _CUDA_ALIGN) * _CUDA_ALIGN


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ w [K, N] int8`` → int32 ``[M, N]`` through
    ``torch._int_mm``.  On CUDA the rows are zero-padded to what the GEMM
    takes (``cuda_gemm_rows``) and the padding rows cut off the result."""
    if a.device.type != "cuda":
        return torch._int_mm(a, w)
    M, K = a.shape
    Mp = cuda_gemm_rows(M, K, w.shape[1])
    if Mp != M:
        a = torch.cat([a, a.new_zeros((Mp - M, K))])
    acc = torch._int_mm(a, w)
    return acc if Mp == M else acc[:M]


def qdot_acc(x: torch.Tensor, w_q: torch.Tensor,
             group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``qdot``'s int32 accumulator ``[M, N]`` and row scales ``[..., 1]``.
    With ``group`` the product is row-parallel (x and w_q hold this rank's
    slice of K): the rows quantize with the whole row's maximum and the
    int32 partial accumulators all-reduce (SUM) before any rescale, so the
    result equals the single-rank accumulator exactly."""
    rf = torch.profiler.record_function
    K = w_q.shape[0]
    with rf(QDOT_PARTS[0]):
        xq, ax = quantize_rows(x, group)
    with rf(QDOT_PARTS[1]):
        acc = int_mm(xq.reshape(-1, K), w_q)
        if group is not None:
            acc = group.all_reduce(acc)
    return acc, ax


def qdot(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None, group=None) -> torch.Tensor:
    """``x @ dequant(w_q)`` via int8: x ``[..., K]`` float, w_q ``[K, N]``
    int8, scale ``[N]`` f32 (per output channel).  Computes
    ``(acc * row_scale) * scale`` in f32, as the JAX package does.  Each
    part runs inside its ``QDOT_PARTS`` profiler range; ``group`` makes
    the product row-parallel (``qdot_acc``)."""
    rf = torch.profiler.record_function
    N = w_q.shape[1]
    acc, ax = qdot_acc(x, w_q, group)
    with rf(QDOT_PARTS[2]):
        out = acc.float() * ax.reshape(-1, 1) * scale
        return out.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)


def qdot_batched(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None, group=None) -> torch.Tensor:
    """Batched ``qdot`` for MoE experts: x ``[E, C, K]`` float, w_q
    ``[E, K, N]`` int8, scale ``[E, N]`` f32 → ``[E, C, N]``.  One int8
    product per expert into an int32 ``[E, C, N]`` accumulator, rescaled
    ``(acc * row_scale) * scale`` in f32 as the JAX package does; with
    ``group`` row-parallel, as ``qdot_acc``."""
    E, C, K = x.shape
    N = w_q.shape[-1]
    xq, ax = quantize_rows(x, group)
    acc = torch.empty((E, C, N), dtype=torch.int32, device=x.device)
    for e in range(E):
        acc[e] = int_mm(xq[e], w_q[e])
    if group is not None:
        acc = group.all_reduce(acc)
    out = acc.float() * ax * scale[:, None, :]
    return out.to(out_dtype or x.dtype)


def expert_linear(x: torch.Tensor, lp, name: str,
                  out_dtype: Optional[torch.dtype] = None, group=None) -> torch.Tensor:
    """Per-expert ``einsum("ecd,edf->ecf", x, lp[name])`` dispatching on the
    quant scale leaf — the batched sibling of models.llama.linear, so the
    MoE and dense forwards share one quantization contract.  ``group``
    (quantized weights only) makes the int8 product row-parallel."""
    w = lp[name]
    s = lp.get(name + "_scale")
    if s is None:
        r = torch.bmm(x, w)
        return r if out_dtype is None else r.to(out_dtype)
    return qdot_batched(x, w, s, out_dtype=out_dtype, group=group)
