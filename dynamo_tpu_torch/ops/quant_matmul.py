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
``qdot_batched``/``expert_linear`` (MoE) come with the MoE slice.
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


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8: returns (x_q int8, row_scale f32
    ``[..., 1]``).  Rows of zeros get scale 1e-9 and quantize to zeros.
    Rounds half to even (``torch.round``, as ``jnp.round``) and clips to
    ±127 before the cast.  The scale is ``max|x|`` times the f32
    reciprocal of 127: XLA compiles the JAX package's ``max / 127.0`` so
    inside its jitted forward (an eager division can differ by one ulp)."""
    xf = x.float()
    ax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0), min=1e-9)
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


def qdot(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(w_q)`` via int8: x ``[..., K]`` float, w_q ``[K, N]``
    int8, scale ``[N]`` f32 (per output channel).  Computes
    ``(acc * row_scale) * scale`` in f32, as the JAX package does.  Each
    part runs inside its ``QDOT_PARTS`` profiler range."""
    rf = torch.profiler.record_function
    K, N = w_q.shape
    with rf(QDOT_PARTS[0]):
        xq, ax = quantize_rows(x)
    with rf(QDOT_PARTS[1]):
        acc = int_mm(xq.reshape(-1, K), w_q)
    with rf(QDOT_PARTS[2]):
        out = acc.float() * ax.reshape(-1, 1) * scale
        return out.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)
