"""Rotary position embeddings with Llama-3 frequency scaling.

Port of the JAX package's ``ops/rope.py``: angles computed from integer
positions in f32 (no precomputed cos/sin table), half-split pairing (the HF
llama convention).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch


def rope_frequencies(
    head_dim: int,
    theta: float,
    scaling: Optional[Dict[str, Any]] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] f32, with optional llama3 scaling."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    if scaling and scaling.get("rope_type", scaling.get("type")) == "llama3":
        factor = scaling["factor"]
        low = scaling.get("low_freq_factor", 1.0)
        high = scaling.get("high_freq_factor", 4.0)
        orig = scaling.get("original_max_position_embeddings", 8192)
        # Long wavelengths (low freqs) scaled down by `factor`; short kept;
        # the band between orig/low and orig/high blends linearly.
        wavelen = 2.0 * math.pi / inv_freq
        smooth = ((orig / wavelen - low) / (high - low)).clamp(0.0, 1.0)
        blended = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > orig / low,
            inv_freq / factor,
            torch.where(wavelen < orig / high, inv_freq, blended),
        )
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """cos and sin of position * inv_freq, shaped [..., seq, 1, hd/2] to
    broadcast over heads — computed once per step, shared by q and k of
    every layer."""
    angles = positions[..., None].float() * inv_freq  # [..., seq, hd/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (first half, second half) pairs of ``x`` [..., seq, heads, hd]
    by precomputed ``rope_cos_sin``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # [..., seq, heads, head_dim]
    positions: torch.Tensor,  # [..., seq] int
    inv_freq: torch.Tensor,  # [head_dim//2]
) -> torch.Tensor:
    """Rotate (first half, second half) pairs by position * inv_freq."""
    return rotate(x, *rope_cos_sin(positions, inv_freq))
