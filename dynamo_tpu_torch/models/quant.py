"""Int8 weight quantization (W8A8-dynamic) for TorchEngine.

Port of the JAX package's ``models/quant.py``:

- **weights**: symmetric per-output-channel int8, quantized once
  (``w_q = round(w / s)``, ``s = max|w| / 127`` along the input axis);
- **activations**: symmetric per-row int8, quantized dynamically inside the
  forward (ops/quant_matmul.py);
- **matmul**: int8 x int8 into int32, rescaled in f32.

Quantized leaves live in the same params dict: each weight ``name`` gains
a sibling ``name + "_scale"`` (f32, the weight's output-channel axis), and
the forward (models/llama.py) dispatches on the scale leaf's presence.
Norms and biases stay in the float dtype.

Layout: shapes are the JAX package's (``[L, in, out]`` per layer,
``lm_head`` ``[D, V]``, ``embed`` ``[V, D]``), so trees compare and convert
leaf for leaf.  In memory, every int8 weight that is a matmul's second
operand is column-major (``[..., out, in]`` contiguous, seen transposed),
the operand layout of cuBLASLt's int8 GEMM; ``embed`` stays row-major for
its gather (the tied head reads ``embed.T``, column-major already).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from .config import ModelConfig

Params = Dict[str, Any]

# Weight leaves that quantize, with the axis that is the input (contracted)
# axis of the per-layer matmul: scales are taken over it, leaving the output
# channel axis.  Shapes are the stacked [L, in, out] layouts of
# models/llama.py; fused leaves (fuse_projections) have the same layout.
_LAYER_QUANT_AXES = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 1,
    "w_gate": 1, "w_up": 1, "w_down": 1,
    "wqkv": 1, "w_gateup": 1,
    # MoE experts [L, E, in, out] -> scales [L, E, out]; the router stays
    # float (tiny, and routing-accuracy-critical).
    "moe_gate": 2, "moe_up": 2, "moe_down": 2,
}

# Top-level leaves.  embed [V, D] scales per vocab row (axis 1): the same
# per-row scale serves the lookup (dequantize the gathered row) and the
# tied head (embed.T's output-channel axis IS the vocab row).
_TOP_QUANT_AXES = {"embed": 1, "lm_head": 0}  # lm_head [D, V] -> scale [V]

# Scale of init_params_quantized's uniform int8 draws: their std is ~73,
# so the dequantized weights mimic init_params' N(0, 0.02).
INIT_SCALE = np.float32(0.02 / 73.0)


def quantize_array_np(w: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization in numpy."""
    wf = np.asarray(w, np.float32)
    amax = np.max(np.abs(wf), axis=axis)
    scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    # Clip before the int8 cast: rint(w/s) can land on ±127.0000x in
    # float32 even though |w| <= amax exactly, and an unclipped cast would
    # wrap +127.x to -128.
    q = np.clip(np.rint(wf / np.expand_dims(scale, axis)), -127, 127).astype(np.int8)
    return q, scale


def is_quantized(params: Params) -> bool:
    return "embed_scale" in params or any(k.endswith("_scale") for k in params.get("layers", {}))


def operand_layout(w: torch.Tensor) -> torch.Tensor:
    """``w`` (``[..., in, out]``) stored column-major: the same values and
    shape, the last two axes transposed in memory."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def _quantize(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_quantize_jnp`` in torch: f32, per-channel amax
    over ``axis``, scale floored at 1e-12, round half to even, clip, cast."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=axis) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127).to(torch.int8)
    return q, scale


def quantize_params(params: Params) -> Params:
    """Quantize a float params dict into a new one (a no-op on a quantized
    one).  ``lora_*`` leaves stay in float: adapters are deltas applied
    around the base projections.  Layer leaves quantize one layer at a
    time, which keeps the f32 transient to one layer's weight."""
    if is_quantized(params):
        return params
    out: Params = {}
    for name, leaf in params.items():
        if name == "layers":
            continue
        axis = _TOP_QUANT_AXES.get(name)
        if axis is None:
            out[name] = leaf
            continue
        q, s = _quantize(leaf, axis)
        out[name] = operand_layout(q) if name == "lm_head" else q
        out[name + "_scale"] = s
    layers: Params = {}
    for name, leaf in params["layers"].items():
        axis = _LAYER_QUANT_AXES.get(name)
        if axis is None or name.startswith("lora_"):
            layers[name] = leaf
            continue
        *lead, din, dout = leaf.shape
        q = torch.empty(*lead, dout, din, dtype=torch.int8,
                        device=leaf.device).transpose(-1, -2)  # column-major per matrix
        s = torch.empty(*lead, dout, dtype=torch.float32, device=leaf.device)
        for l in range(leaf.shape[0]):
            q[l], s[l] = _quantize(leaf[l], axis - 1)
        layers[name], layers[name + "_scale"] = q, s
    out["layers"] = layers
    return out


def dequantize_params(params: Params, dtype: Any = torch.float32) -> Params:
    """The exact float tree of a quantized one: the reference forward that
    quality checks compare the int8 execution against, so the only
    difference under test is the execution, not the rounding of weights.
    Stacked leaves dequantize a layer at a time."""

    def deq(group: Params, axes: Dict[str, int], stacked: bool) -> Params:
        out: Params = {}
        for name, leaf in group.items():
            if name.endswith("_scale") or name == "layers":
                continue
            axis = axes.get(name)
            s = group.get(name + "_scale")
            if axis is None or s is None:
                out[name] = leaf
            elif stacked:
                w = torch.empty(leaf.shape, dtype=dtype, device=leaf.device)
                for l in range(leaf.shape[0]):
                    w[l] = leaf[l].float() * s[l].unsqueeze(axis - 1)
                out[name] = w
            else:
                out[name] = (leaf.float() * s.unsqueeze(axis)).to(dtype)
        return out

    out = deq(params, _TOP_QUANT_AXES, stacked=False)
    out["layers"] = deq(params["layers"], _LAYER_QUANT_AXES, stacked=True)
    return out


def fuse_projections(params: Params) -> Params:
    """Concatenate q|k|v and gate|up along their output axes, scales too:
    7 matmuls per dense layer become 5, and the fused products share one
    activation quantization.  Works on quantized and float trees; int8
    results keep the column-major operand layout.  The forward dispatches on
    the fused leaf names (models/llama.py)."""
    layers = dict(params["layers"])

    def cat(names):
        w = torch.cat([layers.pop(n) for n in names], dim=-1)
        return operand_layout(w) if w.dtype == torch.int8 else w

    if "wq" in layers and "wqkv" not in layers:
        layers["wqkv"] = cat(["wq", "wk", "wv"])
        if "wq_scale" in layers:
            layers["wqkv_scale"] = cat(["wq_scale", "wk_scale", "wv_scale"])
        if "bq" in layers:
            layers["bqkv"] = cat(["bq", "bk", "bv"])
    if "w_gate" in layers and "w_gateup" not in layers:
        layers["w_gateup"] = cat(["w_gate", "w_up"])
        if "w_gate_scale" in layers:
            layers["w_gateup_scale"] = cat(["w_gate_scale", "w_up_scale"])
    return dict(params, layers=layers)


def init_params_quantized(
    config: ModelConfig, seed: int = 0, device: Optional[torch.device] = None
) -> Params:
    """Random-init a quantized tree directly in int8 on the device, from a
    seeded ``torch.Generator``: uniform int8 in [-127, 127] with the
    constant per-channel scale ``0.02/73`` (unit norms).  No float
    transient: full-depth 8B in bf16 would be 16 GB before quantizing, and
    mixtral-8x7b's experts 93 GB.  The MoE router stays float, N(0, 0.02).
    The draws are this package's own, not ``jax.random``'s."""
    dev = default_device(device)
    dt = getattr(torch, str(config.dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    D, H, KV, hd, Fi = (
        config.hidden_size, config.num_heads, config.num_kv_heads,
        config.head_dim, config.intermediate_size,
    )
    L, V = config.num_layers, config.vocab_size

    def q(*shape, col_major=True):
        if not col_major:
            return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        flipped = (*shape[:-2], shape[-1], shape[-2])
        w = torch.randint(-127, 128, flipped, generator=gen, device=dev, dtype=torch.int8)
        return w.transpose(-1, -2)

    def s(*shape):
        return torch.full(shape, float(INIT_SCALE), dtype=torch.float32, device=dev)

    layers: Params = {
        "attn_norm": torch.ones((L, D), dtype=dt, device=dev),
        "wq": q(L, D, H * hd), "wq_scale": s(L, H * hd),
        "wk": q(L, D, KV * hd), "wk_scale": s(L, KV * hd),
        "wv": q(L, D, KV * hd), "wv_scale": s(L, KV * hd),
        "wo": q(L, H * hd, D), "wo_scale": s(L, D),
        "mlp_norm": torch.ones((L, D), dtype=dt, device=dev),
    }
    if config.is_moe:
        E, Fm = config.num_experts, config.moe_intermediate_size or Fi
        layers.update({
            "router": (torch.randn((L, D, E), generator=gen, device=dev) * 0.02).to(dt),
            "moe_gate": q(L, E, D, Fm), "moe_gate_scale": s(L, E, Fm),
            "moe_up": q(L, E, D, Fm), "moe_up_scale": s(L, E, Fm),
            "moe_down": q(L, E, Fm, D), "moe_down_scale": s(L, E, D),
        })
    else:
        layers.update({
            "w_gate": q(L, D, Fi), "w_gate_scale": s(L, Fi),
            "w_up": q(L, D, Fi), "w_up_scale": s(L, Fi),
            "w_down": q(L, Fi, D), "w_down_scale": s(L, D),
        })
    if config.qkv_bias:
        layers.update({
            "bq": torch.zeros((L, H * hd), dtype=dt, device=dev),
            "bk": torch.zeros((L, KV * hd), dtype=dt, device=dev),
            "bv": torch.zeros((L, KV * hd), dtype=dt, device=dev),
        })
    params: Params = {
        "embed": q(V, D, col_major=False),
        "embed_scale": s(V),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dt, device=dev),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = q(D, V)
        params["lm_head_scale"] = s(V)
    return params
