"""Llama-family forward pass (dense) with paged KV, in PyTorch.

Port of the JAX package's ``models/llama.py`` dense path.  The model is
plain functions over a dict of tensors: ``{"embed": [V, D], "layers":
{name: [L, ...]}, "final_norm": [D], "lm_head": [D, V]}``, weights in the
JAX package's ``[in, out]`` layout so trees convert leaf for leaf
(``params_from_jax``).  The cast points are JAX's: norms in f32 then cast,
the gate activation in f32, f32 logits.  A weight with an ``*_scale``
sibling is int8 (W8A8, models/quant.py) and runs ops/quant_matmul.qdot.

The paged KV slab ``[L, P, ps, 2*KV, D]`` is updated IN PLACE: each layer
writes its new K/V rows into its own ``pages[l]`` view and the attention
kernels read that view through un-offset page tables (JAX threaded one
flat slab through its layer scan with per-layer table offsets).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import default_device
from ..ops.quant_matmul import qdot
from ..ops.ragged_attention import (
    kv_write_plan, ragged_attention, single_row_plan, write_kv_ragged,
)
from ..ops.rope import rope_cos_sin, rope_frequencies, rotate
from .config import ModelConfig
from .quant import fuse_projections, operand_layout  # noqa: F401  (fuse_projections: re-exported)

Params = Dict[str, Any]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name: Any) -> torch.dtype:
    """Config dtype string (the JAX package's names) → torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} (one of {sorted(_DTYPES)})") from None


def linear(x: torch.Tensor, lp: Params, name: str, out_dtype=None) -> torch.Tensor:
    """``x @ lp[name]`` (weights [in, out]), dispatching on quantization:
    an int8 weight is recognised by its sibling ``name + "_scale"``
    (models/quant.py) and runs the int8 product (ops/quant_matmul.qdot)."""
    s = lp.get(name + "_scale")
    if s is not None:
        return qdot(x, lp[name], s, out_dtype=out_dtype)
    r = x @ lp[name]
    return r if out_dtype is None else r.to(out_dtype)


def qkv_proj(x: torch.Tensor, lp: Params, q_size: int, kv_size: int):
    """q/k/v projections, using the fused wqkv leaf when present."""
    if "wqkv" in lp:
        qkv = linear(x, lp, "wqkv")
        if "bqkv" in lp:
            qkv = qkv + lp["bqkv"]
        return qkv.split([q_size, kv_size, kv_size], dim=-1)
    q, k, v = linear(x, lp, "wq"), linear(x, lp, "wk"), linear(x, lp, "wv")
    if "bq" in lp:  # Qwen2-style attention biases
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return q, k, v


def mlp(x: torch.Tensor, lp: Params) -> torch.Tensor:
    """SwiGLU FFN (gate activation in f32), fused w_gateup when present."""
    if "w_gateup" in lp:
        gu = linear(x, lp, "w_gateup", torch.float32)
        Fh = gu.shape[-1] // 2
        gate = F.silu(gu[..., :Fh]).to(x.dtype)
        up = gu[..., Fh:].to(x.dtype)
        return linear(gate * up, lp, "w_down")
    gate = F.silu(linear(x, lp, "w_gate", torch.float32)).to(x.dtype)
    return linear(gate * linear(x, lp, "w_up"), lp, "w_down")


def embed_lookup(params: Params, token_ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token embedding gather; int8 embeds dequantize the gathered rows by
    their per-row scale (the vocab row, shared with the tied head)."""
    e = params["embed"][token_ids]
    s = params.get("embed_scale")
    if s is None:
        return e
    return (e.float() * s[token_ids][:, None]).to(dtype)


def lm_logits(params: Params, h_last: torch.Tensor) -> torch.Tensor:
    """Final-norm hidden rows → f32 logits, through lm_head or the tied
    embedding, quantized or not."""
    head = params.get("lm_head")
    if head is not None:
        s = params.get("lm_head_scale")
        if s is None:
            return (h_last @ head).float()
        return qdot(h_last, head, s, out_dtype=torch.float32)
    s = params.get("embed_scale")
    if s is None:
        return (h_last @ params["embed"].T).float()
    return qdot(h_last, params["embed"].T, s, out_dtype=torch.float32)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


@dataclass
class PagedKVCache:
    """Page-major per-layer KV slabs ``[L, P, ps, 2*KV, D]`` with K at even
    and V at odd combined-head indices.  Sequences own pages through page
    tables, so allocation never moves data.  Mutated in place."""

    pages: torch.Tensor

    @classmethod
    def create(
        cls,
        config: ModelConfig,
        num_pages: int,
        page_size: int,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[torch.device] = None,
    ) -> "PagedKVCache":
        shape = (config.num_layers, num_pages, page_size, 2 * config.num_kv_heads, config.head_dim)
        return cls(pages=torch.zeros(shape, dtype=dtype, device=default_device(device)))


class RaggedBatch(NamedTuple):
    """One unified step: a flat token run of mixed prefill chunks and decode
    tokens, all int32 tensors on the model's device.  Tokens at or past
    cu_q_lens[num_seqs] carry slot -1 (write dropped) and produce zero
    attention; rows at or past num_seqs have kv_len 0."""

    token_ids: torch.Tensor  # [T]
    positions: torch.Tensor  # [T]
    slot_mapping: torch.Tensor  # [T] (-1 = padding)
    kv_lens: torch.Tensor  # [S]
    page_indices: torch.Tensor  # [S, pages_per_seq]
    cu_q_lens: torch.Tensor  # [S+1]
    num_seqs: torch.Tensor  # [1]


def init_params(
    config: ModelConfig, seed: int = 0, device: Optional[torch.device] = None
) -> Params:
    """Random N(0, 0.02) weights from a seeded ``torch.Generator`` on the
    target device (unit norms), in the config's dtype — for benchmarks and
    tests without a checkpoint.  Dense models only."""
    if config.is_moe:
        raise NotImplementedError("MoE models are not supported by this package yet")
    dev = default_device(device)
    dt = torch_dtype(config.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    D, H, KV, hd, Fi = (
        config.hidden_size, config.num_heads, config.num_kv_heads,
        config.head_dim, config.intermediate_size,
    )
    L, V = config.num_layers, config.vocab_size

    def norm(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dt)

    layers = {
        "attn_norm": torch.ones((L, D), dtype=dt, device=dev),
        "wq": norm(L, D, H * hd),
        "wk": norm(L, D, KV * hd),
        "wv": norm(L, D, KV * hd),
        "wo": norm(L, H * hd, D),
        "mlp_norm": torch.ones((L, D), dtype=dt, device=dev),
        "w_gate": norm(L, D, Fi),
        "w_up": norm(L, D, Fi),
        "w_down": norm(L, Fi, D),
    }
    if config.qkv_bias:
        layers.update({"bq": norm(L, H * hd), "bk": norm(L, KV * hd), "bv": norm(L, KV * hd)})
    params: Params = {
        "embed": norm(V, D),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dt, device=dev),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = norm(D, V)
    return params


_TOP_LEAVES = {"embed", "final_norm", "lm_head", "embed_scale", "lm_head_scale"}
_QUANT_LAYER_LEAVES = {"wo", "w_down", "wq", "wk", "wv", "wqkv", "w_gate", "w_up", "w_gateup"}
_LAYER_LEAVES = (
    {"attn_norm", "mlp_norm", "bq", "bk", "bv", "bqkv"}
    | _QUANT_LAYER_LEAVES
    | {n + "_scale" for n in _QUANT_LAYER_LEAVES}
)


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch bridge
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Mapping[str, Any], device: Optional[torch.device] = None) -> Params:
    """A JAX params tree (leaves as numpy arrays, e.g. via ``np.asarray``)
    → this package's dict of tensors on ``device``, shapes unchanged
    (weights stay ``[in, out]``).  Accepts unfused (wq/wk/wv, w_gate/w_up)
    and fused (wqkv, w_gateup) leaves, float or int8 with their ``*_scale``
    siblings (int8 weights are stored column-major, models/quant.py);
    refuses leaves it cannot serve (MoE, LoRA banks)."""
    dev = default_device(device)

    def conv(name: str, x: Any, group: Mapping[str, Any]) -> torch.Tensor:
        t = _to_torch(x, dev)
        if t.dtype == torch.int8 and name != "embed" and name + "_scale" in group:
            t = operand_layout(t)
        return t

    out: Params = {}
    for name, leaf in tree.items():
        if name == "layers":
            bad = set(leaf) - _LAYER_LEAVES
            if bad:
                raise ValueError(f"unsupported layer leaves: {sorted(bad)}")
            out["layers"] = {n: conv(n, x, leaf) for n, x in leaf.items()}
        elif name in _TOP_LEAVES:
            out[name] = conv(name, leaf, tree)
        else:
            raise ValueError(f"unsupported params leaf {name!r}")
    return out


def forward_ragged(
    params: Params,
    config: ModelConfig,
    rb: RaggedBatch,
    cache: PagedKVCache,
    *,
    kv_scale=None,  # quantized pages: a float or an [L] per-layer sequence
    decode: bool = False,  # every row is a single-token decode row
) -> torch.Tensor:
    """Unified mixed prefill+decode forward over a flat ragged token run.

    Returns logits ``[S, vocab]`` f32 — each row's LAST token's logits
    (rows past num_seqs give garbage the caller ignores) — and writes the
    step's K/V into ``cache`` in place.  ``kv_scale`` goes to the attention
    kernels, which dequantize in-kernel; the write side stores
    value / scale."""
    T = rb.token_ids.shape[0]
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    dev = rb.token_ids.device
    inv_freq = rope_frequencies(hd, config.rope_theta, config.rope_scaling, device=dev)
    sm_scale = hd**-0.5
    L = cache.pages.shape[0]
    scales = None if kv_scale is None else np.asarray(kv_scale, np.float32).reshape(-1)
    layers = params["layers"]
    # Per-step, layer-invariant work done once: rope angles, the KV write's
    # destination plan and the attention's single-token rows.
    cos, sin = rope_cos_sin(rb.positions, inv_freq)
    plan = kv_write_plan(rb.slot_mapping)
    rows = None if decode else single_row_plan(rb.kv_lens, rb.cu_q_lens, rb.num_seqs, T)

    h = embed_lookup(params, rb.token_ids, torch_dtype(config.dtype))  # [T, D]
    for l in range(L):
        lp = {name: w[l] for name, w in layers.items()}
        x = rms_norm(h, lp["attn_norm"], config.rms_norm_eps)
        q, k, v = qkv_proj(x, lp, H * hd, KV * hd)
        q = rotate(q.reshape(T, H, hd), cos, sin)
        k = rotate(k.reshape(T, KV, hd), cos, sin)
        v = v.reshape(T, KV, hd)
        s_l = None if scales is None else float(scales[min(l, scales.shape[0] - 1)])
        pages = cache.pages[l]
        write_kv_ragged(pages, k, v, rb.slot_mapping, kv_scale=s_l, plan=plan)
        attn = ragged_attention(
            q, pages, rb.kv_lens, rb.page_indices, rb.cu_q_lens, rb.num_seqs,
            sm_scale=sm_scale, kv_scale=s_l, decode=decode, rows=rows,
        )
        h = h + linear(attn.reshape(T, H * hd), lp, "wo")
        x = rms_norm(h, lp["mlp_norm"], config.rms_norm_eps)
        h = h + mlp(x, lp)
    h = rms_norm(h, params["final_norm"], config.rms_norm_eps)
    rows = (rb.cu_q_lens[1:].long() - 1).clamp(0, T - 1)  # last token per row
    return lm_logits(params, h[rows])
