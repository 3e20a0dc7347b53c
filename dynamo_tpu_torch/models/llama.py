"""Llama-family forward pass (dense) with paged KV, in PyTorch.

Port of the JAX package's ``models/llama.py``, dense and MoE (models/moe.py
replaces the SwiGLU FFN where the config has experts).  The model is
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
from .moe import init_moe_params, moe_mlp
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


def linear(x: torch.Tensor, lp: Params, name: str, out_dtype=None, group=None) -> torch.Tensor:
    """``x @ lp[name]`` (weights [in, out]), dispatching on quantization:
    an int8 weight is recognised by its sibling ``name + "_scale"``
    (models/quant.py) and runs the int8 product (ops/quant_matmul.qdot).
    ``group`` (parallel/distributed.AxisGroup) makes the product
    row-parallel: ``x`` and the weight hold this rank's slice of the input
    features and the partial products are all-reduced (for int8, the
    accumulators before the rescale)."""
    s = lp.get(name + "_scale")
    if s is not None:
        return qdot(x, lp[name], s, out_dtype=out_dtype, group=group)
    r = x @ lp[name]
    if group is not None:
        r = group.all_reduce(r)
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


def mlp(x: torch.Tensor, lp: Params, tp=None) -> torch.Tensor:
    """SwiGLU FFN (gate activation in f32), fused w_gateup when present;
    ``tp`` (an AxisGroup) all-reduces the row-parallel ``w_down``."""
    if "w_gateup" in lp:
        gu = linear(x, lp, "w_gateup", torch.float32)
        Fh = gu.shape[-1] // 2
        gate = F.silu(gu[..., :Fh]).to(x.dtype)
        up = gu[..., Fh:].to(x.dtype)
        return linear(gate * up, lp, "w_down", group=tp)
    gate = F.silu(linear(x, lp, "w_gate", torch.float32)).to(x.dtype)
    return linear(gate * linear(x, lp, "w_up"), lp, "w_down", group=tp)


def embed_lookup(params: Params, token_ids: torch.Tensor, dtype: torch.dtype,
                 tp=None) -> torch.Tensor:
    """Token embedding gather; int8 embeds dequantize the gathered rows by
    their per-row scale (the vocab row, shared with the tied head).  With
    ``tp`` the embedding holds this rank's slice of the vocabulary: ids
    outside it look up zeros and the rows are all-reduced, which is exact
    (one term of each sum is not zero)."""
    emb = params["embed"]
    s = params.get("embed_scale")
    if tp is None or tp.size == 1:
        e = emb[token_ids]
        return e if s is None else (e.float() * s[token_ids][:, None]).to(dtype)
    Vl = emb.shape[0]
    local = token_ids.long() - tp.index * Vl
    mine = (local >= 0) & (local < Vl)
    local = torch.where(mine, local, 0)
    e = emb[local]
    if s is not None:
        e = (e.float() * s[local][:, None]).to(dtype)
    e = torch.where(mine[:, None], e, torch.zeros((), dtype=e.dtype, device=e.device))
    return tp.all_reduce(e.contiguous())


def lm_logits(params: Params, h_last: torch.Tensor, tp=None) -> torch.Tensor:
    """Final-norm hidden rows → f32 logits, through lm_head or the tied
    embedding, quantized or not.  With ``tp`` the head holds this rank's
    slice of the vocabulary and the ``[S, V]`` logits are all-gathered, so
    every rank holds (and samples from) the same logits."""
    head = params.get("lm_head")
    if head is not None:
        s = params.get("lm_head_scale")
        if s is None:
            out = (h_last @ head).float()
        else:
            out = qdot(h_last, head, s, out_dtype=torch.float32)
    else:
        s = params.get("embed_scale")
        if s is None:
            out = (h_last @ params["embed"].T).float()
        else:
            out = qdot(h_last, params["embed"].T, s, out_dtype=torch.float32)
    return out if tp is None else tp.all_gather(out, dim=-1)


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
    # Per-token LoRA adapter slot (llm/tenancy/lora.py), -1 = base model;
    # None on engines without adapter banks.
    adapter_slots: Optional[torch.Tensor] = None  # [T]


def init_params(
    config: ModelConfig, seed: int = 0, device: Optional[torch.device] = None
) -> Params:
    """Random N(0, 0.02) weights from a seeded ``torch.Generator`` on the
    target device (unit norms), in the config's dtype — for benchmarks and
    tests without a checkpoint.  MoE configs get the router and expert
    leaves in place of the dense FFN's."""
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
    }
    if config.qkv_bias:
        layers.update({"bq": norm(L, H * hd), "bk": norm(L, KV * hd), "bv": norm(L, KV * hd)})
    if config.is_moe:
        layers.update(init_moe_params(config, gen, dt, dev))
    else:
        layers.update({"w_gate": norm(L, D, Fi), "w_up": norm(L, D, Fi), "w_down": norm(L, Fi, D)})
    params: Params = {
        "embed": norm(V, D),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dt, device=dev),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = norm(D, V)
    return params


_TOP_LEAVES = {"embed", "final_norm", "lm_head", "embed_scale", "lm_head_scale"}
_QUANT_LAYER_LEAVES = {"wo", "w_down", "wq", "wk", "wv", "wqkv", "w_gate", "w_up", "w_gateup",
                       "moe_gate", "moe_up", "moe_down"}
_LORA_TARGETS = ("wq", "wk", "wv", "wo")  # llm/tenancy/lora.py LORA_TARGETS
_LAYER_LEAVES = (
    {"attn_norm", "mlp_norm", "bq", "bk", "bv", "bqkv", "router"}
    | _QUANT_LAYER_LEAVES
    | {n + "_scale" for n in _QUANT_LAYER_LEAVES}
    | {f"lora_{ab}_{t}" for ab in "ab" for t in _LORA_TARGETS}
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
    siblings (int8 weights are stored column-major, models/quant.py), and
    the LoRA banks (``lora_a_*`` / ``lora_b_*``) and the MoE leaves
    (``router``, ``moe_*`` and their scales); refuses leaves it does not
    know."""
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
    # Per-slot rank of the LoRA device banks (llm/tenancy/lora.py); 0 = no
    # LoRA.  Active only when the params carry bank leaves AND the batch
    # carries adapter_slots.
    lora_rank: int = 0,
    # This rank's place in a mesh (parallel/distributed.ParallelState):
    # params and pages are its slices; None = one rank.
    shard=None,
    # > 0: the per-token layers run on exactly this many rows a call.
    pad_rows: int = 0,
) -> torch.Tensor:
    """Unified mixed prefill+decode forward over a flat ragged token run.

    Returns logits ``[S, vocab]`` f32 — each row's LAST token's logits
    (rows past num_seqs give garbage the caller ignores) — and writes the
    step's K/V into ``cache`` in place.  ``kv_scale`` goes to the attention
    kernels, which dequantize in-kernel; the write side stores
    value / scale.

    Batched segmented multi-LoRA (the JAX forward's): every resident
    adapter's A/B factors lie concatenated along an ``R*r`` rank axis, and
    a per-token segment mask (``arange(R*r) // r == slot``) zeroes every
    adapter's columns but the token's own, so ``(x @ A_all) * mask @ B_all``
    serves rows of many adapters in one forward; slot -1 matches nothing.
    The q, k and v deltas are added before rope, the o delta after the
    output projection; base weights (possibly int8) are untouched.

    Under a mesh (``shard``), the JAX forward's sharding is run by hand: a
    rank holds its ``tp`` slice of the heads (and of their pages), calls
    the attention kernels at its local head counts, all-reduces the
    row-parallel ``wo`` and ``w_down`` outputs, looks up its vocabulary
    slice of the embedding (all-reduced) and all-gathers the vocab-sharded
    logits; MoE experts run over ``ep`` (models/moe.py).

    ``pad_rows`` (the engine's ``batch_invariant``): the norms, the
    projections and the MLP see the step's tokens zero-padded to
    ``pad_rows`` rows (cut into slabs of that many where the step holds
    more), so every product has one shape whatever the step carries.
    cuBLAS picks its kernel by the row count, and on the card a token's
    bf16 projections then differ by the step's size (measured at 16 rows
    against 4 on llama-3.1-8b widths); padded, they are the same bits in
    a decode dispatch and in any prefill step."""
    T = rb.token_ids.shape[0]
    tp = None if shard is None or shard.tp.size == 1 else shard.tp
    n = 1 if tp is None else tp.size
    H, KV, hd = config.num_heads // n, config.num_kv_heads // n, config.head_dim
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

    dt = torch_dtype(config.dtype)
    lora_mask = None
    if lora_rank > 0 and rb.adapter_slots is not None and "lora_a_wq" in layers:
        Rr = layers["lora_a_wq"].shape[-1]
        seg = torch.arange(Rr, dtype=torch.int32, device=dev) // lora_rank  # column → slot
        lora_mask = (rb.adapter_slots[:, None] == seg[None, :]).to(dt)  # [T, R*r]

    def lora_delta(x_in: torch.Tensor, lp: Params, name: str,
                   mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        a = lp.get("lora_a_" + name)
        if a is None or mask is None:
            return None
        xa = (x_in @ a) * mask  # own-adapter columns only
        return (xa @ lp["lora_b_" + name]).to(x_in.dtype)

    def per_token(fn, *xs):
        """``fn`` over rows of ``xs`` (None passes through): in one call,
        or in ``pad_rows``-row calls over the zero-padded rows."""
        if pad_rows <= 0:
            return fn(*xs)
        n = -(-T // pad_rows) * pad_rows
        xs = [x if x is None or n == T else torch.cat([x, x.new_zeros((n - T, *x.shape[1:]))])
              for x in xs]
        parts = [fn(*(None if x is None else x[i:i + pad_rows] for x in xs))
                 for i in range(0, n, pad_rows)]

        def cat(ts):
            return (ts[0] if len(ts) == 1 else torch.cat(ts))[:T]

        return tuple(map(cat, zip(*parts))) if isinstance(parts[0], tuple) else cat(parts)

    def add(x: torch.Tensor, d: Optional[torch.Tensor]) -> torch.Tensor:
        return x if d is None else x + d

    h = embed_lookup(params, rb.token_ids, dt, tp)  # [T, D]
    for l in range(L):
        lp = {name: w[l] for name, w in layers.items()}

        def attn_in(h, mask, lp=lp):
            x = rms_norm(h, lp["attn_norm"], config.rms_norm_eps)
            q, k, v = qkv_proj(x, lp, H * hd, KV * hd)
            return (add(q, lora_delta(x, lp, "wq", mask)), add(k, lora_delta(x, lp, "wk", mask)),
                    add(v, lora_delta(x, lp, "wv", mask)))

        def attn_out(h, attn_flat, mask, lp=lp):
            o = linear(attn_flat, lp, "wo", group=tp)
            h = h + add(o, lora_delta(attn_flat, lp, "wo", mask))
            x = rms_norm(h, lp["mlp_norm"], config.rms_norm_eps)
            return h + (moe_mlp(x, lp, config, shard) if config.is_moe else mlp(x, lp, tp))

        q, k, v = per_token(attn_in, h, lora_mask)
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
        h = per_token(attn_out, h, attn.reshape(T, H * hd), lora_mask)
    h = per_token(lambda h: rms_norm(h, params["final_norm"], config.rms_norm_eps), h)
    rows = (rb.cu_q_lens[1:].long() - 1).clamp(0, T - 1)  # last token per row
    return lm_logits(params, h[rows], tp)


def forward_sp_prefill(
    params: Params,
    config: ModelConfig,
    token_ids: torch.Tensor,  # [Tg] this prompt's ids, Tg a multiple of sp
    valid_len: int,  # the prompt's length (<= Tg; the rest is padding)
    shard,  # parallel/distributed.ParallelState with sp > 1
):
    """Whole-prompt sequence-parallel prefill (the JAX package's
    ``forward_sp_prefill``): this rank computes its contiguous chunk of
    ``Tg / sp`` tokens over its ``tp`` heads, every product local to the
    chunk (weights replicate over ``sp``), attention by ring attention over
    the ``sp`` group (ops/ring_attention.py).

    Returns (logits ``[V]`` f32 of the last valid token — the first decode
    token's distribution — on every rank, and ``[L, Tg, 2*KV_local, hd]``
    pages-layout rows, K at even and V at odd combined heads, all-gathered
    over ``sp`` because pages replicate over it)."""
    from ..ops.ring_attention import ring_attention

    sp = shard.sp
    tp = None if shard.tp.size == 1 else shard.tp
    n = 1 if tp is None else tp.size
    Tg = token_ids.shape[0]
    C = Tg // sp.size
    H, KV, hd = config.num_heads // n, config.num_kv_heads // n, config.head_dim
    dev = token_ids.device
    inv_freq = rope_frequencies(hd, config.rope_theta, config.rope_scaling, device=dev)
    sm_scale = hd**-0.5
    lo = sp.index * C
    toks = token_ids[lo:lo + C]
    positions = torch.arange(lo, lo + C, dtype=torch.int32, device=dev)
    cos, sin = rope_cos_sin(positions, inv_freq)
    dt = torch_dtype(config.dtype)
    layers = params["layers"]
    h = embed_lookup(params, toks, dt, tp)  # [C, D]
    rows = []
    for l in range(config.num_layers):
        lp = {name: w[l] for name, w in layers.items()}
        x = rms_norm(h, lp["attn_norm"], config.rms_norm_eps)
        q, k, v = qkv_proj(x, lp, H * hd, KV * hd)
        q = rotate(q.reshape(C, H, hd), cos, sin)
        k = rotate(k.reshape(C, KV, hd), cos, sin)
        v = v.reshape(C, KV, hd)
        attn = ring_attention(q, k, v, valid_len, sp, sm_scale=sm_scale)
        h = h + linear(attn.reshape(C, H * hd), lp, "wo", group=tp)
        x = rms_norm(h, lp["mlp_norm"], config.rms_norm_eps)
        h = h + (moe_mlp(x, lp, config, shard) if config.is_moe else mlp(x, lp, tp))
        rows.append(torch.stack([k, v], dim=2).reshape(C, 2 * KV, hd))
    h = rms_norm(h, params["final_norm"], config.rms_norm_eps)
    # The last valid token lies in one rank's chunk: every rank computes
    # the logits of its own candidate row (the head's collectives run on
    # all), and the owner's row is taken from the gather over sp.
    last = max(0, min(valid_len, Tg) - 1)
    logits = lm_logits(params, h[min(max(last - lo, 0), C - 1)][None], tp)  # [1, V]
    logits = sp.all_gather(logits, dim=0)[last // C]
    kv = sp.all_gather(torch.stack(rows), dim=1)  # [L, Tg, 2KV, hd]
    return logits, kv
