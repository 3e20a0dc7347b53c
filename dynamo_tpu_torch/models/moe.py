"""Mixture-of-experts FFN with dropless dispatch (every expert has room for
every token, C = T).

Port of the JAX package's ``models/moe.py``: per-expert token-index tables
``[E, C]`` instead of one-hot dispatch tensors, the experts' products as
batched ``[E, C, ·]`` matmuls (ops/quant_matmul.expert_linear), and a
weighted scatter-add back to the token rows.  Every shape is static and no
step of it reads a value back to the host, so a forward holding it can be
captured in a CUDA graph (engine/graphs.py) although its routing depends on
the data: the tables are built with ``cumsum`` and ``scatter_``, the rows
gathered with ``index_select`` and combined with ``index_add_``.

The combine adds each token's K weighted expert rows onto zero in f32.
``index_add_`` on CUDA uses atomics, whose order is not fixed; with K = 2
the two terms commute exactly (``0 + a + b == 0 + b + a`` in IEEE
arithmetic), so the result is deterministic, and a CUDA call with K > 2 is
refused rather than served with an order-dependent sum.

Under a mesh (parallel/mesh.py) a rank holds the experts of its ``ep``
coordinate, each over its ``tp`` slice of the expert hidden dim
(``moe_gate: (None, "ep", None, "tp")``): it routes every token over all
experts, runs its own experts' products, and the f32 combine is summed over
the ``ep`` x ``tp`` group.  With int8 experts the down product is
row-parallel over ``tp`` (ops/quant_matmul.qdot_batched with the group),
so the combine then sums over ``ep`` only.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.quant_matmul import expert_linear
from .config import ModelConfig

# moe_mlp's three parts as named profiler ranges (engine/profile_step.py
# reads them): the routing (router product, top-k, tables, gather), the
# experts' products, and the weighted combine.  A range costs the host a
# few microseconds an eager call and nothing in a graph replay.
MOE_PARTS = ("moe.route", "moe.expert_products", "moe.combine")


def init_moe_params(config: ModelConfig, gen: torch.Generator, dt: torch.dtype,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Random N(0, 0.02) router and expert weights from ``gen`` (this
    package's draws, not ``jax.random``'s)."""
    L, D = config.num_layers, config.hidden_size
    E, Fm = config.num_experts, config.moe_intermediate_size or config.intermediate_size

    def norm(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dt)

    return {
        "router": norm(L, D, E),
        "moe_gate": norm(L, E, D, Fm),
        "moe_up": norm(L, E, D, Fm),
        "moe_down": norm(L, E, Fm, D),
    }


def moe_mlp(
    x: torch.Tensor,  # [T, D]
    lp: Dict[str, torch.Tensor],  # this layer's params (leading L stripped)
    config: ModelConfig,
    shard=None,  # parallel/distributed.ParallelState; None = one rank
) -> torch.Tensor:
    """The JAX ``moe_mlp`` on a flat token run: the router product in the
    model dtype, then f32; ``top_k`` over the f32 logits with a softmax over
    the chosen K; per-expert queue positions by a cumulative count; the
    ``[E, C]`` index (padding row T) and weight tables at the dropless
    capacity C = T, since inference must not drop tokens; gather,
    gate/up/down through ``expert_linear`` (the gate's SiLU in f32); and the
    f32 weighted scatter-add into ``[T + 1, D]``, row T dropped."""
    T, D = x.shape
    E, K = config.num_experts, config.num_experts_per_token
    if x.device.type == "cuda" and K > 2:
        raise ValueError(f"moe_mlp on CUDA combines with atomics: top-{K} routing would "
                         "sum in an unfixed order (K <= 2 only)")
    C = T  # dropless: top-k picks distinct experts, so no queue passes T - 1
    dev = x.device
    rf = torch.profiler.record_function
    with rf(MOE_PARTS[0]):
        logits = (x @ lp["router"]).float()  # [T, E]
        weights, chosen = torch.topk(logits, K, dim=-1)  # [T, K]
        weights = torch.softmax(weights, dim=-1)  # renormalised over the chosen
        # Queue position of each (t, k) assignment within its expert.
        flat_e = chosen.reshape(T * K)
        flat_t = torch.arange(T * K, device=dev) // K
        onehot = (flat_e[:, None] == torch.arange(E, device=dev)[None, :]).to(torch.int32)
        pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0].long()
        # dispatch[e, c] = source token (T = padding) and its gate weight.
        at = flat_e * C + pos
        dispatch = torch.full((E * C,), T, dtype=torch.long, device=dev)
        dispatch = dispatch.scatter(0, at, flat_t).view(E, C)
        gate_w = torch.zeros((E * C,), dtype=torch.float32, device=dev)
        gate_w = gate_w.scatter(0, at, weights.reshape(T * K)).view(E, C)

        El = lp["moe_gate"].shape[0]  # this rank's experts
        if El != E:
            e0 = shard.ep_index * El
            dispatch, gate_w = dispatch[e0:e0 + El], gate_w[e0:e0 + El]
        x_pad = torch.cat([x, x.new_zeros((1, D))])
        idx = dispatch.reshape(-1)
        xe = x_pad.index_select(0, idx).view(El, C, D)
    quant_tp = shard is not None and shard.tp.size > 1 and "moe_down_scale" in lp
    with rf(MOE_PARTS[1]):
        gate = F.silu(expert_linear(xe, lp, "moe_gate", torch.float32)).to(x.dtype)
        up = expert_linear(xe, lp, "moe_up")
        ye = expert_linear(gate * up, lp, "moe_down",
                           group=shard.tp if quant_tp else None)  # [El, C, D]
    with rf(MOE_PARTS[2]):
        ye_w = ye.float() * gate_w[..., None]
        yt = torch.zeros((T + 1, D), dtype=torch.float32, device=dev)
        yt.index_add_(0, idx, ye_w.reshape(El * C, D))
        if shard is not None:
            yt = (shard.ep if quant_tp else shard.ep_tp).all_reduce(yt)
        return yt[:T].to(x.dtype)
