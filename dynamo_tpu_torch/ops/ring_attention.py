"""Ring attention: causal self-attention sequence-parallel over the ``sp``
ranks.

Port of the JAX package's ``ops/ring_attention.py``: a long prompt's tokens
shard over the ``sp`` group, each rank keeps its queries, and the K/V chunks
rotate around the ring (``AxisGroup.shift``, one ``batch_isend_irecv`` a
round) while each rank folds every chunk into an online softmax.  The
chunk attention and the merge were XLA ops in the JAX package (no Pallas
kernel), and are plain torch ops here.

Layout contract (the JAX one): rank i of the ring owns the CONTIGUOUS token
chunk ``[i*C, (i+1)*C)`` of a length ``sp*C`` prompt, padding at the tail
masked by ``valid_len``.  A rank attends fully to earlier chunks, causally
within its own and not at all to later ones; those rounds still run, masked.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def _chunk_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                  k_pos: torch.Tensor, valid_len: int,
                  sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized attention of q ``[C, KV, G, D]`` f32 against one K/V
    chunk ``[C, KV, D]`` f32: ``(o [C, KV, G, D], m [C, KV, G], l [C, KV,
    G])``, the online softmax's partials (running max, sum of exp)."""
    scores = torch.einsum("qkgd,lkd->kgql", q, k) * sm_scale  # [KV, G, C, C]
    mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < valid_len)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    m = scores.amax(dim=-1)  # [KV, G, C]
    p = torch.exp(scores - m[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("kgql,lkd->qkgd", p, v)
    return o, m.permute(2, 0, 1), l.permute(2, 0, 1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int,
                   group, *, sm_scale: float) -> torch.Tensor:
    """Causal ring attention of this rank's chunk: q ``[C, H, D]``, k/v
    ``[C, KV, D]``, ``valid_len`` the prompt's length before padding,
    ``group`` the ``sp`` ring (parallel/distributed.AxisGroup).  Returns
    ``[C, H, D]`` in q's dtype."""
    sp, idx = group.size, group.index
    C, H, D = q.shape
    KV = k.shape[1]
    G = H // KV
    dev = q.device
    qf = q.float().reshape(C, KV, G, D)
    ar = torch.arange(C, dtype=torch.int64, device=dev)
    q_pos = idx * C + ar
    o = torch.zeros((C, KV, G, D), dtype=torch.float32, device=dev)
    m = torch.full((C, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((C, KV, G), dtype=torch.float32, device=dev)
    # K and V travel as one [2, C, KV, D] buffer: one exchange a round.
    kv = torch.stack([k.float(), v.float()])
    for r in range(sp):
        src = (idx - r) % sp  # whose chunk this rank holds this round
        o_c, m_c, l_c = _chunk_attend(qf, kv[0], kv[1], q_pos, src * C + ar, valid_len, sm_scale)
        m_new = torch.maximum(m, m_c)
        alpha = torch.exp(m - m_new)  # a fully masked chunk underflows to 0
        beta = torch.exp(m_c - m_new)
        o = o * alpha[..., None] + o_c * beta[..., None]
        l = l * alpha + l_c * beta
        m = m_new
        if r != sp - 1:
            kv = group.shift(kv)
    out = o / l.clamp(min=1e-30)[..., None]
    return out.reshape(C, H, D).to(q.dtype)
