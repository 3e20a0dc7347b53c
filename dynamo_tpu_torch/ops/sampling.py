"""Batched on-device token sampling: greedy / temperature / top-k / top-p /
frequency+presence penalties / packed admissible-token masks / logprobs.

Port of the JAX package's ``ops/sampling.py::sample_tokens``.  All rows
sample in one batched op with per-row parameters as tensors; temperature 0
means greedy regardless of the other knobs.  Where JAX skipped unused work
with on-device ``lax.cond``, this port branches on flags the host already
knows when it builds the step (``SamplingParams``), so no branch waits on
the device.

Randomness: row ``i`` draws its Gumbel noise from a counter-based hash of
``(seed_i, step_i, token id)``, where ``step`` is the row's output-token
index — so a request's sampled tokens are reproducible per (seed, step)
whatever batch row or dispatch it rode in, and the draw never leaves the
device.  The stream is this package's own: it does not reproduce
``jax.random`` (a bit-exact threefry port is later work).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -1e30
# Top-k logprobs returned when logprobs are requested (the OpenAI API's
# documented top_logprobs maximum).
TOPK_LOGPROBS = 20


class SampleOut(NamedTuple):
    tokens: torch.Tensor  # [B] int64
    logprob: torch.Tensor  # [B] f32 — raw log p(sampled token)
    top_ids: torch.Tensor  # [B, TOPK_LOGPROBS] int64
    top_logprobs: torch.Tensor  # [B, TOPK_LOGPROBS] f32


class SamplingFlags(NamedTuple):
    """The host-known facts that decide which sampler stages run.  Each
    changes the launched work, so a captured device program is keyed by
    them (engine/graphs.py)."""

    need_logprobs: bool
    any_penalty: bool
    any_sampled: bool  # some row has temperature > 0
    any_filter: bool  # some sampled row uses top-k or top-p

    @classmethod
    def of(cls, temperature, top_k, top_p, freq_penalty, pres_penalty,
           need_logprobs) -> "SamplingFlags":
        temperature = np.asarray(temperature, np.float32)
        sampled = temperature > 0.0
        filt = (np.asarray(top_k) > 0) | (np.asarray(top_p, np.float32) < 1.0)
        pen = (np.asarray(freq_penalty) != 0.0) | (np.asarray(pres_penalty) != 0.0)
        return cls(bool(need_logprobs), bool(np.any(pen)), bool(np.any(sampled)),
                   bool(np.any(sampled & filt)))


# Host dtypes of the per-row sampling arrays (SamplingParams' tensors).
SAMPLING_DTYPES = {
    "seeds": np.int64,  # holding uint32 seeds
    "steps": np.int64,
    "temperature": np.float32,
    "top_k": np.int64,
    "top_p": np.float32,
    "freq_penalty": np.float32,
    "pres_penalty": np.float32,
}


class SamplingParams(NamedTuple):
    """Per-row sampling state for one device step (host-built), plus the
    host-known flags that decide which stages run."""

    seeds: torch.Tensor  # [B] int64 holding uint32 seeds
    steps: torch.Tensor  # [B] int64 output-token index (rng stream position)
    temperature: torch.Tensor  # [B] f32
    top_k: torch.Tensor  # [B] int64; 0 → disabled
    top_p: torch.Tensor  # [B] f32; 1.0 → disabled
    freq_penalty: torch.Tensor  # [B] f32
    pres_penalty: torch.Tensor  # [B] f32
    counts: torch.Tensor  # [B, V] int16 output-token histogram
    need_logprobs: bool
    any_penalty: bool
    any_sampled: bool  # some row has temperature > 0
    any_filter: bool  # some sampled row uses top-k or top-p
    # Packed admissible-token bitmask ([B, ceil(V/32)] words in int64; bit
    # i of word i//32 = token i admissible) and whether any row is masked.
    mask_words: Optional[torch.Tensor] = None
    any_mask: bool = False

    @classmethod
    def from_tensors(cls, t: Mapping[str, torch.Tensor], counts: torch.Tensor,
                     flags: SamplingFlags) -> "SamplingParams":
        """From tensors named as ``SAMPLING_DTYPES``, already on the device
        (a captured program's static inputs), and the flags they were
        built with."""
        return cls(**{k: t[k] for k in SAMPLING_DTYPES}, counts=counts, **flags._asdict())

    @classmethod
    def from_numpy(
        cls,
        device: torch.device,
        seeds: np.ndarray,
        steps: np.ndarray,
        temperature: np.ndarray,
        top_k: np.ndarray,
        top_p: np.ndarray,
        freq_penalty: np.ndarray,
        pres_penalty: np.ndarray,
        counts: torch.Tensor,
        need_logprobs: bool,
        mask_words: Optional[np.ndarray] = None,
    ) -> "SamplingParams":
        """Move host arrays to ``device`` and derive the flags from them
        (``counts`` is already a device tensor: the engine caches zeros)."""
        host = dict(seeds=np.asarray(seeds).astype(np.int64) & 0xFFFFFFFF, steps=steps,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    freq_penalty=freq_penalty, pres_penalty=pres_penalty)
        t = {k: torch.as_tensor(np.asarray(host[k], dt)).to(device)
             for k, dt in SAMPLING_DTYPES.items()}
        flags = SamplingFlags.of(temperature, top_k, top_p, freq_penalty, pres_penalty,
                                 need_logprobs)
        return cls.from_tensors(t, counts, flags)._replace(
            mask_words=(
                None if mask_words is None
                else torch.as_tensor(np.asarray(mask_words).astype(np.int64)).to(device)
            ),
            any_mask=mask_words is not None,
        )


def _filtered_logits(
    scaled: torch.Tensor,  # [B, V] temperature-scaled logits
    top_k: torch.Tensor,  # [B]; 0 → disabled
    top_p: torch.Tensor,  # [B]; 1.0 → disabled
) -> torch.Tensor:
    """Apply top-k then top-p masks using a single descending sort."""
    B, V = scaled.shape
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, V, top_k).clamp(1, V)
    kth = sorted_desc.gather(-1, (k - 1)[:, None])  # [B, 1]
    idx = torch.arange(V, device=scaled.device)[None, :]
    sorted_masked = torch.where(idx < k[:, None], sorted_desc, NEG_INF)
    # top-p: the smallest prefix of the sorted distribution with cumulative
    # probability >= top_p (always includes the argmax).
    probs_sorted = torch.softmax(sorted_masked, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    cutoff = ((cum - probs_sorted) < top_p[:, None]).sum(-1).clamp(1, V)
    thresh = sorted_masked.gather(-1, (cutoff - 1)[:, None])
    scaled = torch.where(scaled >= kth, scaled, NEG_INF)
    return torch.where(scaled >= thresh, scaled, NEG_INF)


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash on int64 tensors holding uint32 values.  The
    multipliers are below 2**31, so no product leaves int64."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x46C3A68B) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, steps: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] f32 Gumbel(0, 1) noise, a pure function of (seed, step, id)."""
    key = _mix32(seeds ^ _mix32(steps + 0x3C6EF372))  # [B]
    ids = torch.arange(V, device=seeds.device, dtype=torch.int64)
    bits = _mix32(key[:, None] ^ _mix32(ids * 2 + 1)[None, :])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32
    samp: SamplingParams,
    steps: Optional[torch.Tensor] = None,  # overrides samp.steps (fused carry)
    counts: Optional[torch.Tensor] = None,  # overrides samp.counts (fused carry)
) -> SampleOut:
    """Sample one token per row; optionally raw logprobs of the choice.

    Inadmissible tokens (``mask_words``) drop to NEG_INF before
    temperature/top-k/top-p.  Reported logprobs are the RAW model
    distribution (OpenAI semantics), pre-penalty and pre-mask."""
    B, V = logits.shape
    dev = logits.device
    steps = samp.steps if steps is None else steps
    counts = samp.counts if counts is None else counts
    eff = logits
    if samp.any_penalty:
        c = counts.float()
        eff = (
            logits
            - samp.freq_penalty[:, None] * c
            - samp.pres_penalty[:, None] * (c > 0)
        )
    if samp.any_mask and samp.mask_words is not None:
        shifts = torch.arange(32, device=dev, dtype=torch.int64)
        bits = (samp.mask_words[:, :, None] >> shifts[None, None, :]) & 1
        admissible = bits.reshape(B, -1)[:, :V] != 0
        eff = torch.where(admissible, eff, NEG_INF)
    greedy = eff.argmax(dim=-1)
    if samp.any_sampled:
        scaled = eff / samp.temperature.clamp(min=1e-6)[:, None]
        if samp.any_filter:
            scaled = _filtered_logits(scaled, samp.top_k, samp.top_p)
        sampled = (scaled + gumbel_noise(samp.seeds, steps, V)).argmax(dim=-1)
        tokens = torch.where(samp.temperature <= 0.0, greedy, sampled)
    else:
        tokens = greedy
    if samp.need_logprobs:
        k = min(TOPK_LOGPROBS, V)
        logp = torch.log_softmax(logits.float(), dim=-1)
        chosen = logp.gather(-1, tokens[:, None])[:, 0]
        top_lp, top_ids = logp.topk(k, dim=-1)
        pad = TOPK_LOGPROBS - k  # tiny test vocabs: stable output width
        if pad:
            top_lp = torch.cat([top_lp, top_lp.new_full((B, pad), NEG_INF)], dim=-1)
            top_ids = torch.cat([top_ids, top_ids.new_zeros((B, pad))], dim=-1)
    else:
        chosen = torch.zeros((B,), dtype=torch.float32, device=dev)
        top_ids = torch.zeros((B, TOPK_LOGPROBS), dtype=torch.int64, device=dev)
        top_lp = torch.zeros((B, TOPK_LOGPROBS), dtype=torch.float32, device=dev)
    return SampleOut(tokens, chosen, top_ids, top_lp)
