"""Batched on-device token sampling: greedy / temperature / top-k / top-p /
frequency+presence penalties / packed admissible-token masks / logprobs.

Port of the JAX package's ``ops/sampling.py::sample_tokens``.  All rows
sample in one batched op with per-row parameters as tensors; temperature 0
means greedy regardless of the other knobs.  Where JAX skipped unused work
with on-device ``lax.cond``, this port branches on flags the host already
knows when it builds the step (``SamplingParams``), so no branch waits on
the device.

Randomness: row ``i`` draws from ``fold_in(PRNGKey(seed_i), step_i)``,
where ``step`` is the row's output-token index — so a request's sampled
tokens are reproducible per (seed, step) whatever batch row or dispatch it
rode in — and its Gumbel noise is ``jax.random``'s, bit for bit: the
threefry-2x32 construction of ``jax.random.categorical`` under
``jax_threefry_partitionable=True`` (the default of the JAX package's
jax), ``gumbel``'s "low" mode.  A sampled stream therefore continues
exactly across the two packages (a resumed or migrated stream may land on
either).  The sampled rows' draw is ``categorical``, the Gumbel-max
``argmax(x / temperature + g)`` of ``jax.random.categorical``; it routes
by device: CUDA tensors launch ``csrc/threefry_gumbel.cu`` (noise,
division, add and argmax in one kernel), CPU tensors take
``categorical_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build

NEG_INF = -1e30
# Temperatures below this divide as this (the JAX sampler's floor).
MIN_TEMPERATURE = 1e-6
# Rows a sampler kernel launch takes (its grid's y dimension).
MAX_KERNEL_ROWS = 65535
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
    # Stages the host knows no row needs are skipped; a constructor that
    # does not say runs them (the results are the same, the step slower).
    any_penalty: bool = True
    any_sampled: bool = True  # some row has temperature > 0
    any_filter: bool = True  # some sampled row uses top-k or top-p

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
    # Stages the host knows no row needs are skipped; a constructor that
    # does not say runs them (the results are the same, the step slower).
    any_penalty: bool = True
    any_sampled: bool = True  # some row has temperature > 0
    any_filter: bool = True  # some sampled row uses top-k or top-p
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
# jax's threefry2x32 (jax/_src/prng.py ``_threefry2x32_lowering``): two
# rotation schedules alternating over five groups of four rounds, with a key
# injection after each group.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# ``jnp.finfo(jnp.float32).tiny``: ``_gumbel``'s "low" mode draws uniforms
# on [tiny, 1).
_F32_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 on int64 tensors holding uint32 values (broadcasting
    key halves ``k0, k1`` against counter halves ``x0, x1``); the pair of
    outputs, as ``threefry2x32_p`` returns them."""
    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _M32

    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def row_keys(seeds: torch.Tensor, steps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_in(PRNGKey(seed), step)`` per row (the JAX package's
    ``_row_keys``): ``PRNGKey`` of a uint32 seed is ``[0, seed]``, and
    ``fold_in(key, d)`` is threefry of ``key`` over the counter ``[0, d]``."""
    seeds = seeds.to(torch.int64) & _M32
    steps = steps.to(torch.int64) & _M32
    return threefry2x32(torch.zeros_like(seeds), seeds, torch.zeros_like(steps), steps)


def random_bits_plain(seeds: torch.Tensor, steps: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] uint32 bits (in int64) of ``jax.random.bits(row_key, (V,))``:
    threefry of the row key over the counters ``(hi, lo)`` of the flat
    index (``iota_2x32_shape``; hi is 0 below 2**32), the halves xored."""
    k0, k1 = row_keys(seeds, steps)
    ids = torch.arange(V, device=seeds.device, dtype=torch.int64)[None, :]
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(ids), ids)
    return b0 ^ b1


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax's ``_uniform`` on [tiny, 1) from 32 random bits — the top 23 as
    the mantissa of a float in [1, 2), minus 1, scaled and floored at tiny
    — then ``_gumbel``'s "low" mode ``-log(-log(u))``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * (1.0 - _F32_TINY) + _F32_TINY, _F32_TINY)
    return -torch.log(-torch.log(u))


def gumbel_noise_plain(seeds: torch.Tensor, steps: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] f32 Gumbel(0, 1) noise of ``jax.random.gumbel(row_key, (V,))``,
    in plain PyTorch (int64 tensors holding uint32 values)."""
    return gumbel_from_bits(random_bits_plain(seeds, steps, V))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("threefry_gumbel")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.threefry_gumbel_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp]
    lib.threefry_gumbel_launch.restype = ci
    lib.threefry_categorical_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.threefry_categorical_launch.restype = ci
    lib.threefry_categorical_profile_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                                        vp]
    lib.threefry_categorical_profile_launch.restype = ci
    lib.threefry_categorical_ctas.argtypes = [ci, ci, ci, ci]
    lib.threefry_categorical_ctas.restype = ci
    lib.gumbel_of_bits_launch.argtypes = [vp, vp, ci, vp]
    lib.gumbel_of_bits_launch.restype = ci
    return lib


def _check_rows(dev: torch.device, seeds: torch.Tensor, steps: torch.Tensor, B: int) -> None:
    """The [B] int64 seeds and steps a kernel takes, on ``dev``."""
    if dev.type != "cuda" or seeds.device != dev or steps.device != dev:
        raise ValueError(f"CUDA kernel given tensors on {dev}/{seeds.device}/{steps.device}")
    if seeds.shape != (B,) or steps.shape != (B,):
        raise ValueError(f"seeds {tuple(seeds.shape)} / steps {tuple(steps.shape)} are not [B]")
    if seeds.dtype != torch.int64 or steps.dtype != torch.int64:
        raise TypeError(f"seeds/steps must be int64, got {seeds.dtype}/{steps.dtype}")
    if not (seeds.is_contiguous() and steps.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if B > MAX_KERNEL_ROWS:
        raise ValueError(f"{B} rows: the kernels take at most {MAX_KERNEL_ROWS}")


def gumbel_noise_cuda(seeds: torch.Tensor, steps: torch.Tensor, V: int,
                      bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/threefry_gumbel.cu's noise entry on the current stream
    (no sync): one thread per (row, id).  The sampler draws through
    ``categorical``; this entry serves the checks (the bits against
    ``random_bits_plain``, and the unfused draw chip_smoke.py times).
    ``bits`` (a [B, V] int32 tensor) also receives the raw uint32 bits."""
    dev = seeds.device
    B = seeds.shape[0] if seeds.dim() == 1 else -1
    _check_rows(dev, seeds, steps, B)
    if bits is not None and (bits.shape != (B, V) or bits.dtype != torch.int32
                             or bits.device != dev or not bits.is_contiguous()):
        raise ValueError("bits must be a contiguous [B, V] int32 tensor on the same device")
    out = torch.empty((B, V), dtype=torch.float32, device=dev)
    lib = _lib()
    p = _build.ptr
    code = lib.threefry_gumbel_launch(p(seeds), p(steps), p(out), p(bits), B, V,
                                      _build.stream_ptr(dev))
    _build.check(lib, code, "threefry_gumbel")
    return out


def gumbel_of_bits_cuda(bits: torch.Tensor) -> torch.Tensor:
    """The categorical kernel's Gumbel value of each int32 ``bits`` word (a
    CUDA tensor), for the checks that hold it against ``gumbel_from_bits``
    on every uniform; nothing on the main path calls it."""
    if bits.device.type != "cuda" or bits.dtype != torch.int32 or not bits.is_contiguous():
        raise ValueError("bits must be a contiguous int32 CUDA tensor")
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    lib = _lib()
    code = lib.gumbel_of_bits_launch(_build.ptr(bits), _build.ptr(out), bits.numel(),
                                     _build.stream_ptr(bits.device))
    _build.check(lib, code, "gumbel_of_bits")
    return out


def categorical_plain(x: torch.Tensor, temperature: Optional[torch.Tensor],
                      seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """[B] int64 tokens ``argmax(x / max(temperature, 1e-6) + g)`` with
    ``g`` the rows' ``gumbel_noise_plain`` (``jax.random.categorical``'s
    Gumbel-max); ``temperature=None``: the rows are already scaled."""
    if temperature is not None:
        x = x / temperature.clamp(min=MIN_TEMPERATURE)[:, None]
    return (x + gumbel_noise_plain(seeds, steps, x.shape[-1])).argmax(dim=-1)


def categorical_cuda(x: torch.Tensor, temperature: Optional[torch.Tensor],
                     seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Launch csrc/threefry_gumbel.cu's categorical draw on the current
    stream (no sync): the noise, division, add and argmax fused, a row
    over as many CTAs as the kernel picks; ``categorical_plain``'s
    tokens."""
    dev = x.device
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, V] float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, V = x.shape
    _check_rows(dev, seeds, steps, B)
    if not 1 <= V < 2**31:
        raise ValueError(f"V = {V} ids: the kernel takes 1 to 2**31 - 1")
    if temperature is not None and (
            temperature.shape != (B,) or temperature.dtype != torch.float32
            or temperature.device != dev or not temperature.is_contiguous()):
        raise ValueError("temperature must be a contiguous [B] float32 tensor on the same device")
    tokens = torch.empty((B,), dtype=torch.int64, device=dev)
    state = torch.zeros((B, 2), dtype=torch.int64, device=dev)  # a row's best pair, CTAs done
    lib = _lib()
    p = _build.ptr
    code = lib.threefry_categorical_launch(
        p(x), p(temperature), p(seeds), p(steps), p(state), p(tokens), B, V,
        torch.cuda.get_device_properties(dev).multi_processor_count, _build.stream_ptr(dev))
    _build.check(lib, code, "threefry_categorical")
    categorical_cuda.launches += 1
    return tokens


categorical_cuda.launches = 0  # kernel launches (engine/graphs.py, chip_smoke.py read it)


def categorical(x: torch.Tensor, temperature: Optional[torch.Tensor],
                seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """[B] int64 tokens of ``jax.random.categorical`` over the rows of
    ``x / max(temperature, 1e-6)`` (``temperature=None``: ``x`` is already
    scaled) under the rows' keys ``fold_in(PRNGKey(seed), step)``.  Routes
    by device: CUDA tensors launch the kernel (or raise), CPU tensors take
    the plain version.  No fallback."""
    if x.device.type == "cuda":
        return categorical_cuda(x, temperature, seeds, steps)
    if x.device.type == "cpu":
        return categorical_plain(x, temperature, seeds, steps)
    raise ValueError(f"no categorical draw for device {x.device}")


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
        # Unpacked through a byte view: the low 4 bytes of each int64 word
        # (little-endian, on the host and the card) hold its 32 bits, so
        # bit j of word w is bit j % 8 of byte 8w + j // 8, and the
        # intermediates are [B, V] bytes, not [B, V] int64.
        words = samp.mask_words.contiguous().view(torch.uint8).view(B, -1, 8)[:, :, :4]
        shifts = torch.arange(8, device=dev, dtype=torch.uint8)
        bits = (words[:, :, :, None] >> shifts) & 1
        admissible = bits.reshape(B, -1)[:, :V] != 0
        eff = torch.where(admissible, eff, NEG_INF)
    greedy = eff.argmax(dim=-1)
    if samp.any_sampled:
        if samp.any_filter:  # the sort needs the scaled rows
            scaled = eff / samp.temperature.clamp(min=MIN_TEMPERATURE)[:, None]
            sampled = categorical(_filtered_logits(scaled, samp.top_k, samp.top_p), None,
                                  samp.seeds, steps)
        else:
            sampled = categorical(eff.contiguous(), samp.temperature, samp.seeds, steps)
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
