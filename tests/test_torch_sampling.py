"""The port's sampler noise against ``jax.random``, and sampled streams
across packages.

- ``ops/sampling.py``'s plain threefry gives the uint32 bits of
  ``jax.random.bits`` under the JAX package's row keys (``_row_keys``:
  ``fold_in(PRNGKey(seed), step)``) exactly, over a seeded grid of
  (seed, step) that includes 0 and 2**32 - 1.
- Its Gumbel values agree with ``jax.random.gumbel`` within 2 f32 ulp,
  counted at the scale ``max(|g|, 1)``: both compute ``-log(-log(u))`` on
  the same ``u`` and each log may differ by an ulp between XLA and
  PyTorch; where ``g`` is near 0 (``-log(u)`` near 1) the outer log turns
  that ulp into many ulps of ``g`` itself, but never into more than 2 ulp
  of the logits it is added to.
- ``categorical_plain`` gives ``jax.random.categorical``'s tokens exactly
  under the same row keys: edge seeds and steps, constant rows (the noise
  alone decides), a row at -1e30 but one id, a NaN row (its first NaN),
  temperatures below the 1e-6 floor, and pre-scaled rows.
- ``sample_tokens`` draws the tokens of the JAX package's ``sample_tokens``
  for temperature, top-k, top-p and penalties, routes sampled rows through
  ``categorical`` (with the temperature, or pre-scaled after the filters),
  and an all-greedy step does no key work.
- ``TorchEngine`` and ``TpuEngine`` on debug-tiny in f32 (the same seeded
  weights) give identical seeded temperature streams, and identical
  logprob values (within 1e-6) and top-k ids with logprobs 0–3 at
  ``decode_steps`` 1, 4 and 8.

The CUDA kernel (``csrc/threefry_gumbel.cu``: the categorical draw and
the noise entry) is held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import asyncio
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops import sampling as tsamp
from dynamo_tpu_torch.runtime.engine import Context, collect

jsamp = importlib.import_module("dynamo_tpu.ops.sampling")

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
U32_MAX = 2**32 - 1
# (seed, step) grid: the edges, then seeded draws.
_rng = np.random.default_rng(11)
SEEDS = np.concatenate([[0, 1, U32_MAX, 0, U32_MAX, 2**31],
                        _rng.integers(0, 2**32, 26, dtype=np.uint64)]).astype(np.uint32)
STEPS = np.concatenate([[0, 0, 0, U32_MAX, U32_MAX, 1],
                        _rng.integers(0, 2**32, 26, dtype=np.uint64)]).astype(np.uint32)


def _i64(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@jax.jit
def _jax_bits_and_gumbel(seeds, steps):
    keys = jsamp._row_keys(seeds, steps)
    bits = jax.vmap(lambda k: jax.random.bits(k, (1000,), jnp.uint32))(keys)
    gum = jax.vmap(lambda k: jax.random.gumbel(k, (1000,), jnp.float32))(keys)
    return keys, bits, gum


def test_plain_threefry_bits_equal_jax_random_bits():
    keys, bits, _ = _jax_bits_and_gumbel(jnp.asarray(SEEDS), jnp.asarray(STEPS))
    k0, k1 = tsamp.row_keys(_i64(SEEDS), _i64(STEPS))
    got_keys = np.stack([k0.numpy(), k1.numpy()], -1).astype(np.uint32)
    np.testing.assert_array_equal(got_keys, np.asarray(keys))
    got = tsamp.random_bits_plain(_i64(SEEDS), _i64(STEPS), 1000).numpy()
    assert got.min() >= 0 and got.max() <= U32_MAX
    np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(bits))


def test_plain_gumbel_within_two_ulp_of_jax_random_gumbel():
    _, _, want = _jax_bits_and_gumbel(jnp.asarray(SEEDS), jnp.asarray(STEPS))
    want = np.asarray(want)
    got = tsamp.gumbel_noise_plain(_i64(SEEDS), _i64(STEPS), 1000).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    ulps = np.abs(got.astype(np.float64) - want) / scale
    assert ulps.max() <= 2.0, ulps.max()


@jax.jit
def _jax_categorical(seeds, steps, x):
    return jax.vmap(jax.random.categorical)(jsamp._row_keys(seeds, steps), x)


def _categorical_rows(B, V, rng):
    """[B, V] f32 rows: random logits, then a constant row, a row at -1e30
    but one id, a NaN row (NaNs at 7 and V - 5), and random again."""
    x = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    if B > 1:
        x[1] = 0.5
        x[2] = jsamp.NEG_INF
        x[2, V // 3] = -2.0
        x[3, [7, V - 5]] = np.nan
    return x


@pytest.mark.parametrize("V", [1000, 1003])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("temperature", [1e-7, 0.7, 2.0, None])
def test_categorical_plain_equals_jax_random_categorical(B, V, temperature):
    """``categorical_plain`` (and ``categorical`` on the CPU) against
    ``jax.vmap(jax.random.categorical)`` over the JAX package's row keys:
    equal tokens.  ``None``: rows already scaled, as after the filters."""
    rng = np.random.default_rng(B * 10007 + V)
    x = _categorical_rows(B, V, rng)
    seeds = np.asarray([0, U32_MAX, 3, 2**31, 77][:B], np.uint32)
    steps = np.asarray([U32_MAX, 0, 5, 1, 2**31 + 9][:B], np.uint32)
    temp = None if temperature is None else np.full(B, temperature, np.float32)
    if temp is not None and B > 1:
        temp[4] = 0.7 if temperature != 0.7 else 2.0  # rows at two temperatures
    scaled = x if temp is None else np.asarray(
        jnp.asarray(x) / jnp.maximum(jnp.asarray(temp), 1e-6)[:, None])
    want = np.asarray(_jax_categorical(jnp.asarray(seeds), jnp.asarray(steps),
                                       jnp.asarray(scaled)))
    t = None if temp is None else torch.as_tensor(temp)
    got = tsamp.categorical_plain(torch.as_tensor(x), t, _i64(seeds), _i64(steps))
    assert got.dtype == torch.int64 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tsamp.categorical(torch.as_tensor(x), t, _i64(seeds), _i64(steps)), got)
    if B > 1:
        assert got[2] == V // 3  # the one id above -1e30
        assert got[3] == 7  # the row's first NaN, as torch.argmax and jnp.argmax give
        noise = tsamp.gumbel_noise_plain(_i64(seeds[1:2]), _i64(steps[1:2]), V)
        assert got[1] == noise.argmax()  # a constant row: the noise alone decides


@pytest.mark.parametrize("filtered", [False, True], ids=["temperature", "top_k"])
def test_sample_tokens_draws_sampled_rows_through_categorical(monkeypatch, filtered):
    """Sampled rows take one ``categorical`` call: with the temperature on
    unfiltered steps, pre-scaled (``None``) after top-k/top-p; the greedy
    rows keep the argmax."""
    calls = []
    real = tsamp.categorical
    monkeypatch.setattr(tsamp, "categorical",
                        lambda x, t, *a: calls.append((x, t)) or real(x, t, *a))
    B, V = 4, 50
    logits = torch.randn(B, V, generator=torch.Generator().manual_seed(1))
    temp = np.asarray([0.7, 0.0, 1.3, 0.9], np.float32)
    topk = np.full(B, 5 if filtered else 0, np.int32)
    z = np.zeros(B, np.float32)
    samp = tsamp.SamplingParams.from_numpy(
        CPU, np.arange(B), np.arange(B, dtype=np.int32), temp, topk, np.ones(B, np.float32),
        z, z, torch.zeros((B, V), dtype=torch.int16), False)
    assert samp.any_filter == filtered
    tokens = tsamp.sample_tokens(logits, samp).tokens
    assert len(calls) == 1
    x, t = calls[0]
    if filtered:
        assert t is None and int((x[0] > jsamp.NEG_INF).sum()) == 5
    else:
        assert torch.equal(t, torch.as_tensor(temp)) and torch.equal(x, logits)
    assert tokens[1] == logits[1].argmax()
    want = tsamp.categorical_plain(x, t, samp.seeds, samp.steps)
    assert tokens[[0, 2, 3]].tolist() == want[[0, 2, 3]].tolist()


def _jax_sample(logits, seeds, steps, temp, topk, topp, fpen, ppen, counts):
    return jsamp.sample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(steps), jnp.asarray(temp),
        jnp.asarray(topk), jnp.asarray(topp), jnp.asarray(fpen), jnp.asarray(ppen),
        jnp.asarray(counts), jnp.asarray(False),
    )


@pytest.mark.parametrize("case", ["temperature", "top_k", "top_p", "penalties", "mixed"])
def test_sampled_tokens_equal_the_jax_sampler(case):
    rng = np.random.default_rng({"temperature": 1, "top_k": 2, "top_p": 3,
                                 "penalties": 4, "mixed": 5}[case])
    B, V, draws = 8, 300, 12
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int16)
    temp = np.full(B, 0.7, np.float32)
    topk = np.zeros(B, np.int32)
    topp = np.ones(B, np.float32)
    fpen = np.zeros(B, np.float32)
    ppen = np.zeros(B, np.float32)
    if case == "top_k":
        topk[:] = rng.integers(1, 40, B)
    elif case == "top_p":
        topp[:] = rng.uniform(0.3, 0.95, B).astype(np.float32)
    elif case == "penalties":
        fpen[:] = rng.uniform(0, 1, B).astype(np.float32)
        ppen[:] = rng.uniform(0, 1, B).astype(np.float32)
    elif case == "mixed":  # greedy rows beside filtered and penalised ones
        temp[::3] = 0.0
        topk[1::3] = 20
        topp[2::3] = 0.8
        fpen[::2] = 0.5
    seeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    seeds[0], seeds[1] = 0, U32_MAX
    moved = 0
    for step in range(draws):
        steps = np.full(B, step, np.int32) + np.arange(B, dtype=np.int32)
        want = np.asarray(_jax_sample(logits, seeds, steps, temp, topk, topp, fpen, ppen,
                                      counts).tokens)
        samp = tsamp.SamplingParams.from_numpy(CPU, seeds, steps, temp, topk, topp, fpen, ppen,
                                               torch.as_tensor(counts), False)
        got = tsamp.sample_tokens(torch.as_tensor(logits), samp).tokens.numpy()
        np.testing.assert_array_equal(got, want)
        moved += int((got != logits.argmax(-1)).sum())
    assert moved > 0  # the draws are not greedy


def test_all_greedy_step_does_no_key_work(monkeypatch):
    """As the JAX sampler's outer ``lax.cond`` skips ``_row_keys``, an
    all-greedy step never draws noise."""
    calls = []
    real = tsamp.categorical
    monkeypatch.setattr(tsamp, "categorical", lambda *a: calls.append(a) or real(*a))
    B, V = 4, 50
    logits = torch.randn(B, V, generator=torch.Generator().manual_seed(0))
    z = np.zeros(B, np.float32)
    greedy = tsamp.SamplingParams.from_numpy(
        CPU, np.arange(B), np.zeros(B, np.int32), z, np.zeros(B, np.int32), np.ones(B, np.float32),
        z, z, torch.zeros((B, V), dtype=torch.int16), False)
    assert tsamp.sample_tokens(logits, greedy).tokens.tolist() == logits.argmax(-1).tolist()
    assert calls == []
    sampled = greedy._replace(temperature=torch.full((B,), 0.5), any_sampled=True)
    tsamp.sample_tokens(logits, sampled)
    assert len(calls) == 1


# ------------------------------------------------------- the two engines

CFG = dict(model="debug-tiny", block_size=4, num_blocks=64, max_batch=4, max_model_len=128,
           prefill_chunk=8, dtype="float32", decode_steps=4, prefill_chunks_per_burst=2)
PROMPTS = [[5, 17, 33, 2, 250, 9, 61], list(range(40, 61)),
           [7, 7, 7, 7, 100, 3, 11, 19, 23, 29, 31, 37, 41], [200, 1, 150]]
MAX_TOKENS = [12, 9, 14, 11]
_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS["jax"] = jax_init_params(
            jax_get_config("debug-tiny").with_overrides(dtype="float32"), jax.random.PRNGKey(0))
        _PARAMS["np"] = jax.tree_util.tree_map(np.asarray, _PARAMS["jax"])
    return _PARAMS


def _engines(**over):
    cfg = dict(CFG, **over)
    p = _params()
    return (TpuEngine(JaxEngineConfig(**cfg), params=p["jax"]),
            TorchEngine(EngineConfig(**cfg), params=params_from_jax(p["np"], device="cpu"),
                        device="cpu"))


async def _serve(engine, samps):
    async def one(p, m, samp):
        req = PreprocessedRequest(
            token_ids=list(p), stop_conditions=StopConditions(max_tokens=m, ignore_eos=True),
            sampling_options=SamplingOptions(**samp)).to_dict()
        return await collect(await engine.generate(Context(req)))

    try:
        return await asyncio.gather(*(one(p, m, s) for p, m, s in zip(PROMPTS, MAX_TOKENS, samps)))
    finally:
        await engine.close()


def _tokens(items):
    return [t for it in items for t in it["token_ids"]]


@pytest.mark.parametrize("samps", [
    [dict(temperature=0.7, seed=s) for s in (1, 2, 3, U32_MAX)],
    [dict(temperature=0.9, seed=7, top_k=20), dict(temperature=0.8, seed=8, top_p=0.85),
     dict(temperature=1.1, seed=9, frequency_penalty=0.6, presence_penalty=0.3),
     dict(temperature=0.0)],
], ids=["temperature", "filters-penalties-greedy"])
async def test_seeded_temperature_streams_match_tpu_engine(samps):
    jax_engine, port_engine = _engines()
    want = await _serve(jax_engine, samps)
    got = await _serve(port_engine, samps)
    assert [_tokens(g) for g in got] == [_tokens(w) for w in want]
    assert [len(_tokens(g)) for g in got] == MAX_TOKENS


@pytest.mark.parametrize("decode_steps", [1, 4, 8])
async def test_logprobs_and_top_ids_match_tpu_engine(decode_steps):
    samps = [dict(temperature=0.0, logprobs=0), dict(temperature=0.0, logprobs=1),
             dict(temperature=0.8, seed=5, logprobs=2),
             dict(temperature=0.0, logprobs=3, frequency_penalty=0.5)]
    jax_engine, port_engine = _engines(decode_steps=decode_steps)
    want = await _serve(jax_engine, samps)
    got = await _serve(port_engine, samps)
    for g, w, s in zip(got, want, samps):
        assert _tokens(g) == _tokens(w)
        glp = [lp for it in g for lp in ([it["logprobs"]] if "logprobs" in it else [])]
        wlp = [lp for it in w for lp in ([it["logprobs"]] if "logprobs" in it else [])]
        assert len(glp) == len(wlp) == len(_tokens(g))
        for a, b in zip(glp, wlp):
            assert abs(a["logprob"] - b["logprob"]) <= 1e-6
            assert [i for i, _ in a["top"]] == [i for i, _ in b["top"]]
            assert len(a["top"]) == s["logprobs"]
            for (_, x), (_, y) in zip(a["top"], b["top"]):
                assert abs(x - y) <= 1e-6
