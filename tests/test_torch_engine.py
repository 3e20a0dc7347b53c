"""The port as a whole: TorchEngine against TpuEngine on debug-tiny.

Both engines get the same seeded weights (the JAX ``init_params`` tree;
the port's copy through ``params_from_jax``) and the same configuration,
with ``decode_steps`` 4 and a small ``prefill_chunk`` so that chunked
prefill, mixed steps and fused decode dispatches all happen.  Four
concurrent greedy requests must give identical token streams and finish
reasons.  The JAX engine runs its XLA attention path on the CPU; the port
runs the plain versions of its kernels.
"""

import asyncio

import jax
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
from dynamo_tpu_torch.runtime.engine import Context, collect

pytestmark = pytest.mark.torch_port

CFG = dict(
    model="debug-tiny",
    block_size=4,
    num_blocks=64,
    max_batch=4,
    max_model_len=128,
    prefill_chunk=8,
    dtype="float32",
    decode_steps=4,
    prefill_chunks_per_burst=2,
)
PROMPTS = [
    [5, 17, 33, 2, 250, 9, 61],
    list(range(40, 61)),
    [7, 7, 7, 7, 100, 3, 11, 19, 23, 29, 31, 37, 41],
    [200, 1, 150],
]
MAX_TOKENS = [12, 9, 14, 11]


def _req(tokens, max_tokens, **samp):
    return PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=SamplingOptions(**samp),
    ).to_dict()


async def _serve(engine, **samp):
    async def one(p, m):
        items = await collect(await engine.generate(Context(_req(p, m, **samp))))
        return [t for it in items for t in it["token_ids"]], items[-1]["finish_reason"]

    try:
        return await asyncio.gather(*(one(p, m) for p, m in zip(PROMPTS, MAX_TOKENS)))
    finally:
        await engine.close()


def _jax_params():
    cfg = jax_get_config("debug-tiny").with_overrides(dtype="float32")
    return jax_init_params(cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("samp,over", [
    ({}, {}),
    # greedy with penalties: the fused decode carries the output-token
    # counts on the device between iterations
    ({"frequency_penalty": 0.7, "presence_penalty": 0.4}, {}),
    # a pool too small for all four: decode growth preempts and recomputes
    ({}, {"num_blocks": 14}),
    # int8 KV pages with a static scale, dequantized inside attention
    ({}, {"cache_dtype": "int8", "kv_scale": 0.05}),
], ids=["greedy", "greedy-penalties", "preemption", "int8-kv"])
async def test_torch_engine_streams_match_tpu_engine(samp, over):
    cfg = dict(CFG, **over)
    params = _jax_params()
    want = await _serve(TpuEngine(JaxEngineConfig(**cfg), params=params), **samp)
    tree = jax.tree_util.tree_map(np.asarray, params)
    engine = TorchEngine(EngineConfig(**cfg), params=params_from_jax(tree, device="cpu"),
                         device="cpu")
    got = await _serve(engine, **samp)
    assert [len(t) for t, _ in got] == MAX_TOKENS
    assert got == want
    kernels = engine.dispatch_summary()
    assert kernels["decode_kernel"] == kernels["prefill_kernel"] == "plain"
    assert engine.decode_spans.count > 0 and engine.prefill_spans.count > 0
    assert engine.decode_spans.seconds > 0 and engine.prefill_spans.seconds > 0
    assert (engine.scheduler.preempted > 0) == ("num_blocks" in over)


async def test_seeded_sampling_streams_are_reproducible():
    cfg = EngineConfig(**CFG)

    async def run():
        eng = TorchEngine(cfg, device="cpu")
        return await _serve(eng, temperature=0.9, top_p=0.9, seed=11)

    a, b = await run(), await run()
    assert a == b
    assert all(r == "length" for _, r in a)


async def test_engine_finishes_on_eos_and_reports_usage():
    eng = TorchEngine(EngineConfig(**CFG), device="cpu")
    req = PreprocessedRequest(
        token_ids=[1, 2, 3],
        stop_conditions=StopConditions(max_tokens=30, stop_token_ids=[]),
    ).to_dict()
    greedy = await collect(await eng.generate(Context(req)))
    toks = [t for it in greedy for t in it["token_ids"]]
    # Stop on the first generated token, whatever it is.
    req["stop_conditions"]["stop_token_ids"] = [toks[0]]
    items = await collect(await eng.generate(Context(req)))
    await eng.close()
    assert items[-1]["finish_reason"] == "stop"
    assert items[-1]["usage"]["completion_tokens"] == 1
    assert [t for it in items for t in it["token_ids"]] == []


def test_engine_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TorchEngine(EngineConfig(**CFG))  # no device given: CUDA or nothing


async def test_engine_refuses_prompt_ids_outside_the_vocabulary():
    eng = TorchEngine(EngineConfig(**CFG), device="cpu")
    try:
        for bad in ([1, 256], [-1, 2]):  # debug-tiny's vocabulary is [0, 256)
            with pytest.raises(ValueError, match="outside the vocabulary"):
                await eng.generate(Context(_req(bad, 4)))
        assert eng.scheduler.num_waiting == eng.scheduler.num_running == 0
    finally:
        await eng.close()


async def test_abandoned_stream_frees_its_row():
    """Closing a stream after its first item cancels the request: the
    engine must not decode it on to max_tokens."""
    eng = TorchEngine(EngineConfig(**CFG), device="cpu")
    removed = []
    remove = eng.scheduler.remove
    eng.scheduler.remove = lambda seq: (removed.append(len(seq.output)), remove(seq))[1]
    try:
        stream = await eng.generate(Context(_req([5, 17, 33], 100)))
        async for _ in stream:
            break
        await stream.aclose()
        for _ in range(200):
            if not eng.scheduler.num_running:
                break
            await asyncio.sleep(0.01)
        assert eng.scheduler.num_running == 0
        assert removed and removed[0] < 100
    finally:
        await eng.close()
