"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  These tests need a CUDA device and skip without one (they
import no JAX, so they also run where JAX is absent):

    python -m pytest tests/test_torch_kernels_cuda.py -q

chip_smoke.py runs the same comparison at llama-3.1-8b shapes.
"""

import pytest
import torch

from dynamo_tpu_torch.ops import decode_attention as da
from dynamo_tpu_torch.ops import prefill_attention as pa
from dynamo_tpu_torch.ops.ragged_attention import quantize_for_cache

pytestmark = pytest.mark.torch_port

H, KV, D, PS = 32, 8, 128, 16
PAGE_DTYPES = [
    (torch.bfloat16, 1.0),
    (torch.int8, 0.02),
    (torch.float8_e4m3fn, 0.01),
    (torch.float32, 1.0),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _pages(gen, dev, P, dtype, scale):
    vals = torch.randn((P, PS, 2 * KV, D), generator=gen, device=dev)
    return quantize_for_cache(vals / scale, dtype)


# (kv_lens, num_seqs, table width in pages): ragged rows with zero-length
# and padding rows; kv_len on a partition boundary and one past it, a row
# spanning the whole 4096-token table, padding rows at kv_len 1.
DECODE_CASES = {
    "ragged": ([640, 0, 1, 17, 16, 33, 300, 639, 5, 100, 1, 2], 10, 40),
    "partition_edges": ([da.DECODE_PARTITION, da.DECODE_PARTITION + 1, 2 * da.DECODE_PARTITION,
                         2 * da.DECODE_PARTITION + 1, 4096, 1, 1, 0, 3000, 1], 8, 256),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("page_dtype,scale", PAGE_DTYPES, ids=str)
@pytest.mark.parametrize("splits", [1, None])
def test_decode_kernel_matches_plain(cuda, case, page_dtype, scale, splits):
    gen = torch.Generator(device=cuda).manual_seed(0)
    lens, nvalid, PP = DECODE_CASES[case]
    S = len(lens)
    q = torch.randn((S, H, D), generator=gen, device=cuda).to(torch.bfloat16)
    pages = _pages(gen, cuda, S * PP + 4, page_dtype, scale)
    tables = torch.randperm(S * PP, generator=gen, device=cuda).view(S, PP).int()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    num = torch.tensor([nvalid], dtype=torch.int32, device=cuda)
    args = (q, pages, kv_lens, tables, num)
    got = da.decode_attention_cuda(*args, sm_scale=D**-0.5, kv_scale=scale, num_kv_splits=splits)
    want = da.decode_attention_plain(*args, sm_scale=D**-0.5, kv_scale=scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    for r, n in enumerate(lens):
        if r >= nvalid or n == 0:
            assert (got[r] == 0).all()


# (prior prefixes, chunk lengths, S, T): ragged rows; chunks that are not
# multiples of the 64-key tile or a warp's 16 rows over prefixes ending
# mid-page and on page edges; a mixed step's 512-token chunk beside 1-token
# rows up to 2116 tokens.
PREFILL_CASES = {
    "ragged": ([0, 300, 5], [37, 100, 1], 4, 256),
    "tile_edges": ([16, 45, 64, 0], [63, 65, 17, 128], 5, 512),
    "mixed_step": ([1024, 575, 832, 1088, 1345, 1602, 1858, 2115], [512] + [1] * 7, 9, 1024),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
@pytest.mark.parametrize("page_dtype,scale", PAGE_DTYPES, ids=str)
@pytest.mark.parametrize("splits", [1, 3])
def test_prefill_kernel_matches_plain(cuda, case, page_dtype, scale, splits):
    gen = torch.Generator(device=cuda).manual_seed(1)
    priors, q_lens, S, T = PREFILL_CASES[case]
    kv = [p + n for p, n in zip(priors, q_lens)]
    PP = -(-max(kv) // PS)
    q = torch.randn((T, H, D), generator=gen, device=cuda).to(torch.bfloat16)
    pages = _pages(gen, cuda, S * PP + 4, page_dtype, scale)
    tables = torch.randperm(S * PP, generator=gen, device=cuda).view(S, PP).int()
    kv_lens = torch.tensor(kv + [0] * (S - len(kv)), dtype=torch.int32, device=cuda)
    cu = [0]
    for n in q_lens:
        cu.append(cu[-1] + n)
    cu += [cu[-1]] * (S + 1 - len(cu))
    cu = torch.tensor(cu, dtype=torch.int32, device=cuda)
    num = torch.tensor([len(q_lens)], dtype=torch.int32, device=cuda)
    args = (q, pages, kv_lens, tables, cu, num)
    got = pa.prefill_attention_cuda(*args, sm_scale=D**-0.5, kv_scale=scale, num_kv_splits=splits)
    want = pa.prefill_attention_plain(*args, sm_scale=D**-0.5, kv_scale=scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    assert (got[sum(q_lens):] == 0).all()


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((2, 32, 64), dtype=torch.bfloat16, device=cuda)  # head_dim 64
    pages = torch.zeros((4, PS, 16, 64), dtype=torch.bfloat16, device=cuda)
    idx = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    num = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q, pages, lens, idx, num, sm_scale=1.0)
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q.cpu(), pages, lens, idx, num, sm_scale=1.0)


def test_engine_sampling_features_on_the_card(cuda):
    """TorchEngine on CUDA with every sampler stage engaged: penalties (the
    on-device counts carry), top-k/top-p, seeds, logprobs; a small model
    at head_dim 128 (what the kernels take)."""
    import asyncio

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.protocols import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.models.config import ModelConfig, register_config
    from dynamo_tpu_torch.runtime.engine import Context, collect

    register_config(ModelConfig(
        name="card-tiny", vocab_size=512, hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=1, head_dim=128, intermediate_size=512,
    ))
    cfg = EngineConfig(model="card-tiny", dtype="bfloat16", block_size=16,
                       num_blocks=64, max_batch=4, max_model_len=256,
                       prefill_chunk=32, decode_steps=4)

    async def run():
        eng = TorchEngine(cfg, device=cuda)
        opts = [
            dict(temperature=0.0, frequency_penalty=0.5, presence_penalty=0.3),
            dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
            dict(temperature=1.0, seed=6, logprobs=3),
            dict(temperature=0.0),
        ]

        async def one(i, o):
            req = PreprocessedRequest(
                token_ids=list(range(1, 40 + 9 * i)),
                stop_conditions=StopConditions(max_tokens=12, ignore_eos=True),
                sampling_options=SamplingOptions(**o),
            ).to_dict()
            return await collect(await eng.generate(Context(req)))

        try:
            return await asyncio.gather(*(one(i, o) for i, o in enumerate(opts)))
        finally:
            await eng.close()

    first = asyncio.run(run())
    for items in first:
        assert items[-1]["finish_reason"] == "length"
        assert sum(len(it["token_ids"]) for it in items) == 12
    assert all("logprobs" in it for it in first[2][:-1])
    again = asyncio.run(run())  # seeded and greedy streams reproduce
    toks = [[t for it in items for t in it["token_ids"]] for items in first]
    assert toks == [[t for it in items for t in it["token_ids"]] for items in again]


def _card_tiny_engine(cuda, **over):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig, register_config

    register_config(ModelConfig(
        name="card-tiny", vocab_size=512, hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=1, head_dim=128, intermediate_size=512,
    ))
    cfg = EngineConfig(**dict(dict(model="card-tiny", dtype="bfloat16", block_size=16,
                                   num_blocks=64, max_batch=4, max_model_len=256,
                                   prefill_chunk=32, decode_steps=4), **over))
    return TorchEngine(cfg, device=cuda)


def test_graph_replays_match_eager_and_count_kernel_launches(cuda):
    """Each captured program against the eager call on the same inputs
    (writes dropped), and the kernel launches a replay adds."""
    import numpy as np

    from dynamo_tpu_torch.models.llama import RaggedBatch

    eng = _card_tiny_engine(cuda)
    counts = eng.warmup()
    assert counts == {"step": len(eng.reachable_token_buckets()), "multi": 2}
    S, PP = eng.cfg.max_batch, eng.cfg.max_blocks_per_seq
    samp = eng._sampling_arrays([])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    sp = eng._samp_params({k: t(v) for k, v in samp.arrays.items()}, samp.flags)
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        n = 20
        cu = np.zeros(S + 1, np.int32)
        cu[1:] = n
        rb = dict(token_ids=np.pad(rng.integers(1, 512, n), (0, 12)).astype(np.int64),
                  positions=np.pad(np.arange(n), (0, 12)).astype(np.int32),
                  slot_mapping=np.full(32, -1, np.int32),
                  kv_lens=np.asarray([n, 0, 0, 0], np.int32),
                  page_indices=np.zeros((S, PP), np.int32), cu_q_lens=cu,
                  num_seqs=np.asarray([1], np.int32))
        before = pa.prefill_attention_cuda.launches
        got = eng._run_step(rb, samp).tokens.clone()
        assert pa.prefill_attention_cuda.launches - before == 2  # one a layer
        want = eng._step(RaggedBatch(**{k: t(v) for k, v in rb.items()}), sp).tokens
        assert torch.equal(got, want)
        pos0 = np.asarray([40, 55, 70, 85], np.int32)
        tabs = rng.permutation(64)[: S * PP].reshape(S, PP).astype(np.int32) % 64
        tok0 = rng.integers(1, 512, S).astype(np.int64)
        before = da.decode_attention_cuda.launches
        got = eng._run_multi(tok0, pos0, tabs, pos0.copy(), samp).tokens.clone()
        assert da.decode_attention_cuda.launches - before == 2 * eng.cfg.decode_steps
        want, _ = eng._multi(t(tok0), sp.steps, eng._zero_counts, t(pos0), t(tabs), t(pos0), sp)
        assert torch.equal(got, want.tokens)
    assert eng.compile_counts() == counts


def test_failed_capture_raises(cuda):
    """A program that cannot be captured (here: a host sync inside the
    step) raises from the dispatch; nothing runs eagerly instead."""
    import numpy as np

    eng = _card_tiny_engine(cuda)
    step = eng._step

    def syncing_step(rb, samp):
        out = step(rb, samp)
        out.tokens.sum().item()  # a host read: not permitted while capturing
        return out

    eng._step = syncing_step
    S, PP = eng.cfg.max_batch, eng.cfg.max_blocks_per_seq
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = 16
    rb = dict(token_ids=np.ones(16, np.int64), positions=np.arange(16, dtype=np.int32),
              slot_mapping=np.full(16, -1, np.int32),
              kv_lens=np.asarray([16, 0, 0, 0], np.int32),
              page_indices=np.zeros((S, PP), np.int32), cu_q_lens=cu,
              num_seqs=np.asarray([1], np.int32))
    with torch.inference_mode(), pytest.raises(RuntimeError):
        eng._run_step(rb, eng._sampling_arrays([]))
    assert eng.compile_counts()["step"] == 0
