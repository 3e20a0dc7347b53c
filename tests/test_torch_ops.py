"""Parity of the PyTorch port's ops with the JAX package on the CPU.

Inputs come from numpy seeds and go through both the JAX function (its XLA
path, the package's own oracle: ``impl="xla"`` / ``prefill_kernel="xla"``)
and its counterpart in ``dynamo_tpu_torch`` on ``device="cpu"``, where the
attention ops run their plain PyTorch versions.  Tolerance: rtol = atol =
2e-5 in f32 (the bar of tests/test_decode_kernel.py); quantization is
exact.  The hand-written CUDA kernels are checked against these plain
versions on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import ast
import functools
import importlib
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu_torch.device import default_device
from dynamo_tpu_torch.ops import ragged_attention as tra
from dynamo_tpu_torch.ops import rope as trope
from dynamo_tpu_torch.ops import sampling as tsamp
from dynamo_tpu_torch.ops.decode_attention import (
    covered_partitions, decode_attention_plain, decode_partitions,
)
from dynamo_tpu_torch.ops.prefill_attention import (
    ROWS, SMALL_ROWS, SMALL_SLICES, prefill_attention_plain, prefill_slots,
)

# dynamo_tpu.ops re-exports functions under its submodules' names.
jra = importlib.import_module("dynamo_tpu.ops.ragged_attention")
jrope = importlib.import_module("dynamo_tpu.ops.rope")
jsamp = importlib.import_module("dynamo_tpu.ops.sampling")

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=2e-5, atol=2e-5)
CPU = torch.device("cpu")
FP8 = ml_dtypes.float8_e4m3fn


def t(a) -> torch.Tensor:
    """numpy → torch on the CPU (fp8 through a byte view)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == FP8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def n(x) -> np.ndarray:
    """torch or jax → numpy f32 (quantized dtypes widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _quantize_np(vals, dtype, scale):
    if dtype == "int8":
        return np.clip(np.round(vals / scale), -127, 127).astype(np.int8)
    if dtype == "fp8":
        return np.clip(vals / scale, -448, 448).astype(FP8)
    return vals.astype(np.float32)


# ------------------------------------------------------------ quantization


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_for_cache_exact(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 4, 16)) * 300).astype(np.float32)
    x[0, 0, :4] = [0.5, 1.5, -2.5, 1000.0]  # ties and overflow
    jdt, tdt = (jnp.int8, torch.int8) if dtype == "int8" else (jnp.float8_e4m3fn, torch.float8_e4m3fn)
    want = jra.quantize_for_cache(jnp.asarray(x), jdt)
    got = tra.quantize_for_cache(t(x), tdt)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("dtype,scale", [("f32", None), ("int8", 0.05), ("fp8", 0.1)])
def test_write_kv_ragged(dtype, scale):
    rng = np.random.default_rng(1)
    P, ps, KV, D, T = 6, 4, 2, 16, 9
    base = _quantize_np(rng.standard_normal((P, ps, 2 * KV, D)).astype(np.float32), dtype, scale or 1.0)
    k = rng.standard_normal((T, KV, D)).astype(np.float32)
    v = rng.standard_normal((T, KV, D)).astype(np.float32)
    slots = np.asarray([3, 17, -1, 0, 22, -1, 9, 5, 23], np.int32)
    want = jra.write_kv_ragged(jnp.asarray(base), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(slots), kv_scale=scale)
    pages = t(base)
    out = tra.write_kv_ragged(pages, t(k), t(v), t(slots), kv_scale=scale)
    assert out is pages  # in place
    np.testing.assert_array_equal(n(pages), n(want))


def test_write_kv_ragged_all_padding_is_a_noop():
    rng = np.random.default_rng(2)
    base = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    pages = t(base)
    kv = t(rng.standard_normal((4, 1, 8)).astype(np.float32))
    tra.write_kv_ragged(pages, kv, kv, t(np.full((4,), -1, np.int32)))
    np.testing.assert_array_equal(pages.numpy(), base)


# -------------------------------------------------------------------- rope


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
])
def test_apply_rope(scaling):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 200, size=(12,)).astype(np.int32)
    jf = jrope.rope_frequencies(32, 10000.0, scaling)
    tf = trope.rope_frequencies(32, 10000.0, scaling)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jf)
    got = trope.apply_rope(t(x), t(pos), tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------- decode attention

# The five geometries of tests/test_decode_kernel.py (page dtype and scale
# spelled as strings): (S, PP, ps, KV, G, D, chain lengths, valid rows,
# dtype, scale).
DECODE_GEOMETRIES = [
    (4, 6, 4, 2, 2, 16, [24, 1, 13, 7], 4, "f32", None),
    (4, 6, 4, 2, 2, 16, [24, 1, 13, 7], 2, "f32", None),  # padding rows
    (5, 8, 4, 1, 4, 16, [32, 0, 5, 17, 2], 5, "int8", 0.05),  # int8 + 0-len
    (2, 5, 2, 2, 1, 8, [9, 10], 2, "f32", 2.5),  # f32 with scale
    (3, 4, 4, 2, 2, 8, [16, 16, 16], 3, "int8", 0.1),  # full chains
]


def _decode_case(seed, S, PP, ps, KV, G, D, lens, nvalid, dtype, scale):
    rng = np.random.default_rng(seed)
    H, P = KV * G, S * PP + 3
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    vals = (rng.standard_normal((P, ps, 2 * KV, D)) * 3.0).astype(np.float32)
    pages = _quantize_np(vals, dtype, scale or 1.0)
    kv_lens = np.zeros(S, np.int32)
    kv_lens[: len(lens)] = lens
    tables = rng.permutation(S * PP).astype(np.int32).reshape(S, PP)
    num = np.asarray([nvalid], np.int32)
    return q, pages, kv_lens, tables, num


@pytest.mark.parametrize("geom", DECODE_GEOMETRIES + [
    (3, 4, 4, 2, 2, 16, [16, 5, 9], 3, "fp8", 0.05),  # fp8 pages
], ids=lambda g: f"S{g[0]}PP{g[1]}{g[8]}")
def test_decode_attention_plain_vs_xla(geom):
    S, PP, ps, KV, G, D, lens, nv, dt, scale = geom
    q, pages, kv_lens, tables, num = _decode_case(0, *geom)
    sm = D**-0.5
    want = jax.jit(functools.partial(
        jra.ragged_decode_attention, sm_scale=sm, impl="xla", kv_scale=scale,
        kernel="xla",
    ))(q, pages, kv_lens, tables, num)
    got = decode_attention_plain(t(q), t(pages), t(kv_lens), t(tables), t(num),
                                 sm_scale=sm, kv_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(S):  # padding and zero-length rows are exact zeros
        if i >= nv or kv_lens[i] == 0:
            np.testing.assert_array_equal(got[i].numpy(), 0.0)


# (table pages, page size, num_kv_splits): the serve phase's 256-page
# table, tables narrower than one partition, and the test override with an
# uneven last split.
PARTITION_PLANS = [(256, 16, None), (40, 16, None), (5, 16, None), (1, 16, None),
                   (256, 16, 5), (40, 16, 3), (7, 4, 2), (3, 4, 8)]


@pytest.mark.parametrize("PP,ps,splits", PARTITION_PLANS, ids=str)
def test_decode_partition_plan_matches_a_brute_force_count(PP, ps, splits):
    """The decode grid (sized from the table width alone) covers every
    position with no partition wholly past the table, and the partitions a
    row's combine reads are exactly those holding one of its positions,
    counted position by position."""
    part, n = decode_partitions(PP, ps, splits)
    W = PP * ps
    owner = np.arange(W) // part  # partition of every table position
    assert owner.max() == n - 1  # every partition holds a position
    if splits:
        assert part % ps == 0 and n <= splits
    for kv_len in sorted(set(range(0, W + 1, 7)) | {0, 1, part - 1, part, part + 1, W - 1, W}):
        if 0 <= kv_len <= W:
            assert covered_partitions(kv_len, part) == len(np.unique(owner[:kv_len]))


# -------------------------------------------------------- prefill attention

# (S, PP, ps, KV, G, D, kv lens, q lens, dtype, scale): the geometries of
# tests/test_prefill_kernel.py, then chunks of 3, 4 and 5 at block size 4
# over a prior prefix, with quantized pages.
PREFILL_GEOMETRIES = [
    (3, 4, 4, 2, 2, 16, [16, 7, 12], [16, 3, 12], "f32", None),
    (4, 4, 4, 2, 2, 16, [13, 9], [5, 9], "f32", None),
    (4, 4, 8, 2, 1, 16, [32, 1, 17, 5], [4, 1, 17, 2], "int8", 0.05),
    (1, 16, 4, 1, 2, 16, [61], [13], "int8", 0.1),
    (2, 5, 2, 2, 1, 8, [9, 10], [3, 10], "f32", 2.5),
    (3, 6, 4, 2, 2, 16, [11, 20, 7], [3, 3, 3], "int8", 0.05),
    (3, 6, 4, 2, 2, 16, [12, 20, 8], [4, 4, 4], "fp8", 0.05),
    (3, 6, 4, 2, 2, 16, [13, 21, 5], [5, 5, 5], "fp8", 0.1),
]


def _prefill_case(seed, S, PP, ps, KV, G, D, kls, qls, dtype, scale, pad=2):
    rng = np.random.default_rng(seed)
    H, P = KV * G, S * PP + 3
    T = sum(qls) + pad
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    vals = (rng.standard_normal((P, ps, 2 * KV, D)) * 3.0).astype(np.float32)
    pages = _quantize_np(vals, dtype, scale or 1.0)
    kv_lens = np.zeros(S, np.int32)
    kv_lens[: len(kls)] = kls
    cu = np.zeros(S + 1, np.int32)
    cu[1: len(qls) + 1] = np.cumsum(qls)
    cu[len(qls) + 1:] = cu[len(qls)]
    tables = rng.permutation(S * PP).astype(np.int32).reshape(S, PP)
    num = np.asarray([len(qls)], np.int32)
    return q, pages, kv_lens, tables, cu, num


def _resolve_slot(b, cu, nseq, G, nsl):
    """csrc/prefill_attention.cu resolve_slot, one slot at a time: (row,
    q-block, key slice), or (-1, spare index, 0)."""
    qb, small = ROWS // G, SMALL_ROWS // G
    for pass_ in (0, 1):
        for r in range(nseq):
            q_len = cu[r + 1] - cu[r]
            nq = -(-q_len // qb)
            nsmall = 1 if nq > 0 and q_len - (nq - 1) * qb <= small else 0
            n = nq - nsmall if pass_ == 0 else nsmall * nsl
            if b < n:
                return (r, b, 0) if pass_ == 0 else (r, nq - 1, b)
            b -= n
    return (-1, b, 0)


@pytest.mark.parametrize("tensor_cores", [True, False])
@pytest.mark.parametrize("G", [1, 4, 8, 32])
def test_prefill_slots_cover_every_q_block_and_padding_token(G, tensor_cores):
    """``prefill_slots`` sized from the shapes alone: over random ragged
    batches, the device's slot walk gives every full q-block one slot and
    every small one a slot per key slice, and the spare slots' zero ranges
    cover every padding token up to T."""
    rng = np.random.default_rng(G)
    qb, nsl = ROWS // G, SMALL_SLICES if tensor_cores else 1
    for _ in range(60):
        S = int(rng.integers(1, 9))
        T = int(rng.choice([16, 64, 512, 1024]))
        nseq = int(rng.integers(0, S + 1))
        q_lens = [int(x) for x in rng.integers(0, 3 * qb, size=nseq)]
        while sum(q_lens) > T:
            q_lens[int(np.argmax(q_lens))] //= 2
        cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(int).tolist()
        cu += [cu[-1]] * (S + 1 - len(cu))
        slots = [_resolve_slot(b, cu, nseq, G, nsl) for b in range(prefill_slots(T, S, G, tensor_cores))]
        work = [x for x in slots if x[0] >= 0]
        want = []
        for r, n in enumerate(q_lens):
            nq = -(-n // qb)
            for i in range(nq):
                small = i == nq - 1 and (n - i * qb) * G <= SMALL_ROWS
                want += [(r, i, k) for k in range(nsl)] if small else [(r, i, 0)]
        assert sorted(work) == sorted(want)
        zeroed = set()
        for _, k, _ in (x for x in slots if x[0] < 0):
            zeroed.update(range(cu[nseq] + k * qb, cu[nseq] + (k + 1) * qb))
        assert set(range(cu[nseq], T)) <= zeroed


@pytest.mark.parametrize("geom", PREFILL_GEOMETRIES,
                         ids=lambda g: f"S{g[0]}q{'-'.join(map(str, g[7]))}{g[8]}")
def test_prefill_attention_plain_vs_xla(geom):
    D, scale = geom[5], geom[9]
    q, pages, kv_lens, tables, cu, num = _prefill_case(0, *geom)
    sm = D**-0.5
    want = jax.jit(functools.partial(
        jra.ragged_attention, sm_scale=sm, impl="xla", kv_scale=scale,
        prefill_kernel="xla",
    ))(q, pages, kv_lens, tables, cu, num)
    got = prefill_attention_plain(t(q), t(pages), t(kv_lens), t(tables), t(cu),
                                  t(num), sm_scale=sm, kv_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[int(cu[num[0]]):].numpy(), 0.0)


def test_ragged_attention_routes_decode_rows():
    """decode=True takes the decode op with the identity row map."""
    q, pages, kv_lens, tables, num = _decode_case(4, *DECODE_GEOMETRIES[0])
    cu = np.arange(q.shape[0] + 1, dtype=np.int32)
    args = (t(q), t(pages), t(kv_lens), t(tables), t(cu), t(num))
    a = tra.ragged_attention(*args, sm_scale=0.25, decode=True)
    b = tra.ragged_attention(*args, sm_scale=0.25, decode=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("kls,qls,dtype,scale", [
    ([11, 5, 20, 7, 9], [3, 1, 1, 4, 1], "f32", None),
    ([11, 5, 20, 7, 9], [3, 1, 1, 4, 1], "int8", 0.05),
    ([5, 9, 13, 2], [1, 1, 1, 1], "int8", 0.05),
    ([11, 20, 7], [3, 3, 3], "f32", None),
], ids=["mixed-f32", "mixed-int8", "all-single-int8", "no-single-f32"])
def test_ragged_attention_takes_single_token_rows_through_decode(kls, qls, dtype, scale):
    """A step's single-token rows are computed by the decode op, bit for
    bit, and its other rows by the prefill op, so a decode position's
    output does not depend on the step that carries it; the whole step
    still matches the JAX package's ragged attention."""
    S, PP, ps, KV, G, D = 6, 6, 4, 2, 2, 16
    q, pages, kv_lens, tables, cu, num = _prefill_case(5, S, PP, ps, KV, G, D, kls, qls, dtype,
                                                       scale)
    sm = D**-0.5
    args = (t(q), t(pages), t(kv_lens), t(tables), t(cu), t(num))
    got = tra.ragged_attention(*args, sm_scale=sm, kv_scale=scale)
    pre = prefill_attention_plain(*args, sm_scale=sm, kv_scale=scale)
    starts = t(np.minimum(cu[:-1], q.shape[0] - 1))
    dec = decode_attention_plain(t(q).index_select(0, starts.long()), t(pages), t(kv_lens),
                                 t(tables), t(num), sm_scale=sm, kv_scale=scale)
    for r, (a, b) in enumerate(zip(cu[:len(qls)], cu[1:len(qls) + 1])):
        want = dec[r:r + 1] if b - a == 1 else pre[a:b]
        assert torch.equal(got[a:b], want), r
    np.testing.assert_array_equal(got[int(cu[len(qls)]):].numpy(), 0.0)
    ref = jax.jit(functools.partial(
        jra.ragged_attention, sm_scale=sm, impl="xla", kv_scale=scale, prefill_kernel="xla",
    ))(q, pages, kv_lens, tables, cu, num)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------------------- sampling


def test_sample_tokens_greedy_penalties_mask_logprobs():
    rng = np.random.default_rng(5)
    B, V = 6, 300
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int16)
    fpen = np.asarray([0.0, 0.5, 0.0, 1.0, 0.2, 0.0], np.float32)
    ppen = np.asarray([0.0, 0.0, 0.7, 0.3, 0.0, 0.0], np.float32)
    W = (V + 31) // 32
    words = np.full((B, W), 0xFFFFFFFF, np.uint32)
    words[2] = rng.integers(0, 2**32, size=W, dtype=np.uint64).astype(np.uint32)
    words[4, :5] = 0  # first 160 tokens inadmissible
    seeds = np.arange(B, dtype=np.uint32)
    steps = np.zeros(B, np.int32)
    temp = np.zeros(B, np.float32)
    topk = np.zeros(B, np.int32)
    topp = np.ones(B, np.float32)
    want = jsamp.sample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(steps),
        jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp),
        jnp.asarray(fpen), jnp.asarray(ppen), jnp.asarray(counts),
        jnp.asarray(True), jnp.asarray(words), jnp.asarray(True),
    )
    samp = tsamp.SamplingParams.from_numpy(
        CPU, seeds, steps, temp, topk, topp, fpen, ppen, t(counts), True,
        mask_words=words,
    )
    assert samp.any_penalty and samp.any_mask and not samp.any_sampled
    got = tsamp.sample_tokens(t(logits), samp)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob.numpy(), np.asarray(want.logprob), **TOL)
    np.testing.assert_array_equal(got.top_ids.numpy(), np.asarray(want.top_ids))
    np.testing.assert_allclose(got.top_logprobs.numpy(), np.asarray(want.top_logprobs), **TOL)


def test_seeded_sampling_is_per_seed_step_and_row_independent():
    rng = np.random.default_rng(6)
    V = 64
    logits = rng.standard_normal((1, V)).astype(np.float32)

    def draw(rows, seed, step, row, **kw):
        seeds = np.full(rows, 99, np.uint32)
        steps = np.zeros(rows, np.int32)
        seeds[row], steps[row] = seed, step
        lg = np.repeat(logits, rows, axis=0)
        samp = tsamp.SamplingParams.from_numpy(
            CPU, seeds, steps, np.full(rows, 0.8, np.float32),
            np.full(rows, kw.get("top_k", 0), np.int32),
            np.full(rows, kw.get("top_p", 1.0), np.float32),
            np.zeros(rows, np.float32), np.zeros(rows, np.float32),
            torch.zeros((rows, V), dtype=torch.int16), False,
        )
        return int(tsamp.sample_tokens(t(lg), samp).tokens[row])

    a = [draw(1, 7, s, 0) for s in range(16)]
    assert a == [draw(5, 7, s, 3) for s in range(16)]  # row independent
    assert len(set(a)) > 1  # the stream moves with the step
    assert a != [draw(1, 8, s, 0) for s in range(16)]  # and with the seed
    top = draw(1, 7, 0, 0, top_k=1)
    assert top == int(np.argmax(logits))  # top-k 1 is greedy


# ------------------------------------------------- package and device rules


def test_package_imports_no_jax_and_no_module_level_triton():
    root = pathlib.Path(__file__).resolve().parent.parent
    files = list((root / "dynamo_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    # The modules each slice adds are in the scan (the bulk plane, the
    # whole health watchdog, the planner, the auxiliary services, the SDK,
    # its example graph, the deployment tooling, the parallel package, the
    # step plane, ring attention and the port's own tools among them).  The
    # repo's ``tools/`` (the JAX package's) is as foreign as ``dynamo_tpu``.
    planner = ("signals", "policy", "pmetrics", "actuate", "autopilot", "sim", "service",
               "supervisor", "__init__", "__main__")
    sdk = ("__init__", "service", "graph", "config", "allocator", "worker_main", "runner")
    deploy = ("__init__", "renderer", "controller", "model_cache", "api_store")
    for module in ("runtime/transports/bulk.py", "runtime/health.py",
                   "llm/kv_router/pull.py", "llm/migration/worker.py", "llm/trace_service.py",
                   "llm/metrics_service.py", "llm/billing.py", "runtime/recorder.py",
                   "llm/kv_router/recorder.py", "runtime/logging_config.py",
                   *(f"planner/{m}.py" for m in planner),
                   "models/loader.py", "models/gguf.py", "models/hub.py", "llm/sp.py",
                   "llm/tenancy/__init__.py", "llm/tenancy/lora.py", "native.py",
                   *(f"sdk/{m}.py" for m in sdk), *(f"deploy/{m}.py" for m in deploy),
                   "examples/__init__.py", "examples/llm/__init__.py",
                   "examples/llm/components.py", "examples/llm/graphs.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
                   "engine/multihost.py", "engine/ranks.py", "ops/ring_attention.py",
                   "tools/__init__.py", "tools/tune_decode.py", "llm/hf_tokenizer.py",
                   "llm/chat_template.py", "tools/synth_tokenizer.py"):
        assert root / "dynamo_tpu_torch" / module in files, module
    # Packages the card's machine does not have: the port serves without
    # them (tokens.py computes XXH64 itself where xxhash is missing; the
    # disk tier names bf16/fp8 by string, never through ml_dtypes; the
    # service plane's codec writes msgpack itself; the loader reads and
    # writes safetensors itself and never downloads).
    absent = {"aiohttp", "pydantic", "prometheus_client", "jinja2", "tokenizers", "xxhash",
              "ml_dtypes", "msgpack", "safetensors", "huggingface_hub"}
    allowed = {("tokens.py", "xxhash")}
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "dynamo_tpu", "tools"):
                    bad.append(f"{path.name}: {name}")
                if top in absent and (path.name, top) not in allowed:
                    bad.append(f"{path.name}: {name} (not on the card's machine)")
        for node in tree.body:  # module level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                if any(m.split(".")[0] == "triton" for m in mods):
                    bad.append(f"{path.name}: module-level triton import")
    assert not bad, bad


def test_default_device_needs_cuda_unless_cpu_is_explicit(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        default_device()
    with pytest.raises(RuntimeError):
        default_device("cuda")
    assert default_device("cpu") == CPU


def test_kernel_routes_follow_the_device():
    """The tensors' device is the single switch: no engine setting names a
    kernel, and an engine reports the route of its device."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    assert tra.kernel_route(CPU) == "plain"
    assert tra.kernel_route(torch.device("cuda", 0)) == "cuda"
    assert not hasattr(tra, "resolve_kernel") and not hasattr(tra, "ATTENTION_KERNELS")
    fields = EngineConfig.__dataclass_fields__
    assert "decode_kernel" not in fields and "prefill_kernel" not in fields
    with pytest.raises(TypeError):
        EngineConfig(model="debug-tiny", decode_kernel="cuda")
    engine = TorchEngine(EngineConfig(model="debug-tiny", dtype="float32", num_blocks=16,
                                      max_batch=2, max_model_len=32), device="cpu")
    summary = engine.dispatch_summary()
    engine.programs.close()
    assert summary["decode_kernel"] == summary["prefill_kernel"] == "plain"
