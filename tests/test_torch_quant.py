"""W8A8 int8 weights and calibrated int8 KV pages: the port against the JAX
package on the same numpy inputs (debug-tiny, CPU).

Tolerances, with their reasons:

- ``quantize_rows``, ``quantize_array_np``, ``quantize_params``,
  ``dequantize_params``, ``fuse_projections``: bit-exact (the same f32
  division, round-half-to-even and clip in both);
- ``qdot``: int32 accumulators exact, outputs at rtol 1e-6 (the f32 rescale
  of equal accumulators);
- W8A8 ``forward_ragged`` logits: 1e-3 of the largest |logit| (a tie in a
  row's max can flip one activation code; the rest is f32 summation order);
- calibrated KV scales: rtol 1e-2 (both probes write bf16 pages, where one
  ulp is 0.4 %);
- engines: identical greedy streams; the int8-KV accuracy bars of
  ``tests/test_quantized_kv.py`` (top-1 agreement >= 0.9, mean chosen-token
  logprob drift < 0.2) and the quality gate of
  ``tests/test_weight_quant.py`` (mean KL < 0.05, decisive top-1 agree).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops import quant_matmul as tqm
from dynamo_tpu_torch.runtime.engine import Context, collect
from test_torch_engine import CFG, MAX_TOKENS, _jax_params, _serve
from test_torch_model import NUM_PAGES, PS, _jax_tree, _steps

# dynamo_tpu.models / .ops re-export names over their submodules.
jl = importlib.import_module("dynamo_tpu.models.llama")
jq = importlib.import_module("dynamo_tpu.models.quant")
jqm = importlib.import_module("dynamo_tpu.ops.quant_matmul")

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def _np(x):
    """A torch or JAX array as numpy (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _activations(shape, seed=0):
    """Rows with the awkward cases: a zero row, exact ties at ±amax, and
    values that land on .5 code boundaries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    if len(rows) > 1:
        rows[1, :3] = [2.0, -2.0, 1.0]  # 1.0 / (2/127) = 63.5: a tie
    return x


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_exact(dtype):
    x = _activations((2, 9, 64))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jcodes, jscale = jax.jit(jqm.quantize_rows)(jx)
    tcodes, tscale = tqm.quantize_rows(tx)
    assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    assert tscale.reshape(-1)[0] == np.float32(1e-9)  # the zero row's floor
    assert not tcodes.reshape(-1, 64)[0].any()


@pytest.mark.parametrize("lead,col_major", [((16,), False), ((3, 8), True), ((1,), True)],
                         ids=["2d", "3d-col-major", "one-row-col-major"])
def test_qdot_matches_jax(lead, col_major):
    K, N = 64, 48
    x = _activations((*lead, K), seed=1)
    w = np.random.default_rng(2).standard_normal((K, N)).astype(np.float32) * 0.1
    wq, ws = tq.quantize_array_np(w, 0)
    tw = torch.from_numpy(wq)
    if col_major:
        tw = tq.operand_layout(tw)
        assert tw.stride() == (1, K)
    # int32 accumulators: exact.
    jcodes, _ = jqm.quantize_rows(jnp.asarray(x))
    jacc = jax.lax.dot_general(jcodes.reshape(-1, K), jnp.asarray(wq), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tcodes, _ = tqm.quantize_rows(torch.from_numpy(x))
    tacc = tqm.int_mm(tcodes.reshape(-1, K), tw)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    got = tqm.qdot(torch.from_numpy(x), tw, torch.from_numpy(ws))
    want = jax.jit(jqm.qdot)(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws))
    assert got.shape == (*lead, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # Zero rows stay exactly zero (scale floor, no NaN).
    z = tqm.qdot(torch.zeros((2, K)), tw, torch.from_numpy(ws))
    assert not z.abs().max()


def test_qdot_parts_are_profiler_ranges():
    """Each ``qdot`` call opens its three parts (quantize, int8 GEMM,
    rescale) as profiler ranges, the rows engine/profile_step.py reports;
    the ranges leave the result as it was."""
    K, N = 64, 48
    x = torch.from_numpy(_activations((5, K), seed=3))
    wq, ws = tq.quantize_array_np(np.random.default_rng(4).standard_normal((K, N)).astype(
        np.float32) * 0.1, 0)
    tw, tws = tq.operand_layout(torch.from_numpy(wq)), torch.from_numpy(ws)
    plain = tqm.qdot(x, tw, tws)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            got = tqm.qdot(x, tw, tws)
    names = [e.name for e in prof.events()]
    assert [names.count(p) for p in tqm.QDOT_PARTS] == [2, 2, 2]
    assert torch.equal(got, plain)


def test_cuda_gemm_rows_pad_and_refuse():
    """The rows cuBLASLt's int8 GEMM is given on CUDA: more than 16 and a
    multiple of 8 (zero rows padded); a K or N off the 8-grid raises before
    any launch."""
    assert tqm.cuda_gemm_rows(16, 4096, 6144) == 24
    assert tqm.cuda_gemm_rows(1, 4096, 128256) == 24
    assert tqm.cuda_gemm_rows(24, 14336, 4096) == 24
    assert tqm.cuda_gemm_rows(256, 4096, 28672) == 256
    assert tqm.cuda_gemm_rows(2048, 4096, 4096) == 2048
    with pytest.raises(ValueError, match="multiples of 8"):
        tqm.cuda_gemm_rows(32, 60, 48)


# --------------------------------------------------------------- trees


@pytest.mark.parametrize("case", ["random", "adversarial"])
def test_quantize_array_np_matches_jax_and_never_wraps(case):
    """The ±127 no-wrap case of tests/test_weight_quant.py: exact ±amax
    entries and values rounding to 127.0000x must clip, not wrap."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 64)).astype(np.float32)
    if case == "adversarial":
        w[:, 0] = np.abs(w[:, 0].max()) * 3.0
        w[0, :] = -np.abs(w).max(axis=0)
        w[1, :] = np.abs(w).max(axis=0) * (1 - 1e-7)
    for axis in (0, 1):
        q, s = tq.quantize_array_np(w, axis)
        jqv, jsv = jq.quantize_array_np(w, axis)
        np.testing.assert_array_equal(q, jqv)
        np.testing.assert_array_equal(s, jsv)
        tqv, tsv = tq._quantize(torch.from_numpy(w), axis)
        np.testing.assert_array_equal(tqv.numpy(), q)
        np.testing.assert_array_equal(tsv.numpy(), s)
        assert q.min() >= -127 and q.max() <= 127
        deq = q.astype(np.float32) * np.expand_dims(s, axis)
        nz = q != 0
        assert (np.sign(deq[nz]) == np.sign(w[nz])).all()  # no wrap flips a sign


def _torch_tree(tree):
    return tl.params_from_jax(tree, device="cpu")


def _assert_trees_equal(ttree, jtree):
    jtree = jax.tree_util.tree_map(np.asarray, jtree)
    assert set(ttree) == set(jtree)
    assert set(ttree["layers"]) == set(jtree["layers"])
    for name, leaf in ttree.items():
        if name != "layers":
            assert str(leaf.dtype).split(".")[-1] == jtree[name].dtype.name, name
            np.testing.assert_array_equal(_np(leaf), _np(jtree[name]), err_msg=name)
    for name, leaf in ttree["layers"].items():
        assert str(leaf.dtype).split(".")[-1] == jtree["layers"][name].dtype.name, name
        np.testing.assert_array_equal(_np(leaf), _np(jtree["layers"][name]), err_msg=name)


def _float_tree():
    return _jax_tree(fused=False)[1]


@pytest.mark.parametrize("order", ["quantize", "quantize-then-fuse", "fuse-then-quantize",
                                   "fuse-float", "fuse-quantized-jax-tree"])
def test_quantize_dequantize_fuse_bit_exact(order):
    """quantize_params, dequantize_params, fuse_projections and
    is_quantized: the port's leaves equal the JAX package's, in the fused
    and unfused layouts, quantized and not; int8 weights stored
    column-major."""
    jp = _float_tree()
    tp = _torch_tree(jax.tree_util.tree_map(np.asarray, jp))
    if order == "quantize":
        jout, tout = jq.quantize_params(jp), tq.quantize_params(tp)
    elif order == "quantize-then-fuse":
        jout = jq.fuse_projections(jq.quantize_params(jp))
        tout = tq.fuse_projections(tq.quantize_params(tp))
    elif order == "fuse-then-quantize":
        jout = jq.quantize_params(jq.fuse_projections(jp))
        tout = tq.quantize_params(tq.fuse_projections(tp))
    elif order == "fuse-float":
        jout, tout = jq.fuse_projections(jp), tq.fuse_projections(tp)
    else:  # a quantized JAX tree converted, then fused on the port's side
        jq_tree = jq.quantize_params(jp)
        jout = jq.fuse_projections(jq_tree)
        tout = tq.fuse_projections(_torch_tree(jax.tree_util.tree_map(np.asarray, jq_tree)))
    _assert_trees_equal(tout, jout)
    quantized = order != "fuse-float"
    assert tq.is_quantized(tout) == jq.is_quantized(jout) == quantized
    if quantized:
        assert tq.quantize_params(tout) is tout  # a no-op on a quantized tree
    for name, leaf in tout["layers"].items():
        if leaf.dtype == torch.int8:
            assert leaf[0].stride() == (1, leaf.shape[1]), name  # column-major
    if quantized:
        for dt in ("float32", "bfloat16"):
            _assert_trees_equal(tq.dequantize_params(tout, getattr(torch, dt)),
                                jq.dequantize_params(jout, dt))


def test_quantize_params_leaves_lora_alone():
    tp = _torch_tree(jax.tree_util.tree_map(np.asarray, _float_tree()))
    lora = torch.ones((2, 3, 4))
    tp["layers"]["lora_a_q"] = lora
    out = tq.quantize_params(tp)
    assert out["layers"]["lora_a_q"] is lora and "lora_a_q_scale" not in out["layers"]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_params_from_jax_takes_scale_leaves(fused):
    jtree = jq.quantize_params(_float_tree())
    if fused:
        jtree = jq.fuse_projections(jtree)
    jtree = jax.tree_util.tree_map(np.asarray, jtree)
    ttree = tl.params_from_jax(jtree, device="cpu")
    _assert_trees_equal(ttree, jtree)
    assert ttree["embed"].is_contiguous()  # gathered by rows
    w = ttree["layers"]["wqkv" if fused else "wq"]
    assert w[0].stride() == (1, w.shape[1])


def test_init_params_quantized_is_seeded_int8():
    cfg = get_config("debug-tiny").with_overrides(dtype="float32")
    a = tq.init_params_quantized(cfg, seed=3, device="cpu")
    b = tq.init_params_quantized(cfg, seed=3, device="cpu")
    c = tq.init_params_quantized(cfg, seed=4, device="cpu")
    jtree = jq.init_params_quantized(cfg, jax.random.PRNGKey(0))
    assert set(a) == set(jtree) and set(a["layers"]) == set(jtree["layers"])
    for name, leaf in a["layers"].items():
        j = jtree["layers"][name]
        assert leaf.shape == j.shape and str(leaf.dtype).split(".")[-1] == j.dtype.name, name
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    w = a["layers"]["w_up"]
    assert w.min() >= -127 and w.max() <= 127 and w[0].stride() == (1, w.shape[1])
    assert torch.all(a["layers"]["w_up_scale"] == float(np.float32(0.02 / 73.0)))
    assert tq.is_quantized(a)


# --------------------------------------------------------------- model


@pytest.mark.parametrize("cache_dtype,kv_scale", [("float32", None), ("int8", [0.05, 0.08])],
                         ids=["f32-kv", "int8-kv"])
def test_w8a8_forward_ragged_matches_jax(cache_dtype, kv_scale):
    jcfg, tree = _jax_tree(fused=True)
    jtree = jax.tree_util.tree_map(np.asarray, jq.quantize_params(tree))
    tcfg = get_config("debug-tiny").with_overrides(dtype="float32")
    params = tl.params_from_jax(jtree, device="cpu")
    jdt = jnp.int8 if cache_dtype == "int8" else jnp.float32
    jcache = jl.PagedKVCache.create(jcfg, NUM_PAGES, PS, dtype=jdt)
    tcache = tl.PagedKVCache.create(tcfg, NUM_PAGES, PS, tl.torch_dtype(cache_dtype), CPU)
    jscale = None if kv_scale is None else jnp.asarray(kv_scale, jnp.float32)
    for fields, decode in _steps():
        jlog, jcache = jax.jit(
            lambda p, c, rb: jl.forward_ragged(p, jcfg, rb, c, attn_impl="xla",
                                               kv_scale=jscale, decode=decode)
        )(jtree, jcache, jl.RaggedBatch(**{k: jnp.asarray(v) for k, v in fields.items()}))
        trb = tl.RaggedBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
        with torch.inference_mode():
            tlog = tl.forward_ragged(params, tcfg, trb, tcache, kv_scale=kv_scale, decode=decode)
        n = int(fields["num_seqs"][0])
        want = np.asarray(jlog)[:n]
        assert np.abs(tlog[:n].numpy() - want).max() <= 1e-3 * np.abs(want).max()


def _tiny_logits(params, cfg, prompt):
    """One prefill step over ``prompt``: the last token's f32 logits."""
    T = len(prompt)
    nb = (T + PS - 1) // PS + 1
    cache = tl.PagedKVCache.create(cfg, nb, PS, torch.float32, CPU)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    rb = tl.RaggedBatch(
        token_ids=torch.tensor(prompt), positions=torch.arange(T, dtype=torch.int32),
        slot_mapping=torch.arange(T, dtype=torch.int32), kv_lens=i32([T]),
        page_indices=torch.arange(nb, dtype=torch.int32)[None], cu_q_lens=i32([0, T]),
        num_seqs=i32([1]),
    )
    with torch.inference_mode():
        return tl.forward_ragged(params, cfg, rb, cache)[0].numpy()


def test_w8a8_quality_gate_against_dequantized_tree():
    """tests/test_weight_quant.py's gate on the port: the int8 execution
    against an exact dequantized forward of the same weights."""
    cfg = get_config("debug-tiny").with_overrides(dtype="float32")
    qp = tq.quantize_params(tl.init_params(cfg, seed=11, device="cpu"))
    deq = tq.dequantize_params(qp)
    rng = np.random.default_rng(5)
    kls, agree, decisive = [], 0, 0
    for _ in range(8):
        prompt = rng.integers(0, cfg.vocab_size, size=12).tolist()
        lq, lr = _tiny_logits(qp, cfg, prompt), _tiny_logits(deq, cfg, prompt)
        pq = np.exp(lq - lq.max())
        pq /= pq.sum()
        pr = np.exp(lr - lr.max())
        pr /= pr.sum()
        kls.append(float(np.sum(pr * (np.log(pr + 1e-12) - np.log(pq + 1e-12)))))
        top2 = np.partition(lr, -2)[-2:]
        if top2[1] - top2[0] > 3 * np.abs(lq - lr).max():
            decisive += 1
            agree += int(np.argmax(lq) == np.argmax(lr))
    assert np.mean(kls) < 0.05, kls
    assert agree == decisive


# --------------------------------------------------------------- engine


@pytest.mark.parametrize("weight_quant", [None, "int8"])
def test_calibrated_kv_scales_match_tpu_engine(weight_quant):
    cfg = dict(CFG, weight_quant=weight_quant, cache_dtype="int8", kv_scale="auto")
    params = _jax_params()
    jeng = TpuEngine(JaxEngineConfig(**cfg), params=params)
    teng = TorchEngine(EngineConfig(**cfg), device="cpu",
                       params=tl.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                 device="cpu"))
    assert isinstance(teng.kv_scale, np.ndarray) and teng.kv_scale.shape == (2,)
    assert (teng.kv_scale > 0).all()
    np.testing.assert_allclose(teng.kv_scale, jeng.kv_scale, rtol=1e-2)
    assert teng.calibration_s > 0
    assert sum(teng.compile_counts().values()) == 0  # calibration captured nothing


def test_calibration_refuses_once_a_program_exists():
    eng = TorchEngine(EngineConfig(**dict(CFG, cache_dtype="int8", kv_scale="auto")),
                      device="cpu")
    eng.warmup()
    with pytest.raises(RuntimeError, match="before any device program"):
        eng._calibrate_kv_scales()


async def test_w8a8_int8_kv_auto_streams_match_tpu_engine():
    cfg = dict(CFG, weight_quant="int8", cache_dtype="int8", kv_scale="auto")
    params = jq.quantize_params(_jax_params())
    want = await _serve(TpuEngine(JaxEngineConfig(**cfg), params=params))
    tree = jax.tree_util.tree_map(np.asarray, params)
    engine = TorchEngine(EngineConfig(**cfg), params=tl.params_from_jax(tree, device="cpu"),
                         device="cpu")
    got = await _serve(engine)
    assert [len(t) for t, _ in got] == MAX_TOKENS
    assert got == want
    assert engine.params["layers"]["wqkv"].dtype == torch.int8  # quantized and fused


async def test_w8a8_engine_from_float_params_quantizes_like_jax():
    """weight_quant on a float tree: both engines quantize it themselves."""
    cfg = dict(CFG, weight_quant="int8")
    params = _jax_params()
    want = await _serve(TpuEngine(JaxEngineConfig(**cfg), params=params))
    tree = jax.tree_util.tree_map(np.asarray, params)
    got = await _serve(TorchEngine(EngineConfig(**cfg),
                                   params=tl.params_from_jax(tree, device="cpu"), device="cpu"))
    assert got == want


KV_CFG = dict(model="debug-tiny", block_size=4, num_blocks=128, max_batch=4,
              max_model_len=128, prefill_chunk=32, dtype="float32", seed=7)
KV_PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6], list(range(20, 44)), [100, 101]]


async def _greedy_with_logprobs(engine, prompt, n=12):
    req = PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0, logprobs=0),
    ).to_dict()
    out = await collect(await engine.generate(Context(req)))
    toks = [t for it in out for t in it.get("token_ids", ())]
    lps = [it["logprobs"]["logprob"] for it in out if it.get("logprobs")]
    return toks, lps


async def _kv_accuracy(make, weight_quant, params):
    """Greedy agreement and mean chosen-token logprob drift of int8 pages
    under calibrated scales against f32 pages, the same weights."""
    ref = make(EngineConfig(**KV_CFG, weight_quant=weight_quant), params)
    q8 = make(EngineConfig(**KV_CFG, weight_quant=weight_quant, cache_dtype="int8",
                           kv_scale="auto"), params)
    agree = total = 0
    deltas = []
    try:
        for p in KV_PROMPTS:
            t_ref, lp_ref = await _greedy_with_logprobs(ref, p)
            t_q8, lp_q8 = await _greedy_with_logprobs(q8, p)
            n = min(len(t_ref), len(t_q8))
            agree += sum(a == b for a, b in zip(t_ref[:n], t_q8[:n]))
            total += n
            deltas.extend(abs(a - b) for a, b in zip(lp_ref[:n], lp_q8[:n]))
    finally:
        await ref.close()
        await q8.close()
    return agree, total, float(np.mean(deltas))


@pytest.mark.parametrize("weight_quant", [None, "int8"])
async def test_int8_kv_auto_accuracy(weight_quant):
    """tests/test_quantized_kv.py's measurement on both engines, the same
    N(0, 0.02) weights (that test's seed).  With float weights the port
    meets that test's bars (top-1 agreement >= 0.9, drift < 0.2).  Under
    W8A8 the JAX engine itself keeps only 35 of the 48 greedy tokens on
    debug-tiny (one early flip diverges the rest of a stream; drift 0.02),
    so there the bar is the JAX engine's own numbers: equal agreement, and
    drift within 1e-3 of its drift and below 0.2."""
    import dynamo_tpu.engine as jeng
    from dynamo_tpu.models.config import get_config as jget

    jparams = jl.init_params(jget("debug-tiny").with_overrides(dtype="float32"),
                             jax.random.PRNGKey(7))
    tree = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = await _kv_accuracy(lambda c, p: TorchEngine(c, params=p, device="cpu"),
                             weight_quant, tree)
    want = await _kv_accuracy(
        lambda c, p: TpuEngine(jeng.EngineConfig(**{k: getattr(c, k) for k in (
            *KV_CFG, "weight_quant", "cache_dtype", "kv_scale")}), params=p),
        weight_quant, jparams)
    agree, total, drift = got
    assert drift < 0.2, f"logprob drift {drift}"
    if weight_quant is None:
        assert agree / total >= 0.9, f"top-1 agreement {agree}/{total}"
    assert agree == want[0], (got, want)
    assert abs(drift - want[2]) < 1e-3, (got, want)


def test_engine_config_quant_knobs():
    with pytest.raises(ValueError, match="weight_quant"):
        EngineConfig(weight_quant="int4")
    with pytest.raises(ValueError, match="kv_scale"):
        EngineConfig(cache_dtype="int8", kv_scale="calibrate")
    c = EngineConfig(weight_quant="int8", cache_dtype="int8", kv_scale="auto")
    assert c.fuse_projections


async def test_engine_draws_int8_weights_without_params():
    """No params + weight_quant: init_params_quantized, fused, serving."""
    eng = TorchEngine(EngineConfig(**dict(CFG, weight_quant="int8", fuse_projections=False)),
                      device="cpu")
    assert "wq" in eng.params["layers"] and eng.params["layers"]["wq"].dtype == torch.int8
    got = await _serve(eng)
    assert [len(t) for t, _ in got] == MAX_TOKENS
    eng2 = TorchEngine(EngineConfig(**dict(CFG, weight_quant="int8")), device="cpu")
    assert "wqkv_scale" in eng2.params["layers"]
    assert await _serve(eng2) == got  # fusing changes no token
