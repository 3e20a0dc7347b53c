"""Mixture-of-experts on the port against the JAX package.

The same inputs, drawn from numpy seeds or the JAX ``init_params`` tree
(converted with ``params_from_jax``), go through both packages:
``moe_mlp`` in f32 (tolerance 2e-5) and under W8A8 (1e-5); the batched
int8 product's int32 accumulators (exact); ``forward_ragged`` on
``debug-tiny-moe`` against the dense oracle of tests/test_ragged_forward.py
(1e-4) and against the JAX forward (1e-4); the int8 trees of
``quantize_params``, the loader and ``init_params_quantized`` (bit for
bit, or shapes for the random draws, which are each package's own); MoE
checkpoints written by either package and loaded by the other (bit for
bit, float and int8); and ``TorchEngine`` against ``TpuEngine`` greedy
streams in f32 and under W8A8 (identical).  Then the CLI serves
``--arch debug-tiny-moe`` and resolves a Mixtral-layout ``--checkpoint``.
"""

import asyncio
import importlib
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models import moe as tmoe
from dynamo_tpu_torch.models import quant as tquant
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.llama import (
    PagedKVCache, RaggedBatch, forward_ragged, init_params, params_from_jax,
)
from dynamo_tpu_torch.ops import quant_matmul as tqm
from test_ragged_forward import _reference_logits

# dynamo_tpu.models / dynamo_tpu.ops re-export names over their submodules.
jllama = importlib.import_module("dynamo_tpu.models.llama")
jloader = importlib.import_module("dynamo_tpu.models.loader")
jmoe = importlib.import_module("dynamo_tpu.models.moe")
jquant = importlib.import_module("dynamo_tpu.models.quant")
jqm = importlib.import_module("dynamo_tpu.ops.quant_matmul")

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(model="debug-tiny-moe"):
    return (jax_get_config(model).with_overrides(dtype="float32"),
            get_config(model).with_overrides(dtype="float32"))


_TREES = {}


def _jax_tree(model="debug-tiny-moe"):
    """The JAX ``init_params`` tree (seed 0, f32), built once a model."""
    if model not in _TREES:
        _TREES[model] = jllama.init_params(_cfgs(model)[0], jax.random.PRNGKey(0))
    return _TREES[model]


def _layer(tree, l=0):
    return {k: np.asarray(v[l]) for k, v in tree["layers"].items()}


def _t(lp):
    return {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}


# ---------------------------------------------------------------- moe_mlp


@pytest.mark.parametrize("routing", ["random", "skewed"])
@pytest.mark.parametrize("T", [1, 5, 16, 33])
def test_moe_mlp_matches_jax_f32(T, routing):
    """``moe_mlp`` on the same layer and tokens: f32, tolerance 2e-5 (the
    experts' products sum in a different order).  ``skewed`` scales the
    router's first two columns up so that every token picks experts 0 and
    1: their queues fill to T, which the dropless layout must hold."""
    jcfg, tcfg = _cfgs()
    for l in range(jcfg.num_layers):
        lp = _layer(_jax_tree(), l)
        x = np.random.default_rng(T * 10 + l).standard_normal((T, jcfg.hidden_size))
        x = x.astype(np.float32)
        if routing == "skewed":
            lp["router"] = lp["router"].copy()
            lp["router"][:, :2] = np.abs(lp["router"][:, :2]) * 1e3
            x = np.abs(x)
            assert set(np.argsort(x @ lp["router"], axis=-1)[:, -2:].ravel()) == {0, 1}
        want = np.asarray(jax.jit(
            lambda x, lp: jmoe.moe_mlp(x[None], lp, jcfg)[0])(x, lp))
        got = tmoe.moe_mlp(torch.from_numpy(x), _t(lp), tcfg).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("T", [3, 24])
def test_moe_mlp_matches_jax_w8a8(T):
    """Quantized experts (each package quantizing the same float tree, the
    int8 leaves and scales bit for bit equal): outputs within 1e-5."""
    jcfg, tcfg = _cfgs()
    jq = jquant.quantize_params(_jax_tree())
    tq = tquant.quantize_params(params_from_jax(_np(_jax_tree()), device=CPU))
    for name in ("moe_gate", "moe_up", "moe_down"):
        for leaf in (name, name + "_scale"):
            assert np.array_equal(tq["layers"][leaf].numpy(), np.asarray(jq["layers"][leaf]))
    assert tq["layers"]["router"].dtype == torch.float32  # the router stays float
    x = np.random.default_rng(T).standard_normal((T, jcfg.hidden_size)).astype(np.float32)
    jlp = {k: v[1] for k, v in jq["layers"].items()}
    want = np.asarray(jax.jit(lambda x, lp: jmoe.moe_mlp(x[None], lp, jcfg)[0])(x, jlp))
    got = tmoe.moe_mlp(torch.from_numpy(x), {k: v[1] for k, v in tq["layers"].items()},
                       tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_moe_mlp_refuses_top3_on_cuda_only():
    """The combine's atomics sum two terms exactly in any order; the CUDA
    path refuses K > 2 (the CPU path serves it)."""
    _, tcfg = _cfgs()
    cfg3 = tcfg.with_overrides(num_experts_per_token=3)
    lp = _t(_layer(_jax_tree()))
    x = torch.randn(4, tcfg.hidden_size, generator=torch.Generator().manual_seed(0))
    assert tmoe.moe_mlp(x, lp, cfg3).shape == x.shape

    class FakeCuda:
        shape, device = x.shape, torch.device("cuda")

    with pytest.raises(ValueError, match="K <= 2"):
        tmoe.moe_mlp(FakeCuda(), lp, cfg3)


# ------------------------------------------------------- batched products


def _quantized_experts(E, K, N, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
    s = np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    wq = np.clip(np.rint(w / s[:, None, :]), -127, 127).astype(np.int8)
    return wq, s


@pytest.mark.parametrize("C", [1, 8, 33])
def test_qdot_batched_accumulators_exact(C):
    """The int32 accumulators of one int8 product per expert equal the JAX
    package's batched ``dot_general`` exactly; the row quantization is bit
    for bit; the rescaled output agrees to f32 rounding (1e-6)."""
    E, K, N = 4, 64, 48
    x = np.random.default_rng(C).standard_normal((E, C, K)).astype(np.float32)
    wq, s = _quantized_experts(E, K, N, C + 1)
    jxq, jax_ = jax.jit(jqm.quantize_rows)(x)
    jacc = np.asarray(jax.lax.dot_general(jxq, jnp.asarray(wq), (((2,), (1,)), ((0,), (0,))),
                                          preferred_element_type=jnp.int32))
    xq, ax = tqm.quantize_rows(torch.from_numpy(x))
    assert np.array_equal(xq.numpy(), np.asarray(jxq))
    assert np.array_equal(ax.numpy(), np.asarray(jax_))
    w_t = tquant.operand_layout(torch.from_numpy(wq))
    acc = torch.stack([tqm.int_mm(xq[e], w_t[e]) for e in range(E)])
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), jacc)
    want = np.asarray(jax.jit(jqm.qdot_batched)(x, wq, s))
    got = tqm.qdot_batched(torch.from_numpy(x), w_t, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pkg", PKGS)
def test_qdot_batched_matches_dequant_matmul(pkg):
    """tests/test_weight_quant.py::test_qdot_matches_dequant_matmul's
    batched (MoE) half on ``pkg``: error bounded by the dynamic activation
    quantization step (1% of the largest output)."""
    xe = np.random.default_rng(0).standard_normal((4, 8, 64)).astype(np.float32)
    wq, s = _quantized_experts(4, 64, 32, 2)
    want = np.einsum("ecd,edf->ecf", xe, wq.astype(np.float32) * s[:, None, :])
    if pkg == JAX:
        got = np.asarray(jqm.qdot_batched(xe, wq, s))
    else:
        got = tqm.qdot_batched(torch.from_numpy(xe), torch.from_numpy(wq),
                               torch.from_numpy(s)).numpy()
    assert np.abs(got - want).max() / max(np.abs(want).max(), 1e-6) < 0.01


# ----------------------------------------------------------- the forward


def _ragged_logits(tcfg, params, prompt, S=2, T=8):
    """One prefill step of ``prompt`` through the port's forward_ragged."""
    n = len(prompt)
    cache = PagedKVCache.create(tcfg, 8, 4, torch.float32, CPU)
    tok = np.zeros(T, np.int64)
    tok[:n] = prompt
    pos = np.zeros(T, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(T, -1, np.int32)
    slots[:n] = np.arange(n)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = n
    tables = np.zeros((S, 8), np.int32)
    tables[0] = np.arange(8)
    kv = np.zeros(S, np.int32)
    kv[0] = n
    f = lambda a: torch.from_numpy(a)  # noqa: E731
    rb = RaggedBatch(f(tok), f(pos), f(slots), f(kv), f(tables), f(cu),
                     f(np.asarray([1], np.int32)))
    with torch.inference_mode():
        return forward_ragged(params, tcfg, rb, cache).numpy()


def test_ragged_moe_matches_dense_oracle():
    """tests/test_ragged_forward.py::test_ragged_moe_matches_dense_oracle
    on the port: the paged forward of a 4-token prompt on debug-tiny-moe
    against the JAX dense oracle (full causal attention, JAX moe_mlp), and
    against the JAX forward_ragged, at 1e-4."""
    jcfg, tcfg = _cfgs()
    prompt = [1, 2, 3, 4]
    want = np.asarray(_reference_logits(jcfg, _jax_tree(), prompt))
    got = _ragged_logits(tcfg, params_from_jax(_np(_jax_tree()), device=CPU), prompt)
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)
    assert not np.any(np.isnan(got[0]))


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("model", ["debug-tiny", "debug-tiny-moe"])
def test_quantize_dequantize_roundtrip(pkg, model):
    """tests/test_weight_quant.py::test_quantize_dequantize_roundtrip on
    ``pkg``: |w - dequant(quant(w))| <= scale/2 elementwise, norms and the
    router untouched; the port's int8 tree equals the JAX one bit for
    bit."""
    jcfg = jax_get_config(model)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    if pkg == JAX:
        qp = jquant.quantize_params(params)
        assert jquant.quantize_params(qp) is qp
        deq = _np(jquant.dequantize_params(qp))
        qp = _np(qp)
    else:
        tree = params_from_jax(_np(params), device=CPU)
        tq = tquant.quantize_params(tree)
        assert tquant.is_quantized(tq) and tquant.quantize_params(tq) is tq
        jq = _np(jquant.quantize_params(params))
        for name, leaf in jq["layers"].items():
            got = tq["layers"][name]
            got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
            assert np.array_equal(got, np.asarray(leaf, got.dtype)), name
        deq = {"layers": {k: v.float().numpy() for k, v in
                          tquant.dequantize_params(tq)["layers"].items()}}
        qp = {"layers": {k: (v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy())
                         for k, v in tq["layers"].items()}}
    for name in ("wq", "wo", "moe_down" if jcfg.is_moe else "w_down"):
        w = np.asarray(params["layers"][name], np.float32)
        d = np.asarray(deq["layers"][name], np.float32)
        s = np.asarray(qp["layers"][name + "_scale"], np.float32)
        bound = np.expand_dims(s, 1 if name.startswith("w") and s.ndim == 2 else -2) * 0.51
        assert np.all(np.abs(w - d) <= bound + 1e-9), name
    np.testing.assert_array_equal(np.asarray(qp["layers"]["attn_norm"], np.float32),
                                  np.asarray(params["layers"]["attn_norm"], np.float32))
    if jcfg.is_moe:
        np.testing.assert_array_equal(np.asarray(qp["layers"]["router"], np.float32),
                                      np.asarray(params["layers"]["router"], np.float32))


@pytest.mark.parametrize("pkg", PKGS)
def test_init_params_quantized_structure(pkg):
    """tests/test_weight_quant.py::test_init_params_quantized_structure on
    ``pkg``, MoE included: the direct int8 init has init_params' leaves,
    each with its shape, int8 where it has a scale; the port's shapes equal
    the JAX package's."""
    for model in ("debug-tiny", "debug-tiny-moe"):
        jcfg = jax_get_config(model)
        ref = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        if pkg == JAX:
            qp = jquant.init_params_quantized(jcfg, jax.random.PRNGKey(0))
            int8 = jnp.int8
        else:
            qp = tquant.init_params_quantized(get_config(model), 0, CPU)
            int8 = torch.int8
            jq = jquant.init_params_quantized(jcfg, jax.random.PRNGKey(0))
            assert {k: tuple(v.shape) for k, v in qp["layers"].items()} == \
                {k: tuple(v.shape) for k, v in jq["layers"].items()}
        got = {k for k in qp["layers"] if not k.endswith("_scale")}
        assert got == set(ref["layers"])
        for name, leaf in qp["layers"].items():
            if name.endswith("_scale"):
                continue
            assert tuple(leaf.shape) == tuple(ref["layers"][name].shape), name
            if name + "_scale" in qp["layers"]:
                assert leaf.dtype == int8, name
        assert qp["embed"].dtype == int8


def test_params_from_jax_carries_the_moe_leaves():
    """``params_from_jax`` of a quantized JAX MoE tree: every leaf, the
    int8 experts in the column-major operand layout, values unchanged."""
    jq = _np(jquant.quantize_params(_jax_tree()))
    tree = params_from_jax(jq, device=CPU)
    for name, leaf in jq["layers"].items():
        assert np.array_equal(tree["layers"][name].numpy(), leaf), name
    w = tree["layers"]["moe_gate"]
    assert w.dtype == torch.int8 and w.transpose(-1, -2).is_contiguous()


# ------------------------------------------------------------ checkpoints


def _port_tree():
    return params_from_jax(_np(_jax_tree()), device=CPU)


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX), (PORT, PORT)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_save_load_roundtrip_moe(tmp_path, writer, reader):
    """tests/test_loader.py::test_save_load_roundtrip_moe across packages:
    a debug-tiny-moe tree written by one package's ``save_params_hf`` loads
    in the other's ``load_params`` into the same tree, leaf for leaf."""
    jcfg, tcfg = _cfgs()
    path = str(tmp_path / "ckpt")
    if writer == JAX:
        jloader.save_params_hf(_jax_tree(), path)
    else:
        tloader.save_params_hf(_port_tree(), path, config=tcfg)
    if reader == JAX:
        loaded = {k: v for k, v in _np(jloader.load_params(jcfg, path, dtype=jnp.float32))
                  .items()}
        loaded = params_from_jax(loaded, device=CPU)
    else:
        loaded = tloader.load_params(tcfg, path, device=CPU)
    want = _port_tree()
    assert set(loaded) == set(want) and set(loaded["layers"]) == set(want["layers"])
    for name, leaf in want["layers"].items():
        assert torch.equal(loaded["layers"][name], leaf), name
    for name in ("embed", "final_norm", "lm_head"):
        if name in want:
            assert torch.equal(loaded[name], want[name]), name


@pytest.mark.parametrize("writer", PKGS)
def test_moe_config_rejects_dense_checkpoint(tmp_path, writer):
    """tests/test_loader.py::test_moe_config_rejects_dense_checkpoint
    across packages: a dense checkpoint written by either package is
    refused by both loaders under the MoE config, naming the missing MoE
    tensors."""
    path = str(tmp_path / "dense")
    dense = _jax_tree("debug-tiny")
    if writer == JAX:
        jloader.save_params_hf(dense, path)
    else:
        tloader.save_params_hf(params_from_jax(_np(dense), device=CPU), path)
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError, match="MoE"):
        jloader.load_params(jcfg, path, dtype=jnp.float32)
    with pytest.raises(ValueError, match="is MoE .* missing"):
        tloader.load_params(tcfg, path, device=CPU)


def test_moe_checkpoint_missing_an_expert_is_refused(tmp_path):
    """An expert tensor absent from the grid fails the load naming its
    (layer, expert), as the JAX loader's error does."""
    _, tcfg = _cfgs()
    path = str(tmp_path / "ckpt")
    tloader.save_params_hf(_port_tree(), path)
    f = os.path.join(path, "model.safetensors")
    tensors = {k: v.clone() for k, v in tloader.read_safetensors(f)}
    del tensors["model.layers.1.block_sparse_moe.experts.2.w3.weight"]
    tloader.write_safetensors(f, tensors)
    with pytest.raises(ValueError, match=r"missing moe_up for \(layer, expert\) \[\(1, 2\)\]"):
        tloader.load_params(tcfg, path, device=CPU)


def test_loader_int8_matches_both_quantizers(tmp_path):
    """``quant="int8"`` on a Mixtral-layout checkpoint: each expert tensor
    quantized as it arrives into the [L, E, ...] leaves equals the device
    quantizer on the loaded float tree and the JAX loader's int8 tree, bit
    for bit."""
    jcfg, tcfg = _cfgs()
    path = str(tmp_path / "ckpt")
    tloader.save_params_hf(_port_tree(), path)
    got = tloader.load_params(tcfg, path, quant="int8", device=CPU)
    ref = tquant.quantize_params(tloader.load_params(tcfg, path, device=CPU))
    jref = _np(jloader.load_params(jcfg, path, dtype=jnp.float32, quant="int8"))
    assert set(got["layers"]) == set(ref["layers"]) == set(jref["layers"])
    for name, leaf in ref["layers"].items():
        assert torch.equal(got["layers"][name], leaf), name
        assert np.array_equal(got["layers"][name].numpy(), jref["layers"][name]), name
    assert got["layers"]["moe_down"].transpose(-1, -2).is_contiguous()


# ---------------------------------------------------------------- engines

CFG = dict(model="debug-tiny-moe", block_size=4, num_blocks=256, max_batch=4,
           max_model_len=256, prefill_chunk=32, dtype="float32")
PROMPTS = [
    ([5, 17, 33, 2, 250, 9, 61], 14),
    (list(range(40, 61)), 11),
    ([7, 7, 7, 7, 100, 3, 11, 19, 23, 29, 31, 37, 41], 16),
    ([200, 1, 150], 12),
    ([9, 8, 7, 9, 8, 7, 9, 8, 7, 9, 8, 7], 18),
    (list(range(100, 138)), 9),
]


async def _streams(pkg, over):
    pr = importlib.import_module(f"{pkg}.llm.protocols")
    rt = importlib.import_module(f"{pkg}.runtime.engine")
    cfg = dict(CFG, **over)
    if pkg == JAX:
        engine = TpuEngine(JaxEngineConfig(**cfg), params=_jax_tree())
    else:
        engine = TorchEngine(EngineConfig(**cfg), params=_port_tree(), device="cpu")

    async def one(prompt, n):
        req = pr.PreprocessedRequest(
            token_ids=list(prompt),
            stop_conditions=pr.StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=pr.SamplingOptions(),
        ).to_dict()
        out = await rt.collect(await engine.generate(rt.Context(req)))
        return [t for item in out for t in item["token_ids"]]

    try:
        return await asyncio.gather(*(one(p, n) for p, n in PROMPTS))
    finally:
        await engine.close()


@pytest.mark.parametrize("over", [
    {"decode_steps": 1},
    {"decode_steps": 4},
    {"decode_steps": 4, "weight_quant": "int8"},
], ids=["f32-steps1", "f32-steps4", "w8a8-steps4"])
async def test_moe_streams_match_tpu_engine(over):
    """Six greedy requests at once on a 4-row debug-tiny-moe engine (rows
    join and leave the fused sessions, prefill chunks mix with decode):
    the port's streams equal TpuEngine's on the same weights, in f32 and
    under W8A8 (tolerance: none)."""
    got = {pkg: await _streams(pkg, over) for pkg in PKGS}
    assert [len(s) for s in got[PORT]] == [n for _, n in PROMPTS]
    assert got[PORT] == got[JAX]


async def test_moe_engine_warmup_then_serve_adds_no_program():
    """The MoE step has static shapes: warmup captures its programs, and a
    serve after it reaches none that warmup did not."""
    engine = TorchEngine(EngineConfig(**dict(CFG, decode_steps=4)), params=_port_tree(),
                         device="cpu")
    rt = importlib.import_module(f"{PORT}.runtime.engine")
    pr = importlib.import_module(f"{PORT}.llm.protocols")
    try:
        warm = await engine.run_warmup()
        req = pr.PreprocessedRequest(token_ids=list(range(1, 30)),
                                     stop_conditions=pr.StopConditions(max_tokens=12,
                                                                       ignore_eos=True))
        out = await rt.collect(await engine.generate(rt.Context(req.to_dict())))
        assert sum(len(i["token_ids"]) for i in out) == 12
        assert engine.compile_counts() == warm
        assert "router" in engine.params["layers"] and "wqkv" not in engine.params["layers"]
    finally:
        await engine.close()


# -------------------------------------------------------------------- CLI


def test_checkpoint_resolves_the_moe_architecture(tmp_path):
    """``--checkpoint DIR`` with a Mixtral-layout checkpoint: the engine's
    architecture comes from its ``config.json`` (experts and top-k), and
    its weights are the checkpoint's."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.engine import build_torch_engine

    _, tcfg = _cfgs()
    path = str(tmp_path / "mixtral-tiny")
    tloader.save_params_hf(_port_tree(), path, config=tcfg)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    assert hf["architectures"] == ["MixtralForCausalLM"] and hf["num_local_experts"] == 4
    args = cli.parse_args(["run", "in=http", "out=torch", "--checkpoint", path, "--dtype",
                           "float32", "--device", "cpu", "--num-blocks", "32"])
    engine = build_torch_engine(args)
    try:
        mc = engine.model_config
        assert (mc.is_moe, mc.num_experts, mc.num_experts_per_token) == (True, 4, 2)
        for name, leaf in _port_tree()["layers"].items():
            assert torch.equal(engine.params["layers"][name], leaf), name
    finally:
        asyncio.run(engine.close())


def test_cli_serves_debug_tiny_moe():
    """``run in=http out=torch --arch debug-tiny-moe`` as a user starts it:
    a completion of 6 tokens."""
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "in=http", "out=torch",
         "--arch", "debug-tiny-moe", "--dtype", "float32", "--device", "cpu", "--port", "0",
         "--host", "127.0.0.1", "--max-model-len", "128", "--num-blocks", "64"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = p.stdout.readline()
        assert line.startswith("serving 'echo' on http://127.0.0.1:"), (line, p.stderr.read())
        base = line.strip().split(" on ")[1]
        import urllib.request

        body = json.dumps(dict(model="echo", prompt=[5, 17, 33, 2], max_tokens=6,
                               nvext={"ignore_eos": True})).encode()
        req = urllib.request.Request(base + "/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["usage"]["completion_tokens"] == 6
    finally:
        p.send_signal(signal.SIGINT)
        try:
            p.wait(timeout=30)
        finally:
            p.kill()
    assert p.returncode == 0
