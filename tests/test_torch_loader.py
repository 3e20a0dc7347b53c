"""The port's checkpoint loader against the JAX package's.

The same seeded trees (JAX ``init_params``, seed 0, on ``debug-tiny`` and
the Qwen2-shaped and tied variants below) go through both packages' HF
safetensors writers and readers in every direction: the JAX writer (which
uses the ``safetensors`` package) feeds the port's reader (standard
library and numpy), and the port's writer feeds the JAX reader, in f32 and
bf16, as one file and as index-mapped shards, quantized at load to int8 or
not.  The trees must be bit for bit ``params_from_jax`` of the JAX
loader's (through ``fuse_projections`` when the port loads fused).  The
port's on-device quantization is held bit for bit against the numpy
arithmetic of ``quantize_array_np``, and a MoE checkpoint is refused.
"""

import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.models import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.models.loader import load_params as jax_load_params
from dynamo_tpu.models.loader import save_params_hf as jax_save_params_hf
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.config import ModelConfig, get_config
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.models.quant import _quantize, fuse_projections, quantize_array_np

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def _variant(name, dtype):
    """debug-tiny (untied), its tied twin, and a Qwen2-shaped twin with
    q/k/v biases, in both packages' config types."""
    base = jax_get_config("debug-tiny").with_overrides(dtype=dtype)
    over = {"untied": {}, "tied": {"tie_word_embeddings": True},
            "qwen2": {"qkv_bias": True}}[name]
    jcfg = base.with_overrides(**over)
    tcfg = get_config("debug-tiny").with_overrides(dtype=dtype, **over)
    return jcfg, tcfg


def _jax_tree(jcfg):
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias and "bq" not in params["layers"]:
        rng = np.random.default_rng(5)
        L, q, kv = jcfg.num_layers, jcfg.num_heads * jcfg.head_dim, jcfg.num_kv_heads * jcfg.head_dim
        for name, n in (("bq", q), ("bk", kv), ("bv", kv)):
            params["layers"][name] = jax.numpy.asarray(
                rng.standard_normal((L, n)).astype(np.float32), params["embed"].dtype)
    if jcfg.tie_word_embeddings:
        params.pop("lm_head", None)
    return params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(got, want):
    """Leaf for leaf: same names, shapes, dtypes and bits."""
    flat = lambda t: {**{k: v for k, v in t.items() if k != "layers"},  # noqa: E731
                      **{f"layers.{k}": v for k, v in t["layers"].items()}}
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


def _save_sharded_jax(params, path, max_files=3):
    """The JAX writer's tensors split over HF-named shards with an index
    (the JAX writer itself writes one file)."""
    from safetensors.numpy import load_file, save_file

    jax_save_params_hf(params, path)
    one = os.path.join(path, "model.safetensors")
    tensors = load_file(one)
    os.remove(one)
    names = sorted(tensors)
    chunks = [names[i::max_files] for i in range(max_files)]
    weight_map = {}
    for i, chunk in enumerate(chunks):
        fname = f"model-{i + 1:05d}-of-{max_files:05d}.safetensors"
        save_file({n: tensors[n] for n in chunk}, os.path.join(path, fname))
        weight_map.update({n: fname for n in chunk})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


@pytest.mark.parametrize("variant", ["untied", "tied", "qwen2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_port_reader_equals_jax_loader_on_jax_files(variant, dtype, quant, layout, tmp_path):
    """JAX writer → both readers: the port's tree is params_from_jax of
    the JAX loader's, bit for bit (tolerance: none)."""
    jcfg, tcfg = _variant(variant, dtype)
    params = _jax_tree(jcfg)
    path = str(tmp_path / "ckpt")
    if layout == "single":
        jax_save_params_hf(params, path)
    else:
        _save_sharded_jax(params, path)
    want = params_from_jax(_np(jax_load_params(jcfg, path, quant=quant)), device=CPU)
    got = loader.load_params(tcfg, path, quant=quant, device=CPU)
    assert_trees_equal(got, want)
    fused = loader.load_params(tcfg, path, quant=quant, device=CPU, fuse=True)
    assert_trees_equal(fused, fuse_projections(want))


@pytest.mark.parametrize("variant", ["untied", "tied", "qwen2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shard_bytes", [None, 20_000])
def test_jax_reader_reads_port_files(variant, dtype, shard_bytes, tmp_path):
    """The port's writer → the JAX loader and the port's: both trees equal
    the tree written (bit for bit), quantized at load too."""
    jcfg, tcfg = _variant(variant, dtype)
    tree = params_from_jax(_np(_jax_tree(jcfg)), device=CPU)
    path = str(tmp_path / "ckpt")
    files = loader.save_params_hf(tree, path, max_shard_bytes=shard_bytes, config=tcfg)
    shards = [f for f in files if f.endswith(".safetensors")]
    assert (len(shards) > 1) == (shard_bytes is not None)
    for quant in (None, "int8"):
        jax_tree = params_from_jax(_np(jax_load_params(jcfg, path, quant=quant)), device=CPU)
        port_tree = loader.load_params(tcfg, path, quant=quant, device=CPU)
        assert_trees_equal(port_tree, jax_tree)
        if quant is None:
            assert_trees_equal(port_tree, tree)
    # config.json reads back to the same architecture (the name and the
    # serving dtype are the engine's, not the file's).
    back = ModelConfig.from_local_path(path, name=tcfg.name)
    assert back.with_overrides(dtype=tcfg.dtype) == tcfg


def test_safetensors_files_read_by_the_safetensors_package(tmp_path):
    """The port's writer's bytes are a valid safetensors file for the
    reference library, every dtype the loader handles."""
    from safetensors import safe_open

    import ml_dtypes

    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    tensors = {
        "a.f32": torch.from_numpy(f32), "b.bf16": torch.from_numpy(f32).to(torch.bfloat16),
        "c.f16": torch.from_numpy(f32).half(), "d.i8": torch.arange(-4, 4, dtype=torch.int8),
        "e.empty": torch.zeros((0, 4)), "f.i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
    }
    path = str(tmp_path / "x.safetensors")
    loader.write_safetensors(path, tensors, metadata={"format": "pt"})
    with safe_open(path, framework="numpy") as f:
        assert sorted(f.keys()) == sorted(tensors)
        for k, t in tensors.items():
            got = f.get_tensor(k)
            want = t.float().numpy().astype(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 \
                else t.numpy()
            assert got.dtype == want.dtype and np.array_equal(
                got.view(np.uint16) if t.dtype == torch.bfloat16 else got,
                want.view(np.uint16) if t.dtype == torch.bfloat16 else want), k
    back = dict(loader.read_safetensors(path))
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_quantize_equals_numpy_arithmetic(axis, dtype):
    """``models/quant._quantize`` (what the loader runs on the device) is
    bit for bit ``quantize_array_np``: random weights, rows at exact
    half-way points of the grid, a zero row (the 1e-12 floor) and a row
    whose max lands on ±127 exactly (tolerance: none)."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((64, 48)) * 0.02).astype(np.float32)
    w[5] = 0.0
    w[:, 7] = 0.0
    w[9] = np.linspace(-1.0, 1.0, 48, dtype=np.float32)
    w[10] = (np.arange(48, dtype=np.float32) - 24.0) / 127.0 * 2.5 + 0.5 / 127.0
    t = torch.from_numpy(w).to(dtype)
    q, s = _quantize(t, axis)
    qn, sn = quantize_array_np(t.float().numpy(), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), qn) and np.array_equal(s.numpy(), sn)
    jq = importlib.import_module("dynamo_tpu.models.quant")
    jqv, jsv = jq.quantize_array_np(t.float().numpy(), axis)
    assert np.array_equal(qn, jqv) and np.array_equal(sn, jsv)


def test_moe_checkpoint_refused_naming_its_roadmap_item(tmp_path):
    """A Mixtral-style checkpoint (expert tensors) is refused under a dense
    config, with a message naming what does not fit, and loads under the
    MoE config into the JAX loader's tree, leaf for leaf (MoE checkpoints
    are served since ROADMAP queue 1 item 6.6; tests/test_torch_moe.py
    holds the rest)."""
    jcfg = jax_get_config("debug-tiny-moe").with_overrides(dtype="float32")
    path = str(tmp_path / "moe")
    jax_save_params_hf(jax_init_params(jcfg, jax.random.PRNGKey(0)), path)
    with pytest.raises(ValueError, match="is dense but checkpoint has MoE expert tensors"):
        loader.load_params(get_config("debug-tiny").with_overrides(dtype="float32"), path,
                           device=CPU)
    got = loader.load_params(get_config("debug-tiny-moe").with_overrides(dtype="float32"), path,
                             device=CPU)
    want = params_from_jax(_np(jax_load_params(jcfg, path)), device=CPU)
    assert set(got["layers"]) == set(want["layers"]) >= {"router", "moe_gate", "moe_up",
                                                          "moe_down"}
    for name, leaf in want["layers"].items():
        assert torch.equal(got["layers"][name], leaf), name


def test_incomplete_checkpoints_refused(tmp_path):
    """A missing layer, a missing embedding and an index naming a shard
    that is not there each fail with what is missing."""
    jcfg, tcfg = _variant("untied", "float32")
    tree = params_from_jax(_np(_jax_tree(jcfg)), device=CPU)
    path = str(tmp_path / "ckpt")
    loader.save_params_hf(tree, path)
    tensors = dict(loader.read_safetensors(os.path.join(path, "model.safetensors")))
    for drop, match in (("model.layers.1.self_attn.k_proj.weight", r"wk for layers \[1\]"),
                        ("model.embed_tokens.weight", "embed_tokens")):
        d = str(tmp_path / drop)
        os.makedirs(d)
        loader.write_safetensors(os.path.join(d, "model.safetensors"),
                                 {k: v for k, v in tensors.items() if k != drop})
        with pytest.raises(ValueError, match=match):
            loader.load_params(tcfg, d, device=CPU)
    sharded = str(tmp_path / "sharded")
    files = loader.save_params_hf(tree, sharded, max_shard_bytes=20_000)
    os.remove(next(f for f in files if f.endswith(".safetensors")))
    with pytest.raises(FileNotFoundError, match="missing shards"):
        loader.load_params(tcfg, sharded, device=CPU)


def test_engine_serves_a_checkpoint_like_its_tree(tmp_path):
    """``EngineConfig.checkpoint_path``: a TorchEngine loading the port's
    checkpoint of a JAX tree gives TpuEngine's greedy streams on that tree
    (the JAX engine loading the same files), in f32, bf16 weights and W8A8."""
    import asyncio

    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from test_torch_engine import CFG, _serve

    jcfg, tcfg = _variant("untied", "float32")
    path = str(tmp_path / "ckpt")
    loader.save_params_hf(params_from_jax(_np(_jax_tree(jcfg)), device=CPU), path)

    async def main():
        for quant in (None, "int8"):
            cfg = dict(CFG, checkpoint_path=path, weight_quant=quant)
            want = await _serve(TpuEngine(JaxEngineConfig(**cfg)))
            got = await _serve(TorchEngine(EngineConfig(**cfg), device=CPU))
            assert got == want, quant

    asyncio.run(main())
