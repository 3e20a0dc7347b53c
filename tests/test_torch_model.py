"""forward_ragged of the PyTorch port against the JAX package on debug-tiny.

Same seeded weights (the JAX ``init_params`` tree, converted with
``params_from_jax``) and the same ragged batches go through both forwards:
a prefill step that writes prior prefixes, then a mixed step (a fresh
prompt, a chunk over a prior prefix, decode rows), then an all-decode step
with ``decode=True``.  The JAX side runs its XLA attention path
(``attn_impl="xla"``), where quantized pages are dequantized by folding the
scale around the call; the port dequantizes inside the attention op.
Tolerances: logits 1e-4 (f32 matmul summation order over two layers), f32
pages 1e-5, int8 pages at most 1 apart (rounding ties).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.quant import fuse_projections as jax_fuse
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import get_config

# dynamo_tpu.models re-exports names over its submodules.
jl = importlib.import_module("dynamo_tpu.models.llama")

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
PS, NUM_PAGES, S, PP = 4, 20, 4, 5


def _jax_tree(fused: bool):
    cfg = jax_get_config("debug-tiny").with_overrides(dtype="float32")
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    if fused:
        params = jax_fuse(params)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _batch(rows, T):
    """rows: [(all_tokens, start, n, table)] → numpy RaggedBatch fields."""
    tok = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    slots = np.full(T, -1, np.int32)
    kv = np.zeros(S, np.int32)
    tables = np.zeros((S, PP), np.int32)
    cu = np.zeros(S + 1, np.int32)
    at = 0
    for i, (toks, start, n, table) in enumerate(rows):
        p = np.arange(start, start + n)
        tok[at:at + n] = toks[start:start + n]
        pos[at:at + n] = p
        slots[at:at + n] = np.asarray(table)[p // PS] * PS + p % PS
        tables[i] = table
        kv[i] = start + n
        at += n
        cu[i + 1] = at
    cu[len(rows) + 1:] = at
    return dict(token_ids=tok, positions=pos, slot_mapping=slots, kv_lens=kv,
                page_indices=tables, cu_q_lens=cu,
                num_seqs=np.asarray([len(rows)], np.int32))


def _steps():
    rng = np.random.default_rng(0)
    perm = rng.permutation(NUM_PAGES).astype(np.int32)
    tables = [perm[i * PP:(i + 1) * PP] for i in range(S)]
    toks = [rng.integers(1, 256, size=20).tolist() for _ in range(S)]
    prefix = _batch([(toks[1], 0, 6, tables[1]), (toks[2], 0, 8, tables[2]),
                     (toks[3], 0, 2, tables[3])], 16)
    mixed = _batch([(toks[0], 0, 7, tables[0]), (toks[1], 6, 5, tables[1]),
                    (toks[2], 8, 1, tables[2]), (toks[3], 2, 1, tables[3])], 16)
    decode = _batch([(toks[i], start, 1, tables[i])
                     for i, start in enumerate([7, 11, 9, 3])], S)
    decode["cu_q_lens"] = np.arange(S + 1, dtype=np.int32)
    return [(prefix, False), (mixed, False), (decode, True)]


@pytest.mark.parametrize("cache_dtype,kv_scale,fused", [
    ("float32", None, False),
    ("float32", None, True),
    ("int8", 0.05, True),
    ("int8", [0.05, 0.08], True),
], ids=["f32", "f32-fused", "int8-scalar", "int8-per-layer"])
def test_forward_ragged_matches_jax(cache_dtype, kv_scale, fused):
    jcfg, tree = _jax_tree(fused)
    tcfg = get_config("debug-tiny").with_overrides(dtype="float32")
    params = tl.params_from_jax(tree, device="cpu")
    jdt = jnp.int8 if cache_dtype == "int8" else jnp.float32
    jcache = jl.PagedKVCache.create(jcfg, NUM_PAGES, PS, dtype=jdt)
    tcache = tl.PagedKVCache.create(tcfg, NUM_PAGES, PS, tl.torch_dtype(cache_dtype), CPU)
    jscale = None if kv_scale is None else jnp.asarray(kv_scale, jnp.float32)
    for fields, decode in _steps():
        jlog, jcache = jax.jit(
            lambda p, c, rb: jl.forward_ragged(p, jcfg, rb, c, attn_impl="xla",
                                               kv_scale=jscale, decode=decode)
        )(tree, jcache, jl.RaggedBatch(**{k: jnp.asarray(v) for k, v in fields.items()}))
        trb = tl.RaggedBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
        with torch.inference_mode():
            tlog = tl.forward_ragged(params, tcfg, trb, tcache, kv_scale=kv_scale, decode=decode)
        nrows = int(fields["num_seqs"][0])
        np.testing.assert_allclose(tlog[:nrows].numpy(), np.asarray(jlog)[:nrows],
                                   rtol=1e-4, atol=1e-4)
        jp = np.asarray(jcache.pages).astype(np.float32)
        tp = tcache.pages.float().numpy()
        if cache_dtype == "int8":
            assert np.abs(tp - jp).max() <= 1
            assert (tp != jp).mean() < 1e-3
        else:
            np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)


def test_params_from_jax_keeps_layout_and_refuses_unknown_leaves():
    _, tree = _jax_tree(fused=False)
    params = tl.params_from_jax(tree, device="cpu")
    assert params["layers"]["wq"].shape == tree["layers"]["wq"].shape  # [L, in, out]
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    bad = dict(tree, layers=dict(tree["layers"], router=np.ones(1, np.float32)))  # MoE
    with pytest.raises(ValueError):
        tl.params_from_jax(bad, device="cpu")


def test_init_params_is_seeded():
    cfg = get_config("debug-tiny").with_overrides(dtype="float32")
    a = tl.init_params(cfg, seed=3, device="cpu")
    b = tl.init_params(cfg, seed=3, device="cpu")
    c = tl.init_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
