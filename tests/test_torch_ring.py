"""Sequence parallelism in the port (``ops/ring_attention.py``,
``models/llama.forward_sp_prefill``, the engine's ``_sp_prefill``) against
the JAX package on the same seeded inputs, the ranks as gloo processes on
the CPU (tests/test_torch_parallel.py's launcher, each wait bounded).

- ``ring_attention`` at sp 2 and 4, with padding (and garbage K/V past
  the prompt), equals JAX's ``ring_attention_sharded`` within 2e-5 in f32.
- ``forward_sp_prefill`` at sp 2 and at sp 2 x tp 2: the last valid
  token's logits and the sealed K/V rows (each rank its heads) equal JAX's
  within 1e-4.
- An sp 2 engine (leader and follower over the step plane) seals a long
  prompt ahead of admission and streams the tokens of the JAX ``TpuEngine``
  at sp 2; with the reuse pool flooded between seal and admission the
  pinned prefix still hits (>= 12 blocks), and the row retires within a
  bound — the JAX test reads ``num_running`` before its row retires.
- An sp 2 x tp 2 engine given two long prompts at once streams the JAX
  ``TpuEngine``'s tokens, and the two ranks of each tp column (sp
  replicates the pages) end with the same pages: a pass and its seal are
  one dispatch, so one prompt's pass cannot land between the other's pass
  and seal on a follower.
"""

import asyncio
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_parallel import RANK_ENV, free_port, rank_main, run_ranks  # noqa: E402

ENGINE = dict(model="debug-tiny", block_size=4, num_blocks=64, max_batch=2, max_model_len=128,
              prefill_chunk=32, dtype="float32")
PROMPT = [(i * 7 + 3) % 200 for i in range(50)]  # 12 complete blocks
FLOOD_PROMPT = [(i * 11 + 5) % 200 for i in range(50)]
RETIRE_TIMEOUT_S = 10.0


def _job_ring(state, inputs):
    import torch

    from dynamo_tpu_torch.ops.ring_attention import ring_attention

    outs = []
    for q, k, v, valid, scale in inputs["cases"]:
        C = q.shape[0] // state.sp.size
        lo = state.sp.index * C
        part = [torch.from_numpy(a[lo:lo + C]) for a in (q, k, v)]
        outs.append(ring_attention(*part, valid, state.sp, sm_scale=scale).numpy())
    return outs


def _job_sp_prefill(state, inputs):
    import torch

    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.parallel.mesh import param_pspecs, shard_params

    cfg = get_config("debug-tiny").with_overrides(dtype="float32")
    params = tl.params_from_jax(inputs["tree"], device="cpu")
    local = shard_params(params, param_pspecs(cfg), state.mesh, state.rank)
    with torch.inference_mode():
        logits, kv = tl.forward_sp_prefill(local, cfg, torch.from_numpy(inputs["toks"]),
                                           inputs["valid"], state)
    return {"logits": logits.numpy(), "kv": kv.numpy()}


def _job_sp_engine(state, inputs):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.multihost import StepPublisher, follower_serve
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.runtime.engine import Context

    os.environ["DYN_STEP_TOKEN"] = "ring-test"
    engine = TorchEngine(EngineConfig(**ENGINE, sp=2, sp_prefill_min=32),
                         params=params_from_jax(inputs["tree"], device="cpu"), device="cpu",
                         shard=state)
    step = f"127.0.0.1:{inputs['step_port']}"

    async def gen(prompt):
        req = Context({"token_ids": prompt,
                       "stop_conditions": {"max_tokens": 6, "ignore_eos": True},
                       "sampling_options": {"temperature": 0.0}})
        out = []
        async for item in await engine.generate(req):
            out += item.get("token_ids", [])
        return out

    async def leader():
        engine.attach_publisher(await StepPublisher("127.0.0.1", inputs["step_port"], 1).start(60))
        got = {"plain": await gen(PROMPT), "plain_hits": engine.kv.matched_blocks}
        orig_add = engine.scheduler.add

        def flooding_add(seq):
            # Exhaust the pool between the sp seal and admission: every
            # unpinned block in the reuse pool is evicted.
            grabbed = []
            while (bid := engine.kv.allocate_block()) is not None:
                grabbed.append(bid)
            engine.kv.free_sequence(grabbed)
            orig_add(seq)

        engine.scheduler.add = flooding_add
        before = engine.kv.matched_blocks
        got["flood"] = await gen(FLOOD_PROMPT)
        got["flood_hits"] = engine.kv.matched_blocks - before
        deadline = asyncio.get_running_loop().time() + RETIRE_TIMEOUT_S
        while engine.scheduler.num_running and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.01)
        got["running"] = engine.scheduler.num_running
        got["leaked"] = sum(b.ref_count for b in engine.kv._blocks)
        await engine.close()
        return got

    async def follower():
        await follower_serve(engine, step, timeout=60)
        await engine.close()
        return {"pages": engine.cache.pages.numpy()}

    return asyncio.run(leader() if state.is_leader else follower())


def _job_sp_tp_concurrent(state, inputs):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.multihost import StepPublisher, follower_serve
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.runtime.engine import Context

    os.environ["DYN_STEP_TOKEN"] = "ring-test"
    engine = TorchEngine(EngineConfig(**ENGINE, sp=2, tp=2, sp_prefill_min=32),
                         params=params_from_jax(inputs["tree"], device="cpu"), device="cpu",
                         shard=state)

    async def gen(prompt):
        req = Context({"token_ids": prompt,
                       "stop_conditions": {"max_tokens": 6, "ignore_eos": True},
                       "sampling_options": {"temperature": 0.0}})
        out = []
        async for item in await engine.generate(req):
            out += item.get("token_ids", [])
        return out

    async def leader():
        n = state.mesh.config.num_devices - 1
        engine.attach_publisher(await StepPublisher("127.0.0.1", inputs["step_port"], n).start(60))
        got = {"tokens": await asyncio.gather(*(gen(p) for p in inputs["prompts"])),
               "hits": engine.kv.matched_blocks}
        await engine.close()
        return {**got, "pages": engine.cache.pages.numpy()}

    async def follower():
        await follower_serve(engine, f"127.0.0.1:{inputs['step_port']}", timeout=60)
        await engine.close()
        return {"pages": engine.cache.pages.numpy()}

    return asyncio.run(leader() if state.is_leader else follower())


JOBS = {"ring": _job_ring, "sp_prefill": _job_sp_prefill, "sp_engine": _job_sp_engine,
        "sp_tp_concurrent": _job_sp_tp_concurrent}


if __name__ == "__main__":
    rank_main(JOBS)
    sys.exit(0)


if not os.environ.get(RANK_ENV):
    import importlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.models.config import get_config as jax_get_config
    from dynamo_tpu.ops.ring_attention import ring_attention_sharded
    from dynamo_tpu.parallel import mesh as jmesh
    from dynamo_tpu.runtime.engine import Context as JaxContext
    from dynamo_tpu.runtime.engine import collect

    jl = importlib.import_module("dynamo_tpu.models.llama")

pytestmark = pytest.mark.torch_port


def _qkv(seed, T, H, KV, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((T, H, D), (T, KV, D), (T, KV, D)))


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax(sp, tmp_path):
    cases = []
    for seed, (T, H, KV, D), valid in ((0, (32, 4, 2, 16), 32), (1, (32, 2, 2, 8), 19),
                                       (2, (64, 8, 2, 8), 41)):
        q, k, v = _qkv(seed, T, H, KV, D)
        if valid < T:  # garbage past the prompt must change nothing
            k[valid:], v[valid:] = 1e3, -1e3
        cases.append((q, k, v, valid, D**-0.5))
    mesh = Mesh(np.array(jax.devices("cpu")[:sp]), ("sp",))
    outs = run_ranks(__file__, "ring", sp, {"mesh": {"sp": sp}, "cases": cases}, tmp_path)
    for i, (q, k, v, valid, scale) in enumerate(cases):
        want = np.asarray(jax.jit(lambda q, k, v: ring_attention_sharded(
            q, k, v, valid, mesh, sm_scale=scale))(q, k, v))
        got = np.concatenate([out[i] for out in outs])
        np.testing.assert_allclose(got[:valid], want[:valid], atol=2e-5)


@pytest.mark.parametrize("mesh", [dict(sp=2), dict(sp=2, tp=2)], ids=["sp2", "sp2tp2"])
def test_forward_sp_prefill_matches_jax(mesh, tmp_path):
    cfg = jax_get_config("debug-tiny").with_overrides(dtype="float32")
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    prompt = [(i * 13 + 5) % cfg.vocab_size for i in range(27)]
    Tg = 32
    toks = np.zeros((Tg,), np.int32)
    toks[:len(prompt)] = prompt
    jm = jmesh.make_mesh(jmesh.MeshConfig(**mesh))
    placed = jmesh.shard_tree(params, jmesh.param_pspecs(cfg), jm)
    logits, kv = jax.jit(lambda p, t: jl.forward_sp_prefill(p, cfg, t, len(prompt), jm))(
        placed, jnp.asarray(toks))
    inputs = {"mesh": mesh, "tree": jax.tree_util.tree_map(np.asarray, params),
              "toks": toks.astype(np.int64), "valid": len(prompt)}
    n = jmesh.MeshConfig(**mesh).num_devices
    outs = run_ranks(__file__, "sp_prefill", n, inputs, tmp_path)
    kv, kv2 = np.asarray(kv), 2 * cfg.num_kv_heads // mesh.get("tp", 1)
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["logits"], np.asarray(logits), rtol=1e-4, atol=1e-4)
        h0 = (rank % mesh.get("tp", 1)) * kv2
        assert out["kv"].shape == (cfg.num_layers, Tg, kv2, cfg.head_dim)
        np.testing.assert_allclose(out["kv"], kv[:, :, h0:h0 + kv2], rtol=1e-4, atol=1e-4)


def _jax_tokens(prompts, concurrent=False, **mesh):
    async def main():
        engine = TpuEngine(JaxEngineConfig(**ENGINE, sp_prefill_min=32, **mesh))

        async def gen(prompt):
            req = {"token_ids": prompt, "stop_conditions": {"max_tokens": 6, "ignore_eos": True},
                   "sampling_options": {"temperature": 0.0}}
            out = await collect(await engine.generate(JaxContext(req)))
            return [t for item in out for t in item["token_ids"]]

        if concurrent:
            got = list(await asyncio.gather(*(gen(p) for p in prompts)))
        else:
            got = [await gen(p) for p in prompts]
        await engine.close()
        return got

    return asyncio.run(main())


def test_sp_engine_seals_ahead_and_streams_the_jax_tokens(tmp_path):
    # The JAX engine's random init (seed 0), given to the port's ranks.
    jcfg = jax_get_config("debug-tiny").with_overrides(dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    want, want_flood = _jax_tokens([PROMPT, FLOOD_PROMPT], sp=2)
    outs = run_ranks(__file__, "sp_engine", 2,
                     {"mesh": {"sp": 2}, "step_port": free_port(), "tree": tree}, tmp_path)
    lead = outs[0]
    assert lead["plain"] == want
    assert lead["flood"] == want_flood
    assert lead["plain_hits"] >= 12 and lead["flood_hits"] >= 12
    assert lead["running"] == 0 and lead["leaked"] == 0


def test_sp_tp_engine_two_long_prompts_at_once_keep_every_rank_in_step(tmp_path):
    jcfg = jax_get_config("debug-tiny").with_overrides(dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    prompts = [PROMPT, FLOOD_PROMPT]
    want = _jax_tokens(prompts, concurrent=True, sp=2, tp=2)
    outs = run_ranks(__file__, "sp_tp_concurrent", 4,
                     {"mesh": {"sp": 2, "tp": 2}, "step_port": free_port(), "tree": tree,
                      "prompts": prompts}, tmp_path)
    assert outs[0]["tokens"] == want
    assert outs[0]["hits"] >= 24  # both prompts' 12 blocks sealed ahead of admission
    # Ranks (sp, tp) = (1, t) replicate the pages of (0, t).
    for rank in (2, 3):
        np.testing.assert_array_equal(outs[rank]["pages"], outs[rank - 2]["pages"])
