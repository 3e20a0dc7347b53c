"""Batched multi-LoRA on the port against the JAX package.

The LoRA cases of the JAX package's ``tests/test_tenancy.py`` (its lines
378–815: batched equals solo, hot swap, refcount pins, model-not-found,
the served-model allowlist, the 404 body, salt isolation in the engine,
the host tier, the transfer plane and the KV router, the snapshot and a
migrated tenant stream) run on ``TorchEngine`` with the same inputs as on
``TpuEngine``, and wherever both packages run a case their outcomes are
held equal.  Then ``TorchEngine`` and ``TpuEngine`` on the same weights
(JAX ``init_params``, seed 0) and the same adapters (``LoraAdapter.random``
from a numpy seed, so both packages draw the same factors) give identical
greedy streams with mixed adapters in one batch, in f32 on ``debug-tiny``,
at ``decode_steps`` 1 and 4, with speculation on and under W8A8; the
device banks are written in place and a hot swap with more adapters than
slots captures no new program.  The grammar halves of the JAX tenancy
tests are tests/test_torch_grammar.py's.
"""

import asyncio
import importlib
import json

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.llama import params_from_jax
from test_torch_engine import _jax_params

pytestmark = [pytest.mark.torch_port, pytest.mark.tenancy]

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)

CFG = dict(
    model="debug-tiny",
    block_size=4,
    num_blocks=256,
    max_batch=4,
    max_model_len=256,
    prefill_chunk=32,
    dtype="float32",
)


def M(pkg):
    m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
    ns = type("NS", (), {})()
    ns.lora = m("llm.tenancy.lora")
    ns.protocols = m("llm.protocols")
    ns.engine_rt = m("runtime.engine")
    ns.metrics = m("llm.metrics")
    ns.config = m("models.config")
    return ns


def _req(pkg, tokens, max_tokens=24, model=None, annotations=None, ignore_eos=True, **kw):
    p = M(pkg).protocols
    return p.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=p.StopConditions(max_tokens=max_tokens, ignore_eos=ignore_eos),
        sampling_options=p.SamplingOptions(**kw),
        model=model,
        annotations=dict(annotations or {}),
    ).to_dict()


async def _generate(pkg, engine, tokens, **kw):
    rt = M(pkg).engine_rt
    out = await rt.collect(await engine.generate(rt.Context(_req(pkg, tokens, **kw))))
    return [t for item in out for t in item["token_ids"]]


def _engine(pkg, lora=True, max_adapters=4, rank=4, **over):
    """A debug-tiny engine of ``pkg`` on the shared seed-0 JAX weights."""
    cfg = dict(CFG, **over)
    if lora:
        cfg["lora"] = {"enable": True, "max_adapters": max_adapters, "rank": rank}
    params = _jax_params()
    if pkg == JAX:
        return TpuEngine(JaxEngineConfig(**cfg), params=params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return TorchEngine(EngineConfig(**cfg), params=params_from_jax(tree, device="cpu"),
                       device="cpu")


def _lora_engine(pkg, n_adapters=3, max_adapters=4, scale=1.0, **over):
    """The JAX test's ``_lora_engine``: adapters ad0.. of rank 4, seeds
    100.., on either package."""
    engine = _engine(pkg, max_adapters=max_adapters, **over)
    lora = M(pkg).lora
    for i in range(n_adapters):
        engine.register_adapter(lora.LoraAdapter.random(
            engine.model_config, f"ad{i}", rank=4, seed=100 + i, scale=scale))
    return engine


def test_random_adapters_and_banks_equal_across_packages():
    """``LoraAdapter.random``, ``bank_leaves``, ``padded_factors``,
    ``target_dims`` and the salt: the same values on both packages."""
    cfgs = {pkg: M(pkg).config.get_config("debug-tiny") for pkg in PKGS}
    ad = {pkg: M(pkg).lora.LoraAdapter.random(cfgs[pkg], "x", rank=3, seed=9, scale=0.5)
          for pkg in PKGS}
    for tgt in M(PORT).lora.LORA_TARGETS:
        for i in (0, 1):
            assert np.array_equal(ad[PORT].factors[tgt][i], ad[JAX].factors[tgt][i])
        for pkg_ad in (ad[PORT], None):
            a = [M(pkg).lora.padded_factors(pkg_ad and ad[pkg], cfgs[pkg], tgt, 5) for pkg in PKGS]
            assert all(np.array_equal(x, y) for x, y in zip(*a))
    banks = [M(pkg).lora.bank_leaves(cfgs[pkg], 3, 5) for pkg in PKGS]
    assert {k: v.shape for k, v in banks[0].items()} == {k: v.shape for k, v in banks[1].items()}
    assert M(PORT).lora.target_dims(cfgs[PORT]) == M(JAX).lora.target_dims(cfgs[JAX])
    assert M(PORT).lora.kv_salt_for_adapter("a") == M(JAX).lora.kv_salt_for_adapter("a")


def test_peft_directory_reads_equal_across_packages(tmp_path):
    """``save_lora_adapter``'s PEFT directory: both packages' loaders
    (the JAX one through the ``safetensors`` package) read the factors
    written; alpha != r folds alpha/r into B alike."""
    mc = {pkg: M(pkg).config.get_config("debug-tiny") for pkg in PKGS}
    ad = M(PORT).lora.LoraAdapter.random(mc[PORT], "p", rank=6, seed=4)
    path = str(tmp_path / "peft")
    M(PORT).lora.save_lora_adapter(ad, path)
    cfg_path = tmp_path / "peft" / "adapter_config.json"
    for alpha in (None, 12.0):
        if alpha is not None:
            cfg = json.loads(cfg_path.read_text())
            cfg_path.write_text(json.dumps(dict(cfg, lora_alpha=alpha)))
        got = {pkg: M(pkg).lora.load_lora_adapter(path, mc[pkg], name="p") for pkg in PKGS}
        for tgt, (a, b) in ad.factors.items():
            for pkg in PKGS:
                ga, gb = got[pkg].factors[tgt]
                assert np.array_equal(ga, a)
                assert np.array_equal(gb, b * (alpha / 6 if alpha else 1.0))
            assert np.array_equal(got[PORT].factors[tgt][1], got[JAX].factors[tgt][1])


@pytest.mark.parametrize("pkg", PKGS)
def test_registry_refcounts_pin_slots(pkg):
    """tests/test_tenancy.py::test_registry_refcounts_pin_slots on ``pkg``."""
    lora = M(pkg).lora

    async def main():
        applied = []

        async def apply_fn(slot, adapter):
            applied.append((slot, adapter.name if adapter else None))

        mc = M(pkg).config.get_config("debug-tiny")
        reg = lora.AdapterRegistry(2, 4, apply_fn, promote_timeout_s=0.1)
        for name in ("a", "b", "c"):
            reg.register(lora.LoraAdapter.random(mc, name, rank=2), mc)
        sa, sb = await reg.acquire("a"), await reg.acquire("b")
        assert sa != sb
        with pytest.raises(lora.AdapterCapacityError):
            await reg.acquire("c")
        reg.release("a")
        sc = await reg.acquire("c")
        assert sc == sa and "a" not in reg.resident()
        with pytest.raises(lora.AdapterError):
            reg.register(lora.LoraAdapter.random(mc, "b", rank=2, seed=1), mc)
        with pytest.raises(lora.AdapterError):
            reg.unregister("b")
        reg.release("b"), reg.release("c")
        reg.unregister("b")
        assert "b" not in reg.names()
        with pytest.raises(KeyError):
            await reg.acquire("ghost")
        return applied

    assert asyncio.run(main()) == [(0, "a"), (1, "b"), (0, "c")]


async def test_lora_batched_matches_solo_and_tpu_engine():
    """tests/test_tenancy.py::test_lora_batched_matches_solo on both
    packages: one batch serving 3 adapters and the base equals each served
    solo, the four streams differ, and the port's equal TpuEngine's
    (seeded temperature 0.9, the JAX test's sampling)."""
    prompt = [(j * 13 + 5) % 251 + 1 for j in range(12)]
    kw = dict(max_tokens=16, temperature=0.9, seed=21)
    out = {}
    for pkg in PKGS:
        engine = _lora_engine(pkg)
        try:
            solo = {name: await _generate(pkg, engine, prompt, model=name, **kw)
                    for name in ("ad0", "ad1", "ad2")}
            solo["base"] = await _generate(pkg, engine, prompt, **kw)
            assert len({tuple(v) for v in solo.values()}) == 4
            batched = await asyncio.gather(
                *(_generate(pkg, engine, prompt, model=n, **kw) for n in ("ad0", "ad1", "ad2")),
                _generate(pkg, engine, prompt, **kw))
            assert batched == [solo["ad0"], solo["ad1"], solo["ad2"], solo["base"]]
            out[pkg] = solo
        finally:
            await engine.close()
    assert out[PORT] == out[JAX]


MIXED_PROMPTS = [
    ([5, 17, 33, 2, 250, 9, 61], "ad0", 14),
    (list(range(40, 61)), None, 11),
    ([7, 7, 7, 7, 100, 3, 11, 19, 23, 29, 31, 37, 41], "ad1", 16),
    ([200, 1, 150], "ad2", 12),
    ([9, 8, 7, 9, 8, 7, 9, 8, 7, 9, 8, 7], "ad0", 18),
    (list(range(100, 118)), "ad1", 9),
]


# Speculation needs free rows and repetitive output to draft: the spec
# tests' prompts (tests/test_torch_spec.py MIXED) on 8 rows, small adapters.
SPEC_PROMPTS = [
    ([1, 2, 3, 4, 5, 6, 7, 8] * 4, "ad0", 48),
    ([(j * 104729 + 13) % 251 for j in range(24)], None, 24),
    ([3] * 80, "ad1", 32),
    ([9, 9, 5, 9, 9, 5], "ad2", 40),
]


@pytest.mark.parametrize("over", [
    {"decode_steps": 1},
    {"decode_steps": 4},
    {"decode_steps": 4, "max_batch": 8, "spec_decode": {"enable": True, "k": 4}},
    {"decode_steps": 4, "weight_quant": "int8"},
], ids=["steps1", "steps4", "spec", "w8a8"])
async def test_mixed_adapter_streams_match_tpu_engine(over):
    """Six greedy requests over three adapters and the base model, all at
    once on a 4-row engine (rows join and leave the fused sessions): the
    port's streams equal TpuEngine's on the same weights and adapters
    (tolerance: none).  With speculation on (repetitive prompts, free
    rows), the port's speculative streams equal TpuEngine's with
    speculation off, and drafts are accepted."""
    spec = over.get("spec_decode")
    prompts = SPEC_PROMPTS if spec else MIXED_PROMPTS
    got = {}
    for pkg in PKGS:
        eng_over = dict(over)
        if pkg == JAX:
            eng_over.pop("spec_decode", None)  # the reference: speculation off
        engine = _lora_engine(pkg, scale=0.05 if spec else 0.5, **eng_over)
        if spec and pkg == PORT:
            M(PORT).metrics.spec_metrics.reset()
        try:
            got[pkg] = await asyncio.gather(*(
                _generate(pkg, engine, p, model=m, max_tokens=n) for p, m, n in prompts))
        finally:
            await engine.close()
    assert [len(s) for s in got[PORT]] == [n for _, _, n in prompts]
    assert got[PORT] == got[JAX]
    if spec:
        assert M(PORT).metrics.spec_metrics.accepted_total > 0


async def test_hot_swap_more_adapters_than_slots_captures_nothing_new():
    """tests/test_tenancy.py::test_adapter_hot_swap_register_evict_promote
    and the LoRA half of test_constrained_and_lora_rows_compile_nothing_new
    on the port: after warmup, five adapters through two slots (LRU
    evictions, promotions, re-promotion of an evicted adapter reproducing
    its stream, live register/unregister under the allowlist) add no
    program key; the bank tensors stay the ones the programs captured,
    rewritten in place; streams equal TpuEngine's doing the same."""
    prompt = list(range(1, 9))
    streams = {}
    for pkg in PKGS:
        mt = M(pkg).metrics.tenancy_metrics
        engine = _lora_engine(pkg, n_adapters=5, max_adapters=2)
        try:
            if pkg == PORT:
                await engine.run_warmup()
                banks = {k: v.data_ptr() for k, v in engine.params["layers"].items()
                         if k.startswith("lora_")}
            else:
                engine.warmup()
            await _generate(pkg, engine, prompt, max_tokens=4)
            before = engine.compile_counts()
            promos, evictions = mt.adapter_promotions, mt.adapter_evictions
            seq = []
            for name in ("ad0", "ad1", "ad2", "ad3", "ad4", "ad0", "ad2"):
                seq.append(await _generate(pkg, engine, prompt, model=name, max_tokens=4))
            assert seq[5] == seq[0] and seq[6] == seq[2]
            assert mt.adapter_evictions - evictions == 5
            assert mt.adapter_promotions - promos == 7
            assert len(engine._lora_registry.resident()) == 2
            engine.set_served_models(["debug-tiny", *engine.adapter_names()])
            engine.register_adapter(M(pkg).lora.LoraAdapter.random(
                engine.model_config, "fresh", rank=2, seed=9))
            seq.append(await _generate(pkg, engine, prompt, model="fresh", max_tokens=4))
            engine.unregister_adapter("fresh")
            with pytest.raises(M(pkg).protocols.ModelNotFoundError):
                await _generate(pkg, engine, prompt, model="fresh", max_tokens=4)
            assert engine.compile_counts() == before
            if pkg == PORT:
                assert banks == {k: v.data_ptr() for k, v in engine.params["layers"].items()
                                 if k.startswith("lora_")}
            streams[pkg] = seq
        finally:
            await engine.close()
    assert streams[PORT] == streams[JAX]


def test_slot_write_is_in_place_and_matches_jax_banks():
    """``_lora_apply`` writes a slot's rank-padded factors into the banks
    the programs hold (same tensors, same storage); the banks then equal
    the JAX engine's functional ``.at[].set`` result bit for bit."""
    async def main():
        banks = {}
        for pkg in PKGS:
            engine = _lora_engine(pkg, n_adapters=0, max_adapters=3, rank=5)
            mc = engine.model_config
            before = ({k: v for k, v in engine.params["layers"].items() if k.startswith("lora_")}
                      if pkg == PORT else None)
            await engine._lora_apply(1, M(pkg).lora.LoraAdapter.random(mc, "x", rank=3, seed=2))
            await engine._lora_apply(2, M(pkg).lora.LoraAdapter.random(mc, "y", rank=5, seed=3))
            await engine._lora_apply(1, M(pkg).lora.LoraAdapter.random(mc, "z", rank=4, seed=4))
            layers = engine.params["layers"]
            if pkg == PORT:
                for k, v in before.items():
                    assert layers[k] is v
            banks[pkg] = {k: np.asarray(torch.as_tensor(v).numpy() if pkg == PORT else v)
                          for k, v in layers.items() if k.startswith("lora_")}
            await engine.close()
        assert sorted(banks[PORT]) == sorted(banks[JAX])
        for k in banks[JAX]:
            assert np.array_equal(banks[PORT][k], banks[JAX][k]), k

    asyncio.run(main())


@pytest.mark.parametrize("pkg", PKGS)
async def test_unknown_model_is_model_not_found(pkg):
    """tests/test_tenancy.py::test_unknown_model_is_model_not_found on
    ``pkg``."""
    mt = M(pkg).metrics.tenancy_metrics
    engine = _lora_engine(pkg, n_adapters=1)
    try:
        engine.set_served_models(["debug-tiny", "ad0"])
        prompt = list(range(1, 9))
        await _generate(pkg, engine, prompt, model="debug-tiny", max_tokens=2)
        await _generate(pkg, engine, prompt, model="ad0", max_tokens=2)
        n0 = mt.adapter_not_found_total
        with pytest.raises(M(pkg).protocols.ModelNotFoundError):
            await _generate(pkg, engine, prompt, model="someone-elses-model", max_tokens=2)
        with pytest.raises(M(pkg).protocols.ModelNotFoundError):
            await _generate(pkg, engine, prompt, annotations={"adapter": "ghost"}, max_tokens=2)
        assert mt.adapter_not_found_total == n0 + 2
    finally:
        await engine.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_lora_enabled_engine_without_boot_adapters_serves_base(pkg):
    """tests/test_tenancy.py::test_lora_enabled_engine_without_boot_adapters_serves_base
    on ``pkg`` (``_load_adapters`` pins the allowlist to the served name)."""
    load_adapters = importlib.import_module(f"{pkg}.engine")._load_adapters
    engine = _lora_engine(pkg, n_adapters=0)
    try:
        load_adapters(engine, {}, "my-org/served-8b")
        assert engine._served_models == {"my-org/served-8b"}
        prompt = list(range(1, 9))
        assert len(await _generate(pkg, engine, prompt, model="my-org/served-8b",
                                   max_tokens=2)) == 2
        with pytest.raises(M(pkg).protocols.ModelNotFoundError):
            await _generate(pkg, engine, prompt, model="ghost", max_tokens=2)
        engine.register_adapter(M(pkg).lora.LoraAdapter.random(
            engine.model_config, "late", rank=4, seed=9))
        assert len(await _generate(pkg, engine, prompt, model="late", max_tokens=2)) == 2
    finally:
        await engine.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_boot_adapters_from_flags(pkg, tmp_path):
    """``--lora NAME=random:SEED`` and ``--lora NAME=DIR`` through each
    package's ``_lora_section`` / ``_load_adapters``: the same section, the
    same adapters (the PEFT one read from the port's writer's directory)."""
    from types import SimpleNamespace

    mod = importlib.import_module(f"{pkg}.engine")
    peft = str(tmp_path / "peft")
    mc = M(PORT).config.get_config("debug-tiny")
    M(PORT).lora.save_lora_adapter(M(PORT).lora.LoraAdapter.random(mc, "p", rank=4, seed=6), peft)
    args = SimpleNamespace(lora=["r1=random:3", f"p={peft}"], lora_max_adapters=3, lora_rank=4)
    section, adapters = mod._lora_section(args)
    assert section == {"max_adapters": 3, "rank": 4, "enable": True}
    assert adapters == {"r1": "random:3", "p": peft}
    engine = _engine(pkg, max_adapters=3, rank=4)
    try:
        mod._load_adapters(engine, adapters, "base")
        assert engine.adapter_names() == ["p", "r1"]
        assert engine._served_models == {"base", "p", "r1"}
        with pytest.raises(SystemExit, match="NAME=PATH"):
            mod._lora_section(SimpleNamespace(lora=["nopath"], lora_max_adapters=None,
                                              lora_rank=None))
    finally:
        await engine.close()


def test_http_adapter_routes_and_404_bodies_equal_on_both_servers():
    """tests/test_tenancy.py::test_http_404_model_not_found_body on both
    HTTP servers, each over its package's LoRA engine with one pipeline per
    served name (the base, two adapters, and a name whose adapter the
    engine does not hold): the adapters' completions are equal, and an
    unknown model and an unregistered adapter get the same 404
    ``model_not_found`` body from both."""
    from test_torch_http import _mask, _post

    prompt = [5, 17, 33, 2, 250, 9, 61]
    names = (("base", None), ("ad0", "ad0"), ("ad1", "ad1"), ("ad9", "ad9"))

    async def serve(pkg):
        m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
        tok = m("llm.tokenizer").ByteTokenizer()
        engine = _lora_engine(pkg, n_adapters=2)
        engine.set_served_models(["base", "ad0", "ad1"])
        svc = m("llm.http_service").HttpService(host="127.0.0.1", port=0)
        for name, adapter in names:
            pipe = m("runtime.pipeline").build_pipeline(
                [m("llm.preprocessor").OpenAIPreprocessor(tok, name, adapter=adapter),
                 m("llm.backend").Backend(tok)], engine)
            svc.models.add_completion_model(name, pipe)
        await svc.start()
        base = f"http://127.0.0.1:{svc.port}"
        try:
            res = {}
            for model in ("base", "ad0", "ad1", "ghost-adapter", "ad9"):
                res[model] = await _post(base, "/v1/completions", {
                    "model": model, "prompt": prompt, "max_tokens": 8, "temperature": 0,
                    "nvext": {"ignore_eos": True}})
            return res
        finally:
            await svc.close()
            await engine.close()

    out = {pkg: asyncio.run(serve(pkg)) for pkg in PKGS}
    for model in ("base", "ad0", "ad1"):
        (js, _, jtext, _), (ts, _, ttext, _) = out[JAX][model], out[PORT][model]
        assert js == ts == 200
        assert _mask(json.loads(ttext)) == _mask(json.loads(jtext))
    texts = {out[PORT][m][2] for m in ("base", "ad0", "ad1")}
    assert len({json.loads(t)["choices"][0]["text"] for t in texts}) == 3
    for model in ("ghost-adapter", "ad9"):
        (js, jct, jtext, _), (ts, tct, ttext, _) = out[JAX][model], out[PORT][model]
        assert js == ts == 404 and jct.split(";")[0] == tct.split(";")[0]
        jerr, terr = json.loads(jtext)["error"], json.loads(ttext)["error"]
        assert terr == jerr
        assert terr["code"] == "model_not_found" and terr["param"] == "model"
        assert model in terr["message"]


@pytest.mark.parametrize("pkg", PKGS)
async def test_engine_sealing_isolated_by_adapter_salt(pkg):
    """tests/test_tenancy.py::test_engine_sealing_isolated_by_adapter_salt
    on ``pkg``."""
    salt = M(pkg).lora.kv_salt_for_adapter
    engine = _lora_engine(pkg, n_adapters=2)
    try:
        prompt = list(range(10, 26))  # 4 full blocks
        await _generate(pkg, engine, prompt, model="ad0", max_tokens=2)
        assert engine.estimate_prefix_hit(prompt, salt("ad0")) >= 12
        assert engine.estimate_prefix_hit(prompt, salt("ad1")) == 0
        assert engine.estimate_prefix_hit(prompt) == 0
        matched = engine.kv.matched_blocks
        await _generate(pkg, engine, prompt, model="ad1", max_tokens=2)
        assert engine.kv.matched_blocks == matched, "cross-tenant prefix hit"
        assert engine.estimate_prefix_hit(prompt, salt("ad1")) > 0
        await _generate(pkg, engine, prompt, model="ad1", max_tokens=2)
        assert engine.kv.matched_blocks > matched
        base_prompt = list(range(100, 112))
        await _generate(pkg, engine, base_prompt, max_tokens=2)
        matched = engine.kv.matched_blocks
        await _generate(pkg, engine, base_prompt, max_tokens=2)
        assert engine.kv.matched_blocks > matched
    finally:
        await engine.close()


async def test_host_tier_restore_is_tenant_scoped():
    """tests/test_tenancy.py::test_host_tier_restore_is_tenant_scoped (a
    ``slow`` test there) on the port, with the pump parked and drained as
    the port's tier tests do: a base request never restores an adapter's
    blocks, the adapter's re-run restores its own from the host tier, and
    the streams equal TpuEngine's first pass."""
    salt = M(PORT).lora.kv_salt_for_adapter("ad0")
    prompt = list(range(1, 13))  # 3 full blocks
    want = None
    jeng = _lora_engine(JAX, n_adapters=1, num_blocks=16, max_batch=2, max_model_len=64)
    try:
        want = await _generate(JAX, jeng, prompt, model="ad0", max_tokens=4)
    finally:
        await jeng.close()
    engine = _lora_engine(PORT, n_adapters=1, num_blocks=16, max_batch=2, max_model_len=64,
                          host_cache_bytes=64 << 20, host_offload_interval=3600)

    async def drain():
        while engine._offload_queue:
            await engine.drain_offload()

    try:
        first = await _generate(PORT, engine, prompt, model="ad0", max_tokens=4)
        assert first == want
        await drain()
        assert len(engine.host_kv) >= 3
        for base in (20, 40, 60, 80, 100, 120):
            await _generate(PORT, engine, [base + i for i in range(12)], max_tokens=4)
            await drain()
        assert engine.estimate_prefix_hit(prompt, salt) < 12, "needs eviction"
        await _generate(PORT, engine, prompt, max_tokens=4)
        assert engine.estimate_prefix_hit(prompt, salt) < 12
        restored = engine.host_kv.restored_blocks
        again = await _generate(PORT, engine, prompt, model="ad0", max_tokens=4)
        assert engine.host_kv.restored_blocks > restored
        assert again == first
    finally:
        await engine.close()


@pytest.mark.parametrize("src,dst", [(PORT, PORT), (PORT, JAX), (JAX, PORT)])
async def test_transfer_plane_preserves_tenant_identity(src, dst):
    """tests/test_tenancy.py::test_transfer_plane_preserves_tenant_identity
    on the port and across packages: a tenant's export injects under its
    salt only."""
    salt = M(PORT).lora.kv_salt_for_adapter
    a, b = _engine(src, lora=False), _engine(dst, lora=False)
    try:
        prompt = list(range(30, 46))  # 4 blocks
        await _generate(src, a, prompt, annotations={"kv_salt": salt("tenant-x")}, max_tokens=2)
        payload = await a.export_prompt_blocks(prompt, salt=salt("tenant-x"))
        assert payload is not None and payload["n_blocks"] >= 3
        assert await a.export_prompt_blocks(prompt) is None
        assert await b.inject_blocks(prompt, payload, salt("tenant-x")) >= 12
        assert b.estimate_prefix_hit(prompt, salt("tenant-x")) >= 12
        assert b.estimate_prefix_hit(prompt) == 0
        assert b.estimate_prefix_hit(prompt, salt("other")) == 0
    finally:
        await a.close()
        await b.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_kv_router_overlap_is_salted(pkg):
    """tests/test_tenancy.py::test_kv_router_overlap_is_salted on
    ``pkg`` (its engine's events into its own indexer)."""
    salt = M(pkg).lora.kv_salt_for_adapter
    indexers = {pkg: importlib.import_module(f"{pkg}.llm.kv_router.indexer").KvIndexer(
        block_size=4)}
    engine = _lora_engine(pkg, n_adapters=1)
    try:
        engine.set_event_callback(
            lambda ev: [ix.apply_event(7, ev) for ix in indexers.values()])
        prompt = list(range(50, 66))
        await _generate(pkg, engine, prompt, model="ad0", max_tokens=2)
        base_prompt = list(range(200, 212))
        await _generate(pkg, engine, base_prompt, max_tokens=2)
        await asyncio.sleep(0)
        for ix in indexers.values():
            assert ix.find_matches(prompt, salt("ad0")).scores.get(7, 0) >= 4
            assert ix.find_matches(prompt).scores.get(7, 0) == 0
            assert ix.find_matches(prompt, salt("ad9")).scores.get(7, 0) == 0
            assert ix.find_matches(base_prompt).scores.get(7, 0) >= 3
            assert ix.find_matches(base_prompt, salt("ad0")).scores.get(7, 0) == 0
    finally:
        await engine.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_carries_tenant_identity(pkg):
    """tests/test_tenancy.py::test_snapshot_carries_tenant_identity on
    ``pkg``, the grammar field included; the two packages' dicts and
    resume requests are equal."""
    snap_mod = importlib.import_module(f"{pkg}.llm.migration.snapshot")
    salt = M(pkg).lora.kv_salt_for_adapter("ad0")
    g = importlib.import_module(f"{pkg}.llm.tenancy.grammar").GrammarCompiler(
        importlib.import_module(f"{pkg}.llm.tokenizer").ByteTokenizer()).compile(
        {"kind": "json_schema", "schema": {"enum": ["yes", "no", "maybe"]}}).to_dict()
    snap = snap_mod.SequenceSnapshot(request_id="r1", token_ids=[1, 2, 3], orig_prompt_len=2,
                                     adapter="ad0", kv_salt=salt, grammar=g)
    back = snap_mod.SequenceSnapshot.from_dict(snap.to_dict())
    assert (back.adapter, back.kv_salt, back.grammar) == ("ad0", salt, g)
    resume = back.to_resume_request()
    assert resume["annotations"]["adapter"] == "ad0"
    assert resume["annotations"]["kv_salt"] == salt
    assert resume["grammar"] == g
    bare = snap_mod.SequenceSnapshot(request_id="r2", token_ids=[1],
                                     orig_prompt_len=1).to_resume_request()
    assert "adapter" not in bare["annotations"]
    assert "grammar" not in bare
    other = importlib.import_module(
        f"{JAX if pkg == PORT else PORT}.llm.migration.snapshot").SequenceSnapshot
    assert other.from_dict(snap.to_dict()).to_resume_request() == resume


async def test_migrated_tenant_sequence_resumes_exact_and_isolated():
    """tests/test_tenancy.py::test_migrated_tenant_sequence_resumes_exact_and_isolated
    (a ``slow`` test there) on the port, without the grammar (a migrated
    constrained stream is tests/test_torch_grammar.py's): a seeded LoRA
    stream migrated mid-decode carries its adapter and salt in the splice
    request, the target continues it token-identically under the tenant's
    salted chain, and the source's slot pin is released at cutover; the
    control equals TpuEngine's stream."""
    from dynamo_tpu_torch.llm.migration.worker import MigratableWorker
    from dynamo_tpu_torch.runtime.engine import Context, collect

    salt = M(PORT).lora.kv_salt_for_adapter("ad0")
    prompt = [(j * 13 + 5) % 251 + 1 for j in range(12)]
    kw = dict(model="ad0", max_tokens=64, temperature=0.9, seed=33)
    jeng = _lora_engine(JAX, n_adapters=1)
    try:
        want = await _generate(JAX, jeng, prompt, **kw)
    finally:
        await jeng.close()
    src, dst = _lora_engine(PORT, n_adapters=1), _lora_engine(PORT, n_adapters=1)
    mig = MigratableWorker(src, chunk_blocks=4)
    mig.direct["dst"] = MigratableWorker(dst)
    try:
        control = await _generate(PORT, src, prompt, **kw)
        assert control == want and len(control) == 64
        ctx = Context(_req(PORT, prompt, **kw))
        stream = await src.generate(ctx)
        items: list = []

        async def consume():
            async for it in stream:
                items.append(it)

        task = asyncio.create_task(consume())
        for _ in range(400):
            s = src.find_sequence(ctx.id)
            if s is not None and s.num_output_tokens >= 3:
                break
            await asyncio.sleep(0.01)
        assert await mig.migrate_out(ctx.id, {"worker_id": 9, "address": "dst",
                                              "import_path": "-", "generate_path": "-"})
        await task
        marker = items[-1].get("migrated") or items[-2].get("migrated")
        assert marker is not None
        resume = marker["request"]
        assert resume["annotations"]["adapter"] == "ad0"
        assert resume["annotations"]["kv_salt"] == salt
        delivered = [t for it in items for t in it.get("token_ids") or []]
        out = await collect(await dst.generate(Context(resume)))
        tail = [t for it in out for t in it.get("token_ids") or []]
        assert delivered + tail == control
        assert dst.estimate_prefix_hit(resume["token_ids"], salt) > 0
        assert dst.estimate_prefix_hit(resume["token_ids"]) == 0
        assert all(r == 0 for r in src._lora_registry._refs)
        assert all(r == 0 for r in dst._lora_registry._refs)
    finally:
        await src.close()
        await dst.close()


def test_tenancy_metrics_group_renders_the_jax_lora_rows():
    """The port's ``/metrics`` tenancy group: the JAX group's rows, LoRA
    and grammar, name for name and value for value."""
    tm = {pkg: M(pkg).metrics.TenancyMetrics() for pkg in PKGS}
    for i, field in enumerate(vars(tm[JAX])):
        for m in tm.values():
            setattr(m, field, i + 3)
    jax_rows = tm[JAX].render().splitlines()
    assert [ln for ln in jax_rows if "lora" in ln]
    assert tm[PORT].render().splitlines() == jax_rows


@pytest.mark.parametrize("worker_pkg", PKGS)
@pytest.mark.parametrize("mode", ["kv", "round_robin"])
async def test_http_hub_routes_adapter_names_to_the_worker(worker_pkg, mode):
    """``http --hub``'s ``ModelWatcher`` (the port's) over a worker of
    either package registering its base model and each adapter as an
    adapter entry (``register_model(lora=...)``): requests naming an
    adapter reach the worker stamped with the adapter and its salt, and
    stream the tokens the worker's engine gives that adapter directly; an
    unregistered name is not served."""
    W = lambda sub: importlib.import_module(f"{worker_pkg}.{sub}")  # noqa: E731
    F = lambda sub: importlib.import_module(f"{PORT}.{sub}")  # noqa: E731
    hub = await W("runtime.transports.hub").HubServer(host="127.0.0.1").start()
    rt = await W("runtime.component").DistributedRuntime.connect(hub.address)
    engine = _lora_engine(worker_pkg, n_adapters=2)
    front = watcher = None
    prompt = [(j * 13 + 5) % 251 + 1 for j in range(12)]
    try:
        want = {name: await _generate(worker_pkg, engine, prompt, model=name, max_tokens=8)
                for name in ("ad0", "ad1")}
        endpoint = rt.namespace("t").component("worker").endpoint("generate")
        await endpoint.serve_endpoint(engine)
        reg = W("llm.discovery").register_model
        await reg(rt, "debug-tiny", endpoint.path, kv_block_size=CFG["block_size"])
        for name in engine.adapter_names():
            await reg(rt, name, endpoint.path, kv_block_size=CFG["block_size"],
                      lora={"adapter": name, "base": "debug-tiny"})
        front = await F("runtime.component").DistributedRuntime.connect(hub.address)
        manager = F("llm.http_service").ModelManager()
        watcher = await F("llm.discovery").ModelWatcher(
            front, manager, router_mode=F("runtime.client").RouterMode(mode)).start()
        for _ in range(300):
            if all(manager.completion_engine(n) is not None for n in ("debug-tiny", "ad0", "ad1")):
                break
            await asyncio.sleep(0.02)
        tok = F("llm.tokenizer").ByteTokenizer()
        for name in ("ad0", "ad1"):
            req = {"model": name, "prompt": prompt, "max_tokens": 8, "temperature": 0,
                   "nvext": {"ignore_eos": True}}
            chunks = await F("runtime.engine").collect(
                await manager.completion_engine(name).generate(F("runtime.engine").Context(req)))
            text = "".join(c["choices"][0]["text"] for c in chunks if c.get("choices"))
            assert text == tok.decode(want[name]), name
        assert manager.completion_engine("ad9") is None
        if worker_pkg == PORT:
            assert all(r == 0 for r in engine._lora_registry._refs)
    finally:
        if watcher is not None:
            await watcher.stop()
        if front is not None:
            await front.close()
        await engine.close()
        await rt.close()
        await hub.close()


def test_adapter_model_card_equals_jax():
    """``ModelDeploymentCard.for_adapter``: the base card with the
    adapter's name and the adapter→base link, dict for dict as the JAX
    package's."""
    cards = {pkg: importlib.import_module(f"{pkg}.llm.model_card").ModelDeploymentCard
             for pkg in PKGS}
    base = {"name": "base", "context_length": 4096, "extra": {"k": 1}}
    out = {pkg: c.for_adapter(c.from_dict(dict(base)), "ad0").to_dict() for pkg, c in cards.items()}
    assert out[PORT] == out[JAX]
    assert out[PORT]["extra"]["lora"] == {"adapter": "ad0", "base": "base"}


async def test_cli_worker_registers_adapter_entries():
    """``run in=dyn://… out=torch --lora NAME=SPEC``: the worker registers
    the base model and each adapter (an adapter entry naming its base) on
    the hub, as the JAX worker does, and removes them when it stops."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.hub import HubServer

    hub = await HubServer(host="127.0.0.1").start()
    args = cli.parse_args([
        "run", "in=dyn://t.worker.generate", "out=torch", "--hub", hub.address,
        "--arch", "debug-tiny", "--dtype", "float32", "--device", "cpu", "--model", "base",
        "--block-size", "4", "--num-blocks", "64", "--max-model-len", "128",
        "--lora", "a=random:1", "--lora", "b=random:2", "--lora-max-adapters", "2",
        "--lora-rank", "4"])
    ready = asyncio.get_running_loop().create_future()
    task = asyncio.create_task(cli._run(args, on_serving=ready.set_result))
    rt = await DistributedRuntime.connect(hub.address)
    try:
        wrt = await asyncio.wait_for(ready, 60)
        entries = await rt.hub.kv_get_prefix("models/")
        by_name = {k.split("/")[1]: v for k, v in entries.items()}
        assert sorted(by_name) == ["a", "b", "base"]
        assert "lora" not in by_name["base"]
        for name in ("a", "b"):
            assert by_name[name]["lora"] == {"adapter": name, "base": "base"}
            assert by_name[name]["endpoint"] == by_name["base"]["endpoint"]
            assert all(k.endswith(f"/{wrt.worker_id}") for k in entries)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        assert await rt.hub.kv_get_prefix("models/") == {}
    finally:
        if not task.done():
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await rt.close()
        await hub.close()
