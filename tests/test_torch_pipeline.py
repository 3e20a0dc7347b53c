"""The port's continuous decode pipeline against its control and against
the JAX engine, on the CPU.

The model is ``tests/test_continuous_batching.py``: in-loop admission and
retirement are a scheduling change, never a token change, so the port's
continuous pipeline and its drain-on-any-change control
(``_continuous_decode = False``) must give byte-identical streams on the
churn trace (staggered finishes, the back half arriving inside a live fused
session) at seeded temperature 0.9 and at greedy; its greedy streams must
equal ``TpuEngine``'s at ``pipeline_depth`` 2.  Also: ``warmup()`` covers
every program the churn reaches, each sampler flag keys its own program,
the ``RowSlots``/``admit_continuous`` primitives behave as the JAX
package's, and no retired row's blocks are freed before every chunk
dispatched while it was active has been harvested.

On the CPU the device programs run eagerly; ``_Replay`` makes them behave
as captured graphs do on CUDA (the function seen first for a key runs
every later call of that key), so a key that misses something the program
depends on changes the streams here too.
"""

import asyncio
import importlib

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context, collect

pytestmark = pytest.mark.torch_port

CFG = dict(
    model="debug-tiny", block_size=4, num_blocks=256, max_batch=4, max_model_len=256,
    prefill_chunk=16, dtype="float32", decode_steps=4, pipeline_depth=2,
)


class _Replay:
    """A device program whose first function per key serves every later
    call of that key, as a captured graph does."""

    def __init__(self, program):
        self.program = program
        self.fns = {}

    def __call__(self, key, fn, host, dev=None):
        return self.program(key, self.fns.setdefault(key, fn), host, dev)

    def __getattr__(self, name):
        return getattr(self.program, name)


def _engine(continuous=True, params=None, **over):
    eng = TorchEngine(EngineConfig(**dict(CFG, **over)), params=params, device="cpu")
    eng._continuous_decode = continuous
    eng.programs.step = _Replay(eng.programs.step)
    eng.programs.multi = _Replay(eng.programs.multi)
    return eng


def _prompt(i, n=12):
    return [(i * 7919 + j * 104729) % 251 + 1 for j in range(n)]


async def _one(engine, i, osl, late=False, **samp):
    if late:
        # Land INSIDE a live fused session: admission while it runs.
        for _ in range(4000):
            if engine._pipeline_members:
                break
            await asyncio.sleep(0.002)
    req = PreprocessedRequest(
        token_ids=_prompt(i),
        stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
        sampling_options=SamplingOptions(**samp),
    ).to_dict()
    items = await collect(await engine.generate(Context(req)))
    return [t for it in items for t in it["token_ids"]], items[-1]["finish_reason"]


async def _churn(engine, temperature, n=8):
    """The JAX test's churn trace: the first wave keeps the session alive
    while short rows retire; the back half arrives mid-session."""
    jobs = []
    for i in range(n):
        late = i >= (n + 1) // 2
        osl = (24 + 8 * (i % 2)) if not late else (5 + 3 * (i % 3))
        jobs.append(_one(engine, i, osl, late=late, temperature=temperature, seed=i + 1))
    return await asyncio.gather(*jobs)


def _stats(engine):
    return {"rebuilds": engine.pipeline_rebuilds, "admissions": engine.continuous_admissions,
            "retired": engine.continuous_retired}


async def _run(engine, coro_fn):
    try:
        return await coro_fn(engine), _stats(engine)
    finally:
        await engine.close()


@pytest.mark.parametrize("temperature", [0.9, 0.0], ids=["seeded-temp0.9", "greedy"])
def test_continuous_vs_control_exact_streams(temperature):
    on, stats = asyncio.run(_run(_engine(True), lambda e: _churn(e, temperature)))
    off, _ = asyncio.run(_run(_engine(False), lambda e: _churn(e, temperature)))
    assert on == off, "continuous batching changed the streams"
    assert stats["admissions"] >= 1, stats
    assert stats["retired"] >= 1, stats
    assert stats["rebuilds"] == 0, stats


@pytest.fixture(scope="module")
def jax_churn():
    """One TpuEngine (it pays its XLA compiles once): its greedy churn
    streams, compile-count entries and dispatch summary."""
    params = jax_init_params(jax_get_config("debug-tiny").with_overrides(dtype="float32"),
                             jax.random.PRNGKey(0))

    async def run():
        engine = TpuEngine(JaxEngineConfig(**CFG), params=params)
        try:
            streams = await _churn(engine, 0.0)
            return streams, engine.compile_counts(), _stats(engine)
        finally:
            await engine.close()

    streams, counts, stats = asyncio.run(run())
    return params, streams, counts, stats


def test_greedy_churn_matches_tpu_engine(jax_churn):
    params, want, _, jax_stats = jax_churn
    tree = jax.tree_util.tree_map(np.asarray, params)
    engine = _engine(True, params=params_from_jax(tree, device="cpu"))
    got, stats = asyncio.run(_run(engine, lambda e: _churn(e, 0.0)))
    assert got == want
    assert jax_stats["admissions"] >= 1 and stats["admissions"] >= 1, (jax_stats, stats)


def test_warmup_then_churn_adds_no_program(jax_churn):
    jax_counts = jax_churn[2]

    async def run(engine):
        warm = await engine.run_warmup()
        streams = await _churn(engine, 0.0)
        return warm, engine.compile_counts(), streams

    engine = _engine(True)
    (warm, after, streams), stats = asyncio.run(_run(engine, run))
    assert warm == {"step": len(engine.reachable_token_buckets()), "multi": 2}
    assert after == warm, f"the churn reached programs warmup did not: {warm} -> {after}"
    assert set(warm) <= set(jax_counts)
    assert stats["admissions"] >= 1 and all(toks for toks, _ in streams)


def test_warmup_covers_buckets_past_the_context():
    """A step bucket may hold more tokens than one row's page table
    (bench.py's geometry: 768-token steps at max_model_len 256).  Warmup's
    row takes what its table holds and leaves the rest of the bucket as
    padding; it used to claim the whole bucket and index past the table."""
    engine = TorchEngine(EngineConfig(**dict(CFG, max_model_len=32, prefill_chunk=64)),
                         device="cpu")
    buckets = engine.reachable_token_buckets()
    assert buckets[-1] > engine.cfg.max_model_len
    assert engine.warmup() == {"step": len(buckets), "multi": 2}
    engine.programs.close()


# Each sampler flag keys its own programs: requests using it, served on a
# warmed engine whose greedy programs already exist, must stream as the
# control does.
FLAG_CASES = {
    "penalties": dict(frequency_penalty=0.7, presence_penalty=0.4),
    "sampled": dict(temperature=0.8, seed=3),
    "top-k-top-p": dict(temperature=0.9, top_k=20, top_p=0.8, seed=4),
    "logprobs": dict(logprobs=3),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_each_flag_keys_its_program(case):
    opts = FLAG_CASES[case]

    async def wave(engine, warm):
        if warm:
            await engine.run_warmup()
        jobs = [_one(engine, i, 10 + 3 * i, **(opts if i % 2 == 0 else {})) for i in range(4)]
        items = await asyncio.gather(*jobs)
        if case == "logprobs":  # logprob payloads ride per-token items
            req = PreprocessedRequest(
                token_ids=_prompt(9), stop_conditions=StopConditions(max_tokens=9, ignore_eos=True),
                sampling_options=SamplingOptions(**opts)).to_dict()
            lp = await collect(await engine.generate(Context(req)))
            items.append([it.get("logprobs") for it in lp[:-1]])
        return items, engine.programs.multi.fns.keys() | engine.programs.step.fns.keys()

    (got, keys), _ = asyncio.run(_run(_engine(True), lambda e: wave(e, True)))
    (want, _), _ = asyncio.run(_run(_engine(False), lambda e: wave(e, False)))
    assert got == want
    flag = {"logprobs": 0, "penalties": 1, "sampled": 2, "top-k-top-p": 3}[case]
    multi_keys = [k for k in keys if len(k) == 5]
    assert any(k[flag] for k in multi_keys), multi_keys


# RowSlots and admit_continuous, the port's against the JAX package's.
SCHEDULERS = ["dynamo_tpu.engine", "dynamo_tpu_torch.engine"]


def _sched_mod(pkg):
    return importlib.import_module(f"{pkg}.scheduler")


@pytest.mark.parametrize("pkg", SCHEDULERS)
def test_rowslots_free_list(pkg):
    mod = _sched_mod(pkg)
    tokens = importlib.import_module(pkg.split(".")[0] + ".tokens")
    slots = mod.RowSlots(3)

    def mk(rid):
        return mod.SequenceState(request_id=rid, prompt=[1, 2, 3],
                                 block_seq=tokens.TokenBlockSequence(block_size=4))

    a, b = mk("a"), mk("b")
    assert slots.assign(a) == 0
    assert slots.assign(b) == 1
    assert (slots.num_active, slots.capacity_left) == (2, 1)
    slots.retire(0)
    assert slots.rows[0] is None and slots.num_active == 1
    # Pending counts as capacity but is not assignable before the barrier.
    assert slots.capacity_left == 2
    assert slots.assign(mk("c")) == 2
    slots.free(0)
    assert slots.assign(mk("d")) == 0
    assert (slots.num_active, slots.capacity_left) == (3, 0)
    assert [i for i, _ in slots.active()] == [0, 1, 2]


@pytest.mark.parametrize("pkg", SCHEDULERS)
def test_admit_continuous_compatibility_and_order(pkg):
    mod = _sched_mod(pkg)
    cfg_mod = importlib.import_module(f"{pkg}.config")
    kv_mod = importlib.import_module(f"{pkg}.kv_manager")
    tokens = importlib.import_module(pkg.split(".")[0] + ".tokens")
    cfg = cfg_mod.EngineConfig(**CFG)
    sched = mod.Scheduler(cfg, kv_mod.KvBlockManager(cfg.num_blocks, cfg.block_size))

    def mk(rid, grammar=None, frozen=False):
        seq = mod.SequenceState(request_id=rid, prompt=[1, 2, 3, 4],
                                block_seq=tokens.TokenBlockSequence(block_size=cfg.block_size))
        seq.grammar, seq.frozen = grammar, frozen
        return seq

    s1, s2 = mk("s1"), mk("s2")
    sched.add(s1)
    sched.add(s2)
    assert sched.waiting_head_compatible()
    assert sched.admit_continuous(8) == [s1, s2]
    assert all(s in sched.running and s.block_ids for s in (s1, s2))
    assert len(sched.admission_waits) == 2
    # A grammar-constrained head stops in-loop admission cold.
    g, tail = mk("g", grammar=object()), mk("tail")
    sched.add(g)
    sched.add(tail)
    assert not sched.waiting_head_compatible()
    assert sched.admit_continuous(8) == []
    assert g in sched.waiting and tail in sched.waiting
    # A frozen head is blocked, not admitted.
    sched.waiting.clear()
    sched.add(mk("f", frozen=True))
    assert not sched.waiting_head_compatible()
    assert sched.admit_continuous(8) == []
    # The limit and the batch cap bound what one call admits.
    sched.waiting.clear()
    more = [mk(f"m{i}") for i in range(3)]
    for s in more:
        sched.add(s)
    assert sched.admit_continuous(1) == more[:1]
    assert sched.admit_continuous(8) == more[1:2]  # max_batch 4: two were running
    assert more[2] in sched.waiting


def test_write_barrier_holds_retired_blocks():
    """No block of a retired row is freed while a fused chunk dispatched
    when the row was active is still unharvested."""
    engine = _engine(True)
    dispatched = []  # per chunk: the blocks its active rows may write (below their limits)
    harvested = [0]
    violations, frees_in_session = [], [0]
    run_multi, accept = engine._run_multi, engine._accept_chunk

    def spy_multi(tok0, pos0, tables, limits, samp):
        bs = engine.cfg.block_size
        dispatched.append({int(b) for i in np.nonzero(pos0 >= 0)[0]
                           for b in tables[i][: -(-int(limits[i]) // bs)]})
        return run_multi(tok0, pos0, tables, limits, samp)

    def spy_accept(*args):
        harvested[0] += 1
        return accept(*args)

    free = engine.kv.free_sequence

    def spy_free(block_ids):
        if engine._pipeline_members:
            frees_in_session[0] += 1
        for c in dispatched[harvested[0]:]:
            hit = c & set(block_ids)
            if hit:
                violations.append(sorted(hit))
        return free(block_ids)

    engine._run_multi, engine._accept_chunk, engine.kv.free_sequence = spy_multi, spy_accept, spy_free
    _, stats = asyncio.run(_run(engine, lambda e: _churn(e, 0.9)))
    assert stats["retired"] >= 1 and frees_in_session[0] >= 1, (stats, frees_in_session)
    assert not violations, violations


# --------------------------------------- decode_steps 1: no row sits out
# Four prompts sent together at decode_steps 1, 48 new tokens each, the
# same seed-0 params in both engines.  A row whose token fetch was still in
# flight when the loop planned used to miss the plan: the rows split into
# two groups that took turns, at twice the reference's dispatches.
from test_torch_spec import CFG as SPEC_CFG  # noqa: E402
from test_torch_spec import RANDOM, REPETITIVE  # noqa: E402

SPLIT_CFG = dict(SPEC_CFG, decode_steps=1)
SPLIT_PROMPTS = [REPETITIVE, [7] * 20, [11, 12, 13] * 6, RANDOM]


async def _split_trace(engine):
    async def one(p):
        req = PreprocessedRequest(
            token_ids=list(p), stop_conditions=StopConditions(max_tokens=48, ignore_eos=True),
        ).to_dict()
        items = await collect(await engine.generate(Context(req)))
        return [t for it in items for t in it["token_ids"]]

    try:
        return await asyncio.gather(*(one(p) for p in SPLIT_PROMPTS))
    finally:
        await engine.close()


def _count(engine, *kinds):
    return sum(1 for k, *_ in engine.step_trace if k in kinds)


@pytest.fixture(scope="module")
def jax_split():
    """TpuEngine on the trace, speculation off and on (k 8): streams,
    unified dispatches, verification dispatches."""
    params = jax_init_params(jax_get_config("debug-tiny").with_overrides(dtype="float32"),
                             jax.random.PRNGKey(0))
    out = {}
    for spec in (False, True):
        extra = {"spec_decode": {"enable": True, "k": 8}} if spec else {}
        engine = TpuEngine(JaxEngineConfig(**SPLIT_CFG, **extra), params=params)
        streams = asyncio.run(_split_trace(engine))
        out[spec] = (streams, _count(engine, "unified", "unified_fetch"),
                     _count(engine, "spec_verify"))
    return params, out


@pytest.mark.parametrize("spec", [False, True], ids=["spec-off", "spec-k8"])
def test_decode_steps_1_plans_hold_every_live_row(jax_split, spec):
    params, ref = jax_split
    want, ref_unified, ref_verify = ref[spec]
    tree = jax.tree_util.tree_map(np.asarray, params)
    extra = {"spec_decode": {"enable": True, "k": 8}} if spec else {}
    engine = TorchEngine(EngineConfig(**SPLIT_CFG, **extra),
                         params=params_from_jax(tree, device="cpu"), device="cpu")
    plans = []  # per unified dispatch: (rows planned, live rows, holds prefill)
    run_unified = engine._run_unified

    async def spy(plan):
        live = sum(1 for s in engine.scheduler.running if not s.finished)
        prefill = any(start < len(s.prompt) for s, start, _ in plan.items)
        plans.append((len(plan.items), live, prefill))
        return await run_unified(plan)

    engine._run_unified = spy
    got = asyncio.run(_split_trace(engine))
    print(f"decode_steps 1, {'spec k 8' if spec else 'spec off'}: unified dispatches "
          f"{_count(engine, 'unified', 'unified_fetch')} (TpuEngine {ref_unified}), device "
          f"tokens {sum(n for k, _, _, n in engine.step_trace if k.startswith('unified'))}, "
          f"verification dispatches {_count(engine, 'spec_verify')} (TpuEngine {ref_verify}), "
          f"rows a plan after the last prefill {sorted({n for n, _, _ in plans[-20:]})}")
    assert got == want
    assert all(len(t) == 48 for t in got)
    last_prefill = max(i for i, (_, _, pf) in enumerate(plans) if pf)
    after = plans[last_prefill + 1:]
    assert after and all(n == live for n, live, _ in after), after
    assert _count(engine, "unified", "unified_fetch") <= ref_unified
    assert _count(engine, "spec_verify") <= ref_verify
