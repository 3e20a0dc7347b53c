"""The SLO autopilot on the port against the JAX package.

Every test of the JAX package's ``tests/test_autopilot.py`` runs on both
packages (its source loaded once as it is and once with its imports
pointed at ``dynamo_tpu_torch.``), one parametrised case per package.
Then the two are held to identical outcomes: ``Autopilot`` decision
streams, state surfaces and ``autopilot_metrics`` renders over the same
seeded snapshots (with a per-worker latency view), the autopilot sim
report, and ``PlannerDirectiveWatcher``'s enactments on a real
``KvRouterCore`` over each package's hub (the router's tier table and
the prefetch it publishes).
"""

import asyncio
import importlib
import random
import types

import pytest

from test_torch_planner import JAX, PKGS, PORT, load_reference_tests, reference_cases
from test_torch_planner import run_reference_case

pytestmark = [pytest.mark.torch_port, pytest.mark.planner]

REF = {pkg: load_reference_tests("test_autopilot.py", pkg) for pkg in PKGS}


@pytest.fixture(autouse=True)
def _reset_autopilot_metrics():
    for pkg in PKGS:
        importlib.import_module(f"{pkg}.planner.pmetrics").autopilot_metrics.reset()
    yield
    for pkg in PKGS:
        importlib.import_module(f"{pkg}.planner.pmetrics").autopilot_metrics.reset()


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", reference_cases("test_autopilot.py"))
async def test_reference_autopilot_case(case, pkg, tmp_path):
    """``tests/test_autopilot.py::<case>`` on ``pkg``."""
    await run_reference_case(REF[pkg], case, tmp_path)


def A(pkg):
    m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        ap=m("planner.autopilot"), policy=m("planner.policy"), signals=m("planner.signals"),
        pmetrics=m("planner.pmetrics"), sim=m("planner.sim"), actuate=m("planner.actuate"),
        router=m("llm.kv_router.router"), hub=m("runtime.transports.hub"),
        component=m("runtime.component"),
    )


def _walk(M, seed):
    """Seeded snapshots exercising every policy: hit-rate sags, measured
    restore percentiles, host-gap drift and KV pressure."""
    rng = random.Random(seed)
    out = []
    for t in range(150):
        hot = 40 <= t < 80
        out.append(M.signals.SignalSnapshot(
            t=float(t),
            pools={"prefill": M.signals.PoolStats(workers=(0, 1), total_slots=2000),
                   "decode": M.signals.PoolStats(
                       workers=tuple(range(100, 103)), total_slots=24,
                       kv_usage=rng.uniform(0.5, 0.95) if hot else rng.uniform(0, 0.4))},
            ttft_p95_ms=rng.uniform(500, 4000),
            itl_p95_ms=rng.uniform(20, 200),
            fleet_prefix_hit_rate=rng.choice([None, rng.uniform(0.05, 0.9)]),
            restore_pct=rng.choice([None, {"restore_p95_ms": rng.uniform(1, 30),
                                           "pull_p95_ms": rng.uniform(5, 90)}]),
            host_gap=rng.choice([None, rng.uniform(0.0, 0.6)]),
        ))
    return out


def _worker_view(seed):
    rng = random.Random(seed)
    views = []
    for t in range(150):
        views.append({w: {"itl_p50_ms": rng.uniform(10, 40) * (6 if w == 101 and t > 60 else 1),
                          "ttft_p50_ms": rng.uniform(100, 300), "n": rng.randint(0, 30)}
                      for w in (100, 101, 102)})
    return views


@pytest.mark.parametrize("seed", [0, 1])
def test_autopilot_decision_streams_match(seed):
    """The same snapshot walk and per-worker view through both
    ``Autopilot``s: identical decisions (directives and their params),
    state surfaces and ``autopilot_metrics`` renders."""
    got = {}
    for pkg in PKGS:
        M = A(pkg)
        M.pmetrics.autopilot_metrics.reset()
        views = iter(_worker_view(seed))
        eng = M.policy.DecisionEngine(M.policy.SloTargets(), M.policy.PolicyConfig(
            min_prefill=1, max_prefill=4, min_decode=1, max_decode=6,
            confirm_up_ticks=2, confirm_down_ticks=3, cooldown_ticks=4))
        pilot = M.ap.Autopilot(eng, M.ap.AutopilotConfig(), worker_view=lambda: next(views))
        decisions = [pilot.decide(s).to_dict() for s in _walk(M, seed)]
        got[pkg] = (decisions, pilot.state(), M.pmetrics.autopilot_metrics.render())
    assert got[PORT] == got[JAX]
    kinds = {a["kind"] for d in got[PORT][0] for a in d["actions"]}
    assert kinds - {"noop", "scale_prefill", "scale_decode", "flip_role"}, kinds


def test_autopilot_sim_reports_match():
    """``autopilot_smoke``'s scenario report, field for field."""
    got = {pkg: A(pkg).sim.autopilot_smoke(verbose=True) for pkg in PKGS}
    assert got[PORT] == got[JAX] and got[PORT][0]


async def test_directive_watcher_enacts_on_a_router_core_alike():
    """``set_tier_weights`` and ``kv_prefetch`` directives written by each
    package's ``LocalActuator`` onto its own hub, enacted by its
    ``PlannerDirectiveWatcher`` over a real ``KvRouterCore``: the same
    tier tables and the same prefetch publications (kinds and params), and
    the standing slot replayed by a watcher started afterwards."""
    got = {}
    for pkg in PKGS:
        M = A(pkg)
        hub = await M.hub.HubServer().start()
        rt = await M.component.DistributedRuntime.connect(hub.address)
        try:
            ep = rt.namespace("ap").component("w").endpoint("generate")
            core = await M.router.make_kv_router(ep, 4)
            prefetch = await rt.namespace("ap").component("w").subscribe("kv_prefetch")
            watcher = await M.router.PlannerDirectiveWatcher(rt.hub, core).start()
            core.hot_chains.record([11, 12, 13])
            await M.actuate.LocalActuator(rt.hub).apply(M.policy.Decision(tick=3, actions=[
                M.ap.set_tier_weights({"hbm": 1.0, "host": 0.3, "disk": 0.2, "objstore": 0.1},
                                      reason="measured"),
                M.ap.kv_prefetch(2, persist=True, reason="warm"),
                M.ap.tune_decode({"knob": "decode_steps"}, reason="gap")], pressures={}))
            for _ in range(200):
                if watcher.applied >= 2:
                    break
                await asyncio.sleep(0.02)
            payload = {}
            while not payload.get("persist"):  # the publisher's own cadence may come first
                _, payload = await asyncio.wait_for(prefetch.__anext__(), 5)
            index = getattr(core.indexer, "_index", core.indexer)
            late = await M.router.PlannerDirectiveWatcher(rt.hub, core).start()
            for _ in range(200):
                if late.applied >= 2:
                    break
                await asyncio.sleep(0.02)
            got[pkg] = (watcher.applied, dict(index.tier_weights), late.applied,
                        payload)
            for w in (watcher, late):
                await w.stop()
            await prefetch.aclose()
            await core.stop()
        finally:
            await rt.close()
            await hub.close()
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == 2 and got[PORT][1]["host"] == 0.3
