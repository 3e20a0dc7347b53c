"""The SLA planner on the port against the JAX package.

Every test of the JAX package's ``tests/test_planner.py`` runs on both
packages: the module's source is loaded twice, once as it is and once with
its ``dynamo_tpu.`` imports pointed at ``dynamo_tpu_torch.``, and each
case is one parametrised test per package (so each still counts).  Then the
two packages are held to identical outcomes on the same inputs: decision
streams, ``SignalSnapshot.to_dict``s, sim reports and trace files from the
same seeds, ``planner_metrics`` renders, the hub writes of
``LocalActuator``, ``KubeActuator``'s CR patches over the JAX package's
``FakeKube``, a ``SignalCollector`` fed the same topics, the planner's
``/metrics`` and ``/state`` bodies byte for byte, and ``python -m
dynamo_tpu_torch.planner sim --smoke`` against the JAX command.
"""

import asyncio
import importlib
import inspect
import json
import os
import re
import subprocess
import sys
import types

import pytest

pytestmark = [pytest.mark.torch_port, pytest.mark.planner]

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_reference_tests(filename, pkg):
    """The JAX package's test module ``filename``, its imports pointed at
    ``pkg`` (``dynamo_tpu.x`` → ``pkg.x``)."""
    path = os.path.join(REPO, "tests", filename)
    src = open(path, encoding="utf-8").read()
    if pkg != JAX:
        src = re.sub(r"\bdynamo_tpu\.", f"{pkg}.", src)
    name = f"_ref_{os.path.splitext(filename)[0]}_{pkg}"
    mod = types.ModuleType(name)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def reference_cases(filename):
    mod = load_reference_tests(filename, JAX)
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and callable(f))


REF = {pkg: load_reference_tests("test_planner.py", pkg) for pkg in PKGS}


async def run_reference_case(mod, name, tmp_path):
    """Run one reference test function with the fixtures it asks for."""
    fn = getattr(mod, name)
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(fn).parameters else {}
    if inspect.iscoroutinefunction(fn):
        await fn(**kwargs)
    else:
        await asyncio.to_thread(fn, **kwargs)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", reference_cases("test_planner.py"))
async def test_reference_planner_case(case, pkg, tmp_path):
    """``tests/test_planner.py::<case>`` on ``pkg``."""
    await run_reference_case(REF[pkg], case, tmp_path)


def P(pkg):
    m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        policy=m("planner.policy"), signals=m("planner.signals"), sim=m("planner.sim"),
        actuate=m("planner.actuate"), pmetrics=m("planner.pmetrics"),
        service=m("planner.service"), hub=m("runtime.transports.hub"),
        component=m("runtime.component"), protocols=m("llm.kv_router.protocols"),
        publisher=m("llm.kv_router.publisher"), scheduler=m("llm.kv_router.scheduler"),
        health=m("runtime.health"), metrics=m("llm.metrics"),
    )


# ----------------------------------------------------------- decision streams


def _snapshots(M, seed):
    """A seeded walk through pool sizes, queues, latencies and KV use."""
    import random

    rng = random.Random(seed)
    snaps = []
    for t in range(120):
        n_p, n_d = rng.randint(1, 4), rng.randint(1, 4)
        snaps.append(M.signals.SignalSnapshot(
            t=float(t),
            pools={
                "prefill": M.signals.PoolStats(
                    workers=tuple(range(n_p)), active_slots=rng.randint(0, 8 * n_p),
                    total_slots=8 * n_p, kv_usage=rng.random()),
                "decode": M.signals.PoolStats(
                    workers=tuple(range(100, 100 + n_d)), queue_depth=rng.randint(0, 20),
                    active_slots=rng.randint(0, 8 * n_d), total_slots=8 * n_d,
                    kv_usage=rng.random(),
                    per_worker_load={100 + i: rng.random() for i in range(n_d)}),
            },
            ttft_p95_ms=rng.choice([None, rng.uniform(100, 6000)]),
            itl_p95_ms=rng.choice([None, rng.uniform(5, 300)]),
            prefill_queue_depth=rng.randint(0, 30),
        ))
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_streams_and_snapshots_match(seed):
    """The same seeded snapshot walk through both ``DecisionEngine``s (at
    the JAX tests' tight bounds): identical decisions, tick by tick, and
    identical ``SignalSnapshot.to_dict`` / ``from_dict`` round trips."""
    out = {}
    for pkg in PKGS:
        M = P(pkg)
        eng = M.policy.DecisionEngine(M.policy.SloTargets(), M.policy.PolicyConfig(
            min_prefill=1, max_prefill=3, min_decode=1, max_decode=3,
            confirm_up_ticks=2, confirm_down_ticks=3, cooldown_ticks=4))
        snaps = _snapshots(M, seed)
        out[pkg] = (
            [eng.decide(s).to_dict() for s in snaps],
            [s.to_dict() for s in snaps],
            [M.signals.SignalSnapshot.from_dict(s.to_dict()).to_dict() for s in snaps],
            eng.state(),
        )
    assert out[PORT] == out[JAX]
    assert any(a["kind"] != "noop" for d in out[PORT][0] for a in d["actions"])


# ------------------------------------------------------------ sim and traces


@pytest.mark.parametrize("kind", ["poisson", "burst", "ramp"])
def test_sim_reports_and_trace_files_match(kind, tmp_path):
    """Seeded traces written by both packages are the same file, each
    package reads the other's, and ``run_sim`` over them gives identical
    tick rows, completions, actuation calls and flip-flop counts, live
    and dry-run."""
    reports = {}
    for pkg in PKGS:
        M = P(pkg)
        trace = M.sim.gen_trace(kind, rate=2.0, duration_s=90.0, seed=11, isl=3000, osl=150,
                                spike_mult=3.0)
        M.sim.write_trace(str(tmp_path / f"{pkg}.jsonl"), trace)
    files = {pkg: (tmp_path / f"{pkg}.jsonl").read_bytes() for pkg in PKGS}
    assert files[PORT] == files[JAX] and files[PORT]
    for pkg in PKGS:
        M = P(pkg)
        other = JAX if pkg == PORT else PORT
        trace = M.sim.read_trace(str(tmp_path / f"{other}.jsonl"))
        for dry in (False, True):
            eng = M.policy.DecisionEngine(M.policy.SloTargets(), M.policy.PolicyConfig())
            rep = M.sim.run_sim(trace, eng, M.sim.SimConfig(n_prefill=1, n_decode=2),
                                dry_run=dry)
            reports[(pkg, dry)] = (rep.ticks, rep.completed, rep.actuation_calls,
                                   rep.flip_flops())
    for dry in (False, True):
        assert reports[(PORT, dry)] == reports[(JAX, dry)]


def test_smoke_scenarios_match():
    """``smoke`` and ``autopilot_smoke``: both pass and say the same thing."""
    for fn in ("smoke", "autopilot_smoke"):
        got = {pkg: getattr(P(pkg).sim, fn)(verbose=True) for pkg in PKGS}
        assert got[PORT] == got[JAX] and got[PORT][0] is True


def test_sim_smoke_command_matches_jax():
    """``python -m dynamo_tpu_torch.planner sim --smoke`` prints what the
    JAX command prints and exits 0, as does a seeded sim run's JSONL."""
    from conftest import hermetic_child_env

    env = hermetic_child_env(REPO) | {"JAX_PLATFORMS": "cpu"}
    outs = {}
    for pkg in PKGS:
        runs = []
        for args in (["sim", "--smoke"],
                     ["sim", "--trace", "burst", "--duration", "60", "--seed", "5"]):
            r = subprocess.run([sys.executable, "-m", f"{pkg}.planner", *args], cwd=REPO,
                               env=env, capture_output=True, text=True, timeout=120)
            runs.append((r.returncode, r.stdout, r.stderr.strip().splitlines()[-1:]))
        outs[pkg] = runs
    assert outs[PORT] == outs[JAX]
    assert outs[PORT][0][0] == 0 and "sim smoke ok" in outs[PORT][0][1]


def test_kube_option_names_its_roadmap_item():
    """``planner run --kube CR`` (once refused, naming ROADMAP queue 1 item
    10.8, which the deploy package closed) starts on each package against
    a live hub with a ``KubeActuator`` over that package's ``KubeApi``,
    announces ``kube:CR`` actuation and stops on SIGTERM with code 0."""
    import signal
    import threading

    from conftest import hermetic_child_env

    hubmod = importlib.import_module(f"{PORT}.runtime.transports.hub")

    async def main():
        hub = await hubmod.HubServer(host="127.0.0.1", port=0).start()
        try:
            out = {}
            for pkg in PKGS:
                proc = subprocess.Popen(
                    [sys.executable, "-m", f"{pkg}.planner", "run", "--hub", hub.address,
                     "--kube", "app", "--dry-run", "--host", "127.0.0.1", "--port", "0"],
                    cwd=REPO, env=hermetic_child_env(REPO), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                lines = []
                reader = threading.Thread(target=lambda p=proc: lines.extend(p.stdout))
                reader.start()
                try:
                    for _ in range(600):
                        if any(ln.startswith("planner on ") for ln in lines):
                            break
                        await asyncio.sleep(0.1)
                    proc.send_signal(signal.SIGTERM)
                    rc = await asyncio.to_thread(proc.wait, 30)
                finally:
                    proc.kill()
                    reader.join(10)
                said = [ln for ln in lines if ln.startswith("planner on ")]
                out[pkg] = (rc, [re.sub(r":\d+/", ":P/", ln) for ln in said])
            assert out[PORT] == out[JAX]
            assert out[PORT][0] == 0
            assert out[PORT][1] and "DRY-RUN, kube:app actuation" in out[PORT][1][0]
        finally:
            await hub.close()

    asyncio.run(main())


# --------------------------------------------------------------- metrics


def test_planner_metrics_renders_match():
    """``planner_metrics`` and ``autopilot_metrics`` after the same
    decisions: the same text and the same state."""
    got = {}
    for pkg in PKGS:
        M = P(pkg)
        pm, am = M.pmetrics.PlannerMetrics(), M.pmetrics.AutopilotMetrics()
        eng = M.policy.DecisionEngine(M.policy.SloTargets(), M.policy.PolicyConfig(
            max_prefill=2, confirm_up_ticks=1, cooldown_ticks=1))
        for s in _snapshots(M, 3)[:40]:
            pm.record_decision(eng.decide(s))
        for policy in ("prefix_warming", "measured_routing", "prefix_warming"):
            am.record_decision(policy)
            am.record_suppression(policy)
        am.record_cooldown_skip("drift_retune")
        got[pkg] = (pm.render(), pm.render("x"), pm.state_json(), am.render(), am.state())
    assert got[PORT] == got[JAX]


async def test_planner_http_bodies_match():
    """``PlannerHttp``'s ``/metrics`` and ``/state`` over the port's
    standard-library server against the JAX package's aiohttp server:
    statuses, content types and bodies byte for byte, and 404 for an
    unknown path."""
    from aiohttp import ClientSession

    bodies = {}
    for pkg in PKGS:
        M = P(pkg)
        M.pmetrics.metrics.reset()
        M.pmetrics.autopilot_metrics.reset()

        class Static:
            def __init__(self):
                self.snaps = iter(_snapshots(M, 4))

            async def snapshot(self):
                return next(self.snaps)

        eng = M.policy.DecisionEngine(M.policy.SloTargets(), M.policy.PolicyConfig(
            max_prefill=2, confirm_up_ticks=1))
        planner = M.service.Planner(Static(), eng, M.actuate.RecordingActuator())
        for _ in range(10):
            await planner.tick()
        http = await M.service.PlannerHttp(planner, host="127.0.0.1", port=0).start()
        try:
            got = []
            async with ClientSession() as s:
                for path in ("/metrics", "/state", "/nope"):
                    async with s.get(f"http://127.0.0.1:{http.port}{path}") as r:
                        got.append((r.status, r.headers.get("Content-Type"), await r.read()))
            bodies[pkg] = got
        finally:
            await http.stop()
            M.pmetrics.metrics.reset()
    assert bodies[PORT] == bodies[JAX]
    assert json.loads(bodies[PORT][1][2])["ticks"] == 10


# ---------------------------------------------------------------- actuation


def _decisions(M):
    pol = M.policy
    return [
        pol.Decision(tick=1, actions=[pol.scale_prefill(1, 3, "queue")], pressures={}),
        pol.Decision(tick=2, actions=[pol.flip_role(42, pol.PREFILL, "ratio")], pressures={}),
        pol.Decision(tick=3, actions=[pol.scale_decode(-1, 1, "cold"),
                                      pol.flip_role(7, pol.DECODE, "back")], pressures={}),
        pol.Decision(tick=4, actions=[pol.noop("in-band")], pressures={}),
    ]


async def test_local_actuator_hub_writes_match():
    """The same decisions through each package's ``LocalActuator`` onto an
    in-process hub: the same keys and values, in the same order, and
    autopilot directives alike."""
    writes = {}
    for pkg in PKGS:
        M = P(pkg)
        ap = importlib.import_module(f"{pkg}.planner.autopilot")
        hub = await M.hub.InprocHub().start()
        try:
            watcher = await hub.watch_prefix("planner/")
            decisions = _decisions(M) + [M.policy.Decision(tick=5, actions=[
                ap.kv_prefetch(8, persist=True, reason="warm"),
                ap.set_tier_weights({"hbm": 1.0, "host": 0.4}, reason="meas"),
                ap.migrate_out(7, p95_ms=800.0, reason="outlier"),
                ap.tune_decode({"knob": "decode_burst"}, reason="gap")], pressures={})]
            for d in decisions:
                await M.actuate.LocalActuator(hub).apply(d)
            seen = []
            while len(seen) < 8:
                ev = await asyncio.wait_for(watcher.__anext__(), 5)
                seen.append((ev.type, ev.key, ev.value))
            writes[pkg] = (seen, await hub.kv_get_prefix("planner/"))
            await watcher.aclose()
        finally:
            await hub.close()
    assert writes[PORT] == writes[JAX]


async def test_kube_actuator_patches_fake_kube_alike():
    """``KubeActuator`` of both packages over the JAX package's
    ``FakeKube`` (the port keeps its own copy of the CR's group and kind):
    the same applied manifests for targets and flips, and none for a
    missing CR or service."""
    from dynamo_tpu.deploy.controller import FakeKube

    cr = {"apiVersion": "dynamo.tpu.io/v1alpha1", "kind": "DynamoTpuDeployment",
          "metadata": {"name": "app", "namespace": "ns1"},
          "spec": {"services": {"prefill": {"replicas": 1}, "decode": {"replicas": 2}}}}
    got = {}
    for pkg in PKGS:
        M = P(pkg)
        kube = FakeKube()
        kube.objects[("DynamoTpuDeployment", "app")] = json.loads(json.dumps(cr))
        for d in _decisions(M):
            await M.actuate.KubeActuator(kube, "app").apply(d)
        await M.actuate.KubeActuator(kube, "missing").apply(_decisions(M)[0])
        await M.actuate.KubeActuator(kube, "app", {"prefill": "pf"}).apply(_decisions(M)[0])
        got[pkg] = (kube.applied, kube.objects)
    assert got[PORT] == got[JAX]
    assert got[PORT][1][("DynamoTpuDeployment", "app")]["spec"]["services"] == {
        "prefill": {"replicas": 3}, "decode": {"replicas": 2}}
    assert P(PORT).actuate.GROUP == importlib.import_module(f"{JAX}.deploy.controller").GROUP


# ------------------------------------------------------------ signal plane


async def test_signal_collectors_on_one_hub_agree():
    """A port and a JAX ``SignalCollector`` on one hub, fed the same
    discovery keys, ``kv_metrics`` from a port and a JAX worker's
    ``KvMetricsPublisher``, hit-rate events, both edges'
    ``EdgeSloPublisher`` over their ``Metrics`` (the same samples) and a
    quarantine marker: equal snapshots and worker views, and the same after
    a worker's instance is deleted and after the reports go stale."""
    Mp, Mj = P(PORT), P(JAX)
    hub = await Mp.hub.HubServer().start()
    rts = {pkg: await P(pkg).component.DistributedRuntime.connect(hub.address)
           for pkg in PKGS}
    now = [0.0]
    cols = {}
    try:
        for pkg in PKGS:
            comp = rts[pkg].namespace("plan").component("TorchWorker")
            cols[pkg] = await P(pkg).signals.SignalCollector(
                comp, model="m", clock=lambda: now[0]).start()
        ik = Mp.component.instance_key
        hubc = rts[PORT].hub
        await hubc.kv_put(ik("plan", "TorchWorker", "generate", 1), {"metadata": {"role": "decode"}})
        await hubc.kv_put(ik("plan", "TorchWorker", "prefill", 2), {"metadata": {"role": "prefill"}})
        await hubc.kv_put(ik("plan", "TorchWorker", "generate", 3), {})
        await hubc.kv_put(ik("plan", "TorchWorker", "generate", 4), {})
        for pkg, wid in ((PORT, 1), (JAX, 3), (PORT, 4)):
            M = P(pkg)
            comp = rts[pkg].namespace("plan").component("TorchWorker")
            fpm = M.protocols.ForwardPassMetrics(
                request_active_slots=wid, request_total_slots=8, num_requests_waiting=wid % 3,
                gpu_cache_usage_perc=0.1 * wid)
            await M.publisher.KvMetricsPublisher(comp, wid, lambda f=fpm: f).publish_once()
            await comp.publish(M.scheduler.KV_HIT_RATE_SUBJECT,
                               {"worker_id": wid, "isl_blocks": 10 * wid, "overlap_blocks": wid})
        for pkg, (ttft, itl) in ((JAX, (1.8, 0.04)), (PORT, (0.9, 0.055))):
            M = P(pkg)
            m = M.metrics.Metrics()
            ttft_w, itl_w = m.window("m", "completions")
            for k in range(20):
                ttft_w.observe(ttft * (1 + k / 100))
                itl_w.observe(itl * (1 + k / 100))
            await M.signals.EdgeSloPublisher(rts[pkg].namespace("plan"), m,
                                             edge_id=f"e-{pkg}").publish_once()
        await hubc.kv_put(Mp.health.QUARANTINE_PREFIX + "4", {"state": "quarantined"})
        await asyncio.sleep(0.3)
        snaps = {pkg: (await cols[pkg].snapshot()).to_dict() for pkg in PKGS}
        views = {pkg: cols[pkg].worker_slo_view() for pkg in PKGS}
        assert snaps[PORT] == snaps[JAX] and views[PORT] == views[JAX]
        assert snaps[PORT]["pools"]["decode"]["workers"] == [1, 3]
        assert snaps[PORT]["ttft_p95_ms"] == pytest.approx(1800 * 1.19)
        await hubc.kv_delete(ik("plan", "TorchWorker", "generate", 1))
        await asyncio.sleep(0.2)
        now[0] = 5.0
        snaps = {pkg: (await cols[pkg].snapshot()).to_dict() for pkg in PKGS}
        assert snaps[PORT] == snaps[JAX]
        assert snaps[PORT]["pools"]["decode"]["workers"] == [3]
        now[0] = 60.0
        snaps = {pkg: (await cols[pkg].snapshot()).to_dict() for pkg in PKGS}
        assert snaps[PORT] == snaps[JAX] and "ttft_p95_ms" not in snaps[PORT]
    finally:
        for col in cols.values():
            await col.stop()
        for rt in rts.values():
            await rt.close()
        await hub.close()
