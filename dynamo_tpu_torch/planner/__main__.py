"""``python -m dynamo_tpu_torch.planner`` — run the planner or its simulator.
A copy of the JAX package's ``planner/__main__.py``.

  planner run --hub H:P [--namespace dynamo] [--component TpuWorker]
              [--model NAME] [--interval 2.0] [--dry-run] [--autopilot]
              [--kube CR_NAME [--k8s-namespace default]] [--port 9092]
  planner sim [--trace poisson|burst|ramp | --trace-file F.jsonl]
              [--rate 2.0] [--duration 120] [--seed 7] [--dry-run]
              [--out report.jsonl] [--smoke]
  planner supervise --hub H:P --spawn-decode CMD [--spawn-prefill CMD]
              [--resync 5.0]   # enact planner/targets/* without kube

SLO targets and policy bounds come from the layered config's ``planner``
section (runtime/config.py: ``DYN_PLANNER__TTFT_P95_MS=1500`` etc.),
overridable by the flags below.  ``run --kube CR_NAME`` actuates through
the CR's replica counts with the deploy package's ``KubeApi``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys
from typing import Optional

from .policy import DecisionEngine, PolicyConfig, SloTargets
from .sim import (
    SimConfig,
    autopilot_smoke,
    gen_trace,
    read_trace,
    run_sim,
    smoke,
    write_trace,
)


def _engine_from_config(args) -> DecisionEngine:
    from ..runtime.config import RuntimeConfig

    section = dict(RuntimeConfig.from_layers().planner)
    for name in ("ttft_p95_ms", "itl_p95_ms", "kv_headroom"):
        val = getattr(args, f"slo_{name}", None)
        if val is not None:
            section[name] = val
    return DecisionEngine(
        SloTargets.from_dict(section), PolicyConfig.from_dict(section)
    )


async def _run(args) -> None:
    from ..runtime.component import DistributedRuntime
    from .actuate import KubeActuator, LocalActuator
    from .service import Planner, PlannerHttp
    from .signals import SignalCollector

    runtime = await DistributedRuntime.connect(args.hub)
    component = runtime.namespace(args.namespace).component(args.component)
    collector = await SignalCollector(
        component, model=args.model, stale_after_s=args.stale_after_s
    ).start()
    if args.kube:
        from ..deploy.controller import KubeApi

        actuator = KubeActuator(
            KubeApi(namespace=args.k8s_namespace), cr_name=args.kube
        )
    else:
        actuator = LocalActuator(runtime.hub)
    engine = _engine_from_config(args)
    if args.autopilot:
        from .autopilot import Autopilot

        engine = Autopilot(engine, worker_view=collector.worker_slo_view)
    planner = await Planner(
        collector,
        engine,
        actuator,
        interval_s=args.interval,
        dry_run=args.dry_run,
    ).start()
    http = await PlannerHttp(planner, host=args.host, port=args.port).start()
    print(
        f"planner on http://{args.host}:{http.port}/metrics "
        f"({'DRY-RUN' if args.dry_run else 'live'}, "
        f"{'kube:' + args.kube if args.kube else 'local'} actuation)",
        flush=True,
    )
    try:
        await _wait_for_signal()
    finally:
        await http.stop()
        await planner.stop()
        await collector.stop()
        if args.kube:
            await actuator.kube.close()
        await runtime.close()


async def _supervise(args) -> None:
    from ..runtime.transports.hub import HubClient
    from .supervisor import ProcessWorkerPool, Supervisor

    templates = {}
    if args.spawn_decode:
        templates["decode"] = args.spawn_decode
    if args.spawn_prefill:
        templates["prefill"] = args.spawn_prefill
    if not templates:
        raise SystemExit("supervise needs --spawn-decode and/or --spawn-prefill")
    pool = ProcessWorkerPool(templates, term_grace_s=args.term_grace_s)
    hub = await HubClient(args.hub).connect()
    sup = await Supervisor(
        hub, pool.spawn, pool.stop,
        pools=sorted(templates), resync_s=args.resync,
    ).start()
    print(
        f"supervisor enacting {sorted(templates)} targets from the hub "
        "(SIGTERM stops workers — they migrate sequences out themselves)",
        flush=True,
    )
    try:
        await _wait_for_signal()
    finally:
        await sup.stop()
        await sup.shutdown_workers()
        await hub.close()


async def _wait_for_signal() -> None:
    # SIGTERM must unwind through the finally blocks above — supervise's
    # shutdown_workers in particular; the default signal action would kill
    # the process with its worker subprocesses still running, and a
    # restarted supervisor's empty ledger would spawn a second fleet on
    # top of the orphans.
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()


def _sim(args) -> int:
    if args.smoke:
        ok, summary = smoke(verbose=args.verbose)
        print(summary, flush=True)
        ap_ok, ap_summary = autopilot_smoke(verbose=args.verbose)
        print(ap_summary, flush=True)
        return 0 if ok and ap_ok else 1
    if args.trace_file:
        trace = read_trace(args.trace_file)
    else:
        trace = gen_trace(
            args.trace,
            rate=args.rate,
            duration_s=args.duration,
            seed=args.seed,
            isl=args.isl,
            osl=args.osl,
            spike_mult=args.spike_mult,
        )
    if args.trace_out:
        write_trace(args.trace_out, trace)
    engine = _engine_from_config(args)
    report = run_sim(
        trace,
        engine,
        SimConfig(n_prefill=args.n_prefill, n_decode=args.n_decode),
        dry_run=args.dry_run,
    )
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        for row in report.ticks:
            out.write(json.dumps(row) + "\n")
    finally:
        if args.out:
            out.close()
    print(
        f"sim: {len(report.ticks)} ticks, completed={report.completed}, "
        f"actuations={report.actuation_calls}, "
        f"flip_flops={report.flip_flops()}"
        + (" [dry-run]" if args.dry_run else ""),
        file=sys.stderr,
    )
    return 0


def _add_slo_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--slo-ttft-p95-ms", type=float, default=None,
                   dest="slo_ttft_p95_ms")
    p.add_argument("--slo-itl-p95-ms", type=float, default=None,
                   dest="slo_itl_p95_ms")
    p.add_argument("--slo-kv-headroom", type=float, default=None,
                   dest="slo_kv_headroom")
    p.add_argument("--dry-run", action="store_true", dest="dry_run",
                   help="compute + log decisions; never actuate")


def main(argv: Optional[list] = None) -> int:
    from ..runtime.logging_config import setup_logging

    setup_logging()
    parser = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.planner")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run the planner against a hub")
    p_run.add_argument("--hub", required=True)
    p_run.add_argument("--namespace", default="dynamo")
    p_run.add_argument("--component", default="TpuWorker")
    p_run.add_argument("--model", default=None,
                       help="model name (enables prefill queue-depth probe)")
    p_run.add_argument("--interval", type=float, default=2.0)
    p_run.add_argument("--stale-after-s", type=float, default=10.0,
                       dest="stale_after_s")
    p_run.add_argument("--kube", default=None, metavar="CR_NAME",
                       help="actuate by patching this DynamoTpuDeployment CR")
    p_run.add_argument("--k8s-namespace", default="default",
                       dest="k8s_namespace")
    p_run.add_argument("--host", default="0.0.0.0")
    p_run.add_argument("--port", type=int, default=9092)
    p_run.add_argument("--autopilot", action="store_true",
                       help="wrap the engine in the SLO autopilot "
                       "(warming / measured routing / victim / retune "
                       "policies; docs/autopilot.md)")
    _add_slo_flags(p_run)

    p_sim = sub.add_parser("sim", help="deterministic policy simulator")
    p_sim.add_argument("--trace", default="burst", choices=["poisson", "burst", "ramp"])
    p_sim.add_argument("--trace-file", default=None, dest="trace_file",
                       help="replay an arrival-trace JSONL (loadgen format)")
    p_sim.add_argument("--trace-out", default=None, dest="trace_out",
                       help="also write the generated trace here (JSONL)")
    p_sim.add_argument("--rate", type=float, default=2.0, help="req/s baseline")
    p_sim.add_argument("--duration", type=float, default=120.0)
    p_sim.add_argument("--seed", type=int, default=7)
    p_sim.add_argument("--isl", type=int, default=3000)
    p_sim.add_argument("--osl", type=int, default=150)
    p_sim.add_argument("--spike-mult", type=float, default=3.0, dest="spike_mult")
    p_sim.add_argument("--n-prefill", type=int, default=1, dest="n_prefill")
    p_sim.add_argument("--n-decode", type=int, default=2, dest="n_decode")
    p_sim.add_argument("--out", default=None, help="write per-tick JSONL here")
    p_sim.add_argument("--smoke", action="store_true",
                       help="run the CI acceptance scenario; exit 1 on failure")
    p_sim.add_argument("--verbose", action="store_true")
    _add_slo_flags(p_sim)

    p_sup = sub.add_parser(
        "supervise",
        help="hub-native supervisor: spawn/stop local workers to match "
        "planner/targets/* (non-kube deployments)",
    )
    p_sup.add_argument("--hub", required=True)
    p_sup.add_argument("--spawn-decode", default=None, dest="spawn_decode",
                       help="shell command that starts one decode worker")
    p_sup.add_argument("--spawn-prefill", default=None, dest="spawn_prefill",
                       help="shell command that starts one prefill worker")
    p_sup.add_argument("--resync", type=float, default=5.0,
                       help="periodic target-resync interval (s)")
    p_sup.add_argument("--term-grace-s", type=float, default=15.0,
                       dest="term_grace_s",
                       help="SIGTERM→SIGKILL grace for stopped workers")

    args = parser.parse_args(argv)
    if args.cmd == "sim":
        return _sim(args)
    try:
        asyncio.run(_supervise(args) if args.cmd == "supervise" else _run(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
