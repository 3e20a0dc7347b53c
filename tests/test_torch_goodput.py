"""The port's chaos ladder (``dynamo_tpu_torch/tools/goodput.py``) against
the JAX package's ``benchmarks/goodput.py``: the same rungs, and the
port's whole ladder on debug-tiny ``TorchEngine`` workers held to the JAX
ladder's own ``check_report``.

L4 (the storm) is held apart: it crashes two of the three workers while
the watchdog may eject the straggler worker, which can leave the fleet
empty for a while in the reference as well, so a request that arrives
then fails with ``NoInstancesError``.  The test holds that every L4 drop
is that error, which is raised before a stream's first token; a stream
lost mid-way would fail with another."""

import asyncio

import pytest

from benchmarks import goodput as jax_goodput
from dynamo_tpu_torch.tools import fault_matrix, goodput

pytestmark = pytest.mark.torch_port

LEVELS = "0,1,2,3,4,5,6,7,8,9,10"


def _rung_view(rungs):
    return [{**{k: v for k, v in r.items() if k != "events"},
             "events": [ev.to_dict() for ev in r["events"]]} for r in rungs]


def test_ladder_rungs_equal_jax():
    assert _rung_view(goodput.ladder_rungs()) == _rung_view(jax_goodput.ladder_rungs())
    for name in ("REPORT_SCHEMA", "ENGINE_CFG", "TENANTS", "FLOOD_BASE", "CORRUPT_BASE",
                 "OBJSTORE_BASE", "UNSEEDED_EVERY", "STORM_PROMPTS"):
        assert getattr(goodput, name) == getattr(jax_goodput, name), name
    for i in (0, 2, 7, 100_001, 200_003):
        assert goodput._request_dict(i, 12, 8, 7) == jax_goodput._request_dict(i, 12, 8, 7)


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """The whole ladder once on the CPU, cross-checked against the port's
    fault matrix."""
    tmp = tmp_path_factory.mktemp("ladder")
    fm = tmp / "fm.json"
    assert fault_matrix.main(["--engine", "--device", "cpu", "--json", str(fm)]) == 0
    args = goodput.parser().parse_args(
        ["--levels", LEVELS, "--device", "cpu", "--workdir", str(tmp), "--fault-matrix", str(fm)])
    return asyncio.run(goodput.run_ladder(args))


def test_port_ladder_passes_the_jax_check_report(ladder):
    rungs = [r for r in ladder["rungs"] if r["level"] != 4]
    assert [r["level"] for r in rungs] == [0, 1, 2, 3, 5, 6, 7, 8, 9, 10]
    assert jax_goodput.check_report(dict(ladder, rungs=rungs)) == []
    for r in rungs:
        assert r["dropped"] == 0, (r["name"], r["dropped_errors"])
        assert r["completed"] == r["requests"] > 0
    assert ladder["schema"] == jax_goodput.REPORT_SCHEMA
    # the rungs' bars really ran
    by = {r["level"]: r for r in rungs}
    assert by[0]["tracing"]["assembled"] == by[0]["tracing"]["sampled"] > 0
    assert by[5]["resilience"]["respawns"] >= 1
    assert by[7]["integrity"]["detected"] >= by[7]["integrity"]["fired"] >= 1
    assert by[8]["resilience"]["shard_failovers"] >= 1
    assert by[9]["bulk"]["resumes"] >= 1 and by[9]["bulk"]["fallbacks"] >= 1
    assert by[10]["objstore"]["byte_identical"] and by[10]["objstore"]["skip_frac"] >= 0.9


def test_l4_drops_only_before_a_first_token(ladder):
    (l4,) = [r for r in ladder["rungs"] if r["level"] == 4]
    assert set(l4["dropped_errors"]) <= {"NoInstancesError"}, l4["dropped_errors"]
    assert l4["completed"] + l4["dropped"] == l4["requests"]
    # every completed L4 stream equals its L0 control
    control = {i: h for i, s, _, h in ladder["rungs"][0]["deterministic"]["outcomes"] if s == "ok"}
    for i, status, _, token_hash in l4["deterministic"]["outcomes"]:
        if status == "ok" and i in control:
            assert token_hash == control[i], i


def test_fault_matrix_cross_check(ladder):
    cross = ladder["fault_matrix"]
    assert cross["unswept_used_kinds"] == []
    used = {ev["kind"] for r in ladder["rungs"] for ev in r["faults"]}
    assert used - {"hub_outage"} <= set(cross["swept_kinds"])


def test_ladder_without_cuda_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    args = goodput.parser().parse_args(["--levels", "0", "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(goodput.run_ladder(args))


def test_objstore_driver_adds_up_persisted_blocks():
    """L10's driver persists a chain that reaches the host tier over
    several pump cycles over several ``persist_hashes`` calls, each
    storing only what the object tier lacks: the count is their sum."""
    import time
    from types import SimpleNamespace

    class Engine:
        cfg = SimpleNamespace(block_size=4)

        def __init__(self):
            self.calls = [5, 0, 4, 1]

        async def generate(self, ctx):
            async def items():
                yield {"token_ids": [1, 2, 3, 4]}
            return items()

        async def drain_offload(self):
            return None

        async def persist_hashes(self, chain):
            assert len(chain) == 10
            return self.calls.pop(0) if self.calls else 0

    victim = SimpleNamespace(engine=Engine(), closed=False)
    fleet = SimpleNamespace(workers=[victim])
    ev = goodput.FaultEvent("worker_crash", at=0.35, worker=0, count=1)
    # a trace that ended long ago: the driver returns once the chain is
    # persisted, without waiting for a crash
    stats = asyncio.run(goodput._drive_objstore(
        fleet, ev, time.monotonic() - 100.0, duration=1.0, seed=7, extra_engines=[]))
    # 5 + 0 + 4 reaches the bar (all of the 10 blocks but one): no fourth call
    assert stats["persisted"] == 9 and victim.engine.calls == [1]
    assert stats["prompt_blocks"] == 10 and not stats["crashed"]
