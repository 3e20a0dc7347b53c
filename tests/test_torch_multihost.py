"""The port's step plane and multi-rank serving (``engine/multihost.py``, the
engine's publisher and ``mirror_step``, ``run --tp/--nnodes``, the
renderer's multi-host workers) against the JAX package, mirroring
``tests/test_multihost.py``.  Ranks are gloo processes on the CPU, every
wait bounded.

- Step plane: two ranks at ``tp 2`` on two nodes (``nnodes 2``), the
  leader serving and the follower replaying, stream the JAX ``TpuEngine``
  at tp 2's tokens for a greedy row and a seeded, penalized sampled row;
  the host tier (each rank its slice) restores an evicted prefix to the
  same stream; a KV import reaches the follower (its heads of the
  payload); the export refuses; each rank's carry equals the leader's,
  and its pages equal its head slice of a one-rank engine's after the
  same requests.  Under W8A8, int8 pages at calibrated scales and
  speculation, the streams are JAX's ``TpuEngine`` at tp 2's and a
  one-rank engine's, the scales JAX's within the calibration tolerance
  and the one-rank engine's exactly.
- The wildcard bind without ``DYN_STEP_TOKEN`` is refused.
- CLI: the ``run`` parsers flag by flag (the only gaps are the JAX kernel
  selectors, ROADMAP item 8); ``run in=http out=torch --tp 2 --device cpu``
  and the two-command ``--nnodes 2`` form serve the texts and usage of the
  JAX ``run … --tp 2 --cpu-devices 2`` on one checkpoint; every rank
  process exits with its leader, killed or closed; ``TorchWorker``'s
  ``tp: 2`` starts its rank as ``run`` does.
- The renderer's multi-host StatefulSet equals the JAX one after the
  documented substitutions.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_parallel import (  # noqa: E402
    RANK_ENV, REPO, free_port, rank_main, run_ranks,
)

ENGINE = dict(model="debug-tiny", block_size=4, num_blocks=24, max_batch=4, max_model_len=128,
              prefill_chunk=16, dtype="float32", decode_steps=4)
TIERS = dict(host_cache_bytes=1 << 20, host_offload_interval=3600.0)
GREEDY = ([(i * 7 + 3) % 250 + 1 for i in range(21)], {"temperature": 0.0})
SAMPLED = ([(i * 5 + 2) % 250 + 1 for i in range(13)],
           {"temperature": 0.8, "seed": 7, "frequency_penalty": 0.5, "presence_penalty": 0.2})
FLOOD = [[(i * 3 + j) % 250 + 1 for i in range(30)] for j in range(4)]
IMPORTED = [(i * 11 + 1) % 250 + 1 for i in range(17)]
MAX_TOKENS = 12


def _request(prompt, sampling):
    return {"token_ids": prompt, "stop_conditions": {"max_tokens": MAX_TOKENS, "ignore_eos": True},
            "sampling_options": sampling}


async def _gen(engine, context_cls, prompt, sampling):
    out = []
    async for item in await engine.generate(context_cls(_request(prompt, sampling))):
        out += item.get("token_ids", [])
    return out


async def _serve_sequence(engine, payload):
    """The requests every engine of the step-plane test serves, in order."""
    from dynamo_tpu_torch.runtime.engine import Context

    got = {"greedy": await _gen(engine, Context, *GREEDY),
           "sampled": await _gen(engine, Context, *SAMPLED)}
    while await engine.drain_offload():
        pass
    for prompt in FLOOD:  # evicts the greedy prompt's blocks from the pages
        await _gen(engine, Context, prompt, {"temperature": 0.0})
    got["restored"] = await _gen(engine, Context, *GREEDY)
    got["restored_blocks"] = engine.host_kv.restored_blocks
    got["covered"] = await engine.inject_blocks(IMPORTED, payload)
    hits = engine.kv.matched_blocks
    got["imported"] = await _gen(engine, Context, IMPORTED, {"temperature": 0.0})
    got["import_hits"] = engine.kv.matched_blocks - hits
    return got


def _job_step_plane(state, inputs):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.multihost import StepPublisher, follower_serve
    from dynamo_tpu_torch.models.llama import params_from_jax

    os.environ["DYN_STEP_TOKEN"] = "multihost-test"
    engine = TorchEngine(EngineConfig(**ENGINE, **TIERS, tp=2),
                         params=params_from_jax(inputs["tree"], device="cpu"), device="cpu",
                         shard=state)

    async def leader():
        engine.attach_publisher(
            await StepPublisher("127.0.0.1", inputs["step_port"], 1).start(60))
        got = await _serve_sequence(engine, inputs["payload"])
        got["export"] = await engine.export_prompt_blocks(GREEDY[0])
        got["disk"] = engine.disk_kv
        await engine.close()
        return got

    async def follower():
        await follower_serve(engine, f"127.0.0.1:{inputs['step_port']}", timeout=60)
        await engine.close()
        return {}

    got = asyncio.run(leader() if state.is_leader else follower())
    got["carry"] = engine._carry[0].numpy()
    got["pages"] = engine.cache.pages.numpy()
    return got


# W8A8 weights, int8 pages at calibrated scales and speculation, together.
MODES = dict(weight_quant="int8", cache_dtype="int8", kv_scale="auto",
             spec_decode={"enable": True, "k": 4})
REPETITIVE = [7, 8, 9, 10, 11, 12] * 4


async def _serve_modes(engine):
    from dynamo_tpu_torch.runtime.engine import Context

    return {"tokens": await _gen(engine, Context, REPETITIVE, {"temperature": 0.0}),
            "sampled": await _gen(engine, Context, REPETITIVE[:9], SAMPLED[1]),
            "kv_scale": np.asarray(engine.kv_scale)}


def _job_modes(state, inputs):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.multihost import StepPublisher, follower_serve
    from dynamo_tpu_torch.llm.metrics import spec_metrics
    from dynamo_tpu_torch.models.llama import params_from_jax

    os.environ["DYN_STEP_TOKEN"] = "multihost-test"
    engine = TorchEngine(EngineConfig(**ENGINE, **MODES, tp=2),
                         params=params_from_jax(inputs["tree"], device="cpu"), device="cpu",
                         shard=state)

    async def leader():
        engine.attach_publisher(
            await StepPublisher("127.0.0.1", inputs["step_port"], 1).start(60))
        got = await _serve_modes(engine)
        got["spec_dispatches"] = spec_metrics.dispatches_total
        await engine.close()
        return got

    async def follower():
        await follower_serve(engine, f"127.0.0.1:{inputs['step_port']}", timeout=60)
        await engine.close()
        return {"kv_scale": np.asarray(engine.kv_scale)}

    got = asyncio.run(leader() if state.is_leader else follower())
    got["carry"] = engine._carry[0].numpy()
    return got


JOBS = {"step_plane": _job_step_plane, "modes": _job_modes}


if __name__ == "__main__":
    rank_main(JOBS)
    sys.exit(0)


if not os.environ.get(RANK_ENV):
    import argparse
    import importlib

    import jax
    import yaml

    from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.models.config import get_config as jax_get_config
    from dynamo_tpu.models.loader import save_params_hf as jax_save_params_hf
    from dynamo_tpu.runtime.engine import Context as JaxContext
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.multihost import StepPublisher
    from dynamo_tpu_torch.models.llama import params_from_jax
    from tests.test_torch_deploy import D, JAX, PORT, _example, substituted

    jl = importlib.import_module("dynamo_tpu.models.llama")

pytestmark = pytest.mark.torch_port


def _tree():
    cfg = jax_get_config("debug-tiny").with_overrides(dtype="float32")
    return cfg, jl.init_params(cfg, jax.random.PRNGKey(0))


def _jax_streams(params):
    async def main():
        engine = TpuEngine(JaxEngineConfig(**ENGINE, tp=2), params=params)
        got = [await _gen(engine, JaxContext, *case) for case in (GREEDY, SAMPLED)]
        await engine.close()
        return got

    return asyncio.run(main())


def _one_rank(tree):
    """The import payload (a one-rank engine's export of IMPORTED) and a
    one-rank engine's run of the whole sequence."""
    async def main():
        from dynamo_tpu_torch.runtime.engine import Context

        donor = TorchEngine(EngineConfig(**ENGINE), params=params_from_jax(tree, device="cpu"),
                            device="cpu")
        await _gen(donor, Context, IMPORTED, {"temperature": 0.0})
        payload = await donor.export_prompt_blocks(IMPORTED)
        await donor.close()
        ref = TorchEngine(EngineConfig(**ENGINE, **TIERS),
                          params=params_from_jax(tree, device="cpu"), device="cpu")
        got = await _serve_sequence(ref, payload)
        await ref.close()
        got["carry"] = ref._carry[0].numpy()
        got["pages"] = ref.cache.pages.numpy()
        return payload, got

    return asyncio.run(main())


def test_step_plane_streams_the_jax_tp2_engine(tmp_path):
    cfg, params = _tree()
    tree = jax.tree_util.tree_map(np.asarray, params)
    want_greedy, want_sampled = _jax_streams(params)
    payload, ref = _one_rank(tree)
    outs = run_ranks(__file__, "step_plane", 2,
                     {"mesh": {"tp": 2}, "nnodes": 2, "step_port": free_port(), "tree": tree,
                      "payload": payload}, tmp_path)
    lead = outs[0]
    assert lead["greedy"] == want_greedy and lead["sampled"] == want_sampled
    assert lead["restored"] == want_greedy and lead["restored_blocks"] > 0
    assert lead["covered"] > 0 and lead["import_hits"] > 0
    for key in ("greedy", "sampled", "restored", "restored_blocks", "covered", "imported"):
        assert lead[key] == ref[key], key
    assert lead["export"] is None and lead["disk"] is None
    kv2 = 2 * cfg.num_kv_heads // 2
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["carry"], lead["carry"])
        np.testing.assert_allclose(out["pages"], ref["pages"][:, :, :, rank * kv2:(rank + 1) * kv2],
                                   rtol=1e-5, atol=1e-5)


def test_step_plane_w8a8_int8_kv_auto_and_speculation_match_jax_tp2(tmp_path):
    """tp 2 under W8A8 weights, int8 pages at ``kv_scale="auto"`` (every
    rank stores the tp group's per-layer max) and speculation: the
    streams of JAX's ``TpuEngine`` at tp 2 with the same settings, and its
    scales within the calibration tolerance; the streams and scales of a
    one-rank engine of the port exactly (the W8A8 forward is bitwise equal
    at tp 2, so the calibration is too)."""
    _, params = _tree()
    tree = jax.tree_util.tree_map(np.asarray, params)

    async def jax_tp2():
        engine = TpuEngine(JaxEngineConfig(**ENGINE, **MODES, tp=2), params=params)
        got = {"tokens": await _gen(engine, JaxContext, REPETITIVE, {"temperature": 0.0}),
               "sampled": await _gen(engine, JaxContext, REPETITIVE[:9], SAMPLED[1]),
               "kv_scale": np.asarray(engine.kv_scale)}
        await engine.close()
        return got

    async def one_rank():
        ref = TorchEngine(EngineConfig(**ENGINE, **MODES),
                          params=params_from_jax(tree, device="cpu"), device="cpu")
        got = await _serve_modes(ref)
        await ref.close()
        return got

    jax_want = asyncio.run(jax_tp2())
    want = asyncio.run(one_rank())
    outs = run_ranks(__file__, "modes", 2, {"mesh": {"tp": 2}, "step_port": free_port(),
                                            "tree": tree}, tmp_path)
    lead = outs[0]
    assert lead["tokens"] == jax_want["tokens"] and lead["sampled"] == jax_want["sampled"]
    assert lead["tokens"] == want["tokens"] and lead["sampled"] == want["sampled"]
    assert lead["spec_dispatches"] > 0
    for out in outs:
        np.testing.assert_allclose(out["kv_scale"], jax_want["kv_scale"], rtol=1e-2)
        np.testing.assert_array_equal(out["kv_scale"], want["kv_scale"])
        np.testing.assert_array_equal(out["carry"], lead["carry"])


def test_torch_worker_boots_tp2_ranks_like_run():
    """``TorchWorker`` with ``tp: 2`` starts its second rank as ``run --tp
    2`` does and streams what a one-rank engine of the same settings does;
    closing the engine ends the started rank."""
    from dynamo_tpu_torch.engine import build_torch_engine
    from dynamo_tpu_torch.cli import parse_args
    from dynamo_tpu_torch.examples.llm.components import TorchWorker
    from dynamo_tpu_torch.runtime.engine import Context

    async def main():
        args = parse_args(["run", "in=none", "out=torch", "--arch", "debug-tiny", "--device",
                           "cpu", "--max-model-len", "128", "--num-blocks", "64"])
        ref = build_torch_engine(args)
        want = await _gen(ref, Context, *GREEDY)
        await ref.close()
        worker = TorchWorker(config={"tp": 2, "device": "cpu", "model": "debug-tiny",
                                     "max_model_len": 128, "num_blocks": 64})
        engine = await worker._boot_ranks(EngineConfig(model="debug-tiny", max_model_len=128,
                                                       num_blocks=64, tp=2))
        try:
            assert engine.shard is not None and engine.shard.size == 2
            got = await _gen(engine, Context, *GREEDY)
        finally:
            await engine.close()
            await asyncio.wait_for(worker._ranks.stop(timeout=30), 60)
        assert got == want
        assert all(p.returncode == 0 for p in worker._ranks.children)

    asyncio.run(main())


def test_wildcard_bind_without_token_is_refused(monkeypatch):
    monkeypatch.delenv("DYN_STEP_TOKEN", raising=False)

    async def main():
        with pytest.raises(RuntimeError, match="refusing to bind a wildcard"):
            await StepPublisher("0.0.0.0", free_port(), 1).start(timeout=5)
        monkeypatch.setenv("DYN_STEP_TOKEN", "t")
        pub = await StepPublisher("127.0.0.1", free_port(), 0).start(timeout=5)
        await pub.close()

    asyncio.run(main())


# ---------------------------------------------------------------------- CLI


def _run_parser_options(main_or_parser):
    """The ``run`` subcommand's options of a package's CLI parser."""
    if callable(main_or_parser):  # the JAX CLI builds its parser in main()
        captured = {}

        def grab(self, args=None, namespace=None):
            captured["parser"] = self
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main_or_parser(["run", "in=http", "out=tpu"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        parser = captured["parser"]
    else:
        parser = main_or_parser
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {o: a for a in sub.choices["run"]._actions for o in a.option_strings}


def test_run_parser_matches_jax_flag_by_flag():
    from dynamo_tpu import cli as jax_cli
    from dynamo_tpu_torch import cli as port_cli

    jax_opts = _run_parser_options(jax_cli.main)
    port_opts = _run_parser_options(port_cli.build_parser())
    # The JAX kernel selectors have no counterpart (ROADMAP queue 1 item 8);
    # --device is the port's own (device.py).
    assert set(jax_opts) - set(port_opts) == {"--attn-impl", "--decode-kernel"}
    assert set(port_opts) - set(jax_opts) == {"--device"}

    def sig(a):
        return (a.dest, a.default, getattr(a.type, "__name__", a.type), a.nargs,
                type(a).__name__, a.choices)

    for flag in sorted(set(jax_opts) & set(port_opts)):
        assert sig(port_opts[flag]) == sig(jax_opts[flag]), flag
    for flag in ("--tp", "--dp", "--ep", "--sp", "--sp-prefill-min", "--nnodes", "--node-rank",
                 "--step-port"):
        assert port_opts[flag].help == jax_opts[flag].help, flag


BODIES = [
    dict(model="m", prompt=GREEDY[0], max_tokens=MAX_TOKENS, nvext={"ignore_eos": True}),
    dict(model="m", prompt=SAMPLED[0], max_tokens=MAX_TOKENS, temperature=0.8, seed=7,
         frequency_penalty=0.5, nvext={"ignore_eos": True}),
    dict(model="m", prompt=IMPORTED, max_tokens=5, nvext={"ignore_eos": True}),
]
SERVE_TIMEOUT_S = 120


class _Server:
    """One ``run in=http`` command, read until it serves."""

    def __init__(self, pkg, flags, env=None):
        self.p = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli", "run", "in=http",
             "out=torch" if pkg == "dynamo_tpu_torch" else "out=tpu",
             "--host", "127.0.0.1", "--port", str(free_port()), "--model", "m", *flags],
            env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "DYN_LOG": "warning",
                 **(env or {})},
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.lines = []

    def wait_serving(self):
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while time.monotonic() < deadline:
            line = self.p.stdout.readline()
            if not line:
                break
            self.lines.append(line)
            if line.startswith("serving 'm' on "):
                return line.strip().split(" on ")[1]
        self.stop()
        raise AssertionError(f"no server: {self.lines} {self.p.stderr.read()[-3000:]}")

    def stop(self):
        if self.p.poll() is None:
            self.p.send_signal(signal.SIGINT)
        try:
            self.p.wait(timeout=60)
        finally:
            if self.p.poll() is None:
                self.p.kill()
                self.p.wait()
        return self.p.returncode


def _completions(base):
    from tests.test_torch_http import _post

    out = []
    for body in BODIES:
        status, _, text, _ = asyncio.run(_post(base, "/v1/completions", body))
        assert status == 200, text
        data = json.loads(text)
        out.append((data["choices"][0]["text"], data["usage"]))
    return out


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_run_tp2_and_the_two_node_form_serve_the_jax_texts(tmp_path):
    _, params = _tree()
    ckpt = str(tmp_path / "ckpt")
    jax_save_params_hf(jax.tree_util.tree_map(np.asarray, params), ckpt)
    common = ["--arch", "debug-tiny", "--checkpoint", ckpt, "--dtype", "float32",
              "--max-model-len", "128", "--num-blocks", "64", "--tp", "2"]
    jax_server = _Server("dynamo_tpu", [*common, "--cpu-devices", "2"])
    try:
        want = _completions(jax_server.wait_serving())
    finally:
        jax_server.stop()

    one = _Server("dynamo_tpu_torch", [*common, "--device", "cpu"])
    try:
        got = _completions(one.wait_serving())
    finally:
        assert one.stop() == 0
    assert got == want
    started = [int(line.split("pid ")[1].rstrip(")\n")) for line in one.lines
               if line.startswith("rank 1 started")]
    assert len(started) == 1 and not _alive(started[0])
    assert any("backend gloo, programs eager" in line for line in one.lines)

    coord, step = f"127.0.0.1:{free_port()}", str(free_port())
    nodes = ["--nnodes", "2", "--coordinator", coord, "--step-port", step, "--device", "cpu"]
    env = {"DYN_STEP_TOKEN": "two-nodes"}
    follower = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "in=http", "out=torch", *common,
         *nodes, "--node-rank", "1"],
        env={**os.environ, "PYTHONPATH": REPO, "DYN_LOG": "warning", **env}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    leader = _Server("dynamo_tpu_torch", [*common, *nodes, "--node-rank", "0"], env=env)
    try:
        two = _completions(leader.wait_serving())
    finally:
        assert leader.stop() == 0
        try:
            follower.wait(timeout=60)  # the leader's close ends its replay
        finally:
            if follower.poll() is None:
                follower.kill()
                follower.wait()
    assert two == want
    assert follower.returncode == 0, follower.stderr.read()[-3000:]


def test_a_started_rank_dies_with_its_leader():
    """SIGKILL to ``run --tp 2`` (no close frame reaches the step plane):
    the rank it started gets its parent-death signal and exits."""
    p = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "in=none", "out=torch",
         "--arch", "debug-tiny", "--device", "cpu", "--tp", "2"],
        env={**os.environ, "PYTHONPATH": REPO, "DYN_LOG": "warning"}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    child = None
    try:
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while time.monotonic() < deadline:
            line = p.stdout.readline()
            if line.startswith("rank 1 started"):
                child = int(line.split("pid ")[1].rstrip(")\n"))
            if line.startswith("engine up") or not line:
                break
        assert child is not None and _alive(child)
    finally:
        p.kill()
        p.wait()
    deadline = time.monotonic() + 30
    while child is not None and _alive(child) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert child is not None and not _alive(child)


def test_renderer_multihost_matches_jax():
    cr = _example()
    for svc in cr["spec"]["services"].values():
        (svc.get("tpu") or {}).pop("topology", None)  # a TPU slice's shape: refused
    port_docs, jax_docs = D(PORT).deploy.render(cr), D(JAX).deploy.render(cr)
    assert port_docs == substituted(jax_docs)
    decode = {d["metadata"]["name"]: d for d in port_docs
              if d["kind"] == "StatefulSet"}["r1-distill-decode"]
    assert decode["spec"]["replicas"] == 4
    cmd = decode["spec"]["template"]["spec"]["containers"][0]["command"]
    assert cmd[cmd.index("--node-rank") + 1] == "$(POD_ORDINAL)"
    assert yaml.safe_load(D(PORT).deploy.render_to_yaml(cr).split("---\n")[0])
