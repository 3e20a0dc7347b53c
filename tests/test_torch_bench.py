"""The port's bench (``python -m dynamo_tpu_torch.bench``) against the JAX
package's ``bench.py``: the one-line contract on the CPU geometry, the
spec mode's streams, the churn and prefix modes' counts, and the device
rule (no CUDA and no ``--device cpu``: it raises)."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch import bench
from dynamo_tpu_torch.models.llama import params_from_jax

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_driver_contracts.py::test_bench_prints_one_json_line's key set.
CONTRACT_KEYS = {
    "metric", "value", "unit", "vs_baseline",
    "decode_mfu", "decode_kernel", "attention", "host_gap_frac",
    "dispatch", "pipeline",
    "prefill_mfu", "prefill_kernel", "prefill",
}
SMALL_SPEC = {"BENCH_SPEC_ISL": "32", "BENCH_SPEC_OSL": "16", "BENCH_SPEC_REQUESTS": "2"}


def _env() -> dict:
    from conftest import hermetic_child_env

    return hermetic_child_env(REPO)


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's bench.py as a module (its CPU geometry)."""
    spec = importlib.util.spec_from_file_location("jax_bench_py", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_weights():
    """The JAX engine's seed-0 debug-tiny draw, as the port's tree: both
    benches then serve the same weights."""
    tree = jax_init_params(jax_get_config("debug-tiny").with_overrides(dtype="float32"),
                           jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _cpu_cfg():
    return bench.engine_config(torch.device("cpu"))


def test_bench_cpu_prints_one_line_with_the_contract_keys():
    proc = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.bench", "--device", "cpu"],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert set(out) == CONTRACT_KEYS == bench.HEADLINE_KEYS
    assert out["value"] > 0 and 0.0 <= out["host_gap_frac"] <= 1.0
    assert isinstance(out["decode_mfu"], float) and isinstance(out["prefill_mfu"], float)
    # The CPU tensors take the kernels' plain versions; on the card the
    # line names the CUDA sources.
    assert out["decode_kernel"] == out["prefill_kernel"] == "plain"
    assert bench.KERNEL_NAMES["cuda"] == ("csrc/decode_attention.cu", "csrc/prefill_attention.cu")
    assert out["prefill"]["chunks"] >= 1
    assert {"sessions", "rebuilds", "continuous_admissions", "continuous_retired",
            "host_gap_frac", "stalls"} <= set(out["pipeline"])
    for v in out["dispatch"].values():
        assert {"dispatches", "p50_ms", "p99_ms"} <= set(v)
    # MFU against the H100's dense peaks, never a TPU's.
    assert (bench.PEAK_BF16, bench.PEAK_INT8) == (989e12, 1979e12)
    assert "989 TFLOP/s" in proc.stderr and "394T" not in proc.stderr


def test_bench_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])


def test_bench_refuses_the_warm_check(monkeypatch):
    monkeypatch.setenv("BENCH_WARM_CHECK", "1")
    with pytest.raises(SystemExit, match="xla_cache"):
        bench.main(["--device", "cpu"])


def test_spec_mode_streams_equal_jax_spec_bench(jax_bench, jax_weights, monkeypatch):
    for k, v in SMALL_SPEC.items():
        monkeypatch.setenv(k, v)
    jax_cfg, _ = jax_bench._engine_config()
    want = []
    real = jax_bench._spec_run

    async def recording(engine, prompts, osl, temperature):
        got = await real(engine, prompts, osl, temperature)
        if osl == int(SMALL_SPEC["BENCH_SPEC_OSL"]):
            want.append(got[2])
        return got

    monkeypatch.setattr(jax_bench, "_spec_run", recording)
    jax_bench._spec_bench(jax_cfg, jax_get_config(jax_cfg.model))
    cfg, _ = _cpu_cfg()
    line, results, streams = bench.spec_bench(cfg, torch.device("cpu"),
                                              params=params_from_jax(jax_weights, device="cpu"))
    # The JAX bench's timed passes in order: off (repetitive, random), on.
    got = [streams[(kind, mode)] for mode in ("off", "on") for kind, _ in bench.SPEC_KINDS]
    assert got == want
    assert all(len(s) == int(SMALL_SPEC["BENCH_SPEC_OSL"]) for ss in got for s in ss)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "random_ratio",
                         "repetitive_tok_s", "random_tok_s", "acceptance_rate",
                         "tokens_per_dispatch"}


def test_churn_mode_counts_equal_jax(jax_bench, jax_weights, capsys):
    jax_cfg, _ = jax_bench._engine_config()
    jax_bench._churn_bench(jax_cfg, jax_get_config(jax_cfg.model))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg, _ = _cpu_cfg()
    line, _ = bench.churn_bench(cfg, torch.device("cpu"),
                                params=params_from_jax(jax_weights, device="cpu"))
    for key in ("value", "rebuilds", "sessions", "continuous_admissions",
                "continuous_retired"):
        assert line[key] == want[key], (key, line[key], want[key])
    assert line["decode_kernel"] == "plain"


def test_prefix_mode_counts_equal_jax(jax_bench, jax_weights, capsys):
    jax_cfg, _ = jax_bench._engine_config()
    jax_bench._prefix_bench(jax_cfg, jax_get_config(jax_cfg.model))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg, _ = _cpu_cfg()
    line, results = bench.prefix_bench(cfg, torch.device("cpu"),
                                       params=params_from_jax(jax_weights, device="cpu"))
    assert line["identical"] is want["identical"] is True
    # The pull mode runs no offload pump: its counts are exact in both.
    assert line["pull_served_blocks"] == want["pull_served_blocks"] > 0
    for mode in ("off", "pull"):
        assert line["modes"][mode]["skip_frac"] == want["modes"][mode]["skip_frac"], mode
    # The host and disk modes run the write-behind pump every 10 ms beside
    # the trace's explicit drains, and a drain can return while the pump's
    # own batch is in flight, so what a turn restores depends on timing in
    # both packages (disk: 0.75 or 0.9375 in either, with the machine's
    # load).  Both are held to restoring most of the second turn.
    for got in (line, want):
        assert got["modes"]["host"]["skip_frac"] >= 0.9
        assert got["modes"]["disk"]["skip_frac"] >= 0.5
    assert line["compile_stable"]


def test_headline_hooks_see_the_timed_window():
    cfg, wl = _cpu_cfg()
    seen = []
    line, details = bench.headline(cfg, dict(wl, osl=4), torch.device("cpu"),
                                   before_timed=lambda e: seen.append(("before", e.step_trace.copy())),
                                   after_timed=lambda e: seen.append(("after", len(e.step_trace))))
    assert [k for k, _ in seen] == ["before", "after"]
    assert not seen[0][1] and seen[1][1] > 0  # the trace is scoped to the timed run
    assert len(details["streams"]) == wl["requests"]
    assert all(len(t) == 4 and f == "length" for t, _, f in details["streams"])
    assert details["graphs_after"] == details["graphs"]
    assert set(line) == bench.HEADLINE_KEYS
