"""The port's fault matrix (``dynamo_tpu_torch/tools/fault_matrix.py``)
against the JAX package's ``tools/fault_matrix.py``: every sweep, the
engine's too, row for row (fault, where it was injected, what was
observed, the client's status), the same ``fault_kinds``, exit 0.

What a row observes is compared with its timings and the counts that
depend on them masked: seconds and milliseconds, the hub reconnects
(which runtimes of a sweep redial within the outage) and where the WFQ
victim finished.  Those are held to the sweep's own bars instead."""

import asyncio
import importlib.util
import json
import os
import re

import pytest

from dynamo_tpu_torch.tools import fault_matrix

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MASKS = (
    (re.compile(r"\d+\.\d+s\b"), "<s>"),
    (re.compile(r"\d+ms\b"), "<ms>"),
    (re.compile(r"\d+ reconnect\(s\)"), "<n> reconnect(s)"),
    (re.compile(r"at position \d+ of \d+"), "at position <k> of <n>"),
)
# The one label that names the ladder's own file in each package.
_LADDER = ("benchmarks/goodput.py", "dynamo_tpu_torch/tools/goodput.py")


def _masked(row: dict) -> dict:
    out = dict(row)
    for pattern, repl in _MASKS:
        out["observed"] = pattern.sub(repl, out["observed"])
    out["injected_at"] = out["injected_at"].replace(_LADDER[1], _LADDER[0])
    return out


@pytest.fixture(scope="module")
def jax_rows():
    spec = importlib.util.spec_from_file_location(
        "jax_fault_matrix", os.path.join(REPO, "tools", "fault_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    async def sweep():
        return (await mod.sweep_runtime() + await mod.sweep_chaos() + await mod.sweep_shards()
                + await mod.sweep_http() + await mod.sweep_integrity() + await mod.sweep_bulk()
                + await mod.sweep_engine())

    return asyncio.run(sweep())


@pytest.fixture(scope="module")
def port_matrix(tmp_path_factory):
    out = tmp_path_factory.mktemp("fm") / "matrix.json"
    rc = fault_matrix.main(["--engine", "--device", "cpu", "--json", str(out)])
    return rc, json.loads(out.read_text())


def test_port_matrix_equals_jax_row_for_row(jax_rows, port_matrix):
    rc, doc = port_matrix
    assert rc == 0
    assert doc["schema"] == "dynamo-tpu-fault-matrix-v2"
    rows = doc["fault_matrix"]
    assert [r["fault"] for r in rows] == [r["fault"] for r in jax_rows]
    for got, want in zip(rows, jax_rows):
        assert set(got) == set(want) == {"fault", "injected_at", "observed", "status"}
        assert _masked(got) == _masked(want)
    assert doc["fault_kinds"] == sorted({r["fault"].split(" ")[0] for r in jax_rows})
    assert not fault_matrix.bad_rows(rows)


def test_masked_counts_hold_their_bars(port_matrix):
    rows = {r["fault"]: r["observed"] for r in port_matrix[1]["fault_matrix"]}
    assert int(re.search(r"(\d+) reconnect", rows["hub_outage"]).group(1)) >= 1
    pos, n = map(int, re.search(r"at position (\d+) of (\d+)", rows["tenant_flood"]).groups())
    assert pos < n - 1  # FIFO would finish the victim last
    assert rows["slow_stream"].startswith("6/6 streams completed")


def test_bad_rows_flags_unexpected_and_unrecovered():
    rows = [{"observed": "fine"}, {"observed": "UNEXPECTED: x"}, {"observed": "NOT RECOVERED"}]
    assert fault_matrix.bad_rows(rows) == rows[1:]


def test_fault_matrix_without_cuda_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fault_matrix.main([])
