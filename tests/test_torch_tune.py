"""The tuned launch-shape table and its sweep tool on the port against the
JAX package.

- The hint plane (``ops/decode_attention.py``: ``install_tuned_hints``,
  ``active_hints``, ``resolve_hint``) gives the JAX plane's values for one
  table file and one environment: a matching geometry, another geometry,
  a corrupt file, an env pin over the table, an entry recorded on a TPU
  (refused by both here), the prefill keys.
- ``write_entry`` of both tools writes byte-identical tables.
- The pure launch arithmetic (``decode_partitions``,
  ``prefill_partitions``) against the JAX kernels' split arithmetic, read
  from the JAX wrappers themselves (their kernel factory stopped before
  any kernel is built); with no table and no env pin every launch keeps
  the built-in shape; partitions the kernel cannot take are refused.
- ``TorchEngine`` and ``TpuEngine`` on debug-tiny install the same entry
  from one table, and their greedy streams stay identical.
- The tool's CPU smoke: both sweeps and ``main(["--device", "cpu", ...])``
  write an entry (``backend: "cpu"``) that ``install_tuned_hints`` serves.
- Two ``tp`` ranks (gloo processes) install the same entry and resolve the
  same launches.
"""

import importlib
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_parallel import RANK_ENV, rank_main, run_ranks  # noqa: E402

KNOB_ENV = ("DYN_DECODE_SPLITS", "DYN_DECODE_FUSED_PPCB", "DYN_PREFILL_SPLITS",
            "DYN_PREFILL_QB", "DYN_PREFILL_PPCB", "DYN_DECODE_NQ", "DYN_DECODE_NKV_MB")
RANK_CFG = dict(model="debug-tiny", block_size=4, num_blocks=24, max_batch=4, max_model_len=128,
                prefill_chunk=16, dtype="float32", decode_steps=4)


def _job_install(state, inputs):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    cfg = EngineConfig(**RANK_CFG, tp=2)
    engine = TorchEngine(cfg, device="cpu", shard=state)
    PP = cfg.max_blocks_per_seq
    return {"hints": da.active_hints(), "decode": da.decode_plan(PP, cfg.block_size),
            "prefill": pa.prefill_plan(PP), "programs_eager": engine.programs.eager}


JOBS = {"install": _job_install}


if __name__ == "__main__":
    rank_main(JOBS)
    sys.exit(0)


if not os.environ.get(RANK_ENV):  # a rank (importing the helpers) needs no JAX
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.ops import decode_attention as tda
    from dynamo_tpu_torch.ops import prefill_attention as tpa
    from dynamo_tpu_torch.tools import tune_decode as ttune
    from tests.test_torch_engine import CFG, MAX_TOKENS, PROMPTS, _jax_params, _serve
    from tools import tune_decode as jtune

    jda = importlib.import_module("dynamo_tpu.ops.decode_attention")
    jpa = importlib.import_module("dynamo_tpu.ops.prefill_attention")

pytestmark = pytest.mark.torch_port


@pytest.fixture
def clean(monkeypatch):
    for k in KNOB_ENV:
        monkeypatch.delenv(k, raising=False)
    for m in (jda, tda):
        m.clear_tuned_hints()
    yield
    for m in (jda, tda):
        m.clear_tuned_hints()


# ----------------------------------------------------------- the hint plane

KEY = ("debug-tiny", 4, 4)
# (entry at KEY, or None; the file written as is when a str; geometry
# installed; env pins; knobs resolved as (env, tuned key, default)).
DECODE_KNOBS = [("DYN_DECODE_SPLITS", "splits", 0), ("DYN_DECODE_FUSED_PPCB", "ppcb", 99),
                ("DYN_DECODE_NQ", "nq", 8), ("DYN_DECODE_NKV_MB", "nkv_mb", 4)]
PREFILL_KNOBS = [("DYN_PREFILL_QB", "prefill_qb", 128), ("DYN_PREFILL_SPLITS", "prefill_splits", 0),
                 ("DYN_PREFILL_PPCB", "prefill_ppcb", 99)]
HINT_CASES = {
    "matching": ({"splits": 3, "ppcb": 2, "nq": 7, "nkv_mb": 1}, KEY, {}),
    "other_geometry": ({"splits": 3, "ppcb": 2}, ("debug-tiny", 8, 16), {}),
    "corrupt_file": ("{not json", KEY, {}),
    "env_over_table": ({"splits": 3, "ppcb": 2}, KEY, {"DYN_DECODE_SPLITS": "5"}),
    "recorded_on_tpu": ({"splits": 3, "ppcb": 2, "backend": "tpu"}, KEY, {}),
    "recorded_on_cpu": ({"splits": 3, "ppcb": 2, "backend": "cpu"}, KEY, {}),
    "prefill_keys": ({"splits": 3, "prefill_qb": 7, "prefill_splits": 2, "prefill_ppcb": 3},
                     KEY, {"DYN_PREFILL_QB": "64"}),
    "no_table": (None, KEY, {}),
}


@pytest.mark.parametrize("case", sorted(HINT_CASES))
def test_hint_plane_matches_jax(case, tmp_path, monkeypatch, clean):
    entry, geometry, env = HINT_CASES[case]
    path = tmp_path / "tune.json"
    if isinstance(entry, str):
        path.write_text(entry)
    elif entry is not None:
        path.write_text(json.dumps({jda.hint_key(*KEY): entry}))
    monkeypatch.setenv("DYN_DECODE_TUNE_TABLE", str(path))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {}
    for m in (jda, tda):
        assert m.default_table_path() == str(path)
        assert m.hint_key(*geometry) == f"{geometry[0]}|b{geometry[1]}|ps{geometry[2]}"
        installed = m.install_tuned_hints(*geometry)
        got[m] = (installed, m.active_hints(), m.load_tuned_table(),
                  [m.resolve_hint(*k) for k in DECODE_KNOBS + PREFILL_KNOBS])
    assert got[tda] == got[jda]
    installed, active, table, resolved = got[tda]
    assert installed == active
    want_installed = {
        "matching": entry, "recorded_on_cpu": entry, "env_over_table": entry,
        "prefill_keys": entry,
    }.get(case)
    assert installed == want_installed
    if case == "corrupt_file":
        assert table == {}
    if case == "env_over_table":
        assert resolved[0] == 5 and resolved[1] == 2
    if case == "prefill_keys":
        assert resolved[4:] == [64, 2, 3]


def test_default_table_path_is_the_ports_own(monkeypatch, clean):
    """Without ``DYN_DECODE_TUNE_TABLE`` the port reads its own file, never
    the JAX package's by accident."""
    monkeypatch.delenv("DYN_DECODE_TUNE_TABLE", raising=False)
    assert tda.default_table_path().endswith("/.cache/dynamo_tpu_torch/decode_tune.json")
    assert jda.default_table_path().endswith("/.cache/dynamo_tpu/decode_tune.json")


def test_write_entry_files_are_byte_identical(tmp_path):
    entries = [
        ("llama-3.1-8b|b16|ps16", {"geometry": {"model": "llama-3.1-8b", "batch": 16},
                                   "backend": "gpu", "iters": 20, "splits": 0, "ppcb": 32,
                                   "fused_us": 31.25, "prefill_splits": 2, "prefill_us": 70.5}),
        ("debug-tiny|b4|ps4", {"backend": "cpu", "splits": 4, "ppcb": None, "fused_us": 1.0}),
        ("llama-3.1-8b|b16|ps16", {"backend": "gpu", "splits": 8, "ppcb": 16, "fused_us": 30.0}),
    ]
    paths = {}
    for name, mod in (("jax", jtune), ("port", ttune)):
        path = tmp_path / name / "table.json"
        path.parent.mkdir()
        path.write_text("[1, 2]")  # not a table: replaced, as a corrupt file is
        for key, entry in entries:
            mod.write_entry(str(path), key, entry)
            paths.setdefault(name, []).append(path.read_bytes())
    assert paths["port"] == paths["jax"]
    assert json.loads(paths["port"][-1])["llama-3.1-8b|b16|ps16"]["splits"] == 8


# ----------------------------------------------------------- the arithmetic


class _Plan(Exception):
    pass


def _jax_split_pages(monkeypatch, mod, call):
    """The ``split_pages`` and ``ppcb`` a JAX wrapper computes, read from
    its kernel factory's arguments (the factory raises before any kernel
    is built)."""
    def stop(**kw):
        raise _Plan(kw)

    monkeypatch.setattr(mod, "_make_kernel", stop)
    with pytest.raises(_Plan) as e:
        call()
    return e.value.args[0]["split_pages"], e.value.args[0]["ppcb"]


# (table pages, page size, splits, ppcb): serve and phase c/d table widths,
# caps by ppcb, uneven last splits, more splits than pages.
DECODE_SPLITS = [(256, 16, 5, 16), (256, 16, 32, 16), (256, 16, 2, 64), (256, 16, 16, 1),
                 (40, 16, 3, 16), (40, 16, 3, 100), (16, 16, 8, 2), (5, 16, 8, 1),
                 (7, 16, 2, 3), (1, 16, 4, 1), (12, 4, 3, 4), (3, 32, 2, 1)]


@pytest.mark.parametrize("PP,ps,splits,ppcb", DECODE_SPLITS, ids=str)
def test_decode_split_arithmetic_matches_jax(PP, ps, splits, ppcb, monkeypatch, clean):
    H, KV, D, S = 4, 2, 8, 2
    q = jnp.zeros((S, H, D), jnp.float32)
    pages = jnp.zeros((S * PP + 1, ps, 2 * KV, D), jnp.float32)
    tables = jnp.zeros((S, PP), jnp.int32)
    lens, num = jnp.ones((S,), jnp.int32), jnp.asarray([S], jnp.int32)
    split_pages, jppcb = _jax_split_pages(monkeypatch, jda, lambda: jda.fused_decode_attention(
        q, pages, lens, tables, num, sm_scale=1.0, num_kv_splits=splits, pages_per_block=ppcb,
        interpret=True))
    part, J = tda.decode_partitions(PP, ps, splits, ppcb)
    assert (part, J) == (split_pages * ps, -(-PP // split_pages))
    assert min(ppcb, PP) == jppcb
    # The same through the knobs: env pins, then a tuned entry.
    monkeypatch.setenv("DYN_DECODE_SPLITS", str(splits))
    monkeypatch.setenv("DYN_DECODE_FUSED_PPCB", str(ppcb))
    assert tda.decode_plan(PP, ps) == (part, J)


@pytest.mark.parametrize("PP,splits", [(256, 3), (128, 2), (40, 4), (7, 3), (5, 8), (1, 2)],
                         ids=str)
def test_prefill_split_arithmetic_matches_jax(PP, splits, monkeypatch, clean):
    """The port's prefill has no ``prefill_ppcb`` (its tile is compiled in),
    so it splits as the JAX kernel does at one page per compute block."""
    H, KV, D, S, ps = 4, 2, 8, 2, 4
    q = jnp.zeros((8, H, D), jnp.float32)
    pages = jnp.zeros((S * PP + 1, ps, 2 * KV, D), jnp.float32)
    tables = jnp.zeros((S, PP), jnp.int32)
    lens, num = jnp.ones((S,), jnp.int32), jnp.asarray([S], jnp.int32)
    cu = jnp.asarray([0, 4, 8], jnp.int32)
    split_pages, _ = _jax_split_pages(monkeypatch, jpa, lambda: jpa.fused_prefill_attention(
        q, pages, lens, tables, cu, num, sm_scale=1.0, q_block=4, num_kv_splits=splits,
        pages_per_block=1, interpret=True))
    assert tpa.prefill_partitions(PP, splits) == (split_pages, -(-PP // split_pages))
    monkeypatch.setenv("DYN_PREFILL_SPLITS", str(splits))
    assert tpa.prefill_plan(PP) == tpa.prefill_partitions(PP, splits)


@pytest.mark.parametrize("PP,ps", [(256, 16), (16, 16), (5, 16), (1, 16), (256, 8), (64, 4),
                                   (3, 4), (30, 48)], ids=str)
def test_no_table_and_no_pin_keep_the_builtin_launch(PP, ps, tmp_path, monkeypatch, clean):
    """With no table and no env pin every launch is the one before tuning:
    decode partitions of DECODE_PARTITION positions, one prefill split."""
    monkeypatch.setenv("DYN_DECODE_TUNE_TABLE", str(tmp_path / "absent.json"))
    assert tda.install_tuned_hints("llama-3.1-8b", 16, ps) is None
    builtin = (256, -(-PP * ps // 256))
    assert tda.DECODE_PARTITION == 256
    assert tda.decode_partitions(PP, ps) == builtin
    assert tda.decode_plan(PP, ps) == builtin
    assert tpa.prefill_partitions(PP) == (PP, 1)
    assert tda.resolve_hint("DYN_PREFILL_SPLITS", "prefill_splits", 0) == 0
    assert tpa.prefill_plan(PP) == (PP, 1)


@pytest.mark.parametrize("knob,value,PP,ps", [
    ("DYN_DECODE_FUSED_PPCB", "1", 256, 4),  # 4-position partitions
    ("DYN_DECODE_FUSED_PPCB", "3", 256, 8),  # 24
    ("DYN_DECODE_SPLITS", "3", 129, 4),  # 3 runs of 43 pages: 172 positions
    ("DYN_DECODE_FUSED_PPCB", "0", 256, 16),  # no page at all
], ids=str)
def test_a_partition_the_kernel_cannot_take_is_refused(knob, value, PP, ps, monkeypatch, clean):
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match="DYN_DECODE_SPLITS" if "SPLITS" in knob else "ppcb"):
        tda.decode_plan(PP, ps)
    # The same values from a table are refused alike.
    monkeypatch.delenv(knob)
    key = "splits" if "SPLITS" in knob else "ppcb"
    monkeypatch.setattr(tda, "_ACTIVE_HINTS", {key: int(value)})
    with pytest.raises(ValueError, match=key):
        tda.decode_plan(PP, ps)


def test_one_partition_covering_the_table_is_always_taken(clean):
    """A single partition has no boundary inside a context: any width
    serves, as the built-in launch's 256 positions over a narrower table."""
    assert tda.decode_partitions(3, 4, 1) == (12, 1)
    assert tda.decode_partitions(3, 4, None, 5) == (12, 1)
    assert tda.decode_partitions(7, 4, 2) == (28, 1)  # capped by the default ppcb


# ------------------------------------------------------------- the engines


async def test_engines_install_the_same_entry_and_stream_alike(tmp_path, monkeypatch, clean):
    cfg = dict(CFG)
    path = tmp_path / "tune.json"
    entry = {"backend": "cpu", "splits": 2, "ppcb": 8, "prefill_splits": 3, "nq": 16,
             "prefill_qb": 64}
    path.write_text(json.dumps({tda.hint_key(cfg["model"], cfg["max_batch"],
                                             cfg["block_size"]): entry}))
    monkeypatch.setenv("DYN_DECODE_TUNE_TABLE", str(path))
    params = _jax_params()
    want_engine = TpuEngine(JaxEngineConfig(**cfg), params=params)
    assert jda.active_hints() == entry
    want = await _serve(want_engine)
    tree = jax.tree_util.tree_map(np.asarray, params)
    engine = TorchEngine(EngineConfig(**cfg), params=params_from_jax(tree, device="cpu"),
                         device="cpu")
    assert tda.active_hints() == entry
    PP, ps = engine.cfg.max_blocks_per_seq, cfg["block_size"]
    assert tda.decode_plan(PP, ps) == tda.decode_partitions(PP, ps, 2, 8) == (64, 2)
    assert tpa.prefill_plan(PP) == tpa.prefill_partitions(PP, 3)
    got = await _serve(engine)
    assert [len(t) for t, _ in got] == MAX_TOKENS
    assert got == want
    assert len(PROMPTS) == 4


# ---------------------------------------------------------------- the tool


def test_tool_cpu_smoke_writes_an_entry_the_engine_serves(tmp_path, monkeypatch, clean, capsys):
    case = ttune._build_case("debug-tiny", 2, 4, 8, "int8", 0, "cpu")
    best, results = ttune.sweep_fused(case, [0, 2, 4], [1, 4, 8], 1)
    assert results[0]["default"] and results[0]["part"] == 256
    assert any("rejected" in r for r in results)  # ppcb 1 at page size 4
    assert best is not None and best["ok"] and not best.get("default")
    pcase = ttune._build_prefill_case("debug-tiny", 2, 4, 8, "int8", 8, 0, "cpu")
    pbest, presults = ttune.sweep_prefill(pcase, [1, 2, 4], 1)
    assert [r["J"] for r in presults] == [1, 1, 2, 4] and pbest["ok"]

    out = tmp_path / "t" / "table.json"
    monkeypatch.setenv("DYN_DECODE_SPLITS", "7")  # an operator's pin: the sweep ignores it
    assert ttune.main(["--device", "cpu", "--out", str(out), "--batch", "2", "--page-size", "4",
                       "--pages-per-seq", "8", "--cache-dtype", "bfloat16", "--iters", "1",
                       "--prefill-chunk", "8", "--splits", "0,2", "--ppcb", "4,8",
                       "--prefill-splits", "1,2", "--nq", "8"]) == 0
    assert os.environ["DYN_DECODE_SPLITS"] == "7"
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["key"] == "debug-tiny|b2|ps4" and report["stock_sweep"] == []
    assert report["not_swept"]["nq"] == [8]
    entry = json.loads(out.read_text())["debug-tiny|b2|ps4"]
    assert entry == report["entry"]
    assert entry["backend"] == "cpu" and entry["iters"] == 1
    assert {"splits", "ppcb", "fused_us", "prefill_splits", "prefill_us"} <= set(entry)
    monkeypatch.delenv("DYN_DECODE_SPLITS")
    assert tda.install_tuned_hints("debug-tiny", 2, 4, path=str(out)) == entry
    assert tda.resolve_hint("DYN_DECODE_SPLITS", "splits", -1) == entry["splits"]
    assert tda.decode_plan(8, 4) == tda.decode_partitions(8, 4, entry["splits"], entry["ppcb"])


def test_tool_cli_runs_as_a_module(tmp_path):
    import subprocess

    out = tmp_path / "table.json"
    p = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.tools.tune_decode", "--device", "cpu",
         "--out", str(out), "--batch", "1", "--page-size", "4", "--pages-per-seq", "4",
         "--cache-dtype", "float32", "--iters", "1", "--prefill-chunk", "4",
         "--splits", "1", "--ppcb", "4", "--prefill-splits", "1"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(out.read_text())["debug-tiny|b1|ps4"]["backend"] == "cpu"
    assert "not swept (no counterpart in the port)" in p.stderr


def test_two_tp_ranks_install_the_same_entry(tmp_path, monkeypatch):
    """Each rank of ``tp`` 2 is its own process: both install the entry of
    the same table and geometry and resolve the same launches."""
    path = tmp_path / "tune.json"
    entry = {"backend": "cpu", "splits": 4, "ppcb": 4, "prefill_splits": 2}
    key = tda.hint_key(RANK_CFG["model"], RANK_CFG["max_batch"], RANK_CFG["block_size"])
    path.write_text(json.dumps({key: entry}))
    monkeypatch.setenv("DYN_DECODE_TUNE_TABLE", str(path))
    for k in KNOB_ENV:
        monkeypatch.delenv(k, raising=False)
    ranks = run_ranks(__file__, "install", 2, {"mesh": dict(tp=2)}, tmp_path)
    assert ranks[0] == ranks[1]
    assert ranks[0]["hints"] == entry and ranks[0]["programs_eager"]
    assert ranks[0]["decode"] == tda.decode_partitions(32, 4, 4, 4) == (32, 4)
    assert ranks[0]["prefill"] == tpa.prefill_partitions(32, 2) == (16, 2)
