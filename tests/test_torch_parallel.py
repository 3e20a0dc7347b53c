"""The port's tensor, expert and data parallelism (``dynamo_tpu_torch/parallel``,
the sharded ``forward_ragged``) against the JAX package's mesh on the same
seeded inputs.

- Shards: for debug-tiny, its W8A8 tree and debug-tiny-moe, every leaf's
  rank slice (``shard_params``) equals the shard JAX's ``NamedSharding``
  places at the same mesh coordinates, for tp 2, ep 2 and dp 2 x tp 2 on
  the 8 virtual CPU devices; the spec trees, the pages spec and
  ``make_mesh``'s error when there are too few devices are the JAX ones.
- The sharded forward: ranks run as gloo processes on the CPU (this file run
  as a script, one process per rank, each wait bounded).  ``forward_ragged``
  at tp 2 equals JAX's ``forward_ragged(mesh=…)`` within 1e-4 in f32 over a
  prefill, a mixed and a decode step, and each rank's pages equal its head
  slice of JAX's; at W8A8 within 1e-5, its row-parallel int32 accumulators
  equal the single-rank ones exactly; MoE at ep 2 within 1e-4.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS, NUM_PAGES, S, PP = 4, 20, 4, 5
RANK_TIMEOUT_S = 120
RANK_ENV = "TORCH_TEST_RANK"  # set in the rank processes this file starts


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, job: str, n: int, inputs, tmp_path, timeout=RANK_TIMEOUT_S):
    """Run ``job`` of ``script`` as ``n`` gloo ranks on the CPU; returns
    each rank's pickled result.  A rank that fails or outlives ``timeout``
    fails the test (and every rank is killed)."""
    src = tmp_path / f"{job}.in.pkl"
    src.write_bytes(pickle.dumps(inputs))
    port = free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "DYN_LOG": "warning",
           RANK_ENV: "1"}
    procs = [subprocess.Popen([sys.executable, script, job, str(r), str(n), str(port), str(src),
                               str(tmp_path / f"{job}.{r}.pkl")],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    return [pickle.loads((tmp_path / f"{job}.{r}.pkl").read_bytes()) for r in range(n)]


def rank_main(jobs) -> None:
    """Script entry of a rank: ``<job> <rank> <n> <port> <in.pkl>
    <out.pkl>``; runs ``jobs[job](state, inputs)`` in the process group and
    pickles its result."""
    job, rank, n, port, src, dst = sys.argv[1:7]
    import torch

    from dynamo_tpu_torch.parallel.distributed import (
        MultiHostConfig, init_multihost, shutdown_multihost,
    )
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    torch.manual_seed(0)
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    nnodes = inputs.get("nnodes", 1)  # each node runs n / nnodes of the ranks
    local = int(n) // nnodes
    cfg = MultiHostConfig(coordinator=f"127.0.0.1:{port}", nnodes=nnodes,
                          node_rank=int(rank) // local)
    state = init_multihost(cfg, MeshConfig(**inputs["mesh"]), int(rank) % local,
                           torch.device("cpu"), timeout_s=RANK_TIMEOUT_S)
    try:
        out = jobs[job](state, inputs)
    finally:
        shutdown_multihost()
    with open(dst, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------- the jobs


def _job_forward(state, inputs):
    """Each rank: its slices of the tree, its pages, the steps."""
    import torch

    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.ops.quant_matmul import qdot_acc
    from dynamo_tpu_torch.parallel.mesh import param_pspecs, shard_params

    cfg = get_config(inputs["model"]).with_overrides(dtype="float32")
    params = tl.params_from_jax(inputs["tree"], device="cpu")
    local = shard_params(params, param_pspecs(cfg), state.mesh, state.rank)
    kv_local = cfg.num_kv_heads // state.tp.size
    cache = tl.PagedKVCache.create(cfg.with_overrides(num_kv_heads=kv_local), NUM_PAGES, PS,
                                   torch.float32, torch.device("cpu"))
    out = {"logits": []}
    with torch.inference_mode():
        for fields, decode in inputs["steps"]:
            rb = tl.RaggedBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
            out["logits"].append(tl.forward_ragged(local, cfg, rb, cache, decode=decode,
                                                   shard=state).numpy())
        out["pages"] = cache.pages.numpy()
        if "acc_x" in inputs:
            # The row-parallel int8 product of wo: this rank's slice of x and
            # of the weight's rows, against the single-rank accumulator.
            x = torch.from_numpy(inputs["acc_x"])
            w = params["layers"]["wo"][0]
            k = x.shape[-1] // state.tp.size
            lo = state.tp.index * k
            got, ax = qdot_acc(x[:, lo:lo + k], local["layers"]["wo"][0], state.tp)
            want, ax1 = qdot_acc(x, w)
            out["acc_equal"] = bool(torch.equal(got, want) and torch.equal(ax, ax1))
            out["acc_nonzero"] = int((want != 0).sum())
    return out


JOBS = {"forward": _job_forward}


if __name__ == "__main__":
    rank_main(JOBS)
    sys.exit(0)


# ------------------------------------------------------------- the tests

if not os.environ.get(RANK_ENV):  # a rank (importing the helpers) needs no JAX
    import importlib

    import jax
    import jax.numpy as jnp
    import torch

    from dynamo_tpu.models.config import get_config as jax_get_config
    from dynamo_tpu.models.quant import quantize_params as jax_quantize
    from dynamo_tpu.parallel import mesh as jmesh
    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.parallel import mesh as tmesh

    jl = importlib.import_module("dynamo_tpu.models.llama")

pytestmark = pytest.mark.torch_port

MESHES = {"tp2": dict(tp=2), "ep2": dict(ep=2), "dp2tp2": dict(dp=2, tp=2)}


def _tree(model: str, quant: bool = False):
    cfg = jax_get_config(model).with_overrides(dtype="float32")
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    if quant:
        params = jax_quantize(params)
    return cfg, params


def _shard_of(arr, device) -> np.ndarray:
    for s in arr.addressable_shards:
        if s.device == device:
            return np.asarray(s.data)
    raise AssertionError(f"no shard on {device}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("tree", ["debug-tiny", "debug-tiny-w8a8", "debug-tiny-moe"])
def test_rank_slices_equal_jax_shards(tree, mesh):
    model = "debug-tiny-moe" if tree.endswith("moe") else "debug-tiny"
    cfg, params = _tree(model, quant=tree.endswith("w8a8"))
    jm = jmesh.make_mesh(jmesh.MeshConfig(**MESHES[mesh]))
    placed = jmesh.shard_tree(params, jmesh.param_pspecs(cfg), jm)
    tparams = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tm = tmesh.make_mesh(tmesh.MeshConfig(**MESHES[mesh]), [torch.device("cpu")] * 8)
    grid = np.asarray(jm.devices)
    checked = 0
    for rank in range(tm.size):
        c = tm.coords(rank)
        device = grid[c["dp"], c["ep"], c["sp"], c["tp"]]
        local = tmesh.shard_params(tparams, tmesh.param_pspecs(cfg), tm, rank)
        for name, leaf in placed.items():
            pairs = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
            for sub, arr in pairs:
                got = local[name] if sub is None else local[name][sub]
                want = _shard_of(arr, device)
                assert tuple(got.shape) == want.shape, (name, sub)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name}/{sub}")
                checked += 1
    assert checked > 10 * tm.size


def test_spec_trees_and_mesh_error_match_jax():
    cfg = jax_get_config("debug-tiny-moe")
    jspecs, tspecs = jmesh.param_pspecs(cfg), tmesh.param_pspecs(cfg)
    assert set(jspecs) == set(tspecs)
    for name, spec in jspecs.items():
        if isinstance(spec, dict):
            assert {k: tuple(v) for k, v in spec.items()} == tspecs[name]
        else:
            assert tuple(spec) == tspecs[name]
    assert tuple(jmesh.pages_pspec()) == tmesh.pages_pspec()
    cfg4 = dict(tp=4, dp=2)
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(jmesh.MeshConfig(**cfg4), jax.devices("cpu")[:3])
    with pytest.raises(ValueError) as got:
        tmesh.make_mesh(tmesh.MeshConfig(**cfg4), [torch.device("cpu")] * 3)
    assert str(got.value) == str(want.value)
    # The rank grid is JAX's device grid flattened: rank r at device r.
    jm = jmesh.make_mesh(jmesh.MeshConfig(dp=2, ep=2, tp=2))
    tm = tmesh.make_mesh(tmesh.MeshConfig(dp=2, ep=2, tp=2), [torch.device("cpu")] * 8)
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for rank in range(8):
        c = tm.coords(rank)
        assert ids[c["dp"], c["ep"], c["sp"], c["tp"]] == jax.devices("cpu")[rank].id
        assert tm.rank_of(c) == rank


def _batch(rows, T):
    """rows: [(all_tokens, start, n, table)] → numpy RaggedBatch fields."""
    tok = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    slots = np.full(T, -1, np.int32)
    kv = np.zeros(S, np.int32)
    tables = np.zeros((S, PP), np.int32)
    cu = np.zeros(S + 1, np.int32)
    at = 0
    for i, (toks, start, n, table) in enumerate(rows):
        p = np.arange(start, start + n)
        tok[at:at + n] = toks[start:start + n]
        pos[at:at + n] = p
        slots[at:at + n] = np.asarray(table)[p // PS] * PS + p % PS
        tables[i] = table
        kv[i] = start + n
        at += n
        cu[i + 1] = at
    cu[len(rows) + 1:] = at
    return dict(token_ids=tok, positions=pos, slot_mapping=slots, kv_lens=kv,
                page_indices=tables, cu_q_lens=cu, num_seqs=np.asarray([len(rows)], np.int32))


def _steps():
    rng = np.random.default_rng(0)
    perm = rng.permutation(NUM_PAGES).astype(np.int32)
    tables = [perm[i * PP:(i + 1) * PP] for i in range(S)]
    toks = [rng.integers(1, 256, size=20).tolist() for _ in range(S)]
    prefix = _batch([(toks[1], 0, 6, tables[1]), (toks[2], 0, 8, tables[2]),
                     (toks[3], 0, 2, tables[3])], 16)
    mixed = _batch([(toks[0], 0, 7, tables[0]), (toks[1], 6, 5, tables[1]),
                    (toks[2], 8, 1, tables[2]), (toks[3], 2, 1, tables[3])], 16)
    decode = _batch([(toks[i], start, 1, tables[i])
                     for i, start in enumerate([7, 11, 9, 3])], S)
    decode["cu_q_lens"] = np.arange(S + 1, dtype=np.int32)
    return [(prefix, False), (mixed, False), (decode, True)]


CASES = {
    "tp2-f32": ("debug-tiny", False, dict(tp=2), 1e-4),
    "tp2-w8a8": ("debug-tiny", True, dict(tp=2), 1e-5),
    "ep2-moe": ("debug-tiny-moe", False, dict(ep=2), 1e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_forward_matches_jax_mesh(case, tmp_path):
    model, quant, mesh, tol = CASES[case]
    cfg, params = _tree(model, quant)
    jm = jmesh.make_mesh(jmesh.MeshConfig(**mesh))
    placed = jmesh.shard_tree(params, jmesh.param_pspecs(cfg), jm)
    jcache = jl.PagedKVCache.create(cfg, NUM_PAGES, PS, dtype=jnp.float32)
    jcache = jmesh.shard_tree(jcache, jl.PagedKVCache(jmesh.pages_pspec()), jm)
    steps = _steps()
    want = []
    for fields, decode in steps:
        rb = jl.RaggedBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
        logits, jcache = jax.jit(
            lambda p, c, rb: jl.forward_ragged(p, cfg, rb, c, attn_impl="xla", mesh=jm,
                                               decode=decode))(placed, jcache, rb)
        want.append(np.asarray(logits))
    inputs = {"mesh": mesh, "model": model, "steps": steps,
              "tree": jax.tree_util.tree_map(np.asarray, params)}
    if quant:
        inputs["acc_x"] = np.random.default_rng(1).standard_normal(
            (24, cfg.num_heads * cfg.head_dim)).astype(np.float32)
    n = tmesh.MeshConfig(**mesh).num_devices
    outs = run_ranks(__file__, "forward", n, inputs, tmp_path)
    jpages = np.asarray(jcache.pages)
    kv2 = 2 * cfg.num_kv_heads // mesh.get("tp", 1)
    tm = tmesh.make_mesh(tmesh.MeshConfig(**mesh), [None] * n)
    for rank, out in enumerate(outs):
        for (fields, _), got, ref in zip(steps, out["logits"], want):
            rows = int(fields["num_seqs"][0])
            np.testing.assert_allclose(got[:rows], ref[:rows], rtol=tol, atol=tol)
        h0 = tm.coords(rank)["tp"] * kv2
        np.testing.assert_allclose(out["pages"], jpages[:, :, :, h0:h0 + kv2], rtol=1e-5,
                                   atol=1e-5)
        if quant:
            assert out["acc_equal"] and out["acc_nonzero"] > 0
