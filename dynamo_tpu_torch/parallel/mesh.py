"""The rank layout and sharding rules of the port's tensor, expert, data and
sequence parallelism.

Port of the JAX package's ``parallel/mesh.py``.  JAX builds one
``jax.sharding.Mesh`` over the devices and lets XLA place every shard and
insert the collectives; PyTorch's idiom is one process per rank, so here the
mesh is a rank layout: the JAX device grid ``(dp, ep, sp, tp)`` flattened in
its order, rank ``r`` sitting where device ``r`` sits in the JAX grid.  Each
rank holds only its own slice of every leaf (``shard_params``) and calls the
collectives itself (parallel/distributed.py, models/llama.py).

Axes (the JAX module's):

- ``dp``: data parallel.  Params and pages replicate over it and every dp
  rank computes the same replicated batch (the JAX mesh feeds each dp shard
  the whole batch), so it adds replicas, never a batch split.
- ``tp``: tensor parallel over attention heads, the FFN hidden dim and the
  vocabulary.  Row-parallel outputs (``wo``, ``w_down``) all-reduce, the
  vocab-sharded embedding all-reduces a masked lookup, the vocab-sharded
  head all-gathers the logits.
- ``ep``: expert parallel: MoE experts shard over it (their hidden dim over
  ``tp``), and the combine sums over the ``ep`` x ``tp`` group.
- ``sp``: sequence parallel: a long prompt's tokens shard over it in one
  ring-attention prefill (ops/ring_attention.py); weights and pages
  replicate over it.

The KV pages shard over ``tp`` on the combined K/V head axis, so paged
attention is local to a rank at its own head counts.

Specs are tuples of axis names (``None`` = not sharded), the JAX package's
``PartitionSpec`` trees without JAX; a leaf absent from the tree gets
``()``, replicated, as ``_spec_for_path`` treats it there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..models.config import ModelConfig

AXES = ("dp", "ep", "sp", "tp")  # the JAX grid's order, outermost first

Spec = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    tp: int = 1
    ep: int = 1  # expert parallel; 1 = experts replicated over ep
    sp: int = 1  # sequence parallel (ring attention, long-context prefill)

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.ep * self.sp


class Mesh:
    """The rank grid ``(dp, ep, sp, tp)``: rank ``r``'s coordinates are
    ``r`` unravelled in that order (tp fastest, as JAX reshapes its device
    list), and ``devices[r]`` is the device rank ``r`` runs on."""

    axis_names = AXES

    def __init__(self, config: MeshConfig, devices: Sequence[Any]):
        self.config = config
        self.devices = tuple(devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {a: getattr(self.config, a) for a in AXES}

    @property
    def size(self) -> int:
        return self.config.num_devices

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on every axis."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        out: Dict[str, int] = {}
        for a in reversed(AXES):
            n = getattr(self.config, a)
            out[a] = rank % n
            rank //= n
        return {a: out[a] for a in AXES}

    def rank_of(self, coords: Mapping[str, int]) -> int:
        r = 0
        for a in AXES:
            r = r * getattr(self.config, a) + int(coords.get(a, 0))
        return r

    def group_ranks(self, axes: Sequence[str], rank: int) -> List[int]:
        """The ranks that share every coordinate of ``rank`` but those on
        ``axes``, in grid order: ``rank``'s group for a collective over
        ``axes``.  Its position in the list is its index in the group."""
        base = self.coords(rank)
        out = []
        for r in range(self.size):
            c = self.coords(r)
            if all(c[a] == base[a] for a in AXES if a not in axes):
                out.append(r)
        return out

    def all_groups(self, axes: Sequence[str]) -> List[List[int]]:
        """Every group over ``axes``, each once, ordered by its first rank
        (every rank must create the process groups in one order)."""
        seen, out = set(), []
        for r in range(self.size):
            g = tuple(self.group_ranks(axes, r))
            if g not in seen:
                seen.add(g)
                out.append(list(g))
        return out


def check_tp(num_kv_heads: int, tp: int) -> None:
    """The pages shard the combined 2*kv_heads axis over tp: a tp that does
    not divide num_kv_heads would split a K/V pair across ranks."""
    if tp > 1 and num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_kv_heads={num_kv_heads} "
                         "(KV pages shard by head)")


def make_mesh(cfg: MeshConfig, devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The rank grid over ``devices`` (one per rank; by default one CUDA
    device, or the CPU when CUDA is absent).  Raises the JAX package's
    error when there are fewer devices than ranks."""
    n = cfg.num_devices
    if devices is None:
        devices = [torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")]
    if len(devices) < n:
        raise ValueError(f"need {n} devices for {cfg}, have {len(devices)}")
    return Mesh(cfg, list(devices)[:n])


def param_pspecs(config: ModelConfig) -> Dict[str, Any]:
    """The spec tree of models/llama.py's params (the JAX package's, axis
    for axis).

    Column-parallel (wq/wk/wv/w_gate/w_up): output features on tp.
    Row-parallel (wo/w_down): input features on tp, partial sums
    all-reduced.  Vocab on tp for embed and lm_head.  MoE experts on ep
    (and their hidden dim on tp).  An int8 weight's scale lies on its
    output channels and shards with them; row-parallel weights have
    replicated outputs."""
    del config  # one tree for every model; absent leaves are pruned
    layers = {
        "attn_norm": (),
        "wq": (None, None, "tp"),
        "wk": (None, None, "tp"),
        "wv": (None, None, "tp"),
        "wo": (None, "tp", None),
        "bq": (None, "tp"),
        "bk": (None, "tp"),
        "bv": (None, "tp"),
        "mlp_norm": (),
        "w_gate": (None, None, "tp"),
        "w_up": (None, None, "tp"),
        "w_down": (None, "tp", None),
        "router": (),
        "moe_gate": (None, "ep", None, "tp"),
        "moe_up": (None, "ep", None, "tp"),
        "moe_down": (None, "ep", "tp", None),
        "wq_scale": (None, "tp"),
        "wk_scale": (None, "tp"),
        "wv_scale": (None, "tp"),
        "wo_scale": (),
        "w_gate_scale": (None, "tp"),
        "w_up_scale": (None, "tp"),
        "w_down_scale": (),
        "moe_gate_scale": (None, "ep", "tp"),
        "moe_up_scale": (None, "ep", "tp"),
        "moe_down_scale": (None, "ep", None),
    }
    return {
        "embed": ("tp", None),
        "embed_scale": ("tp",),  # per vocab row, shards with embed
        "layers": layers,
        "final_norm": (),
        "lm_head": (None, "tp"),
        "lm_head_scale": ("tp",),
    }


def pages_pspec() -> Spec:
    """KV pages ``[L, P, ps, 2*KV, D]``: the combined K/V head axis on tp
    (tp divides num_kv_heads, so each K/V pair stays on one rank)."""
    return (None, None, None, "tp", None)


def spec_for(specs: Mapping[str, Any], path: Sequence[str]) -> Spec:
    """The spec at ``path`` in a spec tree; ``()`` where the tree has none."""
    spec: Any = specs
    for key in path:
        if not isinstance(spec, Mapping):
            return ()
        spec = spec.get(key, ())
    return tuple(spec) if isinstance(spec, tuple) else ()


def shard_slices(shape: Sequence[int], spec: Spec, mesh: Mesh, rank: int) -> Tuple[slice, ...]:
    """The slice of a ``shape`` leaf that rank ``rank`` holds under
    ``spec`` (trimmed or padded with ``None`` to the leaf's rank): dim d
    split evenly over its axis, chunk i to the rank at coordinate i, as
    ``NamedSharding`` places it."""
    coords = mesh.coords(rank)
    parts = (list(spec) + [None] * len(shape))[: len(shape)]
    out = []
    for d, axis in zip(shape, parts):
        if axis is None:
            out.append(slice(None))
            continue
        n = mesh.shape[axis]
        if d % n:
            raise ValueError(f"dim {d} does not split over {axis}={n}")
        c = d // n
        out.append(slice(coords[axis] * c, (coords[axis] + 1) * c))
    return tuple(out)


def shard_leaf(t: torch.Tensor, spec: Spec, mesh: Mesh, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t``, in memory of its own (never a view
    that keeps the whole leaf alive) and in ``t``'s layout: a column-major
    leaf (models/quant.operand_layout) stays column-major."""
    idx = shard_slices(t.shape, spec, mesh, rank)
    if all(s == slice(None) for s in idx):
        return t
    piece = t[idx]
    if t.dim() >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1:
        return piece.transpose(-1, -2).contiguous().transpose(-1, -2)
    return piece.contiguous().clone()


def shard_params(tree: Mapping[str, Any], specs: Mapping[str, Any], mesh: Mesh,
                 rank: int) -> Dict[str, Any]:
    """Rank ``rank``'s slice of every leaf of a params tree (the port's
    counterpart of placing the tree with ``shard_tree``)."""
    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = {n: shard_leaf(w, spec_for(specs, (name, n)), mesh, rank)
                         for n, w in leaf.items()}
        else:
            out[name] = shard_leaf(leaf, spec_for(specs, (name,)), mesh, rank)
    return out
