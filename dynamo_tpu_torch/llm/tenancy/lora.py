"""Batched multi-LoRA serving: adapter registry + resident device slots.

A copy of the JAX package's ``llm/tenancy/lora.py`` (S-LoRA, Sheng et al.,
arXiv:2311.03285): one base model serves many low-rank adapters by keeping
them in a host-side pool, promoting the actively used ones into device
memory, and applying them *batched*, so one forward pass serves rows from
many adapters (models/llama.py):

- the engine owns a fixed-shape DEVICE BANK per target projection,
  ``[L, in, R*r]`` A-factors and ``[L, R*r, out]`` B-factors for R resident
  slots of rank ceiling r, so hot-swapping an adapter is an in-place column
  write into tensors the captured CUDA graphs read, never a new graph;
- every batch row carries an adapter SLOT id (-1 = base model); the forward
  computes ``(x @ A_all) * slot_mask @ B_all``;
- adapters are merge-free: base weights (possibly int8) are never touched.

This module is host-side policy: the ``AdapterRegistry`` holds loaded
adapters (numpy factors, alpha/r folded into B), manages the LRU-bounded
resident set with refcounts (an adapter is never evicted while a sequence
uses it), and promotes through an engine-supplied apply hook.  KV
isolation: ``kv_salt_for_adapter`` is the ONE derivation of the tenant salt
mixed into the chained block hashes (tokens.py).  PEFT directories are read
with the package's own safetensors reader (models/loader.py), and
``save_lora_adapter`` writes one.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..metrics import tenancy_metrics

logger = logging.getLogger(__name__)

# Projections adapters apply to (attention q/k/v/o — the S-LoRA default).
LORA_TARGETS = ("wq", "wk", "wv", "wo")

_HF_TARGET_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
}


def kv_salt_for_adapter(name: str) -> str:
    """Tenant salt mixed into KV block hashes (tokens.py salt_hash).  The
    single source of truth — engine and router must agree or routing overlap
    scores diverge from engine cache state."""
    return f"lora/{name}"


def target_dims(model_config) -> Dict[str, Tuple[int, int]]:
    """(in, out) dims per LoRA target projection."""
    D = model_config.hidden_size
    q = model_config.num_heads * model_config.head_dim
    kv = model_config.num_kv_heads * model_config.head_dim
    return {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D)}


class AdapterError(ValueError):
    """Malformed adapter (shape/rank mismatch)."""


class AdapterCapacityError(RuntimeError):
    """All resident slots pinned by active sequences; promotion timed out.

    Transient by construction (a slot frees when any pinning sequence
    finishes): the HTTP edge maps it to 503 + Retry-After, and the wire
    tag below lets remote edges do the same without importing us."""

    error_kind = "adapter_capacity"


@dataclass
class LoraAdapter:
    """One adapter's host-side factors.

    ``factors[target] = (A, B)`` with A ``[L, in, r]`` and B ``[L, r, out]``
    float32 numpy; the LoRA scale (alpha/r) is already folded into B.
    Missing targets are simply identity (zero delta).
    """

    name: str
    rank: int
    factors: Dict[str, Tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)

    def validate(self, model_config, max_rank: int) -> None:
        if self.rank < 1 or self.rank > max_rank:
            raise AdapterError(
                f"adapter {self.name!r} rank {self.rank} outside [1, {max_rank}]"
            )
        dims = target_dims(model_config)
        L = model_config.num_layers
        for tgt, (a, b) in self.factors.items():
            if tgt not in dims:
                raise AdapterError(f"adapter {self.name!r}: unknown target {tgt!r}")
            din, dout = dims[tgt]
            if a.shape != (L, din, self.rank) or b.shape != (L, self.rank, dout):
                raise AdapterError(
                    f"adapter {self.name!r} target {tgt}: shapes "
                    f"{a.shape}/{b.shape} != {(L, din, self.rank)}/"
                    f"{(L, self.rank, dout)}"
                )

    @classmethod
    def random(
        cls,
        model_config,
        name: str,
        rank: int = 4,
        seed: int = 0,
        scale: float = 0.05,
        targets: Tuple[str, ...] = LORA_TARGETS,
    ) -> "LoraAdapter":
        """Synthetic adapter for tests/benchmarks.  Unlike training-time
        LoRA init (B=0, a no-op), BOTH factors are non-zero so distinct
        adapters produce distinct streams — the property the multi-tenant
        correctness gates assert."""
        rng = np.random.default_rng(seed)
        dims = target_dims(model_config)
        L = model_config.num_layers
        factors = {}
        for tgt in targets:
            din, dout = dims[tgt]
            a = rng.standard_normal((L, din, rank)).astype(np.float32) * scale
            b = rng.standard_normal((L, rank, dout)).astype(np.float32) * scale
            factors[tgt] = (a, b)
        return cls(name=name, rank=rank, factors=factors)


def load_lora_adapter(path: str, model_config, name: Optional[str] = None) -> LoraAdapter:
    """Load a PEFT-format adapter directory (adapter_config.json +
    adapter_model.safetensors).  HF torch layouts map to the matmul layout:
    lora_A ``[r, in]`` → A ``[in, r]``, lora_B ``[out, r]`` → B ``[r, out]``;
    the LoRA scale alpha/r folds into B at load."""
    cfg_path = os.path.join(path, "adapter_config.json")
    rank, alpha = 8, 8.0
    if os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            cfg = json.load(fh)
        rank = int(cfg.get("r", rank))
        alpha = float(cfg.get("lora_alpha", rank))
    weights = os.path.join(path, "adapter_model.safetensors")
    if not os.path.exists(weights):
        raise AdapterError(f"no adapter_model.safetensors under {path}")
    from ...models.loader import read_safetensors

    L = model_config.num_layers
    grids: Dict[str, Dict[str, List[Optional[np.ndarray]]]] = {}
    for key, tensor in read_safetensors(weights):
        # ...model.layers.{i}.self_attn.{q_proj}.lora_{A|B}.weight
        parts = key.split(".")
        try:
            li = parts.index("layers")
            layer = int(parts[li + 1])
            proj = parts[li + 3]
            which = parts[li + 4]  # lora_A | lora_B
        except (ValueError, IndexError):
            continue
        tgt = _HF_TARGET_MAP.get(proj)
        if tgt is None or which not in ("lora_A", "lora_B"):
            continue
        t = tensor.float().numpy()
        grid = grids.setdefault(tgt, {"A": [None] * L, "B": [None] * L})
        grid["A" if which == "lora_A" else "B"][layer] = t
    factors: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    scaling = alpha / rank
    for tgt, grid in grids.items():
        missing = [
            i for i in range(L) if grid["A"][i] is None or grid["B"][i] is None
        ]
        if missing:
            raise AdapterError(
                f"adapter at {path}: target {tgt} missing layers {missing[:8]}"
            )
        a = np.stack([t.T for t in grid["A"]])  # [L, in, r]
        b = np.stack([t.T for t in grid["B"]]) * scaling  # [L, r, out]
        factors[tgt] = (a, b)
    if not factors:
        raise AdapterError(f"adapter at {path} has no q/k/v/o lora tensors")
    adapter = LoraAdapter(
        name=name or os.path.basename(path.rstrip("/")), rank=rank, factors=factors
    )
    adapter.validate(model_config, max_rank=rank)
    return adapter


def save_lora_adapter(adapter: LoraAdapter, path: str) -> None:
    """Write ``adapter`` as a PEFT directory (``adapter_config.json`` with
    ``lora_alpha == r``, so B is stored as is, and
    ``adapter_model.safetensors`` in HF torch layouts) that
    ``load_lora_adapter`` reads back to the same factors."""
    from ...models.loader import write_safetensors

    os.makedirs(path, exist_ok=True)
    inv = {v: k for k, v in _HF_TARGET_MAP.items()}
    tensors: Dict[str, np.ndarray] = {}
    for tgt, (a, b) in adapter.factors.items():
        for i in range(a.shape[0]):
            stem = f"base_model.model.model.layers.{i}.self_attn.{inv[tgt]}"
            tensors[f"{stem}.lora_A.weight"] = np.ascontiguousarray(a[i].T, np.float32)
            tensors[f"{stem}.lora_B.weight"] = np.ascontiguousarray(b[i].T, np.float32)
    write_safetensors(os.path.join(path, "adapter_model.safetensors"), tensors)
    with open(os.path.join(path, "adapter_config.json"), "w") as fh:
        json.dump({"peft_type": "LORA", "r": adapter.rank, "lora_alpha": adapter.rank,
                   "target_modules": sorted(inv[t] for t in adapter.factors)}, fh)


def bank_leaves(model_config, max_adapters: int, rank: int) -> Dict[str, np.ndarray]:
    """Zero-initialized device-bank leaves for ``params["layers"]``:
    ``lora_a_{t}`` [L, in, R*r] and ``lora_b_{t}`` [L, R*r, out] per target.
    All-zero columns are an exact no-op, so freshly-created slots and the
    base model share one code path (slot mask -1 never matches anyway)."""
    dims = target_dims(model_config)
    L = model_config.num_layers
    Rr = max_adapters * rank
    out: Dict[str, np.ndarray] = {}
    for tgt in LORA_TARGETS:
        din, dout = dims[tgt]
        out[f"lora_a_{tgt}"] = np.zeros((L, din, Rr), np.float32)
        out[f"lora_b_{tgt}"] = np.zeros((L, Rr, dout), np.float32)
    return out


def padded_factors(
    adapter: Optional[LoraAdapter], model_config, target: str, rank: int
) -> Tuple[np.ndarray, np.ndarray]:
    """One slot's column block for ``target``, rank-padded to the bank's
    per-slot ceiling (None adapter or missing target → zeros = no-op)."""
    dims = target_dims(model_config)
    din, dout = dims[target]
    L = model_config.num_layers
    a = np.zeros((L, din, rank), np.float32)
    b = np.zeros((L, rank, dout), np.float32)
    if adapter is not None:
        pair = adapter.factors.get(target)
        if pair is not None:
            ra = min(adapter.rank, rank)
            a[:, :, :ra] = pair[0][:, :, :ra]
            b[:, :ra, :] = pair[1][:, :ra, :]
    return a, b


# ApplyFn(slot, adapter_or_None) promotes an adapter's (padded) factors into
# the device bank's slot columns; awaited under the engine's device lock.
ApplyFn = Callable[[int, Optional[LoraAdapter]], Awaitable[None]]


class AdapterRegistry:
    """Host-side adapter pool + LRU-bounded resident device slots.

    - ``register``/``unregister``: host bookkeeping only (numpy factors).
    - ``acquire(name)``: resolve the adapter to a resident slot, promoting
      (async H2D through ``apply_fn``) and LRU-evicting an idle resident if
      needed; takes a refcount that pins the slot for the sequence's life.
    - ``release(name)``: drop the ref; zero-ref residents become eviction
      candidates (factors stay on device — re-acquiring is free until a
      promotion overwrites the slot).

    A slot is NEVER rewritten while its refcount is non-zero: in-flight
    batch rows address slots by index, so overwriting a live slot would
    silently switch a running sequence's adapter mid-stream.
    """

    def __init__(self, max_resident: int, max_rank: int, apply_fn: ApplyFn,
                 promote_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_resident < 1:
            raise ValueError("lora max_adapters must be >= 1")
        self.max_resident = max_resident
        self.max_rank = max_rank
        self._apply = apply_fn
        self.promote_timeout_s = promote_timeout_s
        # Injectable clock: promotion deadlines must be testable without
        # real waiting and identical under sim/replay.
        self._clock = clock
        self._adapters: Dict[str, LoraAdapter] = {}
        self._slot_of: Dict[str, int] = {}  # resident name → slot
        self._owner: List[Optional[str]] = [None] * max_resident
        self._refs: List[int] = [0] * max_resident
        # Residents LRU (oldest first) — eviction order among ref==0 slots.
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._claim_lock = asyncio.Lock()
        self._freed = asyncio.Event()

    # ----------------------------------------------------------- host pool
    def register(self, adapter: LoraAdapter, model_config) -> None:
        adapter.validate(model_config, self.max_rank)
        fresh = adapter.name not in self._adapters
        self._adapters[adapter.name] = adapter
        if not fresh and adapter.name in self._slot_of:
            # Re-registration with new factors: invalidate the resident copy
            # (promoted again on next acquire).  Refused while in use.
            slot = self._slot_of[adapter.name]
            if self._refs[slot]:
                raise AdapterError(
                    f"adapter {adapter.name!r} is serving sequences; "
                    "cannot replace its factors in place"
                )
            self._evict_slot(slot)
        if fresh:
            tenancy_metrics.adapters_registered += 1

    def unregister(self, name: str) -> None:
        if name not in self._adapters:
            return
        slot = self._slot_of.get(name)
        if slot is not None:
            if self._refs[slot]:
                raise AdapterError(
                    f"adapter {name!r} is serving sequences; drain first"
                )
            self._evict_slot(slot)
        del self._adapters[name]
        tenancy_metrics.adapters_registered -= 1

    def has(self, name: str) -> bool:
        return name in self._adapters

    def get(self, name: str) -> Optional[LoraAdapter]:
        return self._adapters.get(name)

    def names(self) -> List[str]:
        return sorted(self._adapters)

    def resident(self) -> Dict[str, int]:
        return dict(self._slot_of)

    # -------------------------------------------------------- device slots
    def _evict_slot(self, slot: int) -> None:
        owner = self._owner[slot]
        if owner is not None:
            self._slot_of.pop(owner, None)
            self._lru.pop(owner, None)
            self._owner[slot] = None
            tenancy_metrics.adapter_evictions += 1

    def _find_free_slot(self) -> Optional[int]:
        for slot, owner in enumerate(self._owner):
            if owner is None:
                return slot
        # LRU-evict the coldest idle resident.
        for name in self._lru:
            slot = self._slot_of[name]
            if self._refs[slot] == 0:
                self._evict_slot(slot)
                return slot
        return None

    async def acquire(self, name: str) -> int:
        """Resident slot for ``name`` with a ref taken.  Raises KeyError for
        unknown adapters (callers map it to their model-not-found error) and
        AdapterCapacityError when every slot stays pinned past the
        promotion timeout."""
        if name not in self._adapters:
            raise KeyError(name)
        deadline = self._clock() + self.promote_timeout_s
        while True:
            # Serialize claims so two concurrent acquires cannot race one
            # slot; the H2D promotion happens inside the claim.
            async with self._claim_lock:
                adapter = self._adapters.get(name)
                if adapter is None:
                    raise KeyError(name)
                slot = self._slot_of.get(name)
                if slot is not None:
                    self._refs[slot] += 1
                    self._lru.pop(name, None)
                    self._lru[name] = None
                    return slot
                slot = self._find_free_slot()
                if slot is not None:
                    self._owner[slot] = name
                    self._slot_of[name] = slot
                    self._refs[slot] = 1
                    self._lru[name] = None
                    try:
                        await self._apply(slot, adapter)
                    except BaseException:
                        # Failed promotion must not leave a claimed slot
                        # pointing at garbage factors.
                        self._refs[slot] = 0
                        self._evict_slot(slot)
                        raise
                    tenancy_metrics.adapter_promotions += 1
                    return slot
                self._freed.clear()
            timeout = deadline - self._clock()
            if timeout <= 0:
                raise AdapterCapacityError(
                    f"all {self.max_resident} adapter slots are pinned by "
                    f"active sequences; cannot promote {name!r}"
                )
            try:
                await asyncio.wait_for(self._freed.wait(), timeout)
            except asyncio.TimeoutError:
                raise AdapterCapacityError(
                    f"all {self.max_resident} adapter slots are pinned by "
                    f"active sequences; cannot promote {name!r}"
                ) from None

    def release(self, name: str) -> None:
        slot = self._slot_of.get(name)
        if slot is None:
            return
        self._refs[slot] = max(0, self._refs[slot] - 1)
        if self._refs[slot] == 0:
            self._freed.set()  # wake acquire() waiters to re-scan
