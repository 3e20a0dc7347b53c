"""HF safetensors checkpoint → this package's params tree, and back.

Port of the JAX package's ``models/loader.py``.  The safetensors format is
read and written here with the standard library and numpy (an 8-byte
little-endian header length, a JSON header, raw buffers mapped with
``mmap``), since the card's machine has no ``safetensors`` package.  BF16
buffers have no numpy dtype: they are read as ``uint16`` and viewed as
``torch.bfloat16``.

``load_params`` keeps the JAX loader's key map (HF llama/Qwen2 names onto
the stacked ``[L, ...]`` tree, torch ``[out, in]`` linears transposed to
``[in, out]``).  Each leaf is allocated once on the target device and
filled a layer at a time as tensors arrive, so no float transient of the
whole tree ever exists there: a full-depth 8B in bf16 is its 16 GB and
nothing more.  With ``quant="int8"`` each tensor is quantized on the device
as it arrives (``models/quant._quantize``, the arithmetic of
``quantize_array_np``), over the JAX package's axes.  With ``fuse=True`` the
q|k|v and gate|up leaves are allocated fused (``fuse_projections``'
layout), each projection written into its columns.

Mixtral-layout MoE checkpoints map as the JAX loader maps them: the router
``block_sparse_moe.gate.weight`` to ``router`` and the expert grid
``block_sparse_moe.experts.{e}.w1|w2|w3`` to ``moe_gate|moe_down|moe_up``,
all transposed, each expert written (and quantized) into ``[L, E, ...]``
leaves allocated once.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from .config import ModelConfig
from .quant import (
    _LAYER_QUANT_AXES, _TOP_QUANT_AXES, _quantize, fuse_projections, operand_layout,
    quantize_params,
)

Params = Dict[str, Any]

_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    # Qwen2-style attention biases ([out] vectors, no transpose).
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    # Mixtral MoE router: torch [E, D] → transpose → router [D, E].
    "block_sparse_moe.gate.weight": ("router", True),
}

# Mixtral expert sub-keys: block_sparse_moe.experts.{e}.{w}.weight.
# w1 = gate proj [F, D], w2 = down proj [D, F], w3 = up proj [F, D]; all
# transpose into the [in, out] layout moe_mlp consumes (models/moe.py:
# moe_gate/moe_up [E, D, F], moe_down [E, F, D]).
_EXPERT_MAP = {"w1": "moe_gate", "w2": "moe_down", "w3": "moe_up"}
_EXPERT_PREFIX = "block_sparse_moe.experts."

# ------------------------------------------------------------ safetensors

# safetensors dtype code → (torch dtype, numpy storage dtype).
_ST_DTYPES = {
    "F64": (torch.float64, np.float64),
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I64": (torch.int64, np.int64),
    "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}
_ST_CODES = {t: code for code, (t, _) in _ST_DTYPES.items()}
# Storage view for writing: dtypes numpy lacks go out as raw 16-bit words.
_ST_WRITE_VIEW = {torch.bfloat16: torch.int16}


def read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` for each tensor of one ``.safetensors``
    file, in buffer order.  Tensors are CPU views of a copy-on-write
    mapping of the file: nothing is read until used."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (short header)")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} past the end of the file")
        header = json.loads(f.read(n))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
    base = 8 + n
    header.pop("__metadata__", None)
    for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        code = info["dtype"]
        if code not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {code}")
        tdt, ndt = _ST_DTYPES[code]
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(x) for x in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np.dtype(ndt).itemsize or base + end > size or begin < 0:
            raise ValueError(f"{path}: tensor {name!r} has bad data offsets {begin}..{end}")
        if count == 0:
            yield name, torch.empty(shape, dtype=tdt)
            continue
        arr = np.frombuffer(mm, dtype=ndt, count=count, offset=base + begin).reshape(shape)
        t = torch.from_numpy(arr)
        yield name, (t.view(tdt) if tdt is torch.bfloat16 else t)


def _st_header(entries: List[Tuple[str, Tuple[int, ...], torch.dtype]],
               metadata: Optional[Mapping[str, str]]) -> Tuple[bytes, List[int]]:
    header: Dict[str, Any] = {}
    sizes, off = [], 0
    for name, shape, dt in entries:
        if dt not in _ST_CODES:
            raise ValueError(f"tensor {name!r}: dtype {dt} has no safetensors code")
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dt).element_size()
        header[name] = {"dtype": _ST_CODES[dt], "shape": list(shape),
                        "data_offsets": [off, off + nbytes]}
        sizes.append(nbytes)
        off += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the reference writer's 8-byte alignment
    return blob, sizes


def _write_tensor_bytes(f, t: torch.Tensor) -> None:
    t = t.detach().to("cpu").contiguous()
    if t.numel():
        f.write(memoryview(t.view(_ST_WRITE_VIEW.get(t.dtype, t.dtype)).numpy()).cast("B"))


def write_safetensors(path: str, tensors: Mapping[str, Any],
                      metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (torch tensors or numpy arrays, any device) to one
    ``.safetensors`` file in the given order; returns its data bytes."""
    ts = {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
          for k, v in tensors.items()}
    return _write_lazy(path, [(k, tuple(t.shape), t.dtype, (lambda t=t: t)) for k, t in ts.items()],
                       metadata)


def _write_lazy(path: str, entries: List[Tuple[str, Tuple[int, ...], torch.dtype,
                                               Callable[[], torch.Tensor]]],
                metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write tensors produced one at a time by their callables: the header
    comes from shapes, so only one tensor is materialised at once."""
    blob, sizes = _st_header([(n, s, d) for n, s, d, _ in entries], metadata)
    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for (name, shape, dt, make), nbytes in zip(entries, sizes):
            t = make()
            if tuple(t.shape) != tuple(shape) or t.dtype != dt:
                raise ValueError(f"tensor {name!r} came out {tuple(t.shape)} {t.dtype}, "
                                 f"declared {shape} {dt}")
            _write_tensor_bytes(f, t)
    os.replace(tmp, path)
    return sum(sizes)


def checkpoint_files(path: str) -> List[str]:
    """The ``.safetensors`` files of a checkpoint directory: those its
    ``model.safetensors.index.json`` names when present (every one must
    exist), else every ``.safetensors`` file, sorted."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f).get("weight_map") or {}
        files = sorted(set(weight_map.values()))
        missing = [n for n in files if not os.path.exists(os.path.join(path, n))]
        if missing:
            raise FileNotFoundError(f"{index} names missing shards {missing}")
    else:
        files = sorted(n for n in os.listdir(path) if n.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return [os.path.join(path, n) for n in files]


def iter_checkpoint(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    for fname in checkpoint_files(path):
        yield from read_safetensors(fname)


# ----------------------------------------------------------------- loading


def _dtype(dtype: Any, config: ModelConfig) -> torch.dtype:
    from .llama import torch_dtype

    return torch_dtype(dtype or config.dtype)


def _layer_shapes(config: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer shape of each unfused layer leaf (JAX layout, [in, out])."""
    D, F = config.hidden_size, config.intermediate_size
    q, kv = config.q_size, config.kv_size
    Fm = config.moe_intermediate_size or F
    return {
        "attn_norm": (D,), "mlp_norm": (D,),
        "wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D),
        "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
        "bq": (q,), "bk": (kv,), "bv": (kv,),
        # MoE: the router per layer, each expert's matrix per (layer, expert).
        "router": (D, config.num_experts),
        "moe_gate": (D, Fm), "moe_up": (D, Fm), "moe_down": (Fm, D),
    }


def _fused_parts(config: ModelConfig) -> Dict[str, Tuple[str, int]]:
    """part → (fused leaf, column offset) of ``fuse_projections``' layout."""
    q, kv, F = config.q_size, config.kv_size, config.intermediate_size
    return {
        "wq": ("wqkv", 0), "wk": ("wqkv", q), "wv": ("wqkv", q + kv),
        "bq": ("bqkv", 0), "bk": ("bqkv", q), "bv": ("bqkv", q + kv),
        "w_gate": ("w_gateup", 0), "w_up": ("w_gateup", F),
    }


class _TreeBuilder:
    """Allocates each leaf once on the device, at its first part's arrival,
    and writes parts into it a layer at a time."""

    def __init__(self, config: ModelConfig, dt: torch.dtype, quant: Optional[str],
                 device: torch.device, fuse: bool):
        self.config, self.dt, self.quant, self.dev = config, dt, quant, device
        self.shapes = _layer_shapes(config)
        self.parts = _fused_parts(config) if fuse else {}
        self.layers: Params = {}
        self.top: Params = {}
        self.filled: Dict[str, set] = {}

    def _leaf_of(self, part: str) -> Tuple[str, int, Tuple[int, ...]]:
        leaf, col = self.parts.get(part, (part, 0))
        members = [p for p, (lf, _) in self.parts.items() if lf == leaf] or [part]
        shape = list(self.shapes[part])
        shape[-1] = sum(self.shapes[p][-1] for p in members)
        return leaf, col, tuple(shape)

    def put_layer(self, part: str, idx: int, value: torch.Tensor) -> None:
        L = self.config.num_layers
        if not 0 <= idx < L:
            raise ValueError(f"checkpoint layer {idx} of {part} outside the config's {L} layers")
        if tuple(value.shape) != self.shapes[part]:
            raise ValueError(f"checkpoint {part} layer {idx}: shape {tuple(value.shape)} "
                             f"!= the config's {self.shapes[part]}")
        leaf, col, shape = self._leaf_of(part)
        width = self.shapes[part][-1]
        quantize = self.quant and part in _LAYER_QUANT_AXES
        if leaf not in self.layers:
            if quantize:  # int8 weights column-major per layer (models/quant.py)
                w = torch.empty((L, shape[1], shape[0]), dtype=torch.int8, device=self.dev)
                self.layers[leaf] = w.transpose(1, 2)
                self.layers[leaf + "_scale"] = torch.empty((L, shape[1]), dtype=torch.float32,
                                                           device=self.dev)
            else:
                self.layers[leaf] = torch.empty((L, *shape), dtype=self.dt, device=self.dev)
        v = value.to(self.dev)
        if quantize:
            q, s = _quantize(v, _LAYER_QUANT_AXES[part] - 1)  # stacked axis 0 dropped
            self.layers[leaf][idx][..., col: col + width].copy_(q)
            self.layers[leaf + "_scale"][idx][col: col + width].copy_(s)
        else:
            self.layers[leaf][idx][..., col: col + width].copy_(v)
        self.filled.setdefault(part, set()).add(idx)

    def put_expert(self, name: str, idx: int, e: int, value: torch.Tensor) -> None:
        """Write expert ``e`` of layer ``idx`` into the ``[L, E, in, out]``
        leaf ``name`` (quantized as it arrives under int8)."""
        L, E = self.config.num_layers, self.config.num_experts
        if not (0 <= idx < L and 0 <= e < E):
            raise ValueError(f"checkpoint {name} (layer {idx}, expert {e}) outside the "
                             f"config's {L} layers x {E} experts")
        shape = self.shapes[name]
        if tuple(value.shape) != shape:
            raise ValueError(f"checkpoint {name} layer {idx} expert {e}: shape "
                             f"{tuple(value.shape)} != the config's {shape}")
        if name not in self.layers:
            if self.quant:  # column-major per expert matrix (models/quant.py)
                w = torch.empty((L, E, shape[1], shape[0]), dtype=torch.int8, device=self.dev)
                self.layers[name] = w.transpose(-1, -2)
                self.layers[name + "_scale"] = torch.empty((L, E, shape[1]), dtype=torch.float32,
                                                           device=self.dev)
            else:
                self.layers[name] = torch.empty((L, E, *shape), dtype=self.dt, device=self.dev)
        v = value.to(self.dev)
        if self.quant:
            q, s = _quantize(v, _LAYER_QUANT_AXES[name] - 2)  # stacked [L, E] dropped
            self.layers[name][idx, e].copy_(q)
            self.layers[name + "_scale"][idx, e].copy_(s)
        else:
            self.layers[name][idx, e].copy_(v)
        self.filled.setdefault(name, set()).add((idx, e))

    def put_top(self, name: str, value: torch.Tensor) -> None:
        v = value.to(self.dev)
        if self.quant and name in _TOP_QUANT_AXES:
            q, s = _quantize(v, _TOP_QUANT_AXES[name])
            self.top[name] = operand_layout(q) if name == "lm_head" else q.contiguous()
            self.top[name + "_scale"] = s
        else:
            self.top[name] = v.to(self.dt).contiguous()

    def finish(self) -> Params:
        cfg = self.config
        L, E = cfg.num_layers, cfg.num_experts
        required = {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"}
        if cfg.is_moe:
            # Fail at load, not at the first forward's KeyError: a dense
            # checkpoint under an MoE config would silently drop experts.
            absent = {"router", "moe_gate", "moe_up", "moe_down"} - set(self.filled)
            if absent:
                raise ValueError(
                    f"config {cfg.name!r} is MoE ({E} experts) but checkpoint is "
                    f"missing {sorted(absent)} (block_sparse_moe.gate/experts tensors)")
            required.add("router")
            for name in ("moe_gate", "moe_up", "moe_down"):
                missing = sorted({(i, e) for i in range(L) for e in range(E)}
                                 - self.filled[name])
                if missing:
                    raise ValueError(f"checkpoint missing {name} for (layer, expert) "
                                     f"{missing[:8]}")
        else:
            required |= {"w_gate", "w_up", "w_down"}
        if cfg.qkv_bias or any(p in self.filled for p in ("bq", "bk", "bv")):
            required |= {"bq", "bk", "bv"}
        for part in sorted(required):
            missing = sorted(set(range(L)) - self.filled.get(part, set()))
            if missing:
                raise ValueError(f"checkpoint missing {part} for layers {missing}")
        if "embed" not in self.top:
            raise ValueError("checkpoint has no model.embed_tokens.weight")
        return {**self.top, "layers": self.layers}


def load_params(
    config: ModelConfig,
    path: str,
    dtype: Any = None,
    quant: Optional[str] = None,
    device: Optional[torch.device] = None,
    fuse: bool = False,
) -> Params:
    """Load a HF llama-family checkpoint directory (one file or shards with
    their index) into the params tree on ``device``; a ``.gguf`` path loads
    through the GGUF container.  ``quant="int8"`` quantizes each weight as
    it arrives; ``fuse`` allocates the fused projection leaves directly.
    The tree equals the JAX loader's (``params_from_jax`` of it, through
    ``fuse_projections`` when fused) bit for bit."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown weight quant {quant!r} (supported: int8)")
    dev = default_device(device)
    if path.endswith(".gguf"):
        from .gguf import load_params_gguf

        if quant:
            # The float tree is loaded and quantized on the host; only the
            # int8 tree reaches the device (the JAX loader's GGUF branch).
            params = quantize_params(load_params_gguf(config, path, dtype, "cpu"))
            params = {k: ({n: w.to(dev) for n, w in v.items()} if k == "layers" else v.to(dev))
                      for k, v in params.items()}
        else:
            params = load_params_gguf(config, path, dtype, dev)
        return fuse_projections(params) if fuse else params

    b = _TreeBuilder(config, _dtype(dtype, config), quant, dev, fuse)
    with torch.inference_mode():
        for key, tensor in iter_checkpoint(path):
            if key == "model.embed_tokens.weight":
                b.put_top("embed", tensor)
            elif key == "model.norm.weight":
                b.put_top("final_norm", tensor)
            elif key == "lm_head.weight":
                if not config.tie_word_embeddings:
                    b.put_top("lm_head", tensor.T)
            elif key.startswith("model.layers."):
                idx_str, sub = key[len("model.layers."):].split(".", 1)
                if sub.startswith(_EXPERT_PREFIX):
                    if not config.is_moe:
                        raise ValueError(f"config {config.name!r} is dense but checkpoint has "
                                         f"MoE expert tensors ({key})")
                    e_str, w_key = sub[len(_EXPERT_PREFIX):].split(".", 1)
                    name = _EXPERT_MAP.get(w_key.removesuffix(".weight"))
                    if name is not None:
                        b.put_expert(name, int(idx_str), int(e_str), tensor.T)
                    continue
                if sub == "block_sparse_moe.gate.weight" and not config.is_moe:
                    raise ValueError(f"config {config.name!r} is dense but checkpoint has "
                                     f"an MoE router ({key})")
                mapped = _LAYER_MAP.get(sub)
                if mapped is None:
                    continue  # rotary inv_freq buffers etc.
                name, transpose = mapped
                b.put_layer(name, int(idx_str), tensor.T if transpose else tensor)
        return b.finish()


# ------------------------------------------------------------------ writing


def hf_config(config: ModelConfig) -> Dict[str, Any]:
    """The ``config.json`` that ``ModelConfig.from_hf_config`` reads back
    into ``config`` (name aside: ``from_local_path`` names a config after
    its directory)."""
    arch, kind = (("MixtralForCausalLM", "mixtral") if config.is_moe
                  else ("Qwen2ForCausalLM", "qwen2") if config.qkv_bias
                  else ("LlamaForCausalLM", "llama"))
    out: Dict[str, Any] = {
        "architectures": [arch],
        "model_type": kind,
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads,
        "head_dim": config.head_dim,
        "intermediate_size": config.intermediate_size,
        "rope_theta": config.rope_theta,
        "rms_norm_eps": config.rms_norm_eps,
        "max_position_embeddings": config.max_position,
        "tie_word_embeddings": config.tie_word_embeddings,
        "attention_bias": config.qkv_bias,
        "torch_dtype": config.dtype,
    }
    if config.is_moe:
        out["num_local_experts"] = config.num_experts
        out["num_experts_per_tok"] = config.num_experts_per_token
        if config.moe_intermediate_size:
            out["intermediate_size"] = config.moe_intermediate_size
    if config.rope_scaling is not None:
        out["rope_scaling"] = dict(config.rope_scaling)
    if config.eos_token_ids:
        eos = list(config.eos_token_ids)
        out["eos_token_id"] = eos[0] if len(eos) == 1 else eos
    return out


def _hf_entries(params: Params) -> List[Tuple[str, Tuple[int, ...], torch.dtype,
                                              Callable[[], torch.Tensor]]]:
    """(HF name, shape, dtype, producer) for every tensor of an unfused
    float tree, in the JAX writer's order."""
    entries = []

    def add(name, t, transpose):
        shape = tuple(t.shape[::-1]) if transpose else tuple(t.shape)
        entries.append((name, shape, t.dtype,
                        (lambda t=t: t.T.contiguous()) if transpose else (lambda t=t: t)))

    add("model.embed_tokens.weight", params["embed"], False)
    add("model.norm.weight", params["final_norm"], False)
    if "lm_head" in params:
        add("lm_head.weight", params["lm_head"], True)
    inv = {v[0]: (k, v[1]) for k, v in _LAYER_MAP.items()}
    inv_expert = {v: k for k, v in _EXPERT_MAP.items()}
    for name, stacked in params["layers"].items():
        if name in inv_expert:
            for i in range(stacked.shape[0]):
                for e in range(stacked.shape[1]):
                    add(f"model.layers.{i}.{_EXPERT_PREFIX}{e}.{inv_expert[name]}.weight",
                        stacked[i, e], True)
            continue
        if name not in inv:
            continue
        hf_sub, transpose = inv[name]
        for i in range(stacked.shape[0]):
            add(f"model.layers.{i}.{hf_sub}", stacked[i], transpose)
    return entries


def save_params_hf(params: Params, path: str, max_shard_bytes: Optional[int] = None,
                   config: Optional[ModelConfig] = None) -> List[str]:
    """Write an unfused float params tree out in HF naming: one
    ``model.safetensors``, or with ``max_shard_bytes`` the
    ``model-0000i-of-0000n.safetensors`` shards plus
    ``model.safetensors.index.json``; with ``config`` also its
    ``config.json``.  Tensors are copied to the host one at a time.
    Returns the files written."""
    if any(k.endswith("_scale") for k in params["layers"]) or "wqkv" in params["layers"]:
        raise ValueError("save_params_hf writes unfused float trees")
    os.makedirs(path, exist_ok=True)
    entries = _hf_entries(params)
    nbytes = [int(np.prod(s, dtype=np.int64)) * torch.empty((), dtype=d).element_size()
              for _, s, d, _ in entries]
    shards: List[List[int]] = [[]]
    size = 0
    for i, n in enumerate(nbytes):
        if max_shard_bytes is not None and shards[-1] and size + n > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(i)
        size += n
    written = []
    if max_shard_bytes is None:
        names = ["model.safetensors"]
    else:
        names = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
    weight_map = {}
    for fname, idx in zip(names, shards):
        _write_lazy(os.path.join(path, fname), [entries[i] for i in idx],
                    metadata={"format": "pt"})
        weight_map.update({entries[i][0]: fname for i in idx})
        written.append(os.path.join(path, fname))
    if max_shard_bytes is not None:
        index = os.path.join(path, "model.safetensors.index.json")
        with open(index, "w") as f:
            json.dump({"metadata": {"total_size": sum(nbytes)}, "weight_map": weight_map}, f,
                      indent=2)
        written.append(index)
    if config is not None:
        cfg_path = os.path.join(path, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(hf_config(config), f, indent=2)
        written.append(cfg_path)
    return written
