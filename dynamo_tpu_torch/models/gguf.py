"""GGUF container support: parse model metadata and tensors from a single
``.gguf`` file, and write one.

Port of the JAX package's ``models/gguf.py`` (reference:
lib/llm/src/gguf/{mod,content,metadata}.rs): the same header, metadata and
tensor-directory layout and the same ``general.*`` / ``llama.*`` /
``tokenizer.ggml.*`` keys.  Unquantized F32/F16/BF16 tensors load into the
stacked params tree; quantized ggml types are refused with the JAX
package's message.  BF16 goes through ``uint16`` words viewed as
``torch.bfloat16`` (the card's machine has no ``ml_dtypes``).

The embedded tokenizer (``to_tokenizer``) is built from the port's own
pipeline objects (llm/hf_tokenizer.py): ``gpt2`` as byte-level BPE,
``llama`` as a unigram, as the JAX package builds them with ``tokenizers``.

Format (spec: ggml/docs/gguf.md):
  u32 magic "GGUF" | u32 version (2|3) | u64 n_tensors | u64 n_kv
  n_kv * (string key | u32 type | value)
  n_tensors * (string name | u32 n_dims | u64 dims[n] | u32 ggml_type | u64 offset)
  padding to `general.alignment` (default 32) | tensor data
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import default_device

GGUF_MAGIC = b"GGUF"

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)
_SCALARS = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d",
}

# ggml tensor types (subset; the rest are quantized blocks)
GGML_F32, GGML_F16 = 0, 1
GGML_BF16 = 30
_QUANT_NAMES = {
    2: "Q4_0", 3: "Q4_1", 6: "Q5_0", 7: "Q5_1", 8: "Q8_0", 9: "Q8_1",
    10: "Q2_K", 11: "Q3_K", 12: "Q4_K", 13: "Q5_K", 14: "Q6_K", 15: "Q8_K",
}
# ggml type → (torch dtype, numpy storage dtype)
_GGML_DTYPES = {
    GGML_F32: (torch.float32, np.float32),
    GGML_F16: (torch.float16, np.float16),
    GGML_BF16: (torch.bfloat16, np.uint16),
}
_GGML_OF = {torch.float32: GGML_F32, torch.float16: GGML_F16, torch.bfloat16: GGML_BF16}


def _ggml_dtype(ggml_type: int) -> Tuple[torch.dtype, Any]:
    if ggml_type in _GGML_DTYPES:
        return _GGML_DTYPES[ggml_type]
    name = _QUANT_NAMES.get(ggml_type, f"type {ggml_type}")
    raise ValueError(
        f"quantized GGUF tensor type {name} is not supported — export the "
        "checkpoint unquantized (F16/BF16); TPU serving runs bf16"
    )


@dataclass
class GGUFTensor:
    name: str
    shape: Tuple[int, ...]  # numpy order (outermost first)
    ggml_type: int
    offset: int  # relative to data section start


class GGUFFile:
    """Parsed GGUF: metadata dict + tensor directory + lazy tensor reads."""

    def __init__(self, path: str):
        self.path = path
        self.metadata: Dict[str, Any] = {}
        self.tensors: Dict[str, GGUFTensor] = {}
        self._data_start = 0
        with open(path, "rb") as f:
            self._parse(f)

    # ------------------------------------------------------------- parsing
    def _read(self, f: BinaryIO, fmt: str):
        size = struct.calcsize(fmt)
        raw = f.read(size)
        if len(raw) != size:
            raise ValueError(f"{self.path}: truncated GGUF header")
        return struct.unpack(fmt, raw)[0]

    def _read_str(self, f: BinaryIO) -> str:
        n = self._read(f, "<Q")
        return f.read(n).decode("utf-8")

    def _read_value(self, f: BinaryIO, vtype: int):
        if vtype in _SCALARS:
            return self._read(f, _SCALARS[vtype])
        if vtype == _BOOL:
            return bool(self._read(f, "<B"))
        if vtype == _STR:
            return self._read_str(f)
        if vtype == _ARR:
            etype = self._read(f, "<I")
            n = self._read(f, "<Q")
            return [self._read_value(f, etype) for _ in range(n)]
        raise ValueError(f"bad GGUF metadata type {vtype}")

    def _parse(self, f: BinaryIO) -> None:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        version = self._read(f, "<I")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = self._read(f, "<Q")
        n_kv = self._read(f, "<Q")
        for _ in range(n_kv):
            key = self._read_str(f)
            vtype = self._read(f, "<I")
            self.metadata[key] = self._read_value(f, vtype)
        for _ in range(n_tensors):
            name = self._read_str(f)
            n_dims = self._read(f, "<I")
            # GGUF stores ne[] innermost-first; numpy wants outermost-first.
            ne = [self._read(f, "<Q") for _ in range(n_dims)]
            ggml_type = self._read(f, "<I")
            offset = self._read(f, "<Q")
            self.tensors[name] = GGUFTensor(name, tuple(reversed(ne)), ggml_type, offset)
        align = int(self.metadata.get("general.alignment", 32))
        pos = f.tell()
        self._data_start = (pos + align - 1) // align * align

    # -------------------------------------------------------------- tensors
    def tensor(self, name: str) -> torch.Tensor:
        """Read one tensor: a CPU tensor over a copy-on-write mapping of
        the file (unquantized types only)."""
        info = self.tensors[name]
        tdt, ndt = _ggml_dtype(info.ggml_type)
        count = int(np.prod(info.shape, dtype=np.int64)) if info.shape else 1
        mm = np.memmap(self.path, dtype=ndt, mode="c",
                       offset=self._data_start + info.offset, shape=(count,))
        t = torch.from_numpy(np.asarray(mm)).reshape(info.shape)
        return t.view(tdt) if tdt is torch.bfloat16 else t

    # --------------------------------------------------------------- config
    def architecture(self) -> str:
        return str(self.metadata.get("general.architecture", "llama"))

    def to_model_config(self, name: str = "") -> "Any":
        """`llama.*` metadata → ModelConfig (reference: gguf/content.rs)."""
        from .config import ModelConfig

        arch = self.architecture()
        m = self.metadata

        def key(suffix: str, default=None):
            return m.get(f"{arch}.{suffix}", default)

        heads = int(key("attention.head_count"))
        hidden = int(key("embedding_length"))
        vocab = m.get(f"{arch}.vocab_size")
        if vocab is None:
            vocab = len(m.get("tokenizer.ggml.tokens", ())) or 32000
        eos = m.get("tokenizer.ggml.eos_token_id")
        return ModelConfig(
            name=name or str(m.get("general.name", "gguf-model")),
            vocab_size=int(vocab),
            hidden_size=hidden,
            num_layers=int(key("block_count")),
            num_heads=heads,
            num_kv_heads=int(key("attention.head_count_kv", heads)),
            head_dim=int(key("attention.key_length", hidden // heads)),
            intermediate_size=int(key("feed_forward_length")),
            rope_theta=float(key("rope.freq_base", 10000.0)),
            rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
            max_position=int(key("context_length", 4096)),
            eos_token_ids=(int(eos),) if eos is not None else (),
            # qwen2 GGUFs ship q/k/v biases.
            qkv_bias=arch == "qwen2",
        )

    # ------------------------------------------------------------ tokenizer
    def to_tokenizer(self):
        """Build a tokenizer from `tokenizer.ggml.*` metadata.

        `gpt2` model → byte-level BPE from tokens+merges; `llama` (SPM) →
        Unigram from tokens+scores.  Reference: gguf/mod.rs tokenizer
        extraction into their HF tokenizer."""
        from ..llm import hf_tokenizer as hf
        from ..llm.tokenizer import HFTokenizer

        m = self.metadata
        tokens: List[str] = m["tokenizer.ggml.tokens"]
        model = str(m.get("tokenizer.ggml.model", "gpt2"))
        if model == "gpt2":
            vocab = {t: i for i, t in enumerate(tokens)}
            merges = [tuple(s.split(" ", 1)) for s in m.get("tokenizer.ggml.merges", [])]
            tok = hf.Tokenizer(
                hf.BPE(vocab, merges, ignore_merges=True),
                pre_tokenizer=hf.build_pre_tokenizer({"type": "ByteLevel", "add_prefix_space": False}),
                decoder=hf.build_decoder({"type": "ByteLevel"}))
        elif model == "llama":
            scores = m.get("tokenizer.ggml.scores") or [0.0] * len(tokens)
            unk = int(m.get("tokenizer.ggml.unknown_token_id", 0))
            tok = hf.Tokenizer(
                hf.Unigram(list(zip(tokens, scores)), unk_id=unk),
                decoder=hf.build_decoder({"type": "Replace", "pattern": {"String": "▁"},
                                          "content": " "}))
        else:
            raise ValueError(f"unsupported tokenizer.ggml.model {model!r}")
        return HFTokenizer(
            tokenizer=tok,
            bos_token_id=m.get("tokenizer.ggml.bos_token_id"),
            eos_token_id=m.get("tokenizer.ggml.eos_token_id"),
        )


# ----------------------------------------------------------------- loading
# GGUF tensor names (ggml llama.cpp convention) → the stacked params tree.
_GGUF_LAYER_MAP = {
    "attn_norm.weight": ("attn_norm", False),
    "attn_q.weight": ("wq", True),
    "attn_k.weight": ("wk", True),
    "attn_v.weight": ("wv", True),
    # Qwen2-style attention biases ([out] vectors, no transpose).
    "attn_q.bias": ("bq", False),
    "attn_k.bias": ("bk", False),
    "attn_v.bias": ("bv", False),
    "attn_output.weight": ("wo", True),
    "ffn_norm.weight": ("mlp_norm", False),
    "ffn_gate.weight": ("w_gate", True),
    "ffn_up.weight": ("w_up", True),
    "ffn_down.weight": ("w_down", True),
}


def load_params_gguf(config, path: str, dtype: Any = None,
                     device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Load an unquantized GGUF checkpoint into the params tree on
    ``device`` (the JAX ``load_params_gguf``'s unfused tree; transposes
    ``[out, in]`` → ``[in, out]``).  Each stacked leaf is allocated once."""
    from .llama import torch_dtype

    dev = default_device(device)
    g = GGUFFile(path)
    dt = torch_dtype(dtype or config.dtype)
    L = config.num_layers
    params: Dict[str, Any] = {"layers": {}}
    seen: Dict[str, set] = {}
    with torch.inference_mode():
        for name in g.tensors:
            if name == "token_embd.weight":
                params["embed"] = g.tensor(name).to(dev).to(dt).contiguous()
            elif name == "output_norm.weight":
                params["final_norm"] = g.tensor(name).to(dev).to(dt).contiguous()
            elif name == "output.weight":
                params["lm_head"] = g.tensor(name).to(dev).to(dt).T.contiguous()
            elif name.startswith("blk."):
                idx_str, sub = name[len("blk."):].split(".", 1)
                mapped = _GGUF_LAYER_MAP.get(sub)
                if mapped is None:
                    continue
                ours, transpose = mapped
                t = g.tensor(name).to(dev)
                t = t.T if transpose else t
                idx = int(idx_str)
                if not 0 <= idx < L:
                    raise ValueError(f"gguf layer {idx} of {ours} outside the config's {L} layers")
                leaf = params["layers"].get(ours)
                if leaf is None:
                    leaf = params["layers"][ours] = torch.empty((L, *t.shape), dtype=dt, device=dev)
                leaf[idx].copy_(t)
                seen.setdefault(ours, set()).add(idx)
    for ours, idxs in seen.items():
        missing = sorted(set(range(L)) - idxs)
        if missing:
            raise ValueError(f"gguf missing {ours} for layers {missing}")
    if "embed" not in params:
        raise ValueError("gguf missing token_embd.weight")
    if "lm_head" not in params and not config.tie_word_embeddings:
        # llama.cpp only omits output.weight for TIED embeddings.
        raise ValueError(
            "gguf missing output.weight but config is not tied "
            "(tie_word_embeddings=False)"
        )
    return params


# ------------------------------------------------------------------ writer
def _write_str(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)) + b)


def _value_type(v: Any) -> int:
    if isinstance(v, bool):
        return _BOOL
    if isinstance(v, int):
        return _U32 if 0 <= v < 2**32 else _I64
    if isinstance(v, float):
        return _F32
    if isinstance(v, str):
        return _STR
    raise ValueError(f"can't encode metadata value {v!r}")


def _write_value(f: BinaryIO, v: Any) -> None:
    if isinstance(v, bool):
        f.write(struct.pack("<I", _BOOL) + struct.pack("<B", int(v)))
    elif isinstance(v, int):
        t = _value_type(v)
        f.write(struct.pack("<I", t) + struct.pack(_SCALARS[t], v))
    elif isinstance(v, float):
        f.write(struct.pack("<I", _F32) + struct.pack("<f", v))
    elif isinstance(v, str):
        f.write(struct.pack("<I", _STR))
        _write_str(f, v)
    elif isinstance(v, (list, tuple)):
        f.write(struct.pack("<I", _ARR))
        if not v:
            f.write(struct.pack("<I", _STR) + struct.pack("<Q", 0))
            return
        et = _value_type(v[0])
        f.write(struct.pack("<I", et) + struct.pack("<Q", len(v)))
        for item in v:
            if et == _STR:
                _write_str(f, item)
            elif et == _BOOL:
                f.write(struct.pack("<B", int(item)))
            else:
                f.write(struct.pack(_SCALARS[et], item))
    else:
        raise ValueError(f"can't encode metadata value {v!r}")


def write_gguf(
    path: str,
    metadata: Dict[str, Any],
    tensors: Dict[str, Any],
    alignment: int = 32,
) -> None:
    """Minimal GGUF v3 writer.  ``tensors``: torch tensors (f32, f16,
    bf16) or numpy arrays (f32, f16)."""
    ts: Dict[str, torch.Tensor] = {}
    for name, a in tensors.items():
        t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        if t.dtype not in _GGML_OF:
            raise ValueError(f"unsupported tensor dtype {t.dtype}")
        ts[name] = t.detach().to("cpu").contiguous()

    def nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<Q", len(ts)))
        meta = dict(metadata)
        meta.setdefault("general.alignment", alignment)
        f.write(struct.pack("<Q", len(meta)))
        for k, v in meta.items():
            _write_str(f, k)
            _write_value(f, v)
        offset = 0
        for name, t in ts.items():
            _write_str(f, name)
            ne = list(reversed(t.shape))
            f.write(struct.pack("<I", len(ne)))
            for d in ne:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<I", _GGML_OF[t.dtype]) + struct.pack("<Q", offset))
            offset += (nbytes(t) + alignment - 1) // alignment * alignment
        f.write(b"\x00" * ((-f.tell()) % alignment))
        for t in ts.values():
            if t.numel():
                raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                f.write(memoryview(raw.numpy()).cast("B"))
            f.write(b"\x00" * ((-nbytes(t)) % alignment))
