"""The port's GGUF container support against the JAX package's.

The cases of ``tests/test_gguf.py`` run on both packages with the same
files (written from a numpy seed by either package's writer): metadata and
tensors read back equal, ``to_model_config`` gives the same architecture,
``load_params_gguf`` gives the same tree bit for bit (``params_from_jax``
of the JAX one), quantized GGML types fail with the same message, and an
engine built from ``--checkpoint x.gguf`` serves the same greedy tokens.
The embedded tokenizer (``gpt2`` byte-level BPE and ``llama`` unigram)
gives the same ids and texts as the JAX package's ``tokenizers`` build,
directly and through discovery's ``gguf`` spec.
"""

import asyncio
from types import SimpleNamespace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.models import gguf as jg
from dynamo_tpu.models.loader import load_params as jax_load_params
from dynamo_tpu_torch.models import gguf as tg
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models.llama import params_from_jax
from test_torch_loader import assert_trees_equal

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
PKGS = {"jax": jg, "port": tg}


def _tiny_meta(vocab, arch="llama"):
    meta = {
        "general.architecture": "llama",
        "general.name": "tiny",
        "llama.block_count": 2,
        "llama.embedding_length": 16,
        "llama.attention.head_count": 4,
        "llama.attention.head_count_kv": 2,
        "llama.feed_forward_length": 32,
        "llama.context_length": 128,
        "llama.rope.freq_base": 10000.0,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": vocab,
        "tokenizer.ggml.merges": ["h e", "he l", "hel l", "hell o"],
        "tokenizer.ggml.bos_token_id": 0,
        "tokenizer.ggml.eos_token_id": 1,
    }
    if arch != "llama":
        meta = {k.replace("llama.", f"{arch}."): v for k, v in meta.items()}
        meta["general.architecture"] = arch
    return meta


def _tiny_tensors(rng, L=2, D=16, H=4, KV=2, hd=4, F=32, V=8, biases=False):
    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    t = {"token_embd.weight": n(V, D), "output_norm.weight": np.ones((D,), np.float32),
         "output.weight": n(V, D)}
    for i in range(L):
        t[f"blk.{i}.attn_norm.weight"] = np.ones((D,), np.float32)
        t[f"blk.{i}.attn_q.weight"] = n(H * hd, D)
        t[f"blk.{i}.attn_k.weight"] = n(KV * hd, D)
        t[f"blk.{i}.attn_v.weight"] = n(KV * hd, D)
        t[f"blk.{i}.attn_output.weight"] = n(D, H * hd)
        t[f"blk.{i}.ffn_norm.weight"] = np.ones((D,), np.float32)
        t[f"blk.{i}.ffn_gate.weight"] = n(F, D)
        t[f"blk.{i}.ffn_up.weight"] = n(F, D)
        t[f"blk.{i}.ffn_down.weight"] = n(D, F)
        if biases:
            t[f"blk.{i}.attn_q.bias"] = n(H * hd)
            t[f"blk.{i}.attn_k.bias"] = n(KV * hd)
            t[f"blk.{i}.attn_v.bias"] = n(KV * hd)
    return t


def _as(pkg, tensors, dtype):
    """``tensors`` in the form ``pkg``'s writer takes, in ``dtype``."""
    if pkg == "jax":
        dt = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}[dtype]
        return {k: v.astype(dt) for k, v in tensors.items()}
    dt = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}[dtype]
    return {k: torch.from_numpy(v).to(dt) for k, v in tensors.items()}


def _bits(a):
    """Raw bits of a tensor or array of any of the three float types."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    elif a.dtype == ml_dtypes.bfloat16:
        a = a.view(np.int16)
    return np.asarray(a)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_gguf_roundtrip_metadata_and_tensors(writer, dtype, tmp_path):
    """Either writer's file: both parsers read the same metadata and the
    same tensor bits."""
    rng = np.random.default_rng(0)
    vocab = ["h", "e", "l", "o", "he", "hel", "hell", "hello"]
    tensors = _tiny_tensors(rng)
    path = str(tmp_path / "tiny.gguf")
    PKGS[writer].write_gguf(path, _tiny_meta(vocab), _as(writer, tensors, dtype))
    files = {k: m.GGUFFile(path) for k, m in PKGS.items()}
    for g in files.values():
        assert g.architecture() == "llama"
        assert g.metadata["llama.block_count"] == 2
        assert g.metadata["tokenizer.ggml.tokens"] == vocab
        assert set(g.tensors) == set(tensors)
    assert files["jax"].metadata == files["port"].metadata
    assert files["jax"]._data_start == files["port"]._data_start
    for name in tensors:
        want = _bits(_as("jax", {name: tensors[name]}, dtype)[name])
        for g in files.values():
            assert np.array_equal(_bits(g.tensor(name)), want), name


def test_gguf_to_model_config(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    jg.write_gguf(path, _tiny_meta(["a"] * 8), _tiny_tensors(np.random.default_rng(1)))
    j = jg.GGUFFile(path).to_model_config()
    t = tg.GGUFFile(path).to_model_config()
    assert vars(j) == vars(t)
    assert t.num_layers == 2 and t.hidden_size == 16
    assert t.num_heads == 4 and t.num_kv_heads == 2
    assert t.vocab_size == 8 and t.eos_token_ids == (1,)


GGUF_TEXTS = ["hello", "hello hello", "hel lo", "oh hell", "", "he said: 'hello!'", "é hello"]


def _tokenizer_parity(path, texts):
    """Both packages' ``to_tokenizer`` on one file: equal ids with and
    without special tokens, equal decodes of those ids and of every id."""
    from dynamo_tpu.llm.discovery import make_tokenizer as jax_make
    from dynamo_tpu_torch.llm.discovery import make_tokenizer

    toks = [jg.GGUFFile(path).to_tokenizer(), tg.GGUFFile(path).to_tokenizer(),
            jax_make({"kind": "gguf", "file": path}), make_tokenizer({"kind": "gguf", "file": path})]
    j, t = toks[0], toks[1]
    assert (t.vocab_size, t.bos_token_id, t.eos_token_id) == (j.vocab_size, j.bos_token_id,
                                                              j.eos_token_id)
    for text in texts:
        for special in (True, False):
            ids = j.encode(text, add_special_tokens=special)
            assert [k.encode(text, add_special_tokens=special) for k in toks] == [ids] * 4, text
            for skip in (True, False):
                assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)
    every = list(range(j.vocab_size))
    assert t.decode(every) == j.decode(every)
    return j


def test_gguf_tokenizer_extraction(tmp_path):
    """The ``gpt2`` tokenizer a GGUF embeds (byte-level BPE, its merges):
    the port's equals the JAX package's id for id and text for text, and
    so does discovery's ``make_tokenizer`` for a ``gguf`` spec."""
    path = str(tmp_path / "tiny.gguf")
    vocab = ["h", "e", "l", "o", "he", "hel", "hell", "hello"]
    jg.write_gguf(path, _tiny_meta(vocab), _tiny_tensors(np.random.default_rng(2)))
    j = _tokenizer_parity(path, GGUF_TEXTS)
    assert j.encode("hello", add_special_tokens=False) == [vocab.index("hello")]


def test_gguf_llama_tokenizer_extraction(tmp_path):
    """The ``llama`` (sentencepiece) tokenizer a GGUF embeds: a unigram
    over the pieces' scores with its unk id and a ▁ → space decoder, id
    for id and text for text against the JAX package's."""
    path = str(tmp_path / "spm.gguf")
    vocab = ["<unk>", "<s>", "</s>", "▁", "h", "e", "l", "o", "▁he", "llo", "▁hello", "▁hel", "lo"]
    meta = dict(_tiny_meta(vocab), **{
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -2.0, -3.0, -3.0, -3.0, -3.0, -1.5, -1.0, -0.5,
                                  -1.2, -1.1],
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2})
    del meta["tokenizer.ggml.merges"]
    jg.write_gguf(path, meta, _tiny_tensors(np.random.default_rng(2), V=len(vocab)))
    _tokenizer_parity(path, GGUF_TEXTS + ["▁hello▁hel", "hello▁lo x"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("biases", [False, True], ids=["llama", "qwen2"])
def test_gguf_load_params(dtype, biases, tmp_path):
    """``load_params_gguf`` on both packages: the same tree bit for bit,
    Qwen2 biases included; and ``load_params`` of the ``.gguf`` path,
    quantized at load, equal to the JAX loader's."""
    rng = np.random.default_rng(3)
    tensors = _tiny_tensors(rng, biases=biases)
    path = str(tmp_path / "tiny.gguf")
    jg.write_gguf(path, _tiny_meta(["a"] * 8, "qwen2" if biases else "llama"), tensors)
    jcfg = jg.GGUFFile(path).to_model_config().with_overrides(dtype=dtype)
    tcfg = tg.GGUFFile(path).to_model_config().with_overrides(dtype=dtype)
    assert tcfg.qkv_bias == biases
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg.load_params_gguf(jcfg, path)),
                           device=CPU)
    got = tg.load_params_gguf(tcfg, path, dtype=dtype, device=CPU)
    assert_trees_equal(got, want)
    assert got["layers"]["wq"].shape == (2, 16, 16) and got["lm_head"].shape == (16, 8)
    if biases:
        assert torch.equal(got["layers"]["bv"][1].float(),
                           torch.from_numpy(tensors["blk.1.attn_v.bias"]).to(got["layers"]["bv"].dtype).float())
    jq = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_load_params(jcfg, path, quant="int8")),
                         device=CPU)
    assert_trees_equal(tloader.load_params(tcfg, path, quant="int8", device=CPU), jq)


def test_gguf_quantized_rejected(tmp_path):
    """A quantized GGML type fails with the JAX package's message."""
    path = str(tmp_path / "q.gguf")
    jg.write_gguf(path, _tiny_meta(["a"] * 8), {"x": np.zeros((4, 4), np.float32)})
    msgs = []
    for m in PKGS.values():
        g = m.GGUFFile(path)
        g.tensors["x"].ggml_type = 2  # Q4_0
        with pytest.raises(ValueError, match="quantized") as e:
            g.tensor("x")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_gguf_end_to_end_serving(tmp_path):
    """``run out=torch --checkpoint x.gguf``: config and weights come from
    the container, and the port's engine gives the JAX engine's greedy
    tokens."""
    from dynamo_tpu.engine import build_tpu_engine
    from dynamo_tpu_torch.engine import build_torch_engine
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context, collect

    path = str(tmp_path / "serve.gguf")
    jg.write_gguf(path, _tiny_meta(["a"] * 8), _tiny_tensors(np.random.default_rng(7)))

    def args(**kw):
        return SimpleNamespace(arch=None, checkpoint=path, model_config=None, block_size=4,
                               num_blocks=32, max_batch=2, max_model_len=64, prefill_chunk=32,
                               dtype="float32", **kw)

    req = PreprocessedRequest(
        token_ids=[1, 2, 3], stop_conditions=StopConditions(max_tokens=6, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0)).to_dict()

    async def run(engine):
        out = await collect(await engine.generate(Context(dict(req))))
        await engine.close()
        return [t for i in out for t in i["token_ids"]]

    port = build_torch_engine(args(device="cpu"))
    assert port.model_config.num_layers == 2
    got = asyncio.run(run(port))
    want = asyncio.run(run(build_tpu_engine(args())))
    assert got == want and len(got) == 6 and all(0 <= t < 8 for t in got)
