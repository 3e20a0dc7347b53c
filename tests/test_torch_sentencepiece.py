"""The port's sentencepiece tokenizer against the JAX package's.

Every case of the JAX package's ``tests/test_sentencepiece.py`` runs on
both packages (its source loaded with the ``dynamo_tpu.`` imports pointed
at ``dynamo_tpu_torch.``, one parametrised case per package; on the port
the golden checkpoint serve builds its engine with ``build_torch_engine``
on the CPU), except the parity check against the ``sentencepiece``
library, which this image does not have.  Then ids, texts and incremental
detokenization are held equal across the packages on the reference test's
protos and on seeded random texts, the port logs where the normalization
neither package runs would change a text, a tokenizer_config.json chat
template renders as the JAX package renders it, ``hf`` specs are served,
and a ``tokenizer.model``-only checkpoint is served by ``run in=http
out=torch --checkpoint DIR`` with the JAX engine's greedy tokens.
"""

import asyncio
import importlib
import json
import logging
import os
import re
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_planner import JAX, PORT, REPO, load_reference_tests, run_reference_case

pytestmark = pytest.mark.torch_port

PKGS = (PORT, JAX)
REF_FILE = "test_sentencepiece.py"
NOT_MIRRORED = {
    "test_parity_against_real_sentencepiece",  # needs the sentencepiece library
}
# The port's name for the engine factory, and the CPU its entry points
# need spelled out (device.py); each must be found exactly once.
PORT_ENGINE = (("build_tpu_engine", "build_torch_engine", 2),
               ('dtype="float32",\n        )', 'dtype="float32", device="cpu",\n        )', 1))


def _load_port_reference():
    path = os.path.join(REPO, "tests", REF_FILE)
    src = re.sub(r"\bdynamo_tpu\.", f"{PORT}.", open(path, encoding="utf-8").read())
    for old, new, count in PORT_ENGINE:
        assert src.count(old) == count, old
        src = src.replace(old, new)
    mod = types.ModuleType(f"_ref_test_sentencepiece_{PORT}_cpu")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


REF = {JAX: load_reference_tests(REF_FILE, JAX), PORT: _load_port_reference()}
CASES = sorted(n for n, f in vars(REF[JAX]).items()
               if n.startswith("test_") and callable(f) and n not in NOT_MIRRORED)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", CASES)
async def test_reference_sentencepiece_case(case, pkg, tmp_path):
    """``tests/test_sentencepiece.py::<case>`` on ``pkg``."""
    await run_reference_case(REF[pkg], case, tmp_path)


def _sp(pkg):
    return importlib.import_module(f"{pkg}.llm.sp")


def _protos():
    """The reference test's vocabularies (unigram with byte fallback, BPE,
    specials) as piece lists, plus a larger seeded unigram one."""
    sp = _sp(JAX)
    m, _ = REF[JAX]._unigram_model()
    unigram = [(m.pieces[i], m.scores[i], m.types[i]) for i in range(m.vocab_size)]
    bpe = [("<unk>", 0.0, sp.UNKNOWN), ("<s>", 0.0, sp.CONTROL), ("</s>", 0.0, sp.CONTROL),
           ("▁", -3.0, sp.NORMAL), ("a", -4.0, sp.NORMAL), ("b", -4.0, sp.NORMAL),
           ("ab", -1.0, sp.NORMAL), ("▁ab", -2.0, sp.NORMAL), ("abab", -2.5, sp.NORMAL)]
    bpe += [(f"<0x{b:02X}>", -20.0, sp.BYTE) for b in range(256)]
    rng = np.random.default_rng(11)
    big = [("<unk>", 0.0, sp.UNKNOWN), ("<s>", 0.0, sp.CONTROL), ("</s>", 0.0, sp.CONTROL),
           ("[INST]", 0.0, sp.USER_DEFINED)]
    big += [(f"<0x{b:02X}>", -30.0, sp.BYTE) for b in range(256)]
    seen = {p for p, _, _ in big}
    alphabet = list("abcdefghij ")
    while len(big) < 2000:
        w = "".join(rng.choice(alphabet, size=int(rng.integers(1, 6)))).replace(" ", "▁")
        if w not in seen:
            seen.add(w)
            big.append((w, float(-rng.random() * 12), sp.NORMAL))
    return {"unigram": (unigram, 1), "bpe": (bpe, 2), "big-unigram": (big, 1),
            "big-bpe": (big, 2)}


def _texts(seed, n=60):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghij hello world ab") + ["é", "ö", "中", "\n", "[INST]", "<s>"]
    out = ["", "a", "hello world", "héllo wörld", "<s>[INST] hi", "abab" * 50]
    for _ in range(n):
        out.append("".join(rng.choice(alphabet, size=int(rng.integers(1, 40)))))
    return out


PROTOS = ["unigram", "bpe", "big-unigram", "big-bpe"]


@pytest.mark.parametrize("proto", PROTOS)
def test_ids_and_texts_equal_the_jax_tokenizer(proto):
    """The same proto, the same seeded texts: identical ids, identical
    decodes (with and without the sequence-start strip), identical
    trainer ids and vocabulary (tolerance: none)."""
    pieces, model_type = _protos()[proto]
    blob = _sp(JAX).build_model_proto(pieces, model_type=model_type)
    assert _sp(PORT).build_model_proto(pieces, model_type=model_type) == blob
    j, t = _sp(JAX).SentencePieceModel(blob), _sp(PORT).SentencePieceModel(blob)
    assert (t.pieces, t.scores, t.types) == (j.pieces, j.scores, j.types)
    assert (t.unk_id, t.bos_id, t.eos_id, t.model_type) == (j.unk_id, j.bos_id, j.eos_id,
                                                            j.model_type)
    for text in _texts(PROTOS.index(proto)):
        ids = j.encode(text)
        assert t.encode(text) == ids, text
        for start in (True, False):
            assert t.decode(ids, sequence_start=start) == j.decode(ids, sequence_start=start)


def test_decode_stream_deltas_equal_the_jax_tokenizer(tmp_path):
    """Incremental detokenization of seeded random id streams through each
    package's SentencePieceTokenizer and DecodeStream: the same deltas,
    token by token, and the same flush."""
    pieces, _ = _protos()["big-unigram"]
    path = tmp_path / "tokenizer.model"
    path.write_bytes(_sp(JAX).build_model_proto(pieces))
    toks = {pkg: importlib.import_module(f"{pkg}.llm.tokenizer").SentencePieceTokenizer(str(path))
            for pkg in PKGS}
    rng = np.random.default_rng(4)
    for _ in range(20):
        ids = rng.integers(0, len(pieces), size=int(rng.integers(1, 50))).tolist()
        got = {}
        for pkg, tok in toks.items():
            ds = tok.decode_stream()
            got[pkg] = [ds.step(i) for i in ids] + [ds.flush()]
        assert got[PORT] == got[JAX], ids


def test_unapplied_normalization_is_logged_where_it_would_change_ids(caplog):
    """Neither package runs NormalizerSpec's whitespace normalization: the
    port tokenizes as the JAX package does and logs the span where
    sentencepiece would have collapsed spaces — at warning level once a
    model, then at debug level; a text it would not change logs nothing."""
    pieces, model_type = _protos()["unigram"]
    blob = _sp(JAX).build_model_proto(pieces, model_type=model_type)
    j, t = _sp(JAX).SentencePieceModel(blob), _sp(PORT).SentencePieceModel(blob)
    assert t.remove_extra_whitespaces
    caplog.set_level(logging.DEBUG, logger=f"{PORT}.llm.sp")
    assert t.encode("hello world") == j.encode("hello world")
    assert not caplog.records
    for text in ("hello  world", " hello world "):
        assert t.encode(text) == j.encode(text)
    levels = [r.levelno for r in caplog.records]
    assert levels == [logging.WARNING, logging.DEBUG]  # one record a text
    assert "remove_extra_whitespaces" in caplog.records[0].getMessage()
    assert "'hello  world'" in caplog.records[0].getMessage()


def test_chat_template_is_logged_once_and_rendered_role_tagged(tmp_path):
    """A tokenizer_config.json chat template beside a tokenizer.model: the
    port renders it as the JAX package renders it with jinja2 (bos and eos
    from the config, ``tools``, both ``add_generation_prompt`` settings),
    where it used to log and fall back to role tags; without a template
    both render the role-tagged fallback."""
    toks = {}
    pieces, _ = _protos()["unigram"]
    template = ("{{ bos_token }}{% for m in messages %}[{{ m.role|upper }}] {{ m.content|trim }}"
                "{% if not loop.last %}\n{% endif %}{% endfor %}{% if tools %} tools="
                "{{ tools|tojson }}{% endif %}{% if add_generation_prompt %}\n[ASSISTANT]"
                "{% endif %}{{ eos_token if not add_generation_prompt }}")
    for with_config in (True, False):
        d = tmp_path / str(with_config)
        d.mkdir()
        (d / "tokenizer.model").write_bytes(_sp(JAX).build_model_proto(pieces))
        if with_config:
            (d / "tokenizer_config.json").write_text(json.dumps(
                {"chat_template": template, "bos_token": "<s>", "eos_token": {"content": "</s>"}}))
        toks = {pkg: importlib.import_module(f"{pkg}.llm.tokenizer").SentencePieceTokenizer(
            str(d / "tokenizer.model")) for pkg in PKGS}
        assert toks[PORT].chat_template == toks[JAX].chat_template
        msgs = [{"role": "system", "content": " be brief "}, {"role": "user", "content": "hello world"}]
        for agp in (True, False):
            for tools in (None, [{"name": "f", "description": "<a & 'b'>"}]):
                got = {pkg: tok.apply_chat_template(msgs, add_generation_prompt=agp, tools=tools)
                       for pkg, tok in toks.items()}
                assert got[PORT] == got[JAX], (with_config, agp, tools)
        if with_config:
            assert got[PORT].startswith("<s>[SYSTEM] be brief[USER] hello world")  # trim_blocks


def test_unsupported_template_stops_the_sentencepiece_load(tmp_path):
    """A template construct outside the renderer's subset beside a
    tokenizer.model: the JAX tokenizer loads it (jinja2 has the filter),
    the port refuses the load, naming it."""
    pieces, _ = _protos()["unigram"]
    (tmp_path / "tokenizer.model").write_bytes(_sp(JAX).build_model_proto(pieces))
    template = "{% for m in messages %}{{ m.content|wordwrap(20) }}{% endfor %}"
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"chat_template": template}))
    mods = {pkg: importlib.import_module(f"{pkg}.llm.tokenizer") for pkg in PKGS}
    assert mods[JAX].SentencePieceTokenizer(str(tmp_path / "tokenizer.model")).chat_template
    with pytest.raises(ValueError, match="wordwrap"):
        mods[PORT].SentencePieceTokenizer(str(tmp_path / "tokenizer.model"))


def test_tokenizer_kinds_the_port_refuses(tmp_path):
    """``hf`` specs (a ``tokenizer.json`` file, or a directory holding one)
    are served, id for id with the JAX package's discovery; the one kind
    both refuse is an unknown one (the ``gguf`` kind:
    tests/test_torch_gguf.py)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    from dynamo_tpu.llm.discovery import make_tokenizer as jax_make
    from dynamo_tpu_torch.llm.discovery import make_tokenizer

    tok = Tokenizer(WordLevel({"<unk>": 0, "hello": 1, "world": 2, "!": 3}, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    for spec in ({"kind": "hf", "dir": str(tmp_path)},
                 {"kind": "hf", "file": str(tmp_path / "tokenizer.json")}):
        j, t = jax_make(spec), make_tokenizer(spec)
        assert type(t).__name__ == "HFTokenizer"
        for text in ("hello world!", "hello there", ""):
            assert t.encode(text) == j.encode(text) and t.decode(t.encode(text)) == j.decode(j.encode(text))
    for make in (jax_make, make_tokenizer):
        with pytest.raises(ValueError, match="unknown tokenizer kind"):
            make({"kind": "nope"})


def test_sp_only_checkpoint_serves_like_the_jax_engine(tmp_path):
    """A checkpoint directory whose only tokenizer artifact is
    tokenizer.model, served by ``run in=http out=torch --checkpoint DIR``
    (the port's CLI, f32 on the CPU): the text completion's usage counts
    the tokenizer's ids, and its text decodes the exact greedy tokens
    TpuEngine gives on the same files and ids; a chat request renders the
    role-tagged prompt (no tokenizer_config.json, so no template) and
    decodes the JAX engine's tokens for that prompt."""
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu.models import get_config as jax_get_config
    from dynamo_tpu.models.llama import init_params as jax_init_params
    from dynamo_tpu.runtime.engine import Context, collect
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.tokenizer import SentencePieceTokenizer
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.models.loader import save_params_hf
    from test_torch_http import _post

    sp = _sp(PORT)
    words = ["hello", "world", "the", "sky", "is", "blue", "sea", "green"]
    pieces = [("<unk>", 0.0, sp.UNKNOWN), ("<s>", 0.0, sp.CONTROL), ("</s>", 0.0, sp.CONTROL)]
    pieces += [("▁" + w, -1.0, sp.NORMAL) for w in words]
    pieces += [(c, -5.0, sp.NORMAL) for c in "▁<>|\nabcdefghijklmnopqrstuvwxyz"]
    # debug-tiny's 256 ids, each a piece that decodes on its own (no byte
    # piece above 0x7f: a random stream stays valid UTF-8 token by token).
    pieces += [(f"▁w{i}", -3.0, sp.NORMAL) for i in range(256 - len(pieces))]
    path = str(tmp_path / "model")
    jcfg = jax_get_config("debug-tiny").with_overrides(dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    save_params_hf(params_from_jax(tree, device="cpu"), path,
                   config=get_config("debug-tiny").with_overrides(dtype="float32"))
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(sp.build_model_proto(pieces))
    tok = SentencePieceTokenizer(os.path.join(path, "tokenizer.model"))
    prompt = "hello world the sky is"
    chat_prompt = tok.apply_chat_template([{"role": "user", "content": prompt}])
    geometry = dict(block_size=4, num_blocks=128, max_batch=2, max_model_len=256,
                    prefill_chunk=16, decode_steps=4, dtype="float32")

    async def jax_greedy(ids):
        engine = TpuEngine(JaxEngineConfig(model="debug-tiny", checkpoint_path=path, **geometry))
        req = PreprocessedRequest(
            token_ids=ids, stop_conditions=StopConditions(max_tokens=8, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0)).to_dict()
        out = await collect(await engine.generate(Context(req)))
        await engine.close()
        return [t for i in out for t in i["token_ids"]]

    want = asyncio.run(jax_greedy(tok.encode(prompt)))
    want_chat = asyncio.run(jax_greedy(tok.encode(chat_prompt, add_special_tokens=False)))

    args = cli.parse_args([
        "run", "in=http", "out=torch", "--checkpoint", path, "--device", "cpu", "--port", "0",
        "--model", "sp", *[f"--{k.replace('_', '-')}={v}" for k, v in geometry.items()]])

    async def main():
        ready = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(cli._run(args, on_serving=ready.set_result))
        service = await asyncio.wait_for(ready, 60)
        base = f"http://127.0.0.1:{service.port}"
        try:
            body = {"model": "sp", "prompt": prompt, "max_tokens": 8, "temperature": 0,
                    "nvext": {"ignore_eos": True}}
            completion = await _post(base, "/v1/completions", body)
            chat = await _post(base, "/v1/chat/completions", {
                "model": "sp", "messages": [{"role": "user", "content": prompt}],
                "max_tokens": 8, "temperature": 0, "nvext": {"ignore_eos": True}})
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        return completion, chat

    (st, _, text, _), (cst, _, ctext, _) = asyncio.run(main())
    assert st == 200 and cst == 200, (text, ctext)
    got = json.loads(text)
    assert got["usage"]["prompt_tokens"] == len(tok.encode(prompt))
    assert got["choices"][0]["text"] == tok.decode(want)
    assert json.loads(ctext)["choices"][0]["message"]["content"] == tok.decode(want_chat)
