"""The port's ``tokenizer.json`` reader (``llm/hf_tokenizer.py``) and its
``HFTokenizer`` against the JAX package's, which runs the ``tokenizers``
library:

- every pipeline the port supports, each file built here with
  ``tokenizers`` (llama-3's Split + ByteLevel with ``ignore_merges`` and a
  BOS template, Qwen2's NFC, Mistral's Prepend + Replace with byte
  fallback and a decoder sequence, the JAX tests' WordLevel and BPE over
  Whitespace, unigram with Metaspace, every Split behavior, Digits,
  regex Replace, added tokens with every option, no decoder): identical
  ids with and without special tokens, identical decodes with and without
  ``skip_special_tokens``, identical ``DecodeStream`` deltas;
- a hypothesis fuzz over Unicode text (CJK, emoji, ``\\r\\n`` runs, the
  special tokens' strings inside text) on the main pipelines;
- the llama-3-format file ``tools/synth_tokenizer.py`` writes for the
  card's checkpoint (at a reduced vocabulary), with Llama 3.1's published
  template;
- a template construct outside the renderer's subset stops the
  tokenizer's load, named;
- a component outside the port's set raises ``ValueError`` naming it;
- the grammar's wire dict and hash over an HF byte-level vocabulary;
- an HF checkpoint directory served over HTTP by both packages (the
  counterpart of ``tests/test_real_checkpoint.py``): the same statuses,
  bodies, usage and SSE chunks, the dense reference's greedy tokens, and
  a template's ``raise_exception`` answered alike.
"""

import asyncio
import importlib
import json
import os
import random
from argparse import Namespace

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, Tokenizer, decoders
from tokenizers import normalizers as nz
from tokenizers import pre_tokenizers as pt
from tokenizers import processors
from tokenizers.models import BPE, Unigram, WordLevel
from tokenizers.trainers import BpeTrainer, UnigramTrainer, WordLevelTrainer

from dynamo_tpu.llm.tokenizer import HFTokenizer as JaxHF
from dynamo_tpu_torch.llm import chat_template as ct
from dynamo_tpu_torch.llm import hf_tokenizer as hf
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
from dynamo_tpu_torch.tools import synth_tokenizer
from test_torch_chat_template import LLAMA31

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
SPECIALS = ["<|begin_of_text|>", "<|eot_id|>", "<s>", "</s>"]
ALPHABET = (list("abcdefghij klmnop  qrstuvwxyzABCDE.,!?'\n\r\t0123456789-_")
            + ["é", "ö", "中", "文", "😀", "👍🏽", "ß", "Σ", "İ", "́", "²", "Ⓐ", "\x1c", "　",
               "\xa0", "'S", "'ll", "\r\n", "<s>", "<|eot_id|>", "▁", "##"])


def _texts(seed, n=150):
    rng = random.Random(seed)
    out = ["", " ", "a", "hello world", "Hello World's 12345 foo!!\n\n  bar\r\n\r\n",
           "  leading", "trailing  ", "<s>hello<|eot_id|> world<s>", "中文字符 😀 emoji",
           "ΣΑΣ σας", "x <s> y", "tab\tsep  two"]
    out += ["".join(rng.choice(ALPHABET) for _ in range(rng.randint(1, 50))) for _ in range(n)]
    return out


CORPUS = _texts(0, 400)


def _train(model, trainer, pre=None, norm=None):
    tok = Tokenizer(model)
    if norm is not None:
        tok.normalizer = norm
    if pre is not None:
        tok.pre_tokenizer = pre
    tok.train_from_iterator(CORPUS, trainer)
    return tok


def _bpe(vocab_size=400, byte_level=False, **kw):
    return BpeTrainer(vocab_size=vocab_size, special_tokens=["<unk>", "<s>", "</s>"],
                      show_progress=False,
                      initial_alphabet=pt.ByteLevel.alphabet() if byte_level else [], **kw)


LLAMA3 = synth_tokenizer.LLAMA3_SPLIT
QWEN2 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|"
         r"\s*[\r\n]+|\s+(?!\S)|\s+")


def _llama3():
    tok = _train(BPE(ignore_merges=True), _bpe(byte_level=True),
                 pt.Sequence([pt.Split(Regex(LLAMA3), "isolated"),
                              pt.ByteLevel(add_prefix_space=False, use_regex=False)]))
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens(["<|begin_of_text|>", "<|eot_id|>"])
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                      special_tokens=[("<|begin_of_text|>", bos)])])
    return tok


def _qwen2():
    tok = _train(BPE(), _bpe(byte_level=True),
                 pt.Sequence([pt.Split(Regex(QWEN2), "isolated"),
                              pt.ByteLevel(add_prefix_space=False, use_regex=False)]), nz.NFC())
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.add_special_tokens(["<|im_start|>", "<|im_end|>"])
    return tok


def _gpt2():
    tok = _train(BPE(), _bpe(byte_level=True), pt.ByteLevel(add_prefix_space=True))
    tok.decoder = decoders.ByteLevel()
    return tok


def _mistral():
    trainer = BpeTrainer(vocab_size=500, show_progress=False, special_tokens=[
        "<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)])
    tok = _train(BPE(unk_token="<unk>", fuse_unk=True, byte_fallback=True), trainer,
                 norm=nz.Sequence([nz.Prepend("▁"), nz.Replace(" ", "▁")]))
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    return tok


def _wordlevel():
    """The JAX tests' file: WordLevel over Whitespace."""
    return _train(WordLevel(unk_token="<unk>"), WordLevelTrainer(special_tokens=["<unk>", "<s>"]),
                  pt.Whitespace())


def _bpe_whitespace():
    """BPE over Whitespace with a continuing-subword prefix and an
    end-of-word suffix, unk not fused, under NFKD, Lowercase and Strip."""
    tok = _train(BPE(unk_token="<unk>", continuing_subword_prefix="##", end_of_word_suffix="</w>"),
                 _bpe(300, continuing_subword_prefix="##", end_of_word_suffix="</w>"),
                 pt.Whitespace(), nz.Sequence([nz.NFKD(), nz.Lowercase(), nz.Strip()]))
    tok.add_special_tokens(["<|eot_id|>"])
    return tok


def _unigram_metaspace():
    tok = _train(Unigram(), UnigramTrainer(vocab_size=200, special_tokens=["<unk>", "<s>"],
                                           unk_token="<unk>", show_progress=False),
                 pt.Metaspace(prepend_scheme="first"))
    tok.decoder = decoders.Metaspace(prepend_scheme="first")
    tok.add_special_tokens(["<|eot_id|>"])
    return tok


def _unigram_sequence():
    """Unigram with byte fallback behind WhitespaceSplit, Digits and an
    unsplit Metaspace, under NFKC; a ByteFallback + Metaspace decoder."""
    tok = _train(Unigram(), UnigramTrainer(vocab_size=150, special_tokens=["<unk>"],
                                           unk_token="<unk>", show_progress=False),
                 pt.Sequence([pt.WhitespaceSplit(), pt.Digits(individual_digits=True),
                              pt.Metaspace(prepend_scheme="always", split=False)]), nz.NFKC())
    obj = json.loads(tok.to_str())
    obj["model"]["byte_fallback"] = True
    obj["model"]["vocab"] += [[f"<0x{b:02X}>", -20.0] for b in range(256)]
    tok = Tokenizer.from_str(json.dumps(obj))
    tok.decoder = decoders.Sequence([decoders.ByteFallback(), decoders.Metaspace()])
    return tok


def _splits():
    """Every Split behavior (and an inverted one) over string and regex
    patterns, Digits in runs, a regex Replace and NFD; no decoder, so
    tokens join with spaces."""
    seq = pt.Sequence([
        pt.Split(Regex(r"\d+"), "merged_with_previous"),
        pt.Split(" ", "merged_with_next"),
        pt.Split(Regex(r"[,.!?]"), "contiguous"),
        pt.Split(Regex(r"[aeiou]{2}"), "removed", invert=True),
        pt.Split(Regex(r"\s"), "removed"),
        pt.Digits(individual_digits=False),
    ])
    return _train(BPE(unk_token="<unk>"), _bpe(300), seq,
                  nz.Sequence([nz.NFD(), nz.Replace(Regex(r"\s{2,}"), " "), nz.Lowercase()]))


def _added_options():
    """Added tokens with single_word, lstrip, rstrip and normalized (a
    normalized token matches after the normalizer), special and not, one
    already in the vocabulary."""
    tok = _train(BPE(unk_token="<unk>"), _bpe(300), pt.Whitespace(), nz.Lowercase())
    tok.add_tokens([AddedToken("hello", single_word=True), AddedToken("WORLD", normalized=True),
                    AddedToken("<pad>", lstrip=True, rstrip=True, normalized=False),
                    AddedToken("ab", normalized=False), AddedToken("e")])
    tok.add_special_tokens([AddedToken("<|eot_id|>", lstrip=True), "<s>"])
    return tok


def _byte_level_split_metaspace_free():
    """A ByteLevel pre-tokenizer without its regex and a ByteLevel
    post-processor, BPE merges applied (no ignore_merges)."""
    tok = _train(BPE(), _bpe(byte_level=True), pt.ByteLevel(add_prefix_space=False,
                                                             use_regex=False))
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel()
    return tok


PIPELINES = {
    "llama3": _llama3, "qwen2": _qwen2, "gpt2": _gpt2, "mistral": _mistral,
    "wordlevel": _wordlevel, "bpe-whitespace": _bpe_whitespace,
    "unigram-metaspace": _unigram_metaspace, "unigram-sequence": _unigram_sequence,
    "splits": _splits, "added-options": _added_options,
    "byte-level-no-regex": _byte_level_split_metaspace_free,
}
_BUILT = {}


def _pair(name, tmp_path_factory):
    """The JAX and port HFTokenizer over one file built with tokenizers."""
    if name not in _BUILT:
        d = tmp_path_factory.mktemp(name)
        path = str(d / "tokenizer.json")
        PIPELINES[name]().save(path)
        _BUILT[name] = path
    path = _BUILT[name]
    return JaxHF(path), HFTokenizer(path)


def _assert_same(j, t, text):
    for special in (True, False):
        ids = j.encode(text, add_special_tokens=special)
        assert t.encode(text, add_special_tokens=special) == ids, (text, special)
        for skip in (True, False):
            assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)


def _deltas(tok, ids, skip):
    ds = tok.decode_stream(skip_special_tokens=skip)
    return [ds.step(i) for i in ids] + [ds.flush()]


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_ids_texts_and_stream_equal_tokenizers(name, tmp_path_factory):
    """One pipeline: the same vocabulary size and special ids, the same ids
    for seeded texts (tolerance: none), the same decodes of those ids and
    of random id runs, and the same DecodeStream deltas."""
    j, t = _pair(name, tmp_path_factory)
    assert t.vocab_size == j.vocab_size
    for s in SPECIALS:
        assert t._tok.token_to_id(s) == j._tok.token_to_id(s)
    for text in _texts(PIPELINES and list(PIPELINES).index(name)):
        _assert_same(j, t, text)
    rng = random.Random(3)
    for _ in range(60):
        ids = [rng.randrange(j.vocab_size + 2) for _ in range(rng.randint(0, 16))]
        for skip in (True, False):
            assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)
            known = [i for i in ids if i < j.vocab_size]
            assert _deltas(t, known, skip) == _deltas(j, known, skip), known
    for text in _texts(7, 20):
        ids = j.encode(text)
        assert _deltas(t, ids, True) == _deltas(j, ids, True)


FUZZ_TEXT = st.lists(
    st.one_of(
        st.characters(blacklist_categories=("Cs", "Cn")),
        st.sampled_from(["中", "文", "字", "😀", "👍🏽", "🇫🇷", "\r\n", "\r", "\n\n", " ", "  ", "\t",
                         "'s", "123", "é", "́", *SPECIALS])),
    max_size=40).map("".join)


@pytest.mark.parametrize("name", ["llama3", "qwen2", "mistral", "unigram-metaspace",
                                  "added-options", "bpe-whitespace"])
@settings(max_examples=120, deadline=None, suppress_health_check=list(HealthCheck))
@given(text=FUZZ_TEXT)
def test_fuzz_unicode_text(name, text, tmp_path_factory):
    """Arbitrary assigned Unicode (CJK, emoji, ``\\r\\n`` runs, special
    tokens' strings inside text): the same ids, decodes and deltas."""
    j, t = _pair(name, tmp_path_factory)
    _assert_same(j, t, text)
    ids = j.encode(text)
    assert _deltas(t, ids, False) == _deltas(j, ids, False)


def test_synth_tokenizer_matches_tokenizers(tmp_path):
    """The llama-3-format directory the card's checkpoint gets, at 3000
    tokens: ``tokenizers`` loads it, and the port gives its ids, texts,
    bos/eos and chat prompts (with tools, both generation settings)."""
    path = synth_tokenizer.write(str(tmp_path), 3000, 14)
    j, t = JaxHF(path), HFTokenizer(path)
    assert j.vocab_size == t.vocab_size == 3256
    assert (t.bos_token_id, t.eos_token_id) == (j.bos_token_id, j.eos_token_id) == (3000, 3009)
    for text in _texts(11, 80) + ["The quick brown fox jumps over the lazy dog, 42 times!"]:
        _assert_same(j, t, text)
        ids = t.encode(text, add_special_tokens=False)
        assert t.decode(ids, skip_special_tokens=False) == text
    tools = [{"type": "function", "function": {"name": "f", "description": "<a> & 'b'"}}]
    for msgs in ([{"role": "user", "content": "hi"}],
                 [{"role": "system", "content": " sys "}, {"role": "user", "content": "é 中"},
                  {"role": "assistant", "content": None}, {"role": "user", "content": ""}]):
        for agp in (True, False):
            for tl in (None, tools):
                prompt = j.apply_chat_template(msgs, add_generation_prompt=agp, tools=tl)
                assert t.apply_chat_template(msgs, add_generation_prompt=agp, tools=tl) == prompt
                ids = t.encode(prompt, add_special_tokens=False)
                assert ids == j.encode(prompt, add_special_tokens=False) and ids.count(3000) == 1
    call = {"function": {"name": "f", "arguments": {}}}
    two_calls = [{"role": "user", "content": "x"},
                 {"role": "assistant", "content": None, "tool_calls": [call, call]}]
    with pytest.raises(ValueError, match="single tool-calls"):
        j.apply_chat_template(two_calls)
    with pytest.raises(ValueError, match="single tool-calls"):
        t.apply_chat_template(two_calls)
    assert t.chat_template == synth_tokenizer.CHAT_TEMPLATE == LLAMA31  # the published text


@pytest.mark.parametrize("template,named", [
    ("{{ messages|select('odd')|list }}", "odd"),
    ("{% filter upper %}{{ messages[0].content }}{% endfilter %}", "filter"),
    ("{{ messages[0].content|center(40) }}", "center"),
])
def test_unsupported_template_stops_the_load_naming_it(template, named, tmp_path):
    """jinja2 compiles these and the JAX tokenizer loads them; the port
    refuses the tokenizer when it loads, naming the construct, rather than
    on the first chat request."""
    path = synth_tokenizer.write(str(tmp_path), 600, 3)
    config = tmp_path / "tokenizer_config.json"
    config.write_text(json.dumps(dict(json.loads(config.read_text()), chat_template=template)))
    assert JaxHF(path).chat_template == template
    with pytest.raises(ct.TemplateSupportError, match=named):
        HFTokenizer(path)


def _edit(obj, key, value):
    out = json.loads(json.dumps(obj))
    out[key] = value
    return out


@pytest.mark.parametrize("key,value,named", [
    ("normalizer", {"type": "BertNormalizer"}, "BertNormalizer"),
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap": ""}, "Precompiled"),
    ("pre_tokenizer", {"type": "BertPreTokenizer"}, "BertPreTokenizer"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\p{Han}+"}, "behavior": "Isolated",
                       "invert": False}, "Han"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\X"}, "behavior": "Isolated",
                       "invert": False}, r"\\X"),
    ("post_processor", {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0]},
     "RobertaProcessing"),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}, "WordPiece"),
    ("model", {"type": "WordPiece", "vocab": {"a": 0}, "unk_token": "a"}, "WordPiece"),
    ("model", {"type": "BPE", "dropout": 0.1, "vocab": {"a": 0}, "merges": []}, "dropout"),
    ("truncation", {"max_length": 8}, "truncation"),
])
def test_unsupported_components_raise_naming_them(key, value, named, tmp_path_factory):
    """A component type, pattern construct or setting outside the port's
    set is refused when the file loads, with a ValueError naming it —
    never approximated."""
    j, _ = _pair("llama3", tmp_path_factory)
    obj = json.loads(open(_BUILT["llama3"], encoding="utf-8").read())
    with pytest.raises(ValueError, match=named):
        hf.Tokenizer.from_dict(_edit(obj, key, value))


def test_grammar_wire_dict_and_hash_equal_over_a_byte_level_vocabulary(tmp_path_factory):
    """The grammar compiler decodes every id of an HF byte-level
    vocabulary: its wire dict and hash equal the JAX compiler's (the
    sentencepiece departure does not apply)."""
    j, t = _pair("llama3", tmp_path_factory)
    spec = {"kind": "json_schema", "schema": {
        "type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                                         "kind": {"enum": ["cat", "dog"]}}}}
    auts = {pkg: importlib.import_module(f"{pkg}.llm.tenancy.grammar").GrammarCompiler(tok)
            .compile(spec) for pkg, tok in ((JAX, j), (PORT, t))}
    assert json.dumps(auts[PORT].to_dict(), sort_keys=True) == \
        json.dumps(auts[JAX].to_dict(), sort_keys=True)
    assert auts[PORT].hash == auts[JAX].hash and len(auts[PORT].edges) > 4


# ------------------------------------------------ the checkpoint over HTTP

RAISING_TEMPLATE = (
    "{% if messages[0]['role'] == 'system' %}"
    "{{ raise_exception('System role not supported') }}{% endif %}"
    "{% for m in messages %}<|{{ m.role }}|> {{ m.content }} {% endfor %}<|assistant|>")


def _serve_both(path, requests):
    """Serve ``path`` with each package's engine factory, HFTokenizer,
    preprocessor, backend and HTTP edge; send each request to both, in
    turn.  Returns {pkg: [(status, content type, body)]}."""
    from aiohttp import ClientSession

    out = {}
    for pkg in (JAX, PORT):
        m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
        args = Namespace(arch=None, checkpoint=path, model_config=None, block_size=4,
                         num_blocks=128, max_batch=2, max_model_len=256, prefill_chunk=16,
                         decode_steps=4, pipeline_depth=2, dtype="float32", device="cpu")
        factory = "build_tpu_engine" if pkg == JAX else "build_torch_engine"

        async def main():
            engine = getattr(m("engine"), factory)(args)
            tok = m("llm.tokenizer").HFTokenizer.from_pretrained_dir(path)
            pipeline = m("runtime.pipeline").build_pipeline(
                [m("llm.preprocessor").OpenAIPreprocessor(tok, "golden"), m("llm.backend").Backend(tok)],
                engine)
            svc = m("llm.http_service").HttpService(host="127.0.0.1", port=0)
            svc.models.add_chat_model("golden", pipeline)
            svc.models.add_completion_model("golden", pipeline)
            await svc.start()
            got = []
            try:
                async with ClientSession() as s:
                    for route, body in requests:
                        async with s.post(f"http://127.0.0.1:{svc.port}{route}", json=body) as r:
                            got.append((r.status, r.headers.get("Content-Type", ""), await r.text()))
            finally:
                await svc.close()
                await engine.close()
            return got

        out[pkg] = asyncio.run(main())
    return out


def _masked(status, ctype, text):
    def mask(obj):
        if isinstance(obj, dict):
            obj.pop("id", None)
            obj.pop("created", None)
        return obj

    if ctype.startswith("text/event-stream"):
        return status, [d if d == "[DONE]" else mask(json.loads(d))
                        for d in (b[len("data: "):] for b in text.split("\n\n") if b)]
    return status, mask(json.loads(text))


def test_hf_checkpoint_serves_like_the_jax_edge(tmp_path):
    """``tests/test_real_checkpoint.py``'s checkpoint directory (HF
    config.json, safetensors, a ``tokenizers`` tokenizer.json and a chat
    template), served by both packages over HTTP: chat and completion,
    unary and streamed, give the same statuses, bodies, usage and SSE
    chunks; the chat text decodes the dense reference's greedy tokens;
    a template that calls ``raise_exception`` is answered alike, with its
    message."""
    from test_real_checkpoint import build_checkpoint, reference_greedy

    path = str(tmp_path / "model")
    build_checkpoint(path)
    messages = [{"role": "user", "content": "hello world the sky is"}]
    common = {"model": "golden", "max_tokens": 8, "temperature": 0.0, "nvext": {"ignore_eos": True}}
    requests = [
        ("/v1/chat/completions", dict(common, messages=messages)),
        ("/v1/chat/completions", dict(common, messages=messages, stream=True)),
        ("/v1/completions", dict(common, prompt="the sky is blue hello")),
        ("/v1/completions", dict(common, prompt="the sky is blue hello", stream=True,
                                 stream_options={"include_usage": True})),
        ("/v1/chat/completions", dict(common, messages=[{"role": "system", "content": "w1 w2"}] + messages,
                                      stream=True)),
    ]
    got = _serve_both(path, requests)
    want = [_masked(*r) for r in got[JAX]]
    assert [_masked(*r) for r in got[PORT]] == want
    assert [s for s, _ in want] == [200] * 5
    tok = HFTokenizer.from_pretrained_dir(path)
    golden = reference_greedy(path, tok.encode("<|user|> hello world the sky is <|assistant|>"), 8)
    assert want[0][1]["choices"][0]["message"]["content"] == tok.decode(golden)

    with open(os.path.join(path, "tokenizer_config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(dict(cfg, chat_template=RAISING_TEMPLATE), f)
    got = _serve_both(path, requests[4:] + requests[:1])
    want = [_masked(*r) for r in got[JAX]]
    assert [_masked(*r) for r in got[PORT]] == want
    assert want[0][0] != 200 and "System role not supported" in json.dumps(want[0][1])
    assert want[1][0] == 200
