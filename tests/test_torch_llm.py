"""The port's host-side serving modules against the JAX package's.

Each test feeds the same inputs (drawn by hypothesis, or from a seeded
numpy generator) to the JAX module and its copy in ``dynamo_tpu_torch``
and requires equal results: XXH64 block hashing (with and without the
``xxhash`` module), the byte tokenizer and incremental detokenizer, OpenAI
request validation (the port's dataclasses against the pydantic models),
chunk shaping and aggregation, preprocessing, the stop-string decoder and
the HTTP-edge metrics.
"""

import importlib.util
import json
import sys
import time

import numpy as np
import pytest
import xxhash
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from prometheus_client.parser import text_string_to_metric_families

import dynamo_tpu.tokens as jtok
import dynamo_tpu_torch.tokens as ttok
from dynamo_tpu.llm import backend as jbackend
from dynamo_tpu.llm import metrics as jmetrics
from dynamo_tpu.llm import openai as jopenai
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm import tokenizer as jtokenizer
from dynamo_tpu_torch.llm import backend as tbackend
from dynamo_tpu_torch.llm import metrics as tmetrics
from dynamo_tpu_torch.llm import openai as topenai
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm import tokenizer as ttokenizer
from dynamo_tpu_torch.llm.protocols import StopConditions

pytestmark = pytest.mark.torch_port

# ------------------------------------------------------------------ hashing


@settings(max_examples=300, deadline=None)
@given(st.binary(min_size=0, max_size=300), st.sampled_from([0, 1337, 2**64 - 1]))
def test_pure_python_xxh64_matches_xxhash(data, seed):
    assert ttok.xxh64(data, seed) == xxhash.xxh64_intdigest(data, seed=seed)


@pytest.fixture
def tokens_without_xxhash(monkeypatch):
    """A fresh copy of the port's tokens module, imported where ``import
    xxhash`` fails."""
    monkeypatch.setitem(sys.modules, "xxhash", None)
    spec = importlib.util.spec_from_file_location("_tokens_no_xxhash", ttok.__file__)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)  # dataclasses look it up
    spec.loader.exec_module(mod)
    assert "xxh64" in mod._hash_bytes.__code__.co_names  # the Python path
    return mod


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("salt", [None, "tenant-a"])
def test_block_and_sequence_hashes_without_xxhash_match_jax(tokens_without_xxhash, seed, salt):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128256, size=int(rng.integers(0, 200))).tolist()
    mod = tokens_without_xxhash
    for bs in (1, 4, 16):
        for i in range(0, len(toks), bs):
            blk = toks[i: i + bs]
            assert mod.compute_block_hash(blk) == jtok.compute_block_hash(blk)
        want = jtok.TokenBlockSequence(toks, bs, salt)
        for got in (mod.TokenBlockSequence(toks, bs, salt), ttok.TokenBlockSequence(toks, bs, salt)):
            assert got.sequence_hashes() == want.sequence_hashes()
            assert got.block_hashes() == want.block_hashes()
            assert got.last_sequence_hash == want.last_sequence_hash
    parent = int(rng.integers(0, 2**63))
    assert mod.chain_hash(parent, 12345) == jtok.chain_hash(parent, 12345)
    assert mod.chain_hash(None, 7) == jtok.chain_hash(None, 7)


# ---------------------------------------------------------------- tokenizer


def _id_stream(seed: int, n: int = 120):
    """Token ids a byte tokenizer meets: ASCII, the bytes of multi-byte
    characters (split over steps), lone continuation bytes, specials
    (256-258) and ids past the tokenizer's range (>= 259)."""
    rng = np.random.default_rng(seed)
    ids = []
    while len(ids) < n:
        kind = rng.integers(0, 5)
        if kind == 0:
            ids.extend(rng.integers(32, 127, size=int(rng.integers(1, 6))).tolist())
        elif kind == 1:
            ch = chr(int(rng.choice([0xE9, 0x3B1, 0x20AC, 0x4E2D, 0x1F600])))
            ids.extend(ch.encode("utf-8"))
        elif kind == 2:
            ids.append(int(rng.integers(0x80, 0xC0)))
        elif kind == 3:
            ids.append(int(rng.integers(256, 259)))
        else:
            ids.append(int(rng.integers(259, 128256)))
    return ids[:n]


@pytest.mark.parametrize("seed", range(6))
def test_byte_tokenizer_and_decode_stream_match_jax(seed):
    ids = _id_stream(seed)
    jt, tt = jtokenizer.ByteTokenizer(), ttokenizer.ByteTokenizer()
    for skip in (True, False):
        assert tt.decode(ids, skip_special_tokens=skip) == jt.decode(ids, skip_special_tokens=skip)
        js, ts = jt.decode_stream(skip), tt.decode_stream(skip)
        deltas = [(js.step(i), ts.step(i)) for i in ids]
        assert [t for _, t in deltas] == [j for j, _ in deltas]
        assert ts.flush() == js.flush()
    text = jt.decode(ids)
    for special in (True, False):
        assert tt.encode(text, special) == jt.encode(text, special)
    assert (tt.eos_token_id, tt.bos_token_id, tt.vocab_size) == (jt.eos_token_id, jt.bos_token_id, jt.vocab_size)
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "héllo"}]
    assert tt.apply_chat_template(msgs) == jt.apply_chat_template(msgs)


# ------------------------------------------------------- request validation


CHAT = {"model": "m", "messages": [{"role": "user", "content": "hi"}]}
COMPLETION = {"model": "m", "prompt": "hello"}
VALID = [
    dict(CHAT),
    dict(CHAT, max_tokens="12", temperature=1, top_p="0.5", top_k=3.0, seed="7", stop="x",
         n="2", stream="yes", frequency_penalty=0, presence_penalty="-1.5", min_tokens=True),
    dict(CHAT, max_tokens=0, max_completion_tokens=9, stop=["a", "bc"], logprobs=True,
         top_logprobs=20, user="extra keys are kept"),
    dict(CHAT, logprobs="1", top_logprobs=None, nvext={"ignore_eos": "true", "spec_decode": 0,
                                                     "annotations": ["token_ids"], "x": 1}),
    dict(CHAT, messages=[{"role": "user", "content": [{"type": "text", "text": "a"},
                                                     {"type": "image_url", "image_url": {}}]},
                         {"role": "assistant", "content": None, "name": "bot"}]),
    dict(CHAT, response_format={"type": "text"}, tools=[{"type": "function"}], stream_options={}),
    dict(COMPLETION),
    dict(COMPLETION, prompt=[1, 2, 3], logprobs=5, echo=False),
    dict(COMPLETION, prompt=[1.0, True], max_tokens=" 4 "),
    dict(COMPLETION, prompt=["a", "b"]),
    dict(COMPLETION, prompt=[[1, 2], [3.0]]),
    dict(COMPLETION, prompt=[]),
    dict(COMPLETION, nvext={"ignore_eos": False, "priority": "batch", "tenant": "t"}),
]
INVALID = [
    {"messages": [{"role": "user", "content": "hi"}]},  # missing model
    {"prompt": "x"},
    dict(CHAT, model=3),
    dict(CHAT, messages="hi"),
    dict(CHAT, messages=[{"content": "no role"}]),
    dict(CHAT, messages=[{"role": "user", "content": 5}]),
    dict(CHAT, messages=[{"role": "user", "content": ["not a part object"]}]),
    dict(CHAT, max_tokens="abc"),
    dict(CHAT, max_tokens=1.5),
    dict(CHAT, max_tokens="1e3"),
    dict(CHAT, temperature="hot"),
    dict(CHAT, temperature=[1]),
    dict(CHAT, stream=None),
    dict(CHAT, stream=2),
    dict(CHAT, stream="maybe"),
    dict(CHAT, n=None),
    dict(CHAT, stop=[1]),
    dict(CHAT, stop={"a": 1}),
    dict(CHAT, nvext="x"),
    dict(CHAT, nvext={"ignore_eos": "sure"}),
    dict(CHAT, nvext={"annotations": "token_ids"}),
    dict(CHAT, nvext={"grammar": 5}),
    dict(CHAT, response_format="json"),
    dict(CHAT, logprobs=2),
    dict(CHAT, tools={"type": "function"}),
    dict(COMPLETION, prompt=None),
    dict(COMPLETION, prompt=5),
    dict(COMPLETION, prompt=[1, "a"]),
    dict(COMPLETION, prompt=[[1.5]]),
    dict(COMPLETION, logprobs="x"),
    dict(COMPLETION, echo="nope"),
]
# Valid request fields whose option builders reject the values.
OUT_OF_RANGE = [
    dict(CHAT, logprobs=True, top_logprobs=21),
    dict(CHAT, top_logprobs=-1),
    dict(COMPLETION, logprobs=21),
    dict(COMPLETION, logprobs=-1),
]


def _typed(d):
    return {k: (type(v).__name__, v) for k, v in d.items()}


def _parse(mod, d):
    cls = mod.ChatCompletionRequest if "messages" in d else mod.CompletionRequest
    return cls.model_validate(d) if mod is jopenai else cls.from_dict(d)


@pytest.mark.parametrize("body", VALID, ids=lambda b: json.dumps(b)[:60])
def test_valid_requests_parse_to_the_same_options(body):
    j, t = _parse(jopenai, body), _parse(topenai, body)
    assert _typed(t.stop_conditions().to_dict()) == _typed(j.stop_conditions().to_dict())
    assert _typed(t.sampling_options().to_dict()) == _typed(j.sampling_options().to_dict())
    for name in ("model", "stream", "n", "response_format"):
        assert getattr(t, name) == getattr(j, name)
    assert t.extra == (j.model_extra or {})
    if "messages" in body:
        assert [(m.role, m.text(), m.name) for m in t.messages] == [
            (m.role, m.text(), m.name) for m in j.messages]
    else:
        assert t.prompt == j.prompt and type(t.prompt) is type(j.prompt)


@pytest.mark.parametrize("body", INVALID, ids=lambda b: json.dumps(b)[:60])
def test_invalid_requests_are_rejected_by_both(body):
    with pytest.raises(ValueError):  # pydantic's ValidationError is one
        _parse(jopenai, body)
    with pytest.raises(ValueError):
        _parse(topenai, body)


@pytest.mark.parametrize("body", OUT_OF_RANGE, ids=lambda b: json.dumps(b)[:60])
def test_out_of_range_logprobs_are_rejected_by_both(body):
    for mod in (jopenai, topenai):
        req = _parse(mod, body)
        with pytest.raises(ValueError):
            req.sampling_options()


JSON_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-2**70, 2**70),
    st.floats(allow_nan=True, allow_infinity=True),
    st.text(alphabet="0123456789+-_. eEinfatyrsolu\t", max_size=8),
    st.sampled_from(["1", "0", "1.0", "1.5", "true", "False", "YES", "off", "inf", "nan", "1_000"]),
)


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.sampled_from(["max_tokens", "temperature", "stream", "n", "top_k", "top_p", "seed"]),
       JSON_SCALARS)
def test_scalar_fields_accept_and_convert_like_pydantic(name, value):
    _same_as_pydantic(name, value)


# pydantic-core's string-to-number quirks: a run of leading zeros and
# underscores is dropped before the sign is read ("0-1" is -1), single
# underscores between digits are dropped, leading, trailing or doubled ones
# refused.
PYDANTIC_QUIRKS = ["0-0", "0-1", "+0-0", "00-0", "0__1", "1_0", " 1_0", "_1", "1_", "1__0",
                   "-0_1", "0_0.0", "1_0.5", "0-1.0"]


@pytest.mark.parametrize("name", ["max_tokens", "seed", "temperature"])
@pytest.mark.parametrize("value", PYDANTIC_QUIRKS)
def test_quirky_number_strings_parse_like_pydantic(name, value):
    _same_as_pydantic(name, value)


def _same_as_pydantic(name, value):
    """The port's request parse of ``{name: value}`` gives the JAX
    package's (pydantic's) value and type, or refuses as it does."""
    body = dict(COMPLETION, **{name: value})
    try:
        want = getattr(_parse(jopenai, body), name)
    except ValueError:
        with pytest.raises(ValueError):
            _parse(topenai, body)
        return
    got = getattr(_parse(topenai, body), name)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)  # NaN


# ------------------------------------------------------------ chunk shaping


def _chunks(mod, chat: bool, index: int = 0):
    gen = mod.DeltaGenerator("m", chat=chat, request_id="rid", index=index)
    gen.created = 1
    lp = {"token": "a", "logprob": -0.5, "top": [{"token": "a", "logprob": -0.5},
                                                 {"token": "b", "logprob": -1.25}]}
    return [
        gen.text_chunk("Hel"),
        gen.text_chunk("lo", logprobs=lp),
        gen.text_chunk(""),
        gen.finish_chunk("length"),
        gen.usage_chunk({"prompt_tokens": 3, "completion_tokens": 2, "total_tokens": 5}),
    ]


@pytest.mark.parametrize("chat", [True, False], ids=["chat", "completion"])
def test_delta_chunks_and_aggregation_match_jax(chat):
    j, t = _chunks(jopenai, chat), _chunks(topenai, chat)
    assert t == j
    assert topenai.sse_encode(t[0]) == jopenai.sse_encode(j[0])
    assert topenai.SSE_DONE == jopenai.SSE_DONE
    # n > 1: two choices interleaved, per-choice usage summed
    jn = [c for pair in zip(_chunks(jopenai, chat, 0), _chunks(jopenai, chat, 1)) for c in pair]
    tn = [c for pair in zip(_chunks(topenai, chat, 0), _chunks(topenai, chat, 1)) for c in pair]
    for jc, tc in ((j, t), (jn, tn)):
        assert topenai.aggregate_chunks(tc) == jopenai.aggregate_chunks(jc)


# ------------------------------------------------------------ preprocessing


PREPROCESS = [
    dict(CHAT, max_tokens=8, temperature=0.5, seed=3),
    dict(CHAT, messages=[{"role": "system", "content": "s"}, {"role": "user", "content": "ü"}],
         stop=["</s>", "\n\n"], min_tokens=2),
    dict(CHAT, nvext={"use_raw_prompt": True, "annotations": ["formatted_prompt", "token_ids"]}),
    dict(COMPLETION, stop="END", top_k=5, top_p=0.9, frequency_penalty=0.1),
    dict(COMPLETION, prompt=[7, 8, 9], nvext={"ignore_eos": True, "annotations": ["token_ids"]}),
    dict(COMPLETION, prompt=["a", "b"], n=3, seed=11),
    dict(COMPLETION, logprobs=3, nvext={"priority": "BATCH", "tenant": "acme"}),
    dict(CHAT, logprobs=True, top_logprobs=4, max_completion_tokens=6),
]


@pytest.mark.parametrize("body", PREPROCESS, ids=lambda b: json.dumps(b)[:60])
def test_preprocess_matches_jax(body):
    jp = jpre.OpenAIPreprocessor(jtokenizer.ByteTokenizer(), "m")
    tp = tpre.OpenAIPreprocessor(ttokenizer.ByteTokenizer(), "m")
    assert tp.preprocess(dict(body)).to_dict() == jp.preprocess(dict(body)).to_dict()


@pytest.mark.parametrize("ext", [{"response_format": {"type": "json_object"}},
                                 {"nvext": {"grammar": "[a-z]+"}}])
def test_structured_output_is_refused_not_ignored(ext):
    """A structured-output request is never served unconstrained: the port
    compiles its constraint into the automaton the JAX preprocessor ships
    (the same wire dict), and refuses a malformed one with a ValueError
    (400 at the edge), as the JAX preprocessor does."""
    jp = jpre.OpenAIPreprocessor(jtokenizer.ByteTokenizer(), "m")
    tp = tpre.OpenAIPreprocessor(ttokenizer.ByteTokenizer(), "m")
    got = tp.preprocess(dict(CHAT, **ext)).to_dict()
    assert got["grammar"]["edges"] and got == jp.preprocess(dict(CHAT, **ext)).to_dict()
    bad = ({"response_format": {"type": "json_schema", "json_schema": {"schema": {"enum": []}}}}
           if "response_format" in ext else {"nvext": {"grammar": "a(b"}})
    for pre in (tp, jp):
        with pytest.raises(ValueError):
            pre.preprocess(dict(CHAT, **bad))


# ----------------------------------------------------------------- decoding


@pytest.mark.parametrize("seed", range(8))
def test_decoder_stop_strings_and_min_tokens_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    ids = [int(x) for x in rng.choice(list(b"abcxyz \n"), size=60)]
    ids += [257] * 2 + [int(x) for x in rng.integers(97, 100, size=10)]
    text = bytes(i for i in ids if i < 256).decode()
    start = int(rng.integers(0, 40))
    stops = [text[start: start + int(rng.integers(1, 4))], "zz\n", "never-there"]
    cond = dict(max_tokens=int(rng.integers(10, 80)), min_tokens=int(rng.integers(0, 20)),
                stop=stops[: int(rng.integers(0, 4))], stop_token_ids=[ids[5]] if seed % 3 == 0 else [],
                ignore_eos=bool(seed % 2))
    jd = jbackend.Decoder(jtokenizer.ByteTokenizer(), jbackend.StopConditions(**cond))
    td = tbackend.Decoder(ttokenizer.ByteTokenizer(), StopConditions(**cond))
    j_out, t_out = [], []
    for tok in ids:
        j, t = jd.step(tok), td.step(tok)
        j_out.append((j[0], None if j[1] is None else str(j[1])))
        t_out.append((t[0], None if t[1] is None else str(t[1])))
        if j[1] is not None:
            break
    assert t_out == j_out
    assert td.finish() == jd.finish()


# ------------------------------------------------------------------ metrics


def _samples(text: str):
    out = set()
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue  # prometheus_client's creation timestamps
            out.add((s.name, tuple(sorted(s.labels.items())), s.value))
    return out


def test_metrics_render_the_same_samples(monkeypatch):
    clock = None
    monkeypatch.setattr(time, "monotonic", lambda: float(next(clock)))
    jm, tm = jmetrics.Metrics(), tmetrics.Metrics()
    odd = 'we"ird\\mo\ndel'
    open_guards = []
    for m, mod in ((jm, jmetrics), (tm, tmetrics)):
        clock = iter(np.arange(1000.0, 2000.0, 0.0137))  # the same times for each
        calls = [("m", "completions", "stream", 5, mod.Status.SUCCESS),
                 ("m", "chat_completions", "unary", 1, mod.Status.CLIENT_DROP),
                 (odd, "completions", "stream", 3, mod.Status.ERROR),
                 ("m", "completions", "stream", 0, mod.Status.REJECTED),
                 ("m", "completions", "stream", 12, mod.Status.SUCCESS)]
        for model, endpoint, kind, tokens, status in calls:
            g = m.guard(model, endpoint, kind)
            for _ in range(tokens):
                g.on_token()
            g.finish(status)
            g.finish(mod.Status.ERROR)  # a second finish is ignored
        m.requests_total.labels("unknown", "completions", "stream", mod.Status.REJECTED).inc()
        open_guards.append(m.guard("m", "completions", "stream"))  # still in flight
        open_guards[-1].on_token(2)
    got, want = _samples(tm.render().decode()), _samples(jm.render().decode())
    assert got == want
    assert any(name.endswith("_bucket") for name, _, _ in got)
    fams = {f.name: f.type for f in text_string_to_metric_families(tm.render().decode())}
    assert fams == {f.name: f.type for f in text_string_to_metric_families(jm.render().decode())
                    if not f.name.endswith("_created")}
