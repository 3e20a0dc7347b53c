"""Structured output (grammar-constrained decoding) on the port against the
JAX package.

- The twelve grammar cases of the JAX package's ``tests/test_tenancy.py``
  (the regex engine, schema regexes, control characters in strings, the
  token walk, packed masks and eos, constraint specs and the compile cache,
  the state cap, dead-end pruning, the preprocessor's compile, constrained
  streams, grammar x speculation, and no program beyond warmup) run on
  both packages, parametrized by package.
- The port's automaton wire dict and content hash equal the JAX
  package's for the same spec and byte tokenizer.  On a sentencepiece
  vocabulary the port indexes each piece as a stream renders it, so its
  dict equals the JAX compiler's over those strings, and every walk it
  admits renders inside the constraint's language.
- ``TorchEngine`` and ``TpuEngine`` on the same weights give identical
  constrained greedy and seeded streams, beside unconstrained ones in the
  same batch, at ``decode_steps`` 1, 4 and 8, with speculation off and on
  (tolerance: none; f32 on the CPU).
- A constrained stream migrates across packages both ways and resumes
  exactly; the hash-first wire (stub, ``grammar_miss``, one full resend)
  runs over the service plane from each package's preprocessor to the
  other's worker with equal counters; the port's and the JAX edge's HTTP
  bodies and SSE chunks are equal for ``json_schema``, ``json_object``,
  ``nvext.grammar`` and malformed constraints (400), and the port's CLI
  answers a ``json_schema`` request with the JAX edge's text.
"""

import asyncio
import importlib
import json
import os
import signal
import subprocess
import sys
from collections import OrderedDict
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.llama import params_from_jax
from test_torch_engine import _jax_params
from test_torch_http import _both, _post, servers  # noqa: F401  (module fixture)

pytestmark = [pytest.mark.torch_port, pytest.mark.tenancy]

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(
    model="debug-tiny",
    block_size=4,
    num_blocks=256,
    max_batch=4,
    max_model_len=256,
    prefill_chunk=32,
    dtype="float32",
)

# An enum schema admits only literal bytes, so token 0 (= NUL = debug-tiny's
# eos id) is never grammar-admissible outside accepting states.
ENUM_SCHEMA = {"enum": ["yes", "no", "maybe"]}
OBJ_SCHEMA = {
    "type": "object",
    "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
}


def M(pkg):
    m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
    return SimpleNamespace(
        grammar=m("llm.tenancy.grammar"), lora=m("llm.tenancy.lora"), protocols=m("llm.protocols"),
        rt=m("runtime.engine"), metrics=m("llm.metrics"), tokenizer=m("llm.tokenizer"),
        preprocessor=m("llm.preprocessor"), engine=m("engine.engine"),
    )


def TOK(pkg):
    return M(pkg).tokenizer.ByteTokenizer()


def _req(pkg, tokens, max_tokens=24, model=None, grammar=None, annotations=None,
         ignore_eos=True, **kw):
    p = M(pkg).protocols
    return p.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=p.StopConditions(max_tokens=max_tokens, ignore_eos=ignore_eos),
        sampling_options=p.SamplingOptions(**kw),
        model=model,
        annotations=dict(annotations or {}),
        grammar=grammar,
    ).to_dict()


async def _generate(pkg, engine, tokens, **kw):
    rt = M(pkg).rt
    out = await rt.collect(await engine.generate(rt.Context(_req(pkg, tokens, **kw))))
    return [t for item in out for t in item["token_ids"]]


def _automaton(pkg, schema_or_regex) -> dict:
    if isinstance(schema_or_regex, str):
        spec = {"kind": "regex", "pattern": schema_or_regex}
    else:
        spec = {"kind": "json_schema", "schema": schema_or_regex}
    return M(pkg).grammar.GrammarCompiler(TOK(pkg)).compile(spec).to_dict()


def _engine(pkg, lora=None, **over):
    """A debug-tiny engine of ``pkg`` on the shared seed-0 JAX weights."""
    cfg = dict(CFG, **over)
    if lora:
        cfg["lora"] = lora
    params = _jax_params()
    if pkg == JAX:
        return TpuEngine(JaxEngineConfig(**cfg), params=params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return TorchEngine(EngineConfig(**cfg), params=params_from_jax(tree, device="cpu"),
                       device="cpu")


# ------------------------------------------------------------ grammar units


@pytest.mark.parametrize("pkg", PKGS)
def test_regex_engine_core_syntax(pkg):
    G = M(pkg).grammar

    def matches(pattern, text):
        dfa = G._CharDFA(pattern)
        st = dfa.walk(dfa.start, text)
        return st is not None and dfa.accepting(st)

    assert matches("abc", "abc") and not matches("abc", "ab")
    assert matches("a(b|c)+d", "abcbd") and not matches("a(b|c)+d", "ad")
    assert matches("[a-c]{2,3}", "abc") and not matches("[a-c]{2,3}", "a")
    assert matches("-?[0-9]+", "-42") and not matches("-?[0-9]+", "4.2")
    assert matches('"([^"\\\\])*"', '"hi"') and not matches('"([^"\\\\])*"', '"a"b')
    assert matches("x?", "") and matches("\\d\\d", "37")
    # Negated shorthand classes: \D = non-digit (NOT the literal 'D').
    assert matches("\\D+", "abc") and not matches("\\D+", "a1")
    assert matches("\\S\\S", "ab") and not matches("\\S\\S", "a ")
    assert matches("\\W", "-") and not matches("\\W", "x")
    with pytest.raises(G.GrammarError):
        G._CharDFA("a(b")  # unterminated group
    with pytest.raises(G.GrammarError):
        G._CharDFA("*a")  # dangling quantifier


@pytest.mark.parametrize("pkg", PKGS)
def test_schema_regex_covers_shapes(pkg):
    G = M(pkg).grammar

    def accepts(schema, value) -> bool:
        dfa = G._CharDFA(G.build_regex_from_schema(schema))
        st = dfa.walk(dfa.start, json.dumps(value, separators=(",", ":")))
        return st is not None and dfa.accepting(st)

    assert accepts(ENUM_SCHEMA, "maybe") and not accepts(ENUM_SCHEMA, "nope")
    assert accepts(OBJ_SCHEMA, {"ok": True, "n": -3})
    assert not accepts(OBJ_SCHEMA, {"n": 3, "ok": True})  # property order fixed
    arr = {"type": "array", "items": {"type": "integer"}, "minItems": 1, "maxItems": 3}
    assert accepts(arr, [1, 2]) and not accepts(arr, [])
    assert accepts({"type": "number"}, 3.5e2)
    assert accepts({"anyOf": [{"type": "null"}, {"type": "integer"}]}, None)
    # json_object mode: the TOP level must be an object.
    assert accepts({"type": "object"}, {"a": 1, "b": [True, None]})
    assert not accepts({"type": "object"}, 42)
    assert not accepts({"type": "object"}, [1, 2])
    assert not accepts({"type": "object"}, "hi")
    with pytest.raises(G.GrammarError):
        G.build_regex_from_schema({"enum": []})
    with pytest.raises(G.GrammarError):
        G.build_regex_from_schema({"type": "frobnicate"})


@pytest.mark.parametrize("pkg", PKGS)
def test_json_strings_reject_raw_control_chars(pkg):
    # RFC 8259: U+0000–U+001F MUST be escaped inside strings.
    G = M(pkg).grammar
    dfa = G._CharDFA(G.build_regex_from_schema({"type": "string"}))

    def ok(text):
        st = dfa.walk(dfa.start, text)
        return st is not None and dfa.accepting(st)

    assert ok('"a b"') and ok('"a\\nb"') and ok('"a\\u000ab"')
    for raw in ("\n", "\t", "\r", "\x00", "\x1f"):
        assert not ok(f'"a{raw}b"'), repr(raw)
    obj = G._CharDFA(G.build_regex_from_schema(OBJ_SCHEMA))
    st = obj.walk(obj.start, '{\t\n"ok" \r: true, "n"\t: -3}')
    assert st is not None and obj.accepting(st)


@pytest.mark.parametrize("pkg", PKGS)
def test_token_automaton_walk_is_exact(pkg):
    G, tok = M(pkg).grammar, TOK(pkg)
    automaton = G.compile_token_automaton(G.build_regex_from_schema(OBJ_SCHEMA), tok)
    state = automaton.start
    for tid in tok.encode('{"ok": true, "n": 12}', add_special_tokens=False):
        nxt = automaton.advance(state, tid)
        assert nxt is not None, f"token {tid!r} ({chr(tid)}) inadmissible"
        state = nxt
    assert automaton.is_accepting(state)
    assert automaton.advance(automaton.start, ord("x")) is None
    clone = G.TokenMaskAutomaton.from_dict(automaton.to_dict())
    assert clone.hash == automaton.hash
    assert clone.edges == automaton.edges and clone.accepting == automaton.accepting


@pytest.mark.parametrize("pkg", PKGS)
def test_packed_mask_bits_and_eos(pkg):
    automaton = M(pkg).grammar.compile_token_automaton("(ab|cd)", TOK(pkg))
    automaton.set_mask_context(vocab_size=256, eos_ids=[0])
    words = automaton.packed_mask(automaton.start)

    def bit(t):
        return bool(words[t // 32] >> np.uint32(t % 32) & np.uint32(1))

    assert bit(ord("a")) and bit(ord("c"))
    assert not bit(ord("b")) and not bit(0)  # eos only in accepting states
    s = automaton.advance(automaton.advance(automaton.start, ord("a")), ord("b"))
    assert automaton.is_accepting(s) and automaton.is_terminal(s)
    assert bool(automaton.packed_mask(s)[0] & np.uint32(1))


@pytest.mark.parametrize("pkg", PKGS)
def test_constraint_spec_surfaces_and_compile_cache(pkg):
    G = M(pkg).grammar
    assert G.constraint_spec(None, None) is None
    assert G.constraint_spec({"type": "text"}, None) is None
    assert G.constraint_spec(None, "[0-9]+") == {"kind": "regex", "pattern": "[0-9]+"}
    spec = G.constraint_spec(
        {"type": "json_schema", "json_schema": {"name": "t", "schema": ENUM_SCHEMA}}, None)
    assert spec == {"kind": "json_schema", "schema": ENUM_SCHEMA}
    assert G.constraint_spec({"type": "json_object"}, None) == {"kind": "json_object"}
    with pytest.raises(G.GrammarError):
        G.constraint_spec({"type": "grammar_xyz"}, None)
    compiler = G.GrammarCompiler(TOK(pkg))
    a1 = compiler.compile(spec)
    a2 = compiler.compile({"kind": "json_schema", "schema": ENUM_SCHEMA})
    assert a1 is a2 and compiler.compiles == 1 and compiler.hits == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_runaway_grammar_fails_loudly(pkg):
    G = M(pkg).grammar
    with pytest.raises(G.GrammarError):
        G.compile_token_automaton("[0-9]{200,}", TOK(pkg), max_states=16)


@pytest.mark.parametrize("pkg", PKGS)
def test_dead_end_states_pruned_at_compile(pkg):
    # "Ā" (U+0100) decodes from no ByteTokenizer token, so the char-path
    # beyond 'a' is unsatisfiable: the edge into it must be pruned.
    G, tok = M(pkg).grammar, TOK(pkg)
    automaton = G.compile_token_automaton("ab|aĀ", tok)
    s = automaton.advance(automaton.start, ord("a"))
    assert s is not None
    assert set(automaton.allowed(s)) == {ord("b")}
    end = automaton.advance(s, ord("b"))
    assert automaton.is_accepting(end) and automaton.is_terminal(end)
    with pytest.raises(G.GrammarError):
        G.compile_token_automaton("aĀ", tok)
    corrupt = G.TokenMaskAutomaton(0, [{1: 1}, {}], accepting=[])
    assert not corrupt.is_terminal(1)


@pytest.mark.parametrize("pkg", PKGS)
def test_preprocessor_compiles_and_stamps_tenant_identity(pkg):
    m = M(pkg)
    op = m.preprocessor.OpenAIPreprocessor(TOK(pkg), "ad1", adapter="ad1")
    pre = op.preprocess({
        "model": "ad1", "prompt": "hi",
        "response_format": {"type": "json_schema",
                            "json_schema": {"name": "t", "schema": ENUM_SCHEMA}},
    })
    assert pre.annotations["adapter"] == "ad1"
    assert pre.annotations["kv_salt"] == m.lora.kv_salt_for_adapter("ad1")
    assert pre.grammar is not None and pre.grammar["edges"]
    P = m.protocols.PreprocessedRequest
    assert P.from_dict(pre.to_dict()).grammar == pre.grammar
    assert "grammar" not in P(token_ids=[1]).to_dict()
    with pytest.raises(ValueError):
        op.preprocess({"model": "ad1", "prompt": "hi",
                       "response_format": {"type": "grammar_xyz"}})


# ----------------------------------------------------- constrained decoding


def _assert_stream_obeys(pkg, automaton_dict, toks, *, parses_as=None):
    automaton = M(pkg).grammar.TokenMaskAutomaton.from_dict(automaton_dict)
    state = automaton.start
    for t in toks:
        nxt = automaton.advance(state, t)
        assert nxt is not None, f"emitted token {t} is not mask-admissible"
        state = nxt
    assert automaton.is_accepting(state), "stream ended mid-value"
    parsed = json.loads(TOK(pkg).decode(toks))
    if parses_as is not None:
        assert parsed in parses_as
    return parsed


@pytest.mark.parametrize("pkg", PKGS)
async def test_constrained_stream_parses_and_is_deterministic(pkg):
    metrics = M(pkg).metrics.tenancy_metrics
    engine = _engine(pkg)
    try:
        g = _automaton(pkg, ENUM_SCHEMA)
        prompt = [(j * 31 + 7) % 251 + 1 for j in range(12)]
        runs = [await _generate(pkg, engine, prompt, grammar=g, temperature=0.9, seed=42)
                for _ in range(2)]
        assert runs[0] == runs[1], "seeded constrained stream not deterministic"
        _assert_stream_obeys(pkg, g, runs[0], parses_as=["yes", "no", "maybe"])
        other = await _generate(pkg, engine, prompt, grammar=g, temperature=1.3, seed=7)
        _assert_stream_obeys(pkg, g, other, parses_as=["yes", "no", "maybe"])
        toks = await _generate(pkg, engine, prompt, grammar=_automaton(pkg, OBJ_SCHEMA),
                               max_tokens=64, temperature=0.8, seed=3)
        parsed = _assert_stream_obeys(pkg, _automaton(pkg, OBJ_SCHEMA), toks)
        assert set(parsed) == {"ok", "n"}
        assert isinstance(parsed["ok"], bool) and isinstance(parsed["n"], int)
        assert metrics.grammar_masked_rows_total > 0
    finally:
        await engine.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_spec_decode_grammar_exact_stream(pkg):
    """Token identity at temperature > 0 on a LoRA engine, through an
    adapter: the mask holds at every draft-verify position and the verify
    forward applies the row's own adapter."""
    lora = M(pkg).lora

    async def run(spec_enable):
        engine = _engine(pkg, lora={"enable": True, "max_adapters": 2, "rank": 4},
                         spec_decode={"enable": spec_enable, "k": 4})
        engine.register_adapter(lora.LoraAdapter.random(engine.model_config, "ad0", rank=4,
                                                        seed=100))
        try:
            g = _automaton(pkg, OBJ_SCHEMA)
            prompt = [1, 2, 3, 4] * 5  # repetitive: gives the proposer real drafts
            toks = await _generate(pkg, engine, prompt, grammar=g, model="ad0", max_tokens=64,
                                   temperature=0.9, seed=11)
            base = await _generate(pkg, engine, [5, 6, 7, 8] * 3, max_tokens=8)
            lora_plain = await _generate(pkg, engine, [5, 6, 7, 8] * 3, model="ad0",
                                         max_tokens=8)
            return toks, base, lora_plain
        finally:
            await engine.close()

    spec_toks, spec_base, spec_lora = await run(True)
    plain_toks, plain_base, plain_lora = await run(False)
    assert spec_toks == plain_toks, "spec decode diverged under a grammar"
    assert spec_base == plain_base
    assert spec_lora == plain_lora, "spec verify dropped the adapter"
    assert spec_lora != spec_base
    _assert_stream_obeys(pkg, _automaton(pkg, OBJ_SCHEMA), spec_toks)


@pytest.mark.parametrize("pkg", PKGS)
async def test_constrained_and_lora_rows_compile_nothing_new(pkg):
    """Warm every program the serving loop dispatches, then constrained
    and LoRA rows add none.  The port keys sampled traffic's programs at
    first use (engine/graphs.py), so its warm-up also serves the sampled
    unconstrained request once; constrained rows then ride the programs
    of the same sampling flags (the mask is a static input)."""
    lora = M(pkg).lora
    engine = _engine(pkg, lora={"enable": True, "max_adapters": 2, "rank": 4})
    engine.register_adapter(lora.LoraAdapter.random(engine.model_config, "a1", rank=4))
    try:
        prompt = [(j * 17 + 3) % 251 + 1 for j in range(12)]
        engine.warmup()
        await _generate(pkg, engine, prompt, max_tokens=16)
        if pkg == PORT:
            await _generate(pkg, engine, prompt, temperature=0.7, seed=5, max_tokens=16)
        before = engine.compile_counts()
        await _generate(pkg, engine, prompt, grammar=_automaton(pkg, ENUM_SCHEMA),
                        temperature=0.7, seed=5, max_tokens=16)
        await _generate(pkg, engine, prompt, model="a1", max_tokens=16)
        await _generate(pkg, engine, prompt, model="a1", grammar=_automaton(pkg, ENUM_SCHEMA),
                        max_tokens=16)
        assert engine.compile_counts() == before, (
            "tenant rows must ride the existing unified ragged program")
    finally:
        await engine.close()


async def test_mask_buffer_written_in_place_and_restored():
    """The port's step programs read one static mask buffer: a constrained
    step writes its rows in place (same storage), and the next step with
    no constrained row finds all-ones words again."""
    engine = _engine(PORT)
    try:
        buf = engine._mask_words
        ptr, shape = buf.data_ptr(), tuple(buf.shape)
        assert shape == (CFG["max_batch"], (engine.model_config.vocab_size + 31) // 32)
        assert bool((buf == 0xFFFFFFFF).all())
        await _generate(PORT, engine, [5, 6, 7], grammar=_automaton(PORT, ENUM_SCHEMA),
                        max_tokens=8)
        assert engine._mask_words.data_ptr() == ptr and engine._mask_dirty
        await _generate(PORT, engine, [5, 6, 7], max_tokens=3)
        assert not engine._mask_dirty and bool((engine._mask_words == 0xFFFFFFFF).all())
        assert engine._mask_words.data_ptr() == ptr
    finally:
        await engine.close()


@pytest.mark.parametrize("V", [31, 32, 33, 300])
def test_mask_unpack_matches_jax(V):
    """The sampler's mask stage admits exactly the set bits of each row's
    words (bit i % 32 of word i // 32, the high bit included), as the JAX
    sampler does: greedy rows whose logits rise with the token id take
    the highest admissible id, one row for each single bit, one for each
    word's bit 31 cleared, and an all-ones row."""
    import jax.numpy as jnp
    import torch

    from dynamo_tpu.ops import sampling as jsamp
    from dynamo_tpu_torch.ops import sampling as tsamp

    W = (V + 31) // 32
    single = np.zeros((V, W), np.uint32)
    single[np.arange(V), np.arange(V) // 32] = np.uint32(1) << (np.arange(V) % 32).astype(np.uint32)
    words = np.concatenate([single, np.full((1, W), 0x7FFFFFFF, np.uint32),
                            np.full((1, W), 0xFFFFFFFF, np.uint32)])
    B = words.shape[0]
    logits = np.tile(np.arange(V, dtype=np.float32), (B, 1))
    want_tok = np.concatenate([np.arange(V), [max(i for i in range(V) if i % 32 != 31)],
                               [V - 1]])
    zeros_f, zeros_i = np.zeros(B, np.float32), np.zeros(B, np.int32)
    counts = np.zeros((B, V), np.int16)
    want = jsamp.sample_tokens(
        jnp.asarray(logits), jnp.asarray(np.arange(B, dtype=np.uint32)), jnp.asarray(zeros_i),
        jnp.asarray(zeros_f), jnp.asarray(zeros_i), jnp.ones(B, jnp.float32),
        jnp.asarray(zeros_f), jnp.asarray(zeros_f), jnp.asarray(counts),
        jnp.asarray(False), jnp.asarray(words), jnp.asarray(True))
    samp = tsamp.SamplingParams.from_numpy(
        torch.device("cpu"), np.arange(B, dtype=np.uint32), zeros_i, zeros_f, zeros_i, np.ones(B, np.float32),
        zeros_f, zeros_f, torch.from_numpy(counts), False, mask_words=words)
    got = tsamp.sample_tokens(torch.from_numpy(logits), samp).tokens.numpy()
    np.testing.assert_array_equal(np.asarray(want.tokens), want_tok)
    np.testing.assert_array_equal(got, want_tok)


# ------------------------------------------------- the wire dict and hash

SPECS = {
    "enum": {"kind": "json_schema", "schema": ENUM_SCHEMA},
    "object": {"kind": "json_schema", "schema": OBJ_SCHEMA},
    "string-int-enum": {"kind": "json_schema", "schema": {
        "type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                                         "kind": {"enum": ["cat", "dog"]}}}},
    "json_object": {"kind": "json_object"},
    "regex": {"kind": "regex", "pattern": "[0-9]{3}-[a-z]+"},
}


@pytest.mark.parametrize("spec", list(SPECS))
def test_automaton_dict_and_hash_equal_jax(spec):
    """The same spec and byte tokenizer: the port's ``to_dict()`` equals the
    JAX package's, and so do the hash and the stub."""
    auts = {pkg: M(pkg).grammar.GrammarCompiler(TOK(pkg)).compile(SPECS[spec]) for pkg in PKGS}
    assert json.dumps(auts[PORT].to_dict(), sort_keys=True) == \
        json.dumps(auts[JAX].to_dict(), sort_keys=True)
    assert auts[PORT].hash == auts[JAX].hash
    assert auts[PORT].wire_stub() == auts[JAX].wire_stub()


def _sp_model(tmp_path):
    """A seeded sentencepiece vocabulary of 3000 pieces (byte pieces, the
    printable characters, random words, half of them "▁"-prefixed)."""
    sp = importlib.import_module(f"{PORT}.llm.sp")
    rng = np.random.default_rng(5)
    pieces = [("<unk>", 0.0, sp.UNKNOWN), ("<s>", 0.0, sp.CONTROL), ("</s>", 0.0, sp.CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, sp.BYTE) for b in range(128)]
    pieces += [(sp.WS, -10.0, sp.NORMAL)] + [(chr(c), -10.0, sp.NORMAL) for c in range(33, 127)]
    seen = {p for p, _, _ in pieces}
    while len(pieces) < 3000:
        w = "".join(rng.choice(list("abcdefghij\"{}:,0123"), size=int(rng.integers(2, 6))))
        w = (sp.WS + w) if rng.random() < 0.5 else w
        if w not in seen:
            seen.add(w)
            pieces.append((w, float(-1.0 - rng.random() * 8), sp.NORMAL))
    path = tmp_path / "tokenizer.model"
    path.write_bytes(sp.build_model_proto(pieces, unk_id=0, bos_id=1, eos_id=2))
    return str(path)


def test_automaton_dict_and_hash_equal_jax_on_sentencepiece(tmp_path):
    """On a sentencepiece vocabulary the port indexes each piece as a stream
    renders it ("▁ab" as " ab"); the JAX package decodes it alone, with the
    sequence-start strip ("ab").  The port's wire dict and hash equal the
    JAX compiler's run over the mid-stream piece strings, and differ from
    its plain compile (a deliberate departure: ROADMAP.md)."""
    path = _sp_model(tmp_path)
    spec = SPECS["string-int-enum"]
    port = M(PORT).grammar.GrammarCompiler(M(PORT).tokenizer.SentencePieceTokenizer(path))
    port = port.compile(spec)
    jg, jtok = M(JAX).grammar, M(JAX).tokenizer.SentencePieceTokenizer(path)
    rendered = {i: s for i in range(jtok.vocab_size)
                if (s := jtok.decode_window([i], sequence_start=False))}
    assert sum(s.startswith(" ") and len(s) > 1 for s in rendered.values()) > 1000
    jax_rendered = jg.compile_token_automaton(jg.spec_regex(spec), jtok, token_strings=rendered)
    assert port.to_dict() == jax_rendered.to_dict() and port.hash == jax_rendered.hash
    assert len(port.edges) > 4
    plain = jg.GrammarCompiler(jtok).compile(spec)
    assert port.to_dict() != plain.to_dict() and port.hash != plain.hash


SP_WALK_SPECS = {
    "string-int-enum": SPECS["string-int-enum"],
    "enum": {"kind": "json_schema", "schema": {"enum": ["abc", "bad", "cafe"]}},
    "regex": {"kind": "regex", "pattern": "[a-j]{2,6}-[0-9]{2}"},
}


def _rendered_walks(tok, aut, n, seed):
    """``n`` seeded random walks over the automaton's token edges, each
    rendered by the tokenizer's stream detokenizer: [(text, accepting)]."""
    rng = np.random.default_rng(seed)
    acc, out = set(aut.accepting), []
    for _ in range(n):
        st, stream, text = aut.start, tok.decode_stream(), ""
        for _ in range(60):
            if not aut.edges[st] or (st in acc and rng.random() < 0.3):
                break
            toks = sorted(aut.edges[st])
            t = toks[int(rng.integers(len(toks)))]
            st = aut.edges[st][t]
            text += stream.step(t)
        out.append((text + stream.flush(), st in acc))
    return out


@pytest.mark.parametrize("spec", list(SP_WALK_SPECS))
def test_sentencepiece_constrained_walks_render_in_their_language(tmp_path, spec):
    """Every token walk the port's automaton admits on a sentencepiece
    vocabulary renders, through the stream detokenizer, as a prefix of the
    constraint's language, and as a member where the walk ends accepting
    (200 seeded walks).  The JAX package's automaton, which indexes "▁ab"
    as "ab", admits walks that render outside the regex's language."""
    path = _sp_model(tmp_path)
    g = M(PORT).grammar
    tok = M(PORT).tokenizer.SentencePieceTokenizer(path)
    dfa = g._CharDFA(g.spec_regex(SP_WALK_SPECS[spec]))
    walks = _rendered_walks(tok, g.GrammarCompiler(tok).compile(SP_WALK_SPECS[spec]), 200, 9)
    assert sum(a for _, a in walks) >= 20
    for text, accepting in walks:
        st = dfa.walk(dfa.start, text)
        assert st is not None, text
        assert not accepting or dfa.accepting(st), text
    if spec == "regex":
        jtok = M(JAX).tokenizer.SentencePieceTokenizer(path)
        jaut = M(JAX).grammar.GrammarCompiler(jtok).compile(SP_WALK_SPECS[spec])
        assert any(dfa.walk(dfa.start, t) is None for t, _ in _rendered_walks(jtok, jaut, 200, 9))


# ------------------------------------------------------ engines, exactly

STREAM_CASES = [
    # (prompt, grammar spec or None, sampling, max_tokens)
    ([(j * 31 + 7) % 251 + 1 for j in range(12)], "object", {}, 40),
    ([1, 2, 3, 4] * 5, "object", dict(temperature=0.9, seed=11), 40),
    (list(range(40, 61)), None, {}, 30),
    ([9, 8, 7] * 4, "enum", dict(temperature=0.8, seed=3), 16),
    ([200, 1, 150, 7], None, dict(temperature=0.7, seed=5), 30),
    ([5, 17, 33, 2, 250, 9, 61], "regex", {}, 20),
]
_WANT = {}


async def _case_streams(pkg, over):
    engine = _engine(pkg, **over)
    try:
        jobs = []
        for prompt, spec, samp, n in STREAM_CASES:
            g = (None if spec is None else
                 M(pkg).grammar.GrammarCompiler(TOK(pkg)).compile(SPECS[spec]).to_dict())
            jobs.append(_generate(pkg, engine, prompt, grammar=g, max_tokens=n, **samp))
        return await asyncio.gather(*jobs)
    finally:
        await engine.close()


@pytest.mark.parametrize("spec", [False, True], ids=["spec-off", "spec-on"])
@pytest.mark.parametrize("steps", [1, 4, 8])
async def test_constrained_streams_match_tpu_engine(steps, spec):
    """Three constrained requests (greedy and seeded), two unconstrained and
    a regex one, all at once on a 4-row engine: the port's streams equal
    TpuEngine's on the same weights, speculation off and on (tolerance:
    none), and every constrained stream obeys its automaton."""
    over = {"decode_steps": steps}
    if spec:
        over["spec_decode"] = {"enable": True, "k": 4}
    key = (steps, spec)
    if key not in _WANT:
        _WANT[key] = await _case_streams(JAX, over)
    got = await _case_streams(PORT, over)
    assert got == _WANT[key]
    for (_, spec_name, _, n), toks in zip(STREAM_CASES, got):
        assert 0 < len(toks) <= n
        if spec_name is not None:
            aut = M(PORT).grammar.TokenMaskAutomaton.from_dict(
                M(PORT).grammar.GrammarCompiler(TOK(PORT)).compile(SPECS[spec_name]).to_dict())
            state = aut.start
            for t in toks:
                state = aut.advance(state, t)
                assert state is not None


# ------------------------------------------------------------- migration


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
async def test_constrained_stream_migrates_across_packages(src, dst):
    """A seeded constrained stream migrated mid-decode from a worker of one
    package to a worker of the other, over one hub: the splice request
    carries the serialized automaton, the target rebuilds it and replays
    the delivered tokens, and the client's stream equals the
    never-migrated stream of either package."""
    from test_torch_migration import (
        P, _close_worker, _consume, _control, _CopyGate, _spawn_worker, _tokens, _wait_for,
    )

    C = P[PORT]
    hub = await P[dst].hub.HubServer().start()
    a = await _spawn_worker(src, hub.address, "g", "w")
    b = await _spawn_worker(dst, hub.address, "g", "w")
    client_rt = await C.component.DistributedRuntime.connect(hub.address)
    try:
        client = await client_rt.namespace("g").component("w").endpoint("gen").client()
        await client.wait_for_instances(5)
        g = _automaton(PORT, OBJ_SCHEMA)
        prompt = [1, 2, 3, 4] * 5
        kw = dict(max_tokens=48, grammar=g, temperature=0.9, seed=11)
        want_src = await _control(src, a.engine, _req(src, prompt, **kw))
        want_dst = await _control(dst, b.engine, _req(dst, prompt, **kw))
        assert want_src == want_dst and len(want_src) >= 8
        ctx = C.engine.Context(_req(PORT, prompt, **kw))
        stream = await client.generate(ctx, worker_id=a.rt.worker_id)
        items = []
        task = _consume(stream, items)
        await _wait_for(lambda: len(_tokens(items)) >= 4)
        gate = _CopyGate(a.mig)
        assert await a.mig.migrate_out(ctx.id, b.target)
        gate.release()
        await task
        assert _tokens(items) == want_src
        assert a.engine.find_sequence(ctx.id) is None
        await client.close()
    finally:
        await _close_worker(a)
        await _close_worker(b)
        await client_rt.close()
        await hub.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_resume_violating_its_grammar_is_refused(pkg):
    """A resume request whose delivered output (folded into the prompt)
    the automaton rejects is a request error, on either engine."""
    engine = _engine(pkg)
    try:
        req = _req(pkg, [5, 6, 7, ord("x")], grammar=_automaton(pkg, ENUM_SCHEMA))
        req["annotations"]["resume"] = {"orig_prompt_len": 3}
        rt = M(pkg).rt
        with pytest.raises(ValueError, match="violates its grammar"):
            await rt.collect(await engine.generate(rt.Context(req)))
    finally:
        await engine.close()


# ----------------------------------------------------------- hash-first


@pytest.mark.parametrize("pkg", PKGS)
async def test_grammar_hash_first_wire(pkg):
    """tests/test_chaos.py::test_grammar_hash_first_wire on ``pkg``: the
    engine's LRU resolves a stub after one full table, a miss raises the
    typed error, and the preprocessor sends stub, full, then a 2-dispatch
    full burst, then stubs."""
    m = M(pkg)
    G, metrics = m.grammar, m.metrics.tenancy_metrics
    automaton = G.TokenMaskAutomaton(start=0, edges=[{5: 1}, {}], accepting=[1])
    stub = automaton.wire_stub()
    assert stub == {"hash": automaton.hash, "stub": True}
    cls = TpuEngine if pkg == JAX else TorchEngine
    fake_engine = SimpleNamespace(_grammar_lru=OrderedDict(),
                                  model_config=SimpleNamespace(vocab_size=64, eos_token_ids=(0,)))
    with pytest.raises(G.GrammarCacheMissError):
        cls._grammar_automaton(fake_engine, dict(stub))
    got = cls._grammar_automaton(fake_engine, automaton.to_dict())
    assert got.hash == automaton.hash
    hits = metrics.grammar_hash_hits_total
    assert cls._grammar_automaton(fake_engine, dict(stub)) is got
    assert metrics.grammar_hash_hits_total == hits + 1

    seen = []

    class FakeNext:
        has_table = False

        async def generate(self, request):
            g = request.data.get("grammar")
            seen.append(g)
            if g.get("stub"):
                if not self.has_table:
                    raise G.GrammarCacheMissError(g["hash"])
            else:
                self.has_table = True

            async def gen():
                yield {"ok": True}

            return m.rt.ResponseStream(gen(), request.ctx)

    pre = m.protocols.PreprocessedRequest(token_ids=[1], grammar=automaton.to_dict())
    pp = m.preprocessor.OpenAIPreprocessor(tokenizer=None)
    fake = FakeNext()
    resends = metrics.grammar_full_resends_total
    for i in range(5):
        stream = await pp._dispatch(fake, m.rt.AsyncEngineContext(f"r{i}"), pre)
        assert [i async for i in stream] == [{"ok": True}]
    assert ["stub" if g.get("stub") else "full" for g in seen] == \
        ["stub", "full", "full", "full", "stub", "stub"]
    assert metrics.grammar_full_resends_total == resends + 1


async def _wire_round(front_pkg, worker_pkg):
    """``front_pkg``'s preprocessor pipeline over the service plane to a
    ``worker_pkg`` worker: four identical constrained chat requests.
    Returns (texts, the front's counters, the worker's counters)."""
    W = lambda sub: importlib.import_module(f"{worker_pkg}.{sub}")  # noqa: E731
    F = lambda sub: importlib.import_module(f"{front_pkg}.{sub}")  # noqa: E731
    for pkg in PKGS:
        M(pkg).metrics.tenancy_metrics.reset()
    hub = await W("runtime.transports.hub").HubServer(host="127.0.0.1").start()
    rt = await W("runtime.component").DistributedRuntime.connect(hub.address)
    engine = _engine(worker_pkg, decode_steps=4)
    front = None
    try:
        endpoint = rt.namespace("g").component("worker").endpoint("generate")
        await endpoint.serve_endpoint(engine)
        front = await F("runtime.component").DistributedRuntime.connect(hub.address)
        client = await front.namespace("g").component("worker").endpoint("generate").client()
        await client.wait_for_instances(5)
        tok = F("llm.tokenizer").ByteTokenizer()
        pipeline = F("runtime.pipeline").build_pipeline(
            [F("llm.preprocessor").OpenAIPreprocessor(tok, "m"), F("llm.backend").Backend(tok)],
            client)
        body = {"model": "m", "messages": [{"role": "user", "content": "pick"}],
                "max_tokens": 12,
                "response_format": {"type": "json_schema",
                                    "json_schema": {"name": "a", "schema": ENUM_SCHEMA}}}
        texts = []
        for _ in range(4):
            chunks = await F("runtime.engine").collect(
                await pipeline.generate(F("runtime.engine").Context(dict(body))))
            texts.append("".join(c["choices"][0]["delta"].get("content") or ""
                                 for c in chunks if c.get("choices")))
        await client.close()
        fm = M(front_pkg).metrics.tenancy_metrics
        wm = M(worker_pkg).metrics.tenancy_metrics
        front_counts = {k: getattr(fm, k) for k in (
            "grammar_compiles_total", "grammar_cache_hits_total", "grammar_full_resends_total",
            "grammar_stub_dispatches_total")}
        worker_counts = {k: getattr(wm, k) for k in (
            "grammar_requests_total", "grammar_hash_hits_total", "grammar_hash_misses_total")}
        return texts, front_counts, worker_counts
    finally:
        if front is not None:
            await front.close()
        await engine.close()
        await rt.close()
        await hub.close()


async def test_stub_miss_resend_over_the_service_plane_both_ways():
    """Port preprocessor → JAX worker, and JAX preprocessor → port worker:
    the first request's stub misses (``grammar_miss`` in the prologue),
    the full table follows at once, two more ship it whole, the fourth
    stub hits; both directions count the same, and every answer is one
    of the enum's values, the same text both ways."""
    a = await _wire_round(PORT, JAX)
    b = await _wire_round(JAX, PORT)
    assert a == b
    texts, front, worker = a
    assert front == {"grammar_compiles_total": 1, "grammar_cache_hits_total": 3,
                     "grammar_full_resends_total": 1, "grammar_stub_dispatches_total": 1}
    assert worker == {"grammar_requests_total": 4, "grammar_hash_hits_total": 1,
                      "grammar_hash_misses_total": 1}
    assert len(set(texts)) == 1 and json.loads(texts[0]) in ENUM_SCHEMA["enum"]


# ----------------------------------------------------------------- HTTP

PICK = {"model": "m", "messages": [{"role": "user", "content": "pick one"}]}
SCHEMA_RF = {"type": "json_schema", "json_schema": {"name": "pick", "schema": ENUM_SCHEMA}}
HTTP_CASES = {
    "json-schema-unary": ("/v1/chat/completions", dict(PICK, max_tokens=12,
                                                       response_format=SCHEMA_RF)),
    "json-schema-stream": ("/v1/chat/completions", dict(PICK, max_tokens=12, stream=True,
                                                        response_format=SCHEMA_RF)),
    "json-object-stream": ("/v1/chat/completions", dict(PICK, max_tokens=24, stream=True,
                                                        response_format={"type": "json_object"})),
    "json-schema-seeded-completion": ("/v1/completions", dict(
        model="m", prompt=[5, 17, 33, 2], max_tokens=30, temperature=0.9, seed=4,
        response_format={"type": "json_schema", "json_schema": {"schema": OBJ_SCHEMA}})),
    "nvext-regex": ("/v1/completions", dict(model="m", prompt=[5, 17, 33], max_tokens=12,
                                             nvext={"grammar": "[0-9]{3}-(ab|cd)"})),
    "bad-schema": ("/v1/chat/completions", dict(
        PICK, response_format={"type": "json_schema", "json_schema": {"schema": {"enum": []}}})),
    "bad-regex": ("/v1/completions", dict(model="m", prompt=[5], nvext={"grammar": "a(b"})),
    "unknown-format": ("/v1/chat/completions", dict(PICK, response_format={"type": "yaml"})),
}


@pytest.mark.parametrize("case", list(HTTP_CASES))
def test_http_bodies_match_jax(servers, case):  # noqa: F811
    """The same structured-output request to the JAX edge and the port's:
    statuses, bodies and SSE chunk sequences equal (ids and timestamps
    masked); a malformed constraint is a 400 on both."""
    path, body = HTTP_CASES[case]
    want, got = servers.run(_both(servers, path, body))
    assert got == want
    if case.startswith("bad") or case.startswith("unknown"):
        assert got[0] == 400
    else:
        assert got[0] == 200


def test_json_schema_text_parses_and_matches(servers):  # noqa: F811
    """A ``json_schema`` chat answer on the port's edge parses under the
    schema (its enum) and equals the JAX edge's text."""
    path, body = HTTP_CASES["json-schema-unary"]
    texts = []
    for base in (servers.jax_base, servers.base):
        status, _, text, _ = servers.run(_post(base, path, body))
        assert status == 200, text
        choice = json.loads(text)["choices"][0]
        assert choice["finish_reason"] == "stop"
        texts.append(choice["message"]["content"])
    assert texts[0] == texts[1] and json.loads(texts[1]) in ENUM_SCHEMA["enum"]


def test_cli_json_schema_answer_equals_the_jax_edge(servers, tmp_path):  # noqa: F811
    """``run in=http out=torch --checkpoint DIR`` (the JAX edge's seeded
    weights, written as a checkpoint, the edge's engine geometry): a
    ``json_schema`` chat request answers the JAX edge's text, which
    parses under the schema."""
    from dynamo_tpu_torch.models import loader
    from dynamo_tpu_torch.models.config import get_config

    from test_torch_http import CFG as HCFG

    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, _jax_params()), device="cpu")
    ckpt = str(tmp_path / "tiny")
    loader.save_params_hf(tree, ckpt, config=get_config("debug-tiny").with_overrides(
        dtype="float32"))
    argv = ["run", "in=http", "out=torch", "--checkpoint", ckpt, "--model", "m", "--dtype",
            "float32", "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
            "--block-size", str(HCFG["block_size"]), "--num-blocks", str(HCFG["num_blocks"]),
            "--max-batch", str(HCFG["max_batch"]), "--max-model-len", str(HCFG["max_model_len"]),
            "--prefill-chunk", str(HCFG["prefill_chunk"]),
            "--decode-steps", str(HCFG["decode_steps"])]
    p = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.cli", *argv],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    path, body = HTTP_CASES["json-schema-unary"]
    try:
        line = p.stdout.readline()
        assert line.startswith("serving 'm' on http://127.0.0.1:"), (line, p.stderr.read())
        base = line.strip().split(" on ")[1]
        status, _, text, _ = asyncio.run(_post(base, path, body))
        assert status == 200, text
        got = json.loads(text)["choices"][0]["message"]["content"]
    finally:
        p.send_signal(signal.SIGINT)
        try:
            p.wait(timeout=30)
        finally:
            p.kill()
    status, _, text, _ = servers.run(_post(servers.jax_base, path, body))
    assert status == 200
    assert got == json.loads(text)["choices"][0]["message"]["content"]
    assert json.loads(got) in ENUM_SCHEMA["enum"]


@pytest.mark.parametrize("worker_pkg", PKGS)
async def test_http_hub_kv_router_serves_structured_output(worker_pkg):
    """``http --hub … --router kv``'s ``ModelWatcher`` (the port's) over a
    ``run in=dyn://`` worker of either package: a ``json_schema`` chat
    request, three times, answers what the worker's engine gives it behind
    a local pipeline, through one compile at the frontend; the worker's
    automaton cache already holds the table from the local request, so
    every dispatch goes out as the hash-only stub and hits."""
    W = lambda sub: importlib.import_module(f"{worker_pkg}.{sub}")  # noqa: E731
    F = lambda sub: importlib.import_module(f"{PORT}.{sub}")  # noqa: E731
    hub = await W("runtime.transports.hub").HubServer(host="127.0.0.1").start()
    rt = await W("runtime.component").DistributedRuntime.connect(hub.address)
    engine = _engine(worker_pkg, decode_steps=4)
    front = watcher = None
    body = {"model": "debug-tiny", "max_tokens": 12,
            "messages": [{"role": "user", "content": "pick"}],
            "response_format": {"type": "json_schema",
                                "json_schema": {"name": "a", "schema": ENUM_SCHEMA}}}

    def text_of(chunks):
        return "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks
                       if c.get("choices"))

    try:
        wtok = W("llm.tokenizer").ByteTokenizer()
        local = W("runtime.pipeline").build_pipeline(
            [W("llm.preprocessor").OpenAIPreprocessor(wtok, "debug-tiny"),
             W("llm.backend").Backend(wtok)], engine)
        want = text_of(await W("runtime.engine").collect(
            await local.generate(W("runtime.engine").Context(dict(body)))))
        assert json.loads(want) in ENUM_SCHEMA["enum"]
        endpoint = rt.namespace("t").component("worker").endpoint("generate")
        await endpoint.serve_endpoint(engine)
        await W("llm.discovery").register_model(rt, "debug-tiny", endpoint.path,
                                                kv_block_size=CFG["block_size"])
        front = await F("runtime.component").DistributedRuntime.connect(hub.address)
        manager = F("llm.http_service").ModelManager()
        watcher = await F("llm.discovery").ModelWatcher(
            front, manager, router_mode=F("runtime.client").RouterMode("kv")).start()
        for _ in range(300):
            if manager.chat_engine("debug-tiny") is not None:
                break
            await asyncio.sleep(0.02)
        metrics = M(PORT).metrics.tenancy_metrics
        metrics.reset()
        for _ in range(3):
            chunks = await F("runtime.engine").collect(
                await manager.chat_engine("debug-tiny").generate(
                    F("runtime.engine").Context(dict(body))))
            assert text_of(chunks) == want
        assert (metrics.grammar_compiles_total, metrics.grammar_full_resends_total,
                metrics.grammar_stub_dispatches_total) == (1, 0, 3)
    finally:
        if watcher is not None:
            await watcher.stop()
        if front is not None:
            await front.close()
        await engine.close()
        await rt.close()
        await hub.close()
