"""A seeded llama-3-format tokenizer directory, written without ``tokenizers``.

``write(OUT_DIR, n_tokens=128000, seed=14)`` writes ``OUT_DIR/tokenizer.json``
and ``OUT_DIR/tokenizer_config.json`` in the layout Llama 3.1 ships: a
byte-level BPE of ``n_tokens`` tokens (the 256 byte characters, then tokens
each made by one merge), ``ignore_merges``, the ``Split`` + ``ByteLevel``
pre-tokenizer, 256 special tokens from id ``n_tokens`` on
(``<|begin_of_text|>``, ``<|eot_id|>``, …), a ``TemplateProcessing`` that
prepends ``<|begin_of_text|>``, the ByteLevel decoder, and Llama 3.1's
published chat template.  The merges grow seeded random words
(``words``) prefix by prefix, so every token is reachable and any text
encodes.  It stands in for a real checkpoint's tokenizer where the
repository holds none: the vocabulary is synthetic, the format, sizes and
template are the model's.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Tuple

from ..llm.hf_tokenizer import BYTES_CHAR, byte_level_chars

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
NAMED_SPECIALS = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 4: "<|finetune_right_pad_id|>",
                  6: "<|start_header_id|>", 7: "<|end_header_id|>", 8: "<|eom_id|>",
                  9: "<|eot_id|>", 10: "<|python_tag|>"}
# The published Llama-3.1 chat template: the "chat_template" of
# meta-llama/Llama-3.1-8B-Instruct's tokenizer_config.json.
CHAT_TEMPLATE = r"""{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = "26 Jul 2024" %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{#- System message + builtin tools #}
{{- "<|start_header_id|>system<|end_header_id|>\n\n" }}
{%- if builtin_tools is defined or tools is not none %}
    {{- "Environment: ipython\n" }}
{%- endif %}
{%- if builtin_tools is defined %}
    {{- "Tools: " + builtin_tools | reject('equalto', 'code_interpreter') | join(", ") + "\n\n"}}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\n" }}
{{- "Today Date: " + date_string + "\n\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions. To call a function, please respond with JSON for a function call." }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\n\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{#- Custom tools are passed in a user message with some extra guidance #}
{%- if tools_in_user_message and not tools is none %}
    {#- Extract the first user message so we can plug it in here #}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\n\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- "with its proper arguments that best answers the given prompt.\n\n" }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\n\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {%- if builtin_tools is defined and tool_call.name in builtin_tools %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' -}}
            {{- "<|python_tag|>" + tool_call.name + ".call(" }}
            {%- for arg_name, arg_val in tool_call.arguments | items %}
                {{- arg_name + '="' + arg_val + '"' }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- endif %}
                {%- endfor %}
            {{- ")" }}
        {%- else  %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' -}}
            {{- '{"name": "' + tool_call.name + '", ' }}
            {{- '"parameters": ' }}
            {{- tool_call.arguments | tojson }}
            {{- "}" }}
        {%- endif %}
        {%- if builtin_tools is defined %}
            {#- This means we're in ipython mode #}
            {{- "<|eom_id|>" }}
        {%- else %}
            {{- "<|eot_id|>" }}
        {%- endif %}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\n\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' }}
{%- endif %}
"""


def special_tokens(n: int = 256) -> List[str]:
    """Llama 3.1's special tokens, in id order."""
    out, reserved = [], 0
    for i in range(n):
        if i in NAMED_SPECIALS:
            out.append(NAMED_SPECIALS[i])
        else:
            out.append(f"<|reserved_special_token_{reserved}|>")
            reserved += 1
    return out


def words(rng: random.Random):
    """An endless seeded stream of pre-tokens as the split pattern cuts
    them: words with and without a leading space, capitalised or not,
    digit groups, punctuation runs, newline runs."""
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    weights = [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8, 2.4, 2.4, 2.2,
               2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.2, 0.1, 0.1]
    while True:
        r = rng.random()
        if r < 0.86:
            w = "".join(rng.choices(letters, weights, k=rng.randint(2, 9)))
            if rng.random() < 0.2:
                w = w.capitalize()
            yield (" " + w) if rng.random() < 0.6 else w
        elif r < 0.93:
            yield "".join(rng.choices("0123456789", k=rng.randint(2, 3)))
        elif r < 0.98:
            yield (" " if rng.random() < 0.5 else "") + "".join(
                rng.choices(".,;:!?'\"()[]{}-_/*+=<>#", k=rng.randint(1, 3)))
        else:
            yield rng.choice(["\n\n", "  ", "   ", "\n\n\n", " \n", "    "])


def byte_level_bpe(n_tokens: int, seed: int) -> Tuple[Dict[str, int], List[List[str]]]:
    """``n_tokens`` tokens: the 256 byte characters, then one per merge."""
    vocab: Dict[str, int] = {BYTES_CHAR[b]: b for b in range(256)}
    merges: List[List[str]] = []
    stream = words(random.Random(seed))
    while len(vocab) < n_tokens:
        chars = byte_level_chars(next(stream))
        cur = chars[0]
        for c in chars[1:]:
            new = cur + c
            if new not in vocab:
                vocab[new] = len(vocab)
                merges.append([cur, c])
                if len(vocab) == n_tokens:
                    break
            cur = new
    return vocab, merges


def tokenizer_json(n_tokens: int = 128000, seed: int = 14) -> Dict:
    vocab, merges = byte_level_bpe(n_tokens, seed)
    specials = special_tokens()
    added = [{"id": n_tokens + i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(specials)]
    bos = specials[0]
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [n_tokens], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }


def write(out_dir: str, n_tokens: int = 128000, seed: int = 14) -> str:
    """Write the directory's two files; returns the tokenizer.json path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "tokenizer.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(tokenizer_json(n_tokens, seed), f, ensure_ascii=False)
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
                   "chat_template": CHAT_TEMPLATE}, f, ensure_ascii=False, indent=1)
    return path

