"""The port's chat-template renderer (``llm/chat_template.py``) against the
JAX package's ``apply_chat_template``, which renders with jinja2
(``Environment(trim_blocks=True, lstrip_blocks=True)``, ``raise_exception``):

- the published llama-3.1 template, whole, with and without
  ``builtin_tools``; templates modelled on the published Qwen2, Mistral
  and DeepSeek-R1 templates (not byte-exact copies); and one template per
  construct of the subset, over system, user, assistant and tool
  messages, ``tools`` or none, both ``add_generation_prompt`` settings,
  ``None`` and empty content: identical text, or the same error class
  where jinja2 raises (its TemplateAssertionError counts as the
  TemplateSyntaxError it subclasses);
- templates jinja2 refuses to compile are refused alike;
- a construct jinja2 has and the subset does not is refused when the
  template compiles, with an error naming it;
- a template compiles once per text.
"""

import importlib

import pytest

from dynamo_tpu_torch.llm import chat_template as ct

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"

# The published Llama-3.1 chat template, typed in whole: the "chat_template"
# of meta-llama/Llama-3.1-8B-Instruct's tokenizer_config.json (Llama 3.2
# and 3.3 ship the same text), with its builtin_tools branches.
LLAMA31 = """{{- bos_token }}
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
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if builtin_tools is defined or tools is not none %}
    {{- "Environment: ipython\\n" }}
{%- endif %}
{%- if builtin_tools is defined %}
    {{- "Tools: " + builtin_tools | reject('equalto', 'code_interpreter') | join(", ") + "\\n\\n"}}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions. To call a function, please respond with JSON for a function call." }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
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
    {{- '<|start_header_id|>user<|end_header_id|>\\n\\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- "with its proper arguments that best answers the given prompt.\\n\\n" }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {%- if builtin_tools is defined and tool_call.name in builtin_tools %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
            {{- "<|python_tag|>" + tool_call.name + ".call(" }}
            {%- for arg_name, arg_val in tool_call.arguments | items %}
                {{- arg_name + '="' + arg_val + '"' }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- endif %}
                {%- endfor %}
            {{- ")" }}
        {%- else  %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
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
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

QWEN2 = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are Qwen, created by Alibaba Cloud. You are a helpful assistant.' }}
    {%- endif %}
    {{- "\\n\\n# Tools\\n\\nYou may call one or more functions to assist with the user query.\\n\\nYou are provided with function signatures within <tools></tools> XML tags:\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools>\\n\\nFor each function call, return a json object with function name and arguments within <tool_call></tool_call> XML tags:\\n<tool_call>\\n{\\"name\\": <function-name>, \\"arguments\\": <args-json-object>}\\n</tool_call><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
    {%- else %}
        {{- '<|im_start|>system\\nYou are Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\\n<tool_call>\\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- message.content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""

MISTRAL = """{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content'] %}
    {%- set loop_messages = messages[1:] %}
{%- else %}
    {%- set loop_messages = messages %}
{%- endif %}

{{- bos_token }}
{%- for message in loop_messages %}
    {%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}
        {{- raise_exception('After the optional system message, conversation roles must alternate user/assistant/user/assistant/...') }}
    {%- endif %}
    {%- if message['role'] == 'user' %}
        {%- if loop.first and system_message is defined %}
            {{- ' [INST] ' + system_message + '\\n\\n' + message['content'] + ' [/INST]' }}
        {%- else %}
            {{- ' [INST] ' + message['content'] + ' [/INST]' }}
        {%- endif %}
    {%- elif message['role'] == 'assistant' %}
        {{- ' ' + message['content'] + eos_token}}
    {%- else %}
        {{- raise_exception('Only user and assistant roles are supported, with the exception of an initial optional system message!') }}
    {%- endif %}
{%- endfor %}
"""

DEEPSEEK = """{% if not add_generation_prompt is defined %}{% set add_generation_prompt = false %}{% endif %}{% set ns = namespace(is_first=false, is_tool=false, is_output_first=true, system_prompt='') %}{%- for message in messages %}{%- if message['role'] == 'system' %}{% set ns.system_prompt = message['content'] %}{%- endif %}{%- endfor %}{{bos_token}}{{ns.system_prompt}}{%- for message in messages %}{%- if message['role'] == 'user' %}{%- set ns.is_tool = false -%}{{'<｜User｜>' + message['content']}}{%- endif %}{%- if message['role'] == 'assistant' and message['content'] is none %}{%- set ns.is_tool = false -%}{{'<｜Assistant｜>'}}{%- endif %}{%- if message['role'] == 'assistant' and message['content'] is not none %}{%- if ns.is_tool %}{{'<｜tool▁outputs▁end｜>' + message['content'] + '<｜end▁of▁sentence｜>'}}{%- set ns.is_tool = false -%}{%- else %}{% set content = message['content'] %}{% if '</think>' in content %}{% set content = content.split('</think>')[-1] %}{% endif %}{{'<｜Assistant｜>' + content + '<｜end▁of▁sentence｜>'}}{%- endif %}{%- endif %}{%- if message['role'] == 'tool' %}{%- set ns.is_tool = true -%}{%- if ns.is_output_first %}{{'<｜tool▁outputs▁begin｜><｜tool▁output▁begin｜>' + message['content'] + '<｜tool▁output▁end｜>'}}{%- set ns.is_output_first = false %}{%- else %}{{'\\n<｜tool▁output▁begin｜>' + message['content'] + '<｜tool▁output▁end｜>'}}{%- endif %}{%- endif %}{%- endfor -%}{% if ns.is_tool %}{{'<｜tool▁outputs▁end｜>'}}{% endif %}{% if add_generation_prompt and not ns.is_tool %}{{'<｜Assistant｜><think>\\n'}}{% endif %}"""

# Every construct of the subset, one template each.
CONSTRUCTS = [
    "plain text\nsecond line\n",
    "a\r\nb\rc\n\n",
    "{# comment #}x{#- stripped -#}  y  {#+ kept +#}\nz",
    "  {% if true %}\n    yes\n  {% endif %}\nafter",
    "  {%+ if true %}\nkeep lstrip\n  {%- endif +%}\nkeep trim",
    "{{ 'a' }}  \n  {{- 'b' -}}  \n  {{ 'c' }}",
    "{% for m in messages %}{{ loop.index }}/{{ loop.index0 }}/{{ loop.revindex }}/{{ loop.revindex0 }}/{{ loop.first }}/{{ loop.last }}/{{ loop.length }} {{ m.role }}\n{% endfor %}",
    "{% for m in messages if m.role != 'system' %}{{ loop.index }}:{{ m['role'] }}{{ loop.cycle('a','b') }} {% else %}none{% endfor %}",
    "{% for m in [] %}x{% else %}empty{% endfor %}|{% for k, v in {'b': 1, 'a': 2}.items() %}{{ k }}={{ v }};{% endfor %}",
    "{% for i in range(3) %}{% if loop.previtem is defined %}{{ loop.previtem }}<{% endif %}{{ i }}{% if loop.nextitem is defined %}>{{ loop.nextitem }}{% endif %} {% endfor %}",
    "{% set x = 1 %}{% for i in [1, 2] %}{{ x }}{% set x = x + 10 %}{{ x }},{% endfor %}{{ x }}",
    "{% set ns = namespace(n=0, s='') %}{% for m in messages %}{% set ns.n = ns.n + 1 %}{% set ns.s = ns.s ~ m.role[0] %}{% endfor %}{{ ns.n }} {{ ns.s }} {{ ns['n'] }}",
    "{% macro tag(role, content='-') %}<{{ role }}>{{ content }}</{{ role }}>{% endmacro %}{% for m in messages %}{{ tag(m.role, m.content) }}{{ tag(role='x') }}{% endfor %}",
    "{% if messages|length > 2 %}many{% elif messages|length == 2 %}two{% else %}few{% endif %}",
    "{{ 1 + 2 * 3 - 4 / 2 }} {{ 7 // 2 }} {{ 7 % 3 }} {{ 2 ** 10 }} {{ -3 }} {{ +3 }} {{ 'a' ~ 1 ~ none }} {{ 1.5e3 }} {{ 1_000 }} {{ 0x1f }}",
    "{{ 1 < 2 < 3 }} {{ 3 > 2 > 5 }} {{ 'a' in 'cat' }} {{ 'z' not in ['a'] }} {{ not true or false and true }} {{ 1 == 1.0 }} {{ 2 != 2 }} {{ 2 >= 2 <= 3 }}",
    "{{ 'yes' if messages else 'no' }} [{{ 'x' if false }}] {{ 'a' if false else 'b' if true else 'c' }}",
    "{{ [1, 2, 3][1:] }} {{ 'abcdef'[::-1] }} {{ 'abcdef'[1:4:2] }} {{ messages[-1].role }} {{ {'a': [1, {'b': 'c'}]}['a'][1].b }} {{ (1, 2) }} {{ () }} {{ [] }} {{ {} }}",
    "{{ none }} {{ None }} {{ true }} {{ True }} {{ false }} {{ 'it''s' }} {{ \"tab\\tnew\\nline\\u00e9\" }} {{ 'é' }}",
    "[{{ undefined_name }}] [{% for x in undefined_name %}x{% endfor %}] {{ undefined_name is defined }} {{ undefined_name is undefined }} {{ undefined_name|default('d') }} {{ ''|default('e', true) }} {{ undefined_name|length }}",
    "{{ none is none }} {{ 'a' is string }} {{ 1 is number }} {{ true is number }} {{ {} is mapping }} {{ [] is iterable }} {{ 1 is iterable }} {{ 'ab' is sequence }} {{ 1 is sequence }} {{ true is boolean }} {{ 1 is boolean }} {{ true is true }} {{ 1 is true }} {{ false is false }} {{ 1 is eq 1 }} {{ 'a' is equalto 'a' }} {{ 2 is eq(3) }} {{ 1 is not none }}",
    "{{ '  pad  '|trim }}|{{ 'xxhixx'|trim('x') }}|{{ 'Hello'|upper }}|{{ 'Hello'|lower }}|{{ 'hello world'|capitalize }}|{{ 'hello-world (foo) [bar]'|title }}|{{ [1, 'a', none]|join(', ') }}|{{ messages|join('/', attribute='role') }}|{{ 12|string }}",
    "{{ '42'|int }} {{ '42.7'|int }} {{ 'x'|int }} {{ 'x'|int(7) }} {{ 'ff'|int(base=16) }} {{ '1.5'|float }} {{ 'y'|float }} {{ 3|float }}",
    "{{ messages|first }} {{ messages|last }} {{ []|first }} {{ 'abc'|list }} {{ 'aaa'|replace('a', 'b') }} {{ 'aaa'|replace('a', 'b', 2) }} {{ messages|length }} {{ messages|count }} {{ {'b': 1, 'a': 2}|items|list }}",
    "{{ messages|selectattr('role', 'equalto', 'user')|list|length }} {{ messages|rejectattr('role', 'eq', 'user')|map(attribute='role')|join(',') }} {{ messages|selectattr('content')|list|length }} {{ messages|map(attribute='missing', default='d')|list }} {{ ['a ', ' b']|map('trim')|list }}",
    "{{ tools|tojson }} {{ tools|tojson(indent=2) }} {{ '<&\\'>'|tojson }} {{ {'b': [1, 2], 'a': none}|tojson }}",
    "{{ '<x>' + 'y'|tojson }} {{ ('a'|tojson) + '<b>' }} {{ ('a'|tojson) ~ '<b>' }} {{ ('\"a\"'|tojson).replace('\"', '<') }}",
    "{{ ('<a>'|tojson)|replace('a', '<') }} {{ [('<'|tojson), 'b']|join(('&'|tojson)) }} {{ ('a'|tojson)|trim + '<' }} {{ ('a'|tojson)|upper + '<' }} {{ ('a'|tojson).split('a')[0] + '<' }} {{ ('a'|tojson)[0] + '<' }} {{ [1]|tojson * 2 + '<' }} {{ 2 * ([1]|tojson) + '<' }}",
    "{{ ' a b '.strip() }}|{{ 'xab'.lstrip('x') }}|{{ 'abx'.rstrip('x') }}|{{ 'a,b,c'.split(',') }}|{{ 'a b'.split() }}|{{ 'abc'.startswith('a') }}|{{ 'abc'.endswith('c') }}|{{ 'AbC'.lower() }}|{{ 'abc'.upper() }}|{{ 'aXa'.replace('X', 'y') }}|{{ 'hello world'.title() }}",
    "{% set d = {'k': 'v', 'n': none} %}{{ d.get('k') }} {{ d.get('z', 'dflt') }} {{ d.get('z') }} {{ d.items()|list }} {{ d.keys()|list }} {{ d.values()|list }} {{ d.k }} {{ d['n'] }} {{ d.missing }}",
    "{% for m in messages %}{% if m.content is none %}[none]{% elif not m.content %}[empty]{% else %}{{ m.content }}{% endif %}{% endfor %}",
    "{{ bos_token }}{% for m in messages %}{{ m.role }}:{{ m.content }}{{ eos_token }}{% endfor %}{% if add_generation_prompt %}assistant:{% endif %}",
    "{{ dict(a=1)|tojson }} {{ range(2, 8, 3)|list }} {{ namespace(a=1).a }}",
    "{%- for m in messages -%}\n  {{- m.role -}}\n\n{%- endfor -%}\n\n",
    "{{ 'a' 'b' }} {{ [1,2,][0] }} {{ {'a': 1,}.a }} {{ (1) }} {{ ('x',) }}",
    "{% if messages[0]['role'] == 'system' %}{{ raise_exception('system messages are refused: ' ~ messages[0].content) }}{% endif %}ok",
    "{{ [1, 0, 2, none, '']|select|list }} {{ [1, 2, 3]|reject('eq', 2)|list }} {{ messages|map(attribute='role')|select('equalto', 'user')|list|length }} {{ none|select|list }} {{ none|selectattr('x')|list }} {{ messages|map(attribute='content')|reject('none')|list|length }}",
]

# Templates whose rendering raises in Jinja2: the error class must match.
RAISES = [
    "{{ undefined_name.attr }}",
    "{{ undefined_name + 1 }}",
    "{{ undefined_name() }}",
    "{{ undefined_name[0] }}",
    "{% set x = 1 %}{% set x.y = 2 %}",
    "{{ none|length }}",
    "{% for x in none %}{% endfor %}",
    "{{ raise_exception('boom') }}",
    "{{ 1 + 'a' }}",
    "{{ undefined_name|tojson }}",
    "{{ undefined_name < 1 }}",
    "{{ -undefined_name }}",
    "{{ undefined_name|int }}",
]
# Templates Jinja2 refuses to compile.
SYNTAX = [
    "{% if true %}unclosed",
    "{% endif %}",
    "{% break %}",
    "{{ }}",
    "{{ 1 + }}",
    "{% for %}{% endfor %}",
    "{% foo %}",
    "{# unclosed",
    "{{ x is defined is defined }}",
]
# Jinja2 constructs outside the subset: the port refuses them at compile.
UNSUPPORTED = {  # source: the word its error names
    "{% raw %}{{ x }}{% endraw %}": "raw",
    "{% filter upper %}x{% endfilter %}": "filter",
    "{% call foo() %}x{% endcall %}": "call",
    "{{ 'x'|center(9) }}": "center",
    "{{ 3 is odd }}": "odd",
    "{{ [1, 2]|select('odd')|list }}": "odd",
    "{{ messages|rejectattr('role', 'sameas', 'x')|list }}": "sameas",
    "{{ ['a']|map('center', 9)|list }}": "center",
    "{{ 'abc'.count('a') }}": "count",
    "{{ cycler(1, 2) }}": "cycler",
    "{% for x in [1] %}{{ loop.changed(x) }}{% endfor %}": "changed",
    "{% set a, b = 1, 2 %}": "tuple target",
    "{% set x %}block{% endset %}": "block",
    "{% macro m() %}{{ varargs }}{% endmacro %}": "varargs",
    "{% for x in [1] recursive %}{% endfor %}": "recursive",
    "{% include 'x' %}": "include",
}


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather <now> & 'then'",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]
CONVERSATIONS = [
    [{"role": "user", "content": "hello"}],
    [{"role": "system", "content": "  be brief  "}, {"role": "user", "content": "hi"},
     {"role": "assistant", "content": "yo</think>ok"}, {"role": "user", "content": "é 中文 😀"}],
    [{"role": "user", "content": "weather?"},
     {"role": "assistant", "content": None,
      "tool_calls": [{"function": {"name": "get_weather", "arguments": {"city": "Paris"}}}]},
     {"role": "tool", "content": "sunny"}, {"role": "tool", "content": ""}],
    [{"role": "user", "content": ""}, {"role": "assistant", "content": None}],
]
MODELLED = {"llama-3.1": LLAMA31, "qwen2": QWEN2, "mistral": MISTRAL, "deepseek-r1": DEEPSEEK}
TEMPLATES = {**MODELLED, **{f"construct-{i}": t for i, t in enumerate(CONSTRUCTS)},
             **{f"raises-{i}": t for i, t in enumerate(RAISES)},
             **{f"syntax-{i}": t for i, t in enumerate(SYNTAX)}}


def _tokenizer(pkg, template):
    """``pkg``'s ByteTokenizer carrying ``template`` as its chat template."""
    base = importlib.import_module(f"{pkg}.llm.tokenizer").ByteTokenizer

    class Templated(base):
        chat_template = template

    tok = Templated()
    tok.bos_token, tok.eos_token = "<s>", "</s>"
    return tok


def _outcome(tok, messages, agp, tools, **kwargs):
    try:
        return "ok", tok.apply_chat_template(messages, add_generation_prompt=agp, tools=tools,
                                             **kwargs)
    except Exception as exc:  # noqa: BLE001 — the class is what is compared
        name = type(exc).__name__
        return "raised", "TemplateSyntaxError" if name == "TemplateAssertionError" else name


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_template_renders_like_jinja2(name):
    """One template over every conversation, with and without tools and a
    generation prompt: the same text, or the same error class."""
    toks = {pkg: _tokenizer(pkg, TEMPLATES[name]) for pkg in (JAX, PORT)}
    outcomes = []
    for messages in CONVERSATIONS:
        for agp in (True, False):
            for tools in (None, TOOLS):
                want = _outcome(toks[JAX], messages, agp, tools)
                assert _outcome(toks[PORT], messages, agp, tools) == want, (messages, agp, tools)
                outcomes.append(want[0])
    if name.startswith("raises") or name.startswith("syntax"):
        assert "raised" in outcomes
    if name in MODELLED:
        assert outcomes.count("ok") >= 8


BUILTIN_TOOLS = ["code_interpreter", "brave_search", "wolfram_alpha"]
BUILTIN_CALL = [
    {"role": "system", "content": "search when asked"}, {"role": "user", "content": "weather?"},
    {"role": "assistant", "content": None, "tool_calls": [{"function": {
        "name": "brave_search", "arguments": {"query": "Paris <today>", "count": "3"}}}]},
    {"role": "ipython", "content": {"result": "sunny & 20°"}}]


@pytest.mark.parametrize("builtin_tools", [None, BUILTIN_TOOLS], ids=["plain", "builtin_tools"])
def test_published_llama31_template_renders_like_jinja2(builtin_tools):
    """The whole published Llama-3.1 template, with ``builtin_tools`` (its
    ``reject('equalto', …)`` filter, the ``<|python_tag|>`` call written
    from ``arguments | items`` and ``<|eom_id|>``) and without, tools in
    the user message or the system message."""
    kwargs = {} if builtin_tools is None else {"builtin_tools": builtin_tools}
    toks = {pkg: _tokenizer(pkg, LLAMA31) for pkg in (JAX, PORT)}
    outcomes = []
    for messages in [*CONVERSATIONS, BUILTIN_CALL]:
        for agp in (True, False):
            for tools in (None, TOOLS):
                for in_user in (True, False):
                    extra = {**kwargs, "tools_in_user_message": in_user}
                    want = _outcome(toks[JAX], messages, agp, tools, **extra)
                    assert _outcome(toks[PORT], messages, agp, tools, **extra) == want, (
                        messages, agp, tools, in_user)
                    outcomes.append(want)
    texts = [text for kind, text in outcomes if kind == "ok"]
    assert len(texts) >= 20
    if builtin_tools is not None:
        assert any("Tools: brave_search, wolfram_alpha\n\n" in t for t in texts)
        assert any('<|python_tag|>brave_search.call(query="Paris <today>", count="3")<|eom_id|>'
                   in t for t in texts)


@pytest.mark.parametrize("source", list(UNSUPPORTED))
def test_unsupported_construct_is_refused_when_compiling(source):
    """Jinja2 has these; the subset refuses them at compile time with a
    TemplateSupportError (a ValueError) whose message names the construct
    — it never renders them differently."""
    with pytest.raises(ct.TemplateSupportError, match=UNSUPPORTED[source]) as info:
        ct.compile_template(source)
    assert isinstance(info.value, ValueError)


def test_templates_compile_once_per_text():
    ct.compile_template.cache_clear()
    for _ in range(3):
        for messages in CONVERSATIONS:
            ct.render_chat_template(LLAMA31, messages, True, "<s>", "</s>", tools=None)
    info = ct.compile_template.cache_info()
    assert (info.misses, info.hits) == (1, 3 * len(CONVERSATIONS) - 1)
