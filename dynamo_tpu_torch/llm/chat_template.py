"""Chat templates: the subset of Jinja2 that models' chat templates use,
in plain Python.

The JAX package renders ``tokenizer_config.json``'s ``chat_template`` with
``jinja2.Environment(trim_blocks=True, lstrip_blocks=True)``, a global
``raise_exception`` that raises ``ValueError``, and the context
``messages``, ``add_generation_prompt``, ``bos_token``, ``eos_token`` and
the caller's keyword arguments (``tools``).  The card's machine has no
jinja2, so this module lexes, parses and evaluates that subset with
Jinja2's own rules:

- ``{{ }}``, ``{% %}`` and ``{# #}`` with ``-``/``+`` whitespace control,
  ``trim_blocks`` (the newline after a block or comment tag goes),
  ``lstrip_blocks`` (spaces and tabs before a block or comment tag at the
  start of a line go), line endings read as ``\\n`` and one trailing
  newline of the source dropped;
- ``if``/``elif``/``else``, ``for … in … [if …]`` with ``else`` and
  ``loop``, ``set`` (``set ns.x =`` on ``namespace(...)``) and ``macro``;
- literals, lists, dicts, tuples, attribute access that falls back to
  item lookup (and the reverse), subscripts and slices, ``~ + - * / // %
  **``, comparisons, ``in``/``not in``, ``and``/``or``/``not``, ``x if c
  else y``;
- the tests and filters in ``TESTS`` and ``FILTERS``, the str and dict
  methods in ``METHODS``, the globals ``namespace``, ``raise_exception``,
  ``range`` and ``dict``;
- Jinja2's default ``Undefined``: it prints empty and iterates empty, and
  an attribute of it, a call or arithmetic on it raises
  ``UndefinedError``; ``None`` prints as ``None``; ``tojson`` sorts keys
  and escapes ``<``, ``>``, ``&`` and ``'``.

Anything else (another tag, filter, test, method, global or loop
attribute) raises ``TemplateSupportError`` naming it when the template
compiles, never a different rendering.  Templates compile once per text.
"""

from __future__ import annotations

import functools
import json
import re
from collections import abc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class TemplateError(Exception):
    pass


class TemplateSyntaxError(TemplateError):
    """What Jinja2 refuses too: bad syntax, an unknown tag."""


class TemplateRuntimeError(TemplateError):
    pass


class UndefinedError(TemplateRuntimeError):
    pass


class TemplateSupportError(TemplateError, ValueError):
    """A construct Jinja2 has and this subset does not."""


# ------------------------------------------------------------------ runtime

class Undefined:
    """Jinja2's default ``Undefined``."""

    __slots__ = ("_hint", "_obj", "_name")

    def __init__(self, hint: Optional[str] = None, obj: Any = None, name: Any = None):
        self._hint, self._obj, self._name = hint, obj, name

    def _message(self) -> str:
        if self._hint:
            return self._hint
        if self._obj is None:
            return f"{self._name!r} is undefined"
        return f"{_object_type_repr(self._obj)!r} has no attribute {self._name!r}"

    def _fail(self, *args: Any, **kwargs: Any) -> Any:
        raise UndefinedError(self._message())

    def __getattr__(self, name: str) -> Any:
        if name[:2] == "__":
            raise AttributeError(name)
        return self._fail()

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __floordiv__ = __rfloordiv__ = _fail
    __mod__ = __rmod__ = __pos__ = __neg__ = __call__ = __getitem__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __int__ = __float__ = __complex__ = _fail
    __pow__ = __rpow__ = _fail

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other)

    def __ne__(self, other: Any) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))

    def __str__(self) -> str:
        return ""

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return "Undefined"


def _object_type_repr(obj: Any) -> str:
    if obj is None:
        return "None"
    if obj is Ellipsis:
        return "Ellipsis"
    cls = type(obj)
    if cls.__module__ == "builtins":
        return f"{cls.__name__} object"
    return f"{cls.__module__}.{cls.__name__} object"


class Namespace:
    """``namespace(...)``: attributes a ``set ns.x =`` may assign."""

    def __init__(self, *args: Any, **kwargs: Any):
        object.__setattr__(self, "_attrs", dict(*args, **kwargs))

    def get(self, name: str) -> Any:
        return self._attrs[name]

    def __repr__(self) -> str:
        return f"<Namespace {self._attrs!r}>"


def _escape(value: Any) -> "_Markup":
    if isinstance(value, _Markup):
        return value
    return _Markup(str(value).replace("&", "&amp;").replace(">", "&gt;").replace("<", "&lt;")
                   .replace("'", "&#39;").replace('"', "&#34;"))


class _Markup(str):
    """``tojson``'s result: markupsafe's ``Markup``, so ``+`` escapes the
    other operand, ``replace`` its replacement, and the str methods keep
    the type, as in the JAX package's rendering."""

    def __add__(self, other: Any) -> Any:
        if isinstance(other, str):
            return _Markup(str.__add__(self, _escape(other)))
        return NotImplemented

    def __radd__(self, other: Any) -> Any:
        if isinstance(other, str):
            return _Markup(str.__add__(_escape(other), self))
        return NotImplemented

    def __mul__(self, n: Any) -> "_Markup":
        return _Markup(str.__mul__(self, n))

    __rmul__ = __mul__

    def __mod__(self, other: Any) -> Any:
        raise TemplateSupportError("unsupported '%' on a tojson result")

    def _wrap(name: str):  # type: ignore[misc]
        def method(self: "_Markup", *args: Any) -> "_Markup":
            return _Markup(getattr(str, name)(self, *args))
        return method

    strip = _wrap("strip")
    lstrip = _wrap("lstrip")
    rstrip = _wrap("rstrip")
    lower = _wrap("lower")
    upper = _wrap("upper")
    title = _wrap("title")
    capitalize = _wrap("capitalize")
    del _wrap

    def replace(self, old: str, new: str, count: int = -1) -> "_Markup":
        return _Markup(str.replace(self, old, _escape(new), count))

    def split(self, sep: Any = None, maxsplit: int = -1) -> List["_Markup"]:
        return [_Markup(v) for v in str.split(self, sep, maxsplit)]

    def __getitem__(self, key: Any) -> "_Markup":
        return _Markup(str.__getitem__(self, key))


def _raise_exception(message: Any) -> None:
    raise ValueError(message)


# The str and dict methods a template may call.
METHODS = {
    str: {"strip", "lstrip", "rstrip", "split", "startswith", "endswith", "lower", "upper",
          "replace", "title"},
    dict: {"get", "items", "keys", "values"},
}
_METHOD_NAMES = set().union(*METHODS.values())


def _method(obj: Any, name: str) -> Tuple[bool, Any]:
    """A builtin's attribute: one of ``METHODS``, else refused; (False,
    None) when the object has no such attribute."""
    for kind, names in METHODS.items():
        if isinstance(obj, kind) and name in names:
            return True, getattr(obj, name)
    if hasattr(obj, name):
        raise TemplateSupportError(f"unsupported attribute {name!r} of a {type(obj).__name__}")
    return False, None


def _getattr(obj: Any, name: str) -> Any:
    """``Environment.getattr``: the attribute, else the item, else
    Undefined."""
    if isinstance(obj, Undefined):
        return obj._fail()
    if isinstance(obj, Namespace):
        try:
            return obj.get(name)
        except KeyError:
            return Undefined(obj=obj, name=name)
    if isinstance(obj, (_Loop, _Macro)):
        return obj.attr(name)
    found, value = _method(obj, name)
    if found:
        return value
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined(obj=obj, name=name)


def _getitem(obj: Any, key: Any) -> Any:
    """``Environment.getitem``: the item, else (for a str key) the
    attribute, else Undefined."""
    if isinstance(obj, Undefined):
        return obj._fail()
    if isinstance(obj, (Namespace, _Loop, _Macro)):
        return _getattr(obj, key) if isinstance(key, str) else Undefined(obj=obj, name=key)
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            found, value = _method(obj, key)
            if found:
                return value
        return Undefined(obj=obj, name=key)


def _to_str(value: Any) -> str:
    return value if isinstance(value, str) else str(value)


class _Loop:
    """The ``loop`` of a ``for`` body."""

    ATTRS = {"index", "index0", "revindex", "revindex0", "first", "last", "length", "previtem",
             "nextitem", "depth", "depth0", "cycle"}

    def __init__(self, items: List[Any]):
        self.items = items
        self.i = 0

    def attr(self, name: str) -> Any:
        i, n = self.i, len(self.items)
        if name == "index":
            return i + 1
        if name == "index0":
            return i
        if name == "revindex":
            return n - i
        if name == "revindex0":
            return n - i - 1
        if name == "first":
            return i == 0
        if name == "last":
            return i == n - 1
        if name == "length":
            return n
        if name == "previtem":
            return self.items[i - 1] if i > 0 else Undefined("there is no previous item")
        if name == "nextitem":
            return self.items[i + 1] if i + 1 < n else Undefined("there is no next item")
        if name == "depth":
            return 1
        if name == "depth0":
            return 0
        if name == "cycle":
            def cycle(*args: Any) -> Any:
                if not args:
                    raise TypeError("no items for cycling given")
                return args[i % len(args)]
            return cycle
        return Undefined(obj=self, name=name)


class _Macro:
    def __init__(self, node: "MacroNode", frame: "Frame"):
        self.node, self.frame = node, frame

    def attr(self, name: str) -> Any:
        if name == "name":
            return self.node.name
        return Undefined(obj=self, name=name)

    def __call__(self, *args: Any, **kwargs: Any) -> str:
        node = self.node
        if len(args) > len(node.params):
            raise TypeError(f"macro {node.name!r} takes not more than {len(node.params)} argument(s)")
        frame = Frame(self.frame)
        for i, (pname, default) in enumerate(node.params):
            if i < len(args):
                value = args[i]
                if pname in kwargs:
                    raise TypeError(f"macro {node.name!r} got multiple values for argument {pname!r}")
            elif pname in kwargs:
                value = kwargs.pop(pname)
            elif default is not None:
                value = default.ev(frame)
            else:
                value = Undefined(f"parameter {pname!r} was not provided")
            frame.vars[pname] = value
        if kwargs:
            raise TypeError(f"macro {node.name!r} takes no keyword argument {next(iter(kwargs))!r}")
        out: List[str] = []
        _render_body(node.body, frame, out)
        return "".join(out)

    def __repr__(self) -> str:
        return f"<Macro {self.node.name!r}>"


class Frame:
    __slots__ = ("vars", "parent", "root")

    def __init__(self, parent: Optional["Frame"] = None, root: Optional[Dict[str, Any]] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent
        self.root = root if root is not None else parent.root  # type: ignore[union-attr]

    def lookup(self, name: str) -> Any:
        f: Optional[Frame] = self
        while f is not None:
            if name in f.vars:
                return f.vars[name]
            f = f.parent
        if name in self.root:
            return self.root[name]
        if name in GLOBALS:
            return GLOBALS[name]
        return Undefined(name=name)


GLOBALS: Dict[str, Any] = {
    "namespace": Namespace,
    "raise_exception": _raise_exception,
    "range": range,
    "dict": dict,
}
# Jinja2 globals this subset does not have.
_UNSUPPORTED_GLOBALS = {"lipsum", "cycler", "joiner"}


# ------------------------------------------------------------ filters, tests

def _f_tojson(value: Any, indent: Optional[int] = None) -> str:
    text = json.dumps(value, indent=indent, sort_keys=True)
    return _Markup(text.replace("<", "\\u003c").replace(">", "\\u003e")
                   .replace("&", "\\u0026").replace("'", "\\u0027"))


def _f_length(value: Any) -> int:
    return len(value)


def _f_int(value: Any, default: int = 0, base: int = 10) -> int:
    try:
        if isinstance(value, str):
            return int(value, base)
        return int(value)
    except (TypeError, ValueError):
        try:
            return int(float(value))
        except (TypeError, ValueError):
            return default


def _f_float(value: Any, default: float = 0.0) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def _f_default(value: Any, default_value: Any = "", boolean: bool = False) -> Any:
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


def _f_first(seq: Any) -> Any:
    for item in seq:
        return item
    return Undefined("No first item, sequence was empty.")


def _f_last(seq: Any) -> Any:
    for item in reversed(seq):
        return item
    return Undefined("No last item, sequence was empty.")


_WORD_BEGIN = re.compile(r"([-\s({\[<]+)")


def _f_title(s: Any) -> str:
    return "".join(item[0].upper() + item[1:].lower()
                   for item in _WORD_BEGIN.split(_to_str(s)) if item)


def _f_join(value: Any, d: str = "", attribute: Any = None) -> str:
    if attribute is not None:
        value = map(_attrgetter(attribute), value)
    return str(d).join(map(str, value))


def _f_replace(s: Any, old: Any, new: Any, count: Optional[int] = None) -> str:
    return str(s).replace(str(old), str(new), -1 if count is None else count)


def _f_items(value: Any):
    if isinstance(value, Undefined):
        return
    if not isinstance(value, abc.Mapping):
        raise TypeError("Can only get item pairs from a mapping.")
    yield from value.items()


def _attrgetter(attribute: Any, default: Any = None) -> Callable[[Any], Any]:
    parts = ([int(p) if p.isdigit() else p for p in attribute.split(".")]
             if isinstance(attribute, str) else [attribute])

    def get(item: Any) -> Any:
        for part in parts:
            item = _getitem(item, part)
        if default is not None and isinstance(item, Undefined):
            item = default
        return item

    return get


def _select(value: Any, args: Tuple[Any, ...], kwargs: Dict[str, Any], keep: bool,
            attr: bool):
    """Jinja2's select/reject (``attr`` false) and selectattr/rejectattr:
    an optional attribute, then an optional test name and its arguments;
    with no test, the item's truth. A false ``value`` selects nothing."""
    if not value:
        return
    if attr:
        if not args:
            raise TemplateRuntimeError("Missing parameter for attribute name")
        get, args = _attrgetter(args[0]), args[1:]
    else:
        get = lambda item: item  # noqa: E731
    if args:
        test, rest = _test(args[0]), args[1:]
        check = lambda item: test(get(item), *rest, **kwargs)  # noqa: E731
    else:
        check = lambda item: bool(get(item))  # noqa: E731
    yield from (item for item in value if check(item) == keep)


def _f_select(value: Any, *args: Any, **kwargs: Any) -> Any:
    return _select(value, args, kwargs, True, False)


def _f_reject(value: Any, *args: Any, **kwargs: Any) -> Any:
    return _select(value, args, kwargs, False, False)


def _f_selectattr(value: Any, *args: Any, **kwargs: Any) -> Any:
    return _select(value, args, kwargs, True, True)


def _f_rejectattr(value: Any, *args: Any, **kwargs: Any) -> Any:
    return _select(value, args, kwargs, False, True)


def _f_map(value: Any, *args: Any, **kwargs: Any) -> Any:
    if "attribute" in kwargs:
        get = _attrgetter(kwargs.pop("attribute"), kwargs.pop("default", None))
        if args or kwargs:
            raise TemplateRuntimeError("map with attribute= takes no other argument")
        return (get(item) for item in value)
    if not args:
        return iter(())
    name, rest = args[0], args[1:]
    if name not in FILTERS:
        raise TemplateSupportError(f"unsupported filter {name!r} in map()")
    f = FILTERS[name]
    return (f(item, *rest, **kwargs) for item in value)


FILTERS: Dict[str, Callable[..., Any]] = {
    "trim": lambda s, chars=None: _to_str(s).strip(chars),
    "tojson": _f_tojson,
    "length": _f_length,
    "count": _f_length,
    "upper": lambda s: _to_str(s).upper(),
    "lower": lambda s: _to_str(s).lower(),
    "capitalize": lambda s: _to_str(s).capitalize(),
    "title": _f_title,
    "join": _f_join,
    "string": _to_str,
    "int": _f_int,
    "float": _f_float,
    "default": _f_default,
    "d": _f_default,
    "first": _f_first,
    "last": _f_last,
    "list": list,
    "replace": _f_replace,
    "items": _f_items,
    "select": _f_select,
    "reject": _f_reject,
    "selectattr": _f_selectattr,
    "rejectattr": _f_rejectattr,
    "map": _f_map,
}


def _t_sequence(value: Any) -> bool:
    try:
        len(value)
        value.__getitem__  # noqa: B018
    except Exception:
        return False
    return True


def _t_iterable(value: Any) -> bool:
    try:
        iter(value)
    except TypeError:
        return False
    return True


TESTS: Dict[str, Callable[..., bool]] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "number": lambda v: isinstance(v, (int, float, complex)),
    "mapping": lambda v: isinstance(v, abc.Mapping),
    "iterable": _t_iterable,
    "sequence": _t_sequence,
    "boolean": lambda v: v is True or v is False,
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "eq": lambda v, other: v == other,
    "equalto": lambda v, other: v == other,
    "==": lambda v, other: v == other,
}


def _test(name: str) -> Callable[..., bool]:
    if name not in TESTS:
        raise TemplateSupportError(f"unsupported test {name!r}")
    return TESTS[name]


# -------------------------------------------------------------------- lexer

_NEWLINE = re.compile(r"\r\n|\r|\n")
_OPEN = re.compile(r"\{([{%#])([-+]?)")
_BLOCK_END = re.compile(r"\+%\}|-%\}\s*|%\}\n?")
_VAR_END = re.compile(r"-\}\}\s*|\}\}")
_COMMENT_END = re.compile(r"\+#\}|-#\}\s*|#\}\n?")
_WS = re.compile(r"\s+")
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+|\.(\d+_)*\d+)", re.I)
_INT = re.compile(r"(0b(_?[0-1])+|0o(_?[0-7])+|0x(_?[\da-f])+|[1-9](_?\d)*|0(_?0)*)", re.I)
_NAME = re.compile(r"[^\W\d]\w*")
_STRING = re.compile(r"'([^'\\]*(?:\\.[^'\\]*)*)'|\"([^\"\\]*(?:\\.[^\"\\]*)*)\"", re.S)
_OPERATORS = sorted(["+", "-", "/", "//", "*", "%", "**", "~", "[", "]", "(", ")", "{", "}", "==",
                     "!=", ">", ">=", "<", "<=", "=", ".", ":", "|", ",", ";"], key=len, reverse=True)
_OPERATOR = re.compile("|".join(map(re.escape, _OPERATORS)))
_LSTRIP_UNLESS = re.compile(r"[^ \t]")

Token = Tuple[str, Any]  # (type, value): name, int, float, str, op, end


def _lex(source: str) -> List[Tuple[str, Any]]:
    """The source as ("data", text) and ("block"/"var", tokens) items."""
    lines = _NEWLINE.split(source)
    if lines[-1] == "":
        del lines[-1]
    source = "\n".join(lines)
    out: List[Tuple[str, Any]] = []
    pos, n = 0, len(source)
    line_starting = True
    while pos < n:
        m = _OPEN.search(source, pos)
        if m is None:
            out.append(("data", source[pos:]))
            break
        text = source[pos:m.start()]
        kind, sign = m.group(1), m.group(2)
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and kind in "%#":
            l_pos = text.rfind("\n") + 1
            if (l_pos > 0 or line_starting) and not _LSTRIP_UNLESS.search(text, l_pos):
                text = text[:l_pos]
        if text:
            out.append(("data", text))
        pos = m.end()
        if kind == "#":
            e = _COMMENT_END.search(source, pos)
            if e is None:
                raise TemplateSyntaxError("Missing end of comment tag")
            pos = e.end()
            line_starting = e.group().endswith("\n")
            continue
        end_re = _BLOCK_END if kind == "%" else _VAR_END
        toks: List[Token] = []
        depth = 0
        while True:
            w = _WS.match(source, pos)
            if w:
                pos = w.end()
            if pos >= n:
                raise TemplateSyntaxError(f"unexpected end of template, expected the end of a "
                                          f"{'block' if kind == '%' else 'variable'} tag")
            if depth == 0:
                e = end_re.match(source, pos)
                if e:
                    pos = e.end()
                    line_starting = e.group().endswith("\n")
                    break
            for kind_name, rx in (("float", _FLOAT), ("int", _INT), ("name", _NAME),
                                  ("str", _STRING), ("op", _OPERATOR)):
                t = rx.match(source, pos)
                if t:
                    break
            else:
                raise TemplateSyntaxError(f"unexpected char {source[pos]!r} in a tag")
            value: Any = t.group()
            if kind_name == "float":
                value = float(value.replace("_", ""))
            elif kind_name == "int":
                v = value.replace("_", "")
                value = int(v, 0) if v[:2].lower() in ("0b", "0o", "0x") else int(v)
            elif kind_name == "str":
                inner = value[1:-1]
                value = inner.encode("ascii", "backslashreplace").decode("unicode-escape")
            elif kind_name == "op":
                if value in "([{":
                    depth += 1
                elif value in ")]}":
                    depth = max(0, depth - 1)
            toks.append((kind_name, value))
            pos = t.end()
        out.append(("block" if kind == "%" else "var", toks))
    return out


# -------------------------------------------------------------------- nodes

class Node:
    __slots__ = ()

    def ev(self, f: Frame) -> Any:
        raise NotImplementedError

    def children(self) -> Sequence["Node"]:
        return ()


class Const(Node):
    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def ev(self, f: Frame) -> Any:
        return self.value


class Name(Node):
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def ev(self, f: Frame) -> Any:
        return f.lookup(self.name)


class ListLit(Node):
    __slots__ = ("items", "tuple")

    def __init__(self, items: List[Node], as_tuple: bool = False):
        self.items, self.tuple = items, as_tuple

    def ev(self, f: Frame) -> Any:
        vals = [i.ev(f) for i in self.items]
        return tuple(vals) if self.tuple else vals

    def children(self) -> Sequence[Node]:
        return self.items


class DictLit(Node):
    __slots__ = ("pairs",)

    def __init__(self, pairs: List[Tuple[Node, Node]]):
        self.pairs = pairs

    def ev(self, f: Frame) -> Any:
        return {k.ev(f): v.ev(f) for k, v in self.pairs}

    def children(self) -> Sequence[Node]:
        return [n for p in self.pairs for n in p]


class Getattr(Node):
    __slots__ = ("obj", "name")

    def __init__(self, obj: Node, name: str):
        self.obj, self.name = obj, name

    def ev(self, f: Frame) -> Any:
        return _getattr(self.obj.ev(f), self.name)

    def children(self) -> Sequence[Node]:
        return (self.obj,)


class Getitem(Node):
    __slots__ = ("obj", "key")

    def __init__(self, obj: Node, key: Node):
        self.obj, self.key = obj, key

    def ev(self, f: Frame) -> Any:
        return _getitem(self.obj.ev(f), self.key.ev(f))

    def children(self) -> Sequence[Node]:
        return (self.obj, self.key)


class Slice(Node):
    __slots__ = ("start", "stop", "step")

    def __init__(self, start: Optional[Node], stop: Optional[Node], step: Optional[Node]):
        self.start, self.stop, self.step = start, stop, step

    def ev(self, f: Frame) -> Any:
        return slice(*(None if n is None else n.ev(f) for n in (self.start, self.stop, self.step)))

    def children(self) -> Sequence[Node]:
        return [n for n in (self.start, self.stop, self.step) if n is not None]


def _concat(a: Any, b: Any) -> str:
    return "".join((str(a), str(b)))  # plain strings: no Markup escaping


_BINARY: Dict[str, Callable[[Any, Any], Any]] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
    "/": lambda a, b: a / b, "//": lambda a, b: a // b, "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b, "~": _concat,
}
_COMPARE: Dict[str, Callable[[Any, Any], Any]] = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b, "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b, ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "in": lambda a, b: a in b, "notin": lambda a, b: a not in b,
}


class Binary(Node):
    __slots__ = ("op", "left", "right", "fn")

    def __init__(self, op: str, left: Node, right: Node):
        self.op, self.left, self.right, self.fn = op, left, right, _BINARY[op]

    def ev(self, f: Frame) -> Any:
        return self.fn(self.left.ev(f), self.right.ev(f))

    def children(self) -> Sequence[Node]:
        return (self.left, self.right)


class Unary(Node):
    __slots__ = ("op", "operand")

    def __init__(self, op: str, operand: Node):
        self.op, self.operand = op, operand

    def ev(self, f: Frame) -> Any:
        v = self.operand.ev(f)
        if self.op == "not":
            return not v
        return -v if self.op == "-" else +v

    def children(self) -> Sequence[Node]:
        return (self.operand,)


class And(Node):
    __slots__ = ("left", "right")

    def __init__(self, left: Node, right: Node):
        self.left, self.right = left, right

    def ev(self, f: Frame) -> Any:
        return self.left.ev(f) and self.right.ev(f)

    def children(self) -> Sequence[Node]:
        return (self.left, self.right)


class Or(And):
    __slots__ = ()

    def ev(self, f: Frame) -> Any:
        return self.left.ev(f) or self.right.ev(f)


class Compare(Node):
    __slots__ = ("first", "ops")

    def __init__(self, first: Node, ops: List[Tuple[str, Node]]):
        self.first, self.ops = first, ops

    def ev(self, f: Frame) -> Any:
        left = self.first.ev(f)
        for op, node in self.ops:
            right = node.ev(f)
            if not _COMPARE[op](left, right):
                return False
            left = right
        return True

    def children(self) -> Sequence[Node]:
        return [self.first] + [n for _, n in self.ops]


class CondExpr(Node):
    __slots__ = ("test", "then", "other")

    def __init__(self, test: Node, then: Node, other: Optional[Node]):
        self.test, self.then, self.other = test, then, other

    def ev(self, f: Frame) -> Any:
        if self.test.ev(f):
            return self.then.ev(f)
        if self.other is None:
            return Undefined("the inline if-expression evaluated to false and no else section "
                             "was defined.")
        return self.other.ev(f)

    def children(self) -> Sequence[Node]:
        return [n for n in (self.test, self.then, self.other) if n is not None]


class Call(Node):
    __slots__ = ("fn", "args", "kwargs")

    def __init__(self, fn: Node, args: List[Node], kwargs: List[Tuple[str, Node]]):
        self.fn, self.args, self.kwargs = fn, args, kwargs

    def ev(self, f: Frame) -> Any:
        fn = self.fn.ev(f)
        return fn(*(a.ev(f) for a in self.args), **{k: v.ev(f) for k, v in self.kwargs})

    def children(self) -> Sequence[Node]:
        return [self.fn, *self.args, *(v for _, v in self.kwargs)]


class Filter(Node):
    __slots__ = ("node", "name", "fn", "args", "kwargs")

    def __init__(self, node: Node, name: str, args: List[Node], kwargs: List[Tuple[str, Node]]):
        if name not in FILTERS:
            raise TemplateSupportError(f"unsupported filter {name!r}")
        # A test or filter named by a constant argument is checked here too.
        at = {"select": 0, "reject": 0, "selectattr": 1, "rejectattr": 1, "map": 0}.get(name)
        if at is not None and len(args) > at and isinstance(args[at], Const):
            if name != "map":
                _test(args[at].value)
            elif args[at].value not in FILTERS:
                raise TemplateSupportError(f"unsupported filter {args[at].value!r} in map()")
        self.node, self.name, self.fn, self.args, self.kwargs = node, name, FILTERS[name], args, kwargs

    def ev(self, f: Frame) -> Any:
        return self.fn(self.node.ev(f), *(a.ev(f) for a in self.args),
                       **{k: v.ev(f) for k, v in self.kwargs})

    def children(self) -> Sequence[Node]:
        return [self.node, *self.args, *(v for _, v in self.kwargs)]


class Test(Node):
    __slots__ = ("node", "name", "fn", "args")

    def __init__(self, node: Node, name: str, args: List[Node]):
        self.node, self.name, self.fn, self.args = node, name, _test(name), args

    def ev(self, f: Frame) -> Any:
        return self.fn(self.node.ev(f), *(a.ev(f) for a in self.args))

    def children(self) -> Sequence[Node]:
        return [self.node, *self.args]


# Statements render into a list of strings.

class Output(Node):
    __slots__ = ("text", "expr")

    def __init__(self, text: Optional[str] = None, expr: Optional[Node] = None):
        self.text, self.expr = text, expr

    def render(self, f: Frame, out: List[str]) -> None:
        if self.expr is None:
            out.append(self.text)  # type: ignore[arg-type]
        else:
            out.append(_to_str(self.expr.ev(f)))

    def children(self) -> Sequence[Node]:
        return (self.expr,) if self.expr is not None else ()


class If(Node):
    __slots__ = ("branches", "else_")

    def __init__(self, branches: List[Tuple[Node, List[Node]]], else_: List[Node]):
        self.branches, self.else_ = branches, else_

    def render(self, f: Frame, out: List[str]) -> None:
        for test, body in self.branches:
            if test.ev(f):
                _render_body(body, f, out)
                return
        _render_body(self.else_, f, out)

    def children(self) -> Sequence[Node]:
        return [n for t, b in self.branches for n in (t, *b)] + list(self.else_)


class For(Node):
    __slots__ = ("target", "iter", "test", "body", "else_")

    def __init__(self, target: List[str], it: Node, test: Optional[Node], body: List[Node],
                 else_: List[Node]):
        self.target, self.iter, self.test, self.body, self.else_ = target, it, test, body, else_

    def _bind(self, frame: Frame, item: Any) -> None:
        if len(self.target) == 1:
            frame.vars[self.target[0]] = item
            return
        values = list(item)
        if len(values) != len(self.target):
            raise ValueError(f"cannot unpack {len(values)} values into {len(self.target)} names")
        frame.vars.update(zip(self.target, values))

    def render(self, f: Frame, out: List[str]) -> None:
        items = list(self.iter.ev(f))
        if self.test is not None:
            kept = []
            for item in items:
                frame = Frame(f)
                self._bind(frame, item)
                if self.test.ev(frame):
                    kept.append(item)
            items = kept
        if not items:
            _render_body(self.else_, f, out)
            return
        loop = _Loop(items)
        for i, item in enumerate(items):
            loop.i = i
            frame = Frame(f)
            frame.vars["loop"] = loop
            self._bind(frame, item)
            _render_body(self.body, frame, out)

    def children(self) -> Sequence[Node]:
        return [self.iter, *([self.test] if self.test else []), *self.body, *self.else_]


class Set(Node):
    __slots__ = ("name", "attr", "expr")

    def __init__(self, name: str, attr: Optional[str], expr: Node):
        self.name, self.attr, self.expr = name, attr, expr

    def render(self, f: Frame, out: List[str]) -> None:
        value = self.expr.ev(f)
        if self.attr is None:
            f.vars[self.name] = value
            return
        ns = f.lookup(self.name)
        if not isinstance(ns, Namespace):
            raise TemplateRuntimeError("cannot assign attribute on non-namespace object")
        ns._attrs[self.attr] = value

    def children(self) -> Sequence[Node]:
        return (self.expr,)


class MacroNode(Node):
    __slots__ = ("name", "params", "body")

    def __init__(self, name: str, params: List[Tuple[str, Optional[Node]]], body: List[Node]):
        self.name, self.params, self.body = name, params, body

    def render(self, f: Frame, out: List[str]) -> None:
        f.vars[self.name] = _Macro(self, f)

    def children(self) -> Sequence[Node]:
        return [d for _, d in self.params if d is not None] + list(self.body)


def _render_body(body: Sequence[Node], f: Frame, out: List[str]) -> None:
    for node in body:
        node.render(f, out)  # type: ignore[attr-defined]


def _walk(node: Node):
    yield node
    for child in node.children():
        yield from _walk(child)


# ------------------------------------------------------------------- parser

# Jinja2's own tags that this subset does not have, refused by name (a tag
# Jinja2 lacks too, such as ``break`` without its extension, is Jinja2's
# TemplateSyntaxError).
_JINJA_TAGS = {"call", "filter", "include", "import", "from", "extends", "block", "with",
               "autoescape", "raw"}


class _Parser:
    def __init__(self, items: List[Tuple[str, Any]]):
        self.items = items
        self.i = 0
        self.toks: List[Token] = []
        self.p = 0

    # -- token stream of one tag ---------------------------------------------
    def cur(self) -> Token:
        return self.toks[self.p] if self.p < len(self.toks) else ("end", None)

    def nxt(self) -> Token:
        t = self.cur()
        self.p += 1
        return t

    def is_op(self, *ops: str) -> bool:
        t = self.cur()
        return t[0] == "op" and t[1] in ops

    def is_name(self, *names: str) -> bool:
        t = self.cur()
        return t[0] == "name" and t[1] in names

    def expect_op(self, op: str) -> None:
        t = self.nxt()
        if t != ("op", op):
            raise TemplateSyntaxError(f"expected {op!r}, got {t[1]!r}")

    def expect_name(self) -> str:
        t = self.nxt()
        if t[0] != "name":
            raise TemplateSyntaxError(f"expected a name, got {t[1]!r}")
        return t[1]

    def expect_end(self) -> None:
        if self.p < len(self.toks):
            raise TemplateSyntaxError(f"expected the end of the tag, got {self.cur()[1]!r}")

    # -- statements ------------------------------------------------------------
    def parse_template(self) -> List[Node]:
        body, end = self.parse_body(())
        if end is not None:
            raise TemplateSyntaxError(f"Encountered unknown tag {end!r}.")
        return body

    def parse_body(self, ends: Tuple[str, ...]) -> Tuple[List[Node], Optional[str]]:
        """Nodes up to a block tag named in ``ends`` (returned, with its
        tokens loaded), or to the end of the template (None)."""
        body: List[Node] = []
        while self.i < len(self.items):
            kind, value = self.items[self.i]
            self.i += 1
            if kind == "data":
                body.append(Output(text=value))
                continue
            self.toks, self.p = value, 0
            if kind == "var":
                expr = self.parse_tuple()
                self.expect_end()
                body.append(Output(expr=expr))
                continue
            name = self.expect_name()
            if name in ends:
                return body, name
            body.append(self.parse_statement(name, ends))
        if ends:
            raise TemplateSyntaxError(f"unexpected end of template, expected one of {ends}")
        return body, None

    def parse_statement(self, name: str, ends: Tuple[str, ...]) -> Node:
        if name == "if":
            return self.parse_if()
        if name == "for":
            return self.parse_for()
        if name == "set":
            return self.parse_set()
        if name == "macro":
            return self.parse_macro()
        if name in _JINJA_TAGS:
            raise TemplateSupportError(f"unsupported tag {{% {name} %}}")
        raise TemplateSyntaxError(f"Encountered unknown tag {name!r}.")

    def parse_if(self) -> Node:
        branches = []
        test = self.parse_tuple(with_cond=False)
        self.expect_end()
        else_: List[Node] = []
        while True:
            body, end = self.parse_body(("elif", "else", "endif"))
            branches.append((test, body))
            if end == "elif":
                test = self.parse_tuple(with_cond=False)
                self.expect_end()
                continue
            if end == "else":
                self.expect_end()
                else_, _ = self.parse_body(("endif",))
            self.expect_end()
            return If(branches, else_)

    def parse_for(self) -> Node:
        target = self.parse_target()
        if not self.is_name("in"):
            raise TemplateSyntaxError("expected 'in' in a for tag")
        self.nxt()
        it = self.parse_tuple(with_cond=False)
        test = None
        if self.is_name("if"):
            self.nxt()
            test = self.parse_expression()
        if self.is_name("recursive"):
            raise TemplateSupportError("unsupported recursive for loop")
        self.expect_end()
        body, end = self.parse_body(("endfor", "else"))
        else_: List[Node] = []
        if end == "else":
            self.expect_end()
            else_, _ = self.parse_body(("endfor",))
        self.expect_end()
        return For(target, it, test, body, else_)

    def parse_target(self) -> List[str]:
        names = [self.expect_name()]
        while self.is_op(","):
            self.nxt()
            if self.is_name("in") or self.cur()[0] != "name":
                break
            names.append(self.expect_name())
        return names

    def parse_set(self) -> Node:
        name = self.expect_name()
        attr = None
        if self.is_op("."):
            self.nxt()
            attr = self.expect_name()
        if self.is_op(","):
            raise TemplateSupportError("unsupported tuple target in {% set %}")
        if not self.is_op("="):
            raise TemplateSupportError("unsupported block {% set %}")
        self.nxt()
        expr = self.parse_tuple()
        self.expect_end()
        return Set(name, attr, expr)

    def parse_macro(self) -> Node:
        name = self.expect_name()
        self.expect_op("(")
        params: List[Tuple[str, Optional[Node]]] = []
        while not self.is_op(")"):
            if params:
                self.expect_op(",")
                if self.is_op(")"):
                    break
            pname = self.expect_name()
            default = None
            if self.is_op("="):
                self.nxt()
                default = self.parse_expression()
            params.append((pname, default))
        self.nxt()
        self.expect_end()
        body, _ = self.parse_body(("endmacro",))
        self.expect_end()
        node = MacroNode(name, params, body)
        for n in _walk(node):
            if isinstance(n, Name) and n.name in ("varargs", "kwargs", "caller"):
                raise TemplateSupportError(f"unsupported macro special variable {n.name!r}")
        return node

    # -- expressions -------------------------------------------------------
    def parse_tuple(self, with_cond: bool = True) -> Node:
        parse = self.parse_expression if with_cond else self.parse_or
        items = [parse()]
        is_tuple = False
        while self.is_op(","):
            is_tuple = True
            self.nxt()
            if self.cur()[0] == "end" or self.is_op(")") or self.is_name("in", "if"):
                break
            items.append(parse())
        return ListLit(items, as_tuple=True) if is_tuple else items[0]

    def parse_expression(self) -> Node:
        expr = self.parse_or()
        while self.is_name("if"):
            self.nxt()
            test = self.parse_or()
            other = None
            if self.is_name("else"):
                self.nxt()
                other = self.parse_expression()
            expr = CondExpr(test, expr, other)
        return expr

    def parse_or(self) -> Node:
        left = self.parse_and()
        while self.is_name("or"):
            self.nxt()
            left = Or(left, self.parse_and())
        return left

    def parse_and(self) -> Node:
        left = self.parse_not()
        while self.is_name("and"):
            self.nxt()
            left = And(left, self.parse_not())
        return left

    def parse_not(self) -> Node:
        if self.is_name("not"):
            self.nxt()
            return Unary("not", self.parse_not())
        return self.parse_compare()

    def parse_compare(self) -> Node:
        first = self.parse_math1()
        ops: List[Tuple[str, Node]] = []
        while True:
            if self.is_op("==", "!=", "<", "<=", ">", ">="):
                op = self.nxt()[1]
            elif self.is_name("in"):
                self.nxt()
                op = "in"
            elif self.is_name("not") and self.p + 1 < len(self.toks) and self.toks[self.p + 1] == ("name", "in"):
                self.p += 2
                op = "notin"
            else:
                break
            ops.append((op, self.parse_math1()))
        return Compare(first, ops) if ops else first

    def parse_math1(self) -> Node:
        left = self.parse_concat()
        while self.is_op("+", "-"):
            op = self.nxt()[1]
            left = Binary(op, left, self.parse_concat())
        return left

    def parse_concat(self) -> Node:
        left = self.parse_math2()
        while self.is_op("~"):
            self.nxt()
            left = Binary("~", left, self.parse_math2())
        return left

    def parse_math2(self) -> Node:
        left = self.parse_pow()
        while self.is_op("*", "/", "//", "%"):
            op = self.nxt()[1]
            left = Binary(op, left, self.parse_pow())
        return left

    def parse_pow(self) -> Node:
        left = self.parse_unary()
        while self.is_op("**"):
            self.nxt()
            left = Binary("**", left, self.parse_unary())
        return left

    def parse_unary(self, with_filter: bool = True) -> Node:
        if self.is_op("-", "+"):
            op = self.nxt()[1]
            node: Node = Unary(op, self.parse_unary(False))
        else:
            node = self.parse_primary()
        node = self.parse_postfix(node)
        if with_filter:
            node = self.parse_filter_expr(node)
        return node

    def parse_primary(self) -> Node:
        kind, value = self.nxt()
        if kind == "name":
            if value in ("true", "True", "false", "False"):
                return Const(value in ("true", "True"))
            if value in ("none", "None"):
                return Const(None)
            return Name(value)
        if kind == "str":
            while self.cur()[0] == "str":
                value += self.nxt()[1]
            return Const(value)
        if kind in ("int", "float"):
            return Const(value)
        if kind == "op" and value == "(":
            if self.is_op(")"):
                self.nxt()
                return ListLit([], as_tuple=True)
            node = self.parse_tuple()
            self.expect_op(")")
            return node
        if kind == "op" and value == "[":
            items = []
            while not self.is_op("]"):
                if items:
                    self.expect_op(",")
                    if self.is_op("]"):
                        break
                items.append(self.parse_expression())
            self.nxt()
            return ListLit(items)
        if kind == "op" and value == "{":
            pairs = []
            while not self.is_op("}"):
                if pairs:
                    self.expect_op(",")
                    if self.is_op("}"):
                        break
                k = self.parse_expression()
                self.expect_op(":")
                pairs.append((k, self.parse_expression()))
            self.nxt()
            return DictLit(pairs)
        raise TemplateSyntaxError(f"unexpected {value!r}")

    def parse_postfix(self, node: Node) -> Node:
        while True:
            if self.is_op(".", "["):
                node = self.parse_subscript(node)
            elif self.is_op("("):
                node = self.parse_call(node)
            else:
                return node

    def parse_filter_expr(self, node: Node) -> Node:
        while True:
            if self.is_op("|"):
                node = self.parse_filter(node)
            elif self.is_name("is"):
                node = self.parse_test(node)
            elif self.is_op("("):
                node = self.parse_call(node)
            else:
                return node

    def parse_subscript(self, node: Node) -> Node:
        kind, value = self.nxt()
        if value == ".":
            t = self.nxt()
            if t[0] == "name":
                return Getattr(node, t[1])
            if t[0] == "int":
                return Getitem(node, Const(t[1]))
            raise TemplateSyntaxError(f"expected a name or number after '.', got {t[1]!r}")
        args = [self.parse_subscribed()]
        while self.is_op(","):
            self.nxt()
            if self.is_op("]"):
                break
            args.append(self.parse_subscribed())
        self.expect_op("]")
        return Getitem(node, args[0] if len(args) == 1 else ListLit(args, as_tuple=True))

    def parse_subscribed(self) -> Node:
        parts: List[Optional[Node]] = []
        if self.is_op(":"):
            parts.append(None)
        else:
            node = self.parse_expression()
            if not self.is_op(":"):
                return node
            parts.append(node)
        self.nxt()  # the first ':'
        parts.append(None if self.is_op("]", ",", ":") else self.parse_expression())
        if self.is_op(":"):
            self.nxt()
            parts.append(None if self.is_op("]", ",") else self.parse_expression())
        else:
            parts.append(None)
        return Slice(*parts)

    def parse_call_args(self) -> Tuple[List[Node], List[Tuple[str, Node]]]:
        self.expect_op("(")
        args: List[Node] = []
        kwargs: List[Tuple[str, Node]] = []
        while not self.is_op(")"):
            if args or kwargs:
                self.expect_op(",")
                if self.is_op(")"):
                    break
            if self.is_op("*", "**"):
                raise TemplateSupportError("unsupported *args/**kwargs in a call")
            if self.cur()[0] == "name" and self.p + 1 < len(self.toks) and self.toks[self.p + 1] == ("op", "="):
                key = self.nxt()[1]
                self.nxt()
                kwargs.append((key, self.parse_expression()))
            else:
                if kwargs:
                    raise TemplateSyntaxError("invalid syntax for function call expression")
                args.append(self.parse_expression())
        self.nxt()
        return args, kwargs

    def parse_call(self, node: Node) -> Node:
        if isinstance(node, Getattr):
            if isinstance(node.obj, Name) and node.obj.name == "loop":
                if node.name != "cycle":
                    raise TemplateSupportError(f"unsupported call loop.{node.name}()")
            elif node.name not in _METHOD_NAMES:
                raise TemplateSupportError(f"unsupported method {node.name!r}")
        if isinstance(node, Name) and node.name in _UNSUPPORTED_GLOBALS:
            raise TemplateSupportError(f"unsupported global {node.name!r}")
        args, kwargs = self.parse_call_args()
        return Call(node, args, kwargs)

    def parse_filter(self, node: Node) -> Node:
        while self.is_op("|"):
            self.nxt()
            name = self.expect_name()
            while self.is_op("."):
                self.nxt()
                name += "." + self.expect_name()
            args: List[Node] = []
            kwargs: List[Tuple[str, Node]] = []
            if self.is_op("("):
                args, kwargs = self.parse_call_args()
            node = Filter(node, name, args, kwargs)
        return node

    def parse_test(self, node: Node) -> Node:
        self.nxt()  # 'is'
        negated = False
        if self.is_name("not"):
            self.nxt()
            negated = True
        name = self.expect_name()
        args: List[Node] = []
        if self.is_op("("):
            args, kwargs = self.parse_call_args()
            if kwargs:
                raise TemplateSupportError(f"unsupported keyword arguments to test {name!r}")
        elif (self.cur()[0] in ("name", "str", "int", "float") or self.is_op("(", "[", "{")) \
                and not self.is_name("else", "or", "and"):
            if self.is_name("is"):
                raise TemplateSyntaxError("You cannot chain multiple tests with is")
            args = [self.parse_postfix(self.parse_primary())]
        out: Node = Test(node, name, args)
        return Unary("not", out) if negated else out


def _check_loop_attrs(body: List[Node]) -> None:
    for node in body:
        for n in _walk(node):
            if (isinstance(n, Getattr) and isinstance(n.obj, Name) and n.obj.name == "loop"
                    and n.name not in _Loop.ATTRS):
                raise TemplateSupportError(f"unsupported loop attribute {n.name!r}")


class Template:
    def __init__(self, source: str):
        self.body = _Parser(_lex(source)).parse_template()
        _check_loop_attrs(self.body)

    def render(self, **context: Any) -> str:
        out: List[str] = []
        _render_body(self.body, Frame(root=context), out)
        return "".join(out)


@functools.lru_cache(maxsize=64)
def compile_template(source: str) -> Template:
    return Template(source)


def render_chat_template(source: str, messages: List[Dict[str, Any]], add_generation_prompt: bool,
                         bos_token: str, eos_token: str, **kwargs: Any) -> str:
    """What ``jinja2.Environment(trim_blocks=True, lstrip_blocks=True)``
    renders for the JAX package's ``apply_chat_template``."""
    return compile_template(source).render(
        messages=messages, add_generation_prompt=add_generation_prompt,
        bos_token=bos_token, eos_token=eos_token, **kwargs)
