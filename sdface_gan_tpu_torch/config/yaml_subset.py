"""A reader and a writer for the subset of YAML that ``configs/`` uses, so
the port needs no PyYAML: the counterpart of the ``yaml.safe_load`` and
``yaml.safe_dump`` calls of ``sdface_gan_tpu/config/yaml_config.py``.

The subset: block mappings (nested by indentation), comments, plain and
quoted scalars, and one-line flow sequences and mappings such as
``[0.4167, 0.5]``, ``['object_rotation']`` and ``{}``.  Plain scalars are
resolved as PyYAML's ``safe_load`` resolves them (YAML 1.1: ``yes``/``on``
are booleans, ``0.`` is a float, ``1e-4`` without a dot is a string, ``0o17``
is a string), since that is what the JAX package reads.  Anything outside
the subset raises ``ValueError``: anchors, aliases, tags, block scalars,
block sequences, multi-line scalars or flow collections, several documents,
timestamps, merge keys, the ints and floats YAML 1.1 reads in base 2, 8, 16
or 60 (``0b101``, ``017``, ``0x1F``, ``1:30``), and ``\\x``/``\\u``/``\\U``
escapes.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers, in its order (yaml/resolver.py), with the
# forms outside the subset split off into _UNSUPPORTED
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_UNSUPPORTED = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_PLAIN_FORBIDDEN_START = "&*!|>%@`'\"[]{},#"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}


class YAMLSubsetError(ValueError):
    pass


def resolve_plain(text: str, where: str = "") -> Any:
    """A plain scalar's value under PyYAML's (YAML 1.1) resolution."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _UNSUPPORTED.match(text):
        raise YAMLSubsetError(f"scalar {text!r} (base 2, 8, 16 or 60) is not supported{where}")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * float(v)
    if _INT.match(text):
        return int(text.replace("_", ""))
    if text == "<<":
        raise YAMLSubsetError(f"merge keys are not supported{where}")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text) or text == "=":
        raise YAMLSubsetError(f"scalar {text!r} (timestamp or value key) is not supported{where}")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment (a ``#`` at the start or after a
    space, outside quotes)."""
    quote: Optional[str] = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Recursive-descent parser of one line's flow node."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def error(self, msg: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"{msg}{self.where}: {self.s!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        self.skip()
        return self.s[self.i] if self.i < len(self.s) else ""

    def node(self, in_flow: bool) -> Any:
        ch = self.peek()
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in "'\"":
            return self.quoted()
        return self.plain(in_flow)

    def sequence(self) -> list:
        self.i += 1
        out: List[Any] = []
        while True:
            if self.peek() == "]":
                self.i += 1
                return out
            if self.peek() in ("", ","):
                raise self.error("empty or unclosed flow sequence entry")
            out.append(self.node(True))
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']' in a flow sequence")

    def mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            if self.peek() == "}":
                self.i += 1
                return out
            if self.peek() in ("", ","):
                raise self.error("empty or unclosed flow mapping entry")
            key = self.node(True)
            value = None
            if self.peek() == ":":
                self.i += 1
                value = None if self.peek() in (",", "}") else self.node(True)
            if isinstance(key, (dict, list)):
                raise self.error("collection keys are not supported")
            out[key] = value
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}' in a flow mapping")

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated (or multi-line) quoted scalar")
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                if esc not in _ESCAPES:
                    raise self.error("bad or unsupported escape in a double-quoted scalar")
                out.append(_ESCAPES[esc])
                self.i += 2
                continue
            out.append(ch)
            self.i += 1

    def plain(self, in_flow: bool) -> Any:
        start = self.i
        ch = self.s[start:start + 1]
        if ch and ch in _PLAIN_FORBIDDEN_START:
            raise self.error(f"{ch!r} (anchor, alias, tag, block scalar or reserved "
                             "indicator) is not supported")
        if self.s[start:start + 2] in ("- ", "? ") or self.s[start:] in ("-", "?"):
            raise self.error("block sequences and complex keys are not supported")
        stops = ",[]{}" if in_flow else ""
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in stops:
                break
            if c == ":" and (self.i + 1 == len(self.s) or self.s[self.i + 1] in " \t" + stops):
                if not in_flow:
                    raise self.error("a mapping value is not allowed here")
                break
            self.i += 1
        return resolve_plain(self.s[start:self.i].strip(), self.where)

    def finish(self) -> None:
        if self.peek():
            raise self.error("unexpected text after a value")


def _value(text: str, where: str) -> Any:
    p = _Flow(text, where)
    v = p.node(False)
    p.finish()
    return v


def _split_entry(text: str, where: str) -> Tuple[Any, str]:
    """``key: rest`` -> (key, rest); the key plain or quoted."""
    p = _Flow(text, where)
    if p.peek() in "'\"":
        key = p.quoted()
    else:
        start = p.i
        if text[start:start + 1] in _PLAIN_FORBIDDEN_START:
            raise p.error("not a mapping entry (anchor, tag, flow key or reserved indicator)")
        while p.i < len(text) and not (
                text[p.i] == ":" and (p.i + 1 == len(text) or text[p.i + 1] in " \t")):
            p.i += 1
        if p.i == len(text) or text[start:start + 2] in ("- ", "? "):
            raise p.error("expected 'key: value' (block sequences, complex keys and "
                          "multi-line scalars are not supported)")
        key = resolve_plain(text[start:p.i].strip(), where)
    if p.peek() != ":":
        raise p.error("expected ':' after a mapping key")
    return key, text[p.i + 1:].strip()


def safe_load(text: str) -> Any:
    """Parse ``text`` as ``yaml.safe_load`` would, within the subset."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line.strip():
            continue
        where = f" (line {n})"
        indent = len(line) - len(line.lstrip(" "))
        if line[indent:indent + 1] == "\t":
            raise YAMLSubsetError(f"tab indentation{where}")
        body = line[indent:]
        if body.startswith("%"):
            raise YAMLSubsetError(f"directives are not supported{where}")
        if body in ("---", "...") or body.startswith(("--- ", "... ")):
            if lines or body != "---":
                raise YAMLSubsetError(f"several documents are not supported{where}")
            continue
        lines.append((indent, body, where))
    if not lines:
        return None
    if len(lines) == 1 and lines[0][1][:1] in "[{'\"":
        return _value(lines[0][1], lines[0][2])

    root: dict = {}
    stack: List[Tuple[int, dict]] = [(lines[0][0], root)]
    pending: Optional[Tuple[dict, Any, int]] = None
    for indent, body, where in lines:
        if pending is not None:
            parent, key, parent_indent = pending
            pending = None
            if indent > parent_indent:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise YAMLSubsetError(f"bad indentation{where}")
        mapping = stack[-1][1]
        key, rest = _split_entry(body, where)
        if isinstance(key, float) and math.isnan(key):
            raise YAMLSubsetError(f"NaN keys are not supported{where}")
        if rest:
            mapping[key] = _value(rest, where)
        else:
            mapping[key] = None
            pending = (mapping, key, indent)
    return root


# -- writer -----------------------------------------------------------------

def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:  # PyYAML's float form: 1.0e-05
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        plain_ok = (v and v == v.strip() and v[0] not in _PLAIN_FORBIDDEN_START + "-?:~"
                    and not any(c in v for c in ":#,[]{}\n\r\t\\")
                    and v.isprintable())
        if plain_ok:
            try:
                plain_ok = resolve_plain(v) == v
            except YAMLSubsetError:
                plain_ok = False
        if plain_ok:
            return v
        if v.isprintable():
            return "'" + v.replace("'", "''") + "'"
    raise YAMLSubsetError(f"cannot write the value {v!r}")


def _flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def safe_dump(data: dict) -> str:
    """Write a mapping in the subset: nested mappings as blocks, sequences
    and empty mappings in flow style."""
    out: List[str] = []

    def emit(d: dict, indent: int) -> None:
        for k, v in d.items():
            head = " " * indent + _scalar(k) + ":"
            if isinstance(v, dict) and v:
                out.append(head)
                emit(v, indent + 2)
            else:
                out.append(f"{head} {_flow(v)}")

    if not isinstance(data, dict):
        raise YAMLSubsetError("the document must be a mapping")
    emit(data, 0)
    return "\n".join(out) + "\n" if out else "{}\n"
