"""A reader for the subset of YAML that the parameter files use, giving what
PyYAML's ``yaml.safe_load`` gives on them; it is not PyYAML and reads no
more than that subset.

The subset:

* block mappings and block sequences, a sequence item being a scalar, a
  flow collection, a nested block (``- - [2, 1, 4]``, ``- key: value``) or
  an indented block after a bare ``-``;
* flow sequences and mappings, nested to any depth, spanning lines;
* anchors (``&name``), aliases (``*name``) and the merge key
  (``<<: *name`` or ``<<: [*a, *b]``), merged as PyYAML merges: the merged
  keys first, the mapping's own keys overriding them;
* comments, plain scalars, single- and double-quoted strings;
* YAML 1.1 scalars as PyYAML resolves them: ``null`` / ``~`` / empty,
  ``true`` / ``yes`` / ``on`` (and their cases) as booleans, decimal
  integers, and floats, which need a dot (``5.0e-05`` is a float,
  ``1e-5`` a string).

Anything outside it (block scalars ``|`` / ``>``, tags, directives,
several documents, octal, hexadecimal, binary or sexagesimal numbers,
timestamps, complex keys, tabs in indentation) raises
:class:`YamlSubsetError` with the line; nothing is guessed.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, NamedTuple, Optional, Tuple


class YamlSubsetError(ValueError):
    """The text is outside the YAML subset this reader takes."""


class _Line(NamedTuple):
    number: int         # 1-based line in the file
    indent: int
    text: str           # without indentation, comment and trailing blanks


_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# YAML 1.1 forms PyYAML resolves that this reader does not take
_UNSUPPORTED = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"|=$")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0", " ": " "}


def resolve_scalar(text: str, where: str = "") -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 rules."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if _UNSUPPORTED.match(text):
        raise YamlSubsetError(f"{where}scalar {text!r} is a YAML 1.1 form "
                              "outside the subset")
    return text


def _split_lines(text: str) -> List[_Line]:
    out = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        indent = len(raw) - len(body)
        if body.startswith("\t"):
            raise YamlSubsetError(f"line {number}: tab in indentation")
        body = _strip_comment(body, number).rstrip()
        if not body:
            continue
        if indent == 0 and (body.startswith("---") or body.startswith("...")
                            or body.startswith("%")):
            raise YamlSubsetError(f"line {number}: document markers and "
                                  "directives are outside the subset")
        out.append(_Line(number, indent, body))
    return out


def _strip_comment(body: str, number: int) -> str:
    quote = None
    i = 0
    while i < len(body):
        c = body[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 2
                continue
            if c == quote:
                if quote == "'" and body[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "\"'" and (i == 0 or body[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or body[i - 1] in " \t"):
            return body[:i]
        i += 1
    return body


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _find_key_colon(text: str) -> int:
    """Index of the ``:`` that ends a block mapping key, or -1."""
    quote = None
    depth = 0
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 2
                continue
            if c == quote:
                quote = None
        elif c in "\"'" and i == 0:
            quote = c
        elif c in "[{":
            if i == 0:
                return -1       # a flow collection, not a key
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text)
                                          or text[i + 1] == " "):
            return i
        i += 1
    return -1


class _Flow:
    """Parser of one flow node held in a string."""

    def __init__(self, text: str, anchors: Dict[str, Any], where: str):
        self.s = text
        self.pos = 0
        self.anchors = anchors
        self.where = where

    def error(self, msg: str) -> YamlSubsetError:
        return YamlSubsetError(f"{self.where}{msg} at column {self.pos} of "
                               f"{self.s!r}")

    def ws(self) -> None:
        while self.pos < len(self.s) and self.s[self.pos] == " ":
            self.pos += 1

    def node(self) -> Any:
        self.ws()
        if self.pos >= len(self.s):
            raise self.error("missing value")
        c = self.s[self.pos]
        if c == "&":
            name = self.name()
            value = self.node()
            self.anchors[name] = value
            return value
        if c == "*":
            name = self.name()
            if name not in self.anchors:
                raise self.error(f"unknown alias *{name}")
            return self.anchors[name]
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in "\"'":
            return self.quoted()
        return self.plain()

    def name(self) -> str:
        self.pos += 1
        start = self.pos
        while self.pos < len(self.s) and self.s[self.pos] not in " ,[]{}":
            self.pos += 1
        if start == self.pos:
            raise self.error("empty anchor or alias name")
        return self.s[start:self.pos]

    def sequence(self) -> list:
        self.pos += 1
        items = []
        while True:
            self.ws()
            if self.s[self.pos:self.pos + 1] == "]":
                self.pos += 1
                return items
            items.append(self.node())
            self.ws()
            c = self.s[self.pos:self.pos + 1]
            if c == ",":
                self.pos += 1
            elif c != "]":
                raise self.error("expected ',' or ']'")

    def mapping(self) -> dict:
        self.pos += 1
        pairs: List[Tuple[Any, Any]] = []
        while True:
            self.ws()
            if self.s[self.pos:self.pos + 1] == "}":
                self.pos += 1
                return _build_mapping(pairs, self.where)
            key = self.node() if self.s[self.pos] in "\"'" else self.plain(
                key=True)
            self.ws()
            if self.s[self.pos:self.pos + 1] != ":":
                raise self.error("expected ':' after a flow mapping key")
            self.pos += 1
            self.ws()
            if self.s[self.pos:self.pos + 1] in (",", "}"):
                value = None
            else:
                value = self.node()
            pairs.append((key, value))
            self.ws()
            c = self.s[self.pos:self.pos + 1]
            if c == ",":
                self.pos += 1
            elif c != "}":
                raise self.error("expected ',' or '}'")

    def plain(self, key: bool = False) -> Any:
        if self.s[self.pos] in "|>!%@`?":
            raise self.error(f"indicator {self.s[self.pos]!r} is outside the "
                             "subset")
        start = self.pos
        while self.pos < len(self.s):
            c = self.s[self.pos]
            if c in ",[]{}":
                break
            if c == ":" and (self.pos + 1 == len(self.s)
                             or self.s[self.pos + 1] in " ,[]{}"):
                break
            self.pos += 1
        text = self.s[start:self.pos].rstrip()
        if key and text == "<<":
            return _MERGE
        return resolve_scalar(text, self.where)

    def quoted(self) -> str:
        q = self.s[self.pos]
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.s):
                raise self.error("unterminated quoted string")
            c = self.s[self.pos]
            if q == '"' and c == "\\":
                esc = self.s[self.pos + 1:self.pos + 2]
                if esc not in _ESCAPES:
                    raise self.error(f"escape \\{esc} is outside the subset")
                out.append(_ESCAPES[esc])
                self.pos += 2
                continue
            if c == q:
                if q == "'" and self.s[self.pos + 1:self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            out.append(c)
            self.pos += 1


class _MergeKey:
    def __repr__(self) -> str:
        return "<<"


_MERGE = _MergeKey()


def _build_mapping(pairs: List[Tuple[Any, Any]], where: str) -> dict:
    """A dict from ``(key, value)`` pairs as PyYAML builds it: merged
    mappings first (a sequence of them in reverse order), then the
    mapping's own keys, later assignments winning."""
    merged: List[Tuple[Any, Any]] = []
    own: List[Tuple[Any, Any]] = []
    for key, value in pairs:
        if key is _MERGE:
            sources = value if isinstance(value, list) else [value]
            if not all(isinstance(m, dict) for m in sources):
                raise YamlSubsetError(f"{where}a merge key takes a mapping "
                                      "or a sequence of mappings")
            for m in reversed(sources) if isinstance(value, list) else sources:
                merged.extend(m.items())
        else:
            if isinstance(key, (list, dict)):
                raise YamlSubsetError(f"{where}complex mapping keys are "
                                      "outside the subset")
            own.append((key, value))
    out: dict = {}
    for key, value in merged + own:
        out[key] = value
    return out


class _Block:
    """Parser of the block structure, line by line."""

    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0
        self.anchors: Dict[str, Any] = {}

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    @staticmethod
    def where(line: _Line) -> str:
        return f"line {line.number}: "

    def node(self, indent: int) -> Any:
        line = self.peek()
        if _is_seq_item(line.text):
            return self.sequence(indent)
        return self.mapping(indent)

    def sequence(self, indent: int) -> list:
        items = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent or (
                    line.indent == indent and not _is_seq_item(line.text)):
                return items
            if line.indent > indent:
                raise YamlSubsetError(f"{self.where(line)}bad indentation "
                                      "in a block sequence")
            content = line.text[1:]
            stripped = content.lstrip(" ")
            column = indent + 1 + len(content) - len(stripped)
            if stripped and not stripped.startswith(("&", "*", "[", "{", '"',
                                                     "'")) and (
                    _is_seq_item(stripped) or _find_key_colon(stripped) > 0):
                # a nested block starting on the item's line
                self.lines[self.i] = _Line(line.number, column, stripped)
                items.append(self.node(column))
            else:
                self.i += 1
                items.append(self.value(stripped, indent, line, in_seq=True))

    def mapping(self, indent: int) -> dict:
        pairs: List[Tuple[Any, Any]] = []
        first = self.peek()
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                break
            if line.indent > indent:
                raise YamlSubsetError(f"{self.where(line)}bad indentation "
                                      "in a block mapping")
            if _is_seq_item(line.text):
                break
            colon = _find_key_colon(line.text)
            if colon <= 0:
                raise YamlSubsetError(f"{self.where(line)}expected "
                                      "'key: value'")
            key_text = line.text[:colon].rstrip()
            if key_text == "<<":
                key = _MERGE
            elif key_text[0] in "\"'":
                flow = _Flow(key_text, self.anchors, self.where(line))
                key = flow.quoted()
                if flow.pos != len(key_text):
                    raise flow.error("text after a quoted key")
            elif key_text[0] in "?&*!|>%@`":
                raise YamlSubsetError(f"{self.where(line)}key {key_text!r} "
                                      "is outside the subset")
            else:
                key = resolve_scalar(key_text, self.where(line))
            self.i += 1
            pairs.append((key, self.value(line.text[colon + 1:].strip(),
                                          indent, line)))
        if pairs == [] and first is not None:
            raise YamlSubsetError(f"{self.where(first)}expected a mapping")
        return _build_mapping(pairs, self.where(first))

    def value(self, text: str, indent: int, line: _Line,
              in_seq: bool = False) -> Any:
        """The value after ``key:`` or ``-`` on ``line``: inline, or the
        block on the following lines."""
        anchor = None
        if text.startswith("&"):
            name, _, rest = text[1:].partition(" ")
            if not name:
                raise YamlSubsetError(f"{self.where(line)}empty anchor name")
            anchor, text = name, rest.strip()
        if text == "":
            nxt = self.peek()
            if nxt is not None and (nxt.indent > indent or (
                    not in_seq and nxt.indent == indent
                    and _is_seq_item(nxt.text))):
                value = self.node(nxt.indent)
            else:
                value = None
        else:
            value = self.inline(text, line)
            nxt = self.peek()
            if nxt is not None and nxt.indent > indent:
                raise YamlSubsetError(
                    f"{self.where(nxt)}a multi-line plain scalar or a block "
                    "after an inline value is outside the subset")
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def inline(self, text: str, line: _Line) -> Any:
        where = self.where(line)
        if text[0] in "[{":
            while _open_brackets(text) > 0:
                nxt = self.peek()
                if nxt is None:
                    raise YamlSubsetError(f"{where}unclosed flow collection")
                text = text + " " + nxt.text
                self.i += 1
        flow = _Flow(text, self.anchors, where)
        value = flow.node()
        flow.ws()
        if flow.pos != len(text):
            if text[0] in "\"'[{*&":
                raise flow.error("text after a value")
            # a plain scalar may hold ': ' nowhere at block level; take the
            # rest of the line as PyYAML does for ',' and brackets
            value = resolve_scalar(text, where)
        return value


def _open_brackets(text: str) -> int:
    depth, quote = 0, None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 2
                continue
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth


def loads(text: str) -> Any:
    """The value of a YAML document in the subset (None when empty)."""
    lines = _split_lines(text)
    if not lines:
        return None
    parser = _Block(lines)
    first = lines[0]
    if _is_seq_item(first.text) or _find_key_colon(first.text) > 0:
        value = parser.node(first.indent)
    else:
        parser.i = 1
        value = parser.value(first.text, first.indent - 1, first)
    if parser.peek() is not None:
        raise YamlSubsetError(f"{parser.where(parser.peek())}text after the "
                              "document's root node")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


def _float_text(x: float) -> str:
    if x != x:
        return ".nan"
    if x in (float("inf"), float("-inf")):
        return "-.inf" if x < 0 else ".inf"
    text = repr(x)
    mantissa, e, exponent = text.partition("e")
    if "." not in mantissa:      # YAML 1.1 reads 1e-05 as a string
        mantissa += ".0"
    return mantissa + e + exponent


def dumps(value: Any) -> str:
    """One line of flow-style YAML that :func:`loads` and ``yaml.safe_load``
    read back as ``value`` (dicts, lists, strings, numbers, booleans and
    None)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _float_text(value)
    if isinstance(value, str):
        if any(ord(c) < 32 for c in value):
            raise YamlSubsetError(f"control characters in {value!r}")
        return '"' + value.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(dumps(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{dumps(k)}: {dumps(v)}"
                               for k, v in value.items()) + "}"
    raise YamlSubsetError(f"cannot write {type(value).__name__}")
