"""A reader for the YAML subset the model specifications use.

The model files (`hank_tpu/models/*.yaml`) need only a small part of YAML:
block mappings, block sequences (including sequences of mappings),
plain / single-quoted / double-quoted scalars, inline `[a, b]` lists of
scalars and `#` comments. This module reads exactly that subset, with the
same results `yaml.safe_load` gives for it, so the package needs no YAML
library. Anything outside the subset raises `YAMLSubsetError` naming the
line: anchors, aliases, tags, block scalars (`|`, `>`), flow mappings,
nested inline lists, document markers and directives, tab indentation,
multi-line scalars, duplicate keys, and scalars whose YAML 1.1 type is
ambiguous (`yes`/`no`/`on`/`off`, octal or hexadecimal integers, exponent
floats without a decimal point or exponent sign).
"""

from __future__ import annotations

import math
import re
from typing import Any, NamedTuple

__all__ = ["YAMLSubsetError", "load", "load_file"]


class YAMLSubsetError(ValueError):
    """Input outside the supported YAML subset (or malformed)."""

    def __init__(self, lineno: int, msg: str):
        super().__init__(f"line {lineno}: {msg}")
        self.lineno = lineno


class _Line(NamedTuple):
    lineno: int
    indent: int
    text: str


_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
# Number-like text that YAML 1.1 reads as a string or a non-decimal number.
_NUMBERISH = re.compile(r"[-+]?(?:0[0-9_xXoObB]|[0-9][0-9_]*_|[0-9]+:|"
                        r"(?:[0-9][0-9_]*\.?[0-9_]*|\.[0-9_]+)[eE][-+]?[0-9])")
_NULLS = {"~", "null", "Null", "NULL"}
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
_AMBIGUOUS_BOOLS = {"yes", "Yes", "YES", "no", "No", "NO",
                    "on", "On", "ON", "off", "Off", "OFF"}
_SPECIAL_FLOATS = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                   "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
                   "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
                   ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_UNSUPPORTED_START = {
    "&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
    ">": "block scalars", "{": "flow mappings", "%": "directives",
    "@": "reserved indicators", "`": "reserved indicators",
    "?": "complex keys"}


def _strip_comment(raw: str, lineno: int) -> str:
    """The line without its `#` comment (quotes respected)."""
    quote = None
    i = 0
    while i < len(raw):
        ch = raw[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote:
                if quote == "'" and raw[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in "\"'" and (i == 0 or raw[i - 1] in " \t[,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
        i += 1
    return raw.rstrip()


def _lines(text: str) -> list[_Line]:
    out = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        body = _strip_comment(raw, lineno)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t") or "\t" in body[:len(body) - len(stripped)]:
            raise YAMLSubsetError(lineno, "tab in indentation")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise YAMLSubsetError(lineno, "document markers and directives "
                                          "are not supported")
        out.append(_Line(lineno, len(body) - len(stripped), stripped))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _quoted(text: str, lineno: int) -> tuple[str, str]:
    """Parse a quoted scalar at the start of `text`; (value, remainder)."""
    q = text[0]
    out = []
    i = 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+",
                                                        digits):
                    raise YAMLSubsetError(lineno, f"bad \\{esc} escape")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise YAMLSubsetError(lineno, f"unknown escape \\{esc}")
        out.append(ch)
        i += 1
    raise YAMLSubsetError(lineno, "unterminated quoted scalar "
                                  "(multi-line scalars are not supported)")


def _plain(text: str, lineno: int) -> Any:
    """Resolve a plain scalar the way YAML 1.1 (`yaml.safe_load`) does."""
    if text[0] in _UNSUPPORTED_START:
        raise YAMLSubsetError(
            lineno, f"{_UNSUPPORTED_START[text[0]]} are not supported: "
                    f"{text!r}")
    if text[0] in "[]}," or (text[0] in "-:" and text[1:2] in ("", " ")):
        raise YAMLSubsetError(lineno, f"unexpected indicator in {text!r}")
    if ": " in text or text.endswith(":"):
        raise YAMLSubsetError(lineno, f"mapping not allowed here: {text!r}")
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _AMBIGUOUS_BOOLS:
        raise YAMLSubsetError(lineno, f"ambiguous YAML 1.1 boolean {text!r}: "
                                      "write true/false or quote it")
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _NUMBERISH.match(text):
        raise YAMLSubsetError(lineno, f"ambiguous number {text!r}: write a "
                                      "decimal like 1.0e-6, or quote it")
    return text


def _scalar(text: str, lineno: int) -> Any:
    if text[0] in "\"'":
        value, rest = _quoted(text, lineno)
        if rest.strip():
            raise YAMLSubsetError(lineno, f"text after a quoted scalar: "
                                          f"{rest.strip()!r}")
        return value
    return _plain(text, lineno)


def _inline_list(text: str, lineno: int) -> list:
    if not text.endswith("]"):
        raise YAMLSubsetError(lineno, "inline lists must close on their line")
    body = text[1:-1].strip()
    items: list[Any] = []
    while body:
        if body[0] in "[{":
            raise YAMLSubsetError(lineno, "nested inline collections are not "
                                          "supported")
        if body[0] in "\"'":
            value, body = _quoted(body, lineno)
            items.append(value)
        else:
            cut = body.find(",")
            cut = len(body) if cut < 0 else cut
            item = body[:cut].strip()
            if not item:
                raise YAMLSubsetError(lineno, "empty inline list item")
            if item[0] in "]}":
                raise YAMLSubsetError(lineno, f"unexpected {item[0]!r}")
            items.append(_plain(item, lineno))
            body = body[cut:]
        body = body.strip()
        if body.startswith(","):
            body = body[1:].strip()
            if not body:
                raise YAMLSubsetError(lineno, "trailing comma in inline list")
        elif body:
            raise YAMLSubsetError(lineno, f"expected ',' in inline list, "
                                          f"got {body!r}")
    return items


def _value(text: str, lineno: int) -> Any:
    if text.startswith("["):
        return _inline_list(text, lineno)
    return _scalar(text, lineno)


def _split_key(text: str, lineno: int) -> tuple[Any, str] | None:
    """(key, rest) for a `key: value` line, or None if it is no mapping."""
    if text[0] in "\"'":
        key, rest = _quoted(text, lineno)
        if rest.startswith(":") and rest[1:2] in ("", " "):
            return key, rest[1:].strip()
        return None
    for m in re.finditer(r":(?= |$)", text):
        key = text[:m.start()].rstrip()
        if key:
            return _plain(key, lineno), text[m.end():].strip()
    return None


class _Parser:
    def __init__(self, lines: list[_Line]):
        self.lines = lines
        self.i = 0

    def peek(self) -> _Line | None:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        if _is_item(line.text):
            return self.sequence(indent)
        if _split_key(line.text, line.lineno) is not None:
            return self.mapping(indent)
        self.i += 1
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise YAMLSubsetError(nxt.lineno, "multi-line plain scalars are "
                                              "not supported")
        return _value(line.text, line.lineno)

    def nested(self, parent: int, allow_indentless: bool) -> Any:
        """The block under a `key:` / `-` line at indent `parent`."""
        nxt = self.peek()
        if nxt is not None and nxt.indent > parent:
            return self.block(nxt.indent)
        if (allow_indentless and nxt is not None and nxt.indent == parent
                and _is_item(nxt.text)):
            return self.sequence(parent)
        return None

    def sequence(self, indent: int) -> list:
        items = []
        while (line := self.peek()) is not None and line.indent == indent:
            if not _is_item(line.text):
                break
            rest = line.text[1:]
            if not rest.strip():
                self.i += 1
                items.append(self.nested(indent, allow_indentless=False))
                continue
            col = indent + 1 + len(rest) - len(rest.lstrip(" "))
            self.lines[self.i] = _Line(line.lineno, col, rest.lstrip(" "))
            items.append(self.block(col))
        self._check_dedent(indent)
        return items

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while (line := self.peek()) is not None and line.indent == indent:
            if _is_item(line.text):
                raise YAMLSubsetError(line.lineno, "sequence item inside a "
                                                   "mapping")
            split = _split_key(line.text, line.lineno)
            if split is None:
                raise YAMLSubsetError(line.lineno, f"expected 'key: value', "
                                                   f"got {line.text!r}")
            key, rest = split
            if key in out:
                raise YAMLSubsetError(line.lineno, f"duplicate key {key!r}")
            self.i += 1
            if rest:
                out[key] = _value(rest, line.lineno)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise YAMLSubsetError(nxt.lineno, "unexpected indentation "
                                                      "(multi-line scalars are "
                                                      "not supported)")
            else:
                out[key] = self.nested(indent, allow_indentless=True)
        self._check_dedent(indent)
        return out

    def _check_dedent(self, indent: int) -> None:
        line = self.peek()
        if line is not None and line.indent > indent:
            raise YAMLSubsetError(line.lineno, "unexpected indentation")


def load(text: str) -> Any:
    """Parse `text` (the supported YAML subset) into Python objects."""
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    value = parser.block(lines[0].indent)
    if parser.peek() is not None:
        line = parser.peek()
        raise YAMLSubsetError(line.lineno, "unexpected dedent")
    return value


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read())
