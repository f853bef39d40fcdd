"""A reader for the block-style YAML subset of the configs, with
`yaml.safe_load`'s meaning (the port does not depend on PyYAML).

What it reads: block mappings and sequences (a mapping may start on a
sequence's `- ` line), flow mappings `{...}` and sequences `[...]` (on
one line or continued over several), plain, single- and double-quoted
scalars, comments and the empty document.  Plain scalars resolve by
YAML 1.1's rules as PyYAML's resolver does (its regular expressions,
copied): `1.0e-6` is a float and `1e-6` a string; yes/no/on/off are
bools; null, ~ and the empty value are None; 0b, 0x, leading-0 octal,
underscores and base-60 ints and floats.  Keys resolve the same way; a
repeated key keeps its last value.

What it refuses (ValueError): anchors, aliases, tags, block scalars
`|` `>`, document markers and directives (so more than one document),
complex keys `?`, the merge key `<<`, dates and timestamps, tabs in
indentation, a plain scalar continued on the next line, and anything
else outside the subset.  It never guesses.
"""
from __future__ import annotations

import re

__all__ = ["safe_load"]

# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order
_BOOL = re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X)
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_MERGE = re.compile(r'^(?:<<)$')
_NULL = re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X)
_TIMESTAMP = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''',
                        re.X)
_VALUE = re.compile(r'^(?:=)$')
# the resolvers keyed by the scalar's first character, as PyYAML's
_FIRST = [(_BOOL, "bool", "yYnNtTfFoO"), (_FLOAT, "float", "-+0123456789."),
          (_INT, "int", "-+0123456789"), (_MERGE, "merge", "<"),
          (_NULL, "null", "~nN"), (_TIMESTAMP, "timestamp", "0123456789"),
          (_VALUE, "value", "=")]
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Refuse(ValueError):
    pass


def _refuse(msg, lineno=None):
    where = "" if lineno is None else f" (line {lineno})"
    raise _Refuse(f"YAML outside the supported subset{where}: {msg}")


# ---- scalars ---------------------------------------------------------------

def _sexagesimal(text, conv):
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    digits = [conv(part) for part in text.split(":")]
    digits.reverse()
    base, value = 1, 0
    for d in digits:
        value += d * base
        base *= 60
    return sign * value


def _construct_int(text):
    value = text.replace("_", "")
    sign = 1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(text):
    value = text.replace("_", "").lower()
    sign = 1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _resolve_plain(text, lineno=None):
    """A plain scalar's value by YAML 1.1's implicit resolvers."""
    first = text[:1]
    for regex, kind, chars in _FIRST:
        if (first in chars or (kind == "null" and text == "")) \
                and regex.match(text):
            if kind == "bool":
                return text.lower() in ("yes", "true", "on")
            if kind == "float":
                return _construct_float(text)
            if kind == "int":
                return _construct_int(text)
            if kind == "null":
                return None
            # a date or timestamp (no config uses one), the merge key or
            # the value key
            _refuse(f"the {kind} scalar {text!r}", lineno)
    return text


def _double_quoted(body, lineno):
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            i += 1
            if i >= len(body):
                _refuse("a line break in a double-quoted scalar", lineno)
            esc = body[i]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
            elif esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                code = body[i + 1:i + 1 + n]
                if len(code) != n or not re.fullmatch(r"[0-9A-Fa-f]+", code):
                    _refuse(f"the escape \\{esc}{code}", lineno)
                out.append(chr(int(code, 16)))
                i += n
            else:
                _refuse(f"the escape \\{esc}", lineno)
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def _scan_quoted(text, i, lineno):
    """(value, index after the closing quote) of the quoted scalar that
    starts at text[i]."""
    q = text[i]
    j = i + 1
    while True:
        k = text.find(q, j)
        if k < 0:
            _refuse("a quoted scalar continued on the next line", lineno)
        if q == "'" and text[k + 1:k + 2] == "'":
            j = k + 2
            continue
        if q == '"':
            n = 0
            while k - 1 - n > i and text[k - 1 - n] == "\\":
                n += 1
            if n % 2:
                j = k + 1
                continue
        break
    body = text[i + 1:k]
    value = body.replace("''", "'") if q == "'" else \
        _double_quoted(body, lineno)
    return value, k + 1


# ---- lines -------------------------------------------------------------------

def _strip_comment(text, lineno):
    """The line without its comment (a # at the start or after a space,
    outside quotes) and trailing blanks."""
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            _, i = _scan_quoted(text, i, lineno)
            continue
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _lines(text):
    out = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        body = _strip_comment(raw, lineno)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            _refuse("a tab in the indentation", lineno)
        if lineno == 1 and body.startswith("﻿"):
            _refuse("a byte-order mark", lineno)
        if body.startswith(("---", "...")) and (
                len(body) == 3 or body[3] in " \t"):
            _refuse("a document marker", lineno)
        if body.startswith("%"):
            _refuse("a directive", lineno)
        out.append((len(body) - len(stripped), stripped, lineno))
    return out


def _split_key(text, lineno):
    """(key text, rest) if `text` is a block mapping entry, else None.
    The key is plain or quoted; the value indicator is ':' followed by a
    blank or the line's end."""
    if text[0] in "'\"":
        _, j = _scan_quoted(text, 0, lineno)
        rest = text[j:].lstrip(" ")
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return text[:j], rest[1:].strip()
        return None
    if text[0] in "[{":
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    return text[:m.start()].rstrip(), text[m.end():].strip()


def _check_plain(text, lineno, flow=False):
    if not text:
        return
    if text[0] in "&*!|>%@`?" and not (text[0] == "?" and len(text) > 1
                                        and text[1] not in " \t"):
        what = {"&": "an anchor", "*": "an alias", "!": "a tag",
                "|": "a block scalar", ">": "a block scalar",
                "%": "a directive", "@": "a reserved indicator",
                "`": "a reserved indicator", "?": "a complex key"}[text[0]]
        _refuse(f"{what} in {text!r}", lineno)
    if text[0] in ",[]{}#":
        _refuse(f"a plain scalar starting with {text[0]!r}", lineno)
    if text[0] == "-" and (len(text) == 1 or text[1] in " \t"):
        _refuse(f"a sequence entry where a scalar belongs: {text!r}", lineno)
    if re.search(r":(?:[ \t]|$)", text) or (flow and ":" in text):
        _refuse(f"a ':' inside the plain scalar {text!r}", lineno)
    if " #" in text or "\t#" in text:
        _refuse(f"a comment inside the plain scalar {text!r}", lineno)


class _Flow:
    """A flow collection's text (one line, or several joined by blanks)."""

    def __init__(self, text, lineno):
        self.s, self.i, self.lineno = text, 0, lineno

    def _skip(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self):
        self._skip()
        ch = self.s[self.i:self.i + 1]
        if ch == "{":
            return self._mapping()
        if ch == "[":
            return self._sequence()
        if ch in ("'", '"'):
            value, self.i = _scan_quoted(self.s, self.i, self.lineno)
            return value
        return self._plain()

    def _plain(self):
        j = self.i
        while j < len(self.s) and self.s[j] not in ",[]{}":
            if self.s[j] == ":" and (j + 1 == len(self.s)
                                     or self.s[j + 1] in " \t,[]{}"):
                break
            j += 1
        text = self.s[self.i:j].strip()
        _check_plain(text, self.lineno, flow=True)
        self.i = j
        return _resolve_plain(text, self.lineno)

    def _expect(self, chars):
        self._skip()
        ch = self.s[self.i:self.i + 1]
        if not ch or ch not in chars:
            _refuse(f"expected one of {chars!r} at {self.s[self.i:]!r} in "
                    f"{self.s!r}", self.lineno)
        self.i += 1
        return ch

    def _mapping(self):
        self.i += 1
        out = {}
        self._skip()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.node()
            self._skip()
            value = None
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self._skip()
                if self.s[self.i:self.i + 1] not in (",", "}"):
                    value = self.node()
            out[_key(key, self.lineno)] = value
            if self._expect(",}") == "}":
                return out
            self._skip()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out

    def _sequence(self):
        self.i += 1
        out = []
        self._skip()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.node())
            self._skip()
            if self.s[self.i:self.i + 1] == ":":
                _refuse("a single-pair mapping inside a flow sequence",
                        self.lineno)
            if self._expect(",]") == "]":
                return out
            self._skip()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out


def _key(value, lineno):
    if isinstance(value, (dict, list)):
        _refuse("a collection as a mapping key", lineno)
    return value


# ---- block structure ---------------------------------------------------------

class _Block:
    def __init__(self, lines):
        self.lines = lines
        self.k = 0

    def peek(self):
        return self.lines[self.k] if self.k < len(self.lines) else None

    def node(self, indent):
        """The block node whose lines start at column `indent`."""
        col, text, lineno = self.peek()
        if text.startswith("- ") or text == "-":
            return self._sequence(col)
        if _split_key(text, lineno) is not None:
            return self._mapping(col)
        self.k += 1
        value = self._inline(text, lineno, col)
        nxt = self.peek()
        if nxt is not None and nxt[0] >= col:
            _refuse(f"a scalar continued on the next line: {nxt[1]!r}",
                    nxt[2])
        return value

    def _inline(self, text, lineno, col):
        """A value written on its key's (or dash's) line."""
        if text[0] in "[{":
            return self._flow(text, lineno, col)
        if text[0] in "'\"":
            value, j = _scan_quoted(text, 0, lineno)
            if text[j:].strip():
                _refuse(f"text after a quoted scalar: {text!r}", lineno)
            return value
        _check_plain(text, lineno)
        return _resolve_plain(text, lineno)

    def _flow(self, text, lineno, col):
        """A flow collection, joining continuation lines (indented past
        `col`) until its brackets close."""
        parts = [text]
        while True:
            joined = " ".join(parts)
            if _balanced(joined, lineno):
                break
            nxt = self.peek()
            if nxt is None or nxt[0] <= col:
                _refuse(f"an unclosed flow collection {joined!r}", lineno)
            parts.append(nxt[1])
            self.k += 1
        flow = _Flow(joined, lineno)
        value = flow.node()
        if joined[flow.i:].strip():
            _refuse(f"text after a flow collection: {joined!r}", lineno)
        return value

    def _value_after_key(self, rest, lineno, col):
        if rest:
            if rest.startswith("- ") or rest == "-":
                _refuse("a block sequence on its key's line", lineno)
            return self._inline(rest, lineno, col)
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt[0] > col:
            return self.node(nxt[0])
        if nxt[0] == col and (nxt[1].startswith("- ") or nxt[1] == "-"):
            # a sequence may sit at its key's indentation
            return self._sequence(col)
        return None

    def _mapping(self, col):
        out = {}
        while True:
            line = self.peek()
            if line is None or line[0] < col:
                return out
            c, text, lineno = line
            if c > col:
                _refuse(f"unexpected indentation: {text!r}", lineno)
            split = _split_key(text, lineno)
            if split is None:
                if text.startswith("- ") or text == "-":
                    return out
                _refuse(f"a mapping entry without ': ': {text!r}", lineno)
            ktext, rest = split
            self.k += 1
            if ktext[:1] in "'\"":
                key, _ = _scan_quoted(ktext, 0, lineno)
            else:
                if ktext.startswith("? "):
                    _refuse("a complex key", lineno)
                _check_plain(ktext, lineno)
                key = _resolve_plain(ktext, lineno)
            out[key] = self._value_after_key(rest, lineno, col)

    def _sequence(self, col):
        out = []
        while True:
            line = self.peek()
            if line is None or line[0] < col:
                return out
            c, text, lineno = line
            if c > col:
                _refuse(f"unexpected indentation: {text!r}", lineno)
            if not (text.startswith("- ") or text == "-"):
                return out
            rest = text[1:].lstrip(" ")
            if not rest:
                self.k += 1
                nxt = self.peek()
                out.append(self.node(nxt[0]) if nxt is not None
                           and nxt[0] > col else None)
                continue
            # the entry's content starts on the dash's line, at its own
            # column: read it as a line of its own there
            inner = c + len(text) - len(rest)
            self.lines[self.k] = (inner, rest, lineno)
            out.append(self.node(inner))


def _balanced(text, lineno):
    depth, i = 0, 0
    while i < len(text):
        ch = text[i]
        if ch in "'\"":
            _, i = _scan_quoted(text, i, lineno)
            continue
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        i += 1
    return depth <= 0


def safe_load(stream):
    """The document in `stream` (a str, or a file opened for reading) as
    yaml.safe_load reads it, for the subset above; ValueError otherwise."""
    text = stream if isinstance(stream, str) else stream.read()
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _refuse("a tab in the indentation", lineno)
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.peek() is not None:
        col, text_, lineno = block.peek()
        _refuse(f"a second top-level node: {text_!r}", lineno)
    return value
