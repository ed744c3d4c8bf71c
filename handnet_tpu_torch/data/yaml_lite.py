"""DexYCB's YAML subset, read and written without ``yaml``.

What :func:`loads` reads (and :func:`dumps` writes):

* block mappings nested by indentation (``key: value``; ``key:`` followed
  by a more indented block, or by a block sequence at the key's own
  indent, as ``yaml.safe_dump`` writes it);
* block sequences (``- item``, at the key's indent or indented; an item
  may open a compact mapping, ``- a: 1``, or another sequence, ``- - 1``)
  and flow sequences ``[a, b]``, nested too; ``{}`` and ``[]`` are empty;
* scalars as ``yaml.safe_load`` resolves them: decimal ints, floats with a
  dot (``1.0``, ``-2.5e-05``, ``.5``), ``.inf`` and ``.nan``, booleans
  (``true``/``false`` and YAML 1.1's ``yes``/``no``/``on``/``off`` in their
  three cases), null (``null``, ``~`` or nothing), and single- or
  double-quoted strings; any other plain word is a string;
* ``#`` comments and a leading ``---``.

Anything else raises ``ValueError`` naming the line: tabs in the indent,
anchors, aliases and tags, block scalars (``|``, ``>``), plain scalars
over several lines, flow mappings with entries, and plain scalars that
``yaml`` would read as another type the subset lacks (hex, octal and
binary ints, ``1:30`` sexagesimals, timestamps), so that no file reads
differently here than through ``yaml``. As in ``yaml``, a repeated key
keeps its last value.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}
# plain scalars yaml resolves to types outside the subset
_UNSUPPORTED = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+.*)?"
    r"|<<|=")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _fail(line: int, msg: str):
    raise ValueError(f"yaml_lite: line {line}: {msg}")


def _plain(text: str, line: int) -> Any:
    """A plain scalar, resolved as ``yaml.safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF.fullmatch(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _UNSUPPORTED.fullmatch(text):
        _fail(line, f"the plain scalar {text!r} is a type outside the subset")
    if text[0] in "&*!|>%@`{":
        _fail(line, f"{text[0]!r} (anchors, aliases, tags, block scalars, flow "
                    "mappings) is outside the subset")
    if text.startswith(("- ", "? ")) or text in ("-", "?") or ": " in text or text.endswith(":"):
        _fail(line, f"unexpected {text!r}")
    return text


def _quoted(text: str, pos: int, line: int) -> Tuple[str, int]:
    """The quoted string starting at ``text[pos]``; returns it and the
    position after its closing quote."""
    quote = text[pos]
    out: List[str] = []
    i = pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
            i += 1
            continue
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
            elif esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = text[i + 2:i + 2 + n]
                if not re.fullmatch(f"[0-9a-fA-F]{{{n}}}", digits):
                    _fail(line, f"bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                _fail(line, f"unknown escape \\{esc}")
            continue
        out.append(ch)
        i += 1
    _fail(line, "a quoted string does not end on its line")


def _strip_comment(text: str, line: int) -> str:
    """``text`` without a trailing ``# comment`` (outside quotes)."""
    i, quote = 0, None
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif ch == "\\" and quote == '"':
                i += 2
                continue
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _scalar(text: str, line: int) -> Any:
    """A whole value: quoted, flow sequence, ``{}`` or plain."""
    if not text:
        return None
    if text[0] in "'\"":
        value, end = _quoted(text, 0, line)
        if text[end:].strip():
            _fail(line, f"text after a quoted string: {text[end:]!r}")
        return value
    if text[0] == "[":
        value, end = _flow(text, 0, line)
        if text[end:].strip():
            _fail(line, f"text after a flow sequence: {text[end:]!r}")
        return value
    if re.fullmatch(r"\{\s*\}", text):
        return {}
    return _plain(text, line)


def _flow(text: str, pos: int, line: int) -> Tuple[list, int]:
    """The flow sequence starting at ``text[pos] == '['``."""
    out: list = []
    i = pos + 1
    expect_item = True
    while True:
        while i < len(text) and text[i] in " \t":
            i += 1
        if i >= len(text):
            _fail(line, "a flow sequence does not end on its line")
        ch = text[i]
        if ch == "]":
            return out, i + 1
        if ch == ",":
            if expect_item:
                _fail(line, "an empty entry in a flow sequence")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            _fail(line, "a missing ',' in a flow sequence")
        if ch in "'\"":
            value, i = _quoted(text, i, line)
        elif ch == "[":
            value, i = _flow(text, i, line)
        elif ch == "{":
            m = re.compile(r"\{\s*\}").match(text, i)
            if not m:
                _fail(line, "flow mappings are outside the subset")
            value, i = {}, m.end()
        else:
            m = re.compile(r"[^,\]\[{}]*").match(text, i)
            word = m.group(0).strip()
            value, i = _plain(word, line), m.end()
        out.append(value)
        expect_item = False


class _Lines:
    """(line number, indent, text) of the meaningful lines; a sequence
    item's text after ``- `` goes back in as a line of its own, at its
    column, so compact mappings and nested items parse as blocks."""

    def __init__(self, text: str):
        self.items: List[Tuple[int, int, str]] = []
        for number, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t") or (body and "\t" in raw[:len(raw) - len(body)]):
                _fail(number, "a tab in the indent")
            body = _strip_comment(body, number)
            if not body:
                continue
            if body == "---" and not self.items:
                continue
            if body in ("---", "..."):
                _fail(number, "several documents are outside the subset")
            self.items.append((number, len(raw) - len(raw.lstrip(" ")), body))
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else None


def _split_key(body: str, line: int):
    """``key: rest`` -> (key, rest), or None when ``body`` is no mapping entry."""
    if body[0] in "'\"":
        key, end = _quoted(body, 0, line)
        rest = body[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    m = re.match(r"([^#'\"\[\]{},][^#]*?)\s*:(?:\s+|$)", body)
    if not m or body.startswith("- ") or body == "-":
        return None
    if m.group(1).startswith("? "):
        _fail(line, "complex keys are outside the subset")
    return _plain(m.group(1), line), body[m.end():].strip()


def _block(lines: _Lines, indent: int) -> Any:
    first = lines.peek()
    number, col, body = first
    if body == "-" or body.startswith("- "):
        return _sequence(lines, col)
    if _split_key(body, number) is not None:
        return _mapping(lines, col)
    lines.pos += 1
    value = _scalar(body, number)
    nxt = lines.peek()
    if nxt is not None and nxt[1] > indent:
        _fail(nxt[0], "a plain scalar over several lines is outside the subset")
    return value


def _value_after_key(lines: _Lines, key_col: int, rest: str, number: int) -> Any:
    if rest:
        value = _scalar(rest, number)
        nxt = lines.peek()
        if nxt is not None and nxt[1] > key_col:
            _fail(nxt[0], "a plain scalar over several lines is outside the subset")
        return value
    nxt = lines.peek()
    if nxt is None:
        return None
    n_number, n_col, n_body = nxt
    if n_col > key_col or (n_col == key_col and (n_body == "-" or n_body.startswith("- "))):
        return _block(lines, key_col)
    return None


def _mapping(lines: _Lines, col: int) -> dict:
    out: dict = {}
    while True:
        item = lines.peek()
        if item is None or item[1] < col:
            return out
        number, icol, body = item
        if icol > col:
            _fail(number, "unexpected indent")
        split = _split_key(body, number)
        if split is None:
            if body == "-" or body.startswith("- "):
                return out   # the sequence of an enclosing key at this indent
            _fail(number, f"expected 'key: value', got {body!r}")
        key, rest = split
        lines.pos += 1
        out[key] = _value_after_key(lines, col, rest, number)


def _sequence(lines: _Lines, col: int) -> list:
    out: list = []
    while True:
        item = lines.peek()
        if item is None or item[1] < col:
            return out
        number, icol, body = item
        if icol > col:
            _fail(number, "unexpected indent")
        if not (body == "-" or body.startswith("- ")):
            return out
        rest = body[1:].lstrip(" ")
        if not rest:
            lines.pos += 1
            nxt = lines.peek()
            out.append(_block(lines, col) if nxt is not None and nxt[1] > col else None)
            continue
        # the item's text becomes a line at its own column
        lines.items[lines.pos] = (number, col + len(body) - len(rest), rest)
        out.append(_block(lines, col))


def loads(text: str) -> Any:
    """Parse one YAML document of the subset."""
    lines = _Lines(text)
    if lines.peek() is None:
        return None
    value = _block(lines, -1)
    rest = lines.peek()
    if rest is not None:
        _fail(rest[0], f"unexpected {rest[2]!r}")
    return value


def load(path) -> Any:
    with open(path) as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# writer

def _needs_quotes(text: str) -> bool:
    if text != text.strip() or not text or "\n" in text or "\t" in text:
        return True
    try:
        if _plain(text, 0) != text:
            return True
    except ValueError:
        return True
    return (text[0] in "'\"[]{},#&*!|>%@`-?:" or ": " in text or " #" in text
            or text.endswith(":") or any(ch in text for ch in ",[]{}"))


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e")   # yaml's float needs a dot
        return text
    if isinstance(value, str):
        if _needs_quotes(value):
            return "'" + value.replace("'", "''") + "'"
        return value
    raise ValueError(f"yaml_lite: cannot write a {type(value).__name__}")


def _block_lines(value: Any) -> List[str]:
    """``value``'s lines at column 0: a mapping's nested mapping indented
    by 2, its sequence at the key's column; a sequence item's block after
    its ``- ``."""
    if isinstance(value, dict) and value:
        lines = []
        for key in sorted(value, key=str):
            head = _dump_scalar(key) + ":"
            item = value[key]
            if isinstance(item, dict) and item:
                lines += [head] + ["  " + line for line in _block_lines(item)]
            elif isinstance(item, (list, tuple)) and item:
                lines += [head] + _block_lines(item)
            else:
                lines.append(head + " " + _dump_inline(item))
        return lines
    if isinstance(value, (list, tuple)) and value:
        lines = []
        for item in value:
            if isinstance(item, (dict, list, tuple)) and item:
                sub = _block_lines(item)
                lines += ["- " + sub[0]] + ["  " + line for line in sub[1:]]
            else:
                lines.append("- " + _dump_inline(item))
        return lines
    return [_dump_inline(value)]


def _dump_inline(value: Any) -> str:
    if isinstance(value, dict):
        if value:
            raise ValueError("yaml_lite: a mapping cannot be written inline")
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_dump_inline(v) for v in value) + "]"
    return _dump_scalar(value)


def dumps(value: Any) -> str:
    """``value`` (nested dicts, lists, and the subset's scalars) in block
    style with sorted keys, as ``yaml.safe_dump`` lays it out."""
    return "\n".join(_block_lines(value)) + "\n"


def dump(value: Any, path) -> None:
    with open(path, "w") as f:
        f.write(dumps(value))
