"""A reader for the subset of YAML that calibration files and ``--set``
overrides use, giving what ``yaml.safe_load`` gives (the card's machine
has no PyYAML).

The subset: block mappings (``key: value``, nested by indentation of
spaces), comments, and values that are plain, single-quoted or
double-quoted (without escapes) scalars or flow lists of them (``[a, b]``,
nested, over several lines).  Plain scalars resolve by PyYAML's YAML 1.1
rules: null (``~``, ``null``, empty), bool (``true``/``yes``/``on``, ...),
int (decimal, ``0x``, ``0b``, octal ``0..``, sexagesimal, ``_`` separators),
float (a dot is required: ``1e-3`` is a string, ``1.0e-3`` a float;
``.inf``, ``.nan``), else a string.  Anything outside the subset raises
``ValueError``: block sequences (``- x``), flow mappings, anchors, aliases,
tags, block scalars, directives and documents, escapes, timestamps.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# a plain scalar may not start with these (PyYAML's scanner)
_INDICATORS = set("[]{},#&*!|>'\"%@`")


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * int(_sexagesimal(v))
    return sign * int(v)


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v)
    return sign * float(v)


def _plain(text: str) -> Any:
    """Resolve a plain scalar as PyYAML's implicit resolver does."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        raise ValueError(f"{text!r}: timestamps, '=' and '<<' are outside the subset")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a '#' at the start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _quoted(text: str) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"{text!r}: unterminated quoted scalar")
    body = text[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise ValueError(f"{text!r}: stray quote")
        return body.replace("''", "'")
    if "\\" in body or '"' in body:
        raise ValueError(f"{text!r}: escapes in double-quoted scalars are outside the subset")
    return body


def _split_flow(body: str) -> List[str]:
    """Split a flow list's inside on the commas at its own depth."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    items = [s.strip() for s in items]
    if items[-1] == "":  # a trailing comma, or an empty list
        items.pop()
    if any(s == "" for s in items):
        raise ValueError(f"[{body}]: empty entry in a flow list")
    return items


def _value(text: str, flow: bool = False) -> Any:
    text = text.strip()
    if not text:
        return None
    if text[0] == "[":
        if text[-1] != "]":
            raise ValueError(f"{text!r}: unbalanced flow list")
        return [_value(s, flow=True) for s in _split_flow(text[1:-1])]
    if text[0] in "'\"":
        return _quoted(text)
    if text[0] in _INDICATORS or text.startswith(("- ", "? ")) or text in ("-", "?"):
        raise ValueError(f"{text!r}: outside the YAML subset (flow mappings, anchors, "
                         "aliases, tags, block scalars and sequences are not read)")
    if ": " in text or text.endswith(":") or (flow and any(c in text for c in ",[]{}")):
        raise ValueError(f"{text!r}: a mapping or flow indicator inside a plain scalar")
    return _plain(text)


def parse_scalar(text: str) -> Any:
    """One value, as ``yaml.safe_load(text)`` reads a scalar or flow list."""
    return _value(_strip_comment(text))


def _lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of every line that holds more than a
    comment; flow lists spanning lines are joined."""
    out = []
    pending = None  # (number, indent, text) of an open flow list
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {no}: tab indentation")
        body = _strip_comment(raw).rstrip()
        if pending is not None:
            pending = (pending[0], pending[1], pending[2] + " " + body.strip())
            if pending[2].count("[") == pending[2].count("]"):
                out.append(pending)
                pending = None
            continue
        if not body.strip():
            continue
        stripped = body.lstrip()
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise ValueError(f"line {no}: directives and document markers are outside "
                             "the subset")
        item = (no, len(body) - len(stripped), stripped)
        if stripped.count("[") > stripped.count("]"):
            pending = item
        else:
            out.append(item)
    if pending is not None:
        raise ValueError(f"line {pending[0]}: unterminated flow list")
    return out


def _key_value(no: int, content: str) -> Tuple[Any, str]:
    quote = None
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(content) or content[i + 1] == " "):
            key = _value(content[:i])
            if isinstance(key, list):
                raise ValueError(f"line {no}: a list as a mapping key")
            return key, content[i + 1:].strip()
    raise ValueError(f"line {no}: {content!r} is not 'key: value' (block sequences "
                     "and bare scalars are outside the subset)")


def _mapping(lines, at: int, indent: int):
    out = {}
    while at < len(lines):
        no, ind, content = lines[at]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {no}: unexpected indentation")
        key, rest = _key_value(no, content)
        at += 1
        if rest:
            try:
                out[key] = _value(rest)
            except ValueError as e:
                raise ValueError(f"line {no}: {e}") from None
        elif at < len(lines) and lines[at][1] > indent:
            out[key], at = _mapping(lines, at, lines[at][1])
        else:
            out[key] = None
    return out, at


def load(text: str) -> Any:
    """A document of the subset -> its mapping (None when it holds nothing)."""
    lines = _lines(text)
    if not lines:
        return None
    out, at = _mapping(lines, 0, lines[0][1])
    if at != len(lines):
        raise ValueError(f"line {lines[at][0]}: unexpected dedent")
    return out


def load_file(path) -> Any:
    with open(path) as f:
        return load(f.read())
