"""Reader for the flat control files (``run/control*.yml``).

The control format is one ``key: value`` pair per line, with ``#``
comments and blank lines — the subset of YAML the reference's recipes use.
Values decode as YAML would decode them: ``true``/``false`` to bool,
``null``/``~``/nothing to None, integers and decimal numbers to int and
float, quoted text to str with the quotes removed, anything else to str
(``2019-07`` and paths stay text).  A nested or multi-line value is an
error, not a silent misread.
"""

from __future__ import annotations

import re

__all__ = ["parse_control", "read_control"]

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?[0-9]*\.[0-9]*([eE][-+]?[0-9]+)?$")
_BOOLS = {"true": True, "false": False}
_NULLS = ("", "~", "null")


def _strip_comment(text: str) -> str:
    """Drop a trailing ``# comment`` that sits outside quotes (YAML needs
    whitespace before the ``#``)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _value(raw: str, where: str):
    v = _strip_comment(raw).strip()
    if len(v) >= 2 and v[0] == v[-1] == "'":
        return v[1:-1].replace("''", "'")
    if len(v) >= 2 and v[0] == v[-1] == '"':
        return v[1:-1]
    if v[:1] in ("[", "{", "|", ">", "&", "*", "!", "'", '"'):
        raise ValueError(f"{where}: unsupported control value {v!r} "
                         "(the control format is flat key: value pairs)")
    low = v.lower()
    if low in _NULLS:
        return None
    if low in _BOOLS:
        return _BOOLS[low]
    if _INT.match(v):
        return int(v)
    if _FLOAT.match(v) and any(c.isdigit() for c in v):
        return float(v)
    return v


def parse_control(text: str, name: str = "<control>") -> dict:
    """Decode control-file text into a dict (later keys override earlier
    ones, as in YAML)."""
    out = {}
    for n, line in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        body = _strip_comment(line).rstrip()
        if not body.strip():
            continue
        if body[0] in " \t-":
            raise ValueError(f"{where}: nested or list entries are not part "
                             f"of the control format: {line!r}")
        key, sep, rest = body.partition(":")
        if not sep or not key.strip() or (rest and rest[0] not in " \t"):
            raise ValueError(f"{where}: expected 'key: value', got {line!r}")
        out[key.strip()] = _value(rest, where)
    return out


def read_control(path) -> dict:
    """Read one control file (``control.yml``, ``control_free.yml``, ...)."""
    with open(path, "r") as stream:
        return parse_control(stream.read(), str(path))
