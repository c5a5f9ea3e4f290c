"""Unit-suffix parsers for CLI arguments.

Behavioural parity with the reference's ``atofs`` / ``atoft`` / ``atofp``
(reference: ``src/convenience/convenience.c:65-136``): a single trailing
suffix character scales the numeric prefix.  Frequency suffixes fall through
multiplicatively (G -> 1e9, M -> 1e6, k -> 1e3), time suffixes give seconds
(h -> 3600, m -> 60, s -> 1), percent gives a fraction.  Any other trailing
character leaves the value unscaled (plain ``atof`` semantics: parse the
longest valid leading float, 0.0 if none).
"""

from __future__ import annotations

import re

_FLOAT_RE = re.compile(r"^\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _atof(s: str) -> float:
    """C ``atof``: parse the longest valid leading float; 0.0 on failure."""
    m = _FLOAT_RE.match(s)
    return float(m.group(0)) if m else 0.0


def _suffixed(s: str, table: dict[str, float]) -> float:
    if not s:
        return 0.0
    mult = table.get(s[-1])
    if mult is None:
        return _atof(s)
    return _atof(s[:-1]) * mult


def atofs(s: str) -> float:
    """Frequency with k/M/G suffix -> Hz (convenience.c:65-90)."""
    return _suffixed(s, {"k": 1e3, "K": 1e3, "m": 1e6, "M": 1e6, "g": 1e9, "G": 1e9})


def atoft(s: str) -> float:
    """Time with s/m/h suffix -> seconds (convenience.c:92-116)."""
    return _suffixed(s, {"s": 1.0, "S": 1.0, "m": 60.0, "M": 60.0, "h": 3600.0, "H": 3600.0})


def atofp(s: str) -> float:
    """Percentage with % suffix -> fraction (convenience.c:118-136)."""
    return _suffixed(s, {"%": 0.01})


def parse_kwargs(s: str) -> dict[str, str]:
    """Parse ``key=val,key=val`` strings (SoapySDRKwargs_fromString analog).

    Used for ``-g LNA=40,VGA=20`` gain element lists and ``-t`` SDR settings
    (convenience.c:299-314, 363-380) and for ``-d`` source query strings.
    Bare tokens (no ``=``) map to empty-string values.
    """
    out: dict[str, str] = {}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
        else:
            out[part] = ""
    return out
