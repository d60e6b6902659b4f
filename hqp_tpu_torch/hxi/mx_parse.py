"""MATLAB-style S-function parameter parsing (Hxi_mx_parse role).

Port of ``hqp_tpu/hxi/mx_parse.py`` (pure Python, no tensors).  The
reference parses the textual S-function arguments of ``mdl_args``-style
configuration into mxArrays (hxi/Hxi_mx_parse.h:44-264): numeric scalars
and bracketed matrices, quoted strings (with quote-on-quote escaping), and
cell arrays kept as unparsed strings, split at top-level commas.  Same
semantics here, to plain Python types: numpy arrays for numerics, ``str``
for strings and ``MxCell`` (a thin str wrapper) for cell arrays.
"""

from __future__ import annotations

import numpy as np


class MxParseError(ValueError):
    pass


class MxCell(str):
    """A cell-array argument kept as its unparsed text (the reference
    stores cells as mxStrings, Hxi_mx_parse.h:202-219)."""


def split_args(s: str):
    """Split ``a, [1 2], 'x,y', {1,2}`` at TOP-LEVEL commas (bracket,
    brace and quote nesting respected; Hxi_mx_parse.h:72-101)."""
    out, depth, i, start, n = [], 0, 0, 0, len(s)
    while i < n:
        c = s[i]
        if c == "'":
            i += 1
            while i < n:
                if s[i] == "'":
                    if i + 1 < n and s[i + 1] == "'":
                        i += 2
                        continue
                    break
                i += 1
            if i >= n:
                raise MxParseError(f"unterminated string in {s!r}")
        elif c in "[{(":
            depth += 1
        elif c in "]})":
            depth -= 1
        elif c == "," and depth == 0:
            out.append(s[start:i].strip())
            start = i + 1
        i += 1
    tail = s[start:].strip()
    if tail or out:
        out.append(tail)
    return out


def parse_argument(arg: str):
    """One argument -> numpy array | str | MxCell
    (Hxi_mx_parse.h:167-263 mx_parse_argument)."""
    s = arg.strip()
    if not s:
        return np.zeros((0, 0))
    if s[0] == "'":
        if len(s) < 2 or s[-1] != "'":
            raise MxParseError(f"unterminated string {arg!r}")
        return s[1:-1].replace("''", "'")
    if s[0] == "{":
        if s[-1] != "}":
            raise MxParseError(f"unterminated cell array {arg!r}")
        return MxCell(s[1:-1])
    if s[0] == "[":
        if s[-1] != "]":
            raise MxParseError(f"unterminated matrix {arg!r}")
        body = s[1:-1].strip()
        if not body:
            return np.zeros((0, 0))
        rows = []
        for rtext in body.replace("\n", ";").split(";"):
            rtext = rtext.strip()
            if not rtext:
                continue
            toks = rtext.replace(",", " ").split()
            rows.append([_num(t, arg) for t in toks])
        width = len(rows[0])
        if any(len(r) != width for r in rows):
            raise MxParseError(f"ragged matrix literal {arg!r}")
        return np.asarray(rows, dtype=np.float64)
    return np.asarray([[_num(s, arg)]], dtype=np.float64)


def _num(tok, arg):
    try:
        return float(tok)
    except ValueError:
        raise MxParseError(f"expected a number, got {tok!r} in {arg!r}")


def parse_args(s: str):
    """Full argument list -> list of parsed values."""
    return [parse_argument(a) for a in split_args(s)]
