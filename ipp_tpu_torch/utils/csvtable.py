"""The tables of the marker and SWC utilities without pandas.

`utils/markers.py` and `utils/reconops.py` read Vaa3D ``.marker``,
``.apo``, SWC / ESWC and recut seed files and write them back.  The JAX
package does that through ``pandas.read_csv`` / ``DataFrame.to_csv``; the
card's host is not promised pandas, so the port reads and writes them
here, into and out of numpy **structured arrays**: one field for each of
the frame's columns, in its order, with the dtype pandas infers (int64,
uint64, float64 or bool; an object field of ``str`` / NaN where pandas
gives a string column, and of Python ints or bools with NaN where it
gives an object column).

Only what those callers use is covered, and it behaves as pandas 3's C
parser does (each rule below was read off its output):

- ``sep=","`` or whitespace (``sep=None``: runs of spaces and tabs);
  quoting with ``"`` and doubled quotes; ``\\n``, ``\\r\\n`` and ``\\r``
  end lines; a UTF-8 byte-order mark is dropped;
- ``comment``: a line that starts with it is skipped, elsewhere it ends
  the line (with ``","``, a field opened by a separator before it stays,
  empty); lines of only spaces and tabs are skipped; with whitespace, a
  line of blanks and a comment is a row of NaN;
- a header row (empty names become ``Unnamed: i``, repeated ones
  ``name.1``...), ``names=`` (extra fields dropped, as with
  ``index_col=False``) or neither (columns ``"0"``, ``"1"``...); a row with
  more fields than the header and the first row have raises, a shorter
  one is padded with NaN; a first row longer than the header holds an
  implicit index, which is dropped;
- the 19 default NA strings, quoted or not;
- per column: int64; on overflow uint64, or Python ints, or the raw
  strings, as pandas falls back; else float64 by pandas' "precise"
  xstrtod (`parse_float`), with inf spelled out; else bool from
  True / TRUE / true and False / FALSE / false (with NaN: an object
  field); else strings;
- writing: floats as numpy's ``astype(str)`` gives them (``repr``), NaN
  as an empty field, minimal quoting, ``\\n`` at the end of each line.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["NA_VALUES", "ParserError", "read_csv", "parse_float", "columns",
           "table", "assign", "select", "concat", "drop_duplicates",
           "to_int", "rows", "write_csv"]

NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_TRUE = frozenset(["True", "TRUE", "true"])
_FALSE = frozenset(["False", "FALSE", "false"])
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
        "infinity": math.inf, "+infinity": math.inf,
        "-infinity": -math.inf}
_SPACE = " \t\n\v\f\r"
_INT = re.compile(r"[ \t\n\v\f\r]*([+-]?[0-9]+)[ \t\n\v\f\r]*\Z")
_FLOAT = re.compile(r"[ \t\n\v\f\r]*([+-]?)([0-9]*)(?:\.([0-9]*))?"
                    r"(?:[eE]([+-]?[0-9]+))?[ \t\n\v\f\r]*\Z")
_E = [float(f"1e{k}") for k in range(309)]
_I64 = (-(1 << 63), (1 << 63) - 1)
_MAX_DIGITS = 17


class ParserError(ValueError):
    """A row with more fields than the table has columns."""


def parse_float(tok: str) -> Optional[float]:
    """pandas' "precise" xstrtod: the value of `tok`, None if it is no
    number.  Up to 17 digits, leading zeros included, are summed as
    ``n = n * 10 + d`` in a double (integer digits past them raise the
    exponent, fraction digits past them are dropped), then scaled by one
    multiplication or division by a power of ten from a table (two below
    1e-308).  So it differs from ``float()`` in the last bit now and
    then, and reads 0.000000000000000012345 as 0."""
    m = _FLOAT.match(tok)
    if m is None:
        low = tok.lower()
        return _INF.get(low)
    sign, ip, fp, ex = m.groups()
    fp = fp or ""
    if not ip and not fp:
        return None
    exponent = 0
    if len(ip) > _MAX_DIGITS:
        exponent += len(ip) - _MAX_DIGITS
        ip = ip[:_MAX_DIGITS]
    fp = fp[:_MAX_DIGITS - len(ip)]
    exponent -= len(fp)
    digits = ip + fp
    if len(digits) <= 15:              # n * 10 + d is exact below 2**53
        number = float(int(digits))
    else:
        number = 0.0
        for d in digits:
            number = number * 10.0 + (ord(d) - 48)
    if sign == "-":
        number = -number
    if ex is not None:
        exponent += int(ex)
    if exponent > 308:
        return 0.0 if number == 0 else math.copysign(math.inf, number)
    if exponent > 0:
        return number * _E[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _E[-308 - exponent] / _E[308]
    return number / _E[-exponent]


# -- reading -----------------------------------------------------------------

def _lines(text: str):
    """(line, terminator) pairs; the last line may have none."""
    parts = re.split(r"(\r\n|\r|\n)", text)
    for k in range(0, len(parts), 2):
        term = parts[k + 1] if k + 1 < len(parts) else ""
        if parts[k] or term:
            yield parts[k], term


def _records(text: str, sep: Optional[str], comment: Optional[str]):
    """(file line, fields) of every row, as pandas' tokenizer cuts them."""
    ws = sep is None
    lines = list(_lines(text))
    i = 0
    while i < len(lines):
        line, term = lines[i]
        lineno = i + 1
        i += 1
        if not line.strip(" \t"):
            continue
        if comment and line[0] == comment:
            continue
        if '"' not in line:
            if comment:
                cut = line.find(comment)
                if cut >= 0:
                    line = line[:cut]
            if ws:
                line = line.strip(" \t")
                yield lineno, re.split("[ \t]+", line) if line else []
            else:
                yield lineno, line.split(sep)
            continue
        fields, i = _quoted(lines, i - 1, sep, comment)
        yield lineno, fields


def _quoted(lines, i, sep, comment):
    """The fields of the row that starts at lines[i], which holds a quote;
    a quoted field may run on over line ends.  Returns (fields, index of
    the next line)."""
    ws = sep is None
    fields: List[str] = []
    cur: List[str] = []
    opened = not ws          # with ",", a row opens its first field at once
    quoted = False           # inside quotes
    after = False            # just past a closing quote
    fresh = True             # the open field has no characters yet
    line, term = lines[i]
    i += 1
    pos = 0
    while True:
        if pos == len(line):
            if quoted:       # the quoted field runs on
                cur.append(term)
                if i == len(lines):
                    break
                line, term = lines[i]
                i += 1
                pos = 0
                continue
            break
        c = line[pos]
        pos += 1
        if quoted:
            if c == '"':
                quoted, after = False, True
            else:
                cur.append(c)
            continue
        if after and c == '"':                 # a doubled quote
            cur.append('"')
            quoted, after = True, False
            continue
        after = False
        if comment and c == comment:
            break
        if ws and c in " \t":
            if opened:
                fields.append("".join(cur))
                cur, opened = [], False
            continue
        if not ws and c == sep:
            fields.append("".join(cur))
            cur, fresh = [], True
            continue
        if not opened:
            opened, fresh = True, True
        if fresh and c == '"':
            quoted, fresh = True, False
            continue
        fresh = False
        cur.append(c)
    if opened:
        fields.append("".join(cur))
    return fields, i


def _mangle(names: Sequence[str]) -> List[str]:
    """pandas' header names: '' -> 'Unnamed: i', repeats -> 'x.1', ..."""
    names = [n if n else f"Unnamed: {k}" for k, n in enumerate(names)]
    counts: dict = {}
    out = []
    for col in names:
        cur = counts.get(col, 0)
        while cur > 0:
            counts[col] = cur + 1
            col = f"{col}.{cur}"
            cur = counts.get(col, 0)
        out.append(col)
        counts[col] = cur + 1
    return out


def _ints(tokens, na):
    """int64 scan: ('ok', values), ('na', values with 0 at NA) when every
    token is an integer but some are NA, (None, None) at a token that is
    no integer, ('overflow', None) at one past int64 before that."""
    vals = []
    seen_na = False
    for t, isna in zip(tokens, na):
        if isna:
            seen_na = True
            vals.append(0)
            continue
        m = _INT.match(t)
        if m is None:
            return None, None
        v = int(m.group(1))
        if not _I64[0] <= v <= _I64[1]:
            return "overflow", None
        vals.append(v)
    return ("na" if seen_na else "ok"), vals


def _uints(tokens, na):
    """pandas' uint64 scan after an int64 overflow: 'ok' (values), None (a
    token that is no integer), 'conflict' (NA or a negative beside a value
    past int64), 'overflow' (a value past uint64, or negatives only)."""
    vals = []
    seen_na = seen_neg = seen_big = False
    for t, isna in zip(tokens, na):
        if isna:
            seen_na = True
            vals.append(0)
            continue
        if t.lstrip(_SPACE)[:1] == "-":   # any "-..." counts as negative
            seen_neg = True
            vals.append(0)
            continue
        m = _INT.match(t)
        if m is None:
            return None, None
        v = int(m.group(1))
        if v >= 1 << 64:
            return "overflow", None
        seen_big |= v > _I64[1]
        vals.append(v)
    if seen_big and (seen_neg or seen_na):
        return "conflict", None
    if seen_neg:
        return "overflow", None
    return "ok", vals


def _column(tokens: List[str], na: List[bool]) -> np.ndarray:
    """One column's values, typed as pandas infers them."""
    n = len(tokens)
    kind, vals = _ints(tokens, na)
    if kind == "ok":
        return np.array(vals, np.int64)
    if kind == "na":             # the integers as doubles, NaN at NA
        out = np.array(vals, np.int64).astype(np.float64)
        out[np.asarray(na)] = math.nan
        return out
    if kind == "overflow":
        kind, vals = _uints(tokens, na)
        if kind == "ok":
            return np.array(vals, np.uint64)
        if kind == "conflict":                  # the raw strings, NA kept
            return _objects(tokens)
        if kind == "overflow":                  # Python ints, else strings
            out = _objects([math.nan] * n)
            for k, (t, isna) in enumerate(zip(tokens, na)):
                if isna:
                    continue
                m = _INT.match(t)
                if m is None:
                    return _objects(tokens)
                out[k] = int(m.group(1))
            return out
    floats = np.empty(n, np.float64)
    for k, (t, isna) in enumerate(zip(tokens, na)):
        if isna:
            floats[k] = math.nan
            continue
        v = parse_float(t)
        if v is None:
            break
        floats[k] = v
    else:
        return floats
    if all(isna or t in _TRUE or t in _FALSE for t, isna in zip(tokens, na)):
        if not any(na):
            return np.array([t in _TRUE for t in tokens], bool)
        return _objects([math.nan if isna else t in _TRUE
                         for t, isna in zip(tokens, na)])
    return _objects([math.nan if isna else t for t, isna in zip(tokens, na)])


def _objects(values) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = list(values)
    return out


def read_csv(path, sep: Optional[str] = ",", comment: Optional[str] = None,
             header: bool = True, names: Optional[Sequence[str]] = None,
             index_col: Optional[int] = None) -> np.ndarray:
    """The table in `path` as a structured array (see the module's
    docstring).  `sep` None splits on runs of spaces and tabs; `names`
    replaces the header row; `index_col=0` with `names` reads as pandas'
    ``index_col=0`` followed by ``reset_index()``: the same columns, and a
    leading ``index`` column where the first row has one field more than
    `names`."""
    with open(path, "rb") as f:
        text = f.read().decode("utf-8")
    if text.startswith("﻿"):
        text = text[1:]
    recs = list(_records(text, sep, comment))
    skip = 0
    from_header = names is None and header
    if names is not None:
        names = [str(n) for n in names]
        if len(set(names)) != len(names):
            raise ValueError("Duplicate names are not allowed.")
        width = len(names)
        body = recs
    elif header:
        if not recs:
            raise ValueError("No columns to parse from file")
        names = _mangle(recs[0][1])
        width = len(names)
        body = recs[1:]
    else:
        if not recs:
            raise ValueError("No columns to parse from file")
        width = len(recs[0][1])
        names = [str(k) for k in range(width)]
        body = recs
    first = len(body[0][1]) if body else 0
    expected = max(width, first)
    if first > width:
        if from_header:                         # an implicit index
            skip = first - width
        elif index_col == 0:
            if first > width + 1:
                raise ParserError(
                    "Could not construct index. Requested to use 1 number "
                    f"of columns, but {first - width} left to parse.")
            names = ["index"] + names
            width += 1
    cols: List[List[str]] = [[] for _ in range(width)]
    for lineno, fields in body:
        if len(fields) > expected:
            raise ParserError(f"Error tokenizing data. C error: Expected "
                              f"{expected} fields in line {lineno}, saw "
                              f"{len(fields)}")
        fields = fields[skip:skip + width]
        fields += [""] * (width - len(fields))
        for c, tok in zip(cols, fields):
            c.append(tok)
    arrays = []
    for tokens in cols:
        if not tokens:
            arrays.append(np.empty(0, object))
            continue
        arrays.append(_column(tokens, [t in NA_VALUES for t in tokens]))
    return table(names, arrays)


# -- tables ------------------------------------------------------------------

def columns(t) -> List[str]:
    """The column names of a structured array or a mapping of columns."""
    if isinstance(t, np.ndarray):
        return list(t.dtype.names or ())
    return list(t.keys())


def column(t, name) -> np.ndarray:
    """One column; a missing one raises KeyError, as a frame's does."""
    if name not in columns(t):
        raise KeyError(name)
    return np.asarray(t[name])


def table(names: Sequence[str], arrays: Sequence) -> np.ndarray:
    """A structured array from columns of equal length (scalars are
    broadcast)."""
    arrays = [np.asarray(a) for a in arrays]
    n = max((a.shape[0] for a in arrays if a.ndim), default=1)
    out = np.empty(n, [(str(k), a.dtype) for k, a in zip(names, arrays)])
    for k, a in zip(names, arrays):
        out[str(k)] = a
    return out


def assign(t, name: str, values) -> np.ndarray:
    """`t` with column `name` set to `values` (a new column goes last),
    each column keeping its dtype unless it is the one replaced."""
    names = columns(t)
    arrays = [column(t, k) for k in names]
    values = np.asarray(values)
    if values.dtype.kind == "U":                # pandas' str: objects
        values = values.astype(object)
    if values.ndim == 0:
        values = np.full(len(t), values[()], values.dtype)
    if name in names:
        arrays[names.index(name)] = values
    else:
        names.append(name)
        arrays.append(values)
    return table(names, arrays)


def select(t, names: Sequence[str]) -> np.ndarray:
    """The columns `names` of `t`, in that order (KeyError if one is
    missing)."""
    return table(names, [column(t, k) for k in names])


def _common(dtypes) -> np.dtype:
    if len(set(dtypes)) == 1:
        return dtypes[0]
    if all(d.kind in "biuf" for d in dtypes):
        return np.result_type(*dtypes)
    return np.dtype(object)


def concat(tables: Sequence[np.ndarray]) -> np.ndarray:
    """Rows of `tables` one after the other (``pd.concat(...,
    ignore_index=True)``): columns by name in order of appearance, a
    column missing from a table NaN there, mixed numbers promoted as numpy
    does and anything else mixed to objects."""
    if not tables:
        raise ValueError("No objects to concatenate")
    names: List[str] = []
    for t in tables:
        names += [k for k in columns(t) if k not in names]
    arrays = []
    for k in names:
        parts = [t[k] if k in columns(t) else np.full(len(t), math.nan)
                 for t in tables]
        dt = _common([p.dtype for p in parts])
        if dt == object:
            parts = [_objects(p.tolist()) for p in parts]
        arrays.append(np.concatenate([p.astype(dt) for p in parts])
                      if parts else np.empty(0, dt))
    return table(names, arrays)


def _key(v):
    if isinstance(v, float) and v != v:
        return _key                      # NaN equals NaN
    return v


def drop_duplicates(t: np.ndarray) -> np.ndarray:
    """`t` without rows equal to an earlier one (NaN equal to NaN, -0.0 to
    0.0), the first kept."""
    seen = set()
    keep = np.zeros(len(t), bool)
    for k, row in enumerate(rows(t)):
        key = tuple(_key(v) for v in row)
        if key not in seen:
            seen.add(key)
            keep[k] = True
    return t[keep]


def to_int(values) -> np.ndarray:
    """``astype(int)`` as pandas does it: NaN or inf raise."""
    values = np.asarray(values)
    if values.dtype.kind == "f" and not np.isfinite(values).all():
        raise ValueError("Cannot convert non-finite values (NA or inf) to "
                         "integer")
    return values.astype(np.int64)


def rows(t, names: Optional[Sequence[str]] = None) -> Iterable[tuple]:
    """The rows as tuples of Python scalars (as ``itertuples`` yields
    them)."""
    names = columns(t) if names is None else names
    return zip(*(column(t, k).tolist() for k in names))


# -- writing -----------------------------------------------------------------

def _cells(values: np.ndarray) -> list:
    if values.dtype.kind == "f":
        out = values.astype(str).astype(object)
        out[np.isnan(values)] = ""
        return out.tolist()
    if values.dtype.kind in "biu":
        return values.astype(str).tolist()
    return ["" if v is None or (isinstance(v, float) and v != v) else v
            for v in values.tolist()]


def write_csv(f, t, names: Sequence[str], sep: str = ",") -> None:
    """The columns `names` of `t`, one row a line and no header, as
    ``to_csv(f, sep=sep, header=False, index=False)`` writes them."""
    cells = [_cells(column(t, k)) for k in names]
    csv.writer(f, delimiter=sep, lineterminator="\n",
               quoting=csv.QUOTE_MINIMAL).writerows(zip(*cells))
