"""from_json -> MAP<STRING, STRING> (the mainline ``map_utils``).

Port of ``spark_rapids_jni_tpu/ops/map_utils.py``, the backend of
Spark's ``from_json(col, 'map<string,string>')``:

- each row must be one JSON object; anything else (arrays, scalars,
  malformed JSON, trailing garbage) nulls the row (Spark PERMISSIVE);
- keys are the unescaped strings; duplicate keys are kept in order;
- scalar values: strings unescaped, numbers and booleans as their raw
  text, JSON ``null`` a NULL value;
- nested object and array values keep their raw JSON text.

A MAP column is ``LIST<STRUCT<key STRING, value STRING>>``, the
Arrow/cudf map layout; ``map_keys``/``map_values`` are its flat
children. As in the reference, the tokenizer walks each row on the
host (``get_json_object``'s cursor), counted as
``map_utils.host_tokenizer_rows``, and ``get_map_value`` looks values
up row by row there; the columns live on the column's device, and the
row validity is packed by ``bitmask.pack`` (K3 on the card).
"""

from __future__ import annotations

import json
import re
from typing import Optional

import numpy as np
import torch

from ..columnar import Column, bitmask
from ..types import INT32, LIST, STRUCT, TypeId
from ..utils.errors import expects
from ..obs import count, traced
from .get_json_object import _Cursor, _skip_string, _skip_value

# JSON scalar grammar for non-string values: number, true, false
_SCALAR_RE = re.compile(
    r"-?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?$|true$|false$")


def _parse_string(c: _Cursor) -> Optional[str]:
    """The JSON string at the cursor, unescaped (None if malformed)."""
    start = c.p
    _skip_string(c)
    if not c.ok:
        return None
    try:
        return json.loads(c.s[start:c.p])
    except json.JSONDecodeError:  # malformed input is a data value
        c.ok = False
        return None


def _parse_value(c: _Cursor):
    """(ok, value) of the value at the cursor: a string unescaped, a
    nested value's raw text, a scalar's text, None for ``null``."""
    if not c.eof() and c.s[c.p] == '"':
        val = _parse_string(c)
        return val is not None, val
    vstart = c.p
    _skip_value(c)
    if not c.ok:
        return False, None
    raw = c.s[vstart:c.p].strip()
    if raw == "null":
        return True, None
    if raw and raw[0] in "{[":
        return True, raw  # nested: raw JSON text verbatim
    # any other token is invalid (Spark PERMISSIVE: a null row)
    return bool(_SCALAR_RE.match(raw)), raw


def _parse_object(s: str):
    """One row -> list of (key, value or None), or None if malformed."""
    c = _Cursor(s)
    c.ws()
    if c.eof() or c.s[c.p] != "{":
        return None
    c.p += 1
    pairs = []
    c.ws()
    if not c.eof() and c.s[c.p] == "}":
        c.p += 1
    else:
        while True:
            c.ws()
            key = _parse_string(c)
            if key is None:
                return None
            c.ws()
            if c.eof() or c.s[c.p] != ":":
                return None
            c.p += 1
            c.ws()
            ok, val = _parse_value(c)
            if not ok:
                return None
            pairs.append((key, val))
            c.ws()
            if c.eof():
                return None
            if c.s[c.p] == ",":
                c.p += 1
                continue
            if c.s[c.p] == "}":
                c.p += 1
                break
            return None
    c.ws()
    if not c.eof():
        return None  # trailing garbage
    return pairs


@traced("map_utils.from_json_to_map")
def from_json_to_map(col: Column) -> Column:
    """JSON-object STRING column -> MAP (LIST<STRUCT<STRING, STRING>>)."""
    expects(col.dtype.id == TypeId.STRING, "from_json_to_map needs STRING")
    count("map_utils.host_tokenizer_rows", col.size)
    dev = col.device
    offsets = np.zeros(col.size + 1, np.int32)
    valid = np.ones(col.size, bool)
    keys: list = []
    vals: list = []
    for i, s in enumerate(col.to_pylist()):
        pairs = _parse_object(s) if s is not None else None
        if pairs is None:
            valid[i] = False
            pairs = []
        keys += [k for k, _ in pairs]
        vals += [v for _, v in pairs]
        offsets[i + 1] = offsets[i] + len(pairs)
    struct = Column(STRUCT, len(keys), None, children=(
        Column.strings_from_list(keys, device=dev),
        Column.strings_from_list(vals, device=dev)),
        field_names=("key", "value"))
    vmask = None if valid.all() else bitmask.pack(
        torch.from_numpy(valid).to(dev))
    return Column(LIST, col.size, None, vmask, children=(
        Column(INT32, col.size + 1, torch.from_numpy(offsets).to(dev)),
        struct))


@traced("map_utils.map_keys")
def map_keys(map_col: Column) -> Column:
    """The flat key STRING column of a map column."""
    expects(map_col.dtype.id == TypeId.LIST, "map column expected")
    return map_col.child.children[0]


@traced("map_utils.map_values")
def map_values(map_col: Column) -> Column:
    """The flat value STRING column of a map column."""
    expects(map_col.dtype.id == TypeId.LIST, "map column expected")
    return map_col.child.children[1]


def _host_view(map_col: Column):
    return (map_col.offsets.data.cpu().numpy(),
            map_keys(map_col).to_pylist(), map_values(map_col).to_pylist(),
            map_col.valid_bool().cpu().numpy())


@traced("map_utils.map_to_pylist")
def map_to_pylist(map_col: Column) -> list:
    """Host view: one dict per row (None for null rows; duplicate keys
    keep the LAST occurrence, as a dict does)."""
    offs, k, v, valid = _host_view(map_col)
    return [{k[j]: v[j] for j in range(offs[i], offs[i + 1])}
            if valid[i] else None for i in range(map_col.size)]


@traced("map_utils.get_map_value")
def get_map_value(map_col: Column, key: str) -> Column:
    """map[key] lookup -> STRING column (first matching key per row;
    NULL for a null row, a missing key or a null value)."""
    expects(map_col.dtype.id == TypeId.LIST, "map column expected")
    offs, k, v, valid = _host_view(map_col)
    out: list = []
    for i in range(map_col.size):
        found = None
        if valid[i]:
            for j in range(offs[i], offs[i + 1]):
                if k[j] == key:
                    found = v[j]
                    break
        out.append(found)
    return Column.strings_from_list(out, device=map_col.device)
