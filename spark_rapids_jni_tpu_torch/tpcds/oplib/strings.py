"""String operators: predicates and dictionary-backed projections for the
fused plan.

Port of ``spark_rapids_jni_tpu/tpcds/oplib/strings.py``. ``rel_from_df``
ingests a string column without nulls dictionary-encoded: int64 codes on
the device and a sorted category array on the host. The predicates take
one of two routes (``SRT_STRING_ROUTE``; ``auto`` picks ``dict``):

- **dict**: the predicate runs once per category on the host, giving an
  (n_categories,) bool look-up table that the rows gather through their
  codes; no per-row byte work on the device. Exact, because the
  dictionary holds every value the column can take.
- **bytes**: the categories' UTF-8 bytes go to the device as an
  (n_categories, max_len) zero-padded matrix; each row gathers its own
  bytes (``mat[codes]``) and the predicate runs as tensor algebra over
  the (N, max_len) row matrix (``ops/string_ops.py``
  ``contains_matrix`` / ``like_matrix`` / ``starts_with_matrix``).

Both routes compile LIKE through ``string_ops.like_tokens``. Routes are
counted ``rel.route.string.<op>.<route>``.

**Projections** (substr / upper / lower / concat / char_length) transform
the dictionary on the host and remap the codes with one device gather:
the output is again a sorted-dictionary column whose range stats hold by
construction, so a groupby on it stays dense. A STRING column (ingested
with nulls: no dictionary) takes the eager ``ops/string_ops.py`` route
(``rel.route.string.<op>.general``), or raises ``FusedFallback`` while
``run_fused`` runs a plan.
"""

from __future__ import annotations

import numpy as np
import torch

from ...columnar import Column
from ...config import string_route
from ...obs import count
from ...ops import string_ops as _sops
from ...types import INT64
from ...utils.device import host_to_device
from .. import rel as _rel
from .registry import operator

# Concatenating two dictionary columns builds the cross product of their
# categories; past this many pairs the operator takes the eager route.
MAX_CONCAT_PAIRS = 1 << 20


def _code_col(n_rows: int, codes: torch.Tensor, n_cats: int) -> Column:
    """A dictionary-code column whose range stats hold by construction
    (the codes come out of a [0, n_cats) look-up table)."""
    c = Column(INT64, n_rows, codes, value_range=(0, max(n_cats - 1, 0)))
    return _rel._trust(c)


def _cats(rel, col: str):
    """The host dictionary of ``col``, or None for a STRING column."""
    cats = rel.dicts.get(col)
    return None if cats is None else np.asarray(cats)


def _cat_byte_matrix(cats: np.ndarray):
    """(n_cats, max_len) uint8 zero-padded bytes and (n_cats,) int32
    lengths of the categories."""
    enc = [str(c).encode("utf-8") for c in cats]
    m = max((len(b) for b in enc), default=0) or 1
    mat = np.zeros((len(enc), m), np.uint8)
    lens = np.zeros((len(enc),), np.int32)
    for i, b in enumerate(enc):
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return mat, lens


def _host_like(s: str, pattern: str, escape: str = "\\") -> bool:
    """LIKE over one host string through the same token grammar as the
    device DP (``string_ops.like_tokens``); ``_`` consumes one character
    (a lead byte and its continuation bytes), as ``like_matrix`` does."""
    toks = _sops.like_tokens(pattern, escape)
    b = s.encode("utf-8")
    starts = {0}
    for t in toks:
        if t[0] == "%":
            starts = set(range(min(starts), len(b) + 1)) if starts else set()
        elif t[0] == "_":
            nxt = set()
            for p in starts:
                if p < len(b):
                    q = p + 1
                    while q < len(b) and (b[q] & 0xC0) == 0x80:
                        q += 1
                    nxt.add(q)
            starts = nxt
        else:
            starts = {p + 1 for p in starts
                      if p < len(b) and b[p] == t[1]}
    return len(b) in starts


def _general(rel, col: str, opname: str):
    """The STRING column for the eager route, counted; FusedFallback
    while a fused plan runs."""
    if _rel._FUSED_TRACING:
        raise _rel.FusedFallback(
            f"string.{opname} on non-dictionary column {col!r}")
    count(f"rel.route.string.{opname}.general")
    return rel.col(col)


def _predicate(rel, col: str, opname: str, host_fn, device_fn):
    """The predicates' skeleton: the dictionary look-up table or the
    device bytes over the codes; the eager host evaluation on a STRING
    column (nulls read False). Returns an (N,) bool vector over the
    rel's physical rows, for ``rel.filter``."""
    cats = _cats(rel, col)
    if cats is None:
        c = _general(rel, col, opname)
        vals = c.to_pylist()
        hit = np.fromiter((v is not None and bool(host_fn(v)) for v in vals),
                          np.bool_, count=len(vals))
        return host_to_device(hit, c.device)
    codes = rel.col(col).data
    dev = codes.device
    if string_route() == "bytes":
        count(f"rel.route.string.{opname}.bytes")
        mat, lens = _cat_byte_matrix(cats)
        return device_fn(host_to_device(mat, dev)[codes],
                         host_to_device(lens, dev)[codes])
    count(f"rel.route.string.{opname}.dict")
    lut = np.fromiter((host_fn(str(c)) for c in cats), np.bool_,
                      count=len(cats))
    return host_to_device(lut, dev)[codes]


# -- oracles (pandas Series -> Series) -------------------------------------

def contains_oracle(s, pattern):
    return s.str.contains(pattern, regex=False)


def starts_with_oracle(s, prefix):
    return s.str.startswith(prefix)


def like_oracle(s, pattern, escape="\\"):
    return s.map(lambda v: _host_like(str(v), pattern, escape))


def substr_oracle(s, start, length):
    return s.str.slice(start, start + length)


def upper_oracle(s):
    return s.str.upper()


def lower_oracle(s):
    return s.str.lower()


def concat_oracle(a, b, sep=""):
    return a.astype(str) + sep + b.astype(str)


def char_length_oracle(s):
    return s.str.len().astype("int64")


# -- predicates ------------------------------------------------------------

@operator("string.contains", mask_class="rowwise", partition="local",
          oracle=contains_oracle, params=("SRT_STRING_ROUTE",))
def contains(rel, col: str, pattern: str):
    """Literal substring predicate -> (N,) bool (pandas
    ``.str.contains(regex=False)``, Spark ``Contains``)."""
    pat = pattern.encode("utf-8")
    return _predicate(
        rel, col, "contains", lambda s: pattern in s,
        lambda mat, lens: _sops.contains_matrix(mat, lens, pat))


@operator("string.starts_with", mask_class="rowwise", partition="local",
          oracle=starts_with_oracle, params=("SRT_STRING_ROUTE",))
def starts_with(rel, col: str, prefix: str):
    """Prefix predicate -> (N,) bool (Spark ``StartsWith``)."""
    pat = prefix.encode("utf-8")
    return _predicate(
        rel, col, "starts_with", lambda s: s.startswith(prefix),
        lambda mat, lens: _sops.starts_with_matrix(mat, lens, pat))


@operator("string.like", mask_class="rowwise", partition="local",
          oracle=like_oracle, params=("SRT_STRING_ROUTE",))
def like(rel, col: str, pattern: str, escape: str = "\\"):
    """SQL LIKE predicate -> (N,) bool: ``%`` any sequence, ``_`` one
    character, whole-string match."""
    return _predicate(
        rel, col, "like", lambda s: _host_like(s, pattern, escape),
        lambda mat, lens: _sops.like_matrix(mat, lens, pattern, escape))


# -- projections -----------------------------------------------------------

def _factorize(values):
    """Sorted unique categories and an int64 code per value."""
    arr = np.asarray(["" if v is None else v for v in values], object)
    cats, codes = np.unique(arr, return_inverse=True)
    return cats, codes.astype(np.int64).reshape(-1)


def _with_dict(rel, out: str, col: Column, cats) -> "_rel.Rel":
    res = rel.with_column(out, col)
    res.dicts[out] = cats
    return res


def _general_codes(rel, out: str, values, validity, dev):
    """The eager route's result: the values factorized on the host, the
    code column carrying the source's validity (NULL in, NULL out)."""
    cats, codes = _factorize(values)
    return _with_dict(rel, out, Column(INT64, rel.num_rows,
                                       host_to_device(codes, dev),
                                       validity=validity), cats)


def _remap_dict(rel, col: str, out: str, transform, opname: str):
    """A dictionary-transform projection: ``transform`` the host
    categories, sort and deduplicate them into a new dictionary (code
    order stays string order), remap the codes with one device gather."""
    cats = _cats(rel, col)
    if cats is None:
        src = _general(rel, col, opname)
        return _general_codes(rel, out, [None if v is None else transform(v)
                                         for v in src.to_pylist()],
                              src.validity, src.device)
    count(f"rel.route.string.{opname}.dict")
    new_cats, remap = _factorize([transform(str(c)) for c in cats])
    codes = rel.col(col).data
    new_codes = host_to_device(remap, codes.device)[codes]
    return _with_dict(rel, out, _code_col(rel.num_rows, new_codes,
                                          len(new_cats)), new_cats)


@operator("string.substr", mask_class="rowwise", partition="local",
          oracle=substr_oracle, params=("SRT_STRING_ROUTE",))
def substr(rel, col: str, start: int, length: int, out: str):
    """Character-indexed substring projection (0-based ``start``):
    pandas ``.str.slice(start, start + length)``."""
    return _remap_dict(rel, col, out,
                       lambda s: s[start:start + length], "substr")


@operator("string.upper", mask_class="rowwise", partition="local",
          oracle=upper_oracle, params=("SRT_STRING_ROUTE",))
def upper(rel, col: str, out: str):
    return _remap_dict(rel, col, out, lambda s: s.upper(), "upper")


@operator("string.lower", mask_class="rowwise", partition="local",
          oracle=lower_oracle, params=("SRT_STRING_ROUTE",))
def lower(rel, col: str, out: str):
    return _remap_dict(rel, col, out, lambda s: s.lower(), "lower")


@operator("string.char_length", mask_class="rowwise", partition="local",
          oracle=char_length_oracle, params=("SRT_STRING_ROUTE",))
def char_length(rel, col: str, out: str):
    """Per-row character count -> INT64 column (Spark ``length``)."""
    cats = _cats(rel, col)
    if cats is None:
        c = _sops.char_lengths(_general(rel, col, "char_length"))
        return rel.with_column(out, Column(INT64, rel.num_rows,
                                           c.data.to(torch.int64),
                                           c.validity))
    count("rel.route.string.char_length.dict")
    lut = np.fromiter((len(str(c)) for c in cats), np.int64,
                      count=len(cats))
    codes = rel.col(col).data
    lc = Column(INT64, rel.num_rows, host_to_device(lut, codes.device)[codes],
                value_range=(int(lut.min()) if len(lut) else 0,
                             int(lut.max()) if len(lut) else 0))
    return rel.with_column(out, _rel._trust(lc))


@operator("string.concat", mask_class="rowwise", partition="local",
          oracle=concat_oracle, params=("SRT_STRING_ROUTE",))
def concat(rel, col_a: str, col_b: str, out: str, sep: str = ""):
    """Row-wise concatenation of two dictionary columns: the categories'
    cross product becomes the output dictionary (host) and the row codes
    combine with one gather. Past ``MAX_CONCAT_PAIRS`` pairs, or off a
    dictionary, the eager route."""
    ca, cb = _cats(rel, col_a), _cats(rel, col_b)
    if ca is None or cb is None or len(ca) * max(len(cb), 1) \
            > MAX_CONCAT_PAIRS:
        if _rel._FUSED_TRACING:
            raise _rel.FusedFallback(
                f"string.concat({col_a!r}, {col_b!r}) has no dictionary "
                "route")
        count("rel.route.string.concat.general")
        a, b = rel.col(col_a), rel.col(col_b)
        if sep:
            a = _sops.concat(a, Column.strings_from_list(
                [sep] * rel.num_rows, device=a.device))
        joined = _sops.concat(a, b)
        # either side NULL -> NULL (string_ops.concat's validity)
        return _general_codes(rel, out, joined.to_pylist(),
                              joined.validity, joined.device)
    count("rel.route.string.concat.dict")
    nb = len(cb)
    pairs = [str(a) + sep + str(b) for a in ca for b in cb]
    new_cats, flat = _factorize(pairs)  # flat: (na * nb,) codes
    code_a = rel.col(col_a).data
    code_b = rel.col(col_b).data
    new_codes = host_to_device(flat, code_a.device)[code_a * nb + code_b]
    return _with_dict(rel, out, _code_col(rel.num_rows, new_codes,
                                          len(new_cats)), new_cats)

