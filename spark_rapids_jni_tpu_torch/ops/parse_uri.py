"""parse_url: Spark's ``parse_url(url, part[, key])``.

Port of ``spark_rapids_jni_tpu/ops/parse_uri.py``. Spark's CPU
expression delegates to ``java.net.URI``: an unparsable URI yields NULL
for every part, an absent component yields NULL, and components are
returned raw (no decoding, case preserved). The subset of java.net.URI
reproduced here:

- PROTOCOL: the scheme (``[A-Za-z][A-Za-z0-9+.-]*`` before the first ':').
- AUTHORITY/USERINFO/HOST: only for hierarchical URIs with ``//``; userinfo
  is the part before the LAST '@'; an IPv6 literal keeps its brackets; the
  port is stripped at the last ':' after the host (never inside brackets).
- PATH: for hierarchical URIs (with or without scheme); opaque URIs
  (``mailto:a@b``) have a NULL path, as in Java.
- QUERY: between the first '?' and the fragment; NULL when '?' absent.
  With ``key``: the value of the first ``(^|&)key=value`` match, else NULL.
- REF: the fragment after the first '#'.
- FILE: path plus '?'+query when present.
- Validation: characters Java's URI grammar rejects everywhere (space,
  controls, ``<>"\\^`{}|``) NULL the whole row, as does a '%' not followed
  by two hex digits, or a host containing characters outside the reg-name /
  IP-literal sets.

One byte-matrix pass gives the first and last positions of the
delimiters as per-row scalars (the ``amin``/``amax`` of masked position
grids; no per-row control flow), every part is then a (start, length)
pair, and the substrings are one gather on the column's device.
"""

from __future__ import annotations

import torch

from ..columnar import Column
from ..columnar.strings import byte_matrix, max_length, strings_from_matrix
from ..obs import traced
from ..types import TypeId
from ..utils.errors import expects

_PARTS = ("PROTOCOL", "HOST", "PATH", "QUERY", "REF", "AUTHORITY", "FILE",
          "USERINFO")


def _first_pos(mask, pos, lens):
    """First column where mask is true (per row), else the row's length."""
    m = mask.shape[1]
    first = torch.where(mask, pos, m).amin(dim=1)
    return torch.where(first < m, first, lens)


def _last_pos(mask, pos):
    """Last column where mask is true, else -1."""
    return torch.where(mask, pos, -1).amax(dim=1)


def _in_range(pos_grid, lo, hi):
    return (pos_grid >= lo[:, None]) & (pos_grid < hi[:, None])


def _at(mat, idx):
    m = mat.shape[1]
    return torch.gather(mat, 1, idx.clamp(0, m - 1).to(torch.int64)[:, None]
                        )[:, 0]


def _shifted(mat, k: int):
    """``mat`` moved ``k`` columns left (k > 0) or right, zero-filled."""
    out = torch.zeros_like(mat)
    if k > 0:
        out[:, :-k] = mat[:, k:]
    else:
        out[:, -k:] = mat[:, :k]
    return out


@traced("parse_uri.parse_url")
def parse_url(col: Column, part: str, key: "str | None" = None) -> Column:
    """Extract one URL part from a STRING column (Spark parse_url)."""
    expects(col.dtype.id == TypeId.STRING, "parse_url needs STRING")
    part = part.upper()
    expects(part in _PARTS, f"unknown parse_url part: {part}")
    expects(key is None or part == "QUERY", "key is only valid with QUERY")

    m = max(max_length(col), 1)
    mat, lens = byte_matrix(col, m)
    pos = torch.arange(m, dtype=torch.int32, device=mat.device)[None, :]
    in_str = pos < lens[:, None]

    # ---- global validity (Java URI grammar rejects these anywhere) -----
    bad = (mat <= 0x20) | (mat == 0x7F)
    for c in b'<>"\\^`{}|':
        bad = bad | (mat == c)
    invalid = (bad & in_str).any(dim=1)
    # '%' must be followed by two hex digits
    digit = (mat >= ord("0")) & (mat <= ord("9"))
    is_hex = digit | ((mat >= ord("a")) & (mat <= ord("f"))) | \
        ((mat >= ord("A")) & (mat <= ord("F")))
    pct = (mat == ord("%")) & in_str
    ok_len = (pos + 2) < lens[:, None]
    invalid = invalid | (pct & ~(ok_len & _shifted(is_hex, 1)
                                 & _shifted(is_hex, 2))).any(dim=1)

    # ---- scheme ---------------------------------------------------------
    alpha = ((mat >= ord("a")) & (mat <= ord("z"))) | \
            ((mat >= ord("A")) & (mat <= ord("Z")))
    scheme_ch = alpha | digit | (mat == ord("+")) | (mat == ord(".")) | \
        (mat == ord("-"))
    colon = _first_pos((mat == ord(":")) & in_str, pos, lens)
    slash_first = _first_pos((mat == ord("/")) & in_str, pos, lens)
    q_first = _first_pos((mat == ord("?")) & in_str, pos, lens)
    hash_first = _first_pos((mat == ord("#")) & in_str, pos, lens)
    # a ':' counts as the scheme delimiter only before any '/', '?', '#'
    has_scheme = (colon < lens) & (colon > 0) & (colon < slash_first) & \
        (colon < q_first) & (colon < hash_first)
    scheme_ok = alpha[:, 0] & \
        ~(_in_range(pos, torch.zeros_like(lens), colon) & ~scheme_ch) \
        .any(dim=1)
    invalid = invalid | (has_scheme & ~scheme_ok)

    after_scheme = torch.where(has_scheme, colon + 1, 0)
    # hierarchical with authority: "//" right after the scheme (or at start)
    c1 = _at(mat, after_scheme)
    c2 = _at(mat, after_scheme + 1)
    has_auth = (c1 == ord("/")) & (c2 == ord("/")) & \
        (after_scheme + 1 < lens)
    qh = torch.minimum(q_first, hash_first)
    # opaque: scheme present but what follows isn't '/' (and not empty)
    opaque = has_scheme & ~has_auth & (c1 != ord("/")) & (after_scheme < qh)

    auth_start = after_scheme + 2
    auth_end = torch.where(
        has_auth,
        _first_pos((mat == ord("/")) & _in_range(pos, auth_start, qh), pos,
                   lens),
        auth_start)
    auth_end = torch.minimum(auth_end, qh)

    # ---- userinfo / host / port ----------------------------------------
    at_pos = _last_pos((mat == ord("@")) & _in_range(pos, auth_start,
                                                     auth_end), pos)
    has_user = has_auth & (at_pos >= 0)
    host_start = torch.where(has_user, at_pos + 1, auth_start)
    bracket = _at(mat, host_start) == ord("[")
    rb = _first_pos((mat == ord("]")) & _in_range(pos, host_start, auth_end),
                    pos, lens)
    # a bracket host must close inside the authority, and only ':port' (or
    # nothing) may follow: java.net.URI throws otherwise
    v6_closed = bracket & (rb < auth_end)
    host_end_v6 = torch.minimum(rb + 1, auth_end)
    v6_tail_ok = (host_end_v6 == auth_end) | \
        (_at(mat, host_end_v6) == ord(":"))
    port_colon = _last_pos((mat == ord(":")) & _in_range(
        pos, torch.where(bracket, host_end_v6, host_start), auth_end), pos)
    # with a bracket host the port colon must sit immediately after ']'
    v6_port_ok = (port_colon < 0) | (port_colon == host_end_v6)
    host_end = torch.where(bracket, host_end_v6,
                           torch.where(port_colon >= 0, port_colon, auth_end))

    # host charset: reg-name (alnum . - _ ~ %) or [IPv6]
    host_ch = alpha | digit | (mat == ord(".")) | (mat == ord("-")) | \
        (mat == ord("_")) | (mat == ord("~")) | (mat == ord("%"))
    v6_ch = is_hex | (mat == ord(":")) | (mat == ord(".")) | \
        (mat == ord("[")) | (mat == ord("]"))
    in_host = _in_range(pos, host_start, host_end)
    host_invalid = (in_host & ~torch.where(bracket[:, None], v6_ch, host_ch)
                    ).any(dim=1)
    # the port must be digits
    in_port = _in_range(pos, torch.where(port_colon >= 0, port_colon + 1,
                                         auth_end), auth_end)
    host_invalid = host_invalid | (in_port & ~digit).any(dim=1)
    host_invalid = host_invalid | (bracket & ~(v6_closed & v6_tail_ok &
                                               v6_port_ok))
    invalid = invalid | (has_auth & host_invalid)
    has_host = has_auth & (host_end > host_start) & ~host_invalid

    # ---- path / query / ref --------------------------------------------
    path_start = torch.where(has_auth, auth_end,
                             torch.where(opaque, lens, after_scheme))
    # java.net.URI only parses a query on hierarchical URIs; an opaque
    # URI's '?...' is part of the scheme-specific part (Spark: NULL)
    has_query = (q_first < torch.minimum(lens, hash_first)) & ~opaque
    has_ref = hash_first < lens
    query_start = torch.minimum(q_first + 1, lens)
    query_end = hash_first
    ref_start = torch.minimum(hash_first + 1, lens)

    if part == "PROTOCOL":
        starts, ends, present = torch.zeros_like(lens), colon, has_scheme
    elif part == "AUTHORITY":
        starts, ends, present = auth_start, auth_end, has_auth
    elif part == "USERINFO":
        starts, ends, present = auth_start, at_pos.clamp(min=0), has_user
    elif part == "HOST":
        starts, ends, present = host_start, host_end, has_host
    elif part == "PATH":
        starts, ends, present = path_start, qh, ~opaque
    elif part == "FILE":
        starts = path_start
        ends = torch.where(has_query, query_end, qh)
        present = ~opaque
    elif part == "REF":
        starts, ends, present = ref_start, lens, has_ref
    else:  # QUERY
        starts, ends, present = query_start, query_end, has_query
        if key is not None:
            kb = key.encode("utf-8")
            expects(len(kb) >= 1, "empty query key")
            # match (^|&)key= inside the query span, take the first
            km = torch.ones_like(in_str)
            for i, ch in enumerate(kb + b"="):
                km = km & ((_shifted(mat, i) if i else mat) == ch)
            at_start = pos == starts[:, None]
            prev_amp = _shifted(mat, -1) == ord("&")
            vlen = len(kb) + 1
            km = km & (at_start | prev_amp) & \
                ((pos + vlen) <= ends[:, None]) & \
                _in_range(pos, starts, ends)
            kpos = _first_pos(km, pos, lens)
            found = kpos < lens
            vstart = torch.minimum(kpos + vlen, lens)
            amp_after = _first_pos((mat == ord("&")) &
                                   _in_range(pos, vstart, ends), pos, lens)
            starts, ends = vstart, torch.minimum(amp_after, ends)
            present = present & found

    present = present & ~invalid & col.valid_bool()
    starts = torch.where(present, starts, 0)
    out_lens = torch.where(present, (ends - starts).clamp(min=0), 0)

    # the substrings: one gather of each row's span
    w = max(int(out_lens.max()), 1) if col.size else 1
    idx = (starts[:, None] + torch.arange(w, dtype=torch.int32,
                                          device=mat.device)[None, :])
    out = torch.gather(mat, 1, idx.clamp(max=m - 1).to(torch.int64))
    return strings_from_matrix(out, out_lens, present)
