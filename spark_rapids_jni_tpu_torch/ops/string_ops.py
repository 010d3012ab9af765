"""String functions over STRING columns: upper/lower, lengths, substring,
find, concat, substring_index and LIKE.

Port of ``spark_rapids_jni_tpu/ops/string_ops.py``. Every op works on the
padded byte matrix of ``columnar/strings.byte_matrix`` with elementwise
tensor algebra; character-indexed ops map characters to byte ranges
with a cumulative sum over UTF-8 lead bytes (a continuation byte is
``10xxxxxx``). Case mapping is ASCII only, like cudf's ``to_upper``:
multi-byte characters pass through unchanged.

``contains_matrix``, ``starts_with_matrix`` and ``like_matrix`` take a
byte matrix and lengths directly; the fused plan's ``bytes`` string
route (``tpcds/oplib/strings.py``) calls them on the rows' gathered
category bytes. ``like_tokens`` is the one LIKE grammar both string
routes compile.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column, bitmask
from ..columnar.strings import byte_matrix, from_byte_matrix, max_length
from ..types import BOOL8, INT32, TypeId
from ..utils.errors import expects
from ..obs import traced


def _mat(col: Column):
    expects(col.dtype.id == TypeId.STRING, "STRING column required")
    m = max(max_length(col), 1)
    return byte_matrix(col, m), m


def _rebuild(col: Column, mat, lens) -> Column:
    """A STRING column from a byte matrix and lengths, on ``col``'s
    device, with ``col``'s validity."""
    return from_byte_matrix(mat.cpu().numpy(), lens.cpu().numpy(),
                            col.valid_bool().cpu().numpy(),
                            device=col.device)


def _case_map(col: Column, first: str, last: str, delta: int) -> Column:
    (mat, lens), _ = _mat(col)
    hit = (mat >= ord(first)) & (mat <= ord(last))
    out = torch.where(hit, mat.to(torch.int32) + delta, mat.to(torch.int32))
    return _rebuild(col, out.to(torch.uint8), lens)


@traced("string_ops.upper")
def upper(col: Column) -> Column:
    return _case_map(col, "a", "z", -32)


@traced("string_ops.lower")
def lower(col: Column) -> Column:
    return _case_map(col, "A", "Z", 32)


def _lead_bytes(mat: torch.Tensor, lens: torch.Tensor, m: int):
    """(in_str, is_start): byte inside its row, byte starting a UTF-8
    character inside its row."""
    pos = torch.arange(m, dtype=torch.int32, device=mat.device)[None, :]
    in_str = pos < lens[:, None]
    return in_str, in_str & ((mat & 0xC0) != 0x80)


@traced("string_ops.char_lengths")
def char_lengths(col: Column) -> Column:
    """Per-row UTF-8 character count (Spark ``length()``)."""
    (mat, lens), m = _mat(col)
    _, is_start = _lead_bytes(mat, lens, m)
    n_chars = is_start.sum(dim=1).to(torch.int32)
    return Column(INT32, col.size, n_chars, col.validity)


@traced("string_ops.substring")
def substring(col: Column, start: int, length: int) -> Column:
    """Character-indexed substring (0-based start), UTF-8 aware."""
    expects(start >= 0 and length >= 0, "start/length must be nonnegative")
    (mat, lens), m = _mat(col)
    in_str, is_start = _lead_bytes(mat, lens, m)
    # character index of each byte: lead bytes at or before it, less one
    char_idx = torch.cumsum(is_start.to(torch.int32), dim=1) - 1
    keep = in_str & (char_idx >= start) & (char_idx < start + length)
    # kept bytes move left to their rank among the kept
    new_pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    new_lens = keep.sum(dim=1)
    out = torch.zeros_like(mat)
    rows, cols = torch.nonzero(keep, as_tuple=True)
    out[rows, new_pos[rows, cols]] = mat[rows, cols]
    return _rebuild(col, out, new_lens)


@traced("string_ops.contains_matrix")
def contains_matrix(mat: torch.Tensor, lens: torch.Tensor,
                    pattern: bytes) -> torch.Tensor:
    """Literal substring test over a padded byte matrix -> (N,) bool, by
    sliding-window compares."""
    n, m = int(mat.shape[0]), int(mat.shape[1])
    dev = mat.device
    if len(pattern) == 0:
        return torch.ones(n, dtype=torch.bool, device=dev)
    if len(pattern) > m:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    windows = m - len(pattern) + 1
    ok = mat[:, 0:windows] == pattern[0]
    for j, ch in enumerate(pattern[1:], start=1):
        ok = ok & (mat[:, j:j + windows] == ch)
    starts_ok = (torch.arange(windows, dtype=torch.int32, device=dev)[None, :]
                 + len(pattern)) <= lens[:, None]
    return (ok & starts_ok).any(dim=1)


@traced("string_ops.starts_with_matrix")
def starts_with_matrix(mat: torch.Tensor, lens: torch.Tensor,
                       prefix: bytes) -> torch.Tensor:
    """Prefix test over a padded byte matrix -> (N,) bool."""
    n, m = int(mat.shape[0]), int(mat.shape[1])
    if len(prefix) > m:
        return torch.zeros(n, dtype=torch.bool, device=mat.device)
    ok = lens >= len(prefix)
    for j, ch in enumerate(prefix):
        ok = ok & (mat[:, j] == ch)
    return ok


def _bool_col(col: Column, hit: torch.Tensor) -> Column:
    return Column(BOOL8, col.size, hit.to(torch.int8), col.validity)


@traced("string_ops.contains")
def contains(col: Column, pattern: str) -> Column:
    """Literal substring test -> BOOL8 column."""
    (mat, lens), _ = _mat(col)
    return _bool_col(col, contains_matrix(mat, lens, pattern.encode("utf-8")))


@traced("string_ops.starts_with")
def starts_with(col: Column, prefix: str) -> Column:
    (mat, lens), _ = _mat(col)
    return _bool_col(col, starts_with_matrix(mat, lens,
                                             prefix.encode("utf-8")))


@traced("string_ops.concat")
def concat(a: Column, b: Column) -> Column:
    """Row-wise concatenation (null if either side is null)."""
    (ma, la), _ = _mat(a)
    (mb, lb), _ = _mat(b)
    na, nb = ma.cpu().numpy(), mb.cpu().numpy()
    las, lbs = la.cpu().numpy().astype(np.int64), lb.cpu().numpy()
    out_lens = las + lbs
    m_out = max(int(out_lens.max()) if len(out_lens) else 1, 1)
    j = np.arange(m_out)[None, :]
    rows = np.arange(a.size)[:, None]
    from_a = na[rows, np.minimum(j, na.shape[1] - 1)]
    from_b = nb[rows, np.clip(j - las[:, None], 0, nb.shape[1] - 1)]
    out = np.where(j < las[:, None], from_a,
                   np.where(j < out_lens[:, None], from_b, 0)).astype(np.uint8)
    valid = (a.valid_bool() & b.valid_bool()).cpu().numpy()
    return from_byte_matrix(out, out_lens, valid, device=a.device)


@traced("string_ops.substring_index")
def substring_index(col: Column, delim: str, count: int) -> Column:
    """Spark/Hive ``substring_index(str, delim, count)``.

    count > 0: everything before the count-th occurrence of ``delim``
    from the left (non-overlapping, as Spark's indexOf loop steps by the
    delimiter length); fewer occurrences -> the whole string. count < 0:
    everything after the |count|-th occurrence from the right (Spark's
    rfind loop steps back one byte, so matches may overlap). count == 0
    or an empty delimiter -> empty strings.
    """
    (mat, lens), m = _mat(col)
    n = col.size
    dev = mat.device
    valid = col.valid_bool().cpu().numpy()
    db = delim.encode("utf-8")
    dl = len(db)
    if count == 0 or dl == 0:
        return from_byte_matrix(np.zeros((n, 1), np.uint8),
                                np.zeros(n, np.int32), valid, device=dev)

    # match[:, p]: the delimiter starts at byte p
    match = torch.ones((n, m), dtype=torch.bool, device=dev)
    for i, ch in enumerate(db):
        sh = torch.nn.functional.pad(mat[:, i:], (0, i), value=0)
        match = match & (sh == ch)
    pos = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    match = match & ((pos + dl) <= lens[:, None])
    lens64 = lens.to(torch.int64)

    if count > 0:
        if dl == 1:
            # one-byte delimiters cannot overlap: the count-th match from
            # the left is one cumulative sum and an argmax
            lc = torch.cumsum(match.to(torch.int32), dim=1)
            sel = match & (lc == count)
            found = sel.any(dim=1)
            pos_k = torch.argmax(sel.to(torch.int8), dim=1)
        else:
            # a greedy left scan that keeps matches apart (Spark's indexOf)
            blocked = torch.zeros(n, dtype=torch.int64, device=dev)
            occ = torch.zeros(n, dtype=torch.int64, device=dev)
            pos_k = torch.full((n,), -1, dtype=torch.int64, device=dev)
            for j in range(m):
                sel = match[:, j] & (j >= blocked) & (occ < count)
                occ = occ + sel.to(torch.int64)
                pos_k = torch.where(sel & (occ == count), j, pos_k)
                blocked = torch.where(sel, j + dl, blocked)
            found = pos_k >= 0
        starts = torch.zeros(n, dtype=torch.int64, device=dev)
        ends = torch.where(found, pos_k, lens64)
    else:
        k = -count
        # the k-th match from the right (overlaps allowed)
        rc = torch.flip(torch.cumsum(torch.flip(match, [1]).to(torch.int32),
                                     dim=1), [1])
        sel = match & (rc == k)
        found = sel.any(dim=1)
        last = m - 1 - torch.argmax(torch.flip(sel, [1]).to(torch.int8),
                                    dim=1)
        starts = torch.where(found, last + dl, 0)
        ends = lens64

    out_lens = torch.clamp(ends - starts, min=0).cpu().numpy()
    starts_h = starts.cpu().numpy()
    mat_h = mat.cpu().numpy()
    w = max(int(out_lens.max()) if n else 1, 1)
    idx = np.minimum(starts_h[:, None] + np.arange(w)[None, :], m - 1)
    out = np.take_along_axis(mat_h, idx, axis=1)
    out[np.arange(w)[None, :] >= out_lens[:, None]] = 0
    return from_byte_matrix(out, out_lens, valid, device=dev)


@traced("string_ops.like_tokens")
def like_tokens(pattern: str, escape: str = "\\") -> list:
    """A SQL LIKE pattern as tokens ``('%',)``, ``('_',)``, ``('lit',
    byte)``: the one grammar of the byte-matrix DP below and of the host
    dictionary route (``tpcds/oplib/strings.py``)."""
    expects(len(escape) == 1, "escape must be a single character")
    toks = []
    pb = pattern.encode("utf-8")
    esc = escape.encode("utf-8")[0]
    i = 0
    while i < len(pb):
        c = pb[i]
        if c == esc and i + 1 < len(pb):
            toks.append(("lit", pb[i + 1]))
            i += 2
        elif c == ord("%"):
            toks.append(("%",))
            i += 1
        elif c == ord("_"):
            toks.append(("_",))
            i += 1
        else:
            toks.append(("lit", c))
            i += 1
    return toks


@traced("string_ops.like_matrix")
def like_matrix(mat: torch.Tensor, lens: torch.Tensor,
                pattern: str, escape: str = "\\") -> torch.Tensor:
    """SQL LIKE over a padded byte matrix -> (N,) bool: ``%`` any
    sequence, ``_`` any ONE character (a continuation byte never starts
    one), the escape character protects a literal; whole-string match,
    as in Spark.

    The wildcard DP across rows: ``dp[:, j]`` says the bytes read so far
    match the first j tokens; it advances one matrix column a step, and
    each row's verdict is taken when the scan reaches its length."""
    n, m = int(mat.shape[0]), int(mat.shape[1])
    dev = mat.device
    toks = like_tokens(pattern, escape)
    P = len(toks)
    col0 = torch.ones(n, dtype=torch.bool, device=dev)
    dp = [col0]
    for t in toks:
        dp.append(dp[-1] & (t[0] == "%"))
    result = dp[P] & (lens == 0)
    cont_mask = (mat & 0xC0) == 0x80  # UTF-8 continuation bytes
    zero = torch.zeros(n, dtype=torch.bool, device=dev)
    for i_col in range(m):
        c = mat[:, i_col]
        cont = cont_mask[:, i_col]
        new = [zero]
        for j, t in enumerate(toks):
            if t[0] == "%":
                # match the empty sequence, or extend the one before
                new.append(new[j] | dp[j + 1])
            elif t[0] == "_":
                # one CHARACTER: start on a lead byte, then absorb its
                # continuation bytes
                new.append((dp[j] & ~cont) | (dp[j + 1] & cont))
            else:
                new.append(dp[j] & (c == t[1]))
        dp = new
        result = torch.where(lens == (i_col + 1), dp[P], result)
    return result


@traced("string_ops.like")
def like(col: Column, pattern: str, escape: str = "\\") -> Column:
    """SQL LIKE -> BOOL8 column (semantics: :func:`like_matrix`)."""
    (mat, lens), _ = _mat(col)
    result = like_matrix(mat, lens, pattern, escape)
    return Column(BOOL8, col.size, result.to(torch.int8),
                  bitmask.pack(col.valid_bool()))
