"""Regular expressions over STRING columns: rlike / regexp matching.

Port of ``spark_rapids_jni_tpu/ops/regexp.py``, with its own copy of the
pattern compiler:

- **Host:** compile a practical regex subset (literals, ``.``, classes
  ``[a-z0-9_]`` with ranges and negation, escapes ``\\d \\w \\s`` and
  literal escapes, quantifiers ``* + ?``, alternation ``|``, grouping
  ``()``, anchors ``^ $``) into a Thompson NFA, epsilon-closed into plain
  (state, byte-predicate, state) transitions, at most 32 states.
- **Device:** bit-parallel simulation. The active state set of every row
  is one 32-bit lane, advanced one byte-matrix column at a time. The
  transitions are folded into tables ``T[k][byte][u]``: the states
  reached on ``byte`` from the state subset ``u`` of the ``k``-th group of
  eight states. A column's step is then one gather per group of eight
  states, whatever the number of transitions.
- ``regexp_contains`` (Spark ``rlike``: substring semantics) re-injects
  the start states every step and latches the accept bit; ``^``
  suppresses the re-injection, ``$`` moves acceptance to the end-of-row
  step. ``regexp_full_match``: no re-injection, accept read at each
  row's end.

Unsupported constructs (backreferences, lookaround, bounded repeats, more
than 32 states) take Python's ``re`` on the host, counted by
``regexp.host_fallback_calls`` / ``_rows``: the reference's own split
between patterns its engine compiles and the rest. ``regexp_extract``
(capture groups) is host code, as in the reference.
"""

from __future__ import annotations

import re as _pyre
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..columnar import Column, bitmask
from ..columnar.strings import byte_matrix, max_length
from ..obs import count, set_attrs, traced
from ..types import BOOL8, TypeId
from ..utils.errors import expects

_MAX_STATES = 32


class _Unsupported(Exception):
    pass


# ---------------------------------------------------------------------------
# Pattern -> NFA fragments (Thompson construction)
# ---------------------------------------------------------------------------

class _Pred:
    """A byte predicate: set of accepted byte values (as a 256-bool mask)."""

    def __init__(self, mask: np.ndarray):
        self.mask = mask

    def key(self) -> bytes:
        return np.packbits(self.mask).tobytes()


def _class_pred(spec: str, negate: bool) -> _Pred:
    # Byte-level class masks cannot express multi-byte UTF-8 members: a
    # member like 'à' would set only its lead byte (over-matching every
    # character that shares it). Push such patterns to the exact host path.
    if any(ord(ch) > 0x7F for ch in spec):
        raise _Unsupported("non-ascii character in class")
    mask = np.zeros(256, bool)
    i = 0
    while i < len(spec):
        c = spec[i]
        if c == "\\" and i + 1 < len(spec):
            mask |= _escape_pred(spec[i + 1]).mask
            i += 2
            continue
        if i + 2 < len(spec) and spec[i + 1] == "-":
            mask[ord(c):ord(spec[i + 2]) + 1] = True  # ASCII by the gate above
            i += 3
        else:
            mask[ord(c)] = True
            i += 1
    if negate:
        mask = ~mask
    return _Pred(mask)


def _escape_pred(c: str) -> _Pred:
    mask = np.zeros(256, bool)
    if c == "d":
        mask[ord("0"):ord("9") + 1] = True
    elif c == "D":
        mask[ord("0"):ord("9") + 1] = True
        mask = ~mask
    elif c == "w":
        mask[ord("a"):ord("z") + 1] = True
        mask[ord("A"):ord("Z") + 1] = True
        mask[ord("0"):ord("9") + 1] = True
        mask[ord("_")] = True
    elif c == "s":
        for b in b" \t\n\r\f\v":
            mask[b] = True
    elif c == "S":
        for b in b" \t\n\r\f\v":
            mask[b] = True
        mask = ~mask
    elif c in ".^$*+?()[]{}|\\/":
        mask[ord(c)] = True
    else:
        raise _Unsupported(f"escape \\{c}")
    return _Pred(mask)


def _dot_pred() -> _Pred:
    mask = np.ones(256, bool)
    mask[ord("\n")] = False
    return _Pred(mask)


def _has_top_level_alt(pattern: str) -> bool:
    depth = 0
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            i += 2
            continue
        if c == "[":
            while i < len(pattern) and pattern[i] != "]":
                if pattern[i] == "\\":
                    i += 1
                i += 1
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "|" and depth == 0:
            return True
        i += 1
    return False


class _NFA:
    def __init__(self):
        self.n_states = 0
        self.eps: List[Tuple[int, int]] = []
        self.trans: List[Tuple[int, _Pred, int]] = []

    def new_state(self) -> int:
        self.n_states += 1
        return self.n_states - 1


def _parse(pattern: str):
    """Recursive-descent regex parser -> (nfa, start, accept, anchored_l,
    anchored_r)."""
    nfa = _NFA()
    pos = 0

    anchored_l = pattern.startswith("^")
    if anchored_l:
        pattern = pattern[1:]
    anchored_r = pattern.endswith("$") and not pattern.endswith("\\$")
    if anchored_r:
        pattern = pattern[:-1]
    if (anchored_l or anchored_r) and _has_top_level_alt(pattern):
        # '^a|b' / 'a|b$' anchor only ONE branch in Java — stripping the
        # anchor here would anchor the whole alternation; host re instead
        raise _Unsupported("anchor over top-level alternation")

    def parse_alt(i):
        frags = []
        s, e, i = parse_seq(i)
        frags.append((s, e))
        while i < len(pattern) and pattern[i] == "|":
            s2, e2, i = parse_seq(i + 1)
            frags.append((s2, e2))
        if len(frags) == 1:
            return frags[0][0], frags[0][1], i
        start, end = nfa.new_state(), nfa.new_state()
        for s_, e_ in frags:
            nfa.eps.append((start, s_))
            nfa.eps.append((e_, end))
        return start, end, i

    def parse_seq(i):
        start = nfa.new_state()
        cur = start
        while i < len(pattern) and pattern[i] not in "|)":
            s, e, i = parse_atom(i)
            # quantifier?
            if i < len(pattern) and pattern[i] in "*+?":
                q = pattern[i]
                i += 1
                if i < len(pattern) and pattern[i] == "?":
                    raise _Unsupported("lazy quantifier")
                ns, ne = nfa.new_state(), nfa.new_state()
                nfa.eps.append((ns, s))
                nfa.eps.append((e, ne))
                if q in "*?":
                    nfa.eps.append((ns, ne))
                if q in "*+":
                    nfa.eps.append((e, s))
                s, e = ns, ne
            nfa.eps.append((cur, s))
            cur = e
        return start, cur, i

    def parse_atom(i):
        c = pattern[i]
        if c == "(":
            if pattern[i:i + 3] == "(?:":
                s, e, i = parse_alt(i + 3)
            else:
                s, e, i = parse_alt(i + 1)
            if i >= len(pattern) or pattern[i] != ")":
                raise _Unsupported("unbalanced group")
            return s, e, i + 1
        if c == "[":
            j = i + 1
            negate = j < len(pattern) and pattern[j] == "^"
            if negate:
                j += 1
            k = j
            while k < len(pattern) and (pattern[k] != "]" or k == j):
                if pattern[k] == "\\":
                    k += 1
                k += 1
            if k >= len(pattern):
                raise _Unsupported("unbalanced class")
            s_, e_ = _single(_class_pred(pattern[j:k], negate))
            return s_, e_, k + 1
        if c == "\\":
            if i + 1 >= len(pattern):
                raise _Unsupported("trailing backslash")
            s_, e_ = _single(_escape_pred(pattern[i + 1]))
            return s_, e_, i + 2
        if c == ".":
            s_, e_ = _single(_dot_pred())
            return s_, e_, i + 1
        if c in "*+?{":
            raise _Unsupported(f"dangling quantifier {c}")
        if c in "^$":
            raise _Unsupported("mid-pattern anchor")
        if ord(c) > 0x7F:
            # A multi-byte literal's continuation bytes would be mangled by
            # the any-character rewrite in _compile (its continuation
            # transition predicate intersects to empty). Host re instead.
            raise _Unsupported("non-ascii literal")
        b = c.encode("utf-8")
        s = nfa.new_state()
        cur = s
        for byte in b:
            nxt = nfa.new_state()
            mask = np.zeros(256, bool)
            mask[byte] = True
            nfa.trans.append((cur, _Pred(mask), nxt))
            cur = nxt
        return s, cur, i + 1

    def _single(pred):
        s, e = nfa.new_state(), nfa.new_state()
        nfa.trans.append((s, pred, e))
        return s, e

    start, end, i = parse_alt(0)
    if i != len(pattern):
        raise _Unsupported("unbalanced pattern")
    return nfa, start, end, anchored_l, anchored_r


def _compile(pattern: str):
    """-> (preds, transitions[(src, pred_idx, dst)], start_mask, accept_mask,
    anchored_l, anchored_r) with epsilon transitions closed away."""
    nfa, start, accept, al, ar = _parse(pattern)
    S = nfa.n_states
    if S > _MAX_STATES:
        raise _Unsupported(f"{S} NFA states > {_MAX_STATES}")
    # epsilon closure per state
    adj = [[] for _ in range(S)]
    for a, b in nfa.eps:
        adj[a].append(b)
    closure = []
    for s in range(S):
        seen = {s}
        stack = [s]
        while stack:
            x = stack.pop()
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        closure.append(seen)

    def mask_of(states) -> int:
        m = 0
        for s_ in states:
            m |= 1 << s_
        return m

    start_mask = mask_of(closure[start])
    accept_mask = 1 << accept

    # dedupe predicates; close each transition's destination. Predicates
    # that accept high bytes ('.', negated classes, \D/\S/\W) must consume
    # one CHARACTER like Java regex, not one byte: the entry predicate is
    # restricted to non-continuation bytes and the destination state gets a
    # continuation-byte self-loop absorbing the rest of the character.
    cont_mask = np.zeros(256, bool)
    cont_mask[0x80:0xC0] = True
    preds: List[_Pred] = []
    pred_idx = {}

    def intern(pred: _Pred) -> int:
        k = pred.key()
        if k not in pred_idx:
            pred_idx[k] = len(preds)
            preds.append(pred)
        return pred_idx[k]

    trans: List[Tuple[int, int, int]] = []
    for src, pred, dst in nfa.trans:
        if pred.mask[0x80:].any():
            # By construction (non-ASCII literals/classes raise _Unsupported
            # at parse time) a high-byte-accepting predicate accepts EVERY
            # high byte — it means "any character" ('.', negated classes,
            # \D/\S). Only those get the one-character lead-byte +
            # continuation-loop rewrite.
            assert pred.mask[0x80:].all(), \
                "partial high-byte predicate escaped the parser gate"
            entry = _Pred(pred.mask & ~cont_mask)
            trans.append((src, intern(entry), mask_of(closure[dst])))
            trans.append((dst, intern(_Pred(cont_mask.copy())),
                          mask_of(closure[dst])))
        else:
            trans.append((src, intern(pred), mask_of(closure[dst])))
    return preds, trans, start_mask, accept_mask, al, ar


_COMPILE_CACHE: dict = {}


def _get_compiled(pattern: str):
    if pattern not in _COMPILE_CACHE:
        try:
            _COMPILE_CACHE[pattern] = _compile(pattern)
        except _Unsupported as e:
            _COMPILE_CACHE[pattern] = e
    out = _COMPILE_CACHE[pattern]
    if isinstance(out, Exception):
        raise out
    return out


# ---------------------------------------------------------------------------
# Device simulation
# ---------------------------------------------------------------------------

def _step_tables(pattern: str) -> np.ndarray:
    """(groups, 256, 256) int64: ``[k, b, u]`` is the union of the
    destination masks of the transitions on byte ``b`` out of the states
    ``8k + i`` for the set bits ``i`` of ``u``."""
    preds, trans, *_ = _get_compiled(pattern)
    n_states = max([s for s, _, _ in trans] + [0]) + 1
    dest = np.zeros((256, n_states), np.int64)  # [b, s]
    for src, pi, dst_mask in trans:
        dest[preds[pi].mask, src] |= dst_mask
    groups = (n_states + 7) // 8
    dest = np.pad(dest, ((0, 0), (0, 8 * groups - n_states)))
    tables = np.zeros((groups, 256, 256), np.int64)
    for k in range(groups):
        for u in range(1, 256):
            low = (u & -u).bit_length() - 1
            tables[k, :, u] = tables[k, :, u & (u - 1)] | dest[:, 8 * k + low]
    return tables


_TABLE_CACHE: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _device_tables(pattern: str, dev: torch.device) -> torch.Tensor:
    key = (pattern, dev)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = torch.from_numpy(
            _step_tables(pattern).reshape(-1)).to(dev)
    return _TABLE_CACHE[key]


def _simulate_device(mat: torch.Tensor, lens: torch.Tensor, pattern: str,
                     full: bool) -> torch.Tensor:
    _, _, start_mask, accept_mask, al, ar = _get_compiled(pattern)
    tables = _device_tables(pattern, mat.device)
    groups = tables.numel() // (256 * 256)
    n, m = mat.shape
    reinject = not full and not al
    # accept latched mid-string only for contains without a $ anchor
    latch = not full and not ar
    mask = torch.full((n,), start_mask, dtype=torch.int64, device=mat.device)
    hit = (mask & accept_mask) != 0 if latch else None
    end_mask = mask
    for j in range(m):
        row = mat[:, j].to(torch.int64) * 256
        new = tables[row + (mask & 0xFF)]
        for k in range(1, groups):
            new = new | tables[(k << 16) + row + ((mask >> (8 * k)) & 0xFF)]
        if reinject:
            new = new | start_mask
        inside = j < lens
        mask = torch.where(inside, new, mask)
        if latch:
            hit = hit | (inside & ((mask & accept_mask) != 0))
        else:
            end_mask = torch.where(lens == j + 1, mask, end_mask)
    if latch:
        return hit
    # full match or $-anchored contains: accept must hold at the row's end
    return (end_mask & accept_mask) != 0


def _simulate(col: Column, pattern: str, full: bool) -> torch.Tensor:
    _get_compiled(pattern)  # raise _Unsupported before any device work
    m = max(max_length(col), 1)
    mat, lens = byte_matrix(col, m)
    return _simulate_device(mat, lens, pattern, full)


def _host_re(col: Column, pattern: str, full: bool) -> torch.Tensor:
    count("regexp.host_fallback_calls")
    count("regexp.host_fallback_rows", col.size)
    set_attrs(route="host", reason="unsupported_syntax", rows=col.size)
    rx = _pyre.compile(pattern)
    match = rx.fullmatch if full else rx.search
    out = [s is not None and bool(match(s)) for s in col.to_pylist()]
    return torch.tensor(out, dtype=torch.bool, device=col.device)


def _bool_col(col: Column, hit: torch.Tensor) -> Column:
    return Column(BOOL8, col.size, hit.to(torch.int8),
                  bitmask.pack(col.valid_bool()))


@traced("regexp.regexp_contains")
def regexp_contains(col: Column, pattern: str) -> Column:
    """Spark ``rlike``: pattern found anywhere in the string -> BOOL8."""
    expects(col.dtype.id == TypeId.STRING, "regexp needs STRING")
    try:
        return _bool_col(col, _simulate(col, pattern, full=False))
    except _Unsupported:
        return _bool_col(col, _host_re(col, pattern, False))


@traced("regexp.regexp_full_match")
def regexp_full_match(col: Column, pattern: str) -> Column:
    """Anchored whole-string match -> BOOL8."""
    expects(col.dtype.id == TypeId.STRING, "regexp needs STRING")
    try:
        return _bool_col(col, _simulate(col, pattern, full=True))
    except _Unsupported:
        return _bool_col(col, _host_re(col, pattern, True))


@traced("regexp.regexp_extract")
def regexp_extract(col: Column, pattern: str, group: int = 1) -> Column:
    """Spark regexp_extract: capture-group text of the first match, ''
    when unmatched (Spark convention), NULL on null input. Capture
    tracking needs tagged NFAs: this is host code, like the reference's
    full-engine route."""
    expects(col.dtype.id == TypeId.STRING, "regexp needs STRING")
    count("regexp.extract_host_rows", col.size)
    set_attrs(route="host", reason="capture_groups", rows=col.size)
    rx = _pyre.compile(pattern)
    out: list = []
    for s in col.to_pylist():
        if s is None:
            out.append(None)
        else:
            mm = rx.search(s)
            out.append(mm.group(group) if mm and mm.group(group) is not None
                       else "")
    return Column.strings_from_list(out, device=col.device)
