"""get_json_object: JSONPath extraction over STRING columns.

Port of ``spark_rapids_jni_tpu/ops/get_json_object.py``. The device
route is a structural JSON parser over the padded (N, L) byte matrix
(``columnar/strings.byte_matrix``), with no per-row walk:

- escape state: a character is escaped when the backslash run before
  it has odd length, read off a running max of the last non-backslash
  position;
- string interiors: the parity of a running count of unescaped quotes;
- nesting depth: a running sum of structural braces and brackets;
- each JSONPath step is one round of masked first-occurrence scans (a
  key by shifted byte compares, an array element by comma counts);
- the value's span is cut out with one gather.

Positions are int16 grids while L + 8 fits (int32 beyond). The running
max and min are log-step scans (``_running``: log2(L) shifted
``maximum``/``minimum`` passes, the same positions as ``torch.cummax``
without its int64 index grid), and the running counts a triangular
matmul (``_running_sum``, exact), where torch's inner-dimension scans
were slower on the card (``tools/torch_json_scans.py``). Rows go through in chunks of
``CHUNK_CELLS`` // L rows, so that one chunk's grids bound the memory. The
result is assembled on the device by ``strings_from_matrix`` (its
validity through K3).

Host routes, the reference's own: a string value holding an escape is
unescaped on the host (the byte length changes),
``get_json_object.host_unescape_rows``; a path whose field names hold
quotes or backslashes takes the native library's C++ walker when
``native.available()`` (the library is loaded in the process; nothing
builds it here), else the Python walker,
``get_json_object.python_walker_rows``. Spark semantics: strings
unquote, scalars return their literal text, objects and arrays their
raw JSON; JSON null, a missing path and malformed input give SQL NULL.

Path subset: ``$``, ``.field``, ``['field']``, ``[index]``, nested.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from .. import native
from ..columnar import Column
from ..columnar.strings import byte_matrix, max_length, strings_from_matrix
from ..types import TypeId
from ..utils.errors import expects
from ..obs import count, set_attrs, traced

CHUNK_CELLS = 1 << 28  # bytes of one chunk's (rows, L) byte grid

_STEP_RE = re.compile(
    r"\.(?P<field>[^.\[]+)|\[(?P<q>['\"])(?P<qfield>.*?)(?P=q)\]"
    r"|\[(?P<index>\d+)\]")


def _parse_path(path: str):
    if not path.startswith("$"):
        return None
    steps = []
    at = 1
    while at < len(path):
        m = _STEP_RE.match(path, at)
        if m is None:
            return None
        if m.group("field") is not None:
            steps.append(("f", m.group("field")))
        elif m.group("qfield") is not None:
            steps.append(("f", m.group("qfield")))
        else:
            steps.append(("i", int(m.group("index"))))
        at = m.end()
    return steps


# ---------------------------------------------------------------------------
# The Python walker: the host route and the oracle of the device route
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("s", "p", "ok")

    def __init__(self, s: str):
        self.s = s
        self.p = 0
        self.ok = True

    def ws(self):
        while self.p < len(self.s) and self.s[self.p] in " \t\n\r":
            self.p += 1

    def eof(self):
        return self.p >= len(self.s)


def _skip_string(c: _Cursor):
    if c.eof() or c.s[c.p] != '"':
        c.ok = False
        return
    c.p += 1
    while not c.eof() and c.s[c.p] != '"':
        if c.s[c.p] == "\\":
            c.p += 1
        c.p += 1
    if c.eof():
        c.ok = False
        return
    c.p += 1


def _skip_value(c: _Cursor):
    c.ws()
    if c.eof():
        c.ok = False
        return
    ch = c.s[c.p]
    if ch == '"':
        _skip_string(c)
    elif ch in "{[":
        close = "}" if ch == "{" else "]"
        depth = 0
        while True:
            if c.eof():
                c.ok = False
                return
            cur = c.s[c.p]
            if cur == '"':
                _skip_string(c)
                if not c.ok:
                    return
                continue
            if cur == ch:
                depth += 1
            elif cur == close:
                depth -= 1
            c.p += 1
            if depth == 0:
                return
    else:
        while not c.eof() and c.s[c.p] not in ",}] \t\n\r":
            c.p += 1


def _descend(c: _Cursor, step) -> bool:
    c.ws()
    if c.eof():
        return False
    kind, arg = step
    if kind == "f":
        if c.s[c.p] != "{":
            return False
        c.p += 1
        while True:
            c.ws()
            if c.eof() or c.s[c.p] == "}":
                return False
            if c.s[c.p] != '"':
                return False
            key_start = c.p + 1
            _skip_string(c)
            if not c.ok:
                return False
            key = c.s[key_start:c.p - 1]
            c.ws()
            if c.eof() or c.s[c.p] != ":":
                return False
            c.p += 1
            c.ws()
            if key == arg:
                return True
            _skip_value(c)
            if not c.ok:
                return False
            c.ws()
            if not c.eof() and c.s[c.p] == ",":
                c.p += 1
                continue
            return False
    if c.s[c.p] != "[":
        return False
    c.p += 1
    i = 0
    while True:
        c.ws()
        if c.eof() or c.s[c.p] == "]":
            return False
        if i == arg:
            return True
        _skip_value(c)
        if not c.ok:
            return False
        c.ws()
        if c.eof() or c.s[c.p] != ",":
            return False
        c.p += 1
        i += 1


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
            "/": "/", "\\": "\\", '"': '"'}


def _eval_py(s: str, steps) -> Optional[str]:
    c = _Cursor(s)
    for st in steps:
        if not _descend(c, st):
            return None
    c.ws()
    if c.eof():
        return None
    start = c.p
    if c.s[c.p] == '"':
        _skip_string(c)
        if not c.ok:
            return None
        return _unescape(c.s[start + 1:c.p - 1])
    _skip_value(c)
    if not c.ok:
        return None
    text = c.s[start:c.p]
    if text == "null" or not text:
        # an empty span is a missing value after ':' (malformed, e.g.
        # '{"a":}'); Spark returns NULL, and the device route agrees
        return None
    return text


def _hex4(s: str) -> int:
    """Exactly 4 hex digits. int(s, 16) is too lenient (it takes '+123',
    ' 123', '1_23'), which would decode malformed escapes."""
    if len(s) != 4 or any(c not in "0123456789abcdefABCDEF" for c in s):
        raise ValueError(s)
    return int(s, 16)


def _unescape(raw: str) -> str:
    out = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            if nxt == "u" and i + 6 <= len(raw):
                try:
                    cp = _hex4(raw[i + 2:i + 6])
                except ValueError:
                    cp = None
                if cp is not None:
                    # a high surrogate followed by \uDC00-\uDFFF is a pair
                    # (how json.dumps writes a non-BMP character): combine
                    # it, so that no lone surrogate reaches the encoder
                    if (0xD800 <= cp <= 0xDBFF and raw[i + 6:i + 8] == "\\u"
                            and i + 12 <= len(raw)):
                        try:
                            lo = _hex4(raw[i + 8:i + 12])
                        except ValueError:
                            lo = -1
                        if 0xDC00 <= lo <= 0xDFFF:
                            out.append(chr(0x10000 + ((cp - 0xD800) << 10)
                                           + (lo - 0xDC00)))
                            i += 12
                            continue
                    # an unpaired surrogate cannot be UTF-8: the
                    # replacement character, as errors="replace" decodes
                    out.append("�" if 0xD800 <= cp <= 0xDFFF
                               else chr(cp))
                    i += 6
                    continue
            out.append(_ESCAPES.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# The device route: structural parsing over the byte matrix
# ---------------------------------------------------------------------------

def _running(x: torch.Tensor, op, reverse: bool = False) -> torch.Tensor:
    """Running ``op`` (``torch.maximum`` or ``torch.minimum``) along each
    row, from the left (or from the right): log2(width) shifted passes
    between two buffers (``x`` itself is not written)."""
    width = x.shape[1]
    bufs = [torch.empty_like(x), torch.empty_like(x)] if width > 1 else []
    d, k = 1, 0
    while d < width:
        y = bufs[k]
        if reverse:
            op(x[:, :-d], x[:, d:], out=y[:, :-d])
            y[:, -d:] = x[:, -d:]
        else:
            op(x[:, d:], x[:, :-d], out=y[:, d:])
            y[:, :d] = x[:, :d]
        x, k, d = y, 1 - k, 2 * d
    return x


_BLOCK = 128


def _running_sum(x: torch.Tensor, pdt: torch.dtype) -> torch.Tensor:
    """Running sum along each row of a grid of 0, 1 and -1, exact, in
    ``pdt``: a float32 matmul with a triangular matrix inside blocks of
    128 columns, then each block's running start (every partial sum is
    an integer below 2^24, which float32 holds exactly)."""
    n, width = x.shape
    b = min(width, _BLOCK)
    nb = -(-width // b)
    f = torch.nn.functional.pad(x.to(torch.float32), (0, nb * b - width))
    tri = torch.ones(b, b, device=x.device).triu_()
    s = f.view(n, nb, b) @ tri
    if nb > 1:
        ends = s[:, :, -1]
        s += (torch.cumsum(ends, 1) - ends)[:, :, None]
    return s.view(n, nb * b)[:, :width].to(pdt)


def _and_shifted(hit: torch.Tensor, cond: torch.Tensor, k: int) -> None:
    """hit[:, i] &= cond[:, i + k] in place, False past the right edge."""
    width = hit.shape[1]
    if k >= width:
        hit.zero_()
        return
    hit[:, width - k:] = False
    hit[:, :width - k] &= cond[:, k:]


def _device_parse(mat: torch.Tensor, lens: torch.Tensor,
                  valid: torch.Tensor, steps, pdt: torch.dtype):
    """Per-row (value start, value length, ok, needs host unescape) of
    one chunk's (n, L) byte matrix; positions in ``pdt``."""
    n, L = mat.shape
    dev = mat.device
    idx = torch.arange(L, dtype=pdt, device=dev)[None, :]
    INF = L + 1
    inb = idx < lens.to(pdt)[:, None]
    ch = mat  # zero past each row's length

    def col(v):
        return v.to(pdt)[:, None]

    # escape state: odd backslash run just before a character
    bsl = ch == 92
    nonb_last = _running(torch.where(bsl, -1, idx), torch.maximum)
    prev_nonb = torch.cat([torch.full((n, 1), -1, dtype=pdt, device=dev),
                           nonb_last[:, :-1]], dim=1)
    del nonb_last
    esc = ((idx - 1 - prev_nonb) & 1) == 1
    del prev_nonb

    # string interiors via quote parity; quotes themselves are string
    q = (ch == 34) & ~esc
    del esc
    odd = (_running_sum(q, pdt) & 1) == 1
    koq = q & odd   # opening quotes
    kcq = q & ~odd  # closing quotes
    structural = inb & ~(odd | q)
    del q, odd
    is_open = (structural & ((ch == 123) | (ch == 91))).to(pdt)
    is_close = (structural & ((ch == 125) | (ch == 93))).to(pdt)
    dafter = _running_sum(is_open - is_close, pdt)
    dbefore = dafter - is_open + is_close
    del is_open, is_close

    ws = inb & ((ch == 32) | (ch == 9) | (ch == 10) | (ch == 13))
    # nxt_nonws[:, i] = first non-ws position >= i (INF if none)
    nxt_nonws = _running(torch.where(inb & ~ws, idx, INF), torch.minimum,
                         reverse=True)
    del inb

    def at(arr2d, pos, fill):
        safe = torch.clamp(pos, 0, L - 1).to(torch.int64)
        v = torch.gather(arr2d, 1, safe[:, None])[:, 0]
        return torch.where((pos >= 0) & (pos < L), v, fill)

    def first_where(mask):
        return torch.amin(torch.where(mask, idx, INF), dim=1).to(torch.int64)

    def close_of(cur):
        # matching close: first structural position > cur back at the
        # depth before cur. INF (an unclosed container) is allowed mid-
        # descent: the walker streams values out of truncated documents
        # the way Jackson does, and the span filter reads INF as the end
        d_cur = at(dbefore, cur, 0)
        return d_cur, first_where((dafter == col(d_cur)) & structural
                                  & (idx > col(cur)))

    ok = valid & (lens > 0)
    cur = at(nxt_nonws, torch.zeros(n, dtype=torch.int64, device=dev),
             INF).to(torch.int64)
    ok = ok & (cur < INF)

    for kind, arg in steps:
        d_cur, close_c = close_of(cur)
        span = (idx > col(cur)) & (idx < col(close_c))
        if kind == "f":
            name = arg.encode("utf-8")
            m = len(name)
            ok = ok & (at(ch, cur, 0) == 123)
            # keys of THIS object: opening quotes at contents depth whose
            # text equals the name, closed right after, then ':'
            hit = koq & (dbefore == col(d_cur + 1)) & span
            for k, byte in enumerate(name):
                _and_shifted(hit, ch == byte, k + 1)
            _and_shifted(hit, kcq, m + 1)
            # the first non-ws character after the closing quote is ':'
            colon_next = torch.gather(ch, 1, torch.clamp(
                nxt_nonws, 0, L - 1).to(torch.int64)) == 58
            _and_shifted(hit, colon_next & (nxt_nonws < L), m + 2)
            del colon_next
            i0 = first_where(hit)
            del hit
            colon = at(nxt_nonws, i0 + m + 2, INF).to(torch.int64)
            v = at(nxt_nonws, colon + 1, INF).to(torch.int64)
            ok = ok & (i0 < INF) & (v < close_c)
        else:
            k = int(arg)
            ok = ok & (at(ch, cur, 0) == 91)
            if k == 0:
                v = at(nxt_nonws, cur + 1, INF).to(torch.int64)
            else:
                commas = structural & (ch == 44) \
                    & (dbefore == col(d_cur + 1)) & span
                csum = _running_sum(commas, pdt)
                kth = first_where(commas & (csum == k))
                del commas, csum
                v = at(nxt_nonws, kth + 1, INF).to(torch.int64)
                ok = ok & (kth < INF)
            ok = ok & (v < close_c)
        del span
        cur = v

    # the value at cur
    c0 = at(ch, cur, 0)
    _, close_c = close_of(cur)
    is_str = c0 == 34
    is_cont = (c0 == 123) | (c0 == 91)
    e_str = first_where(kcq & (idx > col(cur)))
    # scalars end where the walker stops: ',', '}', ']' or whitespace
    delim = (structural & ((ch == 44) | (ch == 125) | (ch == 93))) | ws
    e_sc = torch.minimum(first_where(delim & (idx > col(cur))),
                         lens.to(torch.int64))
    del delim
    is_null = (e_sc - cur == 4) & (c0 == 110) \
        & (at(ch, cur + 1, 0) == 117) & (at(ch, cur + 2, 0) == 108) \
        & (at(ch, cur + 3, 0) == 108)
    s = torch.where(is_str, cur + 1, cur)
    e = torch.where(is_str, e_str, torch.where(is_cont, close_c + 1, e_sc))
    ok = ok & (cur < INF) & torch.where(
        is_str, e_str < INF, torch.where(is_cont, close_c < INF,
                                         (e_sc > cur) & ~is_null))
    span_mask = (idx >= col(s)) & (idx < col(e))
    need_host = ok & is_str & torch.any(bsl & span_mask, dim=1)
    return s, torch.where(ok, e - s, 0), ok, need_host


def _cut(mat: torch.Tensor, s: torch.Tensor, out_len: torch.Tensor):
    """Each row's bytes [s, s + out_len) at the left of an (n, L)
    matrix, zero past them."""
    L = mat.shape[1]
    pos = torch.arange(L, device=mat.device)[None, :]
    out = torch.gather(mat, 1, torch.clamp(s[:, None] + pos, 0, L - 1))
    return torch.where(pos < out_len[:, None], out, 0)


def _device_eval(col: Column, steps) -> Column:
    n = col.size
    if n == 0:
        return Column.strings_from_list([], device=col.device)
    L = max(max_length(col), 1)  # host sync: the widest document
    pdt = torch.int16 if L + 8 < 2**15 else torch.int32
    valid = col.valid_bool()
    outs, lens_out, oks, hosts = [], [], [], []
    chunk = max(CHUNK_CELLS // L, 1)
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        mat, lens = byte_matrix(_rows(col, start, end), L)
        s, out_len, ok, need_host = _device_parse(
            mat, lens, valid[start:end], steps, pdt)
        outs.append(_cut(mat, s, out_len))
        lens_out.append(out_len)
        oks.append(ok)
        hosts.append(need_host)
        del mat
    out = torch.cat(outs)
    out_len = torch.cat(lens_out)
    ok = torch.cat(oks)
    rows = torch.nonzero(torch.cat(hosts))[:, 0]  # host sync: escape rows
    if rows.numel():
        out, out_len = _unescape_rows(out, out_len, rows)
    return strings_from_matrix(out, out_len, ok)


def _rows(col: Column, start: int, end: int) -> Column:
    """Rows [start, end) of a STRING column, sharing its chars (the
    validity is read separately)."""
    if start == 0 and end == col.size:
        return col
    offs = col.offsets.data[start:end + 1]
    return Column(col.dtype, end - start, None, children=(
        Column(col.offsets.dtype, end - start + 1, offs), col.child))


def _unescape_rows(out: torch.Tensor, out_len: torch.Tensor,
                   rows: torch.Tensor):
    """Unescape the escape-bearing string values on the host and write
    them back. Unescaping shrinks a span, but invalid UTF-8 bytes
    expand 1 -> 3 under errors="replace" (U+FFFD), so the matrix may
    widen."""
    count("get_json_object.host_unescape_rows", int(rows.numel()))
    set_attrs(host_unescape_rows=int(rows.numel()))
    raw = out[rows].cpu().numpy()
    lens = out_len[rows].cpu().numpy()
    new = [_unescape(raw[i, :lens[i]].tobytes().decode(
        "utf-8", errors="replace")).encode("utf-8", errors="replace")
        for i in range(rows.numel())]
    width = max(out.shape[1], max(len(b) for b in new))
    block = np.zeros((len(new), width), np.uint8)
    for i, b in enumerate(new):
        block[i, :len(b)] = np.frombuffer(b, np.uint8)
    if width > out.shape[1]:
        out = torch.nn.functional.pad(out, (0, width - out.shape[1]))
    out[rows] = torch.from_numpy(block).to(out.device)
    out_len = out_len.clone()
    out_len[rows] = torch.tensor([len(b) for b in new], dtype=out_len.dtype,
                                 device=out_len.device)
    return out, out_len


@traced("get_json_object.get_json_object")
def get_json_object(col: Column, path: str) -> Column:
    """Evaluate a JSONPath over every row of a STRING column.

    On the device route (see the module docstring) unless a field name
    holds a quote or a backslash: those take the native walker, or the
    Python walker without the library (their in-place byte compare would
    need unescape-aware matching)."""
    expects(col.dtype.id == TypeId.STRING, "get_json_object needs STRING")
    steps = _parse_path(path)
    if steps is None:
        return Column.strings_from_list([None] * col.size,
                                        device=col.device)
    if all(kind != "f" or (arg and '"' not in arg and "\\" not in arg)
           for kind, arg in steps):
        return _device_eval(col, steps)
    if native.available():
        return _native_eval(col, path)
    return _python_eval(col, steps)


def _native_eval(col: Column, path: str) -> Column:
    """The native C++ walker (``src/main/cpp/src/get_json_object.cpp``)
    over the column's host bytes."""
    valid = col.valid_bool().to(torch.uint8).cpu().numpy()
    got = native.get_json_object(col.child.data.cpu().numpy(),
                                 col.offsets.data.cpu().numpy(), valid, path)
    if got is None:  # a path the walker does not parse: all NULL
        return Column.strings_from_list([None] * col.size,
                                        device=col.device)
    buf, offs, ok = got
    out = [buf[offs[i]:offs[i + 1]].decode("utf-8") if ok[i] else None
           for i in range(col.size)]
    return Column.strings_from_list(out, device=col.device)


def _python_eval(col: Column, steps) -> Column:
    count("get_json_object.python_walker_rows", col.size)
    set_attrs(route="python_walker", rows=col.size)
    out = [None if r is None else _eval_py(r, steps)
           for r in col.to_pylist()]
    return Column.strings_from_list(out, device=col.device)
