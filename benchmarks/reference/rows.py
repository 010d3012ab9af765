"""The plain reference of the row format, in PyTorch on raw tensors.

The format (spark-rapids-jni ``RowConversion.java``): each column's
little-endian bytes at an offset aligned to its own width, one validity
byte per 8 columns right after the last column (bit ``c % 8`` of byte
``c / 8``, 1 = valid), the row padded to 8 bytes. A null slot's bytes
and the padding carry nothing, so only the valid slots and the validity
bytes are judged.

Columns are given as raw tensors: each column's data (1-D, elements of
its width) and its validity as packed 32-bit words, LSB first.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

BLOCK_ROWS = 1 << 20


def layout(widths: Sequence[int]):
    """(row bytes, column starts, validity offset)."""
    starts, at = [], 0
    for w in widths:
        at = (at + w - 1) // w * w
        starts.append(at)
        at += w
    size = (at + (len(widths) + 7) // 8 + 7) // 8 * 8
    return size, starts, at


def unpack_words(words: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of a validity word array as bool (``lo`` a
    multiple of 32)."""
    w = words[lo // 32:(hi + 31) // 32].view(torch.int32).to(torch.int64)
    bits = (w[:, None] >> torch.arange(32, device=w.device)) & 1
    return bits.reshape(-1)[:hi - lo].to(torch.bool)


def pack_words(valid: torch.Tensor) -> torch.Tensor:
    """bool (N,) -> uint32 validity words, LSB first, padding 0."""
    n = valid.shape[0]
    bits = torch.zeros((n + 31) // 32 * 32, dtype=torch.int64,
                       device=valid.device)
    bits[:n] = valid.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=valid.device) \
        << torch.arange(32, device=valid.device)
    words = (bits.reshape(-1, 32) * weights).sum(dim=1)
    return words.to(torch.int32).view(torch.uint32)


def _bytes(col: torch.Tensor) -> torch.Tensor:
    return col.contiguous().view(torch.uint8).reshape(col.shape[0], -1)


def _as_float32(col: torch.Tensor) -> torch.Tensor:
    """The control's precision: a float64 column through float32."""
    if col.dtype == torch.float64:
        return col.to(torch.float32).to(torch.float64)
    return col


def pack(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
         control: bool = False) -> torch.Tensor:
    """The reference's (N, row bytes) uint8 rows of the columns, null
    slots and padding 0; ``control`` packs float64 columns through
    float32 (the control, put in the program's place)."""
    widths = [d.element_size() for d in datas]
    size, starts, voff = layout(widths)
    n, nb = datas[0].shape[0], (len(widths) + 7) // 8
    out = torch.zeros((n, size), dtype=torch.uint8, device=datas[0].device)
    for lo in range(0, n, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, n)
        valid = torch.stack([unpack_words(v, lo, hi) for v in valids],
                            dim=1)
        for c, (d, s, w) in enumerate(zip(datas, starts, widths)):
            src = d[lo:hi]
            b = _bytes(_as_float32(src) if control else src)
            out[lo:hi, s:s + w] = torch.where(valid[:, c:c + 1], b, 0)
        out[lo:hi, voff:voff + nb] = _validity_bytes(valid, nb)
    return out


def _validity_bytes(valid: torch.Tensor, nb: int) -> torch.Tensor:
    """bool (N, k) -> the rows' (N, nb) validity bytes."""
    bits = torch.zeros((valid.shape[0], nb * 8), dtype=torch.int32,
                       device=valid.device)
    bits[:, :valid.shape[1]] = valid.to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=valid.device)
    return (bits.reshape(-1, nb, 8) * weights).sum(2).to(torch.uint8)


def row_mismatches(rows: List[torch.Tensor], datas: Sequence[torch.Tensor],
                   valids: Sequence[torch.Tensor],
                   control: bool = False) -> int:
    """Cells that disagree between the row batches ``rows`` ((N_b,
    row bytes) uint8 each, in order) and the reference's rows of the
    columns: a valid slot whose bytes differ, a row whose validity
    bytes differ, every cell of a row the batches leave out. ``control``
    computes the reference one precision below the columns' own (the
    control)."""
    widths = [d.element_size() for d in datas]
    size, starts, voff = layout(widths)
    nb = (len(widths) + 7) // 8
    bad, at = 0, 0
    for batch in rows:
        n = batch.shape[0]
        if batch.shape[1] != size:
            return n * (len(widths) + 1)
        for lo in range(0, n, BLOCK_ROWS):
            hi = min(lo + BLOCK_ROWS, n)
            got = batch[lo:hi]
            valid = torch.stack([unpack_words(v, at + lo, at + hi)
                                 for v in valids], dim=1)
            for c, (d, s, w) in enumerate(zip(datas, starts, widths)):
                src = d[at + lo:at + hi]
                want = _bytes(_as_float32(src) if control else src)
                diff = (got[:, s:s + w] != want).any(dim=1)
                bad += int((diff & valid[:, c]).sum())
            vbytes = _validity_bytes(valid, nb)
            bad += int((got[:, voff:voff + nb] != vbytes).any(dim=1).sum())
        at += n
    # rows the batches left out (or added) disagree in every cell
    return bad + abs(datas[0].shape[0] - at) * (len(widths) + 1)


def column_mismatches(back: List[List[tuple]], datas: Sequence[torch.Tensor],
                      valids: Sequence[torch.Tensor],
                      control: bool = False) -> int:
    """Cells that disagree between the columns converted back from the
    row batches (``back[b][c]`` = (data, validity words) of column ``c``
    of batch ``b``) and the original columns: a row whose validity
    differs, a valid value whose bytes differ, every cell of a row left
    out. ``control`` reads the original float64 columns through float32
    (the control)."""
    bad, at = 0, 0
    for cols in back:
        n = cols[0][0].shape[0]
        for lo in range(0, n, BLOCK_ROWS):
            hi = min(lo + BLOCK_ROWS, n)
            for (data, words), d, v in zip(cols, datas, valids):
                ok = unpack_words(v, at + lo, at + hi)
                got_ok = unpack_words(words, lo, hi)
                src = d[at + lo:at + hi]
                want = _bytes(_as_float32(src) if control else src)
                diff = (_bytes(data[lo:hi]) != want).any(dim=1) & ok
                bad += int((diff | (got_ok != ok)).sum())
        at += n
    return bad + abs(datas[0].shape[0] - at) * len(datas)
