"""The least time of a piece of work on one NVIDIA H100 SXM, from the
bytes it has to move: the yardstick of every ``*_roofline`` metric.

The byte counts are computed from the schema and the row count alone,
each input byte read once and each output byte written once, so they
read the same work whatever implements it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet


def least_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def align(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) // alignment * alignment


def row_layout(widths: Sequence[int]) -> Tuple[int, list, int]:
    """(row bytes, column starts, validity offset) of the row format:
    each column at an offset aligned to its own width, one validity
    byte per 8 columns right after the last column, the row padded to 8
    bytes."""
    starts, at = [], 0
    for w in widths:
        at = align(at, w)
        starts.append(at)
        at += w
    return align(at + (len(widths) + 7) // 8, 8), starts, at


def column_bytes(widths: Sequence[int], n_rows: int) -> int:
    """The columns' data and their validity words (32 rows a 4-byte
    word, one word array per column)."""
    return (n_rows * sum(widths)
            + len(widths) * 4 * ((n_rows + 31) // 32))


def conversion_bytes(widths: Sequence[int], n_rows: int) -> int:
    """One conversion either way: the columns and their validity read
    (or written) once, the rows written (or read) once."""
    return column_bytes(widths, n_rows) + n_rows * row_layout(widths)[0]
