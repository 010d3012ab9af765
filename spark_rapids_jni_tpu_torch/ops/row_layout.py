"""The row format's fixed-width layout, shared by K6's plan
(``cuda_kernels.pack_plan``) and ``row_conversion``.

Mirrors ``spark_rapids_jni_tpu/ops/row_conversion.py`` (reference:
``row_conversion.cu:417-456``): each column aligned to its own width,
validity bytes right after the last column, the row padded to 8 bytes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def align_offset(offset: int, alignment: int) -> int:
    """Reference: row_conversion.cu:417-419."""
    return (offset + alignment - 1) & ~(alignment - 1)


def fixed_width_layout(widths: Sequence[int]) -> Tuple[int, List[int], int]:
    """(size_per_row, column starts, validity offset) for byte widths
    (row_conversion.cu:432-456)."""
    starts: List[int] = []
    at = 0
    for w in widths:
        at = align_offset(at, w)
        starts.append(at)
        at += w
    return align_offset(at + (len(widths) + 7) // 8, 8), starts, at
