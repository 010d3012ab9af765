"""Bloom filter build, merge and probe over a key column.

Port of ``spark_rapids_jni_tpu/ops/bloom_filter.py``. The filter is
uint32 words, bit ``p % 32`` of word ``p / 32``. A key's k bit positions
come from double hashing of its XXHash64 (seed 0): ``h1 + i * h2`` for
i = 1..k, with h1 and h2 the hash's low and high 32 bits, negatives
folded by ``~`` and the result taken mod the bit count; the order of
operations is the reference's, so the positions are equal. The build
sets the bits of every valid key in a bool plane (setting a bit twice
is idempotent: no atomics) and packs the plane with K3
(``bitmask.pack``). torch has no uint32 shifts, so the probe reads the
words widened to int64.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar import Column, bitmask
from ..obs import traced
from ..utils.errors import expects
from .hashing import xxhash64_column

_BITS_PER_WORD = 32
_LO32 = 0xFFFFFFFF


def _positions(col: Column, num_bits: int, num_hashes: int) -> torch.Tensor:
    """(N, k) int64 bit positions by double hashing of xxhash64(key)."""
    h = xxhash64_column(col, seed=0)
    h1 = h & _LO32
    h2 = (h >> 32) & _LO32  # the logical shift of the uint64 bits
    i = torch.arange(1, num_hashes + 1, dtype=torch.int64,
                     device=h.device)[None, :]
    combined = h1[:, None] + i * h2[:, None]
    combined = torch.where(combined < 0, ~combined, combined)
    return combined % num_bits


@traced("bloom_filter.build")
def build(col: Column, num_bits: int = 1 << 20,
          num_hashes: int = 3) -> torch.Tensor:
    """A bloom filter over a column -> uint32 words (num_bits / 32,).
    Null keys set no bit (Spark: null never passes the filter)."""
    expects(num_bits > 0 and num_bits % _BITS_PER_WORD == 0,
            "num_bits must be word-aligned")
    pos = _positions(col, num_bits, num_hashes)
    if col.validity is not None:
        # a null row's bits go to a scratch slot past the end
        pos = torch.where(col.valid_bool()[:, None], pos, num_bits)
    plane = torch.zeros(num_bits + 1, dtype=torch.bool, device=pos.device)
    plane[pos.reshape(-1)] = True
    return bitmask.pack(plane[:num_bits])


@traced("bloom_filter.merge")
def merge(filters: Sequence[torch.Tensor]) -> torch.Tensor:
    """OR of filters built with the same parameters."""
    expects(len(filters) > 0, "need at least one filter")
    out = filters[0].view(torch.int32)
    for f in filters[1:]:
        expects(f.shape == filters[0].shape, "filters differ in size")
        out = out | f.view(torch.int32)
    return out.view(torch.uint32)


@traced("bloom_filter.probe")
def probe(filter_words: torch.Tensor, col: Column,
          num_hashes: int = 3) -> torch.Tensor:
    """(N,) bool: possibly present (no false negatives); nulls False."""
    num_bits = int(filter_words.shape[0]) * _BITS_PER_WORD
    pos = _positions(col, num_bits, num_hashes)
    words = filter_words.view(torch.int32).to(torch.int64) & _LO32
    bits = (words[pos // _BITS_PER_WORD] >> (pos % _BITS_PER_WORD)) & 1
    hit = (bits == 1).all(dim=1)
    if col.validity is not None:
        hit &= col.valid_bool()
    return hit
