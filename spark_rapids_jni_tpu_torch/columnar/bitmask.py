"""Validity bitmasks: packed little-endian uint32 words, 1 = valid.

cudf's layout (bit r % 32 of word r / 32). ``pack`` goes through K3
(``ops/cuda_kernels.bitmask_pack``): a bit-gathering kernel on CUDA
tensors, its plain reshape-and-weighted-sum version on CPU tensors.
torch has no uint32 shifts, so ``unpack`` widens the words to int64.
``pack_bytes``/``unpack_bytes`` are the row format's per-row validity
bytes: bit ``c % 8`` of byte ``c / 8`` is column ``c``. ``pack_fields``
packs every column of such bytes at once, through K3's table form
(``ops/cuda_kernels.bitmask_pack_fields``: one launch on CUDA tensors).
"""

from __future__ import annotations

import numpy as np
import torch

BITS_PER_WORD = 32


def num_words(n_rows: int) -> int:
    return (n_rows + BITS_PER_WORD - 1) // BITS_PER_WORD


def pack(valid: torch.Tensor) -> torch.Tensor:
    """bool (N,) -> uint32 words (num_words(N),), LSB-first, padding 0."""
    from ..ops.cuda_kernels import bitmask_pack
    return bitmask_pack(valid.to(torch.bool))


def pack_fields(vbytes: torch.Tensor, n_fields: int) -> torch.Tensor:
    """uint8 (N, ceil(n_fields / 8)) validity bytes, at any row stride ->
    uint32 (n_fields, num_words(N)): row ``c`` is column ``c``'s words,
    equal to ``pack(unpack_bytes(vbytes, n_fields)[:, c])``."""
    from ..ops.cuda_kernels import bitmask_pack_fields
    return bitmask_pack_fields(vbytes, n_fields)


def unpack(words: torch.Tensor, n_rows: int) -> torch.Tensor:
    """uint32 words -> bool (n_rows,)."""
    w64 = words.to(torch.int64)
    lanes = torch.arange(BITS_PER_WORD, dtype=torch.int64,
                         device=words.device)
    bits = (w64[:, None] >> lanes[None, :]) & 1
    return bits.reshape(-1)[:n_rows].to(torch.bool)


def pack_bytes(valid: torch.Tensor, n_fields: int) -> torch.Tensor:
    """bool (N, n_fields) -> uint8 (N, ceil(n_fields / 8)), 8 fields a
    byte, LSB-first, padding bits 0."""
    n = valid.shape[0]
    nbytes = (n_fields + 7) // 8
    bits = torch.zeros((n, nbytes * 8), dtype=torch.int32,
                       device=valid.device)
    bits[:, :n_fields] = valid.to(torch.int32)
    weights = torch.ones(8, dtype=torch.int32, device=valid.device) \
        << torch.arange(8, dtype=torch.int32, device=valid.device)
    return (bits.reshape(n, nbytes, 8) * weights).sum(dim=2) \
        .to(torch.uint8)


def unpack_bytes(vbytes: torch.Tensor, n_fields: int) -> torch.Tensor:
    """Inverse of :func:`pack_bytes`: uint8 (N, nbytes) -> bool
    (N, n_fields)."""
    n, nbytes = vbytes.shape
    lanes = torch.arange(8, dtype=torch.int32, device=vbytes.device)
    bits = (vbytes.to(torch.int32)[:, :, None] >> lanes) & 1
    return bits.reshape(n, nbytes * 8)[:, :n_fields].to(torch.bool)


def count_unset(words: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Null count: the zero bits among the first ``n_rows`` (an int32
    scalar tensor on the words' device)."""
    return n_rows - unpack(words, n_rows).sum(dtype=torch.int32)


def all_valid_words(n_rows: int) -> np.ndarray:
    """Host-side all-valid mask (trailing padding bits zeroed)."""
    w = num_words(n_rows)
    out = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    tail = n_rows % BITS_PER_WORD
    if w and tail:
        out[-1] = (1 << tail) - 1
    return out


def pack_host(valid: np.ndarray) -> np.ndarray:
    """Host-side (numpy) pack, LSB-first per 32-bit word."""
    n = valid.shape[0]
    w = num_words(n)
    padded = np.zeros(w * 32, dtype=np.uint32)
    padded[:n] = valid.astype(np.uint32)
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (padded.reshape(w, 32) * weights).sum(axis=1, dtype=np.uint32)
