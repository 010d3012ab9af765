"""Bit-exact float <-> integer reinterpretation.

The reference needs an arithmetic IEEE-754 bit extraction because its
TPU backend cannot bitcast from float64. PyTorch reinterprets storage
directly on every device (``Tensor.view(dtype)``), so the extraction
is one view here.
"""

from __future__ import annotations

import torch


def float64_to_bits(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 holding the IEEE-754 bit pattern."""
    return x.contiguous().view(torch.int64)


def bits_to_float64(bits: torch.Tensor) -> torch.Tensor:
    """An integer bit pattern -> float64 (narrower integers widen with
    their sign, as the reference's cast to uint64 does)."""
    if bits.element_size() != 8:
        bits = bits.to(torch.int64)
    return bits.contiguous().view(torch.float64)


def float32_to_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 holding the IEEE-754 bit pattern."""
    return x.contiguous().view(torch.int32)
