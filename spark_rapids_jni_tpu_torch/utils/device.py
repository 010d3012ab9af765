"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device.
There is no quiet drop to the CPU: asking for the default without a GPU
raises.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .errors import CudfLikeError


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    must then be available."""
    if device is None:
        if not torch.cuda.is_available():
            raise CudfLikeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudfLikeError(f"device {device!r} requested but CUDA is "
                            "not available")
    return dev


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To a GPU it goes from pinned memory
    without blocking, so a plan that uploads a small table mid-query
    (a string look-up table, a category byte matrix) does not make the
    host wait for the card."""
    t = torch.from_numpy(np.require(arr, requirements=("C", "W")))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
