"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device.
There is no quiet drop to the CPU: asking for the default without a GPU
raises.
"""

from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager
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


# uploads memoized by content on this thread (memoized_uploads)
_uploads = threading.local()


@contextmanager
def memoized_uploads(store: dict):
    """Within the block, ``host_to_device`` on this thread answers an
    upload of content it has uploaded before (same bytes, dtype, shape and
    device) from ``store`` instead of copying again, and keeps each pinned
    source alive in ``store`` too. The batched runner holds one store on
    each batch-cache entry: the uploads a plan makes (look-up tables over
    dictionaries, which the entry's key fixes) land once, in its warm-up,
    and the captured graph then reads them from the card, with no host
    copy in it."""
    prev = getattr(_uploads, "store", None)
    _uploads.store = store
    try:
        yield store
    finally:
        _uploads.store = prev


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To a GPU it goes from pinned memory
    without blocking, so a plan that uploads a small table mid-query
    (a string look-up table, a category byte matrix) does not make the
    host wait for the card. Callers never write into the result: under
    ``memoized_uploads`` it is shared."""
    arr = np.require(arr, requirements=("C", "W"))
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t.to(device)
    store = getattr(_uploads, "store", None)
    if store is None:
        return t.pin_memory().to(device, non_blocking=True)
    key = (str(device), str(arr.dtype), arr.shape,
           hashlib.sha1(arr.tobytes()).hexdigest())
    hit = store.get(key)
    if hit is None:
        pinned = t.pin_memory()
        hit = store[key] = (pinned.to(device, non_blocking=True), pinned)
    return hit[0]
