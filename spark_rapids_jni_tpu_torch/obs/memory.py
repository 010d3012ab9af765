"""Device-memory headroom: the probe behind the morsel budget.

Port of ``hbm_headroom_bytes`` from ``spark_rapids_jni_tpu/obs/memory.py``
(the rest of that module comes with the serving layer). The reference
reads ``bytes_limit - bytes_in_use`` from the backend's memory stats,
where bytes in use are the live buffers'. Here the free bytes come from
``torch.cuda.mem_get_info``, plus what PyTorch's caching allocator holds
reserved but not allocated: that memory is free to the port's next
allocation, though ``mem_get_info`` counts it used (after a run that
peaked at tens of GiB, ``mem_get_info`` alone reports a fraction of what
the port can allocate). A CPU device reports nothing, so the probe is None
there, as it is on the reference's CPU backend.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

_lock = threading.Lock()
# a test seam: a callable returning one dict a device with the keys
# bytes_in_use and bytes_limit (utils/faults.FakeDeviceMemory)
_stats_source: "Optional[Callable[[], list]]" = None  # guarded-by: _lock


def set_stats_source_for_testing(fn: "Optional[Callable[[], list]]"
                                 ) -> None:
    """Serve the probe from ``fn`` instead of the card (None restores
    the card)."""
    global _stats_source
    with _lock:
        _stats_source = fn


def hbm_headroom_bytes(device=None) -> Optional[int]:
    """Bytes the port could still allocate on ``device`` (default: the
    current CUDA device): ``mem_get_info``'s free bytes and the caching
    allocator's unallocated reserve. None when nothing reports: a CPU
    device, or no card. With a test source installed, the minimum
    ``bytes_limit - bytes_in_use`` over its devices, as the reference
    reads its backend."""
    with _lock:
        src = _stats_source
    if src is not None:
        heads = [s["bytes_limit"] - s["bytes_in_use"] for s in src()
                 if s is not None and "bytes_limit" in s]
        return max(0, min(heads)) if heads else None
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free) + int(cached)
