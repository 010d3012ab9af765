"""Back-compat shim over the obs package.

Port of ``spark_rapids_jni_tpu/utils/tracing.py``: the kernel counters
and the span helpers under their old import path. New code imports
from ``spark_rapids_jni_tpu_torch.obs``.
"""

from __future__ import annotations

from ..obs.metrics import (  # noqa: F401
    DISPATCH_COUNTER, HOST_SYNC_COUNTER, count, count_dispatch,
    count_host_sync, dispatch_counts, kernel_stats, reset_kernel_stats,
    stats_since)
from ..obs.spans import span, traced  # noqa: F401
