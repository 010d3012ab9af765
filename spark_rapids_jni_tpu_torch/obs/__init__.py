"""Observability for the port: counters and spans.

The route counters (``rel.route.*``), the fallback counter
(``rel.fused_fallbacks``) and the dispatch/host-sync budget counters
(``rel.dispatches*``, ``rel.host_syncs*``) keep the reference's names,
so a run of either package reads the same way. Reports, memory, SLO,
flight-recorder and fleet layers are not ported yet.
"""

from .metrics import (  # noqa: F401
    DISPATCH_COUNTER, HOST_SYNC_COUNTER, REGISTRY, count, count_dispatch,
    count_host_sync, dispatch_counts, kernel_stats, stats_since)
from .spans import (  # noqa: F401
    SpanRecord, set_attrs, span, span_records, traced)

__all__ = [
    "DISPATCH_COUNTER", "HOST_SYNC_COUNTER", "REGISTRY", "count",
    "count_dispatch", "count_host_sync", "dispatch_counts", "kernel_stats",
    "stats_since", "SpanRecord", "set_attrs", "span", "span_records",
    "traced",
]
