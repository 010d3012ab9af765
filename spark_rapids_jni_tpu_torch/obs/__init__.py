"""Observability for the port: counters and spans.

The route counters (``rel.route.*``), the fallback counter
(``rel.fused_fallbacks``) and the dispatch/host-sync budget counters
(``rel.dispatches*``, ``rel.host_syncs*``) keep the reference's names,
so a run of either package reads the same way. A partitioned run
(``tpcds/dist.py``) adds the reference's mesh counters:
``rel.route.dist.{shard_table,broadcast_table,all_gather}``,
``rel.dist_fallbacks[.q]``, ``rel.route.shuffle.{single_shot,staged,
intra,neighborhood,budget_unmet}`` and the wire accounting
``shuffle.bytes_exchanged``, ``shuffle.bytes.<route>``,
``shuffle.rounds[.<route>]``, ``shuffle.peak_scratch_bytes``,
``shuffle.flat_peak_scratch_bytes``; ``shuffle_table`` counts
``shuffle.overflow_rows``, ``shuffle.retry_rounds`` and
``shuffle.retry_rows``. Every counter is this rank's. The out-of-core
runner (``exec/``) adds ``exec.morsel.*``, ``rel.morsel_*``, ``io.disk.*``
and ``mem.pool.*`` counters and gauges, the histograms
``exec.morsel.overlap_ns`` and ``io.disk.{read,decode,fold}_ns``, and
``memory.hbm_headroom_bytes``. Reports, SLO, flight-recorder and fleet
layers are not ported yet.
"""

from .metrics import (  # noqa: F401
    DISPATCH_COUNTER, HOST_SYNC_COUNTER, REGISTRY, count, count_dispatch,
    count_host_sync, dispatch_counts, gauge, kernel_stats, stats_since)
from .spans import (  # noqa: F401
    SpanRecord, set_attrs, span, span_records, traced)

__all__ = [
    "DISPATCH_COUNTER", "HOST_SYNC_COUNTER", "REGISTRY", "count",
    "count_dispatch", "count_host_sync", "dispatch_counts", "gauge",
    "kernel_stats",
    "stats_since", "SpanRecord", "set_attrs", "span", "span_records",
    "traced",
]
