"""Observability for the port: metrics, spans, reports and live telemetry.

Port of ``spark_rapids_jni_tpu/obs/``, one import:

- **metrics**: counters and gauges (always on), histograms and timers
  (``SRT_METRICS``), JSON and Prometheus exposition. The route counters
  (``rel.route.*``), ``rel.fused_fallbacks``, the dispatch/host-sync
  budget counters (``rel.dispatches*``, ``rel.host_syncs*``), the mesh's
  ``rel.route.dist.*``, ``rel.dist_fallbacks``, ``rel.route.shuffle.*``
  and ``shuffle.*``, the out-of-core runner's ``exec.morsel.*``,
  ``rel.morsel_*``, ``io.disk.*`` and ``mem.pool.*``, and the serving
  layer's ``serving.*`` keep the reference's names. Every counter is
  this rank's.
- **spans**: nesting wall-time ranges (``span``, ``traced``) feeding
  ``span.<name>`` histograms, scoped by ``span_mark``/``spans_since``,
  exported as Perfetto JSON.
- **recompile**: the compile events (the kernel library's first-use
  ``nvcc`` build), the eager analog of the reference's jit tracking.
- **report**: the per-query ``ExecutionReport`` that ``run_fused`` emits
  with ``SRT_METRICS`` on, and the query correlation ids
  (``mint_qid``, ``qid_scope``, ``current_qid``).
- **memory**: ``mem.device.<i>.*`` gauges from ``torch.cuda``, the
  headroom probe behind the morsel and exchange-scratch budgets, the
  report's ``memory`` section.
- **slo**: sliding-window latency sketches (``SLO_TRACKER``), exported
  as ``serving.slo.*`` gauges and, raw, as ``/slo.json`` for the fleet.
- **flight**: the always-on flight-recorder ring.
- **server**: the stdlib scrape endpoint (``/metrics``,
  ``/metrics.json``, ``/slo.json``, ``/healthz``, ``/reports``).
- **rollup** (``fleet_rollup``): the scrape-and-merge tier over N
  scrape endpoints (``/fleet/*``).
- **history** (``obs_history``): the bounded on-disk snapshot ring and
  the regression watch over it.
"""

from .metrics import (  # noqa: F401
    DEFAULT_BOUNDS_NS, DISPATCH_COUNTER, HOST_SYNC_COUNTER, Counter, Gauge,
    Histogram, MetricsRegistry, REGISTRY, count, count_dispatch,
    count_host_sync, counter, dispatch_counts, enabled, gauge, histogram,
    kernel_stats, parse_prometheus, prom_name, reset_kernel_stats,
    stats_since, timer)
from .spans import (  # noqa: F401
    SpanRecord, aggregate, current_span_name, export_perfetto,
    mark as span_mark, records_since as spans_since, reset_spans, set_attrs,
    span, span_records, traced)
from .recompile import (  # noqa: F401
    RecompileRecord, mark as recompile_mark, record_event,
    records_since as recompiles_since, recompile_records, reset_recompiles,
    signature_of)
from .report import (  # noqa: F401
    ExecutionReport, current_qid, emit, last_report, mint_qid, qid_scope,
    recent_reports, reset_reports)
from .memory import (  # noqa: F401
    device_memory_stats, device_used_fraction, hbm_headroom_bytes,
    native_arena_snapshot, probed_scratch_budget, reset_memory_probe,
    sample_device_memory)
from .slo import SloTracker, reset_slo  # noqa: F401
from .slo import TRACKER as SLO_TRACKER  # noqa: F401
from .flight import reset_flight  # noqa: F401
from .flight import dump as flight_dump  # noqa: F401
from .flight import note as flight_note  # noqa: F401
from .flight import snapshot as flight_snapshot  # noqa: F401
from . import server as obs_server  # noqa: F401
from . import rollup as fleet_rollup  # noqa: F401
from . import history as obs_history  # noqa: F401
from .history import reset_history  # noqa: F401


def reset_all() -> None:
    """Clear every obs buffer: the registry, the span ring, the compile
    records, the report ring, the SLO windows, the flight ring and the
    history's rate-limit latch. Not the memory-probe memo
    (``memory.reset_memory_probe``)."""
    reset_kernel_stats()
    reset_spans()
    reset_recompiles()
    reset_reports()
    reset_slo()
    reset_flight()
    reset_history()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_BOUNDS_NS", "DISPATCH_COUNTER", "HOST_SYNC_COUNTER",
    "count", "counter", "gauge", "histogram", "timer", "enabled",
    "kernel_stats", "reset_kernel_stats", "stats_since",
    "count_dispatch", "count_host_sync", "dispatch_counts",
    "prom_name", "parse_prometheus",
    "SpanRecord", "span", "traced", "set_attrs", "current_span_name",
    "span_mark", "spans_since", "span_records", "reset_spans",
    "export_perfetto", "aggregate",
    "RecompileRecord", "signature_of", "record_event", "recompile_mark",
    "recompiles_since", "recompile_records", "reset_recompiles",
    "ExecutionReport", "emit", "recent_reports", "last_report",
    "reset_reports", "mint_qid", "current_qid", "qid_scope",
    "sample_device_memory", "device_memory_stats", "hbm_headroom_bytes",
    "device_used_fraction", "probed_scratch_budget",
    "native_arena_snapshot", "reset_memory_probe",
    "SloTracker", "SLO_TRACKER", "reset_slo",
    "flight_note", "flight_dump", "flight_snapshot", "reset_flight",
    "obs_server", "fleet_rollup", "obs_history", "reset_history",
    "reset_all",
]
