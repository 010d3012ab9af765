"""Environment knobs this slice reads.

The reference resolves knobs in three tiers (env > tuned winner > code
default); the tuning tier is not ported yet, so every knob here is an
environment read with a code default. The route knobs keep the
reference's names: ``SRT_JOIN_METHOD`` (``auto``/``xla``/``cuda``) and
``SRT_DENSE_GROUPBY`` (``auto``/``scatter``/``onehot``/``cuda``), with
``cuda`` in place of the reference's ``pallas``, and
``SRT_STRING_ROUTE`` (``auto``/``dict``/``bytes``) picks the string
operators' route. ``SRT_METRICS`` turns the gated obs tier on:
histograms, spans, SLO latency samples and one ``ExecutionReport`` a
``run_fused`` call. ``TZDIR`` names the TZif database the timezone
operators read.

The serving and obs knobs keep the reference's names and defaults:
``SRT_TRACE_EXPORT`` (a directory the reports and flight dumps are
written to), ``SRT_OBS_HTTP_PORT`` / ``SRT_OBS_HTTP_HOST`` (the scrape
endpoint), ``SRT_SLO_WINDOW_S`` / ``SRT_SLO_WINDOWS``,
``SRT_FLIGHT_MIN_INTERVAL_S``, ``SRT_RESULT_CACHE_BYTES`` (the result
cache's cap; unset or 0 = off), ``SRT_SHUFFLE_SCRATCH_HEADROOM_FRACTION``
(the probed headroom's share granted to exchange scratch, default 1/4),
``SRT_QUERY_RETRIES``, ``SRT_RETRY_BACKOFF_MS``, ``SRT_QUERY_DEADLINE_MS``
(``serving/reliability.RetryPolicy.from_env``, read by the fleet
scheduler) and ``SRT_CONTROL_PLANE`` (refused until the control plane is
ported). The micro-batching knobs (``ops/fused_pipeline.py``,
``serving/``): ``SRT_BATCH_MAX`` (queries a batched dispatch coalesces,
clamped to the capacity ladder 2/4/8/16), ``SRT_BATCH_ROUTE``
(``auto``/``padded``/``ragged``), ``SRT_BATCH_WINDOW_MS`` (a fixed
coalescing window; unset = the adaptive one),
``SRT_BATCH_WINDOW_MAX_MS`` (its ceiling, default 5) and
``SRT_PLAN_CACHE_SIZE`` (batch-cache entries kept, default 64).

The mesh knobs keep the reference's names, defaults and normalisation:
``SRT_BROADCAST_THRESHOLD`` (bytes; tables at or below it replicate),
``SRT_GROUPBY_PSUM_WIDTH`` (slots; wider dense groupbys merge by
reduce-scatter), ``SRT_SHUFFLE_JOIN_ROUTE``
(``auto``/``exchange``/``reduce_scatter``), ``SRT_SHUFFLE_SCRATCH_BYTES``
(the per-device exchange scratch budget; unset or 0 = unlimited),
``SRT_SHUFFLE_INTRA`` (``auto``/``flat``) and ``SRT_SHUFFLE_NEIGHBORHOOD``
(the neighbourhood size ``g``; below 2 = the flat exchange). Every rank
of a mesh must read the same values: they decide which collectives run.

The out-of-core knobs (``exec/``) keep the reference's names and
defaults: ``SRT_MORSEL_BYTES`` (the streamed window's byte budget; unset
or 0 = the probed headroom), ``SRT_MORSEL_HEADROOM_FRACTION`` (the share
of the probed free device memory granted to the window, default 1/8),
``SRT_PAGE_BYTES`` (the page ledger's page size, default 64 KiB),
``SRT_PAGE_POOL_BYTES`` (the pool's budget, default 256 MiB; 0 or less
turns the paged staging route off), ``SRT_DISK_PREFETCH_DEPTH`` (row
groups a Parquet table decodes ahead, default 2), ``SRT_DISK_ZONEMAP``
(footer zone-map skipping, default on) and ``SRT_STANDING_CACHE_SIZE``
(standing-query accumulators kept, default 32).
"""

from __future__ import annotations

import os


def env_str(name: str, default: str) -> str:
    """String env knob: unset -> ``default``, otherwise the raw value."""
    v = os.environ.get(name)
    return default if v is None else v


def env_int(name: str, default):
    """Tolerant int env knob: unset/blank/malformed -> ``default``."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    """Tolerant float env knob: unset/blank/malformed -> ``default``."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def env_bool(name: str, default: bool) -> bool:
    """Tolerant bool env knob: unset/blank or unrecognized -> default."""
    v = os.environ.get(name, "").strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return default


def join_method() -> str:
    return env_str("SRT_JOIN_METHOD", "auto")


def dense_groupby_mode() -> str:
    return env_str("SRT_DENSE_GROUPBY", "auto")


def string_route() -> str:
    """``SRT_STRING_ROUTE``: ``auto`` (which picks ``dict``) | ``dict``
    (the host look-up table over the dictionary) | ``bytes`` (the
    categories' bytes on the device); anything else reads as ``auto``."""
    mode = env_str("SRT_STRING_ROUTE", "auto")
    return mode if mode in ("auto", "dict", "bytes") else "auto"


def tzdir() -> str:
    """``TZDIR``: the directory of TZif zone files."""
    return env_str("TZDIR", "/usr/share/zoneinfo")


def metrics_enabled() -> bool:
    return env_bool("SRT_METRICS", False)
