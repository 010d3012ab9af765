"""Environment knobs and the tuned tier.

A knob resolves in three tiers, as in the reference: an explicit
``SRT_*`` environment value, then the tuned winner (the revision-keyed
table ``tune/store.py`` resolves for this torch, CUDA, card and kernel
library), then the code default (``tuned_str``, ``tuned_int``,
``tuned_float``). An operator's environment value always wins over a
measurement; a malformed one falls through to the tuned tier. The tuned
reads: the join route and K1's capacity cap (``ops/join.py``), the
dense groupby route and the batch ceiling
(``ops/fused_pipeline.py``), the exchange scratch budget, the intra
route and the neighbourhood size (``parallel/comm_plan.py``), the
morsel headroom fraction (``exec/morsel.py``) and the Parquet prefetch
depth (``exec/disk_table.py``); the ones that shape a plan ride
``tpcds/rel.planner_env_key`` through ``tune.tuned_planner_key``. Every
other knob is an environment read with a code default. The route knobs keep the
reference's names: ``SRT_JOIN_METHOD`` (``auto``/``xla``/``cuda``) and
``SRT_DENSE_GROUPBY`` (``auto``/``scatter``/``onehot``/``cuda``), with
``cuda`` in place of the reference's ``pallas``, and
``SRT_STRING_ROUTE`` (``auto``/``dict``/``bytes``) picks the string
operators' route. ``SRT_METRICS`` turns the gated obs tier on:
histograms, spans, SLO latency samples and one ``ExecutionReport`` a
``run_fused`` call. ``TZDIR`` names the TZif database the timezone
operators read.

The runtime switches are the reference's ``Config`` fields, with their
names, knobs and defaults: ``trace_enabled`` (``SRT_TRACE_ENABLED``: every
span and ``traced`` op opens a ``torch.profiler.record_function`` range
``srt::<name>``, the analog of cudf's NVTX switch), ``metrics_enabled``
(``SRT_METRICS``), ``trace_export`` (``SRT_TRACE_EXPORT``; ``None``
reads as unset) and ``control_plane_enabled`` (``SRT_CONTROL_PLANE``).
``get_config()`` reads each field at access: a value given to
``set_config`` wins over the environment until ``reset_config``;
otherwise the knob is read anew each time, so a caller that sets the
environment sees the change at once. Four of the reference's fields are
left out, as nothing here would read them: ``use_pallas`` (on a CUDA
tensor the port always takes its kernel), ``shape_bucket_floor`` (the
port compiles no program per shape, so it buckets no row counts),
``refcount_debug`` (no code of either package reads it) and
``memory_log_level`` (the native arena reads ``SRT_MEMORY_LOG_LEVEL``
from its own environment, never through ``Config``, so a field would
be a setting with no effect). ``set_config`` raises on each of them.

The serving and obs knobs keep the reference's names and defaults:
``SRT_TRACE_EXPORT`` (a directory the reports and flight dumps are
written to), ``SRT_OBS_HTTP_PORT`` / ``SRT_OBS_HTTP_HOST`` (the scrape
endpoint), ``SRT_SLO_WINDOW_S`` / ``SRT_SLO_WINDOWS``,
``SRT_FLIGHT_MIN_INTERVAL_S``, ``SRT_RESULT_CACHE_BYTES`` (the result
cache's cap; unset or 0 = off), ``SRT_SHUFFLE_SCRATCH_HEADROOM_FRACTION``
(the probed headroom's share granted to exchange scratch, default 1/4),
``SRT_QUERY_RETRIES``, ``SRT_RETRY_BACKOFF_MS``, ``SRT_QUERY_DEADLINE_MS``
(``serving/reliability.RetryPolicy.from_env``, read by the fleet
scheduler), ``SRT_CONTROL_PLANE`` and its per-loop knobs
(``serving/control_plane.ControlPolicy.from_env``), the history's
``SRT_OBS_HISTORY*`` and the rollup's ``SRT_FLEET_*``, and
``SRT_AOT_CACHE_DIR`` (the disk tier: the kernel library, the capture
manifest and, under ``tuned/``, the tuner's winners; unset = off) with
``SRT_TUNE_DISABLE``, ``SRT_TUNE_WARMUP`` and ``SRT_TUNE_SAMPLES``.
The micro-batching knobs (``ops/fused_pipeline.py``,
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


def env_is_set(name: str) -> bool:
    """True when ``name`` is in the environment at all (even empty): the
    condition under which it outranks a tuned winner."""
    return os.environ.get(name) is not None


def _tuned_winner(name: str):
    # imported here: tune.store imports this module
    from .tune.store import active_winner
    return active_winner(name)


def tuned_str(name: str, default: str) -> str:
    """String knob with the tuned tier: env > tuned winner > default."""
    v = os.environ.get(name)
    if v is not None:
        return v
    w = _tuned_winner(name)
    return default if w is None else w


def tuned_int(name: str, default):
    """Int knob with the tuned tier; a malformed value at either tier
    falls through to the next."""
    v = os.environ.get(name, "").strip()
    if v:
        try:
            return int(v)
        except ValueError:
            pass
    w = _tuned_winner(name)
    if w is not None:
        try:
            return int(str(w).strip())
        except ValueError:
            pass
    return default


def tuned_float(name: str, default):
    """Float knob with the tuned tier (tolerant like ``tuned_int``)."""
    v = os.environ.get(name, "").strip()
    if v:
        try:
            return float(v)
        except ValueError:
            pass
    w = _tuned_winner(name)
    if w is not None:
        try:
            return float(str(w).strip())
        except ValueError:
            pass
    return default


def join_method() -> str:
    return tuned_str("SRT_JOIN_METHOD", "auto")


def dense_groupby_mode() -> str:
    return tuned_str("SRT_DENSE_GROUPBY", "auto")


def string_route() -> str:
    """``SRT_STRING_ROUTE``: ``auto`` (which picks ``dict``) | ``dict``
    (the host look-up table over the dictionary) | ``bytes`` (the
    categories' bytes on the device); anything else reads as ``auto``."""
    mode = env_str("SRT_STRING_ROUTE", "auto")
    return mode if mode in ("auto", "dict", "bytes") else "auto"


def tzdir() -> str:
    """``TZDIR``: the directory of TZif zone files."""
    return env_str("TZDIR", "/usr/share/zoneinfo")


# --- the runtime Config (the reference's ``Config``/``get_config``/
# ``set_config``) ------------------------------------------------------

# field -> (environment knob, parser, default), as in the reference
_CONFIG_FIELDS = {
    "trace_enabled": ("SRT_TRACE_ENABLED", env_bool, False),
    "metrics_enabled": ("SRT_METRICS", env_bool, False),
    "trace_export": ("SRT_TRACE_EXPORT", env_str, ""),
    "control_plane_enabled": ("SRT_CONTROL_PLANE", env_bool, False),
}
_overrides: dict = {}  # field -> the value set_config gave it
_UNSET = object()


class Config:
    """The runtime switches, read field by field: a value given to
    :func:`set_config` until :func:`reset_config`, else the field's
    environment knob, read at each access (so a changed environment is
    seen at once), else its default."""

    __slots__ = ()

    def __getattr__(self, name: str):
        value = _overrides.get(name, _UNSET)
        if value is not _UNSET:
            return value
        spec = _CONFIG_FIELDS.get(name)
        if spec is None:
            raise AttributeError(f"unknown config key {name!r}")
        knob, parse, default = spec
        return parse(knob, default)

    def __setattr__(self, name: str, value) -> None:
        set_config(**{name: value})

    def __repr__(self) -> str:
        return "Config(" + ", ".join(f"{k}={getattr(self, k)!r}"
                                     for k in _CONFIG_FIELDS) + ")"


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    """Set fields; each wins over its environment knob until
    :func:`reset_config`. An unknown key raises ``AttributeError`` and
    sets nothing."""
    for k in kwargs:
        if k not in _CONFIG_FIELDS:
            raise AttributeError(f"unknown config key {k!r}")
    _overrides.update(kwargs)
    return _config


def reset_config(*names: str) -> None:
    """Drop the values ``set_config`` gave ``names`` (all fields when none
    are named): they read their environment knobs again."""
    for k in names or tuple(_overrides):
        _overrides.pop(k, None)


def metrics_enabled() -> bool:
    return get_config().metrics_enabled
