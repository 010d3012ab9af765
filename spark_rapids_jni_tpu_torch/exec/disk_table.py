"""Disk-backed streaming tables: Parquet row groups as morsels.

Port of ``spark_rapids_jni_tpu/exec/disk_table.py``. A
:class:`ParquetHostTable` keeps :class:`~.host_table.HostTable`'s
snapshot and chunk contract (the runner streams both through one duck
type), but its rows stay on disk. Row groups are the storage's own
morsel boundary: the footer carries each group's row count, byte sizes
and min/max/null-count statistics, so the table plans chunks, zone maps
and ingest tokens from footer bytes alone and decodes data pages only on
demand. Decoded groups feed the runner's pinned staging like a host
table's rows.

- **Prefetch.** One background reader thread and a bounded cache of
  decoded groups (``SRT_DISK_PREFETCH_DEPTH`` groups ahead): while
  morsel k folds on the card, group k+1 reads and re-encodes on the
  host. ``io.disk.prefetch_hit``/``miss`` count whether a requested
  group was already scheduled; ``io.disk.{read,decode}_ns`` time the two
  host stages (the runner observes ``io.disk.fold_ns``).
- **Zone maps.** Scan conjuncts are declared on the table
  (``filters=[(col, op, value), ...]``): the table is a filtered view.
  The runner ANDs their masks into every chunk on the device,
  :meth:`to_rel` applies them on the host, and a chunk whose groups'
  footer statistics prove that no row passes is staged dead without a
  disk read (``exec.morsel.zonemap_skipped``), byte-equal either way.
  Statistics the planner cannot trust (floats, absent stats) fold
  everything, counted ``exec.morsel.zonemap_untrusted``.
  ``SRT_DISK_ZONEMAP=0`` turns skipping off.
- **Trust and backstop.** Footer min/max become the declared
  ``value_range`` the dense routes use, like a host table's exact
  stats. Every group decoded for streaming checks its values against its
  footer claim; a violation counts ``io.disk.stale_stats`` and raises
  ``FusedFallback``, so the run completes in-core from the data.

NULLs are admitted only in scan-filtered columns, where a comparison
with NULL is not true: decode fills them with a value that fails the
column's first conjunct. Dictionary columns unify at open into one
sorted dictionary over every file; ``append_file`` of a file inside it
appends one ingest batch (a standing query folds only the new groups),
new strings rebuild the dictionary and reset the log
(``rel.morsel_dict_rebuilds``). Ingest tokens are sha1 digests of each
file's row-group footer metadata and the dictionaries.

Thread contract: one writer (``append_file``) at a time; morsel runs
read immutable :class:`_DiskState` snapshots; data pages are read only on
the reader thread (and by private handles in ``__init__``,
``append_file`` and ``to_rel``), so no ``ParquetFile`` handle crosses
threads.
"""

from __future__ import annotations

import hashlib
import threading
import time
from bisect import bisect_right
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..columnar import Column, Table
from ..columnar.column import np_to_dtype
from ..config import env_bool, tuned_int
from ..io.parquet import open_parquet, read_row_group, row_group_stats
from ..obs import REGISTRY, count
from ..types import decimal64
from ..utils import faults as _faults
from ..utils.device import resolve_device
from ..utils.errors import expects
from .host_table import _padded_range, _page_arrays

_OPS = ("lt", "le", "gt", "ge", "eq", "ne", "between")


# ---------------------------------------------------------------------------
# Snapshot descriptors
# ---------------------------------------------------------------------------


class DiskColumn:
    """Snapshot descriptor of one disk-backed column: declared type and
    trusted range, NO data buffer (the runner reads row counts through
    ``snapshot_rows`` and data through ``chunk_arrays``). Carries the
    immutable :class:`_DiskState` so every consumer of one snapshot —
    specs, fingerprints, chunk reads, zone tests — sees one pinned
    group list and dictionary even while ``append_file`` lands."""

    __slots__ = ("dtype", "value_range", "np_dtype", "state")

    def __init__(self, dtype, value_range, np_dtype, state):
        self.dtype = dtype
        self.value_range = value_range
        self.np_dtype = np_dtype
        self.state = state

    @property
    def row_bytes(self) -> int:
        return int(np.dtype(self.np_dtype).itemsize)


class _RowGroup:
    """One Parquet row group mapped into the table's row space.
    ``stats`` holds the footer zone map per column in the RAW domain —
    ``("int", mn, mx)`` / ``("str", mn, mx)`` / ``("all_null",)`` /
    ``None`` (untrusted) — raw so a dictionary rebuild re-encodes zone
    maps without re-reading any footer."""

    __slots__ = ("file_index", "group_index", "start", "rows", "stats")

    def __init__(self, file_index, group_index, start, rows, stats):
        self.file_index = file_index
        self.group_index = group_index
        self.start = start
        self.rows = rows
        self.stats = stats


class _DiskState:
    """Immutable per-version view: the group list, the unified
    dictionaries, per-column encoded dtypes, the canonical filter
    conjuncts (code-domain for dictionary columns, so they re-encode
    with the dictionary) and the precomputed zone-map skip verdicts."""

    __slots__ = ("version", "groups", "starts", "dicts", "np_dtypes",
                 "rows", "filters", "skip", "null_fill")

    def __init__(self, version, groups, dicts, np_dtypes, filters, skip,
                 null_fill):
        self.version = version
        self.groups = tuple(groups)
        self.starts = [g.start for g in self.groups]
        self.dicts = dict(dicts)
        self.np_dtypes = dict(np_dtypes)
        self.rows = (self.groups[-1].start + self.groups[-1].rows
                     if self.groups else 0)
        self.filters = tuple(filters)
        self.skip = tuple(skip)
        self.null_fill = dict(null_fill)


# ---------------------------------------------------------------------------
# Filter canonicalization + zone tests (host-side, pure int arithmetic)
# ---------------------------------------------------------------------------


def _as_str(v):
    return v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)


def _canon_filters(filters, names, kinds, dicts, decimals) -> tuple:
    """User filters -> canonical conjuncts ``(col_index, op, value)``
    with ``op`` in lt/le/gt/ge/eq/ne and ``value`` numeric. Dictionary
    columns canonicalize into the CODE domain via the sorted-category
    invariant (code order == lexicographic order): range predicates
    become searchsorted boundary codes, an ``eq`` on an absent category
    becomes the impossible conjunct ``(ci, "eq", -1)``, and an ``ne``
    on an absent category is dropped (vacuously true)."""
    out = []
    for col, op, val in filters or ():
        expects(col in names, f"filter on unknown column {col!r}")
        expects(op in _OPS, f"unsupported filter op {op!r}")
        ci = names.index(col)
        if op == "between":
            lo, hi = val
            out.extend(_canon_filters([(col, "ge", lo), (col, "le", hi)],
                                      names, kinds, dicts, decimals))
            continue
        if kinds[col] == "dict":
            cats = dicts[col]
            v = _as_str(val)
            if op in ("eq", "ne"):
                pos = int(np.searchsorted(cats, v))
                present = pos < len(cats) and str(cats[pos]) == v
                if op == "eq":
                    out.append((ci, "eq", pos if present else -1))
                elif present:
                    out.append((ci, "ne", pos))
                # absent 'ne' is vacuously true: drop
            elif op == "lt":
                out.append((ci, "lt", int(np.searchsorted(cats, v, "left"))))
            elif op == "le":
                out.append((ci, "lt", int(np.searchsorted(cats, v, "right"))))
            elif op == "gt":
                out.append((ci, "ge", int(np.searchsorted(cats, v, "right"))))
            else:  # ge
                out.append((ci, "ge", int(np.searchsorted(cats, v, "left"))))
            continue
        expects(isinstance(val, (int, float, np.integer, np.floating)),
                f"filter value for numeric column {col!r} must be "
                "numeric (decimals take unscaled integer values)")
        out.append((ci, op, int(val) if isinstance(
            val, (int, np.integer)) else float(val)))
    return tuple(out)


def _fail_value(op, v):
    """A value that provably FAILS ``(op, v)`` — the NULL sentinel for
    filtered columns (SQL: a comparison with NULL is not-true)."""
    if op in ("lt", "gt", "ne"):
        return v
    if op == "le":
        return v + 1
    if op == "ge":
        return v - 1
    return v + 1  # eq


def _conjunct_impossible(op, v, mn, mx) -> bool:
    """True when NO value in [mn, mx] can satisfy ``(op, value)`` — the
    zone-map interval test. ``mn``/``mx`` may be conservative bounds
    (Parquet permits truncated string statistics; the spec requires
    truncation to widen, never narrow, the interval)."""
    if op == "lt":
        return mn >= v
    if op == "le":
        return mn > v
    if op == "gt":
        return mx <= v
    if op == "ge":
        return mx < v
    if op == "eq":
        return v < mn or v > mx
    return mn == mx == v  # ne: every value equals v


def _np_filter_mask(data: np.ndarray, op: str, v) -> np.ndarray:
    """Host-side predicate mask, the in-core twin of the device mask the
    runner builds (``exec/runner.py`` ``_scan_filter_mask``). NaN
    compares not-true under every op except ``ne``, as on the device."""
    if op == "lt":
        return data < v
    if op == "le":
        return data <= v
    if op == "gt":
        return data > v
    if op == "ge":
        return data >= v
    if op == "eq":
        return data == v
    return data != v


def _stat_interval(stat, name, dicts):
    """Footer stat -> encoded-domain [mn, mx] bound, or None when the
    zone map cannot be trusted for interval tests."""
    if stat is None or stat[0] == "all_null":
        return None
    if stat[0] == "int":
        return (stat[1], stat[2])
    cats = dicts.get(name)
    if cats is None:
        return None
    # conservative code bounds for (possibly truncated) string stats:
    # values >= mn_s have code >= left(mn_s); values <= mx_s have
    # code <= right(mx_s) - 1
    lo = int(np.searchsorted(cats, _as_str(stat[1]), "left"))
    hi = int(np.searchsorted(cats, _as_str(stat[2]), "right")) - 1
    return (lo, hi)


def _zone_skip(groups, names, dicts, filters, count_from: int = 0):
    """Per-group skip verdicts for the canonical conjunction. A group
    skips when ANY conjunct is provably unsatisfiable over it (footer
    interval empty, or the filtered column is all-NULL). Groups at
    index >= ``count_from`` that CANNOT skip and carry an untrusted
    stat on a filtered column count ``exec.morsel.zonemap_untrusted``
    — the honest fold-everything degrade."""
    skip = []
    for gi, g in enumerate(groups):
        verdict = False
        untrusted = False
        for ci, op, v in filters:
            stat = g.stats.get(names[ci])
            if stat is not None and stat[0] == "all_null":
                verdict = True
                break
            iv = _stat_interval(stat, names[ci], dicts)
            if iv is None:
                untrusted = True
                continue
            if _conjunct_impossible(op, v, iv[0], iv[1]):
                verdict = True
                break
        skip.append(verdict)
        if not verdict and untrusted and gi >= count_from:
            count("exec.morsel.zonemap_untrusted")
    return skip


# ---------------------------------------------------------------------------
# The async prefetcher
# ---------------------------------------------------------------------------


class _Prefetcher:
    """One background reader thread + a bounded decoded-group cache.

    ``get`` is the ONLY data-read entry of the streaming path: a cache
    hit returns the already-decoded group (``io.disk.prefetch_hit``), a
    miss enqueues a priority request and blocks (``prefetch_miss``);
    either way the next ``depth`` needed groups are scheduled so the
    reader decodes ahead of the pump. The cache holds at most
    ``depth + 2`` groups and the queue at most ``depth + 1`` requests.

    All ``ParquetFile`` data reads happen on the reader thread through
    its private handle cache, so handles never cross threads."""

    def __init__(self, table, depth: int):
        self._table = table
        self._depth = max(1, int(depth))
        self._cv = threading.Condition()
        self._cache: "OrderedDict" = OrderedDict()  # guarded-by: self._cv
        self._queue: "deque" = deque()  # guarded-by: self._cv
        self._queued: set = set()  # guarded-by: self._cv
        self._errors: dict = {}  # guarded-by: self._cv
        self._stop = False  # guarded-by: self._cv
        self._thread = None  # guarded-by: self._cv
        # the reader thread's own parquet handles (close() resets them
        # only after join())
        self._pfs: dict = {}
        self.hits = 0  # guarded-by: self._cv
        self.misses = 0  # guarded-by: self._cv

    # -- caller side -------------------------------------------------------

    def get(self, state: _DiskState, gid: int) -> dict:
        key = (state.version, gid)
        with self._cv:
            self._start_locked()
            val = self._cache.get(key)
            # a hit is a read the prefetcher ANTICIPATED: the group is
            # either decoded already or its read was scheduled ahead of
            # demand (the overlap exists either way; only its tail is
            # waited on). A cold request nobody scheduled is the miss.
            if val is not None or key in self._queued:
                if val is not None:
                    self._cache.move_to_end(key)
                self.hits += 1
                count("io.disk.prefetch_hit")
            else:
                self.misses += 1
                count("io.disk.prefetch_miss")
            if val is None:
                self._enqueue_locked(state, gid, front=True)
                while True:
                    val = self._cache.get(key)
                    if val is not None:
                        break
                    if key in self._errors:
                        raise self._errors.pop(key)
                    if self._stop:
                        raise RuntimeError(
                            "disk prefetcher closed mid-read")
                    if key not in self._queued:
                        # evicted or dropped between produce and wake:
                        # re-request rather than wait forever
                        self._enqueue_locked(state, gid, front=True)
                    self._cv.wait(0.1)
            self._schedule_ahead_locked(state, gid)
        return val

    def _schedule_ahead_locked(self, state: _DiskState, gid: int) -> None:
        # requires-lock: self._cv
        ahead = 0
        for nxt in range(gid + 1, len(state.groups)):
            if ahead >= self._depth:
                break
            if not self._table._group_needed(state, nxt):
                continue  # zone-skipped groups are never read
            ahead += 1
            if (state.version, nxt) not in self._cache:
                self._enqueue_locked(state, nxt, front=False)

    def _enqueue_locked(self, state, gid, front: bool) -> None:
        # requires-lock: self._cv
        key = (state.version, gid)
        if key in self._queued:
            return
        self._queued.add(key)
        if front:
            self._queue.appendleft((state, gid))
        else:
            self._queue.append((state, gid))
        self._cv.notify_all()

    def _start_locked(self) -> None:  # requires-lock: self._cv
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="srt-disk-prefetch", daemon=True)
            self._thread.start()

    # -- reader thread -----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                state, gid = self._queue.popleft()
                key = (state.version, gid)
            err = val = None
            try:
                val = self._table._decode_group(state, gid, self._pfs)
            except BaseException as e:  # delivered to the waiter
                err = e
                count("io.disk.read_errors")
            with self._cv:
                self._queued.discard(key)
                if err is not None:
                    self._errors[key] = err
                else:
                    self._cache[key] = val
                    while len(self._cache) > self._depth + 2:
                        self._cache.popitem(last=False)
                self._cv.notify_all()

    def close(self) -> None:
        """Stop the reader and drop the cache — safe mid-stream (an
        in-flight ``get`` raises rather than hanging); a later ``get``
        restarts the thread cleanly."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10)
        with self._cv:
            self._cache.clear()
            self._queue.clear()
            self._queued.clear()
            self._pfs = {}

    def stats(self) -> tuple:
        with self._cv:
            return (self.hits, self.misses, len(self._cache),
                    len(self._queue))


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------


class ParquetHostTable:
    """A Parquet-backed streamed table: same runner contract as
    :class:`HostTable` (see module docstring), rows resident on disk.

    ``paths`` is one path or a sequence; ``columns`` projects;
    ``decimals`` declares DECIMAL64 scales for integer unscaled-value
    columns (same contract as ``HostTable.from_df``); ``filters`` are
    scan-level conjunctive predicates making this table a filtered
    view; ``prefetch_depth`` overrides `SRT_DISK_PREFETCH_DEPTH`."""

    is_host_table = True  # duck-typing marker (tpcds/rel.py routing)
    is_disk_table = True  # runner: disk tier present -> io report section

    def __init__(self, paths, columns: Optional[Sequence[str]] = None,
                 decimals: Optional[Dict[str, int]] = None,
                 filters=None, prefetch_depth: Optional[int] = None):
        import pyarrow as pa
        paths = [paths] if isinstance(paths, (str, bytes)) else list(paths)
        expects(len(paths) > 0, "a ParquetHostTable needs at least one "
                                "file")
        self._decimals = dict(decimals or {})
        self._user_filters = tuple(filters or ())
        pf0 = open_parquet(paths[0])
        schema = pf0.schema_arrow
        self.names = (list(columns) if columns
                      else [str(n) for n in schema.names])
        self._kinds: Dict[str, str] = {}  # written here only
        np_dtypes: Dict[str, np.dtype] = {}
        for name in self.names:
            expects(name in schema.names,
                    f"column {name!r} not in {paths[0]!r}")
            t = schema.field(name).type
            if name in self._decimals:
                expects(pa.types.is_integer(t),
                        f"decimal ingest of {name!r} needs integer "
                        "unscaled values")
                self._kinds[name] = "decimal"
                np_dtypes[name] = np.dtype(np.int64)
            elif pa.types.is_integer(t):
                self._kinds[name] = "int"
                dt = np.dtype(t.to_pandas_dtype())
                np_dtypes[name] = (np.dtype(np.int64)
                                   if dt == np.int32 else dt)
            elif pa.types.is_floating(t):
                self._kinds[name] = "float"
                np_dtypes[name] = np.dtype(t.to_pandas_dtype())
            elif pa.types.is_boolean(t):
                self._kinds[name] = "bool"
                np_dtypes[name] = np.dtype(np.bool_)
            elif (pa.types.is_string(t) or pa.types.is_large_string(t)):
                self._kinds[name] = "dict"
                np_dtypes[name] = np.dtype(np.int64)
            else:
                expects(False, f"unsupported parquet type {t} for "
                               f"streamed column {name!r}")
        self._np_dtypes = np_dtypes
        self._lock = threading.Lock()
        self._paths: List[str] = []  # guarded-by: self._lock
        self._file_digests: List[str] = []  # guarded-by: self._lock
        self._batches: list = []  # guarded-by: self._lock; (start, stop, tok)
        self._state: Optional[_DiskState] = None  # guarded-by: self._lock
        self._rel_memo = None  # guarded-by: self._lock
        self._io: dict = {  # guarded-by: self._lock
            "groups_read": 0, "bytes_read": 0, "retries": 0}
        groups, dicts, fdigs = self._scan_files(paths, {}, handle0=pf0)
        with self._lock:
            self._file_digests = fdigs
        self._install_state(0, groups, dicts, paths, count_zone_from=0,
                            rebuild_batches=True)
        depth = (int(prefetch_depth) if prefetch_depth
                 else max(1, tuned_int("SRT_DISK_PREFETCH_DEPTH", 2)))
        self._prefetch = _Prefetcher(self, depth)

    # -- footer scan / state build ----------------------------------------

    def _scan_files(self, paths, base_dicts, handle0=None):
        """Footer + dictionary pre-scan of ``paths``: row-group zone
        maps from footer bytes, string categories from column-projected
        reads (no other data page is touched). Returns (new groups
        relative to row 0 of the FIRST scanned path, unified dicts)."""
        import pyarrow as pa
        cats_sets = {n: (set(map(str, base_dicts[n]))
                         if n in base_dicts else set())
                     for n in self.names if self._kinds[n] == "dict"}
        groups, start, fdigs = [], 0, []
        for fi, path in enumerate(paths):
            pf = handle0 if (fi == 0 and handle0 is not None) \
                else open_parquet(path)
            expects(all(n in pf.schema_arrow.names for n in self.names),
                    f"{path!r} is missing streamed columns")
            for name in cats_sets:
                col = pf.read(columns=[name]).column(0)
                col = col.combine_chunks().drop_null()
                cats_sets[name].update(map(str, col.to_pylist()))
            for gi in range(pf.metadata.num_row_groups):
                raw = row_group_stats(pf, gi)
                rows = raw.pop("__rows__")
                stats = {n: self._classify_stat(n, raw.get(n), rows)
                         for n in self.names}
                groups.append(_RowGroup(fi, gi, start, rows, stats))
                start += rows
            fdigs.append(self._file_digest(pf))
        dicts = {n: np.asarray(sorted(v)) for n, v in cats_sets.items()}
        return groups, dicts, fdigs

    def _classify_stat(self, name, raw, rows):
        if raw is None:
            return None
        mn, mx, nulls = raw
        if mn is None and mx is None:
            return ("all_null",) if nulls == rows else None
        kind = self._kinds[name]
        if kind in ("int", "decimal"):
            if isinstance(mn, (int, np.integer)) and isinstance(
                    mx, (int, np.integer)):
                return ("int", int(mn), int(mx))
            return None
        if kind == "dict":
            return ("str", _as_str(mn), _as_str(mx))
        return None  # float/bool zone maps stay untrusted (NaN edges)

    def _file_digest(self, pf) -> str:
        """Content digest of one file's row-group footer metadata — the
        per-file half of the ingest-log token (module docstring: the
        footer digest IS the content token)."""
        h = hashlib.sha1()
        md = pf.metadata
        for gi in range(md.num_row_groups):
            rg = md.row_group(gi)
            h.update(str(rg.num_rows).encode())
            for ci in range(rg.num_columns):
                col = rg.column(ci)
                if col.path_in_schema not in self.names:
                    continue
                h.update(col.path_in_schema.encode())
                h.update(str(col.total_compressed_size).encode())
                h.update(str(col.total_uncompressed_size).encode())
                h.update(str(col.data_page_offset).encode())
                st = col.statistics
                if st is not None and st.has_min_max:
                    h.update(repr((st.min, st.max)).encode())
        return h.hexdigest()

    def _dict_content_digest(self, dicts) -> str:
        h = hashlib.sha1()
        for name in sorted(dicts):
            h.update(name.encode())
            h.update("\x00".join(map(str, dicts[name])).encode())
        return h.hexdigest()

    def _install_state(self, version, groups, dicts, new_paths,
                       count_zone_from: int,
                       rebuild_batches: bool = False,
                       append_batch=None) -> None:
        """Swap in a fresh immutable state (init and append share this
        tail) and maintain the ingest log: ``rebuild_batches`` re-keys
        every per-file batch token under the current dictionary digest
        (init + dictionary rebuilds), ``append_batch=(start, stop,
        file_digest)`` appends one. Caller must NOT hold ``self._lock``."""
        filters = _canon_filters(self._user_filters, self.names,
                                 self._kinds, dicts, self._decimals)
        null_fill: dict = {}
        for ci, op, v in filters:
            null_fill.setdefault(self.names[ci], _fail_value(op, v))
        skip = _zone_skip(groups, self.names, dicts, filters,
                          count_from=count_zone_from) if filters \
            else [False] * len(groups)
        state = _DiskState(version, groups, dicts, self._np_dtypes,
                           filters, skip, null_fill)
        ddig = self._dict_content_digest(dicts)
        with self._lock:
            old_ranges = (self._ranges_for(self._state)
                          if self._state is not None else None)
            self._paths.extend(new_paths)
            self._state = state
            self._rel_memo = None
            if rebuild_batches:
                rows_by_file: dict = {}
                for g in state.groups:
                    rows_by_file[g.file_index] = (
                        rows_by_file.get(g.file_index, 0) + g.rows)
                self._batches = []
                row = 0
                for i, d in enumerate(self._file_digests):
                    n = rows_by_file.get(i, 0)
                    tok = hashlib.sha1((d + ddig).encode()).hexdigest()
                    self._batches.append((row, row + n, tok))
                    row += n
            elif append_batch is not None:
                start_row, stop_row, fdig = append_batch
                tok = hashlib.sha1((fdig + ddig).encode()).hexdigest()
                self._batches.append((start_row, stop_row, tok))
        # widening counted against the previous state's declared view
        # (same loud-append contract as HostTable)
        if old_ranges is not None:
            for name, rng in self._ranges_for(state).items():
                old = old_ranges.get(name)
                if (old is not None and rng != old
                        and (rng is None or rng[0] < old[0]
                             or rng[1] > old[1])):
                    count("rel.morsel_stats_widened")

    def _ranges_for(self, state: _DiskState) -> dict:
        """Declared (padded) value ranges from footer zone maps: only a
        column whose EVERY group carries a trusted stat gets a range —
        one untrusted group makes the whole bound unknowable."""
        out = {}
        for name in self.names:
            kind = self._kinds[name]
            if kind == "dict":
                cats = state.dicts.get(name)
                out[name] = ((0, len(cats) - 1)
                             if cats is not None and len(cats) else None)
                continue
            if kind not in ("int", "decimal"):
                out[name] = None
                continue
            mn = mx = None
            ok = True
            for g in state.groups:
                stat = g.stats.get(name)
                if stat is not None and stat[0] == "all_null":
                    continue  # contributes no live value
                if stat is None or stat[0] != "int":
                    ok = False
                    break
                mn = stat[1] if mn is None else min(mn, stat[1])
                mx = stat[2] if mx is None else max(mx, stat[2])
            out[name] = (_padded_range((mn, mx))
                         if ok and mn is not None else None)
        return out

    # -- shape / accounting ------------------------------------------------

    @property
    def num_rows(self) -> int:
        with self._lock:
            return int(self._state.rows)

    @property
    def row_bytes(self) -> int:
        """Device bytes one row occupies in a morsel."""
        return sum(int(np.dtype(self._np_dtypes[n]).itemsize)
                   for n in self.names)

    @property
    def nbytes(self) -> int:
        """The would-be in-core ingest size (never materialized)."""
        return self.row_bytes * self.num_rows

    @property
    def version(self) -> int:
        with self._lock:
            return int(self._state.version)

    @property
    def num_row_groups(self) -> int:
        with self._lock:
            return len(self._state.groups)

    def snapshot(self):
        """(version, cols, dicts, batch tokens) — the consistent view a
        morsel run reads; ``cols`` are data-free descriptors pinning
        one immutable state."""
        with self._lock:
            state = self._state
            tokens = tuple(t for _, _, t in self._batches)
        ranges = self._ranges_for(state)
        cols = {}
        for name in self.names:
            kind = self._kinds[name]
            dt = (decimal64(self._decimals[name]) if kind == "decimal"
                  else np_to_dtype(state.np_dtypes[name]))
            cols[name] = DiskColumn(dt, ranges[name],
                                    state.np_dtypes[name], state)
        return (state.version, cols, dict(state.dicts), tokens)

    def snapshot_rows(self, snap) -> int:
        return int(snap[1][self.names[0]].state.rows)

    def batch_tokens(self):
        with self._lock:
            return tuple(t for _, _, t in self._batches)

    def scan_filters(self, snap=None) -> tuple:
        """Canonical conjuncts of this filtered view (code-domain for
        dictionary columns) — the runner folds these into its entry
        fingerprint, its standing key and every rebuilt chunk's mask."""
        if snap is not None:
            return snap[1][self.names[0]].state.filters
        with self._lock:
            return self._state.filters

    def io_stats(self) -> dict:
        """Monotonic per-table I/O facts (the runner diffs these around
        a run for the report's ``io`` section)."""
        hits, misses, cached, queued = self._prefetch.stats()
        with self._lock:
            out = dict(self._io)
        out.update({"prefetch_hits": hits, "prefetch_misses": misses,
                    "cached_groups": cached, "queued_reads": queued})
        return out

    def close(self) -> None:
        self._prefetch.close()

    # -- zone-map skipping -------------------------------------------------

    @staticmethod
    def _zonemap_on() -> bool:
        # read per call: a skipped chunk folds as the identity, byte-equal
        # with decoding it and masking every row dead
        return env_bool("SRT_DISK_ZONEMAP", True)

    def _group_needed(self, state: _DiskState, gid: int) -> bool:
        return not (state.skip[gid] and self._zonemap_on())

    def _overlapping(self, state: _DiskState, start: int, end: int):
        gi = max(0, bisect_right(state.starts, start) - 1)
        while gi < len(state.groups) and state.groups[gi].start < end:
            yield gi
            gi += 1

    def chunk_provably_empty(self, snap, start: int, live: int) -> bool:
        """True when the footer zone maps PROVE no row of chunk
        [start, start+live) can satisfy the scan conjunction — the
        runner stages such chunks dead without any disk read."""
        if live <= 0 or not self._zonemap_on():
            return False
        state = snap[1][self.names[0]].state
        if not state.filters or not any(state.skip):
            return False
        return all(state.skip[gi] for gi in
                   self._overlapping(state, start, start + live))

    # -- decode (reader thread) -------------------------------------------

    def _decode_group(self, state: _DiskState, gid: int,
                      pf_cache: dict, record: bool = True,
                      verify: bool = True) -> dict:
        """Read + re-encode one row group into the HostTable column
        encodings. ``record`` routes through the fault seam and the
        io accounting (the streaming path); ``verify`` checks decoded
        min/max against the footer claim (the zone-map backstop) —
        ``to_rel`` disables both (it recomputes true stats from data)."""
        g = state.groups[gid]
        last = None
        for attempt in range(3):
            try:
                if record:
                    _faults.maybe_inject(_faults.SEAM_DISK)
                pf = pf_cache.get(g.file_index)
                if pf is None:
                    with self._lock:
                        path = self._paths[g.file_index]
                    pf = pf_cache[g.file_index] = open_parquet(path)
                at = read_row_group(pf, g.group_index, self.names)
                break
            except _faults.InjectedFault as e:
                # transient-by-contract storage fault: retry in place,
                # bit-exact (the re-read returns the same bytes)
                count("io.disk.retries")
                with self._lock:
                    self._io["retries"] += 1
                last = e
        else:
            raise last
        t0 = time.perf_counter_ns()
        out = {}
        for name in self.names:
            out[name] = self._encode_column(state, g, gid, name,
                                            at.column(name), verify)
        REGISTRY.histogram("io.disk.decode_ns").observe(
            time.perf_counter_ns() - t0)
        if record:
            with self._lock:
                self._io["groups_read"] += 1
                self._io["bytes_read"] += int(at.nbytes)
        return out

    def _encode_column(self, state, g, gid, name, arr, verify):
        arr = arr.combine_chunks()
        nulls = int(arr.null_count)
        fill = state.null_fill.get(name)
        nmask = None
        if nulls:
            expects(fill is not None,
                    f"NULLs in streamed column {name!r} — only "
                    "scan-filtered columns admit NULLs (they are dead "
                    "rows by predicate semantics)")
            nmask = arr.is_null().to_numpy(zero_copy_only=False)
        kind = self._kinds[name]
        if kind == "dict":
            cats = state.dicts[name]
            vals = np.asarray(arr.to_pylist(), dtype=object)
            live_vals = vals[~nmask] if nulls else vals
            data = np.empty(len(vals), np.int64)
            if live_vals.size:
                sv = live_vals.astype(str)
                pos = np.searchsorted(cats, sv)
                pos_c = np.clip(pos, 0, max(0, len(cats) - 1))
                expects(len(cats) > 0
                        and bool((cats[pos_c].astype(object)
                                  == live_vals).all()),
                        f"value outside the unified dictionary for "
                        f"{name!r} — ingest new files via append_file")
                codes = pos_c.astype(np.int64)
            else:
                codes = np.empty((0,), np.int64)
            if nulls:
                data[~nmask] = codes
                data[nmask] = fill
            else:
                data[:] = codes
            live = codes
        else:
            src = arr.fill_null(0) if nulls else arr
            npv = np.ascontiguousarray(
                src.to_numpy(zero_copy_only=False))
            data = npv.astype(state.np_dtypes[name],
                              copy=bool(nulls))
            if nulls:
                data[nmask] = fill
            live = data[~nmask] if nulls else data
        if verify:
            self._verify_stats(state, g, gid, name, live, nulls, nmask)
        return data

    def _verify_stats(self, state, g, gid, name, live, nulls, nmask):
        """Decode-time backstop of the zone-map trust contract: the
        actual values must sit inside the footer's claimed interval; an
        all-NULL claim must see no live value. Violations are counted
        (``io.disk.stale_stats``, fallback-marked) and degrade the run
        in-core via FusedFallback — never wrong bytes."""
        stat = g.stats.get(name)
        if stat is None:
            return
        stale = False
        if stat[0] == "all_null":
            stale = live.size > 0
        elif live.size:
            iv = _stat_interval(stat, name, state.dicts)
            if iv is not None:
                stale = (int(live.min()) < iv[0]
                         or int(live.max()) > iv[1]) \
                    if live.dtype.kind in "iu" else False
        if stale:
            count("io.disk.stale_stats")
            from ..tpcds.rel import FusedFallback
            raise FusedFallback(
                f"stale parquet footer statistics on {name!r} "
                f"(row group {gid}): decoded values violate the "
                "declared zone map")

    # -- chunk views (runner contract) ------------------------------------

    def _gather(self, state: _DiskState, start: int, live: int) -> list:
        """Live rows [start, start+live) per column, assembled from the
        overlapping decoded groups through the prefetcher."""
        parts: dict = {name: [] for name in self.names}
        end = start + live
        for gi in self._overlapping(state, start, end):
            g = state.groups[gi]
            dec = self._prefetch.get(state, gi)
            lo = max(start, g.start) - g.start
            hi = min(end, g.start + g.rows) - g.start
            for name in self.names:
                parts[name].append(dec[name][lo:hi])
        out = []
        for name in self.names:
            p = parts[name]
            expects(bool(p), "chunk outside the table's row space")
            out.append(p[0] if len(p) == 1 else np.concatenate(p))
        return out

    def chunk_views(self, cols, start: int, live: int) -> list:
        """The live rows [start, start+live) of each column, decoded
        through the prefetcher (HostTable contract)."""
        state = cols[self.names[0]].state
        if live <= 0:
            return [np.zeros((0,), state.np_dtypes[name])
                    for name in self.names]
        return self._gather(state, start, live)

    def chunk_arrays(self, cols, start: int, live: int,
                     cap: int) -> list:
        """Numpy arrays for one capacity-shaped morsel (HostTable
        contract). ``live == 0`` — the zone-skipped / aligned-dead case
        — builds zeros without touching disk."""
        state = cols[self.names[0]].state
        if live <= 0:
            return [np.zeros((cap,), state.np_dtypes[name])
                    for name in self.names]
        out = []
        for name, chunk in zip(self.names,
                               self._gather(state, start, live)):
            if live < cap:
                pad = np.zeros((cap - live,) + chunk.shape[1:],
                               chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            out.append(np.ascontiguousarray(chunk))
        return out

    def chunk_page_arrays(self, cols, start: int, live: int, cap: int,
                          page_bytes: int) -> list:
        """Page-granular staging view (HostTable contract): live pages
        only, decoded through the prefetcher."""
        return _page_arrays(self.chunk_views(cols, start, live), live, cap,
                            page_bytes)

    # -- append (delta-recomputation seam) ---------------------------------

    def append_file(self, path: str) -> "ParquetHostTable":
        """Ingest one more Parquet file as a new batch of row groups.
        Strings inside the unified dictionary append one ingest batch
        (standing queries fold ONLY the new groups — delta); new
        strings rebuild the dictionary and reset the ingest log
        (counted ``rel.morsel_dict_rebuilds``), exactly the HostTable
        append contract."""
        pf = open_parquet(path)
        with self._lock:
            state = self._state
            base_dicts = dict(state.dicts)
            old_groups = list(state.groups)
            old_rows = state.rows
            version = state.version
            fi = len(self._paths)
        new_groups, dicts, fdigs = self._scan_files([path], base_dicts,
                                                    handle0=pf)
        for g in new_groups:
            g.file_index = fi
            g.start += old_rows
        rebuilt = any(
            len(dicts.get(n, ())) != len(base_dicts.get(n, ()))
            for n in dicts)
        groups = old_groups + new_groups
        add_rows = sum(g.rows for g in new_groups)
        with self._lock:
            self._file_digests.extend(fdigs)
        if rebuilt:
            # codes moved: every cached aggregate over old tokens is
            # invalid — the log resets to per-file batches under the
            # NEW dictionary digest
            count("rel.morsel_dict_rebuilds")
            self._install_state(version + 1, groups, dicts, [path],
                                count_zone_from=0,
                                rebuild_batches=True)
        else:
            self._install_state(
                version + 1, groups, dicts, [path],
                count_zone_from=len(old_groups),
                append_batch=(old_rows, old_rows + add_rows, fdigs[0]))
        return self

    # -- in-core materialization (fallback + oracle) -----------------------

    def to_rel(self, device=None):
        """Full in-core materialization on ``device`` (``cuda`` unless
        the caller passes another): every group decoded (private handles,
        no prefetcher traffic, no footer check: true stats recompute from
        the data) and the scan predicate applied on the host. Memoized
        per version and device."""
        dev = resolve_device(device)
        with self._lock:
            state = self._state
            memo = self._rel_memo
        if memo is not None and memo[0] == (state.version, str(dev)):
            return memo[1]
        from ..tpcds import rel as _rel
        pfs: dict = {}
        cols_np = {name: [] for name in self.names}
        for gid in range(len(state.groups)):
            dec = self._decode_group(state, gid, pfs, record=False,
                                     verify=False)
            for name in self.names:
                cols_np[name].append(dec[name])
        full = {name: (np.concatenate(cols_np[name]) if cols_np[name]
                       else np.empty((0,), state.np_dtypes[name]))
                for name in self.names}
        if state.filters:
            keep = np.ones((state.rows,), np.bool_)
            for ci, op, v in state.filters:
                keep &= _np_filter_mask(full[self.names[ci]], op, v)
            full = {name: np.ascontiguousarray(a[keep])
                    for name, a in full.items()}
        cols = []
        for name in self.names:
            kind = self._kinds[name]
            dt = (decimal64(self._decimals[name]) if kind == "decimal"
                  else np_to_dtype(state.np_dtypes[name]))
            col = Column.from_numpy(full[name], dtype=dt, device=dev)
            cols.append(_rel._trust_ingest(col))
        out = _rel.Rel(Table(cols), self.names, dicts=dict(state.dicts))
        with self._lock:
            if self._state.version == state.version:
                self._rel_memo = ((state.version, str(dev)), out)
        return out
