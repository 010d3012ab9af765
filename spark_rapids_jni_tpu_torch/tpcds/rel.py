"""Named-column relations with deferred row masks, and the fused runner.

Port of the single-device core of ``spark_rapids_jni_tpu/tpcds/rel.py``.

**Deferred row masks.** A ``Rel`` carries an optional device bool mask
over its physical rows instead of compacting after every filter or
join. Filters AND into the mask; dense joins and groupbys consume and
produce masks; only materialization (``compact`` / ``to_df``) pays the
one data-dependent host sync (the live-row count).

**The fused runner, eagerly.** The reference traces a whole plan into
one XLA program. PyTorch runs eagerly, so ``run_fused`` runs the plan
once with the planner flag (``_FUSED_TRACING``) set: routes are chosen
host-side from VERIFIED ingest stats exactly as in the reference, no
operator may sync, and an operator that needs a data-dependent general
kernel raises ``FusedFallback``; the runner then counts
``rel.fused_fallbacks`` and re-runs the plan on the general sort-merge
kernels. That is the reference's planner semantics, not a device
fallback. The reference's jit, AOT cache and plan caches have no
counterpart here.

**Trusted ingest stats.** ``value_range``/``unique`` are advisory;
before a plan uses them they are verified once per column against the
device data, over its valid values (memoized on the column), so a
nullable key plans as a non-null one. ``rel_from_df`` computes them
exactly on the host and trusts them by construction.

**Dictionary-encoded strings.** String columns ingest as int64 codes
over a host-side sorted dictionary, so code order is string order and
no string bytes reach the plan; ``to_df`` decodes. A string column with
nulls stays a STRING column (offsets and bytes): correct, eager only.

**Runtime counters.** An operator may count a fact only the data knows
(decimal overflow NULLs) with ``note_runtime_count``. While
``run_fused`` runs a plan the counts stay on the device and are read in
the same device-to-host copy as the live-row count, so the query keeps
its one host sync; outside ``run_fused`` they are read at once.

**Partitioned execution.** ``run_fused(plan, rels, mesh=...)`` runs the
same plan data-parallel over a mesh's data axis (``tpcds/dist.py``): one
process a device, every rank with the same global ``rels``, each
keeping its own row shard. Each ``Rel`` carries a host-side ``part`` tag
(``"sharded"`` row chunks, ``"replicated"`` full copies, None for a
fresh rel, read as replicated), and the operators add the collective
half themselves: masked scalar sums all-reduce, a union with a
replicated side keeps that side on shard 0 only, an unsorted ``head`` of
sharded rows leaves the fused route, and the joins, groupbys and windows
of ``tpcds/oplib`` pick their collective routes.

**Out-of-core execution.** ``run_fused(plan, rels, morsels=...)``, or
any ``rels`` value that is a host table (``exec.HostTable``,
``exec.ParquetHostTable``), routes to the morsel runner
(``exec/runner.py``): the streamed tables reach the plan one
capacity-sized chunk at a time as rels flagged ``morsel``, and every
operator that needs the whole stream (dense groupby partials, presence
bitmaps, masked scalar sums, runtime counters) folds its chunk's partial
through ``_MORSEL_CTX.merge`` into an accumulator on the device. The flag
rides ``_inherit_part`` like the partitioning tag; a mid-plan sort, a
window or a union over streamed rows has no chunked form and raises
``FusedFallback`` (the runner then runs the plan in-core).

**Reports and the result cache.** With ``SRT_METRICS`` on, every
``run_fused`` call emits one ``ExecutionReport`` (``obs/report.py``) on
each route. With ``SRT_RESULT_CACHE_BYTES`` set, ``rel_from_df`` stamps
each ingested column with a digest of its host bytes and ``run_fused``
answers a content-equal repeat from the result cache
(``serving/result_cache.py``, provenance ``result_cache``): no kernel,
no host sync. Streamed inputs bypass the cache.

**Threads.** The planner's flags and channels above are module-global,
so every plan run (in-core, over a mesh, streamed, batched) runs under
``_PLAN_LOCK``: the fleet scheduler's workers run plans one at a time
and overlap only what lies outside a plan run (the host sync, the
materialization, decoding).

**Micro-query batching.** ``run_fused_batched(plan, rels_list)`` runs
the same plan over K submissions whose rels have equal fingerprints as
one batched dispatch: the reference's ``jax.vmap`` of the plan at a
static capacity (``fused_pipeline.batch_capacity``). Its eager analog
is the batch program: the plan run once a slot over the capacity's
slots (pad slots replicate slot 0), with no sync between slots, each
slot giving its column leaves, its row mask and the vector [live count,
runtime counters...]; one host read takes every slot's vector, then each
live slot materializes. On the card the program is captured once per
batch-cache key into a CUDA graph (``serving/aot_cache.capture_graph``)
over static input buffers (the per-slot tables copied into ``cap``
buffers a window; the shared ones read in place, their storage part of
the key) and replayed for every later window: one CPU call launches
every kernel of every slot. The cache is bounded by the card's headroom
as well as by its entry count, and an out-of-memory error in a window
empties it and reaches the batcher as ``SplitAndRetryOOM``. On the CPU,
which only the tests ask for, the same program runs eagerly.
"""

from __future__ import annotations

import decimal
import hashlib
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import Column, Table, bitmask
from ..columnar.strings import dictionary_encode
from ..config import env_str, metrics_enabled
from ..obs import (count, count_dispatch, count_host_sync, dispatch_counts,
                   kernel_stats, set_attrs, span, stats_since)
from ..obs import memory as _obs_memory
from ..obs import recompile as _obs_recompile
from ..obs import report as _obs_report
from ..obs import spans as _obs_spans
from ..ops import gather, sorted_order
from ..ops.fused_pipeline import MAX_DENSE_WIDTH, batch_capacity
from ..serving import aot_cache as _aot
from ..serving.result_cache import result_cache
from ..types import INT8, DType, TypeId, decimal64
from ..utils import faults as _faults
from ..utils import plan_cache as _plan_cache
from ..utils.device import memoized_uploads, resolve_device
from ..utils.errors import expects


class FusedFallback(Exception):
    """Raised while a fused plan runs when an operator needs a
    data-dependent general kernel; run_fused catches it and re-runs the
    plan on the general paths."""


class BatchIncompatible(Exception):
    """Raised by ``run_fused_batched`` when the submissions cannot share
    one batch program (table sets, fingerprints, streamed or masked
    inputs, a window above the ladder, or a plan whose batch program
    fails: a general kernel, or a body the capture refuses). The serving
    batcher catches it and falls back, route-counted, to per-query
    dispatch; it is never a query failure."""


# Serializes every plan run across threads: the planner's flags and
# channels below are module-global. The batched runner also takes it
# around cache-entry creation and capture.
_PLAN_LOCK = threading.RLock()

_FUSED_TRACING = False  # True only while run_fused runs a plan fused

# Active partitioned run (tpcds/dist.py sets it while a plan runs over a
# mesh): the mesh, its data axis and the shard count the collective ops
# need. None = single-device semantics.
_DIST_CTX = None

# Active morsel run (exec/runner.py sets it while a plan runs over one
# chunk of the streamed tables): rels flagged ``morsel`` hold one chunk,
# and every cross-morsel merge point calls ``_MORSEL_CTX.merge``. May be
# active together with _DIST_CTX (a mesh morsel run merges over ranks,
# then over morsels). None = in-core semantics.
_MORSEL_CTX = None

# Runtime-counter channel: (name, 0-d int64 device tensor) pairs that
# operators record while run_fused runs a plan; None outside it.
_TRACE_AUX: "Optional[list]" = None


def note_runtime_count(name: str, value, rel: "Optional[Rel]" = None
                       ) -> None:
    """Count a data-dependent fact from inside a plan: deferred to the
    fused runner's one host read under ``run_fused``, read now (a host
    sync) otherwise. ``rel`` scopes a partitioned run's accounting: a
    count over replicated rows is the same on every shard, so only shard
    0 contributes; sharded rows add their local counts."""
    v = torch.as_tensor(value).to(torch.int64)
    if _DIST_CTX is not None and (rel is None or rel.part != "sharded") \
            and _DIST_CTX.index != 0:
        v = torch.zeros_like(v)
    if _MORSEL_CTX is not None and rel is not None and rel.morsel:
        # a count over streamed rows sums its morsels through the
        # accumulator; one over resident rows is recounted exactly by the
        # merge run
        v = _MORSEL_CTX.merge(v, "sum")
    if _TRACE_AUX is not None:
        _TRACE_AUX.append((name, v))
    else:
        count(name, int(v))


def _inherit_part(out: "Rel", *src: "Rel") -> "Rel":
    """Propagate the partitioning tag through a shard-local op: any
    sharded input makes the output sharded, else replicated inputs stay
    replicated (collective ops set ``part`` themselves). The morsel flag
    rides the same way: anything derived from a streamed chunk is a chunk
    until a cross-morsel merge makes a whole-stream value."""
    parts = {r.part for r in src}
    out.part = ("sharded" if "sharded" in parts
                else "replicated" if "replicated" in parts else None)
    out.morsel = any(r.morsel for r in src)
    return out


def _dispatch(name: str, *args, **kwargs):
    """The core's one doorway into the operator library."""
    from .oplib import registry as _registry
    return _registry.dispatch(name, *args, **kwargs)


# --------------------------------------------------------------------------
# Trusted ingest stats: verify once, then plan host-side without syncs
# --------------------------------------------------------------------------

def _verify_ingest_stats(col: Column) -> "tuple[bool, bool]":
    """(range_ok, unique_ok) for a column's advisory ingest stats over
    its valid values, verified against the device data ONCE and memoized
    on the column."""
    flags = getattr(col, "_stats_flags", None)
    if flags is not None:
        return flags
    if (col.value_range is None or col.data is None
            or not col.dtype.is_integral):
        flags = (False, False)
    else:
        lo, hi = col.value_range
        width = int(hi) - int(lo) + 1
        if width > MAX_DENSE_WIDTH:
            flags = (False, False)  # the dense planner can never use it
        else:
            with span("rel.verify_stats", rows=col.size, width=width):
                count_dispatch("rel.verify_stats")
                count_host_sync("rel.verify_stats")
                # the stats are over the valid values: a NULL row's data
                # is no value
                k64 = col.data.to(torch.int64) - int(lo)
                valid = None if col.validity is None else col.valid_bool()
                inb = (k64 >= 0) & (k64 < width)
                ok_r = bool(inb.all() if valid is None
                            else (inb | ~valid).all())
                ok_u = False
                if col.unique and ok_r:
                    slot = k64 if valid is None else torch.where(
                        valid, k64, width)
                    counts = torch.zeros(width + 1, dtype=torch.int32,
                                         device=k64.device)
                    counts.index_add_(0, slot, torch.ones_like(
                        k64, dtype=torch.int32))
                    ok_u = bool((counts[:width] <= 1).all())
                flags = (ok_r, ok_u)
                if not ok_r:
                    count("rel.stale_stats")
    col._stats_flags = flags
    return flags


def _trust(col: Column, unique: bool = False) -> Column:
    """Mark a column built mid-plan whose stats hold by construction."""
    col._stats_flags = (col.value_range is not None, unique)
    return col


def _trusted_range(col: Column) -> "Optional[tuple[int, int]]":
    """value_range when it is verified (or verifiable now); None under
    the planner flag for unverified stats -- the caller falls back."""
    if (col.value_range is None or col.data is None
            or not col.dtype.is_integral):
        return None
    flags = getattr(col, "_stats_flags", None)
    if flags is None:
        # the flag is another thread's while this one holds no plan run
        if _FUSED_TRACING and _PLAN_LOCK._is_owned():
            return None
        flags = _verify_ingest_stats(col)
    return col.value_range if flags[0] else None


def _trusted_unique(col: Column) -> bool:
    flags = getattr(col, "_stats_flags", None)
    return bool(flags and flags[1])


class Rel:
    """A named relation with masked (deferred-compaction) semantics.

    ``mask`` is an optional device bool vector over the PHYSICAL rows of
    ``table``; None means every row is live. ``dicts`` maps
    dictionary-encoded column names to their sorted category arrays.
    ``pending_sort``/``limit`` record a terminal sort and row limit,
    applied at materialization over just the live rows.

    ``part`` is the partitioning tag of a partitioned run
    (``tpcds/dist.py``): ``"sharded"`` (this rank's row chunk),
    ``"replicated"`` (every rank holds the same full copy) or None (one
    device, or a freshly built rel, read as replicated). ``morsel`` is
    True while a morsel run holds one chunk of a streamed table here
    (``exec/runner.py``): aggregations over it merge across morsels, and
    it is never a plain join build side."""

    def __init__(self, table: Table, names: Sequence[str],
                 mask: Optional[torch.Tensor] = None,
                 dicts: Optional[Dict[str, np.ndarray]] = None,
                 pending_sort: Optional[tuple] = None,
                 limit: Optional[int] = None):
        expects(table.num_columns == len(names),
                "one name per column required")
        expects(len(set(names)) == len(names),
                f"duplicate column names: {sorted(names)}")
        self.table = table
        self.names = list(names)
        self.mask = mask
        self.dicts = dict(dicts) if dicts else {}
        self.pending_sort = pending_sort
        self.limit = limit
        self.part = None
        self.morsel = False

    @property
    def num_rows(self) -> int:
        return self.table.num_rows

    @property
    def device(self) -> torch.device:
        return self.table.columns[0].device

    def col(self, name: str) -> Column:
        plain = self._flush_sort()
        return plain.table.columns[plain.names.index(name)]

    def data(self, name: str) -> torch.Tensor:
        return self.col(name).data

    def _sub_dicts(self, names) -> dict:
        return {n: v for n, v in self.dicts.items() if n in names}

    def _flush_sort(self) -> "Rel":
        """Apply a deferred terminal sort in-plan (dead rows last). Only
        reached when an op follows sort()."""
        if self.pending_sort is None:
            return self
        if _MORSEL_CTX is not None and self.morsel:
            # a sort mid-plan orders one chunk, not the stream; only the
            # terminal sort + LIMIT has a morsel form (exec/runner.py)
            raise FusedFallback("sort over a streamed rel mid-plan")
        by, desc = self.pending_sort
        cols = [self.table.columns[self.names.index(n)] for n in by]
        if self.mask is None:
            order = sorted_order(Table(cols), list(desc))
            out = Rel(gather(self.table, order), self.names,
                      dicts=self.dicts)
        else:
            dead_key = Column(INT8, self.num_rows,
                              (~self.mask).to(torch.int8))
            order = sorted_order(Table([dead_key] + cols),
                                 [False] + list(desc))
            out = Rel(gather(self.table, order), self.names,
                      mask=self.mask[order], dicts=self.dicts)
        if self.limit is not None:
            # rows are ordered dead-last: the physical head is the live head
            k = min(self.limit, out.num_rows)
            head = torch.arange(k, dtype=torch.int64, device=self.device)
            out = Rel(gather(out.table, head), out.names,
                      mask=None if out.mask is None else out.mask[:k],
                      dicts=out.dicts)
        return _inherit_part(out, self)

    def select(self, *names: str) -> "Rel":
        plain = self._flush_sort()
        return _inherit_part(Rel(Table([plain.col(n) for n in names]),
                                 names, mask=plain.mask,
                                 dicts=plain._sub_dicts(names)), plain)

    def with_column(self, name: str, col: Column) -> "Rel":
        plain = self._flush_sort()
        return _inherit_part(Rel(Table(list(plain.table.columns) + [col]),
                                 plain.names + [name], mask=plain.mask,
                                 dicts=plain.dicts), plain)

    def rename(self, **renames: str) -> "Rel":
        names = [renames.get(n, n) for n in self.names]
        dicts = {renames.get(k, k): v for k, v in self.dicts.items()}
        ps = self.pending_sort
        if ps is not None:
            ps = ([renames.get(n, n) for n in ps[0]], ps[1])
        return _inherit_part(Rel(self.table, names, mask=self.mask,
                                 dicts=dicts, pending_sort=ps,
                                 limit=self.limit), self)

    def filter(self, mask) -> "Rel":
        """Deferred filter: ANDs into the row mask, no compaction."""
        plain = self._flush_sort()
        keep = mask.to(torch.bool)
        keep = keep if plain.mask is None else (plain.mask & keep)
        return _inherit_part(Rel(plain.table, plain.names, mask=keep,
                                 dicts=plain.dicts), plain)

    def _sharded(self) -> bool:
        return _DIST_CTX is not None and self.part == "sharded"

    def sum_where(self, values, where=None) -> torch.Tensor:
        """Masked sum of a per-physical-row expression (0-d tensor); over
        sharded rows of a partitioned run the shards' partials all-reduce
        (the q9 CASE WHEN shape)."""
        sel = None if where is None else where.to(torch.bool)
        if self.mask is not None:
            sel = self.mask if sel is None else (sel & self.mask)
        s = values.sum() if sel is None else torch.where(sel, values,
                                                         0).sum()
        if self._sharded():
            s = _DIST_CTX.all_reduce(s)
        if _MORSEL_CTX is not None and self.morsel:
            # the chunk's partial folds into the accumulator; downstream
            # sees the whole stream's sum
            s = _MORSEL_CTX.merge(s, "sum")
        return s

    def count_where(self, where=None) -> torch.Tensor:
        """Count of live rows matching ``where`` (0-d int64 tensor),
        partition-aware like ``sum_where``."""
        sel = None if where is None else where.to(torch.bool)
        if self.mask is not None:
            sel = self.mask if sel is None else (sel & self.mask)
        if sel is None:
            # an unmasked sharded rel holds no dead rows: a static count
            n = self.num_rows * (_DIST_CTX.nshards if self._sharded()
                                 else 1)
            return torch.full((), n, dtype=torch.int64, device=self.device)
        c = sel.sum(dtype=torch.int64)
        if self._sharded():
            c = _DIST_CTX.all_reduce(c)
        if _MORSEL_CTX is not None and self.morsel:
            c = _MORSEL_CTX.merge(c, "sum")
        return c

    # -- materialization ---------------------------------------------------

    def compact(self) -> "Rel":
        """Materialize: drop masked-out rows (THE data-dependent host
        sync), then apply a deferred terminal sort over the live rows,
        then the limit. Raises FusedFallback under the planner flag --
        the fused runner materializes once, at the end."""
        if (self.mask is None and self.pending_sort is None
                and self.limit is None):
            return self
        if _FUSED_TRACING:
            raise FusedFallback("compaction inside a fused plan")
        with span("rel.compact", rows=self.num_rows,
                  masked=self.mask is not None):
            if any(c.data is None for c in self.table.columns):
                return self._compact_by_gather()
            datas = [c.data for c in self.table.columns]
            valids = [None if c.validity is None else c.valid_bool()
                      for c in self.table.columns]
            n = self.num_rows
            if self.mask is not None:
                count_host_sync("rel.compact")
                count_dispatch("rel.compact", 2)
                n = int(self.mask.sum())
                set_attrs(live_rows=n)
            sort_keys, desc = (), ()
            if self.pending_sort is not None:
                count_dispatch("rel.sort", 2)
                by, d = self.pending_sort
                sort_keys = tuple(self.names.index(b) for b in by)
                desc = tuple(d)
            dtypes = tuple(c.dtype for c in self.table.columns)
            out_d, out_v = _materialize_program(
                datas, valids, self.mask, n, dtypes, sort_keys, desc,
                self.limit)
            if self.limit is not None:
                n = min(self.limit, n)
            cols = [Column(dt, n, d, v)
                    for dt, d, v in zip(dtypes, out_d, out_v)]
            return Rel(Table(cols), self.names, dicts=self.dicts)

    def _compact_by_gather(self) -> "Rel":
        """compact() of a rel holding STRING columns: row gathers, which
        take STRING columns (the live rows, the sort, the limit)."""
        rel = self
        if rel.mask is not None:
            count_host_sync("rel.compact")
            count_dispatch("rel.compact", 2)
            idx = torch.nonzero(rel.mask)[:, 0]
            set_attrs(live_rows=int(idx.shape[0]))
            rel = Rel(gather(rel.table, idx), rel.names, dicts=rel.dicts,
                      pending_sort=rel.pending_sort, limit=rel.limit)
        if rel.pending_sort is not None:
            count_dispatch("rel.sort", 2)
            by, desc = rel.pending_sort
            order = sorted_order(Table([rel.table.columns[
                rel.names.index(b)] for b in by]), list(desc))
            rel = Rel(gather(rel.table, order), rel.names, dicts=rel.dicts,
                      limit=rel.limit)
        if rel.limit is not None and rel.limit < rel.num_rows:
            head = torch.arange(rel.limit, device=rel.device)
            rel = Rel(gather(rel.table, head), rel.names, dicts=rel.dicts)
        return Rel(rel.table, rel.names, dicts=rel.dicts)

    def to_df(self):
        import pandas as pd
        out = self.compact()
        frame = {}
        for n in out.names:
            c = out.col(n)
            vals = c.to_pylist()
            if n in out.dicts:
                cats = out.dicts[n]
                vals = [None if v is None else cats[v] for v in vals]
            elif c.dtype.id in (TypeId.DECIMAL32, TypeId.DECIMAL64):
                # unscaled integers -> exact Decimals (to_pylist decodes
                # DECIMAL128 itself)
                s = c.dtype.scale
                vals = [None if v is None
                        else decimal.Decimal(int(v)).scaleb(s)
                        for v in vals]
            frame[n] = vals
        return pd.DataFrame(frame)

    # -- joins and grouped aggregation --------------------------------------

    def join(self, other: "Rel", left_on: Sequence[str],
             right_on: Sequence[str], how: str = "inner") -> "Rel":
        """Equi-join; the result carries every column of both sides
        (``semi``/``anti`` keep left columns only; ``left`` marks
        unmatched right columns null). Pair order is planner-dependent;
        callers that need an order sort the result."""
        expects(how in ("inner", "left", "semi", "anti"),
                f"unsupported join type {how!r}")
        with span("rel.join", how=how, keys=",".join(left_on),
                  left_rows=self.num_rows, right_rows=other.num_rows):
            return _dispatch("join", self._flush_sort(), other._flush_sort(),
                             list(left_on), list(right_on), how)

    def groupby(self, keys: Sequence[str], aggs: Sequence[tuple]) -> "Rel":
        """``aggs`` = [(value_col, agg_name, out_name), ...]; the result is
        the unique keys then the aggregates, in ascending key order."""
        with span("rel.groupby", keys=",".join(keys),
                  rows=self.num_rows, n_aggs=len(aggs)):
            return _dispatch("groupby", self._flush_sort(), list(keys),
                             [tuple(a) for a in aggs])

    def window(self, partition_by: Sequence[str], order_by: Sequence[str],
               funcs: Sequence[tuple],
               descending: Optional[Sequence[bool]] = None) -> "Rel":
        """Window functions: one column appended per ``(kind, value_col,
        out_name)`` (kinds row_number / rank / sum / count) over the
        partitions of ``partition_by`` ordered by ``order_by``; the
        ``window`` operator (``tpcds/oplib/windows.py``)."""
        if _MORSEL_CTX is not None and self.morsel:
            # a window frame needs whole partitions; a chunk has none
            raise FusedFallback("window over a streamed rel")
        with span("rel.window", keys=",".join(partition_by),
                  rows=self.num_rows, n_funcs=len(funcs)):
            return _dispatch("window", self._flush_sort(),
                             list(partition_by), list(order_by),
                             [tuple(f) for f in funcs], descending)

    # -- ordering / shaping ------------------------------------------------

    def sort(self, by: Sequence[str],
             descending: Optional[Sequence[bool]] = None) -> "Rel":
        """Deferred stable sort, applied at materialization over the live
        rows; a following relational op flushes it into the plan."""
        plain = self._flush_sort()
        desc = list(descending or [False] * len(by))
        return _inherit_part(Rel(plain.table, plain.names, mask=plain.mask,
                                 dicts=plain.dicts,
                                 pending_sort=(list(by), desc)), plain)

    def concat(self, other: "Rel") -> "Rel":
        """Row-wise union of fixed-width non-null columns with equal
        schemas; masks concatenate, so it stays fused."""
        a = self._flush_sort()
        b = other._flush_sort()
        if _MORSEL_CTX is not None and a.morsel != b.morsel:
            # streamed with resident: the resident rows would count once a
            # morsel; the in-core run takes this shape
            raise FusedFallback("concat of a streamed and a resident rel")
        if (_DIST_CTX is not None and a.part != b.part
                and "sharded" in (a.part, b.part)):
            # sharded + replicated: a full copy on every shard would count
            # its rows once a shard; keep the replicated side on shard 0
            from . import dist
            if a.part != "sharded":
                a = dist.localize_replicated(a)
            if b.part != "sharded":
                b = dist.localize_replicated(b)
        expects(a.names == b.names, "concat needs equal schemas")
        for n in a.names:
            dl, dr = a.dicts.get(n), b.dicts.get(n)
            expects((dl is None) == (dr is None)
                    and (dl is None or dl is dr or np.array_equal(dl, dr)),
                    f"concat of {n!r} needs a shared string dictionary")
        cols = []
        for x, y in zip(a.table.columns, b.table.columns):
            expects(x.dtype.id == y.dtype.id,
                    "concat supports matching fixed-width columns")
            expects(x.validity is None and y.validity is None,
                    "concat supports non-null columns")
            cols.append(Column(x.dtype, x.size + y.size,
                               torch.cat([x.data, y.data])))
        if a.mask is None and b.mask is None:
            mask = None
        else:
            ml = (torch.ones(a.num_rows, dtype=torch.bool, device=a.device)
                  if a.mask is None else a.mask)
            mr = (torch.ones(b.num_rows, dtype=torch.bool, device=b.device)
                  if b.mask is None else b.mask)
            mask = torch.cat([ml, mr])
        return _inherit_part(Rel(Table(cols), a.names, mask=mask,
                                 dicts=a.dicts), a, b)

    def head(self, n: int) -> "Rel":
        """First ``n`` live rows: a deferred limit after sort(), a static
        slice on an unsorted unmasked rel; an unsorted masked rel has no
        defined first rows, so it compacts first (or leaves the fused
        route)."""
        if self.pending_sort is not None:
            k = n if self.limit is None else min(n, self.limit)
            if not self._sharded():
                # a shard's physical rows do not bound the global count
                k = min(k, self.num_rows)
            return _inherit_part(Rel(
                self.table, self.names, mask=self.mask, dicts=self.dicts,
                pending_sort=self.pending_sort, limit=k), self)
        if self.mask is not None:
            if _FUSED_TRACING:
                raise FusedFallback("head() on an unsorted masked rel")
            return self.compact().head(n)
        if self._sharded():
            # the "first n" rows of unsorted sharded rows mean nothing:
            # each shard would slice its own chunk
            raise FusedFallback("head() on an unsorted sharded rel")
        k = min(n, self.num_rows)
        idx = torch.arange(k, dtype=torch.int64, device=self.device)
        return _inherit_part(Rel(gather(self.table, idx), self.names,
                                 dicts=self.dicts), self)


# --------------------------------------------------------------------------
# The fused runner: one plan run + one materialization per query
# --------------------------------------------------------------------------

def _fusable_rel(rel: Rel) -> bool:
    return all(c.data is not None and c.dtype.is_fixed_width
               for c in rel.table.columns)


def _live_indices(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Ascending indices of the ``n`` True rows of ``mask`` without a
    second sync (``nonzero`` would read the count again): each live row
    scatters its row number to its exclusive-prefix position."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask, pos, n)
    out = torch.empty(n + 1, dtype=torch.int64, device=mask.device)
    out[dst] = torch.arange(mask.shape[0], dtype=torch.int64,
                            device=mask.device)
    return out[:n]


def _materialize_program(datas, valids, mask, n: int, dtypes: tuple,
                         sort_keys: tuple, descending: tuple,
                         limit: Optional[int]):
    """Compact by the row mask (``n`` = its live count, read by the
    caller's one sync), apply the terminal sort over the n LIVE rows,
    slice the limit, and pack validity (K3) -- the reference's second
    dispatch. ``valids`` are dense bool vectors or None."""
    idx = None if mask is None else _live_indices(mask, n)
    out_d = [d if idx is None else d[idx] for d in datas]
    out_v = [None if v is None else (v if idx is None else v[idx])
             for v in valids]
    if sort_keys:
        cols = []
        for ci in sort_keys:
            v = out_v[ci]
            cols.append(Column(dtypes[ci], n, out_d[ci],
                               None if v is None else bitmask.pack(v)))
        order = sorted_order(Table(cols), list(descending))
        out_d = [d[order] for d in out_d]
        out_v = [None if v is None else v[order] for v in out_v]
    if limit is not None and limit < n:
        out_d = [d[:limit] for d in out_d]
        out_v = [None if v is None else v[:limit] for v in out_v]
    return out_d, [None if v is None else bitmask.pack(v) for v in out_v]


def _check_device(rels: "dict[str, Rel]", dev: torch.device) -> None:
    for name, r in rels.items():
        for c in r.table.columns:
            expects(c.device.type == dev.type,
                    f"rel {name!r} lies on {c.device}, not {dev}")


def run_fused(plan, rels: "dict[str, Rel]", device=None, mesh=None,
              axis=None, *, morsels=None,
              skip_result_cache: bool = False) -> Rel:
    """Execute ``plan(rels) -> Rel`` with the planner flag set, then
    materialize once: at most one data-dependent host sync per query
    (counter-asserted through ``rel.host_syncs``), which also reads every
    runtime counter the plan recorded (``note_runtime_count``).

    ``device`` names where ``rels`` live: ``cuda`` unless the caller
    passes another (the tests pass ``"cpu"``); without a GPU and without
    a device this raises. When a plan needs a general kernel the run
    counts ``rel.fused_fallbacks`` and re-runs the plan eagerly on the
    general sort-merge kernels: slower, never wrong.

    With ``mesh`` (a ``parallel.Mesh``) every rank of the mesh calls
    this with the same global ``rels``; the plan runs data-parallel over
    the mesh's data axis (``axis``, default ``parallel.data_axes``) with
    its collectives on the mesh's process groups, still one counted host
    sync per rank, and every rank gets the same result
    (``tpcds/dist.py``). ``device`` then defaults to the mesh's.

    **Out-of-core.** When any ``rels`` value is a host table
    (``exec.HostTable``, ``exec.ParquetHostTable``), or ``morsels`` is
    given, the run goes to the morsel runner (``exec/runner.py``): the
    host tables stream to the device in fixed-capacity chunks through
    pinned, double-buffered staging, the plan folds each chunk into an
    accumulator on the device, and one merge run finishes the query.
    ``morsels`` is None (sized to ``SRT_MORSEL_BYTES`` or the probed free
    memory), an int (at least that many morsels) or an
    ``exec.MorselPlan``.

    **Reports.** With ``SRT_METRICS`` on, every call emits one
    ``ExecutionReport`` (``obs/report.py``): the counter deltas, the
    planner's routes, dispatches and host syncs, the ``shuffle`` section
    over a mesh, the ``morsel`` and ``io`` sections when streamed, the
    ``memory`` section (ingest bytes + the widest exchange round, and the
    device watermarks), spans and compile events, stamped with the
    ambient query id. ``skip_result_cache`` skips the result cache's
    consult and fill."""
    if not metrics_enabled():
        return _run_fused_routed(plan, rels, {}, device, mesh, axis,
                                 morsels, skip_result_cache)
    pname = getattr(plan, "__name__", "plan").lstrip("_")
    info: dict = {}
    before = kernel_stats()
    smark = _obs_spans.mark()
    rmark = _obs_recompile.mark()
    t0 = time.perf_counter_ns()
    with span(f"query.{pname}"):
        out = _run_fused_routed(plan, rels, info, device, mesh, axis,
                                morsels, skip_result_cache)
    wall = time.perf_counter_ns() - t0
    delta = stats_since(before)
    disp, syncs = dispatch_counts(delta)
    # the eager planner counts its routes on every run (the reference
    # keeps them from the trace, on its plan-cache entry)
    routes = {k: v for k, v in info.get("trace_counters", {}).items()
              if k.startswith("rel.route.") or "rel.general_" in k}
    for k, v in delta.items():
        if k.startswith("rel.route.") or "rel.general_" in k:
            routes.setdefault(k, v)
    shuffle = {k: v for k, v in delta.items() if k.startswith("shuffle.")}
    memory = {}
    if info.get("provenance") != _obs_report.PROVENANCE_RESULT_CACHE:
        memory = _obs_memory.query_memory_section(
            _obs_memory.rel_ingest_bytes(rels),
            comm_scratch_bytes=shuffle.get("shuffle.peak_scratch_bytes", 0))
    _obs_report.emit(_obs_report.ExecutionReport(
        query=pname, fused=info.get("fused", False),
        cache_hit=info.get("provenance")
        == _obs_report.PROVENANCE_RESULT_CACHE,
        provenance=_obs_report.report_provenance(info),
        dispatches=disp, host_syncs=syncs, wall_ns=wall, counters=delta,
        routes=routes,
        spans=[r.to_dict() for r in _obs_spans.records_since(smark)],
        recompiles=[r.to_dict()
                    for r in _obs_recompile.records_since(rmark)],
        native_routes=_obs_report.native_route_sentinels(),
        shuffle=shuffle,
        reliability=_reliability_section(delta),
        memory=memory, morsel=info.get("morsel", {}),
        io=info.get("io", {})))
    return out


def _reliability_section(delta: dict) -> dict:
    """A report's reliability rollup: this run's fault and retry counter
    deltas plus the native resource adaptor's snapshot."""
    out = {k: v for k, v in delta.items() if k.startswith("serving.fault.")}
    out.update(_obs_report.native_ra_snapshot())
    return out


def _run_fused_routed(plan, rels: "dict[str, Rel]", info: dict, device,
                      mesh, axis, morsels, skip_result_cache: bool) -> Rel:
    """Route one run: streamed inputs to the morsel runner (which keeps
    its own standing state and bypasses the result cache); otherwise the
    result cache's consult, the fault seams, the run on one device or
    over the mesh, and the cache's fill."""
    if morsels is not None or any(getattr(r, "is_host_table", False)
                                  for r in rels.values()):
        from ..exec import runner
        return runner.run_morsels(plan, rels, info, mesh=mesh, axis=axis,
                                  morsels=morsels, device=device)
    dev = (mesh.device if mesh is not None and device is None
           else resolve_device(device))
    rcache = None if skip_result_cache else result_cache()
    rtoken = None
    if rcache is not None:
        rtoken = result_cache_token(plan, rels, mesh, axis, dev)
        if rtoken is not None:
            hit = rcache.get(rtoken)
            if hit is not None:
                info["provenance"] = _obs_report.PROVENANCE_RESULT_CACHE
                info["fused"] = True
                return hit
    # chaos seams (utils/faults.py): after the result cache (a cached
    # answer dispatches and allocates nothing), before any device work
    _faults.maybe_inject(_faults.SEAM_DISPATCH)
    _faults.maybe_inject(_faults.SEAM_ALLOC)
    if mesh is not None:
        from . import dist
        out = dist.run_partitioned(plan, rels, mesh, axis=axis, device=dev,
                                   info=info)
    else:
        out = _run_fused_impl(plan, rels, dev, info)
    if rtoken is not None:
        rcache.put(rtoken, out)
    return out


def _run_fused_impl(plan, rels: "dict[str, Rel]", dev: torch.device,
                    info: "Optional[dict]" = None) -> Rel:
    """The single-device fused run (``run_fused`` without a mesh);
    ``info``, when given, receives ``fused``."""
    global _FUSED_TRACING, _TRACE_AUX
    if info is None:
        info = {}
    _check_device(rels, dev)
    pname = getattr(plan, "__name__", "plan").lstrip("_")
    with _PLAN_LOCK:
        for name in sorted(rels):
            if not _fusable_rel(rels[name]) or rels[name].mask is not None:
                count("rel.fused_fallbacks")
                info["fused"] = False
                return plan(rels).compact()
            for c in rels[name].table.columns:
                _trusted_range(c)  # verify advisory stats once (memoized)
        _FUSED_TRACING = True
        _TRACE_AUX = aux = []
        try:
            with span("rel.fused_program", query=pname):
                out = plan(rels)
        except FusedFallback:
            out = None
        finally:
            _FUSED_TRACING = False
            _TRACE_AUX = None
        if out is None:
            count("rel.fused_fallbacks")
            count(f"rel.fused_fallbacks.{pname}")
            info["fused"] = False
            return plan(rels).compact()
    count_dispatch("rel.fused_program")
    info["fused"] = True
    return finish_fused(out, aux)


def finish_fused(out: Rel, aux: list, sync_site: "Optional[str]" = None
                 ) -> Rel:
    """The single-device fused run's tail, shared with the morsel
    runner's merge run: the live-row count and every runtime counter in
    one host read (counted under ``sync_site``, by default
    ``rel.mask_count`` or ``rel.aux_count``), then compaction, the
    terminal sort, the limit and the validity pack (K3)."""
    cols = out.table.columns
    datas = [c.data for c in cols]
    valids = [None if c.validity is None else c.valid_bool() for c in cols]
    if out.pending_sort is None:
        sort_keys, descending = (), ()
    else:
        by, desc = out.pending_sort
        sort_keys = tuple(out.names.index(n) for n in by)
        descending = tuple(desc)
    limit = out.limit
    dtypes = tuple(c.dtype for c in cols)
    n = out.num_rows
    if out.mask is not None or aux:
        # the live-row count and every runtime counter in one host read
        count_host_sync(sync_site or (
            "rel.mask_count" if out.mask is not None else "rel.aux_count"))
        head = [out.mask.sum(dtype=torch.int64)] if out.mask is not None \
            else []
        read = torch.stack(head + [v.to(out.device).reshape(())
                                   for _, v in aux]).tolist()
        if out.mask is not None:
            n = read.pop(0)
        for (aname, _), v in zip(aux, read):
            count(aname, int(v))
    if (out.mask is None and not sort_keys and limit is None
            and all(v is None for v in valids)):
        return Rel(out.table, out.names, dicts=out.dicts)
    with span("rel.materialize", live_rows=n):
        out_d, out_v = _materialize_program(
            datas, valids, out.mask, n, dtypes, sort_keys, descending,
            limit)
    count_dispatch("rel.materialize")
    if limit is not None:
        n = min(limit, n)
    return Rel(Table([Column(dt, n, d, v)
                      for dt, d, v in zip(dtypes, out_d, out_v)]),
               out.names, dicts=out.dicts)


# --------------------------------------------------------------------------
# Micro-query batching: K compatible submissions -> one batched dispatch
# --------------------------------------------------------------------------

class PlanCacheLRU(_plan_cache.PlanCacheLRU):
    """The shared LRU (``utils/plan_cache.py``) under the plan-cache
    counter names: ``rel.plan_cache_evictions`` and a per-cache
    sub-counter."""

    def __init__(self, name: str):
        super().__init__(name, ("rel.plan_cache_evictions",
                                f"rel.plan_cache_evictions.{name}"))


# guarded-by: _PLAN_LOCK -- entry get/create pairing; each entry's own
# "lock" serializes its windows from the copy-in to the materialization.
# Bounded by SRT_PLAN_CACHE_SIZE entries and, before each capture, by the
# card's headroom (_make_room)
_BATCH_CACHE = PlanCacheLRU("fused_batch")


def clear_batch_cache() -> None:
    """Drop every batch-cache entry, with its graph, its private memory
    pool and its static buffers."""
    _BATCH_CACHE.clear()


def batch_cache_stats() -> list:
    """One dict a batch-cache entry: its query, capacity, route, whether
    it holds a graph, the hand-kernel launches one replay makes, its
    static input bytes, the bytes it charges the cache (static buffers,
    uploads and the graph's pool), the capture's seconds, and its
    fallback reason."""
    out = []
    for e in _BATCH_CACHE.values():
        g = e.get("graph")
        out.append({"query": e["query"], "capacity": e["capacity"],
                    "route": e["route"], "graph": g is not None,
                    "replay_launches": dict(g.launches) if g else {},
                    "static_bytes": e.get("static_bytes", 0),
                    "bytes": e.get("bytes", 0),
                    "capture_s": g.capture_s if g else None,
                    "fallback": e.get("why")})
    return out


def run_fused_batched(plan, rels_list: "List[dict]", device=None, *,
                      _graph: Optional[bool] = None) -> "List[Rel]":
    """Execute the same plan over K compatible ingests as one batched
    dispatch, plus one materialization a result: the micro-query half of
    serving (``serving/batcher.py``).

    The K submissions must share the plan and the rel fingerprints
    (schema, verified stats, column sizes, dictionary content): the batch
    program's structure is a function of those, so equality lets one
    program serve every slot. The program is the plan run once a slot at
    the static capacity (``fused_pipeline.batch_capacity``; the ragged
    route sizes it by the page pool's lease); a partial window pads with
    copies of slot 0, never demultiplexed. One host sync reads every
    slot's live count and runtime counters. On the card the program is
    captured into a CUDA graph on a key's first window and replayed on
    every later one; on the CPU it runs eagerly (``_graph`` forces
    either: the tests' stand-in capture, the smoke's recording pass).

    ``device`` names where the rels live: ``cuda`` unless the caller
    passes another. Raises :class:`BatchIncompatible` when the
    submissions cannot share one program; the caller falls back,
    route-counted, to per-query ``run_fused``."""
    if len(rels_list) == 1:
        return [run_fused(plan, rels_list[0], device=device)]
    if not metrics_enabled():
        return _run_fused_batched_impl(plan, rels_list, {}, device, _graph)
    pname = getattr(plan, "__name__", "plan").lstrip("_")
    info: dict = {}
    before = kernel_stats()
    smark = _obs_spans.mark()
    rmark = _obs_recompile.mark()
    t0 = time.perf_counter_ns()
    with span(f"query.{pname}", batch=len(rels_list)):
        outs = _run_fused_batched_impl(plan, rels_list, info, device,
                                       _graph)
    wall = time.perf_counter_ns() - t0
    delta = stats_since(before)
    disp, syncs = dispatch_counts(delta)
    routes = {k: v for k, v in info.get("trace_counters", {}).items()
              if k.startswith("rel.route.")}
    for k, v in delta.items():
        if k.startswith("rel.route."):
            routes.setdefault(k, v)
    _obs_report.emit(_obs_report.ExecutionReport(
        query=pname, fused=info.get("fused", False),
        cache_hit=info.get("cache_hit", False),
        provenance=_obs_report.report_provenance(info),
        dispatches=disp, host_syncs=syncs, wall_ns=wall, counters=delta,
        routes=routes,
        spans=[r.to_dict() for r in _obs_spans.records_since(smark)],
        recompiles=[r.to_dict()
                    for r in _obs_recompile.records_since(rmark)],
        native_routes=_obs_report.native_route_sentinels(),
        batch=len(rels_list),
        reliability=_reliability_section(delta),
        # one ingest a slot of the program (padded: the capacity rung;
        # ragged: the page-bucketed capacity), the pad slots' bytes apart
        memory=_obs_memory.query_memory_section(
            _obs_memory.rel_ingest_bytes(rels_list[0]),
            batch_multiplier=info.get("batch_capacity", len(rels_list)),
            padded_waste_bytes=info.get("padded_waste_bytes", 0))))
    return outs


def _slot_stack_bytes(rels, shared: dict) -> int:
    """Device bytes a batched window stacks for one submission: every
    per-slot table's column data and validity. Shared (broadcast) tables
    are read where they lie, whatever the capacity, so they are not part
    of the per-slot footprint the page pool meters or the ragged
    capacity divides by."""
    total = 0
    for name, r in rels.items():
        if shared.get(name):
            continue
        for c in r.table.columns:
            total += int(c.data.nbytes) if c.data is not None else 0
            if c.validity is not None:
                total += int(c.validity.nbytes)
    return max(1, total)


def _run_fused_batched_impl(plan, rels_list, info: dict, device,
                            graph: Optional[bool]) -> "List[Rel]":
    from ..ops.fused_pipeline import BATCH_CAPACITIES, batch_route
    # runtime-lazy: exec/ imports tpcds/ at module scope
    from ..exec.pages import page_pool, ragged_capacity

    # chaos seams: batch faults and memory pressure fire before any cache
    # bookkeeping, so an injected failure exercises the batcher's degrade
    # ladder and never marks an entry as a fallback
    _faults.maybe_inject(_faults.SEAM_BATCH)
    _faults.maybe_inject(_faults.SEAM_ALLOC)
    k = len(rels_list)
    if k > BATCH_CAPACITIES[-1]:
        raise BatchIncompatible(
            f"batch of {k} exceeds the capacity ladder "
            f"(max {BATCH_CAPACITIES[-1]})")
    dev = resolve_device(device)
    order = sorted(rels_list[0])
    for rels in rels_list:
        if sorted(rels) != order:
            raise BatchIncompatible("table sets differ across submissions")
        for name in order:
            r = rels[name]
            if getattr(r, "is_host_table", False):
                raise BatchIncompatible(
                    f"table {name!r} is streamed (morsel) — out-of-core "
                    "runs do not batch")
            if not _fusable_rel(r) or r.mask is not None:
                raise BatchIncompatible(f"table {name!r} not fusable")
        _check_device(rels, dev)
    fps = tuple(_rel_fingerprint(rels_list[0][name]) for name in order)
    for rels in rels_list[1:]:
        if tuple(_rel_fingerprint(rels[name]) for name in order) != fps:
            raise BatchIncompatible(
                "rel fingerprints differ — the traced program would "
                "differ per slot")
    cap = batch_capacity(k)
    # a table every slot submitted as the same Rel object is shared: read
    # in place by every slot; identity is the proof of sharedness
    shared = {name: all(rels[name] is rels_list[0][name]
                        for rels in rels_list) for name in order}
    slot_bytes = _slot_stack_bytes(rels_list[0], shared)
    rtag, eff_cap, lease = "padded", cap, None
    route = batch_route()
    if route != "padded":
        pool = page_pool()
        if pool is None:
            if route == "ragged":
                # forced ragged with the pool off: serve padded, loudly
                count("rel.batch.pool_degraded")
        else:
            lease = pool.lease(k * slot_bytes, tag="batch")
            if lease is None:
                count("rel.batch.pool_degraded")  # the padded twin works
            else:
                rtag = "ragged"
                eff_cap = ragged_capacity(k, slot_bytes, cap)
    info["batch_route"] = rtag
    info["batch_capacity"] = eff_cap
    info["padded_waste_bytes"] = (eff_cap - k) * slot_bytes
    try:
        return _run_batched_window(plan, rels_list, info, order, fps,
                                   shared, eff_cap, rtag, dev, graph)
    finally:
        if lease is not None:
            lease.release()


def _slot_program(plan, rels: dict, entry: dict):
    """One slot of the batch program: the plan under the planner flags
    (no sync), then its column leaves, its row mask (all-True when the
    plan left none, so every slot has one) and the vector [live count,
    runtime counters...]. The first slot run fills the entry's meta;
    later ones must agree with it."""
    global _FUSED_TRACING, _TRACE_AUX
    _FUSED_TRACING = True
    _TRACE_AUX = aux = []
    try:
        out = plan(rels)
    finally:
        _FUSED_TRACING = False
        _TRACE_AUX = None
    if out.pending_sort is None:
        sort = ((), ())
    else:
        by, desc = out.pending_sort
        sort = (tuple(out.names.index(n) for n in by), tuple(desc))
    meta = {"names": list(out.names), "dicts": dict(out.dicts),
            "cols": [(c.dtype, c.size) for c in out.table.columns],
            "sort": sort, "limit": out.limit,
            "aux": [n for n, _ in aux]}
    have = entry.setdefault("meta", meta)
    if any(have[x] != meta[x] for x in ("names", "cols", "sort", "limit",
                                         "aux")):
        raise FusedFallback("batch slots planned different programs")
    leaves = [(c.data, None if c.validity is None else c.valid_bool())
              for c in out.table.columns]
    mask = (torch.ones(out.num_rows, dtype=torch.bool, device=out.device)
            if out.mask is None else out.mask)
    vec = torch.stack([mask.sum(dtype=torch.int64)]
                      + [v.to(out.device).reshape(()) for _, v in aux])
    return leaves, mask, vec


def _batch_program(plan, slots: list, entry: dict):
    """The batch program over ``slots`` (one rels dict a slot): every
    slot's leaves and mask, and the (slots, 1 + counters) block the one
    host sync reads. The entry's first run keeps slot 0's route counters
    (the reference's trace-time counters)."""
    outs = []
    for i, rels in enumerate(slots):
        if i == 0 and "trace_counters" not in entry:
            tb = kernel_stats()
            outs.append(_slot_program(plan, rels, entry))
            entry["trace_counters"] = stats_since(tb)
        else:
            outs.append(_slot_program(plan, rels, entry))
    return ([o[0] for o in outs], [o[1] for o in outs],
            torch.stack([o[2] for o in outs]))


def _fill_static(entry: dict, padded: list, k: int) -> None:
    """The window's first ``k`` slots into the entry's static buffers:
    slot s of a per-slot table into its buffer s. Pad slots keep what
    they last held: their outputs are never read, and any ingest of the
    key's fingerprint is a valid input. A shared table has no buffer."""
    for name, slots in entry["static"].items():
        for s, bufs in enumerate(slots[:k]):
            for c, (d, v) in zip(padded[s][name].table.columns, bufs):
                d.copy_(c.data, non_blocking=True)
                if v is not None:
                    v.copy_(c.validity, non_blocking=True)


def _static_slots(entry: dict, rels0: dict, order, shared: dict,
                  cap: int) -> list:
    """Allocate the entry's static buffers, ``cap`` for each per-slot
    table, and build the rels the captured program reads: slot 0's
    schema, dictionaries and verified stats over the buffers. A shared
    table is read in place, at the storage the entry's key names."""
    static, views, total = {}, {}, 0
    for name in order:
        r = rels0[name]
        if shared[name]:
            views[name] = [r] * cap
            continue
        static[name] = [[(torch.empty_like(c.data),
                          None if c.validity is None
                          else torch.empty_like(c.validity))
                         for c in r.table.columns] for _ in range(cap)]
        views[name] = []
        for bufs in static[name]:
            cols = []
            for c, (d, v) in zip(r.table.columns, bufs):
                total += d.nbytes + (0 if v is None else v.nbytes)
                nc = Column(c.dtype, c.size, d, v,
                            value_range=c.value_range, unique=c.unique)
                flags = getattr(c, "_stats_flags", None)
                if flags is not None:
                    nc._stats_flags = flags
                cols.append(nc)
            views[name].append(Rel(Table(cols), r.names, dicts=r.dicts))
    entry["static"] = static
    entry["static_bytes"] = total
    return [{name: views[name][s] for name in order} for s in range(cap)]


def _shared_storage(rels0: dict, shared: dict) -> tuple:
    """The addresses of the shared tables' columns: a graph reads them
    in place, so they are part of its key. Equal addresses and an equal
    fingerprint are all a replay needs, whichever tensors hold them."""
    return tuple(
        (name, tuple((c.data.data_ptr(), 0 if c.validity is None
                      else c.validity.data_ptr())
                     for c in rels0[name].table.columns))
        for name in sorted(shared) if shared[name])


def _make_room(entry: dict, need: int, dev) -> None:
    """Before a capture: evict other entries, least recently used first,
    while the bytes the cache charges plus ``need`` (the new entry's
    static buffers) exceed the device's headroom (free memory and the
    allocator's unallocated reserve, less the cached graphs' pools:
    their free blocks serve only their own graph), so the cache holds at
    most about half of the memory it competes for. A device that reports
    no memory bounds the cache by its entry count alone."""
    while True:
        head = _obs_memory.hbm_headroom_bytes(dev)
        if head is None:
            return
        pools = sum(e.get("pool_bytes", 0) for e in _BATCH_CACHE.values())
        if _BATCH_CACHE.nbytes() + need <= head - pools:
            return
        if not _BATCH_CACHE.evict_oldest(keep=entry):
            return
        count("rel.batch.budget_evictions")


def _graph_window(entry: dict, plan, padded: list, k: int, order,
                  shared: dict, cap: int, dev, info: dict, site: str):
    """One window through the entry's CUDA graph: on its first window
    make room, allocate the static buffers, fill them, warm up and
    capture (provenance ``cold_compile``); later, fill and replay
    (``warm_memory``). Returns the graph's static outputs."""
    g = entry.get("graph")
    if g is None:
        _make_room(entry, cap * _slot_stack_bytes(padded[0], shared), dev)
        with _PLAN_LOCK:
            slots = _static_slots(entry, padded[0], order, shared, cap)
            _fill_static(entry, padded, cap)
            uploads = entry.setdefault("uploads", {})

            def program():
                with memoized_uploads(uploads):
                    return _batch_program(plan, slots, entry)

            with span("rel.batch_capture", capacity=cap):
                g = entry["graph"] = _aot.capture_graph(
                    program, site=site, signature=(cap, entry["route"]),
                    device=dev)
        # the entry's charge: static buffers, uploads and the graph's pool
        entry["pool_bytes"] = g.pool_bytes
        entry["bytes"] = (entry["static_bytes"] + g.pool_bytes
                          + sum(t.nbytes for t, _ in uploads.values()))
        info["provenance"] = _obs_report.PROVENANCE_COLD_COMPILE
        _aot.note_capture(plan, entry["key_digest"], cap, k, entry["route"])
        if getattr(_WARM, "want", None) is not None:
            entry["warm_disk"] = True
    else:
        _fill_static(entry, padded, k)
        info["provenance"] = (_obs_report.PROVENANCE_WARM_DISK
                              if entry.pop("warm_disk", False)
                              else _obs_report.PROVENANCE_WARM_MEMORY)
    with span("rel.fused_batch_program", capacity=cap, graph=True):
        g.replay()
    return g.outputs


# the manifest key a warm_disk window must match (serving/aot_cache.py);
# None outside one
_WARM = threading.local()


class _WarmMismatch(Exception):
    """A warm_disk window whose rels do not give the manifest's key."""


def warm_batch_entry(plan, rels_list, device, key_digest: str,
                     graph: Optional[bool] = None) -> bool:
    """Capture the batch-cache entry of ``plan`` over ``rels_list`` ahead
    of its first window (``aot_cache.warm_disk``), iff they give the
    manifest's ``key_digest``; the entry's next window reports provenance
    ``warm_disk``. False when they do not, or the batch cannot form."""
    _WARM.want = key_digest
    try:
        run_fused_batched(plan, rels_list, device=device, _graph=graph)
        return True
    except (_WarmMismatch, BatchIncompatible):
        return False
    finally:
        _WARM.want = None


def _release_entry(entry: dict) -> None:
    """Drop an entry's graph (and with it its private pool), its static
    buffers and its uploads: the batch cache's eviction and clear. An
    entry a window holds is marked instead, and that window drops it at
    its end (waiting here could deadlock on the plan lock)."""
    if entry["lock"].acquire(blocking=False):
        try:
            _drop_state(entry)
        finally:
            entry["lock"].release()
    else:
        entry["evicted"] = True


def _drop_state(entry: dict) -> None:
    g = entry.pop("graph", None)
    if g is not None:
        g.release()
    for name in ("static", "uploads", "done"):
        entry.pop(name, None)
    entry["bytes"] = entry["pool_bytes"] = 0


def _run_batched_window(plan, rels_list, info: dict, order, fps,
                        shared: dict, cap: int, rtag: str, dev,
                        graph: Optional[bool]) -> "List[Rel]":
    """One batched window at a decided route and slot count (``cap``:
    the capacity rung, or the ragged route's page-bucketed capacity)."""
    k = len(rels_list)
    use_graph = dev.type == "cuda" if graph is None else bool(graph)
    # pad slots replicate slot 0's inputs; their outputs are never read
    padded = list(rels_list) + [rels_list[0]] * (cap - k)
    content = (tuple(order), fps, planner_env_key(), cap, rtag,
               tuple(sorted(shared.items())), str(dev), use_graph)
    key = (plan,) + content + (
        _shared_storage(rels_list[0], shared) if use_graph else None,)
    pname = getattr(plan, "__name__", "plan").lstrip("_")
    # the key's content without the plan object or addresses: stable
    # across processes, the disk tier's manifest key
    kdigest = _aot.batch_key_digest((pname,) + content)
    want = getattr(_WARM, "want", None)
    if want is not None and want != kdigest:
        raise _WarmMismatch(pname)
    with _PLAN_LOCK:
        entry = _BATCH_CACHE.get(key)
        info["cache_hit"] = entry is not None
        if entry is None:
            entry = {"query": pname, "capacity": cap, "route": rtag,
                     "lock": threading.Lock(), "bytes": 0,
                     "key_digest": kdigest}
            entry["release"] = (lambda e=entry: _release_entry(e))
            _BATCH_CACHE[key] = entry
    with entry["lock"]:
        if entry.get("fallback"):
            raise BatchIncompatible(entry["why"])
        done = entry.get("done")
        if done is not None:  # the last window's reads of the outputs
            torch.cuda.current_stream(dev).wait_event(done)
        try:
            if use_graph:
                leaves, masks, nvals = _graph_window(
                    entry, plan, padded, k, order, shared, cap, dev, info,
                    f"rel.fused_batch.{pname}")
            else:
                with _PLAN_LOCK, span("rel.fused_batch_program",
                                      capacity=cap, graph=False):
                    leaves, masks, nvals = _batch_program(plan, padded,
                                                          entry)
        except torch.cuda.OutOfMemoryError as e:
            # the card is full: free this entry's state and every other
            # entry, and let the batcher split the window (no verdict)
            _drop_state(entry)
            while _BATCH_CACHE.evict_oldest(keep=entry):
                pass
            count("rel.batch.oom")
            raise _faults.SplitAndRetryOOM(
                f"batched window of {k} at capacity {cap}: {e}") from e
        except MemoryError:
            raise  # host memory pressure: no verdict on the program
        except Exception as e:
            if entry.get("ok"):
                raise  # a runtime failure of a proven program
            # a plan that needs a general kernel, or a body the capture
            # refuses: later windows skip straight to per-query dispatch
            entry["fallback"] = True
            entry["why"] = f"{type(e).__name__}: {e}"
            _drop_state(entry)
            count("rel.batch.fallbacks")
            count(f"rel.batch.fallbacks.{pname}")
            raise BatchIncompatible(entry["why"]) from e
        entry["ok"] = True
        count_dispatch("rel.fused_batch_program")
        count("rel.route.serving.batched", k)
        count(f"rel.route.batch.{rtag}", k)
        info["fused"] = True
        info["trace_counters"] = entry.get("trace_counters", {})
        meta = entry["meta"]
        count_host_sync("rel.batch_mask_count")
        ns = nvals.tolist()  # THE batch host sync: every slot's vector
        # runtime counters: summed over the live slots only (pad slots
        # replicate slot 0)
        for j, aname in enumerate(meta["aux"]):
            count(aname, int(sum(ns[i][1 + j] for i in range(k))))
        sort_keys, descending = meta["sort"]
        limit = meta["limit"]
        dtypes = tuple(dt for dt, _ in meta["cols"])
        outs = []
        for i in range(k):  # pad slots [k:cap] are never demultiplexed
            n = int(ns[i][0])
            with span("rel.materialize", live_rows=n, slot=i):
                # the mask is never None, so every output is a fresh
                # gather: nothing aliases the graph's memory
                out_d, out_v = _materialize_program(
                    [d for d, _ in leaves[i]], [v for _, v in leaves[i]],
                    masks[i], n, dtypes, sort_keys, descending, limit)
            count_dispatch("rel.materialize")
            nn = n if limit is None else min(limit, n)
            outs.append(Rel(Table([Column(dt, nn, d, v) for (dt, _), d, v
                                   in zip(meta["cols"], out_d, out_v)]),
                            meta["names"], dicts=meta["dicts"]))
        if dev.type == "cuda":
            entry["done"] = torch.cuda.Event()
            entry["done"].record(torch.cuda.current_stream(dev))
        if entry.get("evicted"):
            _drop_state(entry)
    return outs


# --------------------------------------------------------------------------
# Result-cache keying: fingerprints and ingest content digests
# --------------------------------------------------------------------------

# the env knobs that steer the planner's routes: part of the result
# cache's and the morsel runner's keys
_ROUTE_KNOBS = ("SRT_JOIN_METHOD", "SRT_DENSE_GROUPBY", "SRT_STRING_ROUTE",
                "SRT_BROADCAST_THRESHOLD", "SRT_GROUPBY_PSUM_WIDTH",
                "SRT_SHUFFLE_JOIN_ROUTE", "SRT_SHUFFLE_SCRATCH_BYTES",
                "SRT_SHUFFLE_INTRA", "SRT_SHUFFLE_NEIGHBORHOOD",
                "SRT_PAGE_BYTES")


def planner_env_key() -> tuple:
    """The planner knobs' environment values, the operator registry's
    revision (``oplib.registry.registry_revision``) and the tuned tier's
    part (``tune.tuned_planner_key``: the winner table's digest and every
    resolved tuned planner knob), so neither two tuning tables nor two
    versions of the operator library share a batch-cache entry or a
    result-cache token."""
    from ..tune.space import tuned_planner_key
    from .oplib.registry import registry_revision
    return (tuple(env_str(k, "") for k in _ROUTE_KNOBS)
            + (registry_revision(),) + tuned_planner_key())


# digests of the read-only dictionary arrays seen so far: id -> (weak
# reference, digest). ``rel_from_df`` freezes the dictionaries it makes,
# and every fingerprint (a batch key at each submit, every slot of every
# window) would otherwise hash each one again; a writable array, or a
# view whose base could be written, is hashed every time.
_DICT_DIGESTS: dict = {}


def _dict_digest(cats: np.ndarray) -> str:
    frozen = not cats.flags.writeable and cats.flags.owndata
    key = id(cats)
    hit = _DICT_DIGESTS.get(key) if frozen else None
    if hit is not None and hit[0]() is cats:
        return hit[1]
    h = hashlib.sha1()
    h.update(str(cats.dtype).encode())
    h.update(str(cats.shape).encode())
    if cats.dtype == object:
        h.update("\x00".join(map(str, cats)).encode())
    else:
        h.update(cats.tobytes())
    digest = h.hexdigest()
    if frozen:
        _DICT_DIGESTS[key] = (weakref.ref(
            cats, lambda _, k=key: _DICT_DIGESTS.pop(k, None)), digest)
    return digest


def _rel_fingerprint(rel: Rel) -> tuple:
    """Schema, verified stats and dictionary digests of a resident rel:
    what its routes are chosen from (the result cache's and the morsel
    runner's keys)."""
    cols = tuple((int(c.dtype.id), c.dtype.scale, c.size,
                  c.validity is not None, _trusted_range(c),
                  _trusted_unique(c)) for c in rel.table.columns)
    dict_keys = tuple(sorted((n, _dict_digest(v))
                             for n, v in rel.dicts.items()))
    return (tuple(rel.names), cols, dict_keys)


def _ingest_content_digest(arr: np.ndarray) -> str:
    """sha1 of an ingest array's bytes, dtype and shape: the per-column
    content identity the result cache keys on, computed by
    ``rel_from_df`` only while the cache is on."""
    h = hashlib.sha1()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def result_cache_token(plan, rels: "dict[str, Rel]", mesh=None,
                       axis=None, device=None) -> Optional[str]:
    """The content token of one (plan, inputs) submission, or None
    (counted ``serving.result_cache.uncacheable``) when an input is
    streamed, masked, or has a column without an ingest digest (a
    derived rel, a STRING column with nulls): the cache serves exact
    content matches only. Keys go through ``serving/aot_cache``'s token
    helpers.

    The token names the run's device (``device``, resolved as
    ``run_fused`` resolves it) and the devices its inputs lie on: a
    cached result's tensors live where it was computed, so the same
    content on another device misses."""
    order = sorted(rels)
    digests = []
    for name in order:
        r = rels[name]
        if getattr(r, "is_host_table", False) or r.mask is not None:
            count("serving.result_cache.uncacheable")
            return None
        for c in r.table.columns:
            d = getattr(c, "_content_digest", None)
            if d is None:
                count("serving.result_cache.uncacheable")
                return None
            digests.append(d)
    fps = tuple(_rel_fingerprint(rels[name]) for name in order)
    dev = (mesh.device if mesh is not None and device is None
           else resolve_device(device))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices = (str(dev), tuple(sorted({str(c.device) for name in order
                                       for c in rels[name].table.columns})))
    meshdesc = None
    if mesh is not None:
        from ..parallel import mesh_axes_key
        meshdesc = (str(axis), mesh_axes_key(mesh))
    return _aot.result_token(plan, (tuple(order), fps, tuple(digests),
                                    planner_env_key(), meshdesc, devices))


def _trust_ingest(col: Column) -> Column:
    """Mark an ingest's exact host stats VERIFIED by construction."""
    if col.value_range is not None and col.validity is None:
        _trust(col, unique=bool(col.unique))
    return col


def rel_from_df(df, decimals: "Optional[Dict[str, int]]" = None,
                device=None) -> Rel:
    """pandas frame -> Rel on ``device`` (``cuda`` unless the caller
    passes another). Numeric columns upload directly (int32 widens to
    int64); string/object columns are dictionary-encoded (int64 codes +
    a host-side sorted category array), and those with nulls stay STRING
    columns (eager routes only). Ingest stats are computed exactly on the
    host and trusted.

    ``decimals`` maps integer column names to a cudf-style scale: the
    column ingests as DECIMAL64 unscaled values (value = stored *
    10^scale), and ``to_df`` decodes it to ``decimal.Decimal``."""
    import pandas as pd
    dev = resolve_device(device)
    decimals = decimals or {}
    # the result cache on: stamp each column with its content digest
    # (the host bytes are in hand exactly once, here); off: no cost
    want_digest = result_cache() is not None
    names, cols, dicts = [], [], {}
    for name in df.columns:
        s = df[name]
        names.append(name)
        if pd.api.types.is_numeric_dtype(s.dtype):
            arr = np.ascontiguousarray(s.to_numpy())
            if arr.dtype == np.int32:
                arr = arr.astype(np.int64)
            col = Column.from_numpy(arr, device=dev)
            if name in decimals:
                expects(arr.dtype.kind in "iu",
                        f"decimal ingest of {name!r} needs integer "
                        "unscaled values")
                col = Column(decimal64(decimals[name]), col.size,
                             col.data.to(torch.int64))
        else:
            codes, cats = dictionary_encode(s)
            if (codes < 0).any():  # nulls: a real STRING column
                cols.append(Column.strings_from_list(
                    [None if pd.isna(v) else str(v) for v in s],
                    device=dev))
                continue
            # a private, read-only copy: the dictionary is part of every
            # fingerprint, and its digest is memoized
            cats = np.array(cats)
            cats.flags.writeable = False
            dicts[name] = cats
            arr = codes
            col = Column.from_numpy(codes, device=dev)
        if want_digest:
            col._content_digest = _ingest_content_digest(arr)
        cols.append(_trust_ingest(col))
    return Rel(Table(cols), names, dicts=dicts)


def numeric(col_data) -> Column:
    """Wrap a computed tensor as a non-null INT64/FLOAT64 column."""
    t = torch.as_tensor(col_data)
    if t.dtype.is_floating_point:
        return Column(DType(TypeId.FLOAT64), int(t.shape[0]),
                      t.to(torch.float64))
    expects(not t.dtype.is_complex, f"numeric() cannot wrap {t.dtype}")
    return Column(DType(TypeId.INT64), int(t.shape[0]), t.to(torch.int64))
