"""The morsel runner: out-of-core execution of an unchanged fused plan.

Port of ``spark_rapids_jni_tpu/exec/runner.py`` in eager PyTorch. The
streamed tables (host tables, ``exec/host_table.py``; Parquet tables,
``exec/disk_table.py``) reach the plan one capacity-sized chunk at a time
as rels flagged ``morsel``; every operator that needs the whole stream
(the ``_MORSEL_CTX`` seams of ``tpcds/rel.py`` and
``tpcds/oplib/relational.py``: dense groupby partials, presence bitmaps,
masked scalar sums, runtime counters, and a terminal sort + LIMIT's
top-k candidates) folds its chunk's partial into an accumulator on the
device. One merge run then finishes the query from the accumulator.

**Three runs of the plan.** The reference traces the plan three times
(discovery, the partial program, the merge program) and XLA drops what
a partial program computes past its merge points. Eagerly:

- a *discovery* run records the merge points' shapes and combine rules
  in plan order (the first live morsel's partial run, which also folds
  that morsel; or, when no morsel is live, a run over a dead chunk);
- every later *partial* run stops right after its last merge point
  (``_MergesDone``), so the work downstream of the merges is not done a
  morsel;
- the *merge* run feeds the plan the last staged chunk with every row
  dead: the merge points hand back the accumulated values, the rest of
  the plan runs on them, and the fused runner's tail (one counted host
  sync, compaction, terminal sort, validity through K3) materializes
  the result. The dead chunk keeps the capacity: a smaller one would
  change what the plan computes (``head`` clamps its limit to the rows
  it sees), so the merge run costs one more partial run's per-row
  work over dead rows, as the reference's merge program does.

A run whose merge points differ from the recorded ones raises
``FusedFallback``, as in the reference.

**Staging.** Each morsel goes through one of two pinned host buffers
and one of two device buffers, each the size of half the modeled window
(``sum(cap x row_bytes)``): the host copies the live rows into the
pinned buffer (dead rows zero), a dedicated copy stream copies it to the
card with ``non_blocking=True`` and records an event, the compute stream
waits on that event before the partial run, and the host waits on a
buffer's previous copy before it refills it. Morsel k+1 is staged while
morsel k's kernels run (``exec.morsel.overlap_ns``). With the page pool
on (``SRT_PAGE_POOL_BYTES`` > 0, one device only) the run leases the
window from the ledger and copies only each column's live pages; the
pages past them that an earlier morsel wrote are zeroed on the card, so
a reused buffer never carries old rows in its dead tail. The pump reads
nothing from the device: whether a morsel is all dead is decided from
the host's live counts, and the zone maps of a Parquet table are footer
facts.

**Delta recomputation.** The accumulator after every morsel is kept per
(plan, resident identity, layout, scan filters) with the streamed
tables' ingest-token prefixes. After ``rel_append`` the next run folds
only the new rows' morsels into it (provenance ``delta``); a diverged
prefix starts over (``rel.morsel_delta_invalidations``). The
accumulator is never updated in place, so a fault mid-stream (the
``dispatch`` seam fires once a live morsel) leaves the kept state
intact and the retry replays bit-exact.

**Over a mesh** every rank stages only its slice of each morsel
(capacity / p rows), the operators merge over ranks first and then over
morsels, and every decision that gates a collective (morsel count,
capacities, zone-map and dispatch skips) comes from facts every rank
shares: the whole morsel's live count, never the rank's slice.

What cannot stream (a streamed build side of a non-membership join, a
mid-plan sort, a window or a union over streamed rows, a terminal
streamed result without sort + LIMIT, or any plan under a mesh whose
result still streams) raises ``FusedFallback``: the host tables
materialize whole on the run's device and the plan runs in-core,
counted ``rel.morsel_fallbacks``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..columnar import Column, Table
from ..config import env_int
from ..obs import (REGISTRY, count, count_dispatch, gauge, kernel_stats,
                   span, stats_since)
from ..obs import flight as _flight
from ..obs import report as _obs_report
from ..parallel import comm_plan
from ..tpcds import rel as _rel
from ..tpcds.rel import FusedFallback, Rel
from ..utils import faults as _faults
from ..utils.device import resolve_device
from ..utils.errors import expects
from . import pages as _pages
from .morsel import (MorselPlan, agreed_budget, morsel_bytes_budget,
                     plan_morsels)

PHASE_DISCOVER = "discover"
PHASE_PARTIAL = "partial"
PHASE_FINALIZE = "finalize"

# merge-op identities: used to combine and to build the first
# accumulator; "or" is the presence-bitmap OR (bool vectors)
_OPS = ("sum", "min", "max", "or")

class _MergesDone(Exception):
    """Raised in a partial run right after its last merge point: the rest
    of the plan only computes what the merge run computes again."""


class _OpCombine:
    """Elementwise cross-morsel combine of one tensor partial."""

    __slots__ = ("op",)

    def __init__(self, op: str):
        expects(op in _OPS, f"unknown morsel merge op {op!r}")
        self.op = op

    def combine(self, accs: list, vals: list) -> list:
        a, v = accs[0], vals[0]
        if self.op == "sum":
            return [a + v]
        if self.op == "min":
            return [torch.minimum(a, v)]
        if self.op == "max":
            return [torch.maximum(a, v)]
        return [a | v]

    def init(self, avals: list, dev) -> list:
        shape, dtype = avals[0]
        if self.op in ("sum", "or"):
            return [torch.zeros(shape, dtype=dtype, device=dev)]
        if dtype.is_floating_point:
            fill = float("inf") if self.op == "min" else float("-inf")
        else:
            info = torch.iinfo(dtype)
            fill = info.max if self.op == "min" else info.min
        return [torch.full(shape, fill, dtype=dtype, device=dev)]


class _TopkCombine:
    """Cross-morsel merge of terminal top-k candidate rows: the
    accumulated k and the chunk's k concatenate, sort dead-last by the
    terminal keys, and the first k survive (the global top k is among
    the chunks' top k)."""

    __slots__ = ("names", "dtypes", "by", "desc", "k")

    def __init__(self, names, dtypes, by, desc, k: int):
        self.names = list(names)
        self.dtypes = list(dtypes)
        self.by = list(by)
        self.desc = list(desc)
        self.k = int(k)

    def combine(self, accs: list, vals: list) -> list:
        cols = [Column(dt, 2 * self.k, torch.cat([a, v]))
                for dt, a, v in zip(self.dtypes, accs[:-1], vals[:-1])]
        mask = torch.cat([accs[-1], vals[-1]])
        merged = Rel(Table(cols), self.names, mask=mask,
                     pending_sort=(self.by, self.desc), limit=self.k)
        flushed = merged._flush_sort()
        live = (torch.ones(flushed.num_rows, dtype=torch.bool,
                           device=mask.device)
                if flushed.mask is None else flushed.mask)
        return [c.data for c in flushed.table.columns] + [live]

    def init(self, avals: list, dev) -> list:
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for shape, dtype in avals]


class _MergeSpec:
    __slots__ = ("avals", "combiner")

    def __init__(self, avals, combiner):
        self.avals = avals      # [(shape, torch dtype), ...]
        self.combiner = combiner


class MorselTrace:
    """The context active while the plan runs over one chunk
    (``rel._MORSEL_CTX``); the seams call :meth:`merge` /
    :meth:`merge_many` at each cross-morsel merge point, in plan order.
    A partial run stops (``_MergesDone``) at its last merge point."""

    __slots__ = ("phase", "acc_in", "outputs", "specs", "cursor")

    def __init__(self, phase: str, acc_in=(), specs=None):
        self.phase = phase
        self.acc_in = list(acc_in)
        self.outputs: list = []
        self.specs = specs if specs is not None else []
        self.cursor = 0

    def merge_many(self, values: list, combiner) -> list:
        values = list(values)
        if self.phase == PHASE_DISCOVER:
            # the first fold: the accumulator starts at each combine's
            # identity, so the chunk's partials are the fold
            self.specs.append(_MergeSpec(
                [(tuple(v.shape), v.dtype) for v in values], combiner))
            self.outputs.extend(values)
            return values
        n = len(values)
        accs = self.acc_in[self.cursor:self.cursor + n]
        if len(accs) != n or any(
                tuple(a.shape) != tuple(v.shape) or a.dtype != v.dtype
                for a, v in zip(accs, values)):
            raise FusedFallback(
                "morsel merge structure diverged between runs")
        self.cursor += n
        if self.phase == PHASE_FINALIZE:
            return list(accs)  # the accumulated truth
        outs = combiner.combine(accs, values)
        self.outputs.extend(outs)
        if self.cursor == len(self.acc_in):
            raise _MergesDone()
        return outs

    def merge(self, value, op: str = "sum"):
        return self.merge_many([value], _OpCombine(op))[0]


# ---------------------------------------------------------------------------
# The terminal top-k over streamed rows
# ---------------------------------------------------------------------------

def _topk_candidates(out: Rel, k: int):
    """(tensors, live mask) of a chunk's top-k candidate rows, padded to
    k rows: a dead-last sort, the first k rows."""
    if any(c.validity is not None for c in out.table.columns):
        raise FusedFallback(
            "terminal streamed result with nullable columns")
    src = Rel(out.table, out.names, mask=out.mask, dicts=out.dicts,
              pending_sort=out.pending_sort)
    flushed = src._flush_sort()
    n = flushed.num_rows
    dev = flushed.device
    take = min(k, n)
    live = (torch.ones(n, dtype=torch.bool, device=dev)
            if flushed.mask is None else flushed.mask)
    mask = live[:take]
    if take < k:
        mask = torch.cat([mask, torch.zeros(k - take, dtype=torch.bool,
                                            device=dev)])
    leaves = []
    for c in flushed.table.columns:
        d = c.data[:take]
        if take < k:
            d = torch.cat([d, d.new_zeros((k - take,) + tuple(d.shape[1:]))])
        leaves.append(d)
    return leaves, mask


def _fold_terminal(ctx: MorselTrace, out: Rel, mesh) -> Optional[Rel]:
    """A terminal rel that still streams: its top-k candidates go through
    the merge machinery. Returns the merge run's rel over the
    accumulated candidates; None in the other phases."""
    if mesh is not None:
        raise FusedFallback(
            "terminal streamed result under a mesh (sort + LIMIT "
            "candidates are single-device; aggregate first)")
    if out.pending_sort is None or out.limit is None:
        raise FusedFallback(
            "terminal streamed result without sort + LIMIT: the whole row "
            "stream does not fit by construction")
    k = int(out.limit)
    by, desc = out.pending_sort
    leaves, mask = _topk_candidates(out, k)
    comb = _TopkCombine(out.names, [c.dtype for c in out.table.columns],
                        by, desc, k)
    merged = ctx.merge_many(list(leaves) + [mask], comb)
    if ctx.phase != PHASE_FINALIZE:
        return None
    cols = [Column(dt, k, d) for dt, d in zip(comb.dtypes, merged[:-1])]
    return Rel(Table(cols), out.names, mask=merged[-1], dicts=out.dicts,
               pending_sort=(by, desc), limit=k)


# ---------------------------------------------------------------------------
# Caches: the per-(plan, layout) entries and the standing (delta) state
# ---------------------------------------------------------------------------

DEFAULT_ENTRY_CACHE_SIZE = 64
DEFAULT_STANDING_CACHE_SIZE = 32


class _Entry:
    """What a (plan, layout) keeps between runs: the merge points in plan
    order (None until discovered), the route counters of the discovery
    run, and a fallback verdict."""

    __slots__ = ("specs", "trace_counters", "fallback")

    def __init__(self):
        self.specs: "Optional[list]" = None
        self.trace_counters: dict = {}
        self.fallback: Optional[str] = None


_ENTRY_LOCK = threading.Lock()
_ENTRIES: "OrderedDict" = OrderedDict()  # guarded-by: _ENTRY_LOCK


def _entry(key) -> "tuple[_Entry, bool]":
    with _ENTRY_LOCK:
        e = _ENTRIES.get(key)
        hit = e is not None
        if e is None:
            e = _ENTRIES[key] = _Entry()
            while len(_ENTRIES) > DEFAULT_ENTRY_CACHE_SIZE:
                _ENTRIES.popitem(last=False)
                count("rel.plan_cache_evictions.morsel")
        _ENTRIES.move_to_end(key)
        return e, hit


_STANDING_LOCK = threading.Lock()
_STANDING: "OrderedDict" = OrderedDict()  # guarded-by: _STANDING_LOCK


class _Standing:
    __slots__ = ("tokens", "folded", "acc", "resident")

    def __init__(self, tokens, folded, acc, resident):
        self.tokens = tokens      # {table: (batch token, ...)} folded
        self.folded = folded      # {table: rows folded into acc}
        self.acc = acc            # device tensors, never updated in place
        self.resident = resident  # {name: Rel}: identity proof, pinned


def reset_standing_state() -> None:
    """Drop every kept standing-query accumulator (tests)."""
    with _STANDING_LOCK:
        _STANDING.clear()


def standing_state_size() -> int:
    with _STANDING_LOCK:
        return len(_STANDING)


def _standing_lookup(key, resident, snaps, stream_order):
    """The kept state this run may extend, or None. Reuse needs the same
    resident rel objects and, per streamed table, a token prefix match
    (the ingest log only grows)."""
    with _STANDING_LOCK:
        st = _STANDING.get(key)
        if st is not None:
            _STANDING.move_to_end(key)
    if st is None:
        return None
    if any(st.resident.get(n) is not resident[n] for n in resident):
        count("rel.morsel_delta_invalidations")
        return None
    for name in stream_order:
        tokens = snaps[name][3]
        prev = st.tokens.get(name, ())
        if tokens[:len(prev)] != prev:
            count("rel.morsel_delta_invalidations")
            return None
    return st


def _standing_store(key, st: _Standing) -> None:
    with _STANDING_LOCK:
        _STANDING[key] = st
        _STANDING.move_to_end(key)
        cap = max(1, env_int("SRT_STANDING_CACHE_SIZE",
                             DEFAULT_STANDING_CACHE_SIZE))
        while len(_STANDING) > cap:
            _STANDING.popitem(last=False)
            count("rel.morsel_standing_evictions")


# ---------------------------------------------------------------------------
# Fingerprints and scan filters
# ---------------------------------------------------------------------------

def _scan_filters(ht, snap) -> tuple:
    """Canonical scan conjuncts of a streamed table's snapshot (``()``
    for a plain HostTable); part of the entry and standing keys."""
    fn = getattr(ht, "scan_filters", None)
    return tuple(fn(snap)) if fn is not None else ()


def _scan_filter_mask(data, op: str, v):
    """The device mask of one canonical conjunct (the twin of
    ``disk_table._np_filter_mask``)."""
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
    return data != v  # ne


def _chunk_skippable(ht, snap, start: int, live: int) -> bool:
    """True when the table proves chunk [start, start+live) holds no row
    passing its scan conjunction (a Parquet table's zone maps)."""
    fn = getattr(ht, "chunk_provably_empty", None)
    return fn is not None and fn(snap, start, live)


def _stream_fingerprint(stream, snaps, caps) -> tuple:
    fps = []
    for name in sorted(stream):
        ht = stream[name]
        _, cols, dicts, _ = snaps[name]
        col_sig = tuple((int(cols[n].dtype.id), cols[n].dtype.scale,
                         caps[name], cols[n].value_range)
                        for n in ht.names)
        dict_sig = tuple(sorted((n, _rel._dict_digest(v))
                                for n, v in dicts.items()))
        fps.append((name, tuple(ht.names), col_sig, dict_sig,
                    _scan_filters(ht, snaps[name])))
    return tuple(fps)


# ---------------------------------------------------------------------------
# Staging: two pinned host buffers, two device buffers, a copy stream
# ---------------------------------------------------------------------------

def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


class _Staging:
    """The double-buffered staging of one layout (``(table, column, numpy
    dtype, rows)`` a column): two host buffers (pinned on a card) and two
    device buffers of ``nbytes`` each, every column at a 64-byte-aligned
    offset. On the CPU the host buffer is the device buffer."""

    def __init__(self, layout: tuple, dev: torch.device):
        self.layout = layout
        self.dev = dev
        self.cuda = dev.type == "cuda"
        offs, off = [], 0
        for _, _, dt, rows in layout:
            off = -(-off // 64) * 64
            offs.append(off)
            off += rows * np.dtype(dt).itemsize
        self.offsets = offs
        self.nbytes = max(off, 1)
        # zeros at first: a slot no morsel has filled is a dead chunk of
        # zeros, as the reference pads
        self.host = [torch.zeros(self.nbytes, dtype=torch.uint8,
                                 pin_memory=self.cuda) for _ in range(2)]
        self.host_np = [h.numpy() for h in self.host]
        if self.cuda:
            self.device = [torch.zeros(self.nbytes, dtype=torch.uint8,
                                       device=dev) for _ in range(2)]
            self.stream = torch.cuda.Stream(device=dev)
            for b in self.device:
                b.record_stream(self.stream)
        else:
            self.device = self.host
            self.stream = None
        self.views = [[self._view(self.device[s], i)
                       for i in range(len(layout))] for s in range(2)]
        # rows of each column a device buffer may hold nonzero (paged)
        self.extent = [[0] * len(layout) for _ in range(2)]
        self.copied = [None, None]    # copy into slot s done
        self.consumed = [None, None]  # partial run over slot s done

    def _view(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        _, _, dt, rows = self.layout[i]
        isz = np.dtype(dt).itemsize
        off = self.offsets[i]
        return buf[off:off + rows * isz].view(_torch_dtype(dt))

    def fill(self, slot: int, arrays: list, copy_rows: "Optional[list]"):
        """Stage one morsel into ``slot``: ``arrays`` are each column's
        live rows; ``copy_rows`` None copies whole columns (the dead tail
        zero), else column i copies its first ``copy_rows[i]`` rows (the
        live pages) and rows past them that the slot held before are
        zeroed on the device. Returns the bytes sent to the device."""
        if self.cuda and self.copied[slot] is not None:
            self.copied[slot].synchronize()  # the pinned buffer is free
        hnp = self.host_np[slot]
        for i, src in enumerate(arrays):
            _, _, dt, rows = self.layout[i]
            isz = np.dtype(dt).itemsize
            off = self.offsets[i]
            dst = hnp[off:off + rows * isz].view(dt)
            n = int(src.shape[0])
            end = rows if copy_rows is None else copy_rows[i]
            if n:
                if src.flags.writeable and src.flags.c_contiguous:
                    torch.from_numpy(dst[:n]).copy_(torch.from_numpy(src))
                else:
                    np.copyto(dst[:n], src)
            if end > n:
                dst[n:end] = 0
        sent = 0
        with (torch.cuda.stream(self.stream) if self.cuda
              else contextlib.nullcontext()):
            if self.cuda and self.consumed[slot] is not None:
                self.stream.wait_event(self.consumed[slot])
            if copy_rows is None:
                if self.cuda:
                    self.device[slot].copy_(self.host[slot],
                                            non_blocking=True)
                sent = self.nbytes
            else:
                for i, rows_i in enumerate(copy_rows):
                    _, _, dt, rows = self.layout[i]
                    isz = np.dtype(dt).itemsize
                    off = self.offsets[i]
                    if self.cuda and rows_i:
                        self.device[slot][off:off + rows_i * isz].copy_(
                            self.host[slot][off:off + rows_i * isz],
                            non_blocking=True)
                    sent += rows_i * isz
                    prev = self.extent[slot][i]
                    if prev > rows_i:
                        self.device[slot][off + rows_i * isz:
                                          off + prev * isz].zero_()
                    self.extent[slot][i] = rows_i
            if copy_rows is None:
                self.extent[slot] = [rows for *_, rows in self.layout]
            if self.cuda:
                ev = torch.cuda.Event()
                ev.record(self.stream)
                self.copied[slot] = ev
        return sent

    def acquire(self, slot: int) -> None:
        """The compute stream waits for slot ``slot``'s copy."""
        if self.cuda and self.copied[slot] is not None:
            torch.cuda.current_stream(self.dev).wait_event(
                self.copied[slot])

    def release(self, slot: int) -> None:
        """Slot ``slot``'s partial run is enqueued: its next copy waits
        for it."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.dev))
            self.consumed[slot] = ev


_STAGING_LOCK = threading.Lock()
_STAGING: "OrderedDict" = OrderedDict()  # guarded-by: _STAGING_LOCK
_STAGING_KEEP = 2


def _take_staging(layout: tuple, dev: torch.device) -> _Staging:
    """A free staging object of ``layout`` (kept from an earlier run, so
    warm runs pin and allocate nothing), or a new one."""
    key = (str(dev), layout)
    with _STAGING_LOCK:
        st = _STAGING.pop(key, None)
    return st if st is not None else _Staging(layout, dev)


def _give_staging(st: _Staging) -> None:
    key = (str(st.dev), st.layout)
    with _STAGING_LOCK:
        _STAGING[key] = st
        while len(_STAGING) > _STAGING_KEEP:
            _STAGING.popitem(last=False)


def reset_staging() -> None:
    """Drop the kept staging buffers (tests; frees pinned memory)."""
    with _STAGING_LOCK:
        _STAGING.clear()


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

def _split_tables(rels: dict):
    stream, resident = {}, {}
    for name, r in rels.items():
        if getattr(r, "is_host_table", False):
            stream[name] = r
        else:
            resident[name] = r
    return stream, resident


def _col_np_dtype(c) -> np.dtype:
    return np.dtype(c.np_dtype)


def _incore(plan, rels: dict, dev, mesh, axis, info: dict) -> Rel:
    """The plan over every table in-core on ``dev``."""
    full = {name: (r.to_rel(dev) if getattr(r, "is_host_table", False)
                   else r) for name, r in rels.items()}
    if mesh is not None:
        from ..tpcds import dist as _dist
        return _dist.run_partitioned(plan, full, mesh, axis=axis,
                                     device=dev, info=info)
    return _rel._run_fused_impl(plan, full, dev, info)


def run_morsels(plan, rels: dict, info: "Optional[dict]" = None, mesh=None,
                axis=None, morsels=None, device=None) -> Rel:
    """The morsel entry (``run_fused`` routes here when any ``rels``
    value is a host table or ``morsels`` is given). ``info``, when
    given, receives the run's provenance (``cold``, ``warm_memory`` or
    ``delta``), its ``morsel`` facts and, for Parquet tables, its ``io``
    facts. When streaming cannot hold the plan the host tables
    materialize on the run's device and the plan runs in-core, counted
    ``rel.morsel_fallbacks``: never an error."""
    if info is None:
        info = {}
    pname = getattr(plan, "__name__", "plan").lstrip("_")
    dev = (mesh.device if mesh is not None and device is None
           else resolve_device(device))
    probe = None
    if mesh is not None:
        from ..tpcds import dist as _dist
        probe = _dist.agreed_scratch_probe(mesh, axis, dev)
    # the planner's flags are process-global: one plan run at a time
    with _rel._PLAN_LOCK, (comm_plan.agreed_probe_scope(probe)
                           if mesh is not None
                           else contextlib.nullcontext()):
        try:
            return _run_morsels_impl(plan, rels, info, mesh, axis,
                                     morsels, pname, dev)
        except FusedFallback as e:
            count("rel.morsel_fallbacks")
            count(f"rel.morsel_fallbacks.{pname}")
            info["fallback"] = str(e)
            return _incore(plan, rels, dev, mesh, axis, info)


def _run_budget(dev, mesh, axis) -> Optional[int]:
    """The window budget; under a mesh the minimum of the ranks' probes,
    agreed once a mesh (the ranks must plan alike)."""
    budget = morsel_bytes_budget(dev)
    if mesh is None or env_int("SRT_MORSEL_BYTES", 0) > 0:
        return budget
    from ..parallel import mesh_axes_key
    from ..parallel.collectives import all_reduce

    def agree(local: int) -> int:
        t = torch.tensor([local], dtype=torch.int64, device=dev)
        return int(all_reduce(t, axis, mesh, "min")[0])

    return agreed_budget(budget, (mesh_axes_key(mesh), str(axis)), agree)


def _run_morsels_impl(plan, rels, info, mesh, axis, morsels, pname, dev):
    stream, resident = _split_tables(rels)
    if not stream:
        raise FusedFallback("morsels requested but no streamed table")
    _rel._check_device(resident, dev)
    for name, r in resident.items():
        if (not _rel._fusable_rel(r) or r.mask is not None
                or (mesh is not None
                    and any(c.validity is not None
                            for c in r.table.columns))):
            raise FusedFallback(
                f"resident table {name!r} is not morsel-fusable")
        for c in r.table.columns:
            _rel._trusted_range(c)  # verify advisory stats once (memoized)

    p, dctx = 1, None
    if mesh is not None:
        from ..tpcds import dist as _dist
        axis, axes = _dist._resolve_axis(mesh, axis)
        p = int(np.prod([mesh.shape[a] for a in axes]))

    force = (morsels if isinstance(morsels, int) and morsels > 0
             else None)
    budget = _run_budget(dev, mesh, axis)
    mplan = (morsels if isinstance(morsels, MorselPlan)
             else plan_morsels(stream, budget, force_min=force,
                               mesh_parts=p))
    if mplan is None:
        # the admission verdict: everything fits in-core under the budget
        # (or there is no budget signal and nothing was forced)
        count("rel.route.morsel.incore")
        info["morsel"] = {"incore": True, "budget_bytes": budget}
        return _incore(plan, rels, dev, mesh, axis, info)

    snaps = {name: ht.snapshot() for name, ht in stream.items()}
    caps = mplan.capacities
    stream_order = sorted(stream)
    res_order = sorted(resident)
    parts: dict = {}
    if mesh is not None:
        threshold = _dist.broadcast_threshold()
        parts = {name: ("replicated"
                        if _dist.table_nbytes(resident[name]) <= threshold
                        else "sharded") for name in res_order}
    fps = tuple(_rel._rel_fingerprint(resident[n]) for n in res_order)
    sfps = _stream_fingerprint(stream, snaps, caps)
    sfilters = {name: _scan_filters(stream[name], snaps[name])
                for name in stream_order}
    has_disk = any(getattr(ht, "is_disk_table", False)
                   for ht in stream.values())
    penv = _rel.planner_env_key()
    meshdesc = None
    if mesh is not None:
        from ..parallel import mesh_axes_key
        meshdesc = (str(axis), mesh_axes_key(mesh),
                    tuple(sorted(parts.items())))
    # the paged staging route (one device only): lease the modeled window
    # from the page ledger, copy only live pages; a starved pool degrades
    # to whole-buffer staging, counted
    paged, lease = False, None
    if mesh is None:
        pool = _pages.page_pool()
        if pool is not None:
            lease = pool.lease(int(mplan.window_bytes),
                               tag=f"morsel.{pname}")
            if lease is None:
                count("exec.morsel.pool_degraded")
            else:
                paged = True
    key = (plan, tuple(res_order), fps, sfps, penv,
           None if mesh is None else (id(mesh),) + meshdesc, paged,
           str(dev))
    staging, entry = None, None
    try:
        entry, hit = _entry(key)
        info["cache_hit"] = hit
        if entry.fallback is not None:
            raise FusedFallback(entry.fallback)
        skey = (plan, tuple(res_order), fps, tuple(stream_order),
                tuple(sorted(caps.items())), penv, meshdesc,
                tuple(sorted(sfilters.items())), str(dev))
        st = _standing_lookup(skey, resident, snaps, stream_order)
        folded = (dict(st.folded) if st is not None
                  else {name: 0 for name in stream_order})
        rows_now = {name: int(stream[name].snapshot_rows(snaps[name]))
                    for name in stream_order}
        n_morsels = mplan.n_morsels(rows_now, folded)
        if st is not None and not any(rows_now[n] > folded[n]
                                      for n in stream_order):
            n_morsels = 0  # nothing new: merge the kept accumulator only

        if mesh is not None:
            from ..tpcds import dist as _dist
            dctx = _dist.DistTrace(axis, p, tuple(
                mesh.shape[a] for a in axes), mesh)
            res_rels = _dist._place_inputs(resident, mesh, axis, p,
                                           dctx.index, parts, res_order)
        else:
            res_rels = dict(resident)
        rank = 0 if dctx is None else dctx.index
        chunk_specs = {}
        layout = []
        for name in stream_order:
            ht = stream[name]
            _, cols, dicts, _ = snaps[name]
            chunk_specs[name] = (list(ht.names), dict(dicts),
                                 [(cols[c].dtype, cols[c].value_range)
                                  for c in ht.names])
            for c in ht.names:
                layout.append((name, c, _col_np_dtype(cols[c]).str,
                               caps[name] // p))
        layout = tuple(layout)
        pbytes = _pages.page_bytes() if paged else 0
        io_before = ({name: stream[name].io_stats()
                      for name in stream_order
                      if hasattr(stream[name], "io_stats")}
                     if has_disk else {})
        zone_skips = [0]
        h2d = [0]
        last = [0]  # the slot staged last

        def live_counts(k: int) -> list:
            """Each table's live rows in morsel k (the whole morsel, so
            every rank reads the same), zone-map skips applied."""
            live = []
            for name in stream_order:
                cap = caps[name]
                base = folded[name] + k * cap
                n_live = int(np.clip(rows_now[name] - base, 0, cap))
                if n_live and _chunk_skippable(stream[name], snaps[name],
                                               base, n_live):
                    count("exec.morsel.zonemap_skipped")
                    zone_skips[0] += 1
                    n_live = 0
                live.append(n_live)
            return live

        def stage(k: int):
            """Host-slice morsel k into staging slot k % 2 and start its
            copy to the device; None when every table is dead in it."""
            live = live_counts(k)
            if not any(live):
                return None
            slot = k % 2
            arrays, copy_rows, pages = [], ([] if paged else None), 0
            for i, name in enumerate(stream_order):
                ht = stream[name]
                cap_l = caps[name] // p
                base = folded[name] + k * caps[name]
                # the whole morsel's rows (a Parquet table decodes, and
                # checks, the same row groups on every rank), then this
                # rank's slice of them
                views = (ht.chunk_views(snaps[name][1], base, live[i])
                         if live[i] else None)
                lo = rank * cap_l
                n_rank = int(np.clip(live[i] - lo, 0, cap_l))
                for ci, c in enumerate(ht.names):
                    dt = _col_np_dtype(snaps[name][1][c])
                    arrays.append(views[ci][lo:lo + n_rank]
                                  if views is not None else np.zeros(0, dt))
                    if paged:
                        prows = max(1, min(cap_l, pbytes // dt.itemsize))
                        n_pages = -(-n_rank // prows)
                        pages += n_pages
                        copy_rows.append(min(cap_l, n_pages * prows))
            if pages:
                count("exec.morsel.paged_pages", pages)
            h2d[0] += staging.fill(slot, arrays, copy_rows)
            last[0] = slot
            return slot, live

        def chunk_rels(datas_for, live: list, cap_of) -> dict:
            """The plan's rels: the residents and one chunk a streamed
            table, its declared ranges trusted, rows past the live count
            (and failing rows of a scan filter) dead."""
            out = dict(res_rels)
            j = 0
            for i, name in enumerate(stream_order):
                names, dicts, cspecs = chunk_specs[name]
                cap_l = cap_of(name)
                datas = datas_for[j:j + len(names)]
                j += len(names)
                cols = [_rel._trust(Column(dt, cap_l, d, value_range=rng))
                        for (dt, rng), d in zip(cspecs, datas)]
                start = rank * cap_l
                mask = torch.arange(start, start + cap_l, dtype=torch.int64,
                                    device=dev) < live[i]
                r = Rel(Table(cols), names, mask=mask, dicts=dicts)
                for ci, op, v in sfilters[name]:
                    r.mask = r.mask & _scan_filter_mask(cols[ci].data, op, v)
                r.part = "sharded"
                r.morsel = True
                out[name] = r
            return out

        def run(phase: str, rels_now: dict, acc):
            """One run of the plan under a MorselTrace: the trace, and the
            finalize phase's terminal rel and runtime counters."""
            ctx = MorselTrace(phase, acc_in=acc or (),
                              specs=[] if phase == PHASE_DISCOVER
                              else entry.specs)
            _rel._FUSED_TRACING = True
            _rel._MORSEL_CTX = ctx
            _rel._DIST_CTX = dctx
            _rel._TRACE_AUX = aux = []
            out, mask = None, None
            try:
                out = plan(rels_now)
                if out.morsel:
                    out = _fold_terminal(ctx, out, mesh)
                if phase == PHASE_FINALIZE and dctx is not None:
                    order = _dist._sort_meta(out) + (out.limit,)
                    out, mask = _dist.terminal_mask(out, dctx.index)
                    out = (out, mask, order)
            except _MergesDone:
                pass
            finally:
                _rel._FUSED_TRACING = False
                _rel._MORSEL_CTX = None
                _rel._DIST_CTX = None
                _rel._TRACE_AUX = None
            if phase != PHASE_DISCOVER and ctx.cursor != len(ctx.acc_in):
                raise FusedFallback(
                    "morsel merge structure diverged between runs")
            return ctx, out, aux

        def dead_run(phase: str, acc):
            """The plan over slot ``last[0]`` with every row dead: the
            merge run, or a discovery when no morsel is live."""
            slot = last[0]
            staging.acquire(slot)
            try:
                return run(phase, chunk_rels(
                    staging.views[slot], [0] * len(stream_order),
                    lambda name: caps[name] // p), acc)
            finally:
                staging.release(slot)

        def discover(rels_now: Optional[dict], acc_from_run: bool):
            tb = kernel_stats()
            with span("exec.morsel.discover"):
                ctx, _, _ = (run(PHASE_DISCOVER, rels_now, None)
                             if rels_now is not None
                             else dead_run(PHASE_DISCOVER, None))
            entry.specs = ctx.specs
            entry.trace_counters = {
                k: v for k, v in stats_since(tb).items()
                if not k.startswith(("rel.dispatches", "rel.host_syncs"))}
            info["provenance"] = "cold"
            if acc_from_run:
                return ctx.outputs
            return [t for s in ctx.specs
                    for t in s.combiner.init(s.avals, dev)]

        staging = _take_staging(layout, dev)
        if entry.specs is None and st is not None:
            acc = st.acc  # specs forgotten, state kept: learn them dead
            discover(None, False)
        elif entry.specs is not None:
            info["provenance"] = "warm_memory"
            acc = (st.acc if st is not None else
                   [t for s in entry.specs
                    for t in s.combiner.init(s.avals, dev)])
        else:
            acc = None  # the first live morsel discovers
        acc_bytes = 0

        # ---- the double-buffered pump -----------------------------------
        overlap = REGISTRY.histogram("exec.morsel.overlap_ns")
        fold_ns = REGISTRY.histogram("io.disk.fold_ns")
        qid = _obs_report.current_qid()
        _flight.note("morsel_pump", query=pname, morsels=n_morsels,
                     delta_start=sum(folded.values()))
        with span("exec.morsel.pump", morsels=n_morsels,
                  delta_start=sum(folded.values()), qid=qid):
            staged = stage(0) if n_morsels else None
            for k in range(n_morsels):
                if staged is not None and entry.specs != []:
                    slot, live = staged
                    # the dispatch seam: a fault here abandons this fold;
                    # the kept accumulator is untouched, the retry replays
                    _faults.maybe_inject(_faults.SEAM_DISPATCH)
                    tf = time.perf_counter_ns()
                    staging.acquire(slot)
                    rels_now = chunk_rels(
                        staging.views[slot], live,
                        lambda name: caps[name] // p)
                    if acc is None:
                        acc = discover(rels_now, True)
                    else:
                        ctx, _, _ = run(PHASE_PARTIAL, rels_now, acc)
                        acc = ctx.outputs
                    staging.release(slot)
                    if has_disk:
                        fold_ns.observe(time.perf_counter_ns() - tf)
                    count_dispatch("exec.morsel.partial")
                else:
                    # every chunk of this morsel is dead (zone-map skips or
                    # an aligned tail), or the plan has no merge point:
                    # folding it is each combine's identity
                    count("exec.morsel.dispatch_skipped")
                if k + 1 < n_morsels:
                    t0 = time.perf_counter_ns()
                    staged = stage(k + 1)  # overlaps morsel k's kernels
                    overlap.observe(time.perf_counter_ns() - t0)
        if acc is None:  # no live morsel ever ran: learn the merges dead
            acc = discover(None, False)
        acc_bytes = sum(t.numel() * t.element_size() for t in acc)

        # ---- the merge run ------------------------------------------------
        _flight.note("morsel_merge", query=pname, acc_bytes=acc_bytes)
        with span("exec.morsel.merge", qid=qid):
            ctx, out, aux = dead_run(PHASE_FINALIZE, acc)
        count_dispatch("exec.morsel.merge")
        if dctx is not None:
            count("shuffle.peak_scratch_bytes", dctx.scratch_peak)
            result = _dist.finish_partitioned(
                out[0], out[1], aux, out[2], dctx, dev,
                sync_site="exec.morsel.count")
        else:
            result = _rel.finish_fused(out, aux,
                                       sync_site="exec.morsel.count")
    except FusedFallback as e:
        if entry is not None:
            entry.fallback = str(e)  # later runs go in-core at once
        raise
    finally:
        if staging is not None:
            _give_staging(staging)
        if lease is not None:
            lease.release()

    # ---- standing state + accounting --------------------------------------
    delta = st is not None
    _standing_store(skey, _Standing(
        tokens={name: snaps[name][3] for name in stream_order},
        folded={name: rows_now[name] for name in stream_order},
        acc=acc, resident=dict(resident)))
    if delta:
        count("rel.morsel_delta_reuse")
        info["provenance"] = "delta"
    info["fused"] = True
    info["trace_counters"] = dict(entry.trace_counters)
    model = mplan.window_bytes + acc_bytes
    gauge("exec.morsel.peak_model_bytes").set(model)
    gauge("exec.morsel.capacity_rows").set(max(caps.values()))
    if mplan.budget_bytes is not None:
        gauge("exec.morsel.budget_bytes").set(mplan.budget_bytes)
        if model > mplan.budget_bytes and not mplan.budget_unmet:
            # the accumulator pushed the modeled window past the budget
            count("rel.morsel_budget_unmet")
    count("exec.morsel.runs")
    count("exec.morsel.folded", n_morsels)
    count("exec.morsel.h2d_bytes", h2d[0])
    if paged:
        count("exec.morsel.paged")
    info["morsel"] = {
        "paged": bool(paged),
        "streamed": list(stream_order),
        "n_morsels": int(n_morsels),
        "capacity_rows": dict(caps),
        "budget_bytes": mplan.budget_bytes,
        "window_bytes": int(mplan.window_bytes),
        "acc_bytes": int(acc_bytes),
        "peak_model_bytes": int(model),
        "h2d_bytes": int(h2d[0]),
        "delta": bool(delta),
        "folded_rows": {n: int(folded[n]) for n in stream_order},
        "total_rows": {n: int(rows_now[n]) for n in stream_order},
        "zonemap_skipped": int(zone_skips[0]),
    }
    if has_disk:
        agg: dict = {}
        for name in stream_order:
            if not hasattr(stream[name], "io_stats"):
                continue
            before = io_before.get(name, {})
            for k2, v2 in stream[name].io_stats().items():
                agg[k2] = agg.get(k2, 0) + int(v2) - int(before.get(k2, 0))
        agg["zonemap_skipped"] = int(zone_skips[0])
        info["io"] = agg
    return result
