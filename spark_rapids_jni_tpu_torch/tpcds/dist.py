"""Partitioned whole-plan execution: the fused runner over a mesh.

Port of ``spark_rapids_jni_tpu/tpcds/dist.py``. ``run_fused(plan, rels,
mesh=...)`` lands here. The reference traces the plan once under
``shard_map``; the port is one process a device: every rank of the mesh
calls ``run_fused`` with the same global ``rels``, keeps its own row
shard, runs the plan eagerly with the collectives on the mesh's process
groups (NCCL on CUDA, gloo on the CPU), and gets the same materialized
result back.

**Sharded ingest.** Each input table is row-SHARDED (split into
``shard_capacity`` rows a shard, the tail padded with dead rows under a
validity mask) or REPLICATED in full on every shard, decided from its
byte size against ``SRT_BROADCAST_THRESHOLD`` (Spark's
``autoBroadcastJoinThreshold`` analogue).

**Distributed join planner** (``tpcds/oplib/relational.py``): a
replicated build side is a broadcast-hash join (shard-local); a sharded
build side takes presence-psum (semi/anti), the reduce-scatter join or
the shuffle-hash join (``SRT_SHUFFLE_JOIN_ROUTE``), else one all_gather
replicates it. Dense groupbys merge their per-shard partials with an
all-reduce or, past ``SRT_GROUPBY_PSUM_WIDTH`` slots, a reduce-scatter.
Windows exchange rows so each partition lands on one shard.

**Rank agreement.** A collective that one rank reaches and another does
not hangs the mesh. Every route, fallback and threshold verdict here is
decided on the host from the global rels' verified stats and static
shapes, which every rank shares, so all ranks take the same collectives
in the same order, and on a fallback all return to the single-device
path together.

**Capacity and communication plans.** The exchanges use the lossless
lane capacity (a shard's row count), so no rows overflow and no sizes
need exchanging; ``parallel/comm_plan.py`` stages each exchange into
rounds under ``SRT_SHUFFLE_SCRATCH_BYTES``. Every collective's route,
wire bytes, rounds and modeled peak scratch land in the ``shuffle.*``
counters.

**One host sync a rank.** After the plan, one ``all_gather`` brings
every shard's live-row count and runtime counters to every rank, read
once on the host (the counted ``rel.mask_count`` sync); the live rows
are then padded to the largest shard's count, gathered, and put through
the terminal sort or top-k (``rel.route.sort.topk``) and the limit.

**Morsels over a mesh.** The morsel runner (``exec/runner.py``) drives
the same plan with the streamed tables staged a rank's slice of each
morsel at a time; the operators merge over ranks first, then over
morsels. The collective outputs keep the morsel flag (a redistributed
chunk is still a chunk), and the runner reuses this module's result tail
(``terminal_mask``, ``finish_partitioned``).

The reference's plan caches and AOT tokens have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column, Table
from ..config import env_int
from ..obs import count, count_dispatch, count_host_sync, set_attrs, span
from ..obs import memory as _obs_memory
from ..parallel import (all_gather_rows, axis_index_flat, data_axes,
                        exchange_columns, exchange_columns_hier,
                        exchange_wire_bytes, hash_partition_ids,
                        intra_exchange_route, mesh_axes_key,
                        neighborhood_size, plan_exchange,
                        plan_exchange_hier, shard_capacity)
from ..parallel import comm_plan
from ..parallel.collectives import all_reduce
from ..utils.device import resolve_device
from . import rel as _rel
from .rel import FusedFallback, Rel

# Build tables at or below this byte size replicate to every shard; larger
# ones shard by rows (Spark's autoBroadcastJoinThreshold analogue).
DEFAULT_BROADCAST_THRESHOLD = 1 << 20

# Dense groupbys up to this slot-space width merge partials with an
# all-reduce (replicated result); wider ones reduce-scatter.
DEFAULT_PSUM_WIDTH_CAP = 1 << 16


def broadcast_threshold() -> int:
    return env_int("SRT_BROADCAST_THRESHOLD", DEFAULT_BROADCAST_THRESHOLD)


def psum_width_cap() -> int:
    return env_int("SRT_GROUPBY_PSUM_WIDTH", DEFAULT_PSUM_WIDTH_CAP)


def table_nbytes(r: Rel) -> int:
    """A rel's column payload as the reference counts it (element size x
    rows, from shapes): the broadcast verdict needs no device read."""
    return sum(c.data.element_size() * int(c.size) for c in r.table.columns)


class DistTrace:
    """The active partitioned run, read by the operators as
    ``rel._DIST_CTX``: the mesh, the data ``axis`` (one axis name, or an
    outer-first tuple of two when data shards over ``intra x part``),
    the per-axis shard counts, their product ``nshards``, this rank's
    flat shard ``index``, and the run's modeled peak exchange scratch
    (the max over its collectives; ``shuffle.peak_scratch_bytes``)."""

    __slots__ = ("axis", "nshards", "axis_sizes", "scratch_peak", "mesh",
                 "index")

    def __init__(self, axis, nshards: int, axis_sizes=None, mesh=None):
        self.axis = axis
        self.nshards = nshards
        self.axis_sizes = (tuple(int(s) for s in axis_sizes)
                           if axis_sizes is not None else (int(nshards),))
        self.scratch_peak = 0
        self.mesh = mesh
        self.index = 0 if mesh is None else axis_index_flat(axis, mesh)

    def note_scratch(self, nbytes: int) -> None:
        self.scratch_peak = max(self.scratch_peak, int(nbytes))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reference's ``psum`` over the data axis."""
        return all_reduce(x, self.axis, self.mesh, op)


def count_route_bytes(route: str, nbytes: int, rounds: int = 1) -> None:
    """Account one collective's wire traffic under its route name:
    ``shuffle.rounds[.route]`` and ``shuffle.bytes_exchanged`` /
    ``shuffle.bytes.<route>``."""
    count("shuffle.rounds", rounds)
    count(f"shuffle.rounds.{route}", rounds)
    count("shuffle.bytes_exchanged", int(nbytes))
    count(f"shuffle.bytes.{route}", int(nbytes))


def count_merge_bytes(partial: torch.Tensor, merge: str = "psum") -> None:
    """Account one groupby partial merge: ``replicated`` (an all-reduce,
    route ``psum``) or ``scattered`` (``reduce_scatter``)."""
    ctx = _rel._DIST_CTX
    nbytes = partial.element_size() * int(partial.shape[0])
    route = "reduce_scatter" if merge == "scattered" else "psum"
    count_route_bytes(route, ctx.nshards * nbytes)
    # scratch model: the merged partial plus the collective's working copy
    ctx.note_scratch(2 * nbytes)


# ---------------------------------------------------------------------------
# Collective rel transforms (called from the operators)
# ---------------------------------------------------------------------------

def col_like(src: Column, data: torch.Tensor, size: int) -> Column:
    """A column around redistributed rows that keeps the VERIFIED stats:
    a shuffle or gather moves a subset of the verified rows, so the
    range stays true and uniqueness holds (hash routing sends every
    occurrence of a key to one shard). Dead receive slots hold zeros,
    which may lie outside the range: every consumer masks them."""
    nc = Column(src.dtype, size, data, value_range=src.value_range)
    flags = getattr(src, "_stats_flags", None)
    if flags is not None:
        nc._stats_flags = flags
    if src.unique is not None:
        nc.unique = src.unique
    return nc


def live_mask(r: Rel) -> torch.Tensor:
    if r.mask is not None:
        return r.mask
    return torch.ones(r.num_rows, dtype=torch.bool, device=r.device)


def all_gather_rel(r: Rel) -> Rel:
    """Replicate a sharded rel on every shard, one all_gather a column:
    the build side of a join with no cheaper collective route."""
    ctx = _rel._DIST_CTX
    live = live_mask(r)
    datas = [all_gather_rows(c.data, ctx.axis, ctx.mesh)
             for c in r.table.columns]
    gmask = all_gather_rows(live, ctx.axis, ctx.mesh)
    size = r.num_rows * ctx.nshards
    cols = [col_like(c, d, size) for c, d in zip(r.table.columns, datas)]
    out = Rel(Table(cols), r.names, mask=gmask, dicts=r.dicts)
    out.part = "replicated"
    out.morsel = r.morsel
    count("rel.route.dist.all_gather")
    gathered = ctx.nshards * (table_nbytes(r) + r.num_rows)
    count_route_bytes("all_gather", gathered)
    # the replicated copy every device holds IS the route's memory price
    ctx.note_scratch(gathered)
    return out


def localize_replicated(r: Rel) -> Rel:
    """A replicated rel as a sharded one whose rows live on shard 0 only
    (for unions with sharded rels: the global row multiset stays whole
    and no data moves)."""
    ctx = _rel._DIST_CTX
    here = torch.full((r.num_rows,), ctx.index == 0, dtype=torch.bool,
                      device=r.device)
    out = r.filter(here)
    out.part = "sharded"
    return out


def exchange_rel(r: Rel, pids: torch.Tensor) -> Rel:
    """Send a sharded rel's live rows to the shards ``pids`` names, at
    the lossless lane capacity (``overflow_rows`` zero by construction),
    staged by the communication planner when the scratch budget demands
    it. On a mesh whose data shards over ``intra x part`` the exchange
    takes the two-stage intra plan (``rel.route.shuffle.intra``); with
    ``SRT_SHUFFLE_NEIGHBORHOOD`` a divisor of the shard count it takes
    the neighbourhood plan (``rel.route.shuffle.neighborhood``). Both
    deliver the flat exchange's rows at a lower modeled peak
    (``shuffle.flat_peak_scratch_bytes`` is the flat baseline)."""
    ctx = _rel._DIST_CTX
    p = ctx.nshards
    cap = r.num_rows  # lossless: a sender owns at most n_local rows
    datas = [c.data for c in r.table.columns]
    col_bytes = [d.element_size() * int(np.prod(tuple(d.shape[1:]),
                                                dtype=np.int64))
                 for d in datas]
    hier = None
    if isinstance(ctx.axis, tuple):
        # the routed destination lane is an extra int32 column
        a, b = ctx.axis_sizes
        hier = plan_exchange_hier(cap, a, b, col_bytes + [4], route="intra")
    else:
        g = neighborhood_size()
        if g and p % g == 0 and p // g >= 2:
            hier = plan_exchange_hier(cap, g, p // g, col_bytes + [4],
                                      route="neighborhood")
    if hier is not None:
        count(f"rel.route.shuffle.{hier.route}")
        if not hier.fits_budget:
            count("rel.route.shuffle.budget_unmet")
        count_route_bytes("exchange", hier.total_bytes, rounds=hier.rounds)
        count("shuffle.flat_peak_scratch_bytes",
              hier.flat_peak_scratch_bytes)
        ctx.note_scratch(hier.peak_scratch_bytes)
        set_attrs(shuffle_route=hier.route, shuffle_rounds=hier.rounds,
                  shuffle_peak_scratch=hier.peak_scratch_bytes)
        if isinstance(ctx.axis, tuple):
            recv, recv_live = exchange_columns_hier(
                datas, live_mask(r), pids, ctx.axis[1], hier,
                intra_axis=ctx.axis[0], mesh=ctx.mesh)
        else:
            recv, recv_live = exchange_columns_hier(
                datas, live_mask(r), pids, ctx.axis, hier, mesh=ctx.mesh)
    else:
        plan = plan_exchange(cap, p, col_bytes)
        count(f"rel.route.shuffle.{plan.route}")
        if not plan.fits_budget:
            # the round cap could not honour the budget: stage maximally,
            # run anyway, and count the overrun
            count("rel.route.shuffle.budget_unmet")
        count_route_bytes("exchange", exchange_wire_bytes(datas, cap, p),
                          rounds=plan.rounds)
        ctx.note_scratch(plan.peak_scratch_bytes)
        set_attrs(shuffle_route=plan.route, shuffle_rounds=plan.rounds,
                  shuffle_peak_scratch=plan.peak_scratch_bytes)
        recv, recv_live, _overflow = exchange_columns(
            datas, live_mask(r), pids, ctx.axis, cap, plan=plan,
            mesh=ctx.mesh)
    size = p * cap
    cols = [col_like(c, d, size) for c, d in zip(r.table.columns, recv)]
    out = Rel(Table(cols), r.names, mask=recv_live, dicts=r.dicts)
    out.part = "sharded"
    # a redistributed chunk is still a chunk: merges downstream must fire
    out.morsel = r.morsel
    return out


def hash_pids(r: Rel, key_col: Column) -> torch.Tensor:
    """Spark-compatible hash destinations of a key column (K4/K5 on the
    card); dead rows get one too, and the exchange drops them."""
    return hash_partition_ids(
        Table([Column(key_col.dtype, key_col.size, key_col.data)]),
        _rel._DIST_CTX.nshards)


# ---------------------------------------------------------------------------
# The partitioned runner
# ---------------------------------------------------------------------------

def _sort_meta(out: Rel) -> tuple:
    if out.pending_sort is None:
        return ((), ())
    by, desc = out.pending_sort
    return (tuple(out.names.index(n) for n in by), tuple(desc))


def _shard_column(c: Column, start: int, cap: int) -> torch.Tensor:
    """Rows [start, start + cap) of a column, zero rows past its end."""
    n = int(c.size)
    end = min(start + cap, n)
    part = c.data[min(start, n):end]
    if end - start < cap:
        pad = torch.zeros((cap - max(end - start, 0),)
                          + tuple(c.data.shape[1:]),
                          dtype=c.data.dtype, device=c.data.device)
        part = torch.cat([part, pad])
    return part


def _place_inputs(rels, mesh, axis, p: int, index: int, parts: dict,
                  order: "list[str]") -> "dict[str, Rel]":
    """This rank's rels: a sharded table's ``shard_capacity`` rows under
    a mask of the rows that exist, a replicated table whole. The shard
    tensors are memoized on the global rel, so warm runs slice nothing;
    the columns keep their verified stats."""
    out = {}
    for name in order:
        r = rels[name]
        if parts[name] == "replicated":
            rebuilt = Rel(r.table, r.names, dicts=r.dicts)
            rebuilt.part = "replicated"
            out[name] = rebuilt
            continue
        memo = r.__dict__.setdefault("_dist_placed", {})
        key = (mesh_axes_key(mesh), axis, p, index)
        if key not in memo:
            cap = shard_capacity(r.num_rows, p)
            start = index * cap
            with span("rel.dist_place", table=name, rows=cap):
                datas = [_shard_column(c, start, cap)
                         for c in r.table.columns]
                dev = r.device
                mask = (start + torch.arange(cap, dtype=torch.int64,
                                             device=dev)) < r.num_rows
            memo[key] = (cap, datas, mask)
        cap, datas, mask = memo[key]
        cols = [col_like(c, d, cap) for c, d in zip(r.table.columns, datas)]
        rebuilt = Rel(Table(cols), r.names, mask=mask, dicts=r.dicts)
        rebuilt.part = "sharded"
        out[name] = rebuilt
    return out


def _resolve_axis(mesh, axis) -> "tuple[object, tuple[str, ...]]":
    if axis is None:
        # the data axes resolve through the logical->physical rule table
        axes = data_axes(mesh)
        if len(axes) > 1 and intra_exchange_route() == "flat":
            axes = axes[-1:]
    else:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
    # size-1 axes carry no data parallelism: drop them so no exchange
    # factors a degenerate stage
    axes = tuple(a for a in axes if mesh.shape[a] > 1) or axes[-1:]
    return (axes[0] if len(axes) == 1 else axes), axes


def _fallback(plan, rels, dev, pname: str, info: dict) -> Rel:
    count("rel.dist_fallbacks")
    count(f"rel.dist_fallbacks.{pname}")
    return _rel._run_fused_impl(plan, rels, dev, info)


def agreed_scratch_probe(mesh, axis, dev):
    """The exchange scratch budget's probe agreed by every rank of
    ``mesh`` (the minimum of the ranks' probes, one all-reduce a mesh
    and data axis, memoized): called by every rank at the entry of a
    partitioned run, before any branch a rank could skip. None when the
    override or ``SRT_SHUFFLE_SCRATCH_BYTES`` decides the budget (no
    collective then: both read alike on every rank) or no rank's device
    reports memory."""
    if comm_plan.budget_configured():
        return None
    axis, _ = _resolve_axis(mesh, axis)

    def agree(local: int) -> int:
        t = torch.tensor([local], dtype=torch.int64, device=dev)
        return int(all_reduce(t, axis, mesh, "min")[0])

    return _obs_memory.agreed_scratch_budget(
        (mesh_axes_key(mesh), str(axis)), agree, dev)


def run_partitioned(plan, rels: "dict[str, Rel]", mesh, axis=None,
                    device=None, info: "dict | None" = None) -> Rel:
    """Entry point behind ``run_fused(plan, rels, mesh=...)``, called by
    every rank of ``mesh`` with the same global ``rels``. Falls back to
    the single-device fused run (counted ``rel.dist_fallbacks``) when an
    input cannot be sharded or the plan leaves the fused route, never an
    error; every rank falls back together.

    ``axis`` may be one mesh axis or an outer-first tuple; None resolves
    through the logical rule table (``parallel.data_axes``): a 3-D mesh
    shards data over ``(intra, part)`` unless ``SRT_SHUFFLE_INTRA=flat``
    keeps it on ``part``. ``info``, when given, receives ``fused``.

    Every exchange of the run plans its rounds under one scratch budget:
    with ``SRT_SHUFFLE_SCRATCH_BYTES`` unset, the memory probe agreed by
    every rank at entry (``agreed_scratch_probe``)."""
    if info is None:
        info = {}
    dev = mesh.device if device is None else resolve_device(device)
    probe = agreed_scratch_probe(mesh, axis, dev)
    # the planner's flags are process-global: one plan run at a time
    with _rel._PLAN_LOCK, comm_plan.agreed_probe_scope(probe):
        return _run_partitioned(plan, rels, mesh, axis, dev, info)


def _run_partitioned(plan, rels, mesh, axis, dev, info: dict) -> Rel:
    _rel._check_device(rels, dev)
    axis, axes = _resolve_axis(mesh, axis)
    sizes = tuple(mesh.shape[a] for a in axes)
    p = int(np.prod(sizes))
    order = sorted(rels)
    pname = getattr(plan, "__name__", "plan").lstrip("_")
    for name in order:
        r = rels[name]
        if (not _rel._fusable_rel(r) or r.mask is not None
                or any(c.validity is not None for c in r.table.columns)):
            return _fallback(plan, rels, dev, pname, info)
        for c in r.table.columns:
            # verify the advisory stats on the GLOBAL column once (memoized;
            # every rank holds the same data, so every rank agrees)
            _rel._trusted_range(c)

    threshold = broadcast_threshold()
    parts = {name: ("replicated" if table_nbytes(rels[name]) <= threshold
                    else "sharded") for name in order}
    count("rel.route.dist.shard_table",
          sum(1 for v in parts.values() if v == "sharded"))
    count("rel.route.dist.broadcast_table",
          sum(1 for v in parts.values() if v == "replicated"))

    ctx = DistTrace(axis, p, sizes, mesh)
    idx = ctx.index
    rebuilt = _place_inputs(rels, mesh, axis, p, idx, parts, order)
    _rel._FUSED_TRACING = True
    _rel._DIST_CTX = ctx
    _rel._TRACE_AUX = aux = []
    try:
        with span("rel.dist_program", query=pname, shards=p):
            out = plan(rebuilt)
            sort_keys, descending = _sort_meta(out)
            limit = out.limit
            out, mask = terminal_mask(out, idx)
    except FusedFallback:
        out = None
    finally:
        _rel._FUSED_TRACING = False
        _rel._DIST_CTX = None
        _rel._TRACE_AUX = None
    if out is None:
        return _fallback(plan, rels, dev, pname, info)
    info["fused"] = True
    count("shuffle.peak_scratch_bytes", ctx.scratch_peak)
    count_dispatch("rel.dist_program")
    return finish_partitioned(out, mask, aux, (sort_keys, descending, limit),
                              ctx, dev)


def terminal_mask(out: Rel, idx: int) -> "tuple[Rel, torch.Tensor]":
    """A plan's terminal rel and this rank's live mask over it: sharded
    rows keep their own mask (a terminal sort + LIMIT k first cuts each
    shard to its top k: the global top k is among the k * P survivors);
    a replicated (or fresh) result keeps only shard 0's rows live."""
    if out.part == "sharded":
        if out.pending_sort is not None and out.limit is not None:
            count("rel.route.sort.topk")
            out = out._flush_sort()
        return out, live_mask(out)
    mask = live_mask(out)
    if idx != 0:
        mask = torch.zeros_like(mask)
    return out, mask


def finish_partitioned(out: Rel, mask: torch.Tensor, aux: list,
                       order: tuple, ctx: DistTrace, dev,
                       sync_site: str = "rel.mask_count") -> Rel:
    """The partitioned run's tail, shared with the morsel runner's merge
    run over a mesh: every shard's live count and runtime counters in
    one all_gather, read once on the host (counted under ``sync_site``);
    then every shard's live rows padded to the largest count, gathered,
    and put through the terminal sort (``order`` = sort keys, descending
    flags, limit) and the limit."""
    sort_keys, descending, limit = order
    axis, mesh, idx, p = ctx.axis, ctx.mesh, ctx.index, ctx.nshards
    # THE per-rank host sync: every shard's live count and runtime
    # counters, gathered into a (p, 1 + n_aux) block and read once
    local = torch.stack([mask.sum(dtype=torch.int64)]
                        + [v.to(dev).reshape(()) for _, v in aux])
    block = all_gather_rows(local.reshape(1, -1), axis, mesh)
    count_host_sync(sync_site)
    nv = block.tolist()
    n_each = [int(row[0]) for row in nv]
    for j, (aname, _) in enumerate(aux):
        count(aname, sum(int(row[1 + j]) for row in nv))
    n, m = sum(n_each), max(n_each)

    # every shard's live rows, padded to the largest shard's count
    sel = _rel._live_indices(mask, n_each[idx])
    cols = out.table.columns

    def padded(x: torch.Tensor) -> torch.Tensor:
        x = x[sel]
        if m > x.shape[0]:
            x = torch.cat([x, x.new_zeros((m - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        return all_gather_rows(x, axis, mesh)

    datas = [padded(c.data) for c in cols]
    valids = [None if c.validity is None else padded(c.valid_bool())
              for c in cols]
    gmask = (torch.arange(m, dtype=torch.int64, device=dev)[None, :]
             < block[:, :1]).reshape(-1)
    dtypes = tuple(c.dtype for c in cols)
    with span("rel.materialize", live_rows=n, shards=p):
        out_d, out_v = _rel._materialize_program(
            datas, valids, gmask, n, dtypes, sort_keys, descending, limit)
    count_dispatch("rel.materialize")
    if limit is not None:
        n = min(limit, n)
    return Rel(Table([Column(dt, n, d, v)
                      for dt, d, v in zip(dtypes, out_d, out_v)]),
               out.names, dicts=out.dicts)
