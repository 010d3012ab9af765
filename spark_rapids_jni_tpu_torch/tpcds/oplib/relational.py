"""Relational operators: the join and groupby lowerings of the fused
planner, on one device.

Port of ``spark_rapids_jni_tpu/tpcds/oplib/relational.py``. Routes are
decided on the host from VERIFIED ingest stats: the dense broadcast join
(probed by the direct-address gather or by K1), presence-bitmap
membership for semi/anti joins, and dense fixed-width groupbys
(accumulated by ``index_add_`` or by K2). When no dense route applies, a
fused plan raises ``FusedFallback`` and the runner re-runs it on the
general sort-merge kernels (``rel.route.join.general.<how>``,
``rel.route.groupby.general``).

Keys may be NULL, with Spark's semantics on every route: a NULL key
matches nothing in an inner, semi or left join (a left join keeps the
row, its right side NULL; an anti join keeps it), and a groupby gathers
every NULL key into one group, whose slot on the dense route lies before
the key's values. A dense route that took a nullable key counts
``rel.route.join.dense_nullable.<how>`` or
``rel.route.groupby.dense_nullable``; the key's validity folds into the
live masks, so no host sync is added. A sum or mean with no valid value
in its group is NULL.

In a partitioned run (``tpcds/dist.py``) a sharded build side takes the
collective routes: presence-psum membership, the reduce-scatter join and
the shuffle-hash join, else an all_gather; dense groupbys over sharded
rows merge their per-shard partials in two phases (all-reduce or
reduce-scatter). Every route is chosen from facts every rank shares, so
all ranks run the same collectives.

In a morsel run (``exec/runner.py``) a streamed chunk plays the same
two-phase game over time: a dense groupby's per-chunk partial folds into
the cross-morsel accumulator (``rel.route.groupby.two_phase.morsel``;
under a mesh the ranks' partials all-reduce first), and a semi/anti join
whose build side streams ORs per-chunk presence bitmaps
(``rel.route.join.presence_morsel.{semi,anti}``). Any other join with a
streamed build side raises ``FusedFallback``.
"""

from __future__ import annotations

import torch

from ...columnar import Column, Table, bitmask
from ...obs import count, count_dispatch, count_host_sync, set_attrs
from ...ops import gather, groupby_aggregate, inner_join
from ...ops.fused_pipeline import (
    MAX_DENSE_WIDTH, build_dense_map, dense_groupby_extreme,
    dense_groupby_method, dense_groupby_sum_count, dense_lookup,
    dense_merge_replicated, dense_merge_scattered)
from ...ops.groupby import result_dtype
from ...ops.join import (join_probe_method, left_anti_join, left_join,
                         left_semi_join)
from ...ops.sort import gather_column
from ...types import TypeId
from ...utils.errors import CudfLikeError, expects
from .. import rel as _rel
from .registry import operator


# --------------------------------------------------------------------------
# Pandas oracles (the per-family reference semantics)
# --------------------------------------------------------------------------

def join_oracle(left_df, right_df, left_on, right_on, how="inner"):
    """Reference join semantics over pandas frames."""
    if how in ("semi", "anti"):
        hit = left_df[left_on[0]].isin(right_df[right_on[0]])
        return left_df[hit if how == "semi" else ~hit]
    return left_df.merge(right_df, left_on=list(left_on),
                         right_on=list(right_on), how=how)


def groupby_oracle(df, keys, aggs):
    """Reference groupby, sorted ascending by key."""
    g = df.groupby(list(keys), as_index=False).agg(
        **{out: (c, a) for c, a, out in aggs})
    return g.sort_values(list(keys), kind="stable").reset_index(drop=True)


# --------------------------------------------------------------------------
# Shared join building blocks
# --------------------------------------------------------------------------

def key_valid(col: Column):
    """A key column's valid rows as a bool vector, or None when it has no
    NULL."""
    return None if col.validity is None else col.valid_bool()


def _and(a, b):
    """``a & b`` where either may be None (all True)."""
    return b if a is None else a if b is None else a & b


def null_unmatched(rt: Table, matched: torch.Tensor) -> "list[Column]":
    """Left-join null marking: right-side columns keep their gathered
    data but report null where the row had no match (one packed mask,
    ANDed with any existing validity)."""
    vwords = bitmask.pack(matched)
    cols = []
    for c in rt.columns:
        valid = vwords if c.validity is None else bitmask.pack(
            matched & c.valid_bool())
        cols.append(Column(c.dtype, c.size, c.data, valid))
    return cols


def presence_membership(left, right, lk: Column, rk: Column, how: str,
                        merge=None):
    """Semi/anti MEMBERSHIP via a dense presence bitmap over the LEFT
    key's trusted range: scatter the right keys into a (width,) vector,
    probe the left keys. The right side may hold duplicates; a NULL key
    on either side is never present. ``merge`` combines the shards'
    presence vectors before the probe (the presence-psum route); None
    keeps it shard-local. Returns None when inapplicable."""
    if rk.data is None or not rk.dtype.is_integral:
        return None
    rng = _rel._trusted_range(lk)
    if rng is None:
        return None
    lo, hi = rng
    width = int(hi) - int(lo) + 1
    if width > MAX_DENSE_WIDTH:
        return None
    dev = rk.data.device
    k = rk.data.to(torch.int64) - lo
    rlive = _and(_and((k >= 0) & (k < width), right.mask), key_valid(rk))
    slot = torch.where(rlive, k, width)
    # index_fill_ takes the value as a kernel argument; ``present[slot] =
    # True`` would copy a host scalar to the device, a synchronising copy
    present = torch.zeros(width + 1, dtype=torch.bool, device=dev)
    present.index_fill_(0, slot, True)
    present = present[:width]
    if merge is not None:
        present = merge(present)
    kl = lk.data.to(torch.int64) - lo
    linb = (kl >= 0) & (kl < width)
    found = _and(linb & present[torch.clamp(kl, 0, width - 1)],
                 key_valid(lk))
    if lk.validity is not None or rk.validity is not None:
        count(f"rel.route.join.dense_nullable.{how}")
    return left.filter(found if how == "semi" else ~found)


def dense_key_range(key: Column):
    """(lo, hi) of a build key that the dense path may take: integral,
    its valid values not proven duplicate, with a trusted range no wider
    than MAX_DENSE_WIDTH; else None. Uniqueness may still need proving.
    A NULL build key never matches: its rows stay out of the map."""
    if key.data is None or not key.dtype.is_integral:
        return None
    if key.unique is False and not _rel._trusted_unique(key):
        return None  # ingest already proved duplicates
    rng = _rel._trusted_range(key)
    if rng is None or (rng[1] - rng[0] + 1) > MAX_DENSE_WIDTH:
        return None
    return rng


def dense_build_map(rel, key: Column):
    """Broadcast-map build over a rel's (possibly masked) rows, NULL keys
    left out; None when the dense path cannot be proven applicable.
    Under the planner flag it builds without device checks from trusted
    stats or gives up the route, never syncing."""
    if dense_key_range(key) is None:
        return None
    live = _and(rel.mask, key_valid(key))
    plain = key if key.validity is None else Column(
        key.dtype, key.size, key.data, value_range=key.value_range)
    if _rel._trusted_unique(key):
        return build_dense_map(plain, live, check_range=False,
                               check_unique=False)
    if _rel._FUSED_TRACING:
        return None  # uniqueness unprovable without a device check
    try:
        dmap = build_dense_map(plain, live, check_range=False,
                               check_unique=True)  # host sync
        count_dispatch("rel.build_map_unique_check")
        count_host_sync("rel.build_map_unique_check")
    except CudfLikeError:
        return None  # duplicate build keys: the general join expands
    if rel.mask is None:
        key._stats_flags = (True, True)  # memo: proven on full column
    return dmap


def gather_build_side(rel, idx: torch.Tensor) -> "list[Column]":
    """Gather build-side columns through a dense-lookup index, keeping
    verified value_range bounds (a gather selects a subset)."""
    cols = []
    for c in rel.table.columns:
        g = gather_column(c, idx)
        if (g.value_range is not None
                and getattr(c, "_stats_flags", (False,))[0]):
            g._stats_flags = (True, False)
        cols.append(g)
    return cols


def dense_join(left, right, left_on, right_on, how: str):
    """Broadcast (dense-dictionary) fast path: mask algebra only, no
    compaction, no host sync. A NULL probe key finds nothing; a NULL
    build key is never in the map. Returns None when inapplicable."""
    Rel = _rel.Rel
    if len(left_on) != 1 or len(right_on) != 1:
        return None
    lk = left.col(left_on[0])
    rk = right.col(right_on[0])
    if lk.data is None or not lk.dtype.is_integral:
        return None
    # a key proven unique from trusted stats needs no map yet: K1 builds
    # its own table, so only the gather route below builds one
    rng = dense_key_range(rk) if _rel._trusted_unique(rk) else None
    dmap = None if rng is not None else dense_build_map(right, rk)
    if rng is None and dmap is None:
        if how in ("semi", "anti"):
            out = presence_membership(left, right, lk, rk, how)
            if out is not None:
                count(f"rel.route.join.presence_bitmap.{how}")
                set_attrs(route="presence_bitmap")
                return out
        return None
    lo, hi = rng if rng is not None else (dmap.lo, dmap.lo + dmap.width - 1)
    count(f"rel.route.join.dense.{how}")
    if lk.validity is not None or rk.validity is not None:
        count(f"rel.route.join.dense_nullable.{how}")
    pvalid = key_valid(lk)
    # probe route (ops/join.join_probe_method): the direct-address
    # gather or K1 -- same (idx, found) contract, equal outputs
    method = join_probe_method(rk.size, lk.size, backend=lk.device.type)
    count(f"rel.route.join.probe.{method}")
    set_attrs(probe=method)
    if method == "cuda":
        from ...ops.cuda_kernels import hash_join_probe
        k64 = rk.data.to(torch.int64)
        blive = _and(_and((k64 >= lo) & (k64 <= hi), right.mask),
                     key_valid(rk))
        idx, found = hash_join_probe(rk.data, lk.data, build_live=blive,
                                     probe_live=pvalid)
    else:
        if dmap is None:
            dmap = dense_build_map(right, rk)
        idx, found = dense_lookup(dmap, lk.data, pvalid)
    if how == "semi":
        return left.filter(found)
    if how == "anti":
        return left.filter(~found)
    dicts = {**left.dicts, **right.dicts}
    if how == "left":
        # unmatched rows carry idx 0 (gather-safe); null_unmatched marks
        # them null from the found mask
        rcols = null_unmatched(Table(gather_build_side(right, idx)), found)
        return _rel._inherit_part(
            Rel(Table(list(left.table.columns) + rcols),
                left.names + right.names, mask=left.mask, dicts=dicts),
            left, right)
    live = found if left.mask is None else (found & left.mask)
    return _rel._inherit_part(
        Rel(Table(list(left.table.columns) + gather_build_side(right, idx)),
            left.names + right.names, mask=live, dicts=dicts), left, right)


# --------------------------------------------------------------------------
# Distributed join routes (the collective half; the transport lives in
# tpcds/dist.py and parallel/)
# --------------------------------------------------------------------------

def _presence_psum(left, right, lname: str, rname: str, how: str):
    """Semi/anti membership against a SHARDED build side: each shard
    scatters its local build keys into the presence vector, one
    all-reduce (int32: NCCL has no bool) ORs them, and the probe filters
    locally. Width bytes on the wire instead of a row shuffle."""
    from .. import dist
    ctx = _rel._DIST_CTX

    def psum_or(present):
        nbytes = ctx.nshards * int(present.shape[0]) * 4
        dist.count_route_bytes("psum", nbytes)
        ctx.note_scratch(2 * int(present.shape[0]) * 4)
        return ctx.all_reduce(present.to(torch.int32)) > 0

    out = presence_membership(left, right, left.col(lname),
                              right.col(rname), how, merge=psum_or)
    if out is not None:
        count(f"rel.route.join.presence_psum.{how}")
    return out


def _dense_key_geometry(left, right, left_on, right_on):
    """Applicability gate of the key-routed sharded-build joins
    (shuffle-hash, reduce-scatter): both keys plain integral columns, the
    build key's range verified dense and proven unique. Returns ``(lk,
    rk, lo, width)`` or None."""
    lk = left.col(left_on[0])
    rk = right.col(right_on[0])
    for c in (lk, rk):
        if (c.validity is not None or c.data is None
                or not c.dtype.is_integral or c.children):
            return None
    rng = _rel._trusted_range(rk)
    if rng is None or (int(rng[1]) - int(rng[0]) + 1) > MAX_DENSE_WIDTH:
        return None
    if not _rel._trusted_unique(rk):
        return None  # the shard-local join needs a unique build map
    return lk, rk, int(rng[0]), int(rng[1]) - int(rng[0]) + 1


def _shuffle_hash_join(left, right, left_on, right_on, how: str, geom):
    """Both sides sharded: co-partition them by key hash (K4/K5) with one
    (possibly staged) all_to_all exchange each, then join shard-locally
    on the dense path (K1 on the card)."""
    from .. import dist
    lk, rk, _lo, _width = geom
    lrel = dist.exchange_rel(left, dist.hash_pids(left, lk))
    rrel = dist.exchange_rel(right, dist.hash_pids(right, rk))
    out = dense_join(lrel, rrel, left_on, right_on, how)
    if out is None:  # pre-checked applicability: should be unreachable
        raise _rel.FusedFallback(
            f"shuffle-hash {how} join on {left_on} lost its dense route")
    count(f"rel.route.join.shuffle_hash.{how}")
    out.part = "sharded"
    return out


def _scatter_dense(values: torch.Tensor, slot: torch.Tensor,
                   padded: int) -> torch.Tensor:
    """A (padded,) vector holding ``values`` at ``slot``; slot ``padded``
    is the sentinel of rows that do not count."""
    out = torch.zeros(padded + 1, dtype=values.dtype, device=values.device)
    out[slot] = values
    return out[:padded]


def _reduce_scatter_join(left, right, left_on, right_on, how: str, geom):
    """Sharded build side with a trusted dense unique key: scatter each
    shard's build rows into (width,) dense partials and reduce-scatter
    each column onto the slot owners, then join locally against the owned
    slice. The key is globally unique, so every slot has at most one
    contributor and the sum reproduces the row values exactly (floats
    too, but for ``-0.0 + 0.0 == +0.0``). A sharded probe is exchanged to
    the owners; a replicated probe is masked down to the keys this shard
    owns, moving nothing. Inner/left only; build columns must be plain
    numeric data. Returns None when inapplicable."""
    from ...parallel import reduce_scatter_sum
    from .. import dist
    Rel = _rel.Rel
    if how not in ("inner", "left"):
        return None
    if left.part not in ("sharded", "replicated"):
        return None  # ambiguous probe partitioning: keep the other routes
    lk, rk, lo, width = geom
    if any(c.validity is not None or c.children or c.data is None
           or c.data.dim() != 1 or c.data.dtype == torch.bool
           or c.data.dtype.is_complex for c in right.table.columns):
        return None  # the sum-merge needs plain numeric payloads
    ctx = _rel._DIST_CTX
    p = ctx.nshards
    w_local = -(-width // p)
    padded = w_local * p
    dev = rk.data.device

    # 1. scatter the local build rows into (padded,) dense partials and
    # reduce-scatter each column onto its slot owners
    blive = dist.live_mask(right)
    kb = rk.data.to(torch.int64) - lo
    slot = torch.where(blive & (kb >= 0) & (kb < padded), kb, padded)
    ones = _scatter_dense(torch.ones(slot.shape, dtype=torch.int32,
                                     device=dev), slot, padded)
    presence = reduce_scatter_sum(ones, ctx.axis, ctx.mesh) > 0
    nbytes = 0
    owned_cols = []
    base = lo + ctx.index * w_local
    for name, c in zip(right.names, right.table.columns):
        if name == right_on[0]:
            # slot i of the owned slice holds key base + i by construction
            data = (base + torch.arange(w_local, dtype=torch.int64,
                                        device=dev)).to(c.data.dtype)
        else:
            data = reduce_scatter_sum(_scatter_dense(c.data, slot, padded),
                                      ctx.axis, ctx.mesh)
            nbytes += padded * c.data.element_size()
        owned_cols.append(dist.col_like(c, data, w_local))
    dist.count_route_bytes("reduce_scatter", p * (nbytes + padded * 4))
    # scratch model: one (padded,) partial and its scatter working copy
    max_item = max([c.data.element_size() for c in right.table.columns]
                   + [4])
    ctx.note_scratch(2 * padded * max_item)

    # 2. route the probe to the owners (or mask a replicated probe)
    own = torch.clamp(torch.div(lk.data.to(torch.int64) - lo, w_local,
                                rounding_mode="floor"), 0, p - 1)
    if left.part == "sharded":
        probe = dist.exchange_rel(left, own.to(torch.int32))
    else:
        probe = left.filter(own == ctx.index)
        probe.part = "sharded"
    pk = probe.col(left_on[0])

    # 3. shard-local dense probe against the owned slice
    localk = pk.data.to(torch.int64) - base
    inb = (localk >= 0) & (localk < w_local)
    bidx = torch.clamp(localk, 0, w_local - 1)
    found = inb & presence[bidx]
    build = Rel(Table(owned_cols), list(right.names), mask=presence,
                dicts=right.dicts)
    gathered = gather_build_side(build, bidx)
    dicts = {**probe.dicts, **right.dicts}
    if how == "left":
        rcols = null_unmatched(Table(gathered), found)
        out = Rel(Table(list(probe.table.columns) + rcols),
                  probe.names + list(right.names), mask=probe.mask,
                  dicts=dicts)
    else:
        out = Rel(Table(list(probe.table.columns) + gathered),
                  probe.names + list(right.names),
                  mask=dist.live_mask(probe) & found, dicts=dicts)
    count(f"rel.route.join.reduce_scatter.{how}")
    out.part = "sharded"
    out.morsel = probe.morsel
    return out


def _build_payload_bytes(right) -> int:
    """Per-row byte width of the build side's columns (+1 validity)."""
    return sum(c.data.element_size() for c in right.table.columns) + 1


def route_sharded_build_join(left, right, left_on, right_on, how: str):
    """Collective join routes for a SHARDED build side: ``(result,
    route_name)`` or None (the caller then all_gathers the build side).

    Route order: presence-psum for semi/anti; then, for a dense unique
    build key, ``SRT_SHUFFLE_JOIN_ROUTE`` picks between the reduce-scatter
    join and the shuffle-hash exchange: ``auto`` compares their modeled
    per-device build memory, the explicit settings force one side (and
    fall through when it does not apply)."""
    from ...parallel import shuffle_join_route
    from .. import dist
    if len(left_on) != 1 or len(right_on) != 1:
        return None
    if how in ("semi", "anti"):
        out = _presence_psum(left, right, left_on[0], right_on[0], how)
        if out is not None:
            return out, "presence_psum"
    geom = _dense_key_geometry(left, right, left_on, right_on)
    if geom is None:
        return None
    pref = shuffle_join_route()
    p = _rel._DIST_CTX.nshards
    width = geom[3]
    if pref != "exchange":
        # the reduce-scatter route holds one (width,) partial at a time;
        # the exchange a (p * n_local)-lane receive buffer for every
        # column, the all_gather the whole replicated table
        max_item = max(c.data.element_size() for c in right.table.columns)
        rs_mem = (-(-width // p) * p) * max_item
        if left.part != "sharded":
            alt_mem = p * (dist.table_nbytes(right) + right.num_rows)
        else:
            alt_mem = p * right.num_rows * _build_payload_bytes(right)
        if pref == "reduce_scatter" or rs_mem <= alt_mem:
            out = _reduce_scatter_join(left, right, left_on, right_on,
                                       how, geom)
            if out is not None:
                return out, "reduce_scatter"
    if left.part == "sharded" and pref != "reduce_scatter":
        out = _shuffle_hash_join(left, right, left_on, right_on, how, geom)
        if out is not None:
            return out, "shuffle_hash"
    return None


@operator("join", mask_class="rowwise", partition="collective",
          oracle=join_oracle,
          params=("SRT_SHUFFLE_JOIN_ROUTE", "SRT_JOIN_METHOD",
                  "SRT_BROADCAST_THRESHOLD"))
def join(left, right, left_on, right_on, how: str = "inner"):
    """Equi-join route ladder: the collective routes for a sharded build
    side of a partitioned run, then the dense broadcast fast path, then
    (eagerly only) the general sort-merge kernels."""
    Rel = _rel.Rel
    build = right
    if _rel._MORSEL_CTX is not None and right.morsel:
        # a streamed build side exists one chunk at a time, so its only
        # cross-morsel route is membership: per-chunk presence bitmaps
        # OR-merged through the accumulator (under a mesh the ranks'
        # bitmaps all-reduce first). Anything else runs in-core.
        mctx, dctx = _rel._MORSEL_CTX, _rel._DIST_CTX
        if (how in ("semi", "anti") and len(left_on) == 1
                and len(right_on) == 1 and not left.morsel):

            def morsel_or(present):
                if dctx is not None and right.part == "sharded":
                    from .. import dist
                    nbytes = dctx.nshards * int(present.shape[0]) * 4
                    dist.count_route_bytes("psum", nbytes)
                    dctx.note_scratch(2 * int(present.shape[0]) * 4)
                    present = dctx.all_reduce(present.to(torch.int32)) > 0
                return mctx.merge(present, "or")

            out = presence_membership(left, right, left.col(left_on[0]),
                                      right.col(right_on[0]), how,
                                      merge=morsel_or)
            if out is not None:
                count(f"rel.route.join.presence_morsel.{how}")
                set_attrs(route="presence_morsel")
                return out
        raise _rel.FusedFallback(
            f"{how} join with a streamed build side on {right_on} has no "
            "cross-morsel form")
    if _rel._DIST_CTX is not None and right.part == "sharded":
        from .. import dist
        routed = route_sharded_build_join(left, right, left_on, right_on,
                                          how)
        if routed is not None:
            out, route = routed
            set_attrs(route=route, out_rows=out.num_rows)
            return out
        build = dist.all_gather_rel(right)
    dense = dense_join(left, build, left_on, right_on, how)
    if dense is not None:
        if _rel._DIST_CTX is not None and left.part == "sharded":
            # data-parallel probe of a replicated build table: Spark's
            # BroadcastHashJoin, no shuffle
            count(f"rel.route.join.broadcast.{how}")
        set_attrs(route="dense", out_rows=dense.num_rows)
        return dense
    if _rel._FUSED_TRACING:
        set_attrs(route="fused_fallback")
        raise _rel.FusedFallback(
            f"{how} join on {left_on} needs the general kernel")
    lc = left.compact()
    rc = right.compact()
    count(f"rel.route.join.general.{how}")
    count_dispatch(f"rel.general_join.{how}")
    count_host_sync(f"rel.general_join.{how}")
    set_attrs(route="general")
    lk = lc.select(*left_on).table
    rk = rc.select(*right_on).table
    if how == "semi":
        idx = left_semi_join(lk, rk)
        return Rel(gather(lc.table, idx), lc.names, dicts=lc.dicts)
    if how == "anti":
        idx = left_anti_join(lk, rk)
        return Rel(gather(lc.table, idx), lc.names, dicts=lc.dicts)
    dicts = {**lc.dicts, **rc.dicts}
    if how == "left":
        li, ri = left_join(lk, rk)
        lt = gather(lc.table, li)
        rt = gather(rc.table, torch.clamp(ri, min=0))
        return Rel(Table(list(lt.columns) + null_unmatched(rt, ri >= 0)),
                   lc.names + rc.names, dicts=dicts)
    li, ri = inner_join(lk, rk)
    lt = gather(lc.table, li)
    rt = gather(rc.table, ri)
    set_attrs(out_rows=int(li.shape[0]))
    return Rel(Table(list(lt.columns) + list(rt.columns)),
               lc.names + rc.names, dicts=dicts)


# --------------------------------------------------------------------------
# Grouped aggregation
# --------------------------------------------------------------------------

def dense_slots(rel, keys):
    """Mixed-radix dense-slot encoding over a rel's key columns, LAST key
    least significant (ascending slot order == ascending key order). A
    nullable key's digit gives NULL a slot of its own, before its values
    (digit 0; a value ``v`` is digit ``v - lo + 1``). Returns ``(slots
    int32, width, key_cols, ranges, strides, nullable)`` or None when a
    key lacks a trusted range or the width exceeds the cap."""
    key_cols, ranges, nullable = [], [], []
    for k in keys:
        kc = rel.col(k)
        if kc.data is None or not kc.dtype.is_integral:
            return None
        rng = _rel._trusted_range(kc)
        if rng is None:
            return None
        key_cols.append(kc)
        ranges.append((int(rng[0]), int(rng[1])))
        nullable.append(kc.validity is not None)
    widths = [hi - lo + 1 + nl for (lo, hi), nl in zip(ranges, nullable)]
    width = 1
    for w in widths:
        width *= w
    if width > MAX_DENSE_WIDTH:
        return None
    strides = [1] * len(widths)
    for i in range(len(widths) - 2, -1, -1):
        strides[i] = strides[i + 1] * widths[i + 1]
    slot64 = torch.zeros(rel.num_rows, dtype=torch.int64,
                         device=key_cols[0].device)
    for kc, (lo, _), st, nl in zip(key_cols, ranges, strides, nullable):
        digit = kc.data.to(torch.int64) - lo
        if nl:
            digit = torch.where(kc.valid_bool(), digit + 1, 0)
        slot64 = slot64 + digit * st
    return (slot64.to(torch.int32), width, key_cols, ranges, strides,
            nullable)


def plain_value_column(vc) -> bool:
    """A value column the fixed-width accumulation kernels consume."""
    return vc.data is not None and vc.data.dim() == 1


def dense_groupby(rel, keys, aggs):
    """Dense fast path: integer keys with trusted small ranges aggregate
    into fixed (width,) slots; the present mask IS the result's row mask,
    and compaction yields the ascending-key order of the general path.
    Float and nullable min/max stay general. A nullable key groups its
    NULLs in a slot of their own (``dense_slots``); a sum or mean whose
    group holds no valid value is NULL.

    Over sharded rows of a partitioned run the aggregation has two
    phases: each shard aggregates its local rows into the same slot
    space (K2 on the card), then one collective a partial merges them:
    an all-reduce for slot spaces up to ``SRT_GROUPBY_PSUM_WIDTH``
    (replicated result), a reduce-scatter past it (each shard owns a
    contiguous slice of the slots).

    Over a streamed chunk of a morsel run the partials also fold into
    the cross-morsel accumulator, after the ranks' all-reduce under a
    mesh (the accumulator is replicated, so the scattered merge is not
    taken there); the result is a whole-stream value."""
    Rel = _rel.Rel
    if rel.num_rows == 0:
        return None
    enc = dense_slots(rel, keys)
    if enc is None:
        return None
    slots, width, key_cols, ranges, strides, nullable = enc
    for c, a, _ in aggs:
        vc = rel.col(c)
        if a not in ("sum", "count", "mean", "min", "max"):
            return None
        if not plain_value_column(vc):
            return None
        if vc.validity is not None and a not in ("sum", "count", "mean"):
            return None
        if a in ("min", "max") and vc.dtype.id in (TypeId.FLOAT32,
                                                   TypeId.FLOAT64):
            return None
    dev = slots.device
    mask = (torch.ones(rel.num_rows, dtype=torch.bool, device=dev)
            if rel.mask is None else rel.mask)
    method = dense_groupby_method(width, backend=dev.type)
    count(f"rel.route.groupby.dense.{method}")
    if any(nullable):
        count("rel.route.groupby.dense_nullable")
    set_attrs(route="dense", method=method, width=width)

    merge = None
    ctx = _rel._DIST_CTX
    morsel = _rel._MORSEL_CTX is not None and rel.morsel
    if ctx is not None and rel.part == "sharded":
        from .. import dist
        merge = ("replicated"
                 if morsel or width <= dist.psum_width_cap()
                 else "scattered")
        count(f"rel.route.groupby.two_phase.{merge}")
    if morsel:
        count("rel.route.groupby.two_phase.morsel")

    def merged(partial, op="sum"):
        out = partial
        if merge is not None:
            from .. import dist
            dist.count_merge_bytes(partial, merge)
            fn = (dense_merge_replicated if merge == "replicated"
                  else dense_merge_scattered)
            out = fn(partial, ctx.axis, op, mesh=ctx.mesh)
        if morsel:
            out = _rel._MORSEL_CTX.merge(out, op)
        return out

    # one accumulation pass per (column, accumulator): raw dtype for
    # sums, float64 for means; a nullable column's validity folds into
    # the pass's live mask
    cache = {}

    def pass_for(c, as_f64):
        key = (c, as_f64)
        if key not in cache:
            vc = rel.col(c)
            vals = vc.data
            live = mask if vc.validity is None else (mask & vc.valid_bool())
            if as_f64:
                vals = vals.to(torch.float64)
            s, n = dense_groupby_sum_count(slots, live, vals, width, method)
            cache[key] = (merged(s), merged(n))
        return cache[key]

    # the merged slot space: the full width, or this shard's contiguous
    # slice on the scattered route (global slot = offset + local index)
    if merge == "scattered":
        out_width = -(-width // ctx.nshards)
        offset = ctx.index * out_width
    else:
        out_width, offset = width, 0

    # group presence is a row-mask fact: reuse a non-null value pass when
    # one exists, else pay one row-count pass
    plain = next((c for c, a, _ in aggs
                  if rel.col(c).validity is None), None)
    if plain is not None:
        counts = pass_for(plain, next(a for c, a, _ in aggs
                                      if c == plain) == "mean")[1]
    else:
        _, counts = dense_groupby_sum_count(
            slots, mask, torch.zeros(rel.num_rows, dtype=torch.int64,
                                     device=dev), width, method)
        counts = merged(counts)
    present = counts > 0
    iota = offset + torch.arange(out_width, dtype=torch.int64, device=dev)
    out_cols = []
    for kc, (lo, hi), st, nl in zip(key_cols, ranges, strides, nullable):
        digit = (iota // st) % (hi - lo + 1 + nl)
        kvalid = None
        if nl:
            kvalid = bitmask.pack(digit > 0)
            digit = torch.clamp(digit - 1, min=0)
        decoded = (digit + lo).to(kc.dtype.to_torch())
        out_cols.append(_rel._trust(
            Column(kc.dtype, out_width, decoded, kvalid,
                   value_range=(lo, hi)),
            unique=(len(key_cols) == 1)))
    for c, a, _ in aggs:
        vc = rel.col(c)
        rdt = result_dtype(a, vc.dtype)
        valid = None
        if a == "count":
            data = pass_for(c, False)[1].to(torch.int64)
        elif a == "sum":
            data, n_valid = pass_for(c, False)
            if vc.validity is not None:
                valid = bitmask.pack(n_valid > 0)
        elif a == "mean":
            data, n_valid = pass_for(c, True)
            data = data / n_valid.to(torch.float64)
            if vc.dtype.is_decimal:
                data = data / 10.0 ** -vc.dtype.scale
            if vc.validity is not None:
                valid = bitmask.pack(n_valid > 0)
        else:  # integral min/max
            data = merged(dense_groupby_extreme(slots, mask, vc.data, width,
                                                a == "min"), op=a)
        out_cols.append(Column(rdt, out_width, data.to(rdt.to_torch()),
                               valid))
    out = Rel(Table(out_cols), list(keys) + [o for _, _, o in aggs],
              mask=present, dicts=rel._sub_dicts(keys))
    if morsel:
        # the merged result is a whole-stream value (out.morsel stays
        # False), replicated when the ranks merged, plain otherwise
        out.part = "replicated" if merge is not None else None
    elif merge is not None:
        out.part = "replicated" if merge == "replicated" else "sharded"
    else:
        out.part = rel.part
    return out


@operator("groupby", mask_class="segmented", partition="collective",
          oracle=groupby_oracle,
          params=("SRT_DENSE_GROUPBY", "SRT_GROUPBY_PSUM_WIDTH"))
def groupby(rel, keys, aggs):
    """Grouped aggregation ladder: the dense fixed-slot fast path, else
    (eagerly only) the general sorted-scan kernels."""
    Rel = _rel.Rel
    dense = dense_groupby(rel, keys, aggs)
    if dense is not None:
        return dense
    if _rel._FUSED_TRACING:
        set_attrs(route="fused_fallback")
        raise _rel.FusedFallback(
            f"groupby on {list(keys)} needs the general kernel")
    for c, _, _ in aggs:
        expects(plain_value_column(rel.col(c)),
                f"groupby aggregation over multi-lane column {c!r} "
                "(DECIMAL128) is not supported: cast or rescale to "
                "DECIMAL64 first")
    plain = rel.compact()
    count("rel.route.groupby.general")
    count_dispatch("rel.general_groupby")
    count_host_sync("rel.general_groupby")
    set_attrs(route="general")
    vals = Table([plain.col(c) for c, _, _ in aggs])
    out = groupby_aggregate(plain.select(*keys).table, vals,
                            [(i, a) for i, (_, a, _) in enumerate(aggs)])
    set_attrs(out_groups=out.num_rows)
    cols = list(out.columns)
    for i, (c, a, _) in enumerate(aggs):
        vdt = plain.col(c).dtype
        if a == "mean" and vdt.is_decimal:
            # a decimal's mean in its units, as the dense route gives it
            m = cols[len(keys) + i]
            cols[len(keys) + i] = Column(
                m.dtype, m.size, m.data / 10.0 ** -vdt.scale, m.validity)
    out = Table(cols)
    return Rel(out, list(keys) + [o for _, _, o in aggs],
               dicts=plain._sub_dicts(keys))
