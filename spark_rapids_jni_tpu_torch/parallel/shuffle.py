"""Columnar shuffle over the mesh: ``all_to_all`` on NCCL or gloo.

Port of ``spark_rapids_jni_tpu/parallel/shuffle.py``. Each rank holds its
own rows; an exchange is

1. a stable sort of the rows by destination shard, each row's slot in
   its lane = its position minus its destination's start,
2. a scatter into a ``(P, capacity)`` send buffer per column (rows that
   do not travel park in a sentinel slot ``capacity`` of a
   ``capacity + 1`` lane, which is sliced off: torch scatters raise on
   the out-of-range index JAX's ``mode="drop"`` discards),
3. one ``all_to_all_single`` per column and one for the validity lane,
4. receivers read the ``(P, capacity)`` grid under its validity lane.

Every rank must run the same collectives at the same shapes, so the
capacity and the round count of an exchange are the same on every rank:
the fused runner uses the lossless capacity (its rows per shard, equal
on every rank), and ``shuffle_table`` agrees its capacity and its retry
rounds with a collective before it uses them.

``shuffle_table`` turns a fixed-width table into Spark row images with
K6 (``ops/row_conversion.convert_to_rows``) and back with K3's table
form (``convert_from_rows``); a table with STRING columns goes through
the torch route of the row format. The destinations are Spark's hash
partitioning (K4/K5 under ``murmur3_table``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..columnar import Column, Table
from ..obs import count, set_attrs, traced
from ..types import TypeId
from ..utils.errors import expects
from .collectives import (all_gather_rows, all_reduce, all_to_all_blocks,
                          axis_size)
from .mesh import PART_AXIS, Mesh


@dataclass
class ShuffleResult:
    """This rank's view after one exchange round: ``(P * capacity,
    row_size)`` received rows under ``valid``; ``overflow`` counts the
    rows this rank could not fit as a sender, and ``resid`` marks exactly
    those input rows so the caller can send them again."""
    rows: torch.Tensor      # (P * capacity, row_size) uint8
    valid: torch.Tensor     # (P * capacity,) bool
    overflow: torch.Tensor  # (1,) int32: rows this sender kept back
    resid: torch.Tensor     # (n_local,) bool: input rows NOT sent


def _lanes(live: torch.Tensor, pids: torch.Tensor, p: int, capacity: int):
    """The stable destination sort of an exchange: (order, dest, slot,
    keep, sendable) over the sorted rows. Rows that are not live sort
    last, as bucket ``p``."""
    n_local = int(live.shape[0])
    dev = live.device
    pk = torch.where(live, pids.to(torch.int32),
                     torch.full_like(pids, p, dtype=torch.int32))
    order = torch.argsort(pk, stable=True)
    sorted_p = pk[order]
    starts = torch.searchsorted(
        sorted_p, torch.arange(p, dtype=torch.int32, device=dev))
    dest = torch.clamp(sorted_p, 0, p - 1).to(torch.int64)
    slot = torch.arange(n_local, dtype=torch.int64, device=dev) - starts[dest]
    sendable = sorted_p < p
    keep = sendable & (slot < capacity)
    return order, dest, slot, keep, sendable


def _send_buffer(src: torch.Tensor, dest: torch.Tensor, dslot: torch.Tensor,
                 p: int, cw: int) -> torch.Tensor:
    """A ``(p, cw, ...)`` send buffer of ``src``'s rows at (dest, dslot);
    ``dslot == cw`` is the sentinel slot (dropped)."""
    rest = tuple(src.shape[1:])
    buf = torch.zeros((p * (cw + 1),) + rest, dtype=src.dtype,
                      device=src.device)
    buf[dest * (cw + 1) + dslot] = src
    return buf.reshape((p, cw + 1) + rest)[:, :cw]


def exchange_columns(datas: "list[torch.Tensor]", live: torch.Tensor,
                     pids: torch.Tensor, axis, capacity: int, plan=None,
                     groups=None, group_size: Optional[int] = None, *,
                     mesh: Mesh):
    """all_to_all of per-row column tensors: the repartitioning
    collective of the partitioned runner's shuffle-hash joins and window
    exchange (``tpcds/dist.py``).

    ``datas`` are this rank's columns (``(n_local, ...)`` each), ``live``
    marks the rows that exist (others are neither sent nor counted) and
    ``pids`` each row's destination shard. ``plan`` (a
    ``comm_plan.CommPlan``) stages the lane slots into ``plan.rounds``
    chunked rounds whose output equals the single shot's.

    Returns ``(received_datas, received_live, overflow)``: each received
    tensor is ``(p * capacity, ...)`` (block ``i`` holds shard ``i``'s
    rows) and ``overflow`` counts the live rows this rank could not fit.
    ``capacity >= n_local`` is lossless by construction.

    ``groups``/``group_size`` scope the exchange to neighbourhoods of
    shards along ``axis`` (``pids`` then name group-local destinations);
    ``axis`` may be an outer-first tuple whose destinations name the
    row-major combined index only through ``exchange_columns_hier``."""
    n_local = int(live.shape[0])
    if groups is not None:
        group, _ = mesh.subgroup(axis, groups)
        p = int(group_size)
    else:
        group = None
        p = axis_size(mesh, axis)
        expects(isinstance(axis, str),
                "a flat exchange runs over one axis; tuple axes go "
                "through exchange_columns_hier")
    order, dest, slot, keep, sendable = _lanes(live, pids, p, capacity)
    overflow = (sendable & ~keep).sum(dtype=torch.int32)
    if capacity == 0:  # degenerate lane: nothing travels
        empty = [d.new_zeros((0,) + tuple(d.shape[1:])) for d in datas]
        return empty, live.new_zeros(0, dtype=torch.bool), overflow
    chunk = capacity if (plan is None or not plan.staged) else plan.chunk
    srcs = [d[order] for d in datas]
    live_chunks = []
    out_chunks: "list[list]" = [[] for _ in datas]
    for c0 in range(0, capacity, chunk):
        cw = min(chunk, capacity - c0)
        rslot = slot - c0
        in_round = keep & (rslot >= 0) & (rslot < cw)
        dslot = torch.where(in_round, rslot, cw)
        sv = _send_buffer(in_round, dest, dslot, p, cw)
        live_chunks.append(all_to_all_blocks(sv, axis, mesh, group))
        for i, s in enumerate(srcs):
            out_chunks[i].append(all_to_all_blocks(
                _send_buffer(s, dest, dslot, p, cw), axis, mesh, group))
    recv_live = torch.cat(live_chunks, dim=1).reshape(p * capacity)
    outs = [torch.cat(chunks, dim=1).reshape((p * capacity,)
                                             + tuple(d.shape[1:]))
            for chunks, d in zip(out_chunks, datas)]
    return outs, recv_live, overflow


def _itemsize(d) -> int:
    if torch.is_tensor(d):
        return d.element_size()
    return int(np.dtype(d.dtype).itemsize)


def exchange_wire_bytes(datas, capacity: int, n_shards: int) -> int:
    """Wire footprint of one ``exchange_columns`` across the mesh: the
    send buffers travel whole, so it follows from the shapes."""
    per_shard = n_shards * capacity  # rows physically on the wire
    payload = sum(_itemsize(d) * int(np.prod(tuple(d.shape[1:]),
                                             dtype=np.int64))
                  for d in datas)
    return n_shards * per_shard * (payload + 1)  # +1: the validity lane


def exchange_columns_hier(datas: "list[torch.Tensor]", live: torch.Tensor,
                          pids: torch.Tensor, axis, plan,
                          intra_axis: Optional[str] = None, *, mesh: Mesh):
    """Two-stage hierarchical exchange (``comm_plan.HierCommPlan``).

    Each row's final destination (the combined row-major shard index)
    travels as an extra int32 lane through stage 1, and stage 2 reads its
    local destination from the received values, so the delivered (row,
    destination) multiset equals the flat exchange's.

    Intra tier (``intra_axis`` given): destination ``d = di * b + ds``
    hops to row ``di`` along the intra axis, then to column ``ds`` along
    ``axis``. Neighbourhood tier: one axis of ``n = a * b`` shards, ``d =
    qd * a + rd``; stage 1 routes to member ``rd`` inside each block of
    ``a`` adjacent shards, stage 2 to block ``qd`` across the strided
    co-rank groups. Returns ``(received_datas, received_live)`` shaped
    ``(n * capacity, ...)``."""
    a = plan.stages[0].n_shards
    b = plan.stages[1].n_shards
    cap = plan.capacity
    pids32 = pids.to(torch.int32)
    if intra_axis is not None:
        recv, rlive, _ = exchange_columns(
            datas + [pids32], live, pids32 // b, intra_axis, cap,
            plan=plan.stages[0], mesh=mesh)
        return exchange_columns(recv[:-1], rlive, recv[-1] % b, axis,
                                a * cap, plan=plan.stages[1],
                                mesh=mesh)[:2]
    g1 = tuple(tuple(q * a + r for r in range(a)) for q in range(b))
    recv, rlive, _ = exchange_columns(
        datas + [pids32], live, pids32 % a, axis, cap, plan=plan.stages[0],
        groups=g1, group_size=a, mesh=mesh)
    g2 = tuple(tuple(q * a + r for q in range(b)) for r in range(a))
    return exchange_columns(recv[:-1], rlive, recv[-1] // a, axis, a * cap,
                            plan=plan.stages[1], groups=g2, group_size=b,
                            mesh=mesh)[:2]


@traced("shuffle.shuffle_rows")
def shuffle_rows(mesh: Mesh, rows: torch.Tensor, pids: torch.Tensor,
                 capacity: int, axis: str = PART_AXIS) -> ShuffleResult:
    """all_to_all of row-format bytes along one mesh axis: ``rows`` is
    this rank's ``(n_local, row_size)`` uint8, ``pids`` each row's
    destination shard; ``pids < 0`` marks rows that are neither sent nor
    counted. ``capacity`` must be the same on every rank."""
    expects(rows.dim() == 2 and pids.dim() == 1, "rows (N,S) and pids (N,)")
    expects(rows.shape[0] == pids.shape[0], "rows/pids length mismatch")
    p = mesh.axis_size(axis)
    n_local, row_size = rows.shape
    active = pids >= 0
    order, dest, slot, keep, sendable = _lanes(active, pids, p, capacity)
    resid_sorted = sendable & ~keep
    resid = torch.zeros(n_local, dtype=torch.bool, device=rows.device)
    resid[order] = resid_sorted
    overflow = resid_sorted.sum(dtype=torch.int32).reshape(1)
    dslot = torch.where(keep, slot, capacity)
    send = _send_buffer(rows[order], dest, dslot, p, capacity)
    sv = _send_buffer(keep, dest, dslot, p, capacity)
    recv = all_to_all_blocks(send, axis, mesh)
    rv = all_to_all_blocks(sv, axis, mesh)
    return ShuffleResult(rows=recv.reshape(p * capacity, row_size),
                         valid=rv.reshape(p * capacity),
                         overflow=overflow, resid=resid)


def _sizes_from_images(images: torch.Tensor, schema) -> torch.Tensor:
    """Each row's byte size from its own fixed section: every STRING slot
    holds its byte length 4 bytes in, and row size = var_start +
    align8(sum of lengths), so receivers need no side channel."""
    from ..ops.row_conversion import RowLayout
    lay = RowLayout(schema)
    var_len = torch.zeros(images.shape[0], dtype=torch.int32,
                          device=images.device)
    for dt, start in zip(schema, lay.starts):
        if dt.id == TypeId.STRING:
            var_len = var_len + images[:, start + 4:start + 8] \
                .contiguous().view(torch.int32).reshape(-1)
    return lay.var_start + ((var_len + 7) & ~7)


@traced("shuffle.shuffle_table")
def shuffle_table(mesh: Mesh, table: Table, keys: "list[int]",
                  capacity: Optional[int] = None, axis: str = PART_AXIS,
                  max_rounds: int = 16) -> "tuple[Table, torch.Tensor]":
    """Hash-shuffle this rank's rows of a table (fixed-width and STRING
    columns) across ``axis`` by the key columns ``keys``.

    Returns (the rows this rank received, grouped by sender in shard
    order, as a table; every sender's overflow in round 1, ``(P,)``).
    Overflowing lanes are sent again with doubled capacity until every
    row lands (at most ``max_rounds`` rounds), so skew costs rounds,
    never rows. ``capacity`` defaults to twice the mean rows a lane
    (from the global row count, agreed by one all_reduce). Rows travel
    padded to the widest row of the global batch (agreed the same way);
    receivers recover each row's size from its own string lengths."""
    from ..columnar.strings import max_length
    from ..ops.row_conversion import (RowLayout, _to_row_images_var,
                                      compact_images, convert_from_rows,
                                      convert_to_rows)
    from .partition import hash_partition_ids

    expects(all(c.dtype.id not in (TypeId.LIST, TypeId.STRUCT)
                for c in table.columns),
            "shuffle_table takes fixed-width and STRING columns")
    p = mesh.axis_size(axis)
    n = table.num_rows
    dev = table.columns[0].device
    schema = table.schema()
    lay = RowLayout(schema)
    str_cols = [c for c in table.columns if c.dtype.id == TypeId.STRING]
    # one all_reduce agrees the global row count (the capacity) and the
    # widest strings (the wire row width) on every rank
    local = torch.tensor([n] + [max_length(c) for c in str_cols],
                         dtype=torch.int64, device=dev)
    agreed = all_reduce(local[:1], axis, mesh, "sum").tolist() + \
        all_reduce(local[1:], axis, mesh, "max").tolist()
    n_global, max_lens = agreed[0], tuple(agreed[1:])
    if capacity is None:
        capacity = max(1, int(np.ceil(n_global / (p * p) * 2.0)))
    set_attrs(rows=n, shards=p, capacity=capacity)

    if lay.has_var:
        rows, _ = _to_row_images_var(table, max_lens)
        expects(n * int(rows.shape[1]) < 2**31,
                "shuffled row images would exceed the 2GB size_type cap")
    else:
        row_cols = convert_to_rows(table)
        expects(len(row_cols) == 1, "shuffle batches must fit one row column")
        rows = row_cols[0].child.data.view(torch.uint8).reshape(
            n, lay.var_start)
    size_per_row = int(rows.shape[1])
    pids = hash_partition_ids(Table([table.column(i) for i in keys]), p)

    flats, senders = [], []
    overflow_r1 = None
    cap = capacity
    cur_rows, cur_pids = rows, pids
    for _ in range(max_rounds):
        res = shuffle_rows(mesh, cur_rows, cur_pids, cap, axis)
        if overflow_r1 is None:
            overflow_r1 = all_gather_rows(res.overflow, axis, mesh)
        idx = torch.nonzero(res.valid)[:, 0]  # host sync: received rows
        if idx.numel():
            flats.append(res.rows[idx])
            senders.append(idx // cap)
        ridx = torch.nonzero(res.resid)[:, 0]  # host sync: rows kept back
        n_resid = int(ridx.numel())
        # every rank runs the same rounds: agree whether any row is left
        left = all_reduce(torch.tensor([n_resid], dtype=torch.int64,
                                       device=dev), axis, mesh, "sum")
        if int(left[0]) == 0:
            break
        cur_rows, cur_pids = cur_rows[ridx], cur_pids[ridx]
        cap *= 2
        count("shuffle.retry_rounds")
        count("shuffle.retry_rows", n_resid)
        # every row kept back and sent again is counted: a non-zero value
        # means the capacity guess was wrong and the shuffle paid rounds
        count("shuffle.overflow_rows", n_resid)
        set_attrs(retry_rows=n_resid)
    else:
        expects(False, f"shuffle did not converge in {max_rounds} rounds")

    flat = (torch.cat(flats) if flats else torch.zeros(
        (0, size_per_row), dtype=torch.uint8, device=dev))
    sid = (torch.cat(senders) if senders else torch.zeros(
        0, dtype=torch.int64, device=dev))
    # sender-contiguous order across the retry rounds
    flat = flat[torch.argsort(sid, stable=True)]
    n_all = int(flat.shape[0])
    if lay.has_var:
        rows_col = compact_images(flat, _sizes_from_images(flat, schema))
    else:
        rows_col = Column.list_of_int8(
            flat.reshape(-1).view(torch.int8),
            torch.arange(n_all + 1, dtype=torch.int64, device=dev)
            * size_per_row)
    return convert_from_rows(rows_col, schema), overflow_r1
