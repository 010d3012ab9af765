"""Window operators: row_number, rank and partition sum/count inside the
fused plan.

Port of ``spark_rapids_jni_tpu/tpcds/oplib/windows.py`` on one device.
The partitions are the dense groupby's slots
(``relational.dense_slots``, mixed-radix codes over the keys' trusted
ranges); the order is one stable multi-key sort (``keys.stable_lexsort``
over int64 keys: dead rows last, then the slot, then each order column's
null plane and key, descending as ``~key``); a partition's sums and
counts are one ``dense_groupby_sum_count`` pass (K2 on the card within
its width cap) per value column, gathered back through the slots. No
host syncs.

Numbering over the sorted rows is cumulative algebra: with ``new_part``
marking partition starts, ``start = cummax(new_part ? i : 0)`` is each
row's partition start and ``row_number = i - start + 1``; ``rank`` puts
the start of the row's tie run in place of ``i``. One scatter through
the permutation puts the results back in physical row order. On the card
the scans and the scatter are one launch of K8
(``cuda_kernels.window_numbering``), on the CPU its plain version. Ties
keep physical order (the sort is stable), and dead rows sort last, so
they never shift live numbering.

A partition key without a trusted dense range takes the eager route:
the rel is compacted and its key tuples factorized on the host
(``rel.route.window.general``), or ``FusedFallback`` while ``run_fused``
runs a plan.

In a partitioned run over sharded rows, each window partition first goes
to one shard (slot ``% P``) through the staged exchange of
``tpcds/dist.py`` (``rel.route.window.exchange``), then everything above
runs shard-locally. Dead rows' slots are set to 0 first: an exchange's
empty receive slots hold zeros, whose slots may lie outside ``[0,
width)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...columnar import Column
from ...obs import count, set_attrs
from ...ops import cuda_kernels
from ...ops.fused_pipeline import (dense_groupby_method,
                                   dense_groupby_sum_count)
from ...ops.groupby import result_dtype
from ...ops.keys import null_plane, sort_key, stable_lexsort
from ...types import INT64, TypeId
from ...utils.errors import CudfLikeError
from .. import rel as _rel
from .registry import operator
from .relational import dense_slots, plain_value_column

WINDOW_FUNCS = ("row_number", "rank", "sum", "count")
_SIGN64 = -(1 << 63)  # int64 with only the sign bit set


def window_oracle(df, partition_by, order_by, funcs, descending=None):
    """Reference semantics over a pandas frame: one column appended per
    ``(kind, value_col, out)``. ``rank`` is SQL RANK() (ties share, gaps
    after); ``sum``/``count`` are whole-partition aggregates."""
    out = df.copy()
    desc = list(descending or [False] * len(order_by))
    ordered = df.sort_values(
        list(order_by), ascending=[not d for d in desc], kind="stable")
    grouped = ordered.groupby(list(partition_by), sort=False)
    for kind, vcol, name in funcs:
        if kind == "row_number":
            out[name] = (grouped.cumcount() + 1).reindex(df.index)
        elif kind == "rank":
            # a tie run starts where an order value differs from the
            # previous row OF THE SAME PARTITION (the reference compares
            # with the previous row of the whole sorted frame, which
            # another partition's equal value can hide)
            changed = None
            for c in order_by:
                ch = ordered[c].ne(grouped[c].shift())
                changed = ch if changed is None else (changed | ch)
            rn = grouped.cumcount() + 1
            firsts = rn.where(changed | (rn == 1))
            # the tie run's first row number, carried forward
            out[name] = firsts.groupby(
                [ordered[c] for c in partition_by]).ffill() \
                .reindex(df.index).astype("int64")
        elif kind == "sum":
            out[name] = df.groupby(list(partition_by))[vcol] \
                .transform("sum")
        elif kind == "count":
            out[name] = df.groupby(list(partition_by))[vcol] \
                .transform("count").astype("int64")
        else:
            raise ValueError(f"unknown window func {kind!r}")
    return out


def _host_slots(rel, partition_by):
    """The eager route's partitions: the key tuples of the compacted rel
    factorized on the host."""
    plain = rel.compact()
    keys = np.stack([plain.col(k).data.cpu().numpy()
                     for k in partition_by], axis=1)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    width = int(inv.max()) + 1 if inv.size else 1
    return plain, torch.from_numpy(inv.astype(np.int32)).to(plain.device), \
        width


def _order_keys(oc: Column, descending: bool) -> "list[torch.Tensor]":
    """int64 sort keys of an order column, most significant first."""
    if oc.dtype.id == TypeId.DECIMAL128:
        # the hi lane signed, then the lo lane unsigned (sign bit flipped)
        keys = [oc.data[:, 1], oc.data[:, 0] ^ _SIGN64]
        return [~k for k in keys] if descending else keys
    return [sort_key(oc, descending=descending)]


def _changed(oc: Column, order: torch.Tensor) -> torch.Tensor:
    """(n - 1,) bool: sorted row i + 1 differs from row i in ``oc``.
    NULLs equal each other and differ from every value, whatever the
    bytes under them."""
    v = oc.data[order]
    neq = v[1:] != v[:-1]
    if v.dim() > 1:  # DECIMAL128 lanes
        neq = neq.any(dim=1)
    if oc.validity is not None:
        vb = oc.valid_bool()[order]
        neq = (vb[1:] != vb[:-1]) | (vb[1:] & vb[:-1] & neq)
    return neq


@operator("window", mask_class="segmented", partition="exchange_by_keys",
          oracle=window_oracle,
          params=("SRT_DENSE_GROUPBY", "SRT_SHUFFLE_SCRATCH_BYTES"))
def window(rel, partition_by: Sequence[str], order_by: Sequence[str],
           funcs: Sequence[tuple],
           descending: Optional[Sequence[bool]] = None):
    """Append window-function columns to ``rel`` (module docstring).
    ``funcs`` = [(kind, value_col_or_None, out_name), ...], kinds from
    :data:`WINDOW_FUNCS`."""
    for kind, _, _ in funcs:
        if kind not in WINDOW_FUNCS:
            raise CudfLikeError(f"unknown window func {kind!r}")
    desc = list(descending or [False] * len(order_by))
    enc = dense_slots(rel, partition_by)
    if enc is None:
        if _rel._FUSED_TRACING:
            raise _rel.FusedFallback(
                f"window over {list(partition_by)} needs trusted dense "
                "partition keys")
        count("rel.route.window.general")
        set_attrs(route="general")
        rel, slots, width = _host_slots(rel, partition_by)
    else:
        slots, width = enc[0], enc[1]
        if _rel._DIST_CTX is not None and rel.part == "sharded":
            # co-partition each window partition onto one shard, then
            # compute shard-locally (the exchange_by_keys contract)
            from .. import dist
            count("rel.route.window.exchange")
            rel = dist.exchange_rel(
                rel, torch.remainder(slots, _rel._DIST_CTX.nshards)
                .to(torch.int32))
            enc = dense_slots(rel, partition_by)
            if enc is None:  # verified stats survive the exchange
                raise _rel.FusedFallback(
                    "window lost its dense partition keys across the "
                    "exchange")
            slots, width = enc[0], enc[1]
        count("rel.route.window.dense")
        set_attrs(route="dense", width=width)

    n = rel.num_rows
    dev = slots.device
    live = (torch.ones(n, dtype=torch.bool, device=dev) if rel.mask is None
            else rel.mask)
    slots = torch.where(live, slots, 0)
    method = dense_groupby_method(width, backend=dev.type)

    kinds = {kind for kind, _, _ in funcs}
    want = tuple(k for k in cuda_kernels.WINDOW_OUTPUTS if k in kinds)
    numbers = {}
    if want:
        # one stable sort: dead rows last, then the slot (slots lie in
        # [0, width), so the two make one key), then the order columns
        keys = [slots.to(torch.int64) + (~live).to(torch.int64) * width]
        for name, d in zip(order_by, desc):
            oc = rel.col(name)
            if oc.validity is not None:
                keys.append(null_plane(oc, nulls_first=True))
            keys.extend(_order_keys(oc, d))
        order = stable_lexsort(keys)
        sslot = slots[order]
        new_part = torch.ones(n, dtype=torch.bool, device=dev)
        new_part[1:] = sslot[1:] != sslot[:-1]
        changed = None
        if "rank" in want:
            # a tie run starts where the partition or any order value
            # changes
            changed = new_part.clone()
            for name in order_by:
                changed[1:] |= _changed(rel.col(name), order)
        numbers = dict(zip(want, cuda_kernels.window_numbering(
            order, new_part, changed, want)))

    passes = {}  # one (sums, counts) pass per value column

    def pass_for(vcol):
        if vcol not in passes:
            vc = rel.col(vcol)
            if not plain_value_column(vc):
                raise CudfLikeError(
                    f"window over multi-lane column {vcol!r} (DECIMAL128) "
                    "is not supported: cast or rescale to DECIMAL64 first")
            vlive = live if vc.validity is None else (live & vc.valid_bool())
            passes[vcol] = dense_groupby_sum_count(slots, vlive, vc.data,
                                                   width, method)
        return passes[vcol]

    out_rel = rel
    for kind, vcol, out_name in funcs:
        if kind in numbers:
            col = Column(INT64, n, numbers[kind])
        else:  # sum / count over the whole partition
            sums, counts = pass_for(vcol)
            if kind == "sum":
                rdt = result_dtype("sum", rel.col(vcol).dtype)
                col = Column(rdt, n, sums[slots].to(rdt.to_torch()))
            else:
                col = Column(INT64, n, counts[slots].to(torch.int64))
        out_rel = out_rel.with_column(out_name, col)
    return out_rel
