"""Fused query-pipeline primitives: dense joins and groupbys over
trusted key ranges, composed as row masks without host syncs.

Port of the single-device parts of
``spark_rapids_jni_tpu/ops/fused_pipeline.py``:

- **Broadcast (dense-key dictionary) join**: a build side whose key
  stats show a small dense integer range becomes a direct-address map;
  the probe is a gather, and the probe side keeps its row order.
- **Dense groupby**: keys in a small known range aggregate into FIXED
  (width,) slots, so the result shape never depends on the data.

torch scatters raise on an out-of-range index where JAX's
``mode="drop"`` discards it, so every scatter here parks dead rows in a
sentinel slot ``width`` of a ``width + 1`` buffer and slices it off.
The two-phase merges of a partitioned run (``dense_merge_replicated``,
``dense_merge_scattered``) take the mesh's collectives
(``parallel/collectives.py``). The micro-batching knobs (``batch_route``,
``max_batch_queries``, ``batch_capacity`` over the static ladder
``BATCH_CAPACITIES``) steer ``tpcds/rel.run_fused_batched`` and the
fleet scheduler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..config import dense_groupby_mode, env_str, tuned_int
from ..utils.errors import expects
from ..obs import count, flight_note, traced

# Dense maps beyond this width stop paying for themselves.
MAX_DENSE_WIDTH = 1 << 24

# K2's width cap, the reference's PALLAS_GROUPBY_MAX_WIDTH.
CUDA_GROUPBY_MAX_WIDTH = 1 << 13


# Micro-query batching (serving/batcher.py, tpcds/rel.run_fused_batched):
# a bounded ladder of static batch capacities, so the distinct batched
# programs (one captured CUDA graph each on the card) stay O(log K) instead
# of one per arrival count; a partially filled window pads up to the next
# rung (pad slots carry copies of slot 0 and are never demultiplexed).
BATCH_CAPACITIES = (2, 4, 8, 16)


@traced("fused_pipeline.batch_route")
def batch_route() -> str:
    """Normalized ``SRT_BATCH_ROUTE``: ``padded`` forces the capacity
    rung, ``ragged`` sizes the program by the page pool's lease (serving
    padded, counted, when the pool is off or exhausted), ``auto``
    (default, and every invalid spelling) takes ragged whenever the pool
    can fund the window."""
    r = env_str("SRT_BATCH_ROUTE", "auto")
    return r if r in ("padded", "ragged", "auto") else "auto"


# one-time SRT_BATCH_MAX-over-ladder note; benign flag race (worst case
# two notes), the counter underneath is exact
_max_clamp_noted = False


@traced("fused_pipeline.max_batch_queries")
def max_batch_queries() -> int:
    """Upper bound on queries coalesced into one batched dispatch
    (``SRT_BATCH_MAX``, clamped to the capacity ladder; the scheduler
    reads <=1 as batching off). A value above the ladder's top still
    clamps, but loudly: ``serving.batch.max_clamped`` per clamped read
    and one flight note."""
    k = tuned_int("SRT_BATCH_MAX", BATCH_CAPACITIES[-1])
    if k > BATCH_CAPACITIES[-1]:
        count("serving.batch.max_clamped")
        global _max_clamp_noted
        if not _max_clamp_noted:
            _max_clamp_noted = True
            flight_note("batch.max_clamped",
                        requested=k, ladder_max=BATCH_CAPACITIES[-1])
    return min(k, BATCH_CAPACITIES[-1])


@traced("fused_pipeline.batch_capacity")
def batch_capacity(k: int) -> int:
    """Smallest static capacity >= k on the ladder (k is pre-clamped by
    ``max_batch_queries``): the batch program is keyed on this rung, not
    on k."""
    for c in BATCH_CAPACITIES:
        if c >= k:
            return c
    return BATCH_CAPACITIES[-1]


@dataclass(frozen=True)
class DenseKeyMap:
    """Dictionary over a dense integer key range [lo, lo + width):
    ``rows[k - lo]`` is the build row holding key ``k``, or -1."""

    lo: int
    width: int
    rows: torch.Tensor  # (width,) int32


@traced("fused_pipeline.dense_map_applicable")
def dense_map_applicable(keys: Column) -> bool:
    """Host-side planner check: integer, non-null, known small range."""
    if keys.validity is not None or keys.value_range is None:
        return False
    if keys.data is None:
        return False
    lo, hi = keys.value_range
    return (hi - lo + 1) <= MAX_DENSE_WIDTH


@traced("fused_pipeline.build_dense_map")
def build_dense_map(keys: Column, mask: Optional[torch.Tensor] = None, *,
                    check_range: bool = True,
                    check_unique: bool = True) -> DenseKeyMap:
    """Build the lookup table for a build-side key column. Keys must be
    unique; ``mask`` restricts the build to live rows. ``check_range``
    and ``check_unique`` each cost a host sync; the trusted-stats planner
    passes False for both, which leaves pure tensor algebra."""
    expects(dense_map_applicable(keys),
            "dense key map needs non-null int keys with known small range")
    lo, hi = keys.value_range
    width = int(hi) - int(lo) + 1
    k64 = keys.data.to(torch.int64) - int(lo)
    inb = (k64 >= 0) & (k64 < width)
    if check_range:
        expects(bool(inb.all()),
                "build-side keys fall outside the recorded value_range")
    live = inb if mask is None else (inb & mask)
    k = torch.where(live, k64, width)
    dev = keys.data.device
    rows = torch.full((width + 1,), -1, dtype=torch.int32, device=dev)
    rows[k] = torch.arange(keys.size, dtype=torch.int32, device=dev)
    if check_unique:
        counts = torch.zeros(width + 1, dtype=torch.int32, device=dev)
        counts.index_add_(0, k, torch.ones_like(k, dtype=torch.int32))
        expects(bool((counts[:width] <= 1).all()),
                "dense key map requires unique build-side keys")
    return DenseKeyMap(lo=int(lo), width=width, rows=rows[:width])


@traced("fused_pipeline.dense_lookup")
def dense_lookup(dmap: DenseKeyMap, probe_keys: torch.Tensor,
                 probe_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the map: (build_row_idx int32, found bool) per probe row;
    out-of-range or absent keys get found=False and index 0."""
    k = probe_keys.to(torch.int64) - dmap.lo
    inb = (k >= 0) & (k < dmap.width)
    idx = dmap.rows[torch.clamp(k, 0, dmap.width - 1)]
    found = inb & (idx >= 0)
    if probe_mask is not None:
        found = found & probe_mask
    return torch.where(found, idx, 0), found


@traced("fused_pipeline.dense_groupby_method")
def dense_groupby_method(width: int, backend: Optional[str] = None) -> str:
    """Dense groupby accumulation route: ``scatter`` (index_add_),
    ``onehot`` (forced only) or ``cuda`` (K2,
    ``cuda_kernels.ragged_groupby_sum_count``).

    ``SRT_DENSE_GROUPBY`` (``auto``/``scatter``/``onehot``/``cuda``)
    forces a route; a forced ``cuda`` past the width cap degrades to
    ``scatter`` with the ``rel.route.groupby.cuda_degraded`` counter.
    ``auto`` takes the kernel on the ``cuda`` backend within the width
    cap, as the reference takes Pallas on a TPU; CPU tensors take
    ``scatter``. The one-hot route (the reference's MXU formulation) is
    never auto-picked. Unlike the reference, no cap depends on the row
    count: K2 does O(rows) work at any width."""
    mode = dense_groupby_mode()
    if mode in ("onehot", "scatter"):
        return mode
    if mode == "cuda":
        if width > CUDA_GROUPBY_MAX_WIDTH:
            count("rel.route.groupby.cuda_degraded")
            return "scatter"
        return "cuda"
    if backend == "cuda" and width <= CUDA_GROUPBY_MAX_WIDTH:
        return "cuda"
    return "scatter"


@traced("fused_pipeline.dense_groupby_sum_count")
def dense_groupby_sum_count(group_slots: torch.Tensor, mask: torch.Tensor,
                            values: torch.Tensor, width: int,
                            method: str = "scatter"):
    """Fixed-width groupby: per-slot (sum, count) for slots [0, width).

    Sums accumulate in int64 for every integral input (exact mod 2^64 in
    any order, Spark's long wrap) and in float64 for floats (order-
    dependent in the last bits). ``cuda`` takes K2 for integral values,
    with the mask and slots as they are (K2 skips dead and out-of-range
    rows itself); float values stay on ``scatter`` (the reference's rule),
    counted as ``rel.route.groupby.cuda.float_scatter``."""
    is_float = values.dtype.is_floating_point
    acc = torch.float64 if is_float else torch.int64
    if method == "cuda":
        if is_float:
            count("rel.route.groupby.cuda.float_scatter")
            method = "scatter"
        else:
            from .cuda_kernels import ragged_groupby_sum_count
            return ragged_groupby_sum_count(group_slots, mask, values, width)
    live = mask & (group_slots >= 0) & (group_slots < width)
    if method == "onehot":
        # dead rows are zeroed before the product: 0 * NaN would poison
        # the slot. An elementwise product and row sum, not a matmul:
        # CUDA has no int64 matmul.
        vals = torch.where(live, values.to(acc), 0)
        slots = torch.arange(width, dtype=torch.int64,
                             device=group_slots.device)
        oh = (slots[:, None] == group_slots.to(torch.int64)[None, :]) \
            & live[None, :]
        sums = torch.where(oh, vals[None, :], 0).sum(dim=1, dtype=acc)
        counts = oh.sum(dim=1, dtype=torch.int32)
        return sums, counts
    slot = torch.where(live, group_slots.to(torch.int64), width)
    dev = group_slots.device
    sums = torch.zeros(width + 1, dtype=acc, device=dev)
    sums.index_add_(0, slot, values.to(acc))
    counts = torch.zeros(width + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return sums[:width], counts[:width]


@traced("fused_pipeline.dense_groupby_extreme")
def dense_groupby_extreme(group_slots: torch.Tensor, mask: torch.Tensor,
                          values: torch.Tensor, width: int,
                          take_min: bool) -> torch.Tensor:
    """Fixed-width per-slot min (take_min) or max for INTEGRAL values;
    empty slots hold the identity (callers mask them off)."""
    live = mask & (group_slots >= 0) & (group_slots < width)
    slot = torch.where(live, group_slots.to(torch.int64), width)
    info = torch.iinfo(values.dtype)
    ident = info.max if take_min else info.min
    out = torch.full((width + 1,), ident, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, slot, values, "amin" if take_min else "amax")
    return out[:width]


# ---------------------------------------------------------------------------
# Two-phase (partitioned) merges: the collective half of a partitioned
# dense groupby. Phase 1 is the per-shard dense_groupby_sum_count/extreme
# over local rows; these merge the (width,) partials across the mesh.
# ---------------------------------------------------------------------------

@traced("fused_pipeline.dense_merge_replicated")
def dense_merge_replicated(partial: torch.Tensor, axis, op: str = "sum", *,
                           mesh) -> torch.Tensor:
    """Merge per-shard ``(width,)`` dense partials into the full merged
    vector on every shard (an all-reduce: sum, min or max). Right for
    small slot spaces: the result is replicated."""
    from ..parallel.collectives import all_reduce
    expects(op in ("sum", "min", "max"), f"unknown merge op {op!r}")
    return all_reduce(partial, axis, mesh, op)


@traced("fused_pipeline.dense_merge_scattered")
def dense_merge_scattered(partial: torch.Tensor, axis, op: str = "sum", *,
                          mesh) -> torch.Tensor:
    """Merge per-shard ``(width,)`` dense partials into a slot-sharded
    result: shard ``i`` receives the merged slots ``[i * w_local, (i + 1)
    * w_local)``, ``w_local`` the width over the shard count rounded up.
    Each shard ships every peer only the slice that peer owns, and no
    shard holds the whole merged vector. Padding slots carry the merge
    identity; callers mask them off through the merged counts."""
    from ..parallel.collectives import (axis_size, reduce_scatter_extreme,
                                        reduce_scatter_sum)
    p = axis_size(mesh, axis)
    width = int(partial.shape[0])
    w_local = -(-width // p)
    pad = w_local * p - width
    if pad:
        if op == "sum":
            ident = 0
        else:
            info = torch.iinfo(partial.dtype)
            ident = info.max if op == "min" else info.min
        partial = torch.cat([partial, torch.full(
            (pad,), ident, dtype=partial.dtype, device=partial.device)])
    if op == "sum":
        return reduce_scatter_sum(partial, axis, mesh)
    return reduce_scatter_extreme(partial, axis, op, mesh)


@traced("fused_pipeline.dense_groupby_table")
def dense_groupby_table(slots: torch.Tensor, mask: torch.Tensor,
                        values: torch.Tensor, width: int,
                        slot_to_key=None) -> Table:
    """Host-facing wrapper: dense groupby -> compacted (key, sum) Table
    (the compaction syncs)."""
    sums, counts = dense_groupby_sum_count(slots, mask, values, width)
    sums_np = sums.cpu().numpy()
    present = counts.cpu().numpy() > 0
    keys_np = np.nonzero(present)[0].astype(np.int64)
    if slot_to_key is not None:
        keys_np = slot_to_key(keys_np)
    dev = slots.device
    return Table([Column.from_numpy(keys_np, device=dev),
                  Column.from_numpy(sums_np[present], device=dev)])
