"""Equality joins: the general sort-merge kernels and the probe-route
policy of the fused planner's dense join.

Port of ``spark_rapids_jni_tpu/ops/join.py``. The general joins throw
both key sides into ONE stable sort and read matches off the sorted
arrangement (group bounds by cumulative max/min scans), as the
reference does; the reference's shape bucketing (``utils/batching``) and
jit caches have no counterpart, since PyTorch runs eagerly and compiles
nothing per shape. ``inner_join_batched`` runs K independent joins as one
(K, n) row-wise sort and one expansion, with one host sync for all K
output sizes.

Null join keys never match (SQL semantics): ``row_ranks`` gives null
rows singleton groups.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import Table
from ..config import join_method, tuned_int
from ..utils.errors import expects
from .keys import row_ranks
from ..obs import count, traced

_INT_MAX = 2**31 - 1

# Probe-route caps, the reference's PALLAS_JOIN_MAX_CAPACITY and
# PALLAS_JOIN_MIN_PROBE_ROWS: the kernel route takes a build side whose
# open-addressing table has at most 2^19 slots, and a probe side of at
# least 2^14 rows (below that the direct-address gather is as cheap as a
# dedicated launch).
CUDA_JOIN_MAX_CAPACITY = 1 << 19
CUDA_JOIN_MIN_PROBE_ROWS = 1 << 14


def join_cuda_max_capacity() -> int:
    """K1's table-capacity cap: ``SRT_JOIN_CUDA_MAX_CAPACITY`` > the
    tuned winner > ``CUDA_JOIN_MAX_CAPACITY`` (the reference's
    ``SRT_JOIN_PALLAS_MAX_CAPACITY``). Rides ``planner_env_key``."""
    return tuned_int("SRT_JOIN_CUDA_MAX_CAPACITY", CUDA_JOIN_MAX_CAPACITY)


@traced("join.hash_table_capacity")
def hash_table_capacity(n_build: int) -> int:
    """Open-addressing capacity for ``n_build`` physical build rows: the
    next power of two at or above 2x (load factor <= 0.5), floor 128."""
    n = max(int(n_build), 1)
    return max(128, 1 << (2 * n - 1).bit_length())


@traced("join.join_probe_method")
def join_probe_method(n_build: int, n_probe: int,
                      backend: Optional[str] = None) -> str:
    """Dense-join probe route: ``"xla"`` (the reference's name for the
    direct-address gather, ``fused_pipeline.dense_lookup``) or
    ``"cuda"`` (K1, ``cuda_kernels.hash_join_probe``).

    ``SRT_JOIN_METHOD`` (``auto``/``xla``/``cuda``) forces a route; a
    forced ``cuda`` whose table exceeds the capacity cap degrades to
    ``xla`` with the ``rel.route.join.cuda_degraded`` counter. ``auto``
    takes the kernel on the ``cuda`` backend within the caps, as the
    reference takes Pallas on a TPU. ``backend`` is the device type of
    the tensors (``"cuda"`` or ``"cpu"``)."""
    mode = join_method()
    fits = hash_table_capacity(n_build) <= join_cuda_max_capacity()
    if mode == "xla":
        return "xla"
    if mode == "cuda":
        if not fits:
            count("rel.route.join.cuda_degraded")
            return "xla"
        return "cuda"
    if backend == "cuda" and fits and n_probe >= CUDA_JOIN_MIN_PROBE_ROWS:
        return "cuda"
    return "xla"


# --------------------------------------------------------------------------
# Sorted arrangement -> match structure
# --------------------------------------------------------------------------

def _arrangement(left: Table, right: Table):
    """Combined stable sort of both key sides: per sorted position its
    side (0 left, 1 right), its row within that side, and whether it
    starts a key group."""
    expects(left.num_rows + right.num_rows <= _INT_MAX,
            "combined join input must stay under 2^31 rows")
    n_left = left.num_rows
    sorted_ranks, perm = row_ranks([left, right])
    s_side = (perm >= n_left).to(torch.int64)
    s_lidx = perm - n_left * s_side
    is_head = torch.ones_like(sorted_ranks, dtype=torch.bool)
    if sorted_ranks.shape[0]:
        is_head[1:] = sorted_ranks[1:] != sorted_ranks[:-1]
    return s_side, s_lidx, is_head


def _group_bounds(s_side, is_head):
    """Per sorted position: its right rank, the first right rank of its
    group (``low``) and the group's right-row count."""
    tot = s_side.shape[0]
    c = torch.cumsum(s_side, 0)
    r_rank = c - s_side
    low = torch.cummax(torch.where(is_head, r_rank, 0), 0).values
    is_tail = torch.ones_like(is_head)
    if tot:
        is_tail[:-1] = is_head[1:]
    end = torch.flip(torch.cummin(
        torch.flip(torch.where(is_tail, c, tot), [0]), 0).values, [0])
    return r_rank, low, end - low


def _right_order(s_side, s_lidx, r_rank, n_right: int) -> torch.Tensor:
    """Right rank -> original right row."""
    order_r = torch.zeros(n_right + 1, dtype=torch.int64,
                          device=s_side.device)
    order_r[torch.where(s_side == 1, r_rank, n_right)] = s_lidx
    return order_r[:n_right]


def _match_by_left_row(left: Table, right: Table):
    """Per original left row: its match count and first right rank,
    plus the rank -> right row map."""
    n_left, n_right = left.num_rows, right.num_rows
    s_side, s_lidx, is_head = _arrangement(left, right)
    r_rank, low, cnt = _group_bounds(s_side, is_head)
    dst = torch.where(s_side == 0, s_lidx, n_left)
    counts = torch.zeros(n_left + 1, dtype=torch.int64, device=cnt.device)
    counts[dst] = cnt
    lower = torch.zeros(n_left + 1, dtype=torch.int64, device=cnt.device)
    lower[dst] = low
    return (counts[:n_left], lower[:n_left],
            _right_order(s_side, s_lidx, r_rank, n_right))


@traced("join.inner_join")
def inner_join(left_keys: Table, right_keys: Table
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inner equality join -> (left_indices, right_indices), int32.
    Pairs come in sorted-key order (the order is unspecified, as with
    cudf's hash join)."""
    expects(left_keys.num_columns == right_keys.num_columns,
            "join key tables must have the same number of columns")
    s_side, s_lidx, is_head = _arrangement(left_keys, right_keys)
    r_rank, low, cnt = _group_bounds(s_side, is_head)
    order_r = _right_order(s_side, s_lidx, r_rank, right_keys.num_rows)
    cnt_left = torch.where(s_side == 0, cnt, 0)
    pos = torch.arange(cnt_left.shape[0], dtype=torch.int64,
                       device=cnt_left.device)
    src = torch.repeat_interleave(pos, cnt_left)  # host sync: output size
    expects(src.shape[0] <= _INT_MAX, "join result exceeds 2^31 rows")
    excl = torch.cumsum(cnt_left, 0) - cnt_left
    j = torch.arange(src.shape[0], dtype=torch.int64,
                     device=src.device) - excl[src]
    li = s_lidx[src]
    ri = order_r[low[src] + j] if src.shape[0] else src
    return li.to(torch.int32), ri.to(torch.int32)


@traced("join.left_join")
def left_join(left_keys: Table, right_keys: Table
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left outer join -> (left_indices, right_indices), int32, in left
    row order; -1 marks no match."""
    counts, lower, order_r = _match_by_left_row(left_keys, right_keys)
    out_counts = torch.clamp(counts, min=1)
    rows = torch.arange(counts.shape[0], dtype=torch.int64,
                        device=counts.device)
    li = torch.repeat_interleave(rows, out_counts)  # host sync
    expects(li.shape[0] <= _INT_MAX, "join result exceeds 2^31 rows")
    excl = torch.cumsum(out_counts, 0) - out_counts
    j = torch.arange(li.shape[0], dtype=torch.int64,
                     device=li.device) - excl[li]
    matched = counts[li] > 0
    probe = torch.clamp(lower[li] + j, 0, max(order_r.shape[0] - 1, 0))
    ri = (torch.where(matched, order_r[probe], -1) if order_r.shape[0]
          else torch.full_like(li, -1))
    return li.to(torch.int32), ri.to(torch.int32)


@traced("join.left_semi_join")
def left_semi_join(left_keys: Table, right_keys: Table) -> torch.Tensor:
    """Left rows with at least one match -> ascending left indices."""
    counts, _, _ = _match_by_left_row(left_keys, right_keys)
    return torch.nonzero(counts > 0).flatten().to(torch.int32)


@traced("join.left_anti_join")
def left_anti_join(left_keys: Table, right_keys: Table) -> torch.Tensor:
    """Left rows with no match -> ascending left indices."""
    counts, _, _ = _match_by_left_row(left_keys, right_keys)
    return torch.nonzero(counts == 0).flatten().to(torch.int32)


# --------------------------------------------------------------------------
# Batched joins: K independent joins, each step launched once for all K
# --------------------------------------------------------------------------

def _batched_keys(tables: Sequence[Table], narrow: bool) -> torch.Tensor:
    """(K, n) sort keys of K single-column key tables: int64 values, or,
    ``narrow`` (every key shares its high 32 bits), their low words
    shifted into int32 (the same order, half the sort's bytes)."""
    k = torch.stack([t.columns[0].data.to(torch.int64) for t in tables])
    if not narrow:
        return k
    base = (int(tables[0].columns[0].value_range[0]) >> 32) << 32
    return (k - base - (1 << 31)).to(torch.int32)


@traced("join.inner_join_batched")
def inner_join_batched(lefts: Sequence[Table], rights: Sequence[Table]
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """K independent inner joins as one batched device program.

    ``lefts``/``rights``: sequences of single-column key Tables, the
    lefts of one row count and the rights of another, non-nullable
    integral keys of one dtype. Returns a list of (left_indices,
    right_indices) int32 pairs, each equal to ``inner_join`` of its pair
    (the same pairs in the same order). All K sorts run as one (K, n)
    row-wise stable sort and every scan, scatter and gather launches once
    for all K joins; one host sync reads all K output sizes.

    Keys are narrow (sorted as int32) when every key's ``value_range``
    shares its high 32 bits, the reference's stats-driven narrowing; wide
    otherwise (int64)."""
    expects(len(lefts) == len(rights) and len(lefts) > 0,
            "need equal, nonzero batch sizes")
    n_l = lefts[0].num_rows
    n_r = rights[0].num_rows
    dt = lefts[0].columns[0].dtype
    for t in list(lefts) + list(rights):
        expects(t.num_columns == 1, "batched join takes single-key tables")
        expects(t.columns[0].validity is None,
                "batched join keys must be non-nullable")
        expects(t.columns[0].dtype.id == dt.id, "batched keys share a dtype")
    expects(dt.is_integral, "batched join keys must be integral")
    for t in lefts:
        expects(t.num_rows == n_l, "left tables share a row count")
    for t in rights:
        expects(t.num_rows == n_r, "right tables share a row count")
    expects(n_l + n_r <= _INT_MAX,
            "combined join input must stay under 2^31 rows")
    his = set()
    for t in list(lefts) + list(rights):
        vr = t.columns[0].value_range
        if vr is None:
            his = None
            break
        his |= {int(vr[0]) >> 32, int(vr[1]) >> 32}
    narrow = his is not None and len(his) == 1
    count(f"rel.route.join.batched.{'narrow' if narrow else 'wide'}")
    keys = torch.cat([_batched_keys(lefts, narrow),
                      _batched_keys(rights, narrow)], dim=1)
    kb, tot = keys.shape
    dev = keys.device
    sk, perm = torch.sort(keys, dim=1, stable=True)
    s_side = (perm >= n_l).to(torch.int64)
    s_lidx = perm - n_l * s_side
    is_head = torch.ones_like(sk, dtype=torch.bool)
    if tot:
        is_head[:, 1:] = sk[:, 1:] != sk[:, :-1]
    # _group_bounds row-wise
    c = torch.cumsum(s_side, 1)
    r_rank = c - s_side
    low = torch.cummax(torch.where(is_head, r_rank, 0), 1).values
    is_tail = torch.ones_like(is_head)
    if tot:
        is_tail[:, :-1] = is_head[:, 1:]
    end = torch.flip(torch.cummin(
        torch.flip(torch.where(is_tail, c, tot), [1]), 1).values, [1])
    cnt = end - low
    # _right_order row-wise: right rank -> original right row
    order_r = torch.zeros((kb, n_r + 1), dtype=torch.int64, device=dev)
    order_r.scatter_(1, torch.where(s_side == 1, r_rank, n_r), s_lidx)
    order_r = order_r[:, :n_r]
    cnt_left = torch.where(s_side == 0, cnt, 0)
    totals = cnt_left.sum(dim=1).tolist()  # one host sync: all K sizes
    grand = sum(totals)
    expects(max(totals) <= _INT_MAX, "join result exceeds 2^31 rows")
    flat = cnt_left.reshape(-1)
    src = torch.repeat_interleave(
        torch.arange(kb * tot, dtype=torch.int64, device=dev), flat,
        output_size=grand)
    excl = torch.cumsum(flat, 0) - flat
    j = torch.arange(grand, dtype=torch.int64, device=dev) - excl[src]
    li = s_lidx.reshape(-1)[src]
    ri = (order_r[src // tot, low.reshape(-1)[src] + j] if grand
          else src)
    li, ri = li.to(torch.int32), ri.to(torch.int32)
    return list(zip(torch.split(li, totals), torch.split(ri, totals)))
