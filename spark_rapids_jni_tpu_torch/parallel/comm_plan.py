"""Communication-plan optimizer: staged, memory-capped exchanges.

Port of ``spark_rapids_jni_tpu/parallel/comm_plan.py``; pure host
arithmetic over static shapes, so the plans, their byte models and
their route names are the reference's, number for number.

The fused shuffle (``exchange_columns`` + ``tpcds/dist.py``) uses the
lossless per-lane capacity, so a single-shot ``all_to_all``'s transient
buffers scale with the global exchanged bytes: each collective builds a
``(n_shards, capacity)``-lane send buffer and its received mirror on
every device. ``plan_exchange`` lowers one exchange into ``rounds``
chunked all_to_all rounds under a per-device scratch budget
(``SRT_SHUFFLE_SCRATCH_BYTES``): round ``r`` ships lane slots
``[r*chunk, (r+1)*chunk)`` of every (sender, receiver) lane, so the
largest live collective buffer shrinks by the staging factor while the
delivered rows, and their layout, stay identical to the single shot.

Scratch model (what the budget bounds, and what the
``shuffle.peak_scratch_bytes`` counter reports): columns travel one
collective each, so the peak transient footprint of a staged exchange is
the send buffer plus the received mirror of the widest single column in
one round::

    peak = 2 * n_shards * chunk * max(column_bytes + [1])   # +1: validity lane

The planner picks the largest ``chunk`` whose peak fits the budget
(``rounds = ceil(capacity / chunk)``), bounded by ``MAX_STAGED_ROUNDS``;
an exchange that needs more rounds stages maximally and reports itself
over budget (``fits_budget == False``, counted
``rel.route.shuffle.budget_unmet``).

Every rank must plan the same rounds (each round is a collective), so
the budget is an environment knob every rank reads alike, the override
below, which a caller applies on every rank, or, with the knob unset,
the device-memory probe (``obs/memory.probed_scratch_budget``), which a
partitioned run agrees across its ranks by an all-reduce of the minimum
at its entry and holds on its thread for the run
(``agreed_probe_scope``). With the knob unset and no agreed probe held
(outside a partitioned run, or on a device with no memory stats such as
the CPU) the budget is unlimited: no rank ever plans from its own
un-agreed probe. The reference's tuned tier
is not ported. The port runs eagerly, so there is no plan cache for a
budget to re-key.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

from ..config import env_int, env_str

# Hard ceiling on staging depth: each round is (n_columns + 1)
# collectives, so unbounded staging would trade the memory cliff for a
# latency cliff. An exchange whose budget demands more rounds stages to
# this depth and reports fits_budget=False instead.
MAX_STAGED_ROUNDS = 64

# SRT_SHUFFLE_JOIN_ROUTE values (tpcds/oplib/relational.py
# route_sharded_build_join)
JOIN_ROUTE_AUTO = "auto"
JOIN_ROUTE_EXCHANGE = "exchange"
JOIN_ROUTE_REDUCE_SCATTER = "reduce_scatter"
JOIN_ROUTES = (JOIN_ROUTE_AUTO, JOIN_ROUTE_EXCHANGE,
               JOIN_ROUTE_REDUCE_SCATTER)

# Floor of the shrink ladder: below it the staged planner would demand
# more rounds than MAX_STAGED_ROUNDS for any real exchange.
MIN_SCRATCH_BYTES = 4096

# Process-level override of the env budget (shrink_scratch_budget), for
# a caller that degrades the budget after running out of device memory.
# It must be applied on every rank alike. The holders are the callers
# whose retries depend on the degraded tier: the override is dropped
# when the last one releases.
_scratch_override: Optional[int] = None  # guarded-by: _scratch_lock
_scratch_lock = threading.Lock()
_scratch_holders: set = set()  # guarded-by: _scratch_lock

# The probe agreed by the ranks of the partitioned run on this thread
# (agreed_probe_scope); a thread outside one holds none.
_agreed = threading.local()


def _configured_budget() -> "tuple[bool, Optional[int]]":
    """(True, budget) when the override or ``SRT_SHUFFLE_SCRATCH_BYTES``
    (0 = unlimited) decides the budget; (False, None) when the knob is
    unset or malformed."""
    if _scratch_override is not None:
        return True, _scratch_override
    try:
        b = int(env_str("SRT_SHUFFLE_SCRATCH_BYTES", "").strip())
    except ValueError:
        return False, None
    return True, (b if b > 0 else None)


def scratch_budget() -> Optional[int]:
    """Per-device exchange scratch budget in bytes, or None (unlimited:
    every exchange stays single-shot). An active override
    (``shrink_scratch_budget``) wins over ``SRT_SHUFFLE_SCRATCH_BYTES``;
    with the knob unset, the probe agreed by the partitioned run on this
    thread, else unlimited."""
    configured, budget = _configured_budget()
    if configured:
        return budget
    return getattr(_agreed, "budget", None)


def budget_configured() -> bool:
    """True when the override or ``SRT_SHUFFLE_SCRATCH_BYTES`` decides the
    budget, so no probe needs agreeing (both read alike on every rank)."""
    return _configured_budget()[0]


@contextlib.contextmanager
def agreed_probe_scope(budget: Optional[int]):
    """Hold ``budget``, the probe a partitioned run agreed on every rank,
    as this thread's probed budget for the block."""
    prev = getattr(_agreed, "budget", None)
    _agreed.budget = budget
    try:
        yield
    finally:
        _agreed.budget = prev


def shrink_scratch_budget(holder=None) -> Optional[int]:
    """Degrade the exchange scratch budget one tier (halve it, floored
    at ``MIN_SCRATCH_BYTES``). Returns the new effective budget, or None
    when there is nothing to shrink (no budget in force, or already at
    the floor). ``holder`` registers a dependence on the degraded tier,
    even at the floor, released via ``release_scratch_override``; the
    configured budget comes back when the last holder releases (or on
    ``reset_scratch_override``)."""
    global _scratch_override
    with _scratch_lock:
        cur = scratch_budget()
        if cur is None:
            return None
        if holder is not None:
            _scratch_holders.add(holder)
        if cur <= MIN_SCRATCH_BYTES:
            return None
        _scratch_override = max(MIN_SCRATCH_BYTES, cur // 2)
        return _scratch_override


def release_scratch_override(holder) -> None:
    """A registered holder is done: drop the override, restoring the
    configured budget, only when the last holder releases. A holder that
    never registered changes nothing."""
    global _scratch_override
    with _scratch_lock:
        if holder in _scratch_holders:
            _scratch_holders.discard(holder)
            if not _scratch_holders:
                _scratch_override = None


def scratch_override_active() -> bool:
    """True while a degradation override is in force."""
    with _scratch_lock:
        return _scratch_override is not None


def reset_scratch_override() -> None:
    """Drop the override and every holder registration, restoring the
    configured budget."""
    global _scratch_override
    with _scratch_lock:
        _scratch_holders.clear()
        _scratch_override = None


def shuffle_join_route() -> str:
    """Planner preference for sharded-build equi-joins:
    ``auto`` (modeled-bytes choice), ``exchange`` (row all_to_all
    shuffle-hash only), or ``reduce_scatter`` (dense-slice merge onto
    owners only)."""
    v = env_str("SRT_SHUFFLE_JOIN_ROUTE", JOIN_ROUTE_AUTO).strip()
    return v if v in JOIN_ROUTES else JOIN_ROUTE_AUTO


def intra_exchange_route() -> str:
    """Route policy for 3-D meshes carrying an ``intra`` axis:
    ``auto`` (default — shard data over intra x part and run the
    hierarchical two-stage exchange) or ``flat`` (ignore the intra axis
    for data; shard over part only, the 2-D behavior)."""
    v = env_str("SRT_SHUFFLE_INTRA", "auto").strip()
    return v if v in ("auto", "flat") else "auto"


def neighborhood_size() -> int:
    """Neighbourhood size for single-axis exchanges: ``0`` (default)
    keeps the flat all_to_all; ``g >= 2`` stages the exchange through
    process subgroups of ``g`` adjacent shards (two group-scoped stages
    instead of one mesh-wide collective). A value that does not divide
    the shard count is ignored at plan time (the flat route runs)."""
    g = env_int("SRT_SHUFFLE_NEIGHBORHOOD", 0)
    return g if g >= 2 else 0


@dataclass(frozen=True)
class CommPlan:
    """One exchange's lowering, chosen on the host from static shapes.

    ``rounds == 1`` is the single-shot plan (one all_to_all per column at
    full capacity); ``rounds > 1`` stages the lane slots into ``chunk``-slot
    rounds. ``peak_scratch_bytes`` is the modeled per-device transient
    footprint (see module docstring), ``round_bytes`` the wire bytes one
    staged round moves across the whole mesh, ``total_bytes`` the full
    exchange's wire footprint (identical for every plan of the same
    geometry — staging changes *when* bytes move, never how many)."""

    capacity: int            # lane slots per (sender, receiver) pair
    n_shards: int
    rounds: int
    chunk: int               # lane slots shipped per round
    payload_bytes: int       # per-row bytes across all columns + validity
    max_col_bytes: int       # widest single column's per-row bytes
    peak_scratch_bytes: int
    round_bytes: int
    total_bytes: int
    budget: Optional[int]

    @property
    def staged(self) -> bool:
        return self.rounds > 1

    @property
    def route(self) -> str:
        return "staged" if self.staged else "single_shot"

    @property
    def fits_budget(self) -> bool:
        """True when the modeled peak respects the budget (vacuously true
        with no budget). False marks a budget the round cap could not
        honor — the plan still runs, maximally staged, and the planner
        route-counts the overrun instead of failing the query."""
        return self.budget is None or self.peak_scratch_bytes <= self.budget


def _col_bytes(col_bytes: Sequence[int]) -> "tuple[int, int]":
    """(per-row payload incl. the 1-byte validity lane, widest column)."""
    widths = [int(b) for b in col_bytes] + [1]
    return sum(widths), max(widths)


def single_shot_scratch_bytes(capacity: int, n_shards: int,
                              col_bytes: Sequence[int]) -> int:
    """Modeled per-device scratch of the unstaged exchange — the A/B
    baseline the staged plan is judged against."""
    _, max_col = _col_bytes(col_bytes)
    return 2 * n_shards * capacity * max_col


def plan_exchange(capacity: int, n_shards: int,
                  col_bytes: Sequence[int],
                  budget: Optional[int] = None,
                  max_rounds: int = MAX_STAGED_ROUNDS) -> CommPlan:
    """Lower one ``exchange_columns`` geometry into a CommPlan.

    ``capacity`` is the per-lane slot count (the lossless setting passes
    the shard-local row count), ``col_bytes`` the per-row byte width of
    each exchanged column. ``budget`` defaults to ``scratch_budget()``;
    None keeps the exchange single-shot.
    """
    capacity = max(1, int(capacity))
    n_shards = int(n_shards)
    if budget is None:
        budget = scratch_budget()
    payload, max_col = _col_bytes(col_bytes)
    total = n_shards * n_shards * capacity * payload

    def mk(chunk: int) -> CommPlan:
        chunk = max(1, min(int(chunk), capacity))
        rounds = -(-capacity // chunk)
        return CommPlan(
            capacity=capacity, n_shards=n_shards, rounds=rounds,
            chunk=chunk, payload_bytes=payload, max_col_bytes=max_col,
            peak_scratch_bytes=2 * n_shards * chunk * max_col,
            round_bytes=n_shards * n_shards * chunk * payload,
            total_bytes=total, budget=budget)

    if budget is None:
        return mk(capacity)
    # largest chunk whose widest-column send+recv pair fits the budget
    chunk = budget // (2 * n_shards * max_col)
    if chunk < 1:
        chunk = 1
    plan = mk(chunk)
    if plan.rounds > max_rounds:
        # round cap: stage as deep as allowed and report the overrun
        plan = mk(-(-capacity // max_rounds))
    return plan


# ---------------------------------------------------------------------------
# Hierarchical (two-stage) exchange plans — the topology-aware tiers
# ---------------------------------------------------------------------------
#
# The array-redistribution paper's core move: lower one n-way exchange
# into a SEQUENCE of group-scoped collectives matched to the topology.
# Both tiers here factor n = a * b and route every row in two hops —
# first within a group of ``a`` (the intra axis of a 3-D mesh, or a
# neighbourhood of ``a`` adjacent shards (a process subgroup)), then
# across the ``b`` groups. Stage 1 lanes hold ``capacity`` slots (each
# sender owns that many rows); stage 2 lanes must hold ``a * capacity``
# slots for losslessness (worst case, every row a group received targets
# one destination group) but ship them in ``chunk <= capacity`` rounds,
# so the modeled per-device peak is
#
#     max(2 * a * chunk1, 2 * b * chunk2) * max_col_bytes
#
# — strictly below the flat single-shot ``2 * n * capacity * max_col``
# whenever a, b >= 2, at the price of one extra hop's wire bytes. The
# delivered multiset of (row, destination) pairs is identical to the
# flat exchange (parallel/shuffle.exchange_columns_hier carries each
# row's final destination as an extra routed lane), so downstream
# mask-algebra results stay bit-exact.

@dataclass(frozen=True)
class HierCommPlan:
    """A two-stage exchange lowering: ``stages[0]`` routes within groups
    of ``a`` shards, ``stages[1]`` across the ``b`` groups. ``route`` is
    the tier name the distributed planner counts
    (``rel.route.shuffle.intra`` / ``rel.route.shuffle.neighborhood``)."""

    route_name: str          # "intra" | "neighborhood"
    stages: "tuple[CommPlan, CommPlan]"
    capacity: int            # per-sender row slots (stage-1 lane size)
    n_shards: int            # a * b — the logical exchange width
    payload_bytes: int
    max_col_bytes: int
    total_bytes: int         # both hops' wire footprint (padded model)
    budget: Optional[int]

    @property
    def staged(self) -> bool:
        return True

    @property
    def route(self) -> str:
        return self.route_name

    @property
    def rounds(self) -> int:
        return self.stages[0].rounds + self.stages[1].rounds

    @property
    def peak_scratch_bytes(self) -> int:
        return max(s.peak_scratch_bytes for s in self.stages)

    @property
    def flat_peak_scratch_bytes(self) -> int:
        """The flat single-shot baseline this plan is judged against —
        the smoke gates assert ``peak_scratch_bytes`` strictly below
        this at equal results."""
        return 2 * self.n_shards * self.capacity * self.max_col_bytes

    @property
    def fits_budget(self) -> bool:
        return all(s.fits_budget for s in self.stages)


def plan_exchange_hier(capacity: int, group_size: int, n_groups: int,
                       col_bytes: Sequence[int],
                       budget: Optional[int] = None,
                       route: str = "intra") -> HierCommPlan:
    """Lower one exchange over ``group_size * n_groups`` shards into the
    two-stage hierarchical plan. Stage 2's default chunk is ``capacity``
    (one stage-1 fan-in worth per round) — the staging that buys the
    strict peak reduction — shrunk further when a scratch budget
    demands it."""
    capacity = max(1, int(capacity))
    a, b = int(group_size), int(n_groups)
    if budget is None:
        budget = scratch_budget()
    payload, max_col = _col_bytes(col_bytes)
    s1 = plan_exchange(capacity, a, col_bytes, budget)
    # cap stage 2's chunk at `capacity` even with no budget in force:
    # a single-shot second stage would put the peak right back at the
    # flat exchange's 2*n*capacity*max_col
    cap2 = 2 * b * capacity * max_col
    s2 = plan_exchange(a * capacity, b, col_bytes,
                       cap2 if budget is None else min(budget, cap2))
    n = a * b
    total = (n * a * capacity * payload          # stage 1: within groups
             + n * b * (a * capacity) * payload)  # stage 2: across groups
    return HierCommPlan(
        route_name=route, stages=(s1, s2), capacity=capacity,
        n_shards=n, payload_bytes=payload, max_col_bytes=max_col,
        total_bytes=total, budget=budget)
