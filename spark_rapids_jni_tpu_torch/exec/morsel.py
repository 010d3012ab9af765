"""The morsel planner: size fixed-capacity row chunks to a byte budget.

Port of ``spark_rapids_jni_tpu/exec/morsel.py``, the same arithmetic:

- **One capacity a streamed table, a power of two.** Every morsel of a
  table, and every later ``rel_append`` delta, has the same row
  capacity, so the standing accumulator and the entry cache of the
  runner keep one layout. On a mesh the capacity rounds up to a multiple
  of the shard count so each rank stages an equal slice.
- **The budget.** ``SRT_MORSEL_BYTES`` when set; otherwise
  ``SRT_MORSEL_HEADROOM_FRACTION`` (default 1/8) of the card's free
  memory (``obs.memory.hbm_headroom_bytes``, from
  ``torch.cuda.mem_get_info``), floored to a power of two and memoized
  for the process: the value sets the capacities, so it must be as
  stable as a knob. No knob and no card (the CPU) means no budget, and
  no streaming unless a morsel count is forced.
- **The window model.** The budget governs the streamed working set,
  the double-buffered chunk window ``2 x sum(cap_t x row_bytes_t)``
  (morsel k computes while k+1 copies) plus the accumulator. Capacities
  halve until the window fits; a budget that cannot be met at the floor
  runs anyway and counts ``rel.morsel_budget_unmet``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..config import env_float, env_int
from ..obs import count, gauge

# Share of the probed free device memory granted to the streamed window
# when SRT_MORSEL_BYTES is unset: the window shares that memory with the
# resident tables, the accumulator and the exchange scratch.
DEFAULT_HEADROOM_FRACTION = 0.125

# Floor on a budget-derived capacity; a forced morsel count may go below.
MIN_MORSEL_ROWS = 8

_UNSET = object()
_lock = threading.Lock()
# memoized probed budget a device (the env override is read live)
_probed_budget: dict = {}  # guarded-by: _lock


# the budget a mesh's ranks agreed on, a mesh (agreed_budget)
_agreed: dict = {}  # guarded-by: _lock


def reset_morsel_budget_probe() -> None:
    """Forget the memoized probed budget (tests: a live re-probe would
    change the capacities under the standing state)."""
    with _lock:
        _probed_budget.clear()
        _agreed.clear()


def agreed_budget(budget: Optional[int], key, agree) -> Optional[int]:
    """The budget every rank of a mesh uses: ``agree(local)`` returns the
    minimum of the ranks' values (0 standing for no signal), asked once a
    mesh ``key`` and memoized like the probe. The capacities, the morsel
    count and every collective of the run follow from it, so the ranks
    must read it alike."""
    with _lock:
        if key in _agreed:
            return _agreed[key]
    got = int(agree(int(budget or 0)))
    count("exec.morsel.budget_agreed")
    with _lock:
        return _agreed.setdefault(key, got or None)


def morsel_bytes_budget(device=None) -> Optional[int]:
    """The streamed window's byte budget: ``SRT_MORSEL_BYTES`` when set
    (> 0), else the memoized probe of ``device`` (default: the current
    card), else None (no signal: streaming happens only when a morsel
    count is forced)."""
    env = env_int("SRT_MORSEL_BYTES", 0)
    if env and env > 0:
        return env
    key = "default" if device is None else str(device)
    with _lock:
        memo = _probed_budget.get(key, _UNSET)
    if memo is not _UNSET:
        return memo
    from ..obs.memory import hbm_headroom_bytes
    headroom = hbm_headroom_bytes(device)
    budget: Optional[int] = None
    if headroom is not None and headroom > 0:
        f = env_float("SRT_MORSEL_HEADROOM_FRACTION",
                      DEFAULT_HEADROOM_FRACTION)
        if not (0.0 < f <= 1.0):
            f = DEFAULT_HEADROOM_FRACTION
        raw = int(headroom * f)
        if raw > 0:
            budget = 1 << (raw.bit_length() - 1)  # pow2 floor
    with _lock:
        if key not in _probed_budget:
            _probed_budget[key] = budget
            if budget is not None:
                gauge("mem.probe.morsel_budget_bytes").set(budget)
        return _probed_budget[key]


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


@dataclass
class MorselPlan:
    """One run's streaming layout: which tables stream, at what
    capacity, and the modeled streamed window."""

    capacities: Dict[str, int]          # rows a morsel, a table
    budget_bytes: Optional[int]
    window_bytes: int                   # 2 x sum(cap x row_bytes)
    budget_unmet: bool = False
    forced: Optional[int] = None
    row_bytes: Dict[str, int] = field(default_factory=dict)

    def n_morsels(self, rows: "Dict[str, int]",
                  folded: "Optional[Dict[str, int]]" = None) -> int:
        """Chunks to cover ``rows`` past the folded prefix: the maximum
        over tables, so a table with fewer chunks contributes all-dead
        tail morsels (the merge identity)."""
        m = 0
        for name, cap in self.capacities.items():
            left = rows[name] - (folded or {}).get(name, 0)
            m = max(m, -(-max(0, left) // cap))
        return max(1, m)


def plan_morsels(stream: dict, budget: Optional[int],
                 force_min: Optional[int] = None,
                 mesh_parts: int = 1) -> Optional[MorselPlan]:
    """Each streamed table's capacity (see the module docstring), or
    None when nothing calls for streaming: no budget and no forced
    count, or every table fits the budget whole (the in-core verdict)."""
    if not stream:
        return None
    if budget is None and not force_min:
        return None
    rb = {name: max(1, ht.row_bytes) for name, ht in stream.items()}
    rows = {name: ht.num_rows for name, ht in stream.items()}
    caps: Dict[str, int] = {}
    if force_min:
        for name, ht in stream.items():
            want = -(-max(1, rows[name]) // max(1, int(force_min)))
            cap = _pow2_ceil(want)
            if force_min > 1 and -(-rows[name] // cap) < force_min:
                cap = max(1, cap // 2)  # snap down: >= forced morsels
            caps[name] = cap
    else:
        total_bytes = sum(rb[n] * rows[n] for n in stream)
        if total_bytes * 2 <= budget:
            return None  # fits in-core under the double-buffer model
        share = max(1, budget // (2 * len(stream)))
        for name in stream:
            caps[name] = max(_pow2_floor(max(1, share // rb[name])),
                             MIN_MORSEL_ROWS)
    # never a chunk larger than the table (pow2-ceiled: a whole-table
    # chunk stays one morsel)
    for name in caps:
        caps[name] = min(caps[name], _pow2_ceil(max(1, rows[name])))
    if mesh_parts > 1:
        for name in caps:
            cap = max(caps[name], mesh_parts)
            caps[name] = -(-cap // mesh_parts) * mesh_parts
    floor = 1 if force_min else MIN_MORSEL_ROWS

    def window() -> int:
        return 2 * sum(caps[n] * rb[n] for n in caps)

    unmet = False
    if budget is not None:
        while window() > budget:
            # halve the largest byte contributor first; stop at the floor
            name = max(caps, key=lambda n: caps[n] * rb[n])
            nxt = caps[name] // 2
            if mesh_parts > 1:
                nxt = max(nxt, mesh_parts)
            if nxt < max(floor, 1) or nxt == caps[name]:
                unmet = True
                break
            caps[name] = nxt
        if unmet:
            count("rel.morsel_budget_unmet")
    return MorselPlan(capacities=caps, budget_bytes=budget,
                      window_bytes=window(), budget_unmet=unmet,
                      forced=force_min, row_bytes=rb)
