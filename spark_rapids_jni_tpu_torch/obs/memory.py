"""Device-memory accounting: measure the card, model per-query peaks.

Port of ``spark_rapids_jni_tpu/obs/memory.py``, with three jobs:

- **Sampling.** ``sample_device_memory()`` reads every CUDA device's
  ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
  ``.peak`` as ``bytes_in_use`` / ``peak_bytes_in_use``) and its total
  memory (``bytes_limit``) into the ``mem.device.<i>.*`` gauges, where
  the reference reads PJRT's ``device.memory_stats()``. The peak lasts
  for the whole process, like PJRT's, unless a caller resets it
  (``torch.cuda.reset_peak_memory_stats``). A host without a card
  reports no device.
- **The headroom probe.** ``hbm_headroom_bytes`` is what the port could
  still allocate: ``mem_get_info``'s free bytes plus the caching
  allocator's unallocated reserve (memory that is free to the port's
  next allocation, though ``mem_get_info`` counts it used: after a run
  that peaked at tens of GiB, ``mem_get_info`` alone reports a fraction
  of it). ``probed_scratch_budget`` turns it into the exchange scratch
  budget that a partitioned run's exchanges plan under when
  ``SRT_SHUFFLE_SCRATCH_BYTES`` is unset: headroom x
  ``SRT_SHUFFLE_SCRATCH_HEADROOM_FRACTION`` (default 1/4), rounded down
  to a power of two, at least ``comm_plan.MIN_SCRATCH_BYTES``, memoized.
  A device with no stats (the CPU) keeps the unlimited budget. Over a
  mesh every rank must plan the same rounds, so ``agreed_scratch_budget``
  agrees the probe once a mesh by an all-reduce of the minimum, and
  ``comm_plan.scratch_budget()`` reads only that agreed value, held for
  the run (``comm_plan.agreed_probe_scope``).
- **The per-query model.** ``query_memory_section`` assembles the
  ExecutionReport's ``memory`` section: ingest bytes + the widest
  exchange round's modeled scratch, and the measured device watermarks.

``native_arena_snapshot`` reads the native bridge's host arena
(``native.py``) once the library is loaded in the process; ``{}`` before.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch

from ..config import env_float, env_str
from .metrics import count, gauge

MEM_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

DEFAULT_HEADROOM_FRACTION = 0.25

# "no signal" in the agreement all-reduce: the minimum ignores ranks
# whose device reports nothing
_NO_SIGNAL = 1 << 62

_lock = threading.Lock()
_UNSET = object()
_probed_budget: dict = {}  # guarded-by: _lock -- device key -> budget
_agreed_budget: dict = {}  # guarded-by: _lock -- mesh key -> budget
# a test seam: a callable returning one stats dict (or None) a device
# (utils/faults.FakeDeviceMemory)
_stats_source: "Optional[Callable[[], list]]" = None  # guarded-by: _lock
# devices whose byte gauges were published: a device that stops
# reporting has them zeroed once
_published_devices: "set[int]" = set()  # guarded-by: _lock


def set_stats_source_for_testing(fn: "Optional[Callable[[], list]]"
                                 ) -> None:
    """Serve the stats from ``fn`` instead of the card (None restores
    the card), and forget the memoized probes."""
    global _stats_source
    with _lock:
        _stats_source = fn
    reset_memory_probe()


def reset_memory_probe() -> None:
    """Forget the memoized and agreed probes and the published-device
    set (tests)."""
    with _lock:
        _probed_budget.clear()
        _agreed_budget.clear()
        _published_devices.clear()


def _raw_device_stats() -> "List[Optional[dict]]":
    """One stats dict (or None) a visible CUDA device."""
    with _lock:
        src = _stats_source
    if src is not None:
        return list(src())
    if not torch.cuda.is_available():
        return []
    out: "List[Optional[dict]]" = []
    for i in range(torch.cuda.device_count()):
        try:
            st = torch.cuda.memory_stats(i)
            out.append({
                "bytes_in_use": int(st.get("allocated_bytes.all.current",
                                           0)),
                "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak",
                                                0)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory)})
        except RuntimeError:
            # a broken stats read is counted, never raised: the probe is
            # an observability path
            count("obs.memory_probe_errors")
            out.append(None)
    return out


def _normalize(raw: Optional[dict]) -> Optional[dict]:
    if not isinstance(raw, dict):
        return None
    out = {k: int(raw[k]) for k in MEM_STAT_KEYS if raw.get(k) is not None}
    if "bytes_in_use" not in out or "bytes_limit" not in out:
        return None
    return out


def sample_device_memory(publish: bool = True
                         ) -> "dict[int, Optional[dict]]":
    """Every device's normalized stats; with ``publish`` set the
    ``mem.device.<i>.*`` gauges (``reporting`` 1/0 for every device, the
    byte gauges where it reports) and ``mem.devices_reporting``."""
    stats = {i: _normalize(raw) for i, raw in enumerate(_raw_device_stats())}
    if publish:
        with _lock:
            prev = set(_published_devices)
        now_reporting = set()
        for i, s in stats.items():
            gauge(f"mem.device.{i}.reporting").set(0 if s is None else 1)
            if s is None:
                if i in prev:
                    for k in MEM_STAT_KEYS + ("headroom_bytes",):
                        gauge(f"mem.device.{i}.{k}").set(0)
                continue
            now_reporting.add(i)
            for k, v in s.items():
                gauge(f"mem.device.{i}.{k}").set(v)
            gauge(f"mem.device.{i}.headroom_bytes").set(
                max(0, s["bytes_limit"] - s["bytes_in_use"]))
        with _lock:
            _published_devices.clear()
            _published_devices.update(now_reporting)
        gauge("mem.devices_reporting").set(len(now_reporting))
    return stats


def device_memory_stats(index: int = 0) -> Optional[dict]:
    """Normalized stats of one device, or None when it reports nothing."""
    raw = _raw_device_stats()
    return _normalize(raw[index]) if index < len(raw) else None


def device_used_fraction() -> Optional[float]:
    """The largest ``bytes_in_use / bytes_limit`` over reporting devices,
    or None when none reports."""
    fracs = [s["bytes_in_use"] / s["bytes_limit"]
             for s in sample_device_memory(publish=False).values()
             if s is not None and s.get("bytes_limit")]
    return max(0.0, max(fracs)) if fracs else None


def hbm_headroom_bytes(device=None) -> Optional[int]:
    """Bytes the port could still allocate on ``device`` (default: the
    current CUDA device): ``mem_get_info``'s free bytes and the caching
    allocator's unallocated reserve. None when nothing reports: a CPU
    device, or no card. With a test source installed, the minimum
    ``bytes_limit - bytes_in_use`` over its devices, as the reference
    reads its backend."""
    with _lock:
        src = _stats_source
    if src is not None:
        heads = [s["bytes_limit"] - s["bytes_in_use"]
                 for s in map(_normalize, src()) if s is not None]
        return max(0, min(heads)) if heads else None
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free) + int(cached)


def _headroom_fraction() -> float:
    f = env_float("SRT_SHUFFLE_SCRATCH_HEADROOM_FRACTION",
                  DEFAULT_HEADROOM_FRACTION)
    return f if 0.0 < f <= 1.0 else DEFAULT_HEADROOM_FRACTION


def probed_scratch_budget(device=None) -> Optional[int]:
    """This process's headroom-derived exchange scratch budget, or None
    when ``device`` reports no memory (unlimited, as before the probe).
    Probed once a device and memoized, so the budget is as stable as an
    environment knob; a reporting device always gets a cap, at least
    ``comm_plan.MIN_SCRATCH_BYTES``."""
    key = "default" if device is None else str(device)
    with _lock:
        memo = _probed_budget.get(key, _UNSET)
    if memo is not _UNSET:
        return memo
    headroom = hbm_headroom_bytes(device)
    budget: Optional[int] = None
    if headroom is not None:
        from ..parallel.comm_plan import MIN_SCRATCH_BYTES
        raw = int(max(0, headroom) * _headroom_fraction())
        budget = (1 << (raw.bit_length() - 1) if raw >= MIN_SCRATCH_BYTES
                  else MIN_SCRATCH_BYTES)
    with _lock:
        if key not in _probed_budget:
            _probed_budget[key] = budget
            if headroom is not None:
                count("obs.memory_probe_budget")
                gauge("mem.probe.scratch_budget_bytes").set(budget)
                gauge("mem.probe.headroom_bytes").set(headroom)
        return _probed_budget[key]


def agreed_scratch_budget(key, agree: "Callable[[int], int]",
                          device=None) -> Optional[int]:
    """The probed budget every rank of a mesh uses: ``agree(local)``
    returns the minimum over the ranks (``_NO_SIGNAL`` standing for a
    rank whose device reports nothing), asked once a mesh ``key`` on
    every rank and memoized; None when no rank reports."""
    with _lock:
        if key in _agreed_budget:
            return _agreed_budget[key]
    local = probed_scratch_budget(device)
    got = int(agree(_NO_SIGNAL if local is None else int(local)))
    count("obs.memory_probe_agreed")
    with _lock:
        return _agreed_budget.setdefault(
            key, None if got >= _NO_SIGNAL else got)


def native_arena_snapshot(publish: bool = True) -> dict:
    """The native host arena's live counters (``native.arena_stats``:
    bytes_in_use, peak_bytes, outstanding_allocations, live_handles),
    published as ``mem.native.arena.*`` gauges beside the device
    watermarks. {} when the library is not loaded; a broken read is
    counted (``obs.native_ra_errors``), never silent."""
    try:
        from .. import native
        if not native.available():
            return {}
        stats = native.arena_stats()
    except Exception:
        count("obs.native_ra_errors")
        return {}
    out = {k: int(v) for k, v in stats.items()}
    if publish:
        for k, v in out.items():
            gauge(f"mem.native.arena.{k}").set(v)
    return out


def column_bytes(col) -> int:
    """Device bytes one column pins: data, packed validity, children."""
    n = 0
    if col.data is not None:
        n += int(col.data.nbytes)
    if col.validity is not None:
        n += int(col.validity.nbytes)
    for child in col.children or ():
        n += column_bytes(child)
    return n


def rel_ingest_bytes(rels: dict) -> int:
    """Device bytes pinned by one query's input tables, each rel object
    counted once; host tables (streamed) pin none."""
    seen = set()
    total = 0
    for r in rels.values():
        if id(r) in seen or getattr(r, "is_host_table", False):
            continue
        seen.add(id(r))
        for col in r.table.columns:
            total += column_bytes(col)
    return total


def query_memory_section(ingest_bytes: int, comm_scratch_bytes: int = 0,
                         batch_multiplier: int = 1,
                         sample_devices: bool = True,
                         padded_waste_bytes: int = 0) -> dict:
    """One ExecutionReport's ``memory`` section: the modeled peak (ingest
    x batch multiplier + the widest exchange round's scratch, an upper
    bound's shape, not an allocator trace), the bytes a batched window's
    pad slots pin beyond the live ones (``padded_waste_bytes``, when
    any) and the measured device watermarks."""
    modeled = int(ingest_bytes) * max(1, int(batch_multiplier)) \
        + int(comm_scratch_bytes)
    section = {"ingest_bytes": int(ingest_bytes),
               "comm_scratch_bytes": int(comm_scratch_bytes),
               "batch_multiplier": max(1, int(batch_multiplier)),
               "modeled_peak_bytes": modeled}
    if padded_waste_bytes:
        section["padded_waste_bytes"] = int(padded_waste_bytes)
    gauge("mem.modeled.query_peak_bytes").set(modeled)
    if sample_devices:
        devices = {i: s for i, s in sample_device_memory().items()
                   if s is not None}
        if devices:
            section["devices"] = {str(i): s for i, s in devices.items()}
    arena = native_arena_snapshot()
    if arena:
        section["native_arena"] = arena
    return section


def render_watermarks() -> str:
    """Human-readable memory block: each device's stats, the exchange
    scratch budget and where it comes from."""
    lines = ["memory watermarks:"]
    stats = sample_device_memory()
    reporting = {i: s for i, s in stats.items() if s is not None}
    if not reporting:
        lines.append(f"  no reporting device ({len(stats)} CUDA "
                     f"device(s) visible)")
    for i, s in sorted(reporting.items()):
        used, limit = s["bytes_in_use"], s["bytes_limit"]
        peak = s.get("peak_bytes_in_use", used)
        lines.append(
            f"  device {i}: {used / 2**20:.1f} MiB in use (peak "
            f"{peak / 2**20:.1f}) of {limit / 2**20:.1f} MiB — headroom "
            f"{max(0, limit - used) / 2**20:.1f} MiB")
    env = env_str("SRT_SHUFFLE_SCRATCH_BYTES", "").strip()
    if env:
        lines.append(f"  exchange scratch budget: {env} bytes "
                     f"(SRT_SHUFFLE_SCRATCH_BYTES)")
    else:
        budget = probed_scratch_budget()
        lines.append("  exchange scratch budget: unlimited (no env knob, "
                     "no reporting device)" if budget is None else
                     f"  exchange scratch budget: {budget} bytes (probed "
                     f"from the device's headroom; a partitioned run "
                     f"plans under the minimum over its ranks)")
    arena = native_arena_snapshot()
    if arena:
        lines.append(f"  native arena: {arena.get('bytes_in_use', 0)} "
                     f"bytes in use, peak {arena.get('peak_bytes', 0)}")
    return "\n".join(lines)
