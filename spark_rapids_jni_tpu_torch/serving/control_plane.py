"""SLO-driven control plane: four feedback loops over live telemetry.

Port of ``spark_rapids_jni_tpu/serving/control_plane.py``. Each loop
consumes one telemetry family and drives one existing seam, so the
fleet degrades before it fails:

1. **Predictive shedding** (``shed_verdict``, at
   ``FleetScheduler.submit`` and ``QueryExecutor.submit``). For a
   submission with a deadline, the tenant x priority window's execute
   quantiles predict ``queue_wait + execute``; when that passes the
   deadline the query sheds at admission as ``QueryShed``, counted
   ``serving.shed.predicted``. A per-(tenant, priority) hysteresis band
   (``SRT_CONTROL_SHED_ENTER`` / ``_EXIT``) keeps it from flapping, and
   below ``SRT_CONTROL_MIN_SAMPLES`` samples a window is cold and never
   sheds.
2. **Batch tuning** (``tune_batch``, at ``FleetScheduler._next_batch``).
   The arrival-gap EWMA (``serving/batcher.py``) and the execute p50
   pick the capacity rung worth waiting for, and the window is that
   rung's expected fill time.
3. **Memory pressure** (``check_memory``, ``memory_verdict``). Above the
   high-water used fraction (``obs/memory.device_used_fraction``: the
   caching allocator's allocated bytes over the card's memory) the
   exchange scratch budget shrinks a tier
   (``comm_plan.shrink_scratch_budget``, held by the caller) and the
   batch ceiling halves, counted ``serving.control.mem.*``; below the
   low-water mark both are restored. ``check_memory`` is
   ``memory_action`` (the decision) then ``apply_memory_action`` (the
   scratch budget), split so that ranks of a mesh slice apply one
   agreed decision. ``memory_verdict`` (``SRT_CONTROL_MEM_ADMIT=1``)
   sheds at admission a query whose modeled ingest bytes exceed the
   headroom ``torch.cuda.mem_get_info`` reports.
4. **Autoscaling** (``desired_workers``, applied by
   ``FleetScheduler._maybe_autoscale``). The fleet's queue-wait p90
   against ``SRT_CONTROL_QUEUE_WAIT_SLO_MS`` grows or shrinks the live
   workers between a floor and a ceiling; within
   ``SRT_CONTROL_SCALE_COOLDOWN_S`` of a worker crash it holds
   (``serving.control.scale.held``).

**Fail safe.** Every telemetry read goes through ``_signal`` on the
``control`` fault seam (``utils/faults.py``): any failure is counted
(``serving.control.telemetry_errors``,
``serving.control.fallback.<loop>``), latches that loop to static policy
for ``SRT_CONTROL_FAULT_COOLDOWN_S`` and reads as no signal. A loop may
fall back to static policy on bad telemetry; it never sheds, scales or
shrinks on it. Cold windows and devices without memory stats (the CPU)
are no signal too.

Off unless ``SRT_CONTROL_PLANE=1``; the per-loop knobs are
``SRT_CONTROL_{SHED,BATCH,MEM,SCALE}``. Every decision is a
``serving.control.*`` counter or gauge and a flight-recorder event.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..config import env_bool, env_float, env_int
from ..obs import count, gauge
from ..obs import flight as _flight
from ..obs import slo as _slo
from ..utils import faults as _faults

LOOP_SHED = "shed"
LOOP_BATCH = "batch"
LOOP_MEM = "mem"
LOOP_SCALE = "scale"
LOOPS = (LOOP_SHED, LOOP_BATCH, LOOP_MEM, LOOP_SCALE)


def enabled() -> bool:
    """The master switch, ``SRT_CONTROL_PLANE``. Off, every caller keeps
    its static policy with no added work on the submit path."""
    return env_bool("SRT_CONTROL_PLANE", False)


def _env_on(name: str) -> bool:
    return env_bool(name, True)


@dataclass(frozen=True)
class ControlPolicy:
    """The control plane's knobs, resolved once at construction.
    Per-loop booleans let an operator run one loop alone."""

    shed_on: bool = True           # SRT_CONTROL_SHED
    batch_on: bool = True          # SRT_CONTROL_BATCH
    mem_on: bool = True            # SRT_CONTROL_MEM
    scale_on: bool = True          # SRT_CONTROL_SCALE
    # below this many execute samples in the live windows a
    # (tenant, priority) key is COLD: no prediction, no shed, static
    # batch walk — the no-signal fail-safe floor
    min_samples: int = 16          # SRT_CONTROL_MIN_SAMPLES
    # hysteresis band: start shedding when predicted > deadline * enter,
    # stop when predicted < deadline * exit (exit < enter, or the loop
    # flaps one shed per admission around the threshold)
    shed_enter: float = 1.0        # SRT_CONTROL_SHED_ENTER
    shed_exit: float = 0.7         # SRT_CONTROL_SHED_EXIT
    mem_high: float = 0.85         # SRT_CONTROL_MEM_HIGH_WATER
    mem_low: float = 0.60          # SRT_CONTROL_MEM_LOW_WATER
    mem_interval_s: float = 1.0    # SRT_CONTROL_MEM_INTERVAL_S
    queue_wait_slo_ms: float = 100.0  # SRT_CONTROL_QUEUE_WAIT_SLO_MS
    scale_interval_s: float = 1.0  # SRT_CONTROL_SCALE_INTERVAL_S
    crash_cooldown_s: float = 10.0  # SRT_CONTROL_SCALE_COOLDOWN_S
    fault_cooldown_s: float = 30.0  # SRT_CONTROL_FAULT_COOLDOWN_S
    scale_min: Optional[int] = None  # SRT_CONTROL_SCALE_MIN
    scale_max: Optional[int] = None  # SRT_CONTROL_SCALE_MAX

    @staticmethod
    def from_env() -> "ControlPolicy":
        enter = max(0.1, env_float("SRT_CONTROL_SHED_ENTER", 1.0))
        return ControlPolicy(
            shed_on=_env_on("SRT_CONTROL_SHED"),
            batch_on=_env_on("SRT_CONTROL_BATCH"),
            mem_on=_env_on("SRT_CONTROL_MEM"),
            scale_on=_env_on("SRT_CONTROL_SCALE"),
            min_samples=max(1, env_int("SRT_CONTROL_MIN_SAMPLES", 16)),
            shed_enter=enter,
            # exit must sit at or below enter, or the band would
            # re-admit one doomed query per shed — the exact flapping
            # hysteresis exists to prevent
            shed_exit=min(enter,
                          max(0.0,
                              env_float("SRT_CONTROL_SHED_EXIT", 0.7))),
            mem_high=env_float("SRT_CONTROL_MEM_HIGH_WATER", 0.85),
            mem_low=env_float("SRT_CONTROL_MEM_LOW_WATER", 0.60),
            mem_interval_s=max(
                0.0, env_float("SRT_CONTROL_MEM_INTERVAL_S", 1.0)),
            queue_wait_slo_ms=max(
                0.001, env_float("SRT_CONTROL_QUEUE_WAIT_SLO_MS", 100.0)),
            scale_interval_s=max(
                0.0, env_float("SRT_CONTROL_SCALE_INTERVAL_S", 1.0)),
            crash_cooldown_s=max(
                0.0, env_float("SRT_CONTROL_SCALE_COOLDOWN_S", 10.0)),
            fault_cooldown_s=max(
                0.0, env_float("SRT_CONTROL_FAULT_COOLDOWN_S", 30.0)),
            scale_min=env_int("SRT_CONTROL_SCALE_MIN", None),
            scale_max=env_int("SRT_CONTROL_SCALE_MAX", None))


class ControlPlane:
    """One serving lifetime's control loops (a FleetScheduler or
    QueryExecutor constructs one iff :func:`enabled`). ``tracker`` and
    ``_clock`` are test seams (a private SloTracker with a fake clock
    makes every verdict deterministic); production instances read the
    process-global ``obs.slo.TRACKER`` the scheduler/executor already
    stamp."""

    def __init__(self, name: str = "fleet", n_workers: int = 1,
                 tracker: Optional[_slo.SloTracker] = None,
                 policy: Optional[ControlPolicy] = None,
                 _clock=time.monotonic):
        self.name = name
        self.policy = policy or ControlPolicy.from_env()
        self._tracker = tracker if tracker is not None else _slo.TRACKER
        self._clock = _clock
        self._lock = threading.Lock()
        # loop -> latch expiry (monotonic s): a loop that saw a garbage
        # telemetry read is pinned to static policy until the cooldown
        self._latched: "dict[str, float]" = {}  # guarded-by: self._lock
        # (tenant, priority) -> currently inside the shedding band
        self._shedding: "dict[tuple, bool]" = {}  # guarded-by: self._lock
        # memory-pressure batch-capacity ceiling (None = unconstrained)
        self._mem_cap_limit: Optional[int] = None  # guarded-by: self._lock
        self._mem_degraded = False  # guarded-by: self._lock
        self._last_mem = float("-inf")  # guarded-by: self._lock
        self._last_scale = float("-inf")  # guarded-by: self._lock
        self._last_batch_cap: Optional[int] = None  # guarded-by: self._lock
        self.floor = max(1, self.policy.scale_min or 1)
        self.ceiling = max(self.floor,
                           self.policy.scale_max
                           if self.policy.scale_max is not None
                           else max(1, int(n_workers)))
        gauge("serving.control.enabled").set(1)

    # -- the fail-safe signal wrapper --------------------------------------

    def latched(self, loop: str) -> bool:
        """True while ``loop`` is pinned to static policy after a
        telemetry fault."""
        now = self._clock()
        with self._lock:
            exp = self._latched.get(loop)
            if exp is None:
                return False
            if now < exp:
                return True
            del self._latched[loop]
            return False

    def _signal(self, loop: str, fn, *args):
        """Run one telemetry read for ``loop`` through the ``control``
        chaos seam with the fail-safe contract: ANY failure (an injected
        garbage read, a broken backend, a bug in the read itself) is
        counted, latches the loop to static policy for
        ``fault_cooldown_s``, and resolves to None — no signal. A
        control loop may degrade on bad telemetry; it may never act on
        it."""
        if self.latched(loop):
            return None
        try:
            _faults.maybe_inject(_faults.SEAM_CONTROL)
            return fn(*args)
        except Exception:
            count("serving.control.telemetry_errors")
            count(f"serving.control.fallback.{loop}")
            with self._lock:
                self._latched[loop] = (self._clock()
                                       + self.policy.fault_cooldown_s)
            _flight.note("control_fault", control=self.name, loop=loop)
            return None

    def _execute_stats(self, tenant: str,
                       priority: int) -> Optional[dict]:
        return self._tracker.latency_stats(_slo.KIND_EXECUTE, tenant,
                                           int(priority))

    def _queue_wait_stats(self) -> Optional[dict]:
        return self._tracker.latency_stats(_slo.KIND_QUEUE_WAIT)

    # -- loop 1: predictive shedding ---------------------------------------

    def shed_verdict(self, tenant: str, priority: int,
                     deadline_s: Optional[float], depth_ahead: int,
                     workers: int) -> Optional[int]:
        """Admission verdict for one deadline-carrying submission: the
        predicted ``queue_wait + execute`` in ns when the query should
        shed NOW, else None (admit). ``deadline_s`` is seconds from now
        until the submission's deadline; ``depth_ahead`` the queued
        items that would dispatch before it (its own class and above);
        ``workers`` the live workers draining them.

        Prediction: ``depth_ahead * execute_p50 / workers`` of queue
        wait plus this query's own ``execute_p90`` — both conservative
        log2-bucket upper bounds (obs/slo.py), the right bias for a
        shed decision. Cold windows (< ``min_samples``) and latched/
        faulted signals return None: the static dequeue-time expiry
        remains the only deadline enforcement."""
        if not self.policy.shed_on or deadline_s is None:
            return None
        key = (tenant, int(priority))
        stats = self._signal(LOOP_SHED, self._execute_stats, tenant,
                             priority)
        if stats is None or stats["count"] < self.policy.min_samples:
            # no signal: clear any stale band state and never shed
            with self._lock:
                self._shedding.pop(key, None)
            return None
        wait_ns = depth_ahead * stats["p50_ns"] // max(1, workers)
        predicted_ns = wait_ns + stats["p90_ns"]
        deadline_ns = max(0.0, deadline_s) * 1e9
        with self._lock:
            active = self._shedding.get(key, False)
            if active:
                if predicted_ns < deadline_ns * self.policy.shed_exit:
                    self._shedding[key] = active = False
            elif predicted_ns > deadline_ns * self.policy.shed_enter:
                self._shedding[key] = active = True
                _flight.note("control_shed", control=self.name,
                             tenant=tenant, priority=int(priority),
                             predicted_ms=round(predicted_ns / 1e6, 3),
                             deadline_ms=round(deadline_ns / 1e6, 3),
                             depth_ahead=int(depth_ahead))
        if not active:
            return None
        gauge("serving.control.shed.predicted_ms").set(
            round(predicted_ns / 1e6, 3))
        return int(predicted_ns)

    # -- loop 2: SLO-aware batch tuning ------------------------------------

    def tune_batch(self, tenant: str, priority: int, capacity: int,
                   window_s: float, gap_s: Optional[float],
                   max_window_s: float) -> "tuple[int, float]":
        """Pick the batch capacity rung and coalescing window for the
        batch being formed, from the arrival-gap EWMA plus the observed
        execute p50 — batch while the device would be busy anyway:
        the rung is the arrivals expected within one execute p50
        (snapped DOWN the ``BATCH_CAPACITIES`` ladder, never above the
        static ``capacity``), the window that rung's expected fill time.
        No signal (cold window, no arrival history, loop off/latched)
        returns the static ``(capacity, window_s)`` walk unchanged.
        The memory-pressure ceiling (loop 3) caps the result either
        way."""
        if not self.policy.batch_on or capacity <= 1:
            return self._mem_capped(capacity), window_s
        stats = self._signal(LOOP_BATCH, self._execute_stats, tenant,
                             priority)
        if (stats is None or stats["count"] < self.policy.min_samples
                or not gap_s or gap_s <= 0):
            return self._mem_capped(capacity), window_s
        from ..ops.fused_pipeline import BATCH_CAPACITIES

        exec_s = stats["p50_ns"] / 1e9
        want = 1 + int(exec_s // gap_s)
        cap = 1
        for c in BATCH_CAPACITIES:
            if c <= min(want, capacity):
                cap = c
        cap = self._mem_capped(cap)
        win = (0.0 if cap <= 1
               else min(max(0.0, max_window_s), gap_s * (cap - 1)))
        count("serving.control.batch.tuned")
        gauge("serving.control.batch.capacity").set(cap)
        with self._lock:
            changed = cap != self._last_batch_cap
            self._last_batch_cap = cap
        if changed:
            _flight.note("control_batch", control=self.name,
                         capacity=cap,
                         window_ms=round(win * 1e3, 3))
        return cap, win

    def _mem_capped(self, capacity: int) -> int:
        with self._lock:
            lim = self._mem_cap_limit
        if lim is None:
            return capacity
        return max(1, min(capacity, lim))

    # -- loop 3: memory-pressure proactive degradation ---------------------

    def check_memory(self, holder, static_cap: int) -> None:
        """Rate-limited pressure check over the device-memory readings:
        ``memory_action`` decides, ``apply_memory_action`` shrinks or
        restores the scratch budget for ``holder``. Counted
        ``serving.control.mem.*``, apart from the reactive
        ``serving.fault.oom.*`` family. No reporting device (the CPU) is
        no signal and no action."""
        self.apply_memory_action(self.memory_action(static_cap), holder)

    def memory_action(self, static_cap: int) -> Optional[str]:
        """The memory loop's decision, rate-limited to
        ``mem_interval_s``: ``"shrink"`` at or above the high-water used
        fraction (the batch ceiling halves here, counted
        ``serving.control.mem.batch_halved``), ``"restore"`` at or below
        the low-water mark after a degradation (the ceiling lifts), else
        None."""
        if not self.policy.mem_on:
            return None
        now = self._clock()
        with self._lock:
            if now - self._last_mem < self.policy.mem_interval_s:
                return None
            self._last_mem = now
        from ..obs import memory as _memory

        frac = self._signal(LOOP_MEM, _memory.device_used_fraction)
        if frac is None:
            return None
        gauge("serving.control.mem.used_fraction").set(round(frac, 4))
        if frac >= self.policy.mem_high:
            with self._lock:
                cur = (self._mem_cap_limit if self._mem_cap_limit
                       is not None else max(1, int(static_cap)))
                new = max(1, cur // 2)
                changed = new != self._mem_cap_limit
                self._mem_cap_limit = new
                self._mem_degraded = True
            if changed:
                count("serving.control.mem.batch_halved")
                _flight.note("mem_pressure", control=self.name,
                             used_fraction=round(frac, 4), batch_cap=new)
            return "shrink"
        if frac <= self.policy.mem_low:
            with self._lock:
                degraded = self._mem_degraded
                self._mem_cap_limit = None
                self._mem_degraded = False
            if degraded:
                _flight.note("mem_recovered", control=self.name,
                             used_fraction=round(frac, 4))
                return "restore"
        return None

    @staticmethod
    def apply_memory_action(action: Optional[str], holder) -> None:
        """Apply a ``memory_action`` decision: ``"shrink"`` halves the
        exchange scratch budget one tier for ``holder`` (counted
        ``serving.control.mem.scratch_shrunk`` when it shrank),
        ``"restore"`` releases ``holder`` (the configured budget returns
        with the last holder's release), counted
        ``serving.control.mem.restored``."""
        if action is None:
            return
        from ..parallel import comm_plan as _comm

        if action == "shrink":
            if _comm.shrink_scratch_budget(holder=holder) is not None:
                count("serving.control.mem.scratch_shrunk")
        elif action == "restore":
            _comm.release_scratch_override(holder)
            count("serving.control.mem.restored")

    def memory_verdict(self, modeled_bytes: int
                       ) -> "Optional[tuple[int, int]]":
        """Admission gate of loop 3: the modeled per-query device bytes
        (``obs/memory.rel_ingest_bytes``) against the live headroom
        (``obs/memory.hbm_headroom_bytes``). Returns ``(modeled,
        headroom)`` when the query should shed at admission, else None.
        Opt-in via ``SRT_CONTROL_MEM_ADMIT=1``;
        ``SRT_CONTROL_MEM_ADMIT_FRACTION`` (default 1.0) scales the
        admissible share of headroom. The out-of-core route (morsels) is
        the relief: a query shed here can stream instead. No reporting
        device is no signal: admit."""
        if not self.policy.mem_on or modeled_bytes <= 0:
            return None
        if not env_bool("SRT_CONTROL_MEM_ADMIT", False):
            return None
        from ..obs import memory as _memory
        headroom = self._signal(LOOP_MEM, _memory.hbm_headroom_bytes)
        if headroom is None:
            return None
        frac = env_float("SRT_CONTROL_MEM_ADMIT_FRACTION", 1.0)
        if not (0.0 < frac <= 1.0):
            frac = 1.0
        if modeled_bytes > int(headroom * frac):
            count("serving.control.mem.admission_denied")
            _flight.note("mem_admission_denied", control=self.name,
                         modeled_bytes=int(modeled_bytes),
                         headroom_bytes=int(headroom))
            return int(modeled_bytes), int(headroom)
        return None

    # -- loop 4: worker auto-scaling ---------------------------------------

    def desired_workers(self, live: int, queued: int,
                        last_crash_monotonic: float) -> Optional[int]:
        """Target live-worker count against the fleet-wide queue-wait
        SLO, or None (no change / no signal). Grows one worker at a
        time when the observed queue-wait p90 exceeds the SLO with a
        real backlog (below the ceiling); retires one when the fleet is
        idle and the p90 sits under half the SLO (above the floor).
        HOLDS — counted ``serving.control.scale.held`` — inside the
        crash cooldown: while supervision is respawning/quarantining,
        the autoscaler stays out of the thread pool."""
        if not self.policy.scale_on:
            return None
        now = self._clock()
        with self._lock:
            if now - self._last_scale < self.policy.scale_interval_s:
                return None
            self._last_scale = now
        if now - last_crash_monotonic < self.policy.crash_cooldown_s:
            # inside the rate limit, not before it: the held counter
            # counts WITHHELD VERDICTS (one per decision cadence), not
            # raw submit traffic during the cooldown
            count("serving.control.scale.held")
            return None
        stats = self._signal(LOOP_SCALE, self._queue_wait_stats)
        if stats is None or stats["count"] < self.policy.min_samples:
            return None
        slo_ns = self.policy.queue_wait_slo_ms * 1e6
        if (stats["p90_ns"] > slo_ns and queued > 0
                and live < self.ceiling):
            return live + 1
        if (stats["p90_ns"] < slo_ns / 2 and queued == 0
                and live > self.floor):
            return live - 1
        return None


def maybe_control_plane(name: str, n_workers: int = 1,
                        **kw) -> Optional[ControlPlane]:
    """A ControlPlane when the master switch is on, else None — the one
    construction gate every serving lifetime uses, so "control plane
    off" is a single attribute-is-None check on the hot paths."""
    if not enabled():
        return None
    return ControlPlane(name=name, n_workers=n_workers, **kw)


def new_gloo_group(ranks):
    """A gloo process group over ``ranks`` (global ranks). Every rank of
    the default group must call this, in the same order, for every group
    (``torch.distributed.new_group``'s rule); the CPU transport carries
    host-side verdicts beside a NCCL default group on the card. Its
    collectives time out as the default group's do
    (``parallel.distributed.group_timeout``)."""
    import torch.distributed as dist

    from ..parallel.distributed import group_timeout

    return dist.new_group(ranks=[int(r) for r in ranks], backend="gloo",
                          timeout=group_timeout())


class RankAgreement:
    """One verdict a call, agreed across the ranks of a mesh: the mesh's
    first rank decides and a broadcast over a gloo group of the mesh's
    ranks hands its verdict to every rank. Every rank calls ``decide`` in
    the same order from one thread (the submission order a mesh's
    callers already keep); the group serves nothing else, so its
    broadcasts never interleave with another thread's collectives."""

    def __init__(self, mesh):
        import torch.distributed as dist

        ranks = [int(r) for r in mesh.ranks.reshape(-1)]
        self.src = ranks[0]
        self.leader = dist.get_rank() == self.src
        self.group = new_gloo_group(ranks)

    def decide(self, verdict):
        """The leader's ``verdict`` on every rank (others pass anything)."""
        import torch.distributed as dist

        buf = [verdict]
        dist.broadcast_object_list(buf, src=self.src, group=self.group)
        return buf[0]
