"""Deterministic fault injection: the chaos seams.

Port of ``spark_rapids_jni_tpu/utils/faults.py``, pure Python. The
memory-pressure kinds raise this module's ``RetryOOM`` and
``SplitAndRetryOOM`` (the reference's come from its native bridge),
which the serving layer's retry matrix classifies
(``serving/reliability.py``).

**Spec grammar** (``SRT_FAULTS``, or :func:`configure`)::

    SRT_FAULTS=seam:kind:count[,seam:kind:count...]
    SRT_FAULTS=worker:crash:1,dispatch:raise:2,alloc:retry_oom:1

Seams, where a fault fires (one ``maybe_inject`` call each):

- ``dispatch``: once a query before its run (``tpcds/rel.py``), and
  once a live morsel before its partial run (``exec/runner.py``); the
  standing accumulator is never mutated in place, so a retry replays
  bit-exact;
- ``alloc``: once a query before its run (``tpcds/rel.py``);
- ``disk``: a Parquet row group's read (``exec/disk_table.py``
  ``_decode_group``), retried in place (``io.disk.retries``);
- ``batch``: once a batched window, before its batch-cache lookup
  (``tpcds/rel.run_fused_batched``);
- ``worker``: once a fleet worker's loop turn (``serving/scheduler.py``;
  on a mesh before the slice's pick, so a crash holds no query), and
  ``respawn`` before a crashed worker's replacement;
- ``control``: every telemetry read of the control plane
  (``serving/control_plane.ControlPlane._signal``); a fault latches
  that loop to static policy;
- ``aot_load``: the kernel library's header check before it is bound
  (``ops/cuda_kernels.kernels``); a fault is a corrupt library, built
  anew;
- ``shuffle``: the reference's exchange seam, reached by nothing in the
  port.

Kinds, what fires: ``raise`` and ``corrupt`` raise
:class:`InjectedFault` (transient), ``crash`` :class:`WorkerCrash`,
``retry_oom`` :class:`RetryOOM`, ``split_oom`` :class:`SplitAndRetryOOM`.

**Determinism.** Counts are consumed in call order under one lock: a
``dispatch:raise:2`` spec faults exactly the first two dispatch-seam
calls process-wide, then disarms. Every firing increments
``serving.fault.injected.<seam>.<kind>``.

When no spec is armed, ``maybe_inject`` is one attribute read — the
production hot path pays nothing.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..config import env_str
from ..obs import count

SEAM_WORKER = "worker"
SEAM_DISPATCH = "dispatch"
SEAM_AOT_LOAD = "aot_load"
SEAM_SHUFFLE = "shuffle"
SEAM_BATCH = "batch"
SEAM_ALLOC = "alloc"
SEAM_RESPAWN = "respawn"
SEAM_CONTROL = "control"
SEAM_DISK = "disk"
SEAMS = (SEAM_WORKER, SEAM_DISPATCH, SEAM_AOT_LOAD, SEAM_SHUFFLE,
         SEAM_BATCH, SEAM_ALLOC, SEAM_RESPAWN, SEAM_CONTROL, SEAM_DISK)

KIND_RAISE = "raise"
KIND_CORRUPT = "corrupt"
KIND_CRASH = "crash"
KIND_RETRY_OOM = "retry_oom"
KIND_SPLIT_OOM = "split_oom"
KINDS = (KIND_RAISE, KIND_CORRUPT, KIND_CRASH, KIND_RETRY_OOM,
         KIND_SPLIT_OOM)


class InjectedFault(RuntimeError):
    """A deterministically injected failure. ``raise``/``corrupt`` kinds
    are TRANSIENT by contract — the reliability layer's retry matrix
    treats them as retryable (docs/RELIABILITY.md)."""

    def __init__(self, seam: str, kind: str):
        super().__init__(f"injected fault [{seam}:{kind}]")
        self.seam = seam
        self.kind = kind


class WorkerCrash(InjectedFault):
    """An injected worker-thread death. Escapes the worker loop (it is
    never handled as a per-query error) so supervision — detect,
    requeue, respawn — is what recovers, exactly like a real thread
    death."""


class RetryOOM(RuntimeError):
    """The task must free its buffers and retry from its checkpoint."""


class SplitAndRetryOOM(RuntimeError):
    """The task must split its input batch and retry."""


class _FaultPlan:
    """Parsed spec: ordered (seam, kind, remaining-count) entries."""

    __slots__ = ("entries",)

    def __init__(self, entries: "list[list]"):
        self.entries = entries  # [ [seam, kind, remaining], ... ]


_lock = threading.Lock()
_plan: Optional[_FaultPlan] = None  # guarded-by: _lock
# lock-free fast-path flag: reads are deliberately unlocked (the armed
# check is one attribute read on the production hot path)
_armed = False  # guarded-by: _lock


def parse_spec(spec: str) -> "list[tuple[str, str, int]]":
    """Parse ``seam:kind:count,...``; raises ValueError on an unknown
    seam/kind or a malformed triple — a silently ignored chaos spec
    would report a vacuous pass."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) == 2:
            bits.append("1")
        if len(bits) != 3:
            raise ValueError(f"bad fault spec {part!r} "
                             f"(want seam:kind[:count])")
        seam, kind, n = bits[0].strip(), bits[1].strip(), bits[2].strip()
        if seam not in SEAMS:
            raise ValueError(f"unknown fault seam {seam!r} "
                             f"(one of {SEAMS})")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(one of {KINDS})")
        cnt = int(n)
        if cnt < 1:
            raise ValueError(f"fault count must be >= 1: {part!r}")
        out.append((seam, kind, cnt))
    return out


def configure(spec: Optional[str]) -> None:
    """Arm (or, with None/empty, disarm) the injection plan for this
    process. Tests and the chaos smoke call this directly; production
    processes arm via ``SRT_FAULTS`` at first seam evaluation."""
    global _plan, _armed
    entries = [list(e) for e in parse_spec(spec)] if spec else []
    with _lock:
        _plan = _FaultPlan(entries) if entries else None
        _armed = _plan is not None


def reset() -> None:
    """Disarm and forget any plan (tests)."""
    global _plan, _armed, _env_loaded
    with _lock:
        _plan = None
        _armed = False
        _env_loaded = False


_env_loaded = False  # guarded-by: _lock


def _ensure_env_loaded() -> None:
    """Lazily arm from ``SRT_FAULTS`` once per process (unless a test
    already configured explicitly)."""
    global _env_loaded, _plan, _armed
    with _lock:
        if _env_loaded:
            return
        _env_loaded = True
        if _plan is not None:
            return
        spec = env_str("SRT_FAULTS", "").strip()
        if spec:
            entries = [list(e) for e in parse_spec(spec)]
            _plan = _FaultPlan(entries)
            _armed = True


def _exception_for(seam: str, kind: str) -> BaseException:
    if kind == KIND_CRASH:
        return WorkerCrash(seam, kind)
    if kind == KIND_RETRY_OOM:
        return RetryOOM(f"injected [{seam}:{kind}]")
    if kind == KIND_SPLIT_OOM:
        return SplitAndRetryOOM(f"injected [{seam}:{kind}]")
    return InjectedFault(seam, kind)


def maybe_inject(seam: str) -> None:
    """The seam hook: no-op unless an armed plan has remaining count for
    ``seam``; otherwise consume one, count
    ``serving.fault.injected.<seam>.<kind>``, and raise the mapped
    exception. First-matching-entry order makes multi-kind specs on one
    seam deterministic."""
    global _armed
    if not _armed and _env_loaded:
        return
    _ensure_env_loaded()
    if not _armed:
        return
    with _lock:
        plan = _plan
        if plan is None:
            return
        for entry in plan.entries:
            if entry[0] == seam and entry[2] > 0:
                entry[2] -= 1
                kind = entry[1]
                break
        else:
            return
        if not any(e[2] > 0 for e in plan.entries):
            # plan fully consumed: disarm so every later seam call is
            # back to the one-attribute-read fast path (the plan itself
            # is kept — remaining() still reports {} from it)
            _armed = False
    count(f"serving.fault.injected.{seam}.{kind}")
    raise _exception_for(seam, kind)


def remaining() -> "dict[tuple[str, str], int]":
    """Unconsumed injections by (seam, kind) — the chaos smoke's
    ``--fail-on-silent-fault`` gate asserts this is empty: an injection
    that never fired means the seam was never reached and the scenario
    proved nothing."""
    with _lock:
        if _plan is None:
            return {}
        out: "dict[tuple[str, str], int]" = {}
        for seam, kind, left in _plan.entries:
            if left > 0:
                out[(seam, kind)] = out.get((seam, kind), 0) + left
        return out


def armed() -> bool:
    return _armed


# ---------------------------------------------------------------------------
# Fake-device memory shim — synthetic ``memory_stats`` for CPU CI
# ---------------------------------------------------------------------------


class FakeDeviceMemory:
    """A synthetic memory-stats source for ``obs.memory.hbm_headroom_bytes``
    so the morsel budget probe (``exec/morsel.py``) runs end to end on
    the CPU, where no card reports. Tests install it, turn
    ``set_used_fraction`` between assertions, and the probe reads it as
    it would read the card. ``install`` and ``uninstall`` clear the
    memoized budget probe.
    """

    def __init__(self, n_devices: int = 1,
                 limit_bytes: int = 16 << 30):
        self.n_devices = int(n_devices)
        self.limit_bytes = int(limit_bytes)
        self._lock = threading.Lock()
        self._used = 0  # guarded-by: self._lock
        self._peak = 0  # guarded-by: self._lock

    def set_used_bytes(self, used: int) -> None:
        with self._lock:
            self._used = int(used)
            self._peak = max(self._peak, self._used)

    def set_used_fraction(self, frac: float) -> None:
        self.set_used_bytes(int(self.limit_bytes * frac))

    def read(self) -> "list":
        with self._lock:
            stat = {"bytes_in_use": self._used,
                    "peak_bytes_in_use": self._peak,
                    "bytes_limit": self.limit_bytes}
        return [dict(stat) for _ in range(self.n_devices)]

    def install(self) -> "FakeDeviceMemory":
        from ..exec.morsel import reset_morsel_budget_probe
        from ..obs import memory as _obs_memory
        _obs_memory.set_stats_source_for_testing(self.read)
        reset_morsel_budget_probe()
        return self

    def uninstall(self) -> None:
        from ..exec.morsel import reset_morsel_budget_probe
        from ..obs import memory as _obs_memory
        _obs_memory.set_stats_source_for_testing(None)
        reset_morsel_budget_probe()
