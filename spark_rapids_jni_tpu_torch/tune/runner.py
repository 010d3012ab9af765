"""The tuner: measure each candidate ladder on the device, keep winners.

Port of ``spark_rapids_jni_tpu/tune/runner.py``. Each spec's workload
runs through the real path (``tpcds.rel.run_fused`` and its batched,
streamed and Parquet routes) once a candidate, the candidate installed
as the active table (``store.set_active_table``), so every run reads it
through the same tier production reads take. A candidate's cost is its
measured wall time; its result must equal the incumbent's (the spec's
default) byte for byte, or it is rejected (``tune.oracle_rejects``): a
faster wrong answer is a bug, not a winner.

Measurement: one oracle run, then ``SRT_TUNE_WARMUP`` (default 1)
untimed runs and ``SRT_TUNE_SAMPLES`` (default 3) timed ones scored by
their minimum, ``time.monotonic_ns`` around the query through its host
sync. Each run gets fresh rels, ingested before its clock starts (the
reference times the ingest with the query), unless the caller hands the
``pipeline`` workload its own (``tune(rels=...)``: the main path's tables
at their scale, shared by every run). Workloads bypass the result cache.
On the card the oracle run alone goes under
``torch.use_deterministic_algorithms``: ``index_add_``'s float atomics
change a sum's order from run to run, so without it no two runs of one
query, the incumbent's own included, are byte-equal; the mode slows the
float scatter, so the warm-up and the timed samples run with it off, as
production does. A candidate other than the default wins only when its
best time beats the default's by more than the larger of the two sample
spreads (max minus min); otherwise the default stays, counted
``tune.kept_incumbent`` (the reference takes the fastest). A knob set in
the environment is skipped, counted ``tune.env_pinned``: the
environment outranks any winner. A mesh workload needs a process group
of at least its ranks (``pipeline_mesh`` two, ``pipeline_mesh4`` four,
over gloo on the CPU); without one its knob is skipped, counted
``tune.mesh_unavailable``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import env_int, env_is_set
from ..obs import count
from . import store as _store
from .space import SPECS, TunableSpec

WORKLOADS = ("pipeline", "pipeline_mesh", "pipeline_mesh4",
             "pipeline_morsel", "pipeline_disk", "pipeline_batched")
# the ranks each mesh workload needs
_MESH_RANKS = {"pipeline_mesh": 2, "pipeline_mesh4": 4}


def tune_warmup() -> int:
    """Untimed runs a candidate before sampling (>= 0)."""
    return max(0, env_int("SRT_TUNE_WARMUP", 1))


def tune_samples() -> int:
    """Timed runs a candidate (>= 1), scored by their minimum."""
    return max(1, env_int("SRT_TUNE_SAMPLES", 3))


class _Unavailable(Exception):
    """The workload cannot run in this process (no mesh)."""


# ---------------------------------------------------------------------------
# Workloads: each returns (setup, body); setup() builds fresh inputs
# (untimed), body(inputs) returns the materialized result (timed)
# ---------------------------------------------------------------------------

def _data(sf: float):
    from ..tpcds import generate
    return generate(sf=sf, seed=7)


def _ingest(data, device):
    from ..tpcds.rel import rel_from_df
    return {name: rel_from_df(df, device=device) for name, df in data.items()}


def _workload_pipeline(sf: float, device, mesh_parts: Optional[int] = None,
                       rels: Optional[dict] = None):
    from ..tpcds import PLANS
    from ..tpcds.rel import run_fused
    data = _data(sf) if rels is None else None
    mesh = None
    if mesh_parts:
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_world_size() < mesh_parts:
            raise _Unavailable(f"needs {mesh_parts} ranks")
        from ..parallel import PART_AXIS, make_mesh
        mesh = make_mesh({PART_AXIS: mesh_parts}, device_type=device.type)

    def body(rels):
        return run_fused(PLANS["q3"], rels, device=device, mesh=mesh,
                         skip_result_cache=True).to_df()

    if rels is not None:
        return (lambda: rels), body
    return (lambda: _ingest(data, device)), body


def _workload_morsel(sf: float, device):
    from ..tpcds import PLANS
    from ..tpcds.rel import run_fused
    data = _data(sf)

    def body(rels):
        from ..exec import reset_standing_state
        # a fresh standing state: a repeated run would replay a delta
        reset_standing_state()
        return run_fused(PLANS["q3"], rels, device=device, morsels=2,
                         skip_result_cache=True).to_df()

    return (lambda: _ingest(data, device)), body


def _workload_disk(sf: float, device):
    import tempfile

    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..exec import ParquetHostTable, reset_standing_state
    from ..tpcds import PLANS
    from ..tpcds.rel import run_fused
    data = _data(sf)
    # written once: the knob is the read-ahead depth, not the layout;
    # small row groups, so the miniature streams many of them
    path = os.path.join(tempfile.mkdtemp(prefix="srt_tune_disk_"),
                        "store_sales.parquet")
    pq.write_table(pa.Table.from_pandas(data["store_sales"],
                                        preserve_index=False),
                   path, row_group_size=4096)
    dims = {k: v for k, v in data.items() if k != "store_sales"}

    def setup():
        reset_standing_state()
        rels = _ingest(dims, device)
        rels["store_sales"] = ParquetHostTable(path)
        return rels

    def body(rels):
        try:
            return run_fused(PLANS["q3"], rels, device=device,
                             skip_result_cache=True).to_df()
        finally:
            rels["store_sales"].close()

    return setup, body


def _workload_batched(sf: float, device, k: int = 4):
    from ..tpcds import PLANS
    from ..tpcds.rel import run_fused_batched
    data = _data(sf)

    def body(rels_list):
        outs = run_fused_batched(PLANS["q3"], rels_list, device=device)
        return [o.to_df() for o in outs]

    return (lambda: [_ingest(data, device) for _ in range(k)]), body


def _make_workload(name: str, sf: float, device, rels=None):
    if name == "pipeline":
        return _workload_pipeline(sf, device, rels=rels)
    if name in _MESH_RANKS:
        return _workload_pipeline(sf, device, _MESH_RANKS[name])
    if name == "pipeline_morsel":
        return _workload_morsel(sf, device)
    if name == "pipeline_disk":
        return _workload_disk(sf, device)
    if name == "pipeline_batched":
        return _workload_batched(sf, device)
    raise ValueError(f"unknown tune workload {name!r}")


# ---------------------------------------------------------------------------
# The byte oracle
# ---------------------------------------------------------------------------

def _frames(result) -> list:
    return result if isinstance(result, list) else [result]


def bytes_equal(got, want) -> bool:
    """Strict byte-equality of two workload results (frames or lists of
    frames): the same columns, dtypes and raw bytes (NaNs compare
    bitwise, object columns by value)."""
    gs, ws = _frames(got), _frames(want)
    if len(gs) != len(ws):
        return False
    for g, w in zip(gs, ws):
        if list(g.columns) != list(w.columns) or len(g) != len(w):
            return False
        for c in w.columns:
            ga, wa = g[c].to_numpy(), w[c].to_numpy()
            if ga.dtype != wa.dtype:
                return False
            if ga.dtype.kind == "O":
                if not np.array_equal(ga, wa):
                    return False
            elif ga.tobytes() != wa.tobytes():
                return False
    return True


# ---------------------------------------------------------------------------
# The measurement loop
# ---------------------------------------------------------------------------

def _measure(setup, body, warmup: int, samples: int,
             deterministic: bool) -> Tuple[object, List[int]]:
    """(the oracle run's result, the timed samples' wall ns). The oracle
    run alone goes under deterministic algorithms when asked."""
    with _deterministic(deterministic):
        result = body(setup())
    for _ in range(warmup):
        body(setup())
    times = []
    for _ in range(samples):
        inputs = setup()
        t0 = time.monotonic_ns()
        body(inputs)
        times.append(time.monotonic_ns() - t0)
        count("tune.measurements")
    return result, times


@contextlib.contextmanager
def _deterministic(on: bool):
    """Deterministic algorithms for the block (warning, not raising, on
    an operation that has none), then the previous mode."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    if on:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        if on:
            torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def _ordered_candidates(spec: TunableSpec) -> List[str]:
    """The default first: its result is the oracle."""
    return [spec.default] + [c for c in spec.candidates if c != spec.default]


def _pick_winner(default: str, times: Dict[str, int],
                 spreads: Dict[str, int]) -> str:
    """The fastest candidate when it beats the default by more than the
    larger of their spreads, else the default."""
    fastest = min(times, key=lambda c: times[c])
    if fastest == default or default not in times:
        return fastest
    margin = max(spreads[fastest], spreads[default])
    if times[default] - times[fastest] > margin:
        return fastest
    count("tune.kept_incumbent")
    return default


def tune(knobs: Optional[Iterable[str]] = None, sf: float = 0.25,
         save: bool = True, log=None, device=None,
         rels: Optional[dict] = None) -> Dict[str, dict]:
    """Tune ``knobs`` (default: every spec) on ``device`` (``cuda``
    unless the caller passes another). Returns ``{knob: {"winner",
    "times_ns", "skipped"}}``, with ``"spread_ns"`` for a measured knob. ``rels``, tables already
    ingested on ``device``, replace the ``pipeline`` workload's data of
    scale ``sf``. With ``save`` the winners are written to this
    revision's table and installed as the active table; a fresh process
    on the same revision loads them with no measurement. On a CUDA
    device the oracle runs go under deterministic algorithms (the module
    docstring)."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    wanted = set(knobs) if knobs is not None else None
    specs = [s for s in SPECS if wanted is None or s.knob in wanted]
    warmup, samples = tune_warmup(), tune_samples()
    say = log or (lambda *_: None)
    report: Dict[str, dict] = {}
    winners: Dict[str, str] = {}
    try:
        count("tune.runs")
        for spec in specs:
            if env_is_set(spec.knob):
                count("tune.env_pinned")
                say(f"{spec.knob}: pinned by env, skipped")
                report[spec.knob] = {"winner": None, "times_ns": {},
                                     "skipped": "env_pinned"}
                continue
            try:
                setup, body = _make_workload(spec.workload, sf, dev, rels)
            except _Unavailable as e:
                count("tune.mesh_unavailable")
                say(f"{spec.knob}: {spec.workload} {e}, skipped")
                report[spec.knob] = {"winner": None, "times_ns": {},
                                     "skipped": "mesh_unavailable"}
                continue
            times: Dict[str, int] = {}
            spreads: Dict[str, int] = {}
            incumbent = None
            for cand in _ordered_candidates(spec):
                _store.set_active_table({**winners, spec.knob: cand})
                result, ns = _measure(setup, body, warmup, samples,
                                      dev.type == "cuda")
                if incumbent is None:
                    incumbent = result
                elif not bytes_equal(result, incumbent):
                    count("tune.oracle_rejects")
                    say(f"{spec.knob}={cand}: oracle reject (result "
                        f"differs from the incumbent's)")
                    continue
                times[cand], spreads[cand] = min(ns), max(ns) - min(ns)
                say(f"{spec.knob}={cand}: {times[cand] / 1e6:.3f} ms "
                    f"(spread {spreads[cand] / 1e6:.3f} ms over "
                    f"{len(ns)})")
            winner = _pick_winner(spec.default, times, spreads)
            winners[spec.knob] = winner
            count("tune.winners")
            report[spec.knob] = {"winner": winner, "times_ns": times,
                                 "spread_ns": spreads, "skipped": None}
            say(f"{spec.knob}: winner {winner!r}")
    finally:
        # no trial table outlives the run
        _store.set_active_table(None)
    if save and winners:
        _store.store_table(
            winners, measurements={k: r["times_ns"] for k, r in report.items()
                                   if r["winner"] is not None})
        _store.set_active_table(winners)
    return report
