"""The tunable knobs and their candidate ladders.

Port of ``spark_rapids_jni_tpu/tune/space.py``. Each ``TunableSpec``
names one ``SRT_*`` knob, a small static ladder of candidate spellings,
the workload it is measured on (``runner.WORKLOADS``) and its oracle:
byte-equality of the full query result against the incumbent (the
default spelling). Every candidate picks between routes or budgets that
compute the same bytes, so a measured difference is time; the runner
still checks the bytes of every candidate.

The names follow the port: ``cuda`` for the reference's ``pallas``, so
``SRT_JOIN_CUDA_MAX_CAPACITY`` is the reference's
``SRT_JOIN_PALLAS_MAX_CAPACITY`` (K1's table-capacity cap). On the card
``auto`` takes the hand kernels (K1 for joins, K2 for integral
groupbys), so the route ladders hold them against the torch routes
(``xla``, the direct-address gather; ``scatter``, ``index_add_``;
``onehot``). Forced routes that degrade on some device are not listed.
The reference's one-hot width tier (``SRT_GROUPBY_ONEHOT_MAX_WIDTH``)
has no counterpart: the port takes the one-hot route only when it is
forced, so a width tier would select nothing.

``tuned_planner_key()`` is the cache-key bridge: the active table's
digest and the resolved value of every tuned knob that shapes a plan,
appended to ``planner_env_key``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class TunableSpec:
    """One knob's search declaration. ``candidates`` are env spellings
    (the table stores strings); ``default`` reproduces the untuned
    behaviour, is always measured and is the oracle's incumbent;
    ``planner`` marks knobs whose value shapes a plan."""

    knob: str
    candidates: Tuple[str, ...]
    default: str
    workload: str
    planner: bool
    oracle: str = "byte-equal full query result vs the incumbent"
    doc: str = ""


SPECS: Tuple[TunableSpec, ...] = (
    TunableSpec(
        knob="SRT_JOIN_METHOD", candidates=("auto", "xla"), default="auto",
        workload="pipeline", planner=True,
        doc="dense-join probe route (ops/join.join_probe_method); 'auto' "
            "takes K1 on the card within its caps"),
    TunableSpec(
        knob="SRT_JOIN_CUDA_MAX_CAPACITY",
        candidates=("262144", "524288", "1048576"), default="524288",
        workload="pipeline", planner=True,
        doc="table-capacity cap of K1's route "
            "(ops/join.join_cuda_max_capacity)"),
    TunableSpec(
        knob="SRT_DENSE_GROUPBY", candidates=("auto", "scatter", "onehot"),
        default="auto", workload="pipeline", planner=True,
        doc="dense-groupby route (ops/fused_pipeline.dense_groupby_method); "
            "'auto' takes K2 on the card for integral values"),
    TunableSpec(
        knob="SRT_SHUFFLE_SCRATCH_BYTES", candidates=("", "65536", "1048576"),
        default="", workload="pipeline_mesh", planner=True,
        doc="per-device exchange scratch budget; '' keeps the probe "
            "(parallel/comm_plan.scratch_budget)"),
    TunableSpec(
        knob="SRT_SHUFFLE_NEIGHBORHOOD", candidates=("0", "2"), default="0",
        workload="pipeline_mesh4", planner=True,
        doc="neighbourhood size of single-axis exchanges; 0 = flat "
            "(parallel/comm_plan.neighborhood_size)"),
    TunableSpec(
        knob="SRT_MORSEL_HEADROOM_FRACTION",
        candidates=("0.0625", "0.125", "0.25"), default="0.125",
        workload="pipeline_morsel", planner=False,
        doc="share of the probed device headroom granted to the streamed "
            "window (exec/morsel.morsel_bytes_budget)"),
    TunableSpec(
        knob="SRT_DISK_PREFETCH_DEPTH", candidates=("1", "2", "4"),
        default="2", workload="pipeline_disk", planner=False,
        doc="row groups a Parquet table decodes ahead "
            "(exec/disk_table.ParquetHostTable)"),
    TunableSpec(
        knob="SRT_BATCH_MAX", candidates=("4", "8", "16"), default="16",
        workload="pipeline_batched", planner=False,
        doc="batched-dispatch ceiling "
            "(ops/fused_pipeline.max_batch_queries)"),
)


def spec_by_knob(knob: str) -> Optional[TunableSpec]:
    for s in SPECS:
        if s.knob == knob:
            return s
    return None


def tuned_planner_key() -> tuple:
    """The active table's digest and the resolved values of the tuned
    knobs that shape a plan, each read at its route module:
    ``planner_env_key``'s tuned part."""
    from ..config import dense_groupby_mode, join_method, tuned_str
    from ..ops.join import join_cuda_max_capacity
    from ..parallel.comm_plan import intra_exchange_route, neighborhood_size
    from .store import active_table_digest

    return (active_table_digest(), join_method(), dense_groupby_mode(),
            join_cuda_max_capacity(),
            tuned_str("SRT_SHUFFLE_SCRATCH_BYTES", ""),
            intra_exchange_route(), neighborhood_size())
