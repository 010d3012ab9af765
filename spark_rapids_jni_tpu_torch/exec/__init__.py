"""Out-of-core morsel execution: queries over fact tables larger than
the card's memory.

Port of ``spark_rapids_jni_tpu/exec/``. Fact tables stay in host memory
(:class:`HostTable`) or on disk (:class:`ParquetHostTable`); a planner
cuts them into fixed-capacity chunks (morsels) sized to
``SRT_MORSEL_BYTES`` or the card's free memory; the unchanged fused plan
folds one morsel at a time into an accumulator on the card, staged
through pinned, double-buffered host buffers and a copy stream; one
merge run finishes the query. ``rel_append`` extends a standing table,
and the next run folds only the new rows (provenance ``delta``). The
page ledger (:mod:`.pages`) accounts the paged staging window.

Entry point: ``tpcds.rel.run_fused(plan, rels, morsels=...)``: any host
table among ``rels`` routes the run here.
"""

from .disk_table import ParquetHostTable  # noqa: F401
from .host_table import HostTable, rel_append  # noqa: F401
from .morsel import (MorselPlan, morsel_bytes_budget,  # noqa: F401
                     plan_morsels, reset_morsel_budget_probe)
from .pages import (PageLease, PagePool,  # noqa: F401
                    bucket_pages, live_row_mask, occupancy_mask,
                    page_bytes, page_pool, page_pool_bytes,
                    page_pool_enabled, pages_for, ragged_capacity)
from .runner import (reset_standing_state,  # noqa: F401
                     run_morsels, standing_state_size)

__all__ = [
    "HostTable", "ParquetHostTable", "rel_append", "MorselPlan",
    "plan_morsels",
    "morsel_bytes_budget", "reset_morsel_budget_probe",
    "run_morsels", "reset_standing_state", "standing_state_size",
    "PageLease", "PagePool", "bucket_pages", "occupancy_mask",
    "live_row_mask", "page_bytes", "page_pool", "page_pool_bytes",
    "page_pool_enabled", "pages_for", "ragged_capacity",
]
