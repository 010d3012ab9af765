"""Parquet ingestion: columnar files to the port's tables.

Port of ``spark_rapids_jni_tpu/io/parquet.py``. pyarrow reads and
decodes on the host, then the Arrow interchange uploads each column
with one host-to-device copy: the card does not decode Parquet pages.

- :func:`read_parquet`: the whole file, composed from the row-group
  helpers so both tiers share one decode route; byte-equal with
  ``pq.read_table``.
- :func:`open_parquet` / :func:`read_row_group` / :func:`row_group_stats`:
  the streaming tier (``exec/disk_table.py``): a memory-mapped handle,
  one row group at a time with the column projection inside the read,
  and footer statistics without touching a data page.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from ..columnar import Table
from ..obs import REGISTRY, count, set_attrs, span
from .arrow import from_arrow


def open_parquet(path: str):
    """``path`` as a memory-mapped :class:`pyarrow.parquet.ParquetFile`:
    the footer parses now, data pages fault in as row groups are read.
    A handle is not thread-safe; ``exec/disk_table.py`` reads through
    one reader thread."""
    import pyarrow.parquet as pq

    return pq.ParquetFile(path, memory_map=True)


def read_row_group(pf, index: int, columns: Optional[Sequence[str]] = None):
    """One row group of an open handle as an Arrow table, projecting
    ``columns`` inside the read. Observes ``io.disk.read_ns`` and counts
    ``io.disk.groups_read`` and ``io.disk.bytes_read``."""
    t0 = time.perf_counter_ns()
    at = pf.read_row_group(index, columns=list(columns) if columns else None)
    REGISTRY.histogram("io.disk.read_ns").observe(time.perf_counter_ns() - t0)
    count("io.disk.groups_read")
    count("io.disk.bytes_read", at.nbytes)
    return at


def row_group_stats(pf, index: int) -> dict:
    """Footer statistics of one row group, per column, without a data
    page: ``{name: (min, max, null_count) | None}`` in the file's
    domain, and ``"__rows__"`` -> the row count. None means no usable
    min/max (the zone-map planner then folds the group); an all-NULL
    chunk without min/max reads ``(None, None, rows)``."""
    meta = pf.metadata.row_group(index)
    out: dict = {"__rows__": int(meta.num_rows)}
    for ci in range(meta.num_columns):
        col = meta.column(ci)
        name = col.path_in_schema
        st = col.statistics
        if st is None:
            out[name] = None
            continue
        nulls = int(st.null_count) if st.has_null_count else None
        if st.has_min_max:
            out[name] = (st.min, st.max, nulls)
        elif nulls is not None and nulls == meta.num_rows:
            out[name] = (None, None, nulls)
        else:
            out[name] = None
    return out


def read_parquet(path: str, columns: Optional[Sequence[str]] = None,
                 device=None) -> Table:
    """The whole file (``columns`` projected) as a ``Table`` on
    ``device`` (``cuda`` unless the caller passes another)."""
    import pyarrow as pa

    with span("io.read_parquet", path=path,
              columns=",".join(columns) if columns else "*"):
        pf = open_parquet(path)
        parts = [read_row_group(pf, g, columns)
                 for g in range(pf.metadata.num_row_groups)]
        if not parts:
            at = pf.schema_arrow.empty_table()
            if columns:
                at = at.select(list(columns))
        else:
            at = pa.concat_tables(parts).combine_chunks()
        table = from_arrow(at, device=device)
        set_attrs(rows=table.num_rows, out_columns=table.num_columns)
        return table
