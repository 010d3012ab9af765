"""Host-resident streaming tables: the ingest side of morsel execution.

Port of ``spark_rapids_jni_tpu/exec/host_table.py``. A :class:`HostTable`
is the out-of-core counterpart of ``rel_from_df``, with the same
encodings (numeric columns as they are, int32 widened to int64,
dictionary-encoded strings over a sorted category array so code order
is string order, DECIMAL64 unscaled ingest), but its buffers stay in
host memory as numpy arrays. The card only ever holds a capacity-sized
window of the rows (``exec/runner.py``), so the table may be larger
than the card's memory.

Two facts the runner leans on:

- **Exact declared stats.** ``value_range`` of each integral column is
  computed over the whole host data at ingest (padded outward on a
  power-of-two grid, so appends inside the pad keep the layout) and
  merged on every append; a chunk is a subset of the rows, so its
  columns carry the range as trusted and the dense routes engage with
  no device check. Uniqueness is dropped after an append: a streamed
  table is never a dense build side.
- **An append-only ingest log.** Every ingest batch records ``(start,
  stop, token)``, the token a sha1 of the batch's encoded bytes and the
  dictionaries. The standing-query state of the runner is keyed on the
  token prefix, so ``rel_append`` invalidates per batch and a rebuilt
  table shows as a diverged prefix.

An append that grows a string column's dictionary re-encodes the column
(the sorted-dictionary invariant moves codes) and resets the log to one
batch, counted ``rel.morsel_dict_rebuilds``.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from ..columnar import Column, Table
from ..columnar.column import host_ingest_stats, np_to_dtype
from ..obs import count
from ..types import DType, decimal64
from ..utils.device import resolve_device
from ..utils.errors import expects


class HostColumn:
    """One host-resident column: encoded numpy buffer + declared type
    and exact range stats (see module docstring)."""

    __slots__ = ("dtype", "data", "value_range", "unique")

    def __init__(self, dtype: DType, data: np.ndarray,
                 value_range=None, unique=None):
        self.dtype = dtype
        self.data = data
        self.value_range = value_range
        self.unique = unique

    @property
    def row_bytes(self) -> int:
        return int(self.data.dtype.itemsize)

    @property
    def np_dtype(self) -> np.dtype:
        return self.data.dtype


def _padded_range(rng):
    """Quantize a declared range outward (~25% slack, pow2 grid). A
    padded range is still a true bound (the dense planner plans a
    slightly wider masked slot space), and it keeps the runner's entry
    and standing-query state stable under appends: values inside the pad
    change nothing; only an outgrowth widens the range (counted
    ``rel.morsel_stats_widened``) and re-keys the plan."""
    if rng is None:
        return None
    lo, hi = int(rng[0]), int(rng[1])
    width = hi - lo + 1
    q = max(8, 1 << max(0, (width - 1).bit_length() - 2))
    lo2 = (lo // q) * q
    hi2 = -(-(hi + 1) // q) * q - 1
    return (lo2, hi2)


def _encode_numeric(arr: np.ndarray, name: str,
                    decimals: dict) -> HostColumn:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.int32:
        arr = arr.astype(np.int64)
    if name in decimals:
        expects(arr.dtype.kind in "iu",
                f"decimal ingest of {name!r} needs integer unscaled "
                "values")
        arr = arr.astype(np.int64)
        return HostColumn(decimal64(decimals[name]), arr, None, None)
    rng, uniq = host_ingest_stats(arr, None)
    return HostColumn(np_to_dtype(arr.dtype), arr, _padded_range(rng),
                      uniq)


def _batch_token(cols: "Dict[str, HostColumn]", names: Sequence[str],
                 start: int, stop: int,
                 dicts: "Dict[str, np.ndarray]") -> str:
    """Content token of rows [start, stop): sha1 over every column's
    encoded bytes plus the dictionary identity (codes are only
    meaningful against their category array)."""
    h = hashlib.sha1()
    for name in names:
        c = cols[name]
        h.update(name.encode())
        h.update(str(c.data.dtype).encode())
        h.update(np.ascontiguousarray(c.data[start:stop]).tobytes())
        cats = dicts.get(name)
        if cats is not None:
            h.update("\x00".join(map(str, cats)).encode())
    return h.hexdigest()


class HostTable:
    """A host-resident append-only table the morsel runner streams.

    Thread contract: ONE writer (``append``) at a time; concurrent
    readers (morsel runs) see a consistent snapshot because every
    append swaps in freshly built arrays under the lock and readers
    take ``snapshot()`` under the same lock. ``rel_append`` is the
    module-level sugar the streaming-ingest story documents.
    """

    is_host_table = True  # duck-typing marker (``tpcds/rel.py`` routing)

    def __init__(self, names: Sequence[str],
                 cols: "Dict[str, HostColumn]",
                 dicts: "Dict[str, np.ndarray]",
                 decimals: "Optional[Dict[str, int]]" = None):
        expects(len(names) > 0, "a HostTable needs at least one column")
        self.names = list(names)
        self._lock = threading.Lock()
        self._cols = cols  # guarded-by: self._lock -- swapped whole on append
        self.dicts = dicts  # guarded-by: self._lock -- swapped whole on append
        self._decimals = dict(decimals or {})
        # append-only ingest log: (start_row, stop_row, content token);
        # the standing-query delta cache keys on this token sequence
        # guarded-by self._lock: the log, the version (bumped per append or
        # re-encode) and the in-core memo ((version, device), Rel)
        self._batches: "list[tuple[int, int, str]]" = []
        self._version = 0
        self._rel_memo = None
        n = cols[self.names[0]].data.shape[0]
        for name in self.names:
            expects(cols[name].data.shape[0] == n,
                    "HostTable columns must share one row count")
        with self._lock:
            self._batches.append((0, n, _batch_token(cols, self.names,
                                                     0, n, dicts)))

    # -- construction ------------------------------------------------------

    @classmethod
    def from_df(cls, df, decimals: "Optional[Dict[str, int]]" = None
                ) -> "HostTable":
        """pandas frame -> HostTable, mirroring ``rel_from_df``'s
        encodings. Null-carrying object columns are rejected — the
        streamed paths are plain-data only (ingest nulls stay an
        in-core feature)."""
        import pandas as pd
        decimals = dict(decimals or {})
        names, cols, dicts = [], {}, {}
        for name in df.columns:
            s = df[name]
            names.append(name)
            if pd.api.types.is_numeric_dtype(s.dtype):
                cols[name] = _encode_numeric(s.to_numpy(), name, decimals)
                continue
            codes, cats = pd.factorize(s, sort=True)
            expects(not (codes < 0).any(),
                    f"streamed ingest of {name!r} needs non-null values")
            arr = codes.astype(np.int64)
            # declared over the whole DICTIONARY, not the seen codes:
            # stable under appends that stay inside known categories
            cols[name] = HostColumn(np_to_dtype(arr.dtype), arr,
                                    (0, len(cats) - 1), None)
            dicts[name] = np.asarray(cats)
        return cls(names, cols, dicts, decimals)

    # -- shape / accounting ------------------------------------------------

    @property
    def num_rows(self) -> int:
        with self._lock:
            return int(self._cols[self.names[0]].data.shape[0])

    @property
    def row_bytes(self) -> int:
        """Device bytes one row of this table occupies in a morsel."""
        with self._lock:
            return sum(self._cols[n].row_bytes for n in self.names)

    @property
    def nbytes(self) -> int:
        """Total host payload (the would-be in-core ingest size)."""
        return self.row_bytes * self.num_rows

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def snapshot(self) -> "tuple[int, Dict[str, HostColumn], dict, tuple]":
        """(version, cols, dicts, batch tokens) under one lock — the
        consistent view a morsel run reads."""
        with self._lock:
            return (self._version, dict(self._cols), dict(self.dicts),
                    tuple(t for _, _, t in self._batches))

    def snapshot_rows(self, snap) -> int:
        """Row count OF A SNAPSHOT (not the live table — an append may
        have landed since). The runner sizes its morsel loop with this
        so every streamed table type owns its snapshot layout
        (disk-backed snapshots carry no data buffers at all)."""
        return int(snap[1][self.names[0]].data.shape[0])

    def batch_tokens(self) -> "tuple[str, ...]":
        with self._lock:
            return tuple(t for _, _, t in self._batches)

    # -- append (the streaming-ingest seam) --------------------------------

    def append(self, df) -> "HostTable":
        """Extend the table with ``df``'s rows as one new ingest batch.
        Returns ``self`` for chaining. See the module docstring for the
        dictionary-growth and stats-widening invalidation rules."""
        import pandas as pd
        expects(list(df.columns) == self.names,
                f"append schema mismatch: {list(df.columns)} vs "
                f"{self.names}")
        with self._lock:
            old_n = int(self._cols[self.names[0]].data.shape[0])
            new_cols: "Dict[str, HostColumn]" = {}
            new_dicts = dict(self.dicts)
            reencoded = False
            for name in self.names:
                cur = self._cols[name]
                s = df[name]
                if name in self.dicts:
                    cats = self.dicts[name]
                    vals = np.asarray([str(v) for v in s])
                    pos = np.searchsorted(cats, vals)
                    pos_c = np.clip(pos, 0, len(cats) - 1)
                    known = cats.astype(object)[pos_c] == vals.astype(
                        object)
                    if bool(known.all()):
                        codes = pos_c.astype(np.int64)
                        data = np.concatenate([cur.data, codes])
                        rng = (0, len(cats) - 1)
                        new_cols[name] = HostColumn(cur.dtype, data, rng,
                                                    None)
                        continue
                    # dictionary grows: the sorted-category invariant
                    # moves existing codes, so the whole column
                    # re-encodes and the ingest log resets below
                    reencoded = True
                    old_vals = cats[cur.data]
                    allvals = np.concatenate([old_vals, vals])
                    codes, newcats = pd.factorize(
                        pd.Series(allvals), sort=True)
                    data = codes.astype(np.int64)
                    new_dicts[name] = np.asarray(newcats)
                    new_cols[name] = HostColumn(
                        cur.dtype, data, (0, len(newcats) - 1), None)
                    continue
                add = _encode_numeric(np.asarray(s.to_numpy()), name,
                                      self._decimals)
                expects(add.dtype.id == cur.dtype.id,
                        f"append dtype mismatch on {name!r}")
                data = np.concatenate([cur.data, add.data])
                if cur.value_range is None or add.value_range is None:
                    rng = None
                else:
                    rng = (min(cur.value_range[0], add.value_range[0]),
                           max(cur.value_range[1], add.value_range[1]))
                    if rng != cur.value_range:
                        # widened range = new dense widths = a new
                        # layout; counted so a drifting append pattern
                        # shows
                        count("rel.morsel_stats_widened")
                new_cols[name] = HostColumn(cur.dtype, data, rng, None)
            n = int(new_cols[self.names[0]].data.shape[0])
            self._cols = new_cols
            self.dicts = new_dicts
            self._version += 1
            self._rel_memo = None
            if reencoded:
                count("rel.morsel_dict_rebuilds")
                self._batches = [(0, n, _batch_token(
                    new_cols, self.names, 0, n, new_dicts))]
            else:
                self._batches.append((old_n, n, _batch_token(
                    new_cols, self.names, old_n, n, new_dicts)))
        return self

    # -- views -------------------------------------------------------------

    def chunk_arrays(self, cols: "Dict[str, HostColumn]", start: int,
                     live: int, cap: int) -> "list[np.ndarray]":
        """Numpy arrays for one capacity-shaped morsel: rows
        [start, start+live) padded with zeros to ``cap`` (dead rows —
        the chunk mask covers them)."""
        out = []
        for name in self.names:
            data = cols[name].data
            chunk = data[start:start + live]
            if live < cap:
                pad = np.zeros((cap - live,) + chunk.shape[1:],
                               chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            out.append(np.ascontiguousarray(chunk))
        return out

    def chunk_page_arrays(self, cols: "Dict[str, HostColumn]",
                          start: int, live: int, cap: int,
                          page_bytes: int) -> list:
        """Page-granular staging view of one capacity-shaped morsel: per
        column ``(pages, n_pages, prows, dtype, tail_shape)``, ``pages``
        the live page arrays (``(prows, *tail)`` each, rows [start,
        start+live), the last zero-padded), ``n_pages`` the column's page
        count at ``cap`` and ``prows`` the rows a page (at most ``cap``).
        Dead pages are not built: a caller stands the zero page in for
        them."""
        return _page_arrays([cols[name].data[start:start + live]
                             for name in self.names], live, cap, page_bytes)

    def chunk_views(self, cols: "Dict[str, HostColumn]", start: int,
                    live: int) -> "list[np.ndarray]":
        """The live rows [start, start+live) of each column, as views of
        the snapshot's arrays (the runner copies them into its pinned
        staging buffers)."""
        return [cols[name].data[start:start + live] for name in self.names]

    def to_rel(self, device=None):
        """Full in-core materialization on ``device`` (``cuda`` unless
        the caller passes another): the morsel fallback path and the
        exactness oracle. Memoized per version and device, so repeated
        fallbacks pay one upload."""
        dev = resolve_device(device)
        with self._lock:
            memo = self._rel_memo
            version = self._version
        if memo is not None and memo[0] == (version, str(dev)):
            return memo[1]
        from ..tpcds import rel as _rel
        with self._lock:
            cols_snap = dict(self._cols)
            dicts_snap = dict(self.dicts)
        cols = []
        for name in self.names:
            hc = cols_snap[name]
            col = Column.from_numpy(hc.data, dtype=hc.dtype, device=dev)
            cols.append(_rel._trust_ingest(col))
        out = _rel.Rel(Table(cols), self.names, dicts=dicts_snap)
        with self._lock:
            if self._version == version:
                self._rel_memo = ((version, str(dev)), out)
        return out


def _page_arrays(chunks: "list[np.ndarray]", live: int, cap: int,
                 page_bytes: int) -> list:
    """``chunk_page_arrays`` of the live rows ``chunks`` (one array a
    column, ``live`` rows each)."""
    out = []
    for data in chunks:
        tail = data.shape[1:]
        row_bytes = int(data.dtype.itemsize
                        * int(np.prod(tail, dtype=np.int64) or 1))
        prows = max(1, min(int(cap), int(page_bytes) // max(1, row_bytes)))
        n_pages = -(-int(cap) // prows)
        live_pages = -(-int(live) // prows) if live > 0 else 0
        pages = []
        for j in range(live_pages):
            page = data[j * prows:min(live, (j + 1) * prows)]
            if page.shape[0] < prows:
                pad = np.zeros((prows - page.shape[0],) + tail, data.dtype)
                page = np.concatenate([page, pad])
            pages.append(np.ascontiguousarray(page))
        out.append((pages, n_pages, prows, data.dtype, tail))
    return out


def rel_append(table: HostTable, df) -> HostTable:
    """Extend a standing table with ``df``'s rows as one new ingest
    batch: the next ``run_fused`` over it folds only the appended
    morsels into the cached accumulator and runs the merge again
    (provenance ``delta``)."""
    return table.append(df)
