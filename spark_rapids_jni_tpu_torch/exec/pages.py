"""The device page ledger: ragged occupancy over static page-count buckets.

Port of ``spark_rapids_jni_tpu/exec/pages.py``, the same accounting:

- **Pages.** Device buffers are counted in fixed power-of-two pages
  (``SRT_PAGE_BYTES``); only a buffer's last page may be partly live.
- **Bucket ladder.** Leases snap up to the ``{2^m, 3*2^(m-1)}`` ladder of
  page counts, so a run of live sizes collapses onto few sizes.
- **Leases.** :meth:`PagePool.lease` reserves a bucketed page count
  against the ``SRT_PAGE_POOL_BYTES`` budget; exhaustion returns None
  and the caller degrades to its whole-buffer twin, counted with the
  ``pool_degraded`` mark, never an error.
- **Occupancy masks.** :func:`occupancy_mask` / :func:`live_row_mask`
  derive page- and row-granular liveness from a live row count.
- **Gauges.** ``mem.pool.*``: bytes leased, live and padded, leases,
  utilization.

The ledger allocates nothing itself: the buffers come from PyTorch's
CUDA caching allocator, and the pool is the admission ledger that keeps
the paged consumers' total bounded and visible: the morsel pump's paged
staging route (``exec/runner.py``), which leases its window and copies
only the live pages of each morsel into the card, and the batched runs'
windows (``tpcds/rel.py``). The result cache's paged tier keeps its
pages on the host and leases nothing.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..config import env_int
from ..obs import count, gauge

DEFAULT_PAGE_BYTES = 1 << 16        # 64 KiB
DEFAULT_POOL_BYTES = 1 << 28        # 256 MiB of modeled paged HBM


def page_bytes() -> int:
    """Page size (``SRT_PAGE_BYTES``) snapped down to a power of two,
    at least 1 KiB."""
    raw = env_int("SRT_PAGE_BYTES", DEFAULT_PAGE_BYTES)
    raw = max(1 << 10, int(raw))
    return 1 << (int(raw).bit_length() - 1)


def page_pool_bytes() -> int:
    """The pool budget (``SRT_PAGE_POOL_BYTES``); 0 or less turns the
    pool, and the paged staging route with it, off."""
    return env_int("SRT_PAGE_POOL_BYTES", DEFAULT_POOL_BYTES)


def page_pool_enabled() -> bool:
    return page_pool_bytes() > 0


# ---------------------------------------------------------------------------
# Static page-count bucket ladder
# ---------------------------------------------------------------------------

# Hard ceiling on ladder generation — 2^40 pages of 1 KiB is already
# absurd; the ladder is bounded by the pool budget in practice.
_MAX_BUCKET_EXP = 40


def bucket_pages(n_pages: int) -> int:
    """Smallest ladder rung >= ``n_pages`` of the ``{2^m, 3*2^(m-1)}``
    grid (1, 2, 3, 4, 6, 8, 12, 16, ...): the rung sizes a lease."""
    n = max(1, int(n_pages))
    for m in range(_MAX_BUCKET_EXP):
        if (1 << m) >= n:
            return 1 << m
        if m >= 1 and 3 * (1 << (m - 1)) >= n:
            return 3 * (1 << (m - 1))
    return 1 << _MAX_BUCKET_EXP


def pages_for(nbytes: int, pbytes: Optional[int] = None) -> int:
    """ceil(nbytes / page) — live pages a byte count occupies."""
    p = page_bytes() if pbytes is None else int(pbytes)
    return max(1, -(-max(0, int(nbytes)) // p))


def ragged_capacity(k: int, slot_bytes: int, cap: int) -> int:
    """Effective slot capacity for a ragged batch: the number of
    ``slot_bytes``-sized slots the page-bucketed allocation for ``k``
    LIVE slots can hold, clamped to the padded ladder capacity ``cap``
    (ragged must never be worse than its padded twin). ``k <= result
    <= cap`` always holds, so pad slots shrink from ``cap - k`` to the
    page-quantization remainder."""
    k = max(1, int(k))
    slot_bytes = max(1, int(slot_bytes))
    pb = page_bytes()
    rung = bucket_pages(pages_for(k * slot_bytes, pb))
    kcap = (rung * pb) // slot_bytes
    return max(k, min(int(cap), int(kcap)))


# ---------------------------------------------------------------------------
# Occupancy masks
# ---------------------------------------------------------------------------

def page_rows(itemsize: int, pbytes: Optional[int] = None) -> int:
    """Rows of ``itemsize``-wide elements per page (>= 1 even for rows
    wider than a page, so degenerate dtypes still make progress)."""
    p = page_bytes() if pbytes is None else int(pbytes)
    return max(1, p // max(1, int(itemsize)))


def occupancy_mask(live_rows: int, cap_rows: int, prows: int) -> np.ndarray:
    """Page-granular liveness of a ``cap_rows`` buffer holding
    ``live_rows`` live rows: bool ``(n_pages,)``, True where the page
    holds at least one live row."""
    n_pages = -(-max(0, int(cap_rows)) // max(1, int(prows)))
    live_pages = -(-max(0, int(live_rows)) // max(1, int(prows)))
    out = np.zeros((max(0, n_pages),), np.bool_)
    out[:min(live_pages, n_pages)] = True
    return out


def live_row_mask(live_rows: int, cap_rows: int, prows: int) -> np.ndarray:
    """Row-granular liveness DERIVED from page occupancy: rows in dead
    pages are dead wholesale; within the last live page the row index
    decides. Equals ``arange(cap) < live`` by construction — the page
    derivation is the contract the ragged consumers rely on (a page the
    occupancy mask kills can never contribute a live row)."""
    pages = occupancy_mask(live_rows, cap_rows, prows)
    rows = np.repeat(pages, max(1, int(prows)))[:max(0, int(cap_rows))]
    if rows.shape[0] < int(cap_rows):  # prows does not divide cap
        rows = np.concatenate(
            [rows, np.zeros((int(cap_rows) - rows.shape[0],), np.bool_)])
    return rows & (np.arange(max(0, int(cap_rows))) < int(live_rows))


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

class PageLease:
    """One page-count-bucketed reservation. ``nbytes`` is the bucketed
    (allocated) size, ``live_bytes`` the caller's live payload; the
    difference is the padding the pool gauges as ``mem.pool.
    bytes_padded``. Release exactly once (idempotent)."""

    __slots__ = ("pages", "nbytes", "live_bytes", "tag", "_pool",
                 "_released")

    def __init__(self, pages: int, nbytes: int, live_bytes: int,
                 tag: str, pool: "PagePool"):
        self.pages = pages
        self.nbytes = nbytes
        self.live_bytes = live_bytes
        self.tag = tag
        self._pool = pool
        self._released = False

    @property
    def padded_bytes(self) -> int:
        return self.nbytes - self.live_bytes

    def release(self) -> None:
        self._pool.release(self)


class PagePool:
    """Byte-budgeted page accountant for ragged device buffers.

    Thread-safe. The pool allocates no device memory (the caching
    allocator owns the buffers): it is the admission ledger and gauge
    surface that keeps the paged routes' total bounded and visible."""

    def __init__(self, budget_bytes: int,
                 pbytes: Optional[int] = None):
        self.page_bytes = page_bytes() if pbytes is None else int(pbytes)
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._leased_bytes = 0      # guarded-by: self._lock
        self._live_bytes = 0        # guarded-by: self._lock
        self._leases = 0            # guarded-by: self._lock

    # -- admission ---------------------------------------------------------

    def lease(self, live_bytes: int, tag: str = "") -> Optional[PageLease]:
        """Reserve the bucketed page count covering ``live_bytes``
        against the budget, or None when it cannot fit (counted
        ``mem.pool.exhausted`` — the CALLER owns the route-degrade
        counter carrying the ``pool_degraded`` fallback mark)."""
        live = max(0, int(live_bytes))
        rung = bucket_pages(pages_for(live, self.page_bytes))
        nbytes = rung * self.page_bytes
        with self._lock:
            if self._leased_bytes + nbytes > self.budget_bytes:
                count("mem.pool.exhausted")
                self._publish_locked()
                return None
            self._leased_bytes += nbytes
            self._live_bytes += live
            self._leases += 1
            self._publish_locked()
        count("mem.pool.leases")
        return PageLease(rung, nbytes, live, tag, self)

    def release(self, lease: PageLease) -> None:
        with self._lock:
            if lease._released:
                return
            lease._released = True
            self._leased_bytes -= lease.nbytes
            self._live_bytes -= lease.live_bytes
            self._leases -= 1
            self._publish_locked()

    # -- introspection -----------------------------------------------------

    @property
    def leased_bytes(self) -> int:
        with self._lock:
            return self._leased_bytes

    @property
    def live_bytes(self) -> int:
        with self._lock:
            return self._live_bytes

    @property
    def n_leases(self) -> int:
        with self._lock:
            return self._leases

    def _publish_locked(self) -> None:
        # call only with self._lock held
        padded = self._leased_bytes - self._live_bytes
        gauge("mem.pool.budget_bytes").set(self.budget_bytes)
        gauge("mem.pool.bytes_leased").set(self._leased_bytes)
        gauge("mem.pool.bytes_live").set(self._live_bytes)
        gauge("mem.pool.bytes_padded").set(padded)
        gauge("mem.pool.leases").set(self._leases)
        util = (100 * self._live_bytes // self._leased_bytes
                if self._leased_bytes else 100)
        gauge("mem.pool.utilization_pct").set(util)


# ---------------------------------------------------------------------------
# Shared dead pages (the morsel pump zeroes stale pages in place on the
# card instead: its capacity buffers are reused, never concatenated)
# ---------------------------------------------------------------------------

_zero_pages: dict = {}  # guarded-by: _zero_lock
_zero_lock = threading.Lock()


def zero_page_device(dtype, shape: tuple, device):
    """The process-wide all-zero page tensor for ``(dtype, shape)`` on
    ``device``, made once and shared (a dead page needs no copy)."""
    import torch
    dev = torch.device(device)
    key = (np.dtype(dtype).str, tuple(int(s) for s in shape), str(dev))
    with _zero_lock:
        buf = _zero_pages.get(key)
    if buf is not None:
        return buf
    fresh = torch.from_numpy(np.zeros(key[1], np.dtype(dtype))).to(dev)
    with _zero_lock:
        return _zero_pages.setdefault(key, fresh)


# ---------------------------------------------------------------------------
# Process singleton
# ---------------------------------------------------------------------------

_pool: Optional[PagePool] = None  # guarded-by: _pool_lock
_pool_lock = threading.Lock()


def page_pool() -> Optional[PagePool]:
    """The process-wide pool, or None when disabled
    (``SRT_PAGE_POOL_BYTES`` <= 0). Re-reads the env each call so tests
    and operators resize/disable without a restart; a changed budget or
    page size rebuilds the ledger (outstanding leases keep their old
    pool object — releases stay consistent)."""
    cap = page_pool_bytes()
    if cap <= 0:
        return None
    pb = page_bytes()
    global _pool
    with _pool_lock:
        if (_pool is None or _pool.budget_bytes != cap
                or _pool.page_bytes != pb):
            _pool = PagePool(cap, pb)
        return _pool


def reset() -> None:
    """Drop the process pool and the zero-page cache (tests)."""
    global _pool
    with _pool_lock:
        _pool = None
    with _zero_lock:
        _zero_pages.clear()
