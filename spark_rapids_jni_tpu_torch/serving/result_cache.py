"""Content-keyed result cache: memoize materialized query results.

Port of ``spark_rapids_jni_tpu/serving/result_cache.py``. A content-equal
repeat (the same plan over the same table content) returns the
materialized result with no kernel launch and no host sync, reported
with provenance ``result_cache``. Keys are content, never identity:
``tpcds/rel.result_cache_token`` over the plan code digest, the rel
fingerprints, per-column ingest content digests (stamped by
``rel_from_df`` while this cache is on), the planner knobs, the device
and the environment key (``serving/aot_cache.result_token``). Inputs
without digests are uncacheable, counted.

``SRT_RESULT_CACHE_BYTES`` bounds the cache (LRU by bytes; unset or 0
turns the tier off, the ingest digests with it). Two tiers share the
bound, chosen as in the reference:

- **paged** (:class:`PagedResultCache`), while the page pool is on
  (``SRT_PAGE_POOL_BYTES`` > 0, ``exec/pages.py``; the default): each
  result is kept as host page segments of at most ``SRT_PAGE_BYTES``,
  in pinned memory when the result is on the card, so an idle result
  holds no device memory. ``put`` copies the columns out with
  non-blocking copies and records one CUDA event; a hit makes its
  stream wait on that event and copies the pages into fresh device
  tensors: copies only, no kernel launch and no host sync. Charging is
  page-rounded and eviction frees exactly the LRU pages admission needs;
  an entry that lost a page is dead and refunds its remainder at its
  next ``get`` (a miss). Results that cannot be paged losslessly (a
  mask, a pending sort or limit, nested children) are kept whole.
- **whole** (:class:`ResultCache`), when the pool is off: whole results
  stay on the device and are evicted whole.

Neither tier leases from the page ledger: the paged tier holds no
device memory, so whether a result is cached depends only on the byte
caps, and every rank of a mesh caches alike.

Obs: ``serving.result_cache.{hits,misses,evictions,page_evictions,
too_large,uncacheable}`` counters and ``serving.result_cache.{bytes,
entries}`` gauges.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict

import torch

from ..config import env_int
from ..obs import count, gauge


def result_cache_bytes() -> int:
    """The configured byte cap; 0 (the default) turns the tier off."""
    return env_int("SRT_RESULT_CACHE_BYTES", 0)


def rel_nbytes(rel) -> int:
    """Resident size of a materialized result: its columns' device bytes
    (data, validity, children) and its host dictionaries."""
    from ..obs.memory import column_bytes
    total = sum(column_bytes(c) for c in rel.table.columns)
    for cats in rel.dicts.values():
        total += int(getattr(cats, "nbytes", 0))
    return total


class ResultCache:
    """Byte-bounded LRU of token -> materialized result ``Rel``, on the
    device. Thread-safe. A hit hands back the same ``Rel``: its decode
    (``to_df``) only reads, so callers share it safely."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()  # guarded-by: self._lock
        self._bytes = 0  # guarded-by: self._lock
        self._lock = threading.Lock()

    def get(self, token: str):
        with self._lock:
            entry = self._entries.get(token)
            if entry is None:
                count("serving.result_cache.misses")
                return None
            self._entries.move_to_end(token)
        count("serving.result_cache.hits")
        return entry[0]

    def put(self, token: str, rel) -> bool:
        nbytes = rel_nbytes(rel)
        if nbytes > self.max_bytes:
            count("serving.result_cache.too_large")
            return False
        evicted = 0
        with self._lock:
            old = self._entries.pop(token, None)
            if old is not None:
                self._bytes -= old[1]
            while self._entries and self._bytes + nbytes > self.max_bytes:
                _, (_, vbytes) = self._entries.popitem(last=False)
                self._bytes -= vbytes
                evicted += 1
            self._entries[token] = (rel, nbytes)
            self._bytes += nbytes
            self._publish_locked()
        if evicted:
            count("serving.result_cache.evictions", evicted)
        return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._publish_locked()

    def _publish_locked(self) -> None:  # requires-lock: self._lock
        gauge("serving.result_cache.bytes").set(self._bytes)
        gauge("serving.result_cache.entries").set(len(self._entries))


class _PagedEntry:
    """One paged resident: enough host-side structure to rebuild the
    result ``Rel`` losslessly. Each column buffer is one host tensor
    (``cols``), split into row-aligned page views (``page_slots``) that
    the eviction loop strips one at a time. An entry that lost any page
    is dead (a partial result is useless): it drops its host buffers at
    once, keeps its remaining charge until its next ``get``, and misses
    there."""

    __slots__ = ("names", "dicts", "cols", "opaque", "page_slots",
                 "charged_bytes", "stripped", "device", "event")

    def __init__(self):
        self.names = None
        self.dicts = None
        self.cols = None        # [(dtype, size, data_host, validity_host
        #                          | None, value_range, unique,
        #                          field_names), ...]
        self.opaque = None      # the whole Rel (unpageable results)
        self.page_slots = []    # [(pages_list, idx), ...] strippable
        self.charged_bytes = 0
        self.stripped = 0
        self.device = None      # where the result was and a hit goes
        self.event = None       # the snapshot copies' CUDA event

    def drop_pages(self) -> None:
        """Free every host page (the entry is dead)."""
        self.cols = None
        for pages, idx in self.page_slots:
            pages[idx] = None


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A new host tensor holding ``t``: pinned, and filled by a
    non-blocking copy, when ``t`` is on the card."""
    if t.device.type == "cuda":
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out
    return t.clone(memory_format=torch.contiguous_format)


def _split_pages(t: torch.Tensor, pbytes: int) -> list:
    """Row-aligned page views of one host buffer, at most ``pbytes`` bytes
    each (the last page ragged; a zero-row buffer is one empty page)."""
    row_bytes = t.element_size() * math.prod(t.shape[1:])
    prows = max(1, int(pbytes) // max(1, row_bytes))
    return [t[i:i + prows] for i in range(0, max(1, t.shape[0]), prows)]


class PagedResultCache:
    """Byte-bounded result cache with page-granular residency on the
    host (see the module docstring): page-rounded charging, per-page
    eviction, and a hit rebuilt as fresh device tensors by copies
    alone."""

    def __init__(self, max_bytes: int, pbytes: int):
        self.max_bytes = int(max_bytes)
        self.page_bytes = int(pbytes)
        self._entries: "OrderedDict[str, _PagedEntry]" = OrderedDict()  # guarded-by: self._lock
        self._bytes = 0  # guarded-by: self._lock
        self._lock = threading.Lock()

    # -- snapshot / rebuild ------------------------------------------------

    def _snapshot(self, rel) -> _PagedEntry:
        ent = _PagedEntry()
        ent.names = list(rel.names)
        ent.dicts = dict(rel.dicts)
        columns = rel.table.columns
        pageable = (rel.mask is None and rel.pending_sort is None
                    and rel.limit is None
                    and all(not c.children and c.data is not None
                            for c in columns))
        if not pageable:
            ent.opaque = rel
            ent.charged_bytes = _page_round(rel_nbytes(rel),
                                            self.page_bytes)
            return ent
        ent.device = (columns[0].data.device if columns
                      else torch.device("cpu"))
        cols = []
        for c in columns:
            data = _host_copy(c.data)
            validity = None if c.validity is None else _host_copy(c.validity)
            for buf in (data, validity):
                if buf is not None:
                    pages = _split_pages(buf, self.page_bytes)
                    ent.page_slots.extend((pages, i)
                                          for i in range(len(pages)))
            cols.append((c.dtype, c.size, data, validity, c.value_range,
                         c.unique, c.field_names))
        ent.cols = cols
        if ent.device.type == "cuda":
            ent.event = torch.cuda.Event()
            ent.event.record(torch.cuda.current_stream(ent.device))
        dict_bytes = sum(int(getattr(v, "nbytes", 0))
                         for v in ent.dicts.values())
        ent.charged_bytes = (len(ent.page_slots) * self.page_bytes
                             + _page_round(dict_bytes, self.page_bytes))
        return ent

    @staticmethod
    def _rebuild(ent: _PagedEntry, cols: list):
        """Fresh device tensors from the host buffers: on the card the
        current stream waits for the snapshot's copies (no host wait),
        then each buffer goes up in one non-blocking copy (its pages are
        consecutive views of it, and a live entry has all of them)."""
        if ent.opaque is not None:
            return ent.opaque
        from ..columnar import Column, Table
        from ..tpcds.rel import Rel
        dev = ent.device
        if ent.event is not None:
            torch.cuda.current_stream(dev).wait_event(ent.event)

        def upload(buf):
            out = torch.empty(buf.shape, dtype=buf.dtype, device=dev)
            out.copy_(buf, non_blocking=True)
            return out

        return Rel(Table([
            Column(dt, size, upload(data),
                   None if validity is None else upload(validity),
                   value_range=vr, unique=uniq, field_names=fnames)
            for dt, size, data, validity, vr, uniq, fnames in cols]),
            ent.names, dicts=ent.dicts)

    # -- the ResultCache interface -----------------------------------------

    def get(self, token: str):
        with self._lock:
            ent = self._entries.get(token)
            if ent is not None and ent.stripped:
                # dead resident: refund what eviction left behind
                del self._entries[token]
                self._bytes -= _live_bytes(ent, self.page_bytes)
                self._publish_locked()
                ent = None
            if ent is None:
                count("serving.result_cache.misses")
                return None
            self._entries.move_to_end(token)
            cols = ent.cols
        count("serving.result_cache.hits")
        return self._rebuild(ent, cols)

    def put(self, token: str, rel) -> bool:
        ent = self._snapshot(rel)
        if ent.charged_bytes > self.max_bytes:
            count("serving.result_cache.too_large")
            return False
        evicted_pages = 0
        evicted_entries = 0
        with self._lock:
            old = self._entries.pop(token, None)
            if old is not None:
                self._bytes -= _live_bytes(old, self.page_bytes)
            while (self._entries
                   and self._bytes + ent.charged_bytes > self.max_bytes):
                vtok = next(iter(self._entries))
                victim = self._entries[vtok]
                if victim.opaque is not None or not victim.page_slots:
                    # a whole resident (or a fully stripped one)
                    del self._entries[vtok]
                    self._bytes -= _live_bytes(victim, self.page_bytes)
                    evicted_entries += 1
                    continue
                if not victim.stripped:
                    victim.drop_pages()
                victim.page_slots.pop()
                victim.stripped += 1
                self._bytes -= self.page_bytes
                evicted_pages += 1
                if not victim.page_slots:
                    # last page gone: drop the husk (dict remainder)
                    del self._entries[vtok]
                    self._bytes -= _live_bytes(victim, self.page_bytes)
                    evicted_entries += 1
            self._entries[token] = ent
            self._bytes += ent.charged_bytes
            self._publish_locked()
        if evicted_pages:
            count("serving.result_cache.page_evictions", evicted_pages)
        if evicted_entries:
            count("serving.result_cache.evictions", evicted_entries)
        return True

    def resident_pages(self) -> list:
        """Every live entry's host page views (the smoke's and the
        tests' residency checks)."""
        with self._lock:
            return [pages[idx] for ent in self._entries.values()
                    if not ent.stripped
                    for pages, idx in ent.page_slots]

    def resident_tensors(self) -> list:
        """Every tensor the entries hold: host buffers, and the columns
        of whole (unpageable) results."""
        with self._lock:
            out = []
            for ent in self._entries.values():
                if ent.opaque is not None:
                    for c in ent.opaque.table.columns:
                        out.extend(_column_tensors(c))
                for col in ent.cols or ():
                    out.extend(b for b in col[2:4] if b is not None)
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._publish_locked()

    def _publish_locked(self) -> None:  # requires-lock: self._lock
        gauge("serving.result_cache.bytes").set(self._bytes)
        gauge("serving.result_cache.entries").set(len(self._entries))


def _column_tensors(col) -> list:
    out = [b for b in (col.data, col.validity) if b is not None]
    for child in col.children or ():
        out.extend(_column_tensors(child))
    return out


def _page_round(nbytes: int, pbytes: int) -> int:
    return max(1, -(-max(0, int(nbytes)) // int(pbytes))) * int(pbytes)


def _live_bytes(ent: _PagedEntry, pbytes: int) -> int:
    """An entry's still-charged bytes after any stripping."""
    return ent.charged_bytes - ent.stripped * pbytes


_cache = None  # guarded-by: _cache_lock -- ResultCache | PagedResultCache
_cache_lock = threading.Lock()


def result_cache():
    """The process's result cache, or None when the tier is off: the
    paged tier while the page pool is on, else the whole tier.
    Re-reads the environment each call: a changed cap, page size or
    tier rebuilds the cache, dropping its residents."""
    cap = result_cache_bytes()
    if cap <= 0:
        return None
    from ..exec.pages import page_bytes, page_pool_enabled
    global _cache
    with _cache_lock:
        if page_pool_enabled():
            pb = page_bytes()
            if (not isinstance(_cache, PagedResultCache)
                    or _cache.max_bytes != cap or _cache.page_bytes != pb):
                _cache = PagedResultCache(cap, pb)
        elif not isinstance(_cache, ResultCache) or _cache.max_bytes != cap:
            _cache = ResultCache(cap)
        return _cache


def reset() -> None:
    """Drop the process's cache (tests)."""
    global _cache
    with _cache_lock:
        _cache = None
