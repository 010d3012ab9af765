"""Content-keyed result cache: memoize materialized query results.

Port of ``spark_rapids_jni_tpu/serving/result_cache.py``. A content-equal
repeat (the same plan over the same table content) returns the
materialized result ``Rel`` with no kernel launch and no host sync,
reported with provenance ``result_cache``. Keys are content, never
identity: ``tpcds/rel.result_cache_token`` over the plan code digest,
the rel fingerprints, per-column ingest content digests (stamped by
``rel_from_df`` while this cache is on), the planner knobs, the device
and the environment key (``serving/aot_cache.result_token``). Inputs
without digests are uncacheable, counted.

``SRT_RESULT_CACHE_BYTES`` bounds the cache (LRU by bytes; unset or 0
turns the tier off, the ingest digests with it). Results stay whole on
the device and are evicted whole. While the page pool is on
(``SRT_PAGE_POOL_BYTES`` > 0, ``exec/pages.py``) every buffer is charged
at page granularity (``SRT_PAGE_BYTES``) and the entry leases that
charge from the page ledger, released on eviction, so the pool's gauges
see what the cache pins. A result whose lease the pool refuses is still
cached, unleased (counted ``serving.result_cache.pool_degraded``), so
whether a result is cached never depends on the pool, and every rank of
a mesh caches alike.

The reference's paged tier keeps results as host page segments and
uploads them on a hit, so idle results pin no device memory. The port
keeps one device-resident tier: a device copy of those pages would pin
the same bytes on the same card as the whole entry, and a host tier
(an upload on every hit) is not ported.

Obs: ``serving.result_cache.{hits,misses,evictions,too_large,
uncacheable,pool_degraded}`` counters and
``serving.result_cache.{bytes,entries}`` gauges.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

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


def _page_round(nbytes: int, pbytes: int) -> int:
    return max(1, -(-max(0, int(nbytes)) // int(pbytes))) * int(pbytes)


def _buffers(col):
    yield col.data
    yield col.validity
    for child in col.children or ():
        yield from _buffers(child)


def paged_nbytes(rel, pbytes: int) -> int:
    """``rel_nbytes`` with every buffer (column data, validity, children,
    the dictionaries together) rounded up to whole pages: what the page
    ledger charges for holding the result."""
    total = sum(_page_round(b.nbytes, pbytes) for c in rel.table.columns
                for b in _buffers(c) if b is not None)
    dict_bytes = sum(int(getattr(v, "nbytes", 0)) for v in rel.dicts.values())
    return total + _page_round(dict_bytes, pbytes)


class ResultCache:
    """Byte-bounded LRU of token -> materialized result ``Rel``, on the
    device. Thread-safe. A hit hands back the same ``Rel``: its decode
    (``to_df``) only reads, so callers share it safely.

    ``page_bytes`` > 0 charges each entry at page granularity and leases
    the charge from the page ledger (see the module docstring)."""

    def __init__(self, max_bytes: int, page_bytes: int = 0):
        self.max_bytes = int(max_bytes)
        self.page_bytes = int(page_bytes)
        # token -> (rel, charged bytes, the ledger's lease or None)
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
        nbytes = (paged_nbytes(rel, self.page_bytes) if self.page_bytes
                  else rel_nbytes(rel))
        if nbytes > self.max_bytes:
            count("serving.result_cache.too_large")
            return False
        lease = None
        if self.page_bytes:
            from ..exec.pages import page_pool
            pool = page_pool()
            lease = None if pool is None else pool.lease(
                nbytes, tag="result_cache")
            if lease is None:
                count("serving.result_cache.pool_degraded")
        dropped = []
        with self._lock:
            old = self._entries.pop(token, None)
            if old is not None:
                self._bytes -= old[1]
                dropped.append(old)
            while self._entries and self._bytes + nbytes > self.max_bytes:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim[1]
                dropped.append(victim)
            self._entries[token] = (rel, nbytes, lease)
            self._bytes += nbytes
            self._publish_locked()
        for _, _, vlease in dropped:
            if vlease is not None:
                vlease.release()
        evicted = len(dropped) - (old is not None)
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
            dropped = list(self._entries.values())
            self._entries.clear()
            self._bytes = 0
            self._publish_locked()
        for _, _, lease in dropped:
            if lease is not None:
                lease.release()

    def _publish_locked(self) -> None:  # requires-lock: self._lock
        gauge("serving.result_cache.bytes").set(self._bytes)
        gauge("serving.result_cache.entries").set(len(self._entries))


_cache = None  # guarded-by: _cache_lock -- ResultCache
_cache_lock = threading.Lock()


def result_cache():
    """The process's result cache, or None when the tier is off. Entries
    lease page-rounded bytes from the page ledger while the page pool is
    on. Re-reads the environment each call: a changed cap, page size or
    pool switch rebuilds the cache, dropping its residents."""
    cap = result_cache_bytes()
    if cap <= 0:
        return None
    from ..exec.pages import page_bytes, page_pool_enabled
    pb = page_bytes() if page_pool_enabled() else 0
    global _cache
    old = None
    with _cache_lock:
        if (_cache is None or _cache.max_bytes != cap
                or _cache.page_bytes != pb):
            old, _cache = _cache, ResultCache(cap, pb)
        cache = _cache
    if old is not None:
        old.clear()
    return cache


def reset() -> None:
    """Drop the process's cache (tests)."""
    global _cache
    with _cache_lock:
        old, _cache = _cache, None
    if old is not None:
        old.clear()
