"""A bounded LRU for plan memos: the batched runner's captured programs.

Port of ``spark_rapids_jni_tpu/utils/plan_cache.py``. The reference
keeps its compiled XLA executables here; the port keeps the batch
cache's entries (``tpcds/rel.py``), each holding, on the card, a
captured CUDA graph with its private memory pool and its static input
and output buffers. The policy is the reference's: recency eviction at
``SRT_PLAN_CACHE_SIZE`` entries (default 64), every eviction counted on
each of the cache's counters, so a thrashing shape mix shows in obs.

An evicted or cleared entry is released at once: an entry that is a
dict with a ``"release"`` callable has it called, which drops its graph,
its pool and its buffers, instead of waiting for the last reference to
die. An evicted entry is rebuilt (captured again) on its next use.

Beyond the reference, an entry that is a dict may charge device bytes
(its ``"bytes"``): ``nbytes`` sums them and ``evict_oldest`` lets the
owner evict down to a byte budget, least recently used first.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Sequence

from ..config import env_int
from ..obs import count

DEFAULT_PLAN_CACHE_SIZE = 64


def plan_cache_cap() -> int:
    """LRU capacity of the in-memory plan caches (entries per cache)."""
    return env_int("SRT_PLAN_CACHE_SIZE", DEFAULT_PLAN_CACHE_SIZE)


def _release(entry) -> None:
    fn = entry.get("release") if isinstance(entry, dict) else None
    if fn is not None:
        fn()


class PlanCacheLRU:
    """Bounded plan cache: dict-shaped (``get`` / ``[key] = entry``) with
    least-recently-used eviction at ``SRT_PLAN_CACHE_SIZE`` entries,
    bumping each name in ``counters`` once per eviction."""

    def __init__(self, name: str, counters: Sequence[str] = ()):
        self.name = name
        self.counters = tuple(counters)
        # N serving workers share the cache; OrderedDict mutation
        # (move_to_end, eviction) is not atomic
        self._entries: "OrderedDict" = OrderedDict()  # guarded-by: self._lock
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def __setitem__(self, key, entry) -> None:
        evicted = []
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            cap = max(1, plan_cache_cap())
            while len(self._entries) > cap:
                evicted.append(self._entries.popitem(last=False)[1])
                for c in self.counters:
                    count(c)
        for old in evicted:
            _release(old)

    def nbytes(self) -> int:
        """The device bytes the entries charge (a dict entry's
        ``"bytes"``)."""
        with self._lock:
            return sum(e.get("bytes", 0) for e in self._entries.values()
                       if isinstance(e, dict))

    def evict_oldest(self, keep=None) -> bool:
        """Evict the least recently used entry other than ``keep``,
        counted and released as an eviction at the cap is; False when no
        other entry is left."""
        with self._lock:
            key = next((k for k, e in self._entries.items()
                        if e is not keep), None)
            if key is None:
                return False
            old = self._entries.pop(key)
            for c in self.counters:
                count(c)
        _release(old)
        return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def values(self) -> list:
        with self._lock:
            return list(self._entries.values())

    def clear(self) -> None:
        with self._lock:
            old = list(self._entries.values())
            self._entries.clear()
        for entry in old:
            _release(entry)
