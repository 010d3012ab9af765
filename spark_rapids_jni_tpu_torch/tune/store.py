"""Revision-keyed persistence of the tuner's winners.

Port of ``spark_rapids_jni_tpu/tune/store.py``. The winner table lives
at ``$SRT_AOT_CACHE_DIR/tuned/<revision>.json``, ``<revision>`` a digest
of ``revision_key()``: the torch and CUDA versions, the card's name and
the kernel library's digest (the reference names jax, jaxlib and its
device topology). A table measured under one revision is never read
under another: an upgrade, another card or an edited kernel misses and
the fleet tunes again.

Writes are atomic (tmp file, then ``os.replace``). A corrupt, stale or
wrong-revision table counts ``tune.store.tuned_stale`` (a marked
fallback), is unlinked, and the knobs fall back to their defaults; knob
resolution never raises.

The active table is memoized a process: resolution is a dict lookup, a
fresh process pays one disk read and no measurement.
``set_active_table`` installs an in-memory table (the runner's trials);
``SRT_TUNE_DISABLE=1`` reads every knob untuned. On a mesh every rank
must plan alike, so ``agree_active_table`` installs the first rank's
table on every rank and checks the digests agree; ``store_table``
writes from rank 0 alone while a process group is up.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import threading
from typing import Dict, Optional

from ..config import env_bool, env_str
from ..obs import count

# bump when the on-disk layout changes: mismatched tables read as stale
TUNE_FORMAT_VERSION = 1

_store_lock = threading.Lock()
# the memoized active table: None = not resolved yet, {} = untuned
_active: Optional[Dict[str, str]] = None  # guarded-by: _store_lock


@functools.lru_cache(maxsize=1)
def _device_name() -> str:
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0)


def revision_key() -> tuple:
    """What a winner table is valid for: the AOT cache's
    ``environment_key`` (torch, CUDA, the kernel library's digest) and
    the card's name."""
    from ..serving.aot_cache import environment_key
    return environment_key() + (_device_name(),)


def revision_digest(key: Optional[tuple] = None) -> str:
    """Filename-safe digest of the revision."""
    key = revision_key() if key is None else key
    return hashlib.sha256(repr(key).encode()).hexdigest()[:32]


def tuned_dir() -> Optional[str]:
    """The winner tables' directory, or None when persistence is off
    (``SRT_AOT_CACHE_DIR`` unset)."""
    d = env_str("SRT_AOT_CACHE_DIR", "").strip()
    return os.path.join(d, "tuned") if d else None


def table_path() -> Optional[str]:
    d = tuned_dir()
    return None if d is None else os.path.join(d, revision_digest() + ".json")


def load_table(path: Optional[str] = None) -> Optional[Dict[str, str]]:
    """Read and check one winner table; None when absent. A corrupt,
    stale-format or wrong-revision file counts ``tune.store.tuned_stale``,
    is unlinked and reads as None."""
    if path is None:
        path = table_path()
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("format") != TUNE_FORMAT_VERSION:
            raise ValueError("stale tune table format")
        if doc.get("revision") != repr(revision_key()):
            raise ValueError("revision mismatch")
        winners = doc.get("winners")
        if not isinstance(winners, dict):
            raise ValueError("malformed winners")
        count("tune.store.loads")
        return {str(k): str(v) for k, v in winners.items()}
    except (OSError, ValueError, AttributeError):
        count("tune.store.tuned_stale")
        try:
            os.unlink(path)
        except OSError:
            pass
        return None


def _writer() -> bool:
    """Rank 0 writes while a process group is up; any process otherwise."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def store_table(winners: Dict[str, str],
                measurements: Optional[dict] = None) -> bool:
    """Publish a winner table for this revision atomically. False
    (counting ``tune.store.save_errors`` on a failed write) when
    persistence is off, the write fails or this rank is not the writer:
    tuning still works in the process."""
    path = table_path()
    if path is None or not _writer():
        return False
    doc = {"format": TUNE_FORMAT_VERSION, "revision": repr(revision_key()),
           "winners": {str(k): str(v) for k, v in winners.items()},
           "measurements": measurements or {}}
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        count("tune.store.saves")
        return True
    except OSError:
        count("tune.store.save_errors")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def active_table() -> Dict[str, str]:
    """The table knob resolution reads: the installed one, else this
    revision's disk table (one read a process), else empty;
    ``SRT_TUNE_DISABLE=1`` forces empty."""
    global _active
    if env_bool("SRT_TUNE_DISABLE", False):
        return {}
    with _store_lock:
        if _active is None:
            _active = load_table() or {}
        return dict(_active)


def set_active_table(winners: Optional[Dict[str, str]]) -> None:
    """Install an in-memory table; None drops back to the disk table."""
    global _active
    with _store_lock:
        _active = (None if winners is None
                   else {str(k): str(v) for k, v in winners.items()})


def reset_active_table_for_testing() -> None:
    set_active_table(None)


def active_winner(name: str) -> Optional[str]:
    """The tuned winner of one knob, or None."""
    return active_table().get(name)


def active_table_digest() -> str:
    """Content digest of the active table, ``"untuned"`` when empty."""
    table = active_table()
    if not table:
        return "untuned"
    blob = json.dumps(table, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def agree_active_table(group=None) -> str:
    """Install the first rank's active table on every rank of ``group``
    (default: the default group) and return its digest: each rank
    broadcasts from the group's first rank and checks its own digest
    against the leader's, so no rank plans under another table. A no-op
    without a process group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return active_table_digest()
    src = (0 if group is None
           else dist.get_global_rank(group, 0))
    buf = [active_table() if dist.get_rank() == src else None]
    dist.broadcast_object_list(buf, src=src, group=group)
    table = buf[0] or {}
    if table != active_table():
        count("tune.store.agreed_from_leader")
        set_active_table(table)
    digest = active_table_digest()
    check = [digest]
    dist.broadcast_object_list(check, src=src, group=group)
    if check[0] != digest:
        raise RuntimeError(f"tuned table digest {digest} on rank "
                           f"{dist.get_rank()} differs from the leader's "
                           f"{check[0]}")
    return digest
