"""Hand-written Hopper kernels K1-K6, their wrappers and plain versions.

The reference's Pallas kernels (``spark_rapids_jni_tpu/ops/
pallas_kernels.py``) become CUDA C++ under ``csrc/``:

- K1 ``hash_join_probe`` (``csrc/hash_join_probe.cu``) replaces
  ``_hash_join_probe`` / ``hash_join_probe_pallas``;
- K2 ``ragged_groupby_sum_count`` (``csrc/ragged_groupby.cu``) replaces
  ``_ragged_groupby`` / ``ragged_groupby_sum_count_pallas``;
- K3 ``bitmask_pack`` (``csrc/bitmask_pack.cu``) replaces
  ``bitmask_pack_pallas``; its table form ``bitmask_pack_fields`` packs
  every column of the row format's validity bytes in one launch;
- K4 ``murmur3_int32`` and K5 ``murmur3_int64`` (``csrc/murmur3.cu``)
  replace ``murmur3_int32_pallas`` and ``murmur3_int64_pallas``
  (``hashing.murmur3_table`` chains K5 over int64 columns as
  ``murmur3_int64_table_pallas`` does);
- K6 ``pack_rows`` (``csrc/pack_rows.cu``) replaces
  ``_pack_rows_compiled`` / ``pack_rows_pallas``, with real validity.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, at first use, into ``target/torch_kernels/``
(git-ignored), keyed by a digest of the sources and flags; ``ctypes``
binds it. Each source is compiled by its own ``nvcc`` process, all
started together, then linked.

Each wrapper takes its plain PyTorch version for CPU tensors only. For a
CUDA tensor it launches the kernel on the current stream or raises:
there is no fallback. ``LAUNCHES`` counts the ``__global__`` launches
per kernel name, bumped only where a wrapper launches: K1 launches once
when its table fits in shared memory (``probe_table_shared``) and
otherwise its build and then its probe, K2 once a call (it writes its
outputs whole, so a call with no rows launches it too), the others one
each. Any other call with no rows launches nothing (a zero-block grid is
a launch error). While this thread captures a CUDA graph
(``capture_launches``), a wrapper's launches go to the capture's own
counter instead: nothing runs during a capture, and the graph's owner
adds them to ``LAUNCHES`` on every replay
(``serving/aot_cache.capture_graph``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import functools
import hashlib
import itertools
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from ..columnar import bitmask
from ..utils.errors import CudfLikeError, expects
from .join import hash_table_capacity
from .row_layout import fixed_width_layout

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("hash_join_probe.cu", "ragged_groupby.cu", "bitmask_pack.cu",
           "murmur3.cu", "pack_rows.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "target" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# K1 tables of at most this many 16-byte slots (128 KB) are built in each
# block's shared memory (``probe_table_shared``)
PROBE_SHARED_SLOTS = 1 << 13

# K2's per-block shared memory is width x 12 B a copy; 8192 slots = 96 KB,
# the same width cap as the reference's PALLAS_GROUPBY_MAX_WIDTH.
RAGGED_MAX_WIDTH = 1 << 13
# the shared memory K2's copies of the slots may take (ragged_copies)
RAGGED_COPY_BYTES = 192 * 1024
# K2 launches a block for each this many rows, up to one an SM
# (csrc/ragged_groupby.cu kBlockRows); the workspace holds their partials
RAGGED_BLOCK_ROWS = 2048

# __global__ launches per kernel name (K1 "hash_join_probe", K2
# "ragged_groupby_sum_count", K3 "bitmask_pack" and its table form
# "bitmask_pack_fields", K4 "murmur3_int32", K5 "murmur3_int64", K6
# "pack_rows")
LAUNCHES: "collections.Counter[str]" = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


# a graph capture in progress on this thread: its launch counter
_capture_tls = threading.local()


def _count_launch(name: str, n: int = 1) -> None:
    rec = getattr(_capture_tls, "launches", None)
    (LAUNCHES if rec is None else rec)[name] += n


@contextlib.contextmanager
def capture_launches():
    """Count this thread's wrapper launches into a fresh Counter, yielded,
    instead of ``LAUNCHES``, for the duration of a graph capture."""
    prev = getattr(_capture_tls, "launches", None)
    rec: "collections.Counter[str]" = collections.Counter()
    _capture_tls.launches = rec
    try:
        yield rec
    finally:
        _capture_tls.launches = prev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise CudfLikeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library built from the current sources and flags lives
    (its ``nvcc`` output sits beside it, with the suffix ``.log``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsrt_torch_kernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile every source with its own ``nvcc``, all started together,
    link them into ``out`` and write the compilers' output beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{Path(name).stem}.o" for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        logs = [f"== {name}\n{p.communicate()[0]}"
                for name, p in zip(SOURCES, procs)]
        failed = [n for n, p in zip(SOURCES, procs) if p.returncode != 0]
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", f"{tmp}/lib.so", *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(f"== link\n{link.stdout}")
            failed = ["link"] if link.returncode != 0 else []
        log = "\n".join(logs)
        out.with_suffix(".log").write_text(log)
        if failed:
            raise CudfLikeError(f"nvcc failed for {failed}:\n{log}")
        os.replace(f"{tmp}/lib.so", out)


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The kernel library, built at first use (or reused when one built
    from identical sources and flags exists) and bound once per process."""
    out = library_path()
    if not out.exists():
        t0 = time.perf_counter_ns()
        _build(out)
        # the port's one run-time compile: a cold process's first report
        # shows it (obs/recompile.py)
        from ..obs.recompile import record_event
        record_event("ops.cuda_kernels.build", "compile", (out.name,),
                     duration_s=(time.perf_counter_ns() - t0) / 1e9)
    lib = ctypes.CDLL(str(out))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.srt_hash_join_probe.argtypes = [
        vp, vp, ll, vp, vp, ll, vp, i, vp, vp, vp]
    lib.srt_ragged_groupby_sum_count.argtypes = [
        vp, vp, vp, ll, i, i, i, vp, vp, vp, vp]
    lib.srt_ragged_groupby_max_blocks.argtypes = []
    lib.srt_bitmask_pack.argtypes = [vp, ll, vp, ll, vp]
    lib.srt_bitmask_pack_fields.argtypes = [vp, ll, ll, i, vp, ll, vp]
    lib.srt_murmur3_int32.argtypes = [vp, vp, vp, ll, vp]
    lib.srt_murmur3_int64.argtypes = [vp, vp, vp, ll, vp]
    lib.srt_pack_rows.argtypes = [vp, i, i, i, i, i, i, i, vp, ll, vp, vp]
    for fn in (lib.srt_hash_join_probe, lib.srt_ragged_groupby_sum_count,
               lib.srt_ragged_groupby_max_blocks, lib.srt_bitmask_pack,
               lib.srt_bitmask_pack_fields, lib.srt_murmur3_int32,
               lib.srt_murmur3_int64, lib.srt_pack_rows):
        fn.restype = ctypes.c_int
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise CudfLikeError(f"CUDA kernel {name} failed to launch: error "
                            f"{rc} ({torch.cuda.get_device_name()})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _cuda_input(t: torch.Tensor, dev: torch.device, what: str,
                n: Optional[int] = None) -> torch.Tensor:
    if t.device != dev or t.dim() != 1 or (n is not None
                                           and t.shape[0] != n):
        # the messages are built only on failure: formatting them on every
        # call was most of a many-column wrapper call's host time
        expects(t.device == dev, f"{what} must lie on {dev}, not {t.device}")
        expects(t.dim() == 1, f"{what} must be 1-D")
        expects(t.shape[0] == n, f"{what} has {t.shape[0]} rows, want {n}")
    return t.contiguous()


def _live_mask(live: Optional[torch.Tensor], dev: torch.device, n: int,
               what: str) -> Optional[torch.Tensor]:
    if live is None:
        return None
    expects(live.dtype == torch.bool, f"{what} must be bool")
    return _cuda_input(live, dev, what, n)


# --------------------------------------------------------------------------
# K1: hash-join probe
# --------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split ``c`` into 16-bit
    halves so no product leaves int64 (int32 multiply would wrap at the
    wrong width and uint32 arithmetic is not implemented in torch)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def fmix32(k: torch.Tensor) -> torch.Tensor:
    """Murmur3's 32-bit finalizer on int64 lanes holding uint32 values."""
    k = k ^ (k >> 16)
    k = _mul_u32(k, 0x85EBCA6B)
    k = k ^ (k >> 13)
    k = _mul_u32(k, 0xC2B2AE35)
    return k ^ (k >> 16)


def probe_hash(keys: torch.Tensor) -> torch.Tensor:
    """The reference's ``_probe_hash`` (murmur3 fmix32 of
    lo ^ hi * 0x85EBCA6B over the key's uint32 lanes), in int64 lanes
    holding uint32 values."""
    k64 = keys.to(torch.int64)
    lo = k64 & _U32
    hi = (k64 >> 32) & _U32  # arithmetic shift, masked = logical shift
    return fmix32(lo ^ _mul_u32(hi, 0x85EBCA6B))


def hash_join_probe_plain(build_keys: torch.Tensor, probe_keys: torch.Tensor,
                          build_live: Optional[torch.Tensor] = None,
                          probe_live: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: the reference's lowest-row-wins tournament build
    (``_build_join_table``) and a vectorized linear-probing walk."""
    dev = probe_keys.device
    n_probe = int(probe_keys.shape[0])
    if n_probe == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    n = int(build_keys.shape[0])
    cap = hash_table_capacity(n)
    bkeys = build_keys.to(torch.int64)
    pkeys = probe_keys.to(torch.int64)
    tbl = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    if n:
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        h0 = probe_hash(bkeys)
        placed = (torch.zeros(n, dtype=torch.bool, device=dev)
                  if build_live is None else ~build_live)
        step = 0
        while step < cap + n and not bool(placed.all()):
            cand = (h0 + step) & (cap - 1)
            can_take = ~placed & (tbl[cand] < 0)
            cand_m = torch.where(can_take, cand, cap)
            winner = torch.full((cap + 1,), 2**31 - 1, dtype=torch.int32,
                                device=dev)
            winner.scatter_reduce_(0, cand_m, rows, "amin")
            won = can_take & (winner[cand] == rows)
            tbl[torch.where(won, cand, cap)] = rows
            tbl[cap] = -1
            placed = placed | won
            step += 1
    tbl = tbl[:cap]
    tkey = bkeys[tbl.clamp(min=0).to(torch.int64)] if n else \
        torch.zeros(cap, dtype=torch.int64, device=dev)
    h = probe_hash(pkeys) & (cap - 1)
    idx = torch.zeros(n_probe, dtype=torch.int32, device=dev)
    found = torch.zeros(n_probe, dtype=torch.bool, device=dev)
    done = (torch.zeros(n_probe, dtype=torch.bool, device=dev)
            if probe_live is None else ~probe_live)
    for _ in range(cap):
        if bool(done.all()):
            break
        row = tbl[h]
        empty = row < 0
        match = ~empty & (tkey[h] == pkeys)
        newly = match & ~done
        idx = torch.where(newly, row, idx)
        found = found | newly
        done = done | match | empty
        h = (h + 1) & (cap - 1)
    return idx, found


def probe_table_shared(n_build: int) -> bool:
    """Whether K1's table of ``n_build`` build rows is built in each
    block's shared memory (one launch) rather than on the card (its build
    and its probe: two launches)."""
    return hash_table_capacity(n_build) <= PROBE_SHARED_SLOTS


def hash_join_probe(build_keys: torch.Tensor, probe_keys: torch.Tensor,
                    build_live: Optional[torch.Tensor] = None,
                    probe_live: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(build_row_index int32, found bool) per probe row: the
    ``dense_lookup`` contract, equal to it whenever the live build keys
    are unique (the planner's precondition). Dead build rows never enter
    the table; dead probe rows report (0, False). Capacity is
    ``hash_table_capacity(len(build_keys))`` (load factor <= 0.5)."""
    expects(not build_keys.dtype.is_floating_point
            and not probe_keys.dtype.is_floating_point,
            "hash_join_probe takes integral keys")
    dev = probe_keys.device
    if dev.type == "cpu":
        return hash_join_probe_plain(build_keys, probe_keys, build_live,
                                     probe_live)
    n_build, n_probe = int(build_keys.shape[0]), int(probe_keys.shape[0])
    bkeys = _cuda_input(build_keys.to(torch.int64), dev, "build keys")
    pkeys = _cuda_input(probe_keys.to(torch.int64), dev, "probe keys")
    blive = _live_mask(build_live, dev, n_build, "build_live")
    plive = _live_mask(probe_live, dev, n_probe, "probe_live")
    idx = torch.empty(n_probe, dtype=torch.int32, device=dev)
    found = torch.empty(n_probe, dtype=torch.bool, device=dev)
    if n_probe == 0:
        return idx, found
    cap = hash_table_capacity(n_build)
    expects(cap < 2**31, "hash table capacity exceeds int32")
    # no table: the kernel builds one in each block's shared memory (one
    # launch); else 16-byte slots on the card (filled, built, then probed:
    # two launches)
    shared = probe_table_shared(n_build)
    table = None if shared else torch.empty(
        (cap, 4), dtype=torch.int32, device=dev)
    rc = kernels().srt_hash_join_probe(
        bkeys.data_ptr(), _ptr(blive), n_build, pkeys.data_ptr(),
        _ptr(plive), n_probe, _ptr(table), cap, idx.data_ptr(),
        found.data_ptr(), _stream(dev))
    _check(rc, "hash_join_probe")
    _count_launch("hash_join_probe", 1 if shared else 2)  # build, probe
    return idx, found


# --------------------------------------------------------------------------
# K2: ragged groupby sum + count
# --------------------------------------------------------------------------

def ragged_groupby_sum_count_plain(slots: torch.Tensor, live: torch.Tensor,
                                   values: torch.Tensor, width: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: ``index_add_`` into a sentinel-extended buffer
    (dead and out-of-range rows park in slot ``width``), then slice."""
    dev = slots.device
    ok = live & (slots >= 0) & (slots < width)
    slot = torch.where(ok, slots.to(torch.int64), width)
    sums = torch.zeros(width + 1, dtype=torch.int64, device=dev)
    sums.index_add_(0, slot, values.to(torch.int64))
    counts = torch.zeros(width + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return sums[:width], counts[:width]


@functools.lru_cache(maxsize=None)
def _ragged_max_blocks(device_index: int) -> int:
    """K2's grid cap on a device (its SM count: one block an SM), read
    once a device."""
    with torch.cuda.device(device_index):
        blocks = kernels().srt_ragged_groupby_max_blocks()
    _check(-blocks if blocks < 0 else 0, "ragged_groupby_sum_count")
    return blocks


def ragged_copies(width: int) -> int:
    """K2's copies of the slots in each block's shared memory (12 B a slot
    a copy), as many as fit ``RAGGED_COPY_BYTES``: one a thread (1024, up
    to 16 slots: plain adds), else a power of two up to one a warp (32,
    shared-memory atomics). More copies, fewer rows meeting on one
    address (PERF.md, ``tools/torch_k2_copies.py``)."""
    fit = RAGGED_COPY_BYTES // (12 * width)
    return 1024 if fit >= 1024 else min(32, 1 << (fit.bit_length() - 1))


def ragged_groupby_sum_count(slots: torch.Tensor, live: torch.Tensor,
                             values: torch.Tensor, width: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot (sum int64, count int32) over dense int32 slot codes for
    INTEGRAL values, exact mod 2^64. Dead rows and rows whose slot lies
    outside [0, width) are skipped."""
    expects(not values.dtype.is_floating_point,
            "ragged_groupby_sum_count takes integral values only")
    width = int(width)
    dev = slots.device
    if dev.type == "cpu":
        return ragged_groupby_sum_count_plain(slots, live, values, width)
    expects(0 < width <= RAGGED_MAX_WIDTH,
            f"ragged groupby width {width} outside (0, {RAGGED_MAX_WIDTH}]")
    n = int(slots.shape[0])
    s = _cuda_input(slots.to(torch.int32), dev, "slots")
    lv = _live_mask(live, dev, n, "live")
    expects(lv is not None, "live mask is required")
    v = _cuda_input(values.to(torch.int64), dev, "values", n)
    # one launch writes every output slot: nothing is zeroed first
    blocks = max(1, min(_ragged_max_blocks(dev.index or 0),
                        -(-n // RAGGED_BLOCK_ROWS)))
    copies = ragged_copies(width)
    workspace = torch.empty(blocks * width * 12, dtype=torch.uint8,
                            device=dev)
    sums = torch.empty(width, dtype=torch.int64, device=dev)
    counts = torch.empty(width, dtype=torch.int32, device=dev)
    rc = kernels().srt_ragged_groupby_sum_count(
        s.data_ptr(), lv.data_ptr(), v.data_ptr(), n, width, copies, blocks,
        workspace.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        _stream(dev))
    _check(rc, "ragged_groupby_sum_count")
    _count_launch("ragged_groupby_sum_count")
    return sums, counts


# --------------------------------------------------------------------------
# K3: validity bitmask pack, a vector and a table of columns
# --------------------------------------------------------------------------

def bitmask_pack_plain(valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: pad to a multiple of 32, reshape (words, 32),
    weighted sum with 1 << lane (in int64: torch has no uint32 shifts)."""
    n = int(valid.shape[0])
    w = (n + 31) // 32
    bits = torch.zeros(w * 32, dtype=torch.int64, device=valid.device)
    bits[:n] = valid.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=valid.device) \
        << torch.arange(32, dtype=torch.int64, device=valid.device)
    return (bits.reshape(w, 32) * weights).sum(dim=1).to(torch.uint32)


def bitmask_pack(valid: torch.Tensor) -> torch.Tensor:
    """bool (N,) -> uint32 words (ceil(N/32),), LSB-first, padding 0."""
    dev = valid.device
    if dev.type == "cpu":
        return bitmask_pack_plain(valid)
    expects(valid.dtype == torch.bool, "bitmask_pack takes a bool vector")
    v = _cuda_input(valid, dev, "valid")
    n = int(v.shape[0])
    n_words = (n + 31) // 32
    words = torch.empty(n_words, dtype=torch.uint32, device=dev)
    if n_words == 0:
        return words
    rc = kernels().srt_bitmask_pack(v.data_ptr(), n, words.data_ptr(),
                                        n_words, _stream(dev))
    _check(rc, "bitmask_pack")
    _count_launch("bitmask_pack")
    return words


def bitmask_pack_fields_plain(vbytes: torch.Tensor, n_fields: int
                              ) -> torch.Tensor:
    """Plain PyTorch K3, table form: unpack the validity bytes to a bool
    (N, n_fields) matrix and pack each column as ``bitmask_pack_plain``
    does, all columns at once."""
    n = int(vbytes.shape[0])
    w = (n + 31) // 32
    bits = torch.zeros((n_fields, w * 32), dtype=torch.int64,
                       device=vbytes.device)
    bits[:, :n] = bitmask.unpack_bytes(vbytes, n_fields).T.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=vbytes.device) \
        << torch.arange(32, dtype=torch.int64, device=vbytes.device)
    return (bits.reshape(n_fields, w, 32) * weights).sum(dim=2) \
        .to(torch.uint32)


def bitmask_pack_fields(vbytes: torch.Tensor, n_fields: int
                        ) -> torch.Tensor:
    """The row format's validity bytes, uint8 (N, ceil(n_fields / 8)) at
    any row stride (bit ``c % 8`` of byte ``c / 8`` is column ``c``) ->
    uint32 (n_fields, ceil(N/32)): row ``c`` is column ``c``'s words,
    LSB-first, padding 0. One launch for every column."""
    n_fields = int(n_fields)
    expects(vbytes.dtype == torch.uint8 and vbytes.dim() == 2,
            "bitmask_pack_fields takes a uint8 (rows, bytes) matrix")
    expects(n_fields > 0 and vbytes.shape[1] == (n_fields + 7) // 8,
            f"{vbytes.shape[1]} validity bytes a row for {n_fields} fields")
    dev = vbytes.device
    if dev.type == "cpu":
        return bitmask_pack_fields_plain(vbytes, n_fields)
    n = int(vbytes.shape[0])
    n_words = (n + 31) // 32
    out = torch.empty((n_fields, n_words), dtype=torch.uint32, device=dev)
    if n_words == 0:
        return out
    if vbytes.stride(1) != 1:
        vbytes = vbytes.contiguous()
    rc = kernels().srt_bitmask_pack_fields(
        vbytes.data_ptr(), vbytes.stride(0), n, n_fields, out.data_ptr(),
        n_words, _stream(dev))
    _check(rc, "bitmask_pack_fields")
    _count_launch("bitmask_pack_fields")
    return out


# --------------------------------------------------------------------------
# K4, K5: Spark murmur3 of one 4-byte block / one 8-byte value per row
# --------------------------------------------------------------------------

def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate left on int64 lanes holding uint32 values."""
    return ((x << r) | (x >> (32 - r))) & _U32


def murmur3_mix(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One murmur3 block round (Spark ``mixK1`` then ``mixH1``) on int64
    lanes holding uint32 values."""
    k = _mul_u32(rotl32(_mul_u32(k, 0xCC9E2D51), 15), 0x1B873593)
    h = rotl32(h ^ k, 13)
    return (_mul_u32(h, 5) + 0xE6546B64) & _U32


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding uint32 values -> int32 with the same bits."""
    return ((x & _U32) ^ 0x80000000).sub_(0x80000000).to(torch.int32)


def murmur3_int32_plain(blocks: torch.Tensor, seeds: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch K4 in int64 lanes."""
    h = murmur3_mix(seeds.to(torch.int64) & _U32,
                    blocks.to(torch.int64) & _U32)
    return as_int32(fmix32(h ^ 4))


def murmur3_int64_plain(values: torch.Tensor, seeds: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch K5 in int64 lanes: the low word, then the high."""
    v = values.to(torch.int64)
    h = murmur3_mix(seeds.to(torch.int64) & _U32, v & _U32)
    h = murmur3_mix(h, (v >> 32) & _U32)
    return as_int32(fmix32(h ^ 8))


def _murmur3_launch(name: str, values: torch.Tensor, seeds: torch.Tensor,
                    value_dtype: torch.dtype, plain) -> torch.Tensor:
    expects(values.dtype == value_dtype and seeds.dtype == torch.int32,
            f"{name} takes {value_dtype} values and int32 seeds, not "
            f"{values.dtype} and {seeds.dtype}")
    dev = values.device
    if dev.type == "cpu":
        return plain(values, seeds)
    n = int(values.shape[0])
    v = _cuda_input(values, dev, "values")
    s = _cuda_input(seeds, dev, "seeds", n)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    rc = getattr(kernels(), f"srt_{name}")(v.data_ptr(), s.data_ptr(),
                                           out.data_ptr(), n, _stream(dev))
    _check(rc, name)
    _count_launch(name)
    return out


def murmur3_int32(blocks: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Spark murmur3 of one int32 block per row from per-row int32 seeds,
    total length 4 -> int32 (N,)."""
    return _murmur3_launch("murmur3_int32", blocks, seeds, torch.int32,
                           murmur3_int32_plain)


def murmur3_int64(values: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Spark murmur3 of one int64 value per row (low word first) from
    per-row int32 seeds, total length 8 -> int32 (N,)."""
    return _murmur3_launch("murmur3_int64", values, seeds, torch.int64,
                           murmur3_int64_plain)


# --------------------------------------------------------------------------
# K6: fixed-width columns -> row-format word image
# --------------------------------------------------------------------------

# K6: the shared memory of a block when two fit on an SM, and when one
# takes the SM; the most rows a tile holds
PACK_SMEM_BYTES = 110 * 1024
PACK_SMEM_ONE_BLOCK = 220 * 1024
PACK_MAX_TILE = 256


class PackPlan(NamedTuple):
    """K6's plan for a schema (``pack_plan``)."""
    size_per_row: int
    n_words: int
    validity_offset: int
    tile_rows: int          # T: rows a tile stages, a multiple of 32
    # (c0, c1, lo, hi, vc0, vc1, vst): the columns of each segment, its
    # bytes [lo, hi) of the row, the columns whose validity bits its
    # validity bytes hold, and where their validity words are staged
    segments: Tuple[Tuple[int, ...], ...]
    # (staged offset | width << 24, byte in the row), per column
    cols: Tuple[Tuple[int, int], ...]
    buf_bytes: int          # one staging buffer
    img_stride: int         # bytes between image rows, an odd multiple of 8

    @property
    def smem_bytes(self) -> int:
        return 2 * self.buf_bytes + self.tile_rows * self.img_stride

    def words(self) -> Tuple[int, ...]:
        """The plan as the kernel reads it (int32): 8 per segment, then 2
        per column."""
        return tuple(x for seg in self.segments for x in seg + (0,)) \
            + tuple(x for col in self.cols for x in col)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _pack_segment(widths, starts, voff, size_per_row, b0: int, b1: int):
    """The segment of row bytes [16 b0, 16 b1): its columns (those that
    start there: none straddles a 16-byte boundary), its bytes and the
    columns whose validity bits its validity bytes hold."""
    k, lo, hi = len(widths), 16 * b0, min(16 * b1, size_per_row)
    c0, c1 = bisect.bisect_left(starts, lo), bisect.bisect_left(starts, hi)
    vb0 = max(lo - voff, 0)
    vb1 = min(hi - voff, (k + 7) // 8)
    vc0, vc1 = (8 * vb0, min(8 * vb1, k)) if vb1 > vb0 else (0, 0)
    return (c0, c1, lo, hi, vc0, vc1)


def _img_stride(segments) -> int:
    """Image rows hold the largest segment, padded to an odd number of
    8-byte units (8-byte stores of a half-warp on distinct banks)."""
    most = max(s[3] - s[2] for s in segments)
    return most if most % 16 == 8 else most + 8


def _pack_sizes(prefix, segments, tile: int) -> Tuple[int, int]:
    """(buf_bytes, image_bytes) of tiles of ``tile`` rows (``prefix``:
    the running sum of the widths): a buffer holds a segment's column
    runs, then its validity words."""
    buf = max(_align16(tile * (prefix[s[1]] - prefix[s[0]]))
              + _align16(4 * (tile // 32) * (s[5] - s[4])) for s in segments)
    return buf, tile * _img_stride(segments)


@functools.lru_cache(maxsize=256)
def pack_plan(widths: Tuple[int, ...]) -> PackPlan:
    """K6's plan for a schema of byte widths. T is the largest multiple
    of 32 up to ``PACK_MAX_TILE`` whose two staging buffers and row image
    fit ``PACK_SMEM_BYTES`` (two blocks an SM); where that leaves fewer
    than 128 rows, a block takes the SM (``PACK_SMEM_ONE_BLOCK``) for a
    larger T: wide rows gain more from long tiles than from a second
    block. When 32 rows of the whole row fit neither, the row is cut
    greedily into segments at 16-byte boundaries, each within half of
    ``PACK_SMEM_BYTES`` (so the largest buffer and the largest image of
    any two segments fit together), and made 32 rows at a time. Column c is
    staged at ``cols[c][0] & 0xFFFFFF`` of its segment's buffer (T values
    of ``cols[c][0] >> 24`` bytes) and goes to byte ``cols[c][1]`` of the
    row."""
    size_per_row, starts, voff = fixed_width_layout(widths)
    blocks = -(-size_per_row // 16)
    prefix = [0, *itertools.accumulate(widths)]

    def segment(b0, b1):
        return _pack_segment(widths, starts, voff, size_per_row, b0, b1)

    def fits(seg, tile, budget):
        buf, image = _pack_sizes(prefix, [seg], tile)
        return 2 * buf + image <= budget

    def largest_tile(seg, budget):
        return next((t for t in range(PACK_MAX_TILE, 31, -32)
                     if fits(seg, t, budget)), 0)

    segments = [segment(0, blocks)]
    tile = largest_tile(segments[0], PACK_SMEM_BYTES)
    if tile < 128:
        tile = max(tile, largest_tile(segments[0], PACK_SMEM_ONE_BLOCK))
    if not tile:
        tile, segments, b0 = 32, [], 0
        while b0 < blocks:
            b1 = b0 + 1
            expects(fits(segment(b0, b1), tile, PACK_SMEM_BYTES // 2),
                    "a 16-byte segment exceeds K6's shared memory")
            while b1 < blocks and fits(segment(b0, b1 + 1), tile,
                                       PACK_SMEM_BYTES // 2):
                b1 += 1
            segments.append(segment(b0, b1))
            b0 = b1
    cols = [(0, 0)] * len(widths)
    for c0, c1, *_ in segments:
        for c in range(c0, c1):
            cols[c] = (tile * (prefix[c] - prefix[c0]) | widths[c] << 24,
                       starts[c])
    buf_bytes, _ = _pack_sizes(prefix, segments, tile)
    return PackPlan(
        size_per_row, size_per_row // 4, voff, tile,
        tuple(s + (_align16(tile * (prefix[s[1]] - prefix[s[0]])),)
              for s in segments),
        tuple(cols), buf_bytes, _img_stride(segments))


@functools.lru_cache(maxsize=256)
def _plan_on_card(widths: Tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """The schema's plan as int32 on the card, copied once."""
    return torch.tensor(pack_plan(widths).words(), dtype=torch.int32,
                        device=dev)


def _validity_list(validity, k: int) -> list:
    validity = [None] * k if validity is None else list(validity)
    expects(len(validity) == k, "one validity entry per column")
    return validity


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """(N, ...) tensor -> (N, bytes per row) uint8 of its little-endian
    storage (an empty tensor from numpy may carry stride 0, which
    ``view`` refuses)."""
    n = int(t.shape[0])
    width = t.element_size() * math.prod(t.shape[1:])
    if n == 0:
        return torch.zeros((0, width), dtype=torch.uint8, device=t.device)
    return t.contiguous().view(torch.uint8).reshape(n, width)


def pack_rows_plain(columns, widths, validity=None) -> torch.Tensor:
    """Plain PyTorch K6: each column's little-endian bytes into its slot
    of a zeroed (N, size_per_row) byte matrix, then the validity bytes;
    returned as (N, size_per_row / 4) int32 words."""
    widths = tuple(int(w) for w in widths)
    size_per_row, starts, voff = fixed_width_layout(widths)
    n = int(columns[0].shape[0])
    dev = columns[0].device
    validity = _validity_list(validity, len(widths))
    mat = torch.zeros((n, size_per_row), dtype=torch.uint8, device=dev)
    for col, start, width in zip(columns, starts, widths):
        mat[:, start:start + width] = as_bytes(col)
    valid = torch.stack([torch.ones(n, dtype=torch.bool, device=dev)
                         if v is None else bitmask.unpack(v, n)
                         for v in validity], dim=1)
    nb = (len(widths) + 7) // 8
    mat[:, voff:voff + nb] = bitmask.pack_bytes(valid, len(widths))
    return mat.view(torch.int32)


def pack_rows(columns, widths, validity=None) -> torch.Tensor:
    """Fixed-width columns of byte widths 1, 2, 4 or 8 -> the row
    format's (N, size_per_row / 4) word image (int32 storage,
    little-endian bytes). ``validity`` holds one packed uint32 word
    tensor or None (all valid) per column."""
    widths = tuple(int(w) for w in widths)
    k = len(widths)
    expects(k > 0 and len(columns) == k, "one width per column")
    expects(all(w in (1, 2, 4, 8) for w in widths),
            f"pack_rows takes widths 1, 2, 4 or 8, not {widths}")
    expects(all(c.dim() == 1 and c.element_size() == w
                for c, w in zip(columns, widths)),
            "each column is 1-D with elements of its width")
    dev = columns[0].device
    if dev.type == "cpu":
        return pack_rows_plain(columns, widths, validity)
    n = int(columns[0].shape[0])
    plan = pack_plan(widths)
    validity = _validity_list(validity, k)
    cols = [_cuda_input(c, dev, f"column {i}", n)
            for i, c in enumerate(columns)]
    expects(all(v is None or v.element_size() == 4 for v in validity),
            "validity is packed 32-bit words")
    words = [None if v is None else
             _cuda_input(v, dev, f"validity {i}", (n + 31) // 32)
             for i, v in enumerate(validity)]
    out = torch.empty((n, plan.n_words), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    # this call's pointers, one small array on the card (pinned, so the
    # copy does not wait for the stream)
    ptrs = torch.tensor([c.data_ptr() for c in cols]
                        + [0 if v is None else v.data_ptr() for v in words],
                        dtype=torch.int64).pin_memory().to(dev,
                                                           non_blocking=True)
    rc = kernels().srt_pack_rows(
        _plan_on_card(widths, dev).data_ptr(), k, plan.size_per_row,
        len(plan.segments), plan.validity_offset, plan.tile_rows,
        plan.buf_bytes, plan.img_stride, ptrs.data_ptr(), n,
        out.data_ptr(), _stream(dev))
    _check(rc, "pack_rows")
    _count_launch("pack_rows")
    return out
