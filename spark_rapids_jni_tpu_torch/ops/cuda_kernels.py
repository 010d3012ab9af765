"""Hand-written Hopper kernels K1-K3, their wrappers and plain versions.

The reference's Pallas kernels on the fused q1-q10 path
(``spark_rapids_jni_tpu/ops/pallas_kernels.py``) become CUDA C++ under
``csrc/``:

- K1 ``hash_join_probe`` (``csrc/hash_join_probe.cu``) replaces
  ``_hash_join_probe`` / ``hash_join_probe_pallas``;
- K2 ``ragged_groupby_sum_count`` (``csrc/ragged_groupby.cu``) replaces
  ``_ragged_groupby`` / ``ragged_groupby_sum_count_pallas``;
- K3 ``bitmask_pack`` (``csrc/bitmask_pack.cu``) replaces
  ``bitmask_pack_pallas``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, at first use, into ``target/torch_kernels/``
(git-ignored), keyed by a digest of the sources and flags; ``ctypes``
binds it. Each source is compiled by its own ``nvcc`` process, all
started together, then linked.

Each wrapper takes its plain PyTorch version for CPU tensors only. For a
CUDA tensor it launches the kernel on the current stream or raises:
there is no fallback. ``LAUNCHES`` counts the ``__global__`` launches
per kernel name, bumped only where a wrapper launches: K1 launches its
build and then its probe (one launch when the build side is empty), K2
and K3 one each.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..utils.errors import CudfLikeError, expects
from .join import hash_table_capacity

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("hash_join_probe.cu", "ragged_groupby.cu", "bitmask_pack.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "target" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# K2's per-block shared memory is width x 12 B; 8192 slots = 96 KB, the
# same width cap as the reference's PALLAS_GROUPBY_MAX_WIDTH.
RAGGED_MAX_WIDTH = 1 << 13

# __global__ launches per kernel name (K1 "hash_join_probe", K2
# "ragged_groupby_sum_count", K3 "bitmask_pack")
LAUNCHES: "collections.Counter[str]" = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


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
        _build(out)
    lib = ctypes.CDLL(str(out))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.srt_hash_join_probe.argtypes = [
        vp, vp, ll, vp, vp, ll, vp, vp, i, vp, vp, vp]
    lib.srt_ragged_groupby_sum_count.argtypes = [
        vp, vp, vp, ll, i, vp, vp, vp]
    lib.srt_bitmask_pack.argtypes = [vp, ll, vp, ll, vp]
    for fn in (lib.srt_hash_join_probe, lib.srt_ragged_groupby_sum_count,
               lib.srt_bitmask_pack):
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
    expects(t.device == dev, f"{what} must lie on {dev}, not {t.device}")
    expects(t.dim() == 1, f"{what} must be 1-D")
    if n is not None:
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


def probe_hash(keys: torch.Tensor) -> torch.Tensor:
    """The reference's ``_probe_hash`` (murmur3 fmix32 of
    lo ^ hi * 0x85EBCA6B over the key's uint32 lanes), in int64 lanes
    holding uint32 values."""
    k64 = keys.to(torch.int64)
    lo = k64 & _U32
    hi = (k64 >> 32) & _U32  # arithmetic shift, masked = logical shift
    k = lo ^ _mul_u32(hi, 0x85EBCA6B)
    k = k ^ (k >> 16)
    k = _mul_u32(k, 0x85EBCA6B)
    k = k ^ (k >> 13)
    k = _mul_u32(k, 0xC2B2AE35)
    return k ^ (k >> 16)


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
    slot_row = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    slot_key = torch.empty(cap, dtype=torch.int64, device=dev)
    rc = kernels().srt_hash_join_probe(
        bkeys.data_ptr(), _ptr(blive), n_build, pkeys.data_ptr(),
        _ptr(plive), n_probe, slot_row.data_ptr(), slot_key.data_ptr(),
        cap, idx.data_ptr(), found.data_ptr(), _stream(dev))
    _check(rc, "hash_join_probe")
    LAUNCHES["hash_join_probe"] += 2 if n_build else 1  # build, probe
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
    sums = torch.zeros(width, dtype=torch.int64, device=dev)
    counts = torch.zeros(width, dtype=torch.int32, device=dev)
    if n == 0:
        return sums, counts
    rc = kernels().srt_ragged_groupby_sum_count(
        s.data_ptr(), lv.data_ptr(), v.data_ptr(), n, width,
        sums.data_ptr(), counts.data_ptr(), _stream(dev))
    _check(rc, "ragged_groupby_sum_count")
    LAUNCHES["ragged_groupby_sum_count"] += 1
    return sums, counts


# --------------------------------------------------------------------------
# K3: validity bitmask pack
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
    LAUNCHES["bitmask_pack"] += 1
    return words
