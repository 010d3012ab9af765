"""Hand-written Hopper kernels K1-K6, their wrappers and plain versions.

The reference's Pallas kernels (``spark_rapids_jni_tpu/ops/
pallas_kernels.py``) become CUDA C++ under ``csrc/``:

- K1 ``hash_join_probe`` (``csrc/hash_join_probe.cu``) replaces
  ``_hash_join_probe`` / ``hash_join_probe_pallas``;
- K2 ``ragged_groupby_sum_count`` (``csrc/ragged_groupby.cu``) replaces
  ``_ragged_groupby`` / ``ragged_groupby_sum_count_pallas``;
- K3 ``bitmask_pack`` (``csrc/bitmask_pack.cu``) replaces
  ``bitmask_pack_pallas``;
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
per kernel name, bumped only where a wrapper launches: K1 launches its
build and then its probe (one launch when the build side is empty), the
others one each. A call with no rows launches nothing (a zero-block grid
is a launch error).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

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

# K2's per-block shared memory is width x 12 B; 8192 slots = 96 KB, the
# same width cap as the reference's PALLAS_GROUPBY_MAX_WIDTH.
RAGGED_MAX_WIDTH = 1 << 13

# __global__ launches per kernel name (K1 "hash_join_probe", K2
# "ragged_groupby_sum_count", K3 "bitmask_pack", K4 "murmur3_int32", K5
# "murmur3_int64", K6 "pack_rows")
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
    lib.srt_murmur3_int32.argtypes = [vp, vp, vp, ll, vp]
    lib.srt_murmur3_int64.argtypes = [vp, vp, vp, ll, vp]
    lib.srt_pack_rows.argtypes = [vp, i, i, i, i, i, ll, vp, vp]
    for fn in (lib.srt_hash_join_probe, lib.srt_ragged_groupby_sum_count,
               lib.srt_bitmask_pack, lib.srt_murmur3_int32,
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
    LAUNCHES[name] += 1
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

@functools.lru_cache(maxsize=256)
def pack_plan(widths: Tuple[int, ...]):
    """K6's plan for a schema of byte widths: (size_per_row, n_words,
    word_first, entries, validity_offset). The entries of output word w
    are ``entries[word_first[w]:word_first[w + 1]]``, each
    ``col | width << 32 | src_shift << 40 | dst_shift << 48``: word w ORs
    in bits ``src_shift`` up of column ``col``'s value (``width`` bytes),
    shifted left by ``dst_shift``. The kernel reads the column and the
    rest as two int32 arrays."""
    size_per_row, starts, validity_offset = fixed_width_layout(widths)
    n_words = size_per_row // 4
    per_word: "list[list[int]]" = [[] for _ in range(n_words)]
    for c, (start, width) in enumerate(zip(starts, widths)):
        part = c | width << 32
        if width == 8:
            per_word[start // 4].append(part)
            per_word[start // 4 + 1].append(part | 32 << 40)
        else:
            per_word[start // 4].append(part | (8 * (start % 4)) << 48)
    word_first = [0]
    for entries in per_word:
        word_first.append(word_first[-1] + len(entries))
    return (size_per_row, n_words, tuple(word_first),
            tuple(e for entries in per_word for e in entries),
            validity_offset)


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
    _, n_words, word_first, entries, voff = pack_plan(widths)
    validity = _validity_list(validity, k)
    cols = [_cuda_input(c, dev, f"column {i}", n)
            for i, c in enumerate(columns)]
    expects(all(v is None or v.element_size() == 4 for v in validity),
            "validity is packed 32-bit words")
    words = [None if v is None else
             _cuda_input(v, dev, f"validity {i}", (n + 31) // 32)
             for i, v in enumerate(validity)]
    out = torch.empty((n, n_words), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    # the plan with this call's pointers, one array on the card (pinned,
    # so the copy does not wait for the stream): int64 pointers, then
    # int32 word_first, entry columns and entry (width, shifts)
    ptrs = torch.tensor([c.data_ptr() for c in cols]
                        + [0 if v is None else v.data_ptr() for v in words],
                        dtype=torch.int64)
    small = list(word_first) + [e & 0xFFFFFFFF for e in entries] \
        + [e >> 32 for e in entries]
    plan = torch.cat([ptrs.view(torch.int32), torch.tensor(
        small + [0] * (len(small) % 2), dtype=torch.int32)])
    plan = plan.pin_memory().to(dev, non_blocking=True)
    rc = kernels().srt_pack_rows(
        plan.data_ptr(), plan.numel() // 2, k, n_words, len(entries), voff,
        n, out.data_ptr(), _stream(dev))
    _check(rc, "pack_rows")
    LAUNCHES["pack_rows"] += 1
    return out
