"""ctypes bindings to the port's native library.

Port of ``spark_rapids_jni_tpu/native.py``: the same Python API and names
over the same C ABI (``srt_*``). The library, ``libsrt_torch_native-
<digest>.so``, is built at first ``load()`` into ``target/torch_native/``
(git-ignored) from:

- the reference's host sources, unedited, where they are
  (``src/main/cpp/src/*.cpp``: the handle registry's tables, row
  conversion, the hashes, sort, joins and groupby, the casts, the
  get_json_object walker, the Arrow import, the arena and the resource
  adaptor) and its JNI sources but ``PjrtEngineJni.cpp``
  (``src/main/cpp/jni``, against the vendored ``jni.h``), so a JVM that
  loads the library reaches the card through ``DeviceTableJni``,
  ``RowConversionJni``, ``HashJni`` and ``RelationalJni``;
- ``csrc/native/engine_jni.cpp``, the port's own ``PjrtEngine`` natives
  over the CUDA engine in place of ``PjrtEngineJni.cpp`` (its deviations
  are in its header comment);
- ``csrc/native/c_api.cpp``, the port's copy of the reference's C ABI
  with its device half behind ``csrc/native/device_engine.hpp``;
- on a host with a CUDA device, the engine ``csrc/native/cuda_engine.cu``
  and ``cuda_sort.cu`` and the port's K4/K5 (``csrc/murmur3.cu``) and K6
  (``csrc/pack_rows.cu``), with ``nvcc`` for ``sm_90a``; elsewhere
  ``csrc/native/no_device_engine.cpp``, with the C++ compiler alone.

The variant follows ``torch.cuda.is_available()``, never whether ``nvcc``
is found: on a host with the card a failed ``nvcc`` build raises. Each
source is compiled by its own process, all started together; the file
name holds a digest of every source, header and flag; a file lock and an
atomic rename make parallel processes build once.

``load(device=None)`` resolves the device as the port's entry points do
(``cuda`` unless the caller asks for the CPU) and, on the card, starts
the CUDA engine (raising if it cannot). The host-table entry points then
route to the card as the reference's route to its PJRT programs: every
call the device route admits runs there (``kernel_was_device`` reads 1),
the rest on the host (0); a device call that fails raises and reads 2,
with no host retry. ``available()`` never builds: it is true once
``load()`` has succeeded in this process.

Differences from the reference's binding: the engine is CUDA's, so
``cuda_init``/``cuda_available``/``cuda_device_count``/
``cuda_platform_name`` stand for the ``pjrt_*`` functions, and the
StableHLO functions (``pjrt_compile_mlir``, ``pjrt_execute``,
``pjrt_register_program``, ...) have no twin: the kernels are compiled
into the library. ``DeviceBuffer.then`` serves the names of the engine's
hashes. The resource adaptor raises ``utils/faults.RetryOOM`` and
``SplitAndRetryOOM``, which ``serving/reliability.retry_action`` maps.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .obs import traced
from .types import DType, TypeId
from .utils.device import resolve_device
from .utils.errors import CudfLikeError
from .utils.faults import RetryOOM, SplitAndRetryOOM

ROOT = Path(__file__).resolve().parents[1]
CPP = ROOT / "src" / "main" / "cpp"
CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = CSRC / "native"
BUILD_DIR = ROOT / "target" / "torch_native"

HOST_SOURCES = tuple(CPP / "src" / f"{name}.cpp" for name in (
    "arena", "table", "row_conversion", "relational", "cast_strings",
    "arrow_interop", "hashing", "resource_adaptor", "get_json_object"))
JNI_SOURCES = tuple(CPP / "jni" / f"{name}.cpp" for name in (
    "RowConversionJni", "HashJni", "RmmSparkJni", "TpuTableJni",
    "RelationalJni", "CastStringsJni", "GetJsonObjectJni",
    "DeviceTableJni")) + (NATIVE / "engine_jni.cpp",)
CUDA_SOURCES = (NATIVE / "cuda_engine.cu", NATIVE / "cuda_sort.cu",
                CSRC / "murmur3.cu", CSRC / "pack_rows.cu")
NO_CUDA_SOURCES = (NATIVE / "no_device_engine.cpp",)
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-I", "src/main/cpp/include",
             "-I", "src/main/cpp/include/vendored_jni", "-I",
             "spark_rapids_jni_tpu_torch/csrc/native")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I",
              "src/main/cpp/include")
LINK_FLAGS = ("-ldl", "-lpthread")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def variant() -> str:
    """``cuda`` on a host with a CUDA device, else ``host``."""
    return "cuda" if torch.cuda.is_available() else "host"


def _sources(var: str) -> tuple:
    return (HOST_SOURCES + JNI_SOURCES + (NATIVE / "c_api.cpp",)
            + (CUDA_SOURCES if var == "cuda" else NO_CUDA_SOURCES))


def library_path(sources=None, stem: str = "libsrt_torch_native") -> Path:
    """Where the library built from the current ``sources`` (default: this
    host's variant's), headers and flags lives; its compilers' output sits
    beside it with the suffix ``.log``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + NVCC_FLAGS + LINK_FLAGS).encode())
    headers = sorted((CPP / "include" / "srt").glob("*.hpp")) + sorted(
        NATIVE.glob("*.hpp")) + [CPP / "include" / "vendored_jni" / "jni.h",
                                 CPP / "jni" / "jni_string_buffers.hpp"]
    for p in tuple(sources or _sources(variant())) + tuple(headers):
        h.update(p.relative_to(ROOT).as_posix().encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _tool(name: str, default: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    if os.path.exists(default):
        return default
    raise CudfLikeError(f"{name} not found: the native library cannot be "
                        "built")


def _build(out: Path, sources) -> None:
    """Compile every source with its own compiler process (``nvcc`` for
    the ``.cu`` ones), all started together, link them into ``out``
    (atomically) and write the compilers' output beside it."""
    cxx = _tool("g++", "/usr/bin/c++")
    nvcc = _tool("nvcc", "/usr/local/cuda/bin/nvcc") \
        if any(src.suffix == ".cu" for src in sources) else None
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for i, src in enumerate(sources):
            obj = Path(tmp) / f"{i}_{src.stem}.o"
            cmd = ([nvcc, *NVCC_FLAGS]
                   if src.suffix == ".cu" else [cxx, *CXX_FLAGS])
            jobs.append((src, obj, subprocess.Popen(
                cmd + ["-c", str(src), "-o", str(obj)], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [f"== {src.relative_to(ROOT)}\n{p.communicate()[0]}"
                for src, _, p in jobs]
        failed = [str(src.relative_to(ROOT)) for src, _, p in jobs
                  if p.returncode != 0]
        if not failed:
            link = subprocess.run(
                [nvcc or cxx, "-shared", "-o", f"{tmp}/lib.so",
                 *(str(obj) for _, obj, _ in jobs), *LINK_FLAGS],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            logs.append(f"== link\n{link.stdout}")
            failed = ["link"] if link.returncode != 0 else []
        log = "\n".join(logs)
        out.with_suffix(".log").write_text(log)
        if failed:
            raise CudfLikeError(f"native build failed for {failed}:\n{log}")
        os.replace(f"{tmp}/lib.so", out)


def build(sources=None, stem: str = "libsrt_torch_native") -> Path:
    """Build this host's library (or one of ``sources``) if it is not
    built yet, without binding it: its path."""
    sources = tuple(sources or _sources(variant()))
    out = library_path(sources=sources, stem=stem)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _build(out, sources)
    return out


def build_jni_driver(library: Path, source: Path) -> Path:
    """A C++ driver of the library's JNI natives (a mock ``JNIEnv``, such
    as ``tests/torch_jni_engine_driver.cpp``) built with the host's C++
    compiler against the vendored ``jni.h`` and linked against
    ``library``, beside it: its path. The name holds a digest of the
    source, the library's name (itself a digest) and the flags, so an
    edit to either builds anew."""
    flags = ("-O1", "-std=c++17", "-I",
             str(CPP / "include" / "vendored_jni"))
    h = hashlib.sha256(" ".join(flags).encode() + library.name.encode())
    h.update(Path(source).read_bytes())
    out = library.with_name(f"{Path(source).stem}-{h.hexdigest()[:16]}")
    with open(out.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_tool("g++", "/usr/bin/c++"), *flags, str(source), "-o",
                 str(tmp), str(library), f"-Wl,-rpath,{library.parent}"],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise CudfLikeError(f"JNI driver build failed:\n"
                                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out


def load(device=None) -> ctypes.CDLL:
    """The library, built at first use and bound once a process. On a
    ``cuda`` device (the default) the CUDA engine starts on it; it raises
    if it cannot. ``device="cpu"`` binds the library without the engine,
    so every entry point takes its host route."""
    global _LIB
    dev = resolve_device(device)
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _configure(lib)
            _LIB = lib
        if dev.type == "cuda":
            index = torch.cuda.current_device() if dev.index is None \
                else dev.index
            _check(_LIB.srt_cuda_init(index))
        return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    """Declare restype AND argtypes for every symbol — without argtypes,
    ctypes marshals Python ints as 32-bit c_int and silently truncates
    64-bit handles."""
    c = ctypes
    i32, i64, vp = c.c_int32, c.c_int64, c.c_void_p
    p_i32 = c.POINTER(c.c_int32)
    p_i64 = c.POINTER(c.c_int64)
    p_u8 = c.POINTER(c.c_uint8)
    p_u32 = c.POINTER(c.c_uint32)
    p_f64 = c.POINTER(c.c_double)
    sig = {
        "srt_last_error": (c.c_char_p, []),
        "srt_arena_bytes_in_use": (i64, []),
        "srt_arena_peak_bytes": (i64, []),
        "srt_arena_outstanding": (i64, []),
        "srt_arena_set_log_level": (None, [i32]),
        "srt_live_handles": (i64, []),
        "srt_compute_fixed_width_layout": (i32, [p_i32, p_i32, i32, p_i32,
                                                 p_i32]),
        "srt_pack_plan": (i32, [p_i32, i32, p_i32, i32]),
        "srt_table_create": (i64, [p_i32, p_i32, i32, i32, c.POINTER(vp),
                                   c.POINTER(p_u32)]),
        "srt_table_create2": (i64, [p_i32, p_i32, i32, i32, c.POINTER(vp),
                                    c.POINTER(p_u32), c.POINTER(p_i32),
                                    c.POINTER(p_u8)]),
        "srt_table_free": (None, [i64]),
        "srt_table_from_arrow": (i64, [vp, vp]),
        "srt_convert_to_rows": (i32, [i64, p_i64, i32]),
        "srt_row_batch_num_rows": (i32, [i64]),
        "srt_row_batch_size_per_row": (i32, [i64]),
        "srt_row_batch_data": (p_u8, [i64]),
        "srt_row_batch_free": (None, [i64]),
        "srt_convert_from_rows": (i32, [p_u8, i32, p_i32, p_i32, i32,
                                        p_i64]),
        "srt_from_rows_was_device": (i32, []),
        "srt_kernel_was_device": (i32, [c.c_char_p]),
        "srt_column_data": (vp, [i64]),
        "srt_column_validity": (p_u32, [i64]),
        "srt_column_free": (None, [i64]),
        "srt_murmur3_table": (i32, [i64, i32, p_i32]),
        "srt_xxhash64_table": (i32, [i64, i64, p_i64]),
        "srt_hive_hash_table": (i32, [i64, p_i32]),
        "srt_ra_configure": (None, [i64]),
        "srt_ra_pool_bytes": (i64, []),
        "srt_ra_in_use": (i64, []),
        "srt_ra_active_tasks": (i64, []),
        "srt_ra_task_register": (None, [i64]),
        "srt_ra_task_done": (None, [i64]),
        "srt_ra_task_retry_done": (None, [i64]),
        "srt_ra_alloc": (i32, [i64, i64, i64]),
        "srt_ra_free": (i32, [i64, i64]),
        "srt_ra_task_metrics": (i32, [i64, p_i64]),
        "srt_cuda_init": (i32, [i32]),
        "srt_cuda_available": (i32, []),
        "srt_cuda_device_count": (i32, []),
        "srt_cuda_platform_name": (c.c_char_p, []),
        "srt_cuda_kernel_launches": (i64, [c.c_char_p]),
        "srt_cuda_kernel_names": (c.c_char_p, []),
        "srt_cuda_reset_kernel_launches": (None, []),
        "srt_cuda_live_buffers": (i64, []),
        "srt_table_num_rows": (i32, [i64]),
        "srt_table_num_columns": (i32, [i64]),
        "srt_sort_order": (i32, [i64, p_u8, p_u8, i32, p_i32]),
        "srt_inner_join": (i64, [i64, i64]),
        "srt_left_join": (i64, [i64, i64]),
        "srt_left_semi_anti_join": (i64, [i64, i64, i32]),
        "srt_join_result_size": (i64, [i64]),
        "srt_join_result_has_right": (i32, [i64]),
        "srt_join_result_left": (p_i32, [i64]),
        "srt_join_result_right": (p_i32, [i64]),
        "srt_join_result_free": (None, [i64]),
        "srt_groupby": (i64, [i64, i64]),
        "srt_groupby_num_groups": (i32, [i64]),
        "srt_groupby_rep_rows": (p_i32, [i64]),
        "srt_groupby_sizes": (p_i64, [i64]),
        "srt_groupby_sum_is_float": (i32, [i64, i32]),
        "srt_groupby_isums": (p_i64, [i64, i32]),
        "srt_groupby_fsums": (p_f64, [i64, i32]),
        "srt_groupby_counts": (p_i64, [i64, i32]),
        "srt_groupby_imins": (p_i64, [i64, i32]),
        "srt_groupby_imaxs": (p_i64, [i64, i32]),
        "srt_groupby_fmins": (p_f64, [i64, i32]),
        "srt_groupby_fmaxs": (p_f64, [i64, i32]),
        "srt_groupby_means": (p_f64, [i64, i32]),
        "srt_groupby_free": (None, [i64]),
        "srt_cast_string_to_int64": (i64, [p_u8, p_i32, i32, i32, p_i64,
                                           p_u8, p_i32]),
        "srt_cast_string_to_float64": (i64, [p_u8, p_i32, i32, i32, p_f64,
                                             p_u8, p_i32]),
        # handles are heap pointers: argtypes keep them 64-bit
        "srt_get_json_object": (vp, [p_u8, p_i32, i32, p_u8, c.c_char_p]),
        "srt_json_result_chars": (vp, [vp]),
        "srt_json_result_offsets": (p_i32, [vp]),
        "srt_json_result_valid": (p_u8, [vp]),
        "srt_json_result_free": (None, [vp]),
        "srt_table_to_device": (i64, [i64]),
        "srt_device_table_free": (None, [i64]),
        "srt_device_table_num_rows": (i32, [i64]),
        "srt_live_device_handles": (i64, []),
        "srt_murmur3_table_device": (i64, [i64, i32]),
        "srt_xxhash64_table_device": (i64, [i64, i64]),
        "srt_convert_to_rows_device": (i64, [i64]),
        "srt_sort_order_device": (i64, [i64, p_u8, i32]),
        "srt_convert_from_rows_device": (i32, [i64, i32, p_i32, p_i32, i32,
                                               p_i64]),
        "srt_inner_join_device": (i64, [i64, i64]),
        "srt_groupby_device": (i64, [i64, i64]),
        "srt_device_buffer_kernel": (i64, [c.c_char_p, i64]),
        "srt_device_buffer_bytes": (i64, [i64]),
        "srt_device_buffer_fetch": (i32, [i64, vp, i64]),
        "srt_device_buffer_free": (None, [i64]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def available() -> bool:
    """Whether ``load()`` has succeeded in this process (never builds)."""
    return _LIB is not None


def _lib() -> ctypes.CDLL:
    return _LIB if _LIB is not None else load()


def _error() -> str:
    return _lib().srt_last_error().decode()


def _check(rc: int) -> None:
    if rc < 0:
        raise CudfLikeError(_error())


def _handle(h: int) -> int:
    if h == 0:
        raise CudfLikeError(_error())
    return h


def _ids_scales(schema: Sequence[DType]):
    ids = (ctypes.c_int32 * len(schema))(*[int(dt.id) for dt in schema])
    scales = (ctypes.c_int32 * len(schema))(*[dt.scale for dt in schema])
    return ids, scales


def _copy(ptr, n: int, dtype) -> np.ndarray:
    """``n`` values at a result pointer as a fresh array (empty for 0)."""
    if n == 0:
        return np.empty(0, dtype)
    return np.ctypeslib.as_array(ptr, (n,)).copy()


# the Arrow C Data Interface spec structs, declared once so size and
# alignment are right by construction on any ABI (mirrors
# src/main/cpp/include/srt/arrow_abi.hpp)
class _ArrowSchemaStruct(ctypes.Structure):
    _fields_ = [("format", ctypes.c_char_p), ("name", ctypes.c_char_p),
                ("metadata", ctypes.c_void_p), ("flags", ctypes.c_int64),
                ("n_children", ctypes.c_int64),
                ("children", ctypes.c_void_p),
                ("dictionary", ctypes.c_void_p),
                ("release", ctypes.c_void_p),
                ("private_data", ctypes.c_void_p)]


class _ArrowArrayStruct(ctypes.Structure):
    _fields_ = [("length", ctypes.c_int64), ("null_count", ctypes.c_int64),
                ("offset", ctypes.c_int64), ("n_buffers", ctypes.c_int64),
                ("n_children", ctypes.c_int64),
                ("buffers", ctypes.c_void_p),
                ("children", ctypes.c_void_p),
                ("dictionary", ctypes.c_void_p),
                ("release", ctypes.c_void_p),
                ("private_data", ctypes.c_void_p)]


class ArrowTable:
    """Zero-copy native table over an Arrow C-Data-Interface export of a
    pyarrow struct array (or a Table via ``from_pyarrow``). The native
    side takes the array by the spec's move and runs its release callback
    exactly once, when the table is closed (or at once if the import is
    refused)."""

    def __init__(self, struct_array):
        import pyarrow  # noqa: F401  (the caller already has it)
        c = ctypes
        self._schema = _ArrowSchemaStruct()
        self._array = _ArrowArrayStruct()
        schema_ptr = c.addressof(self._schema)
        array_ptr = c.addressof(self._array)
        struct_array._export_to_c(array_ptr, schema_ptr)
        self.handle = _handle(_lib().srt_table_from_arrow(schema_ptr,
                                                          array_ptr))
        # counts come from the NATIVE handle: what the kernels will read
        self.num_rows = _lib().srt_table_num_rows(self.handle)
        self.num_columns = _lib().srt_table_num_columns(self.handle)

    @staticmethod
    def from_pyarrow(table) -> "ArrowTable":
        """pyarrow.Table -> native table (combined to one chunk)."""
        sa = table.combine_chunks().to_struct_array()
        if hasattr(sa, "combine_chunks"):  # ChunkedArray on some versions
            sa = sa.combine_chunks()
        return ArrowTable(sa)

    def close(self):
        if self.handle:
            _lib().srt_table_free(self.handle)  # runs the Arrow release
            self.handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def compute_fixed_width_layout(schema: Sequence[DType]):
    """The native layout engine: (size_per_row, starts, sizes)."""
    n = len(schema)
    ids, scales = _ids_scales(schema)
    starts = (ctypes.c_int32 * n)()
    sizes = (ctypes.c_int32 * n)()
    spr = _lib().srt_compute_fixed_width_layout(ids, scales, n, starts, sizes)
    _check(spr)
    return spr, list(starts), list(sizes)


def pack_plan_words(widths: Sequence[int]) -> list:
    """K6's plan for byte widths as the engine builds it
    (``csrc/native/pack_plan.hpp``): equal to
    ``ops.cuda_kernels.pack_plan(widths).words()``."""
    n = len(widths)
    cap = 8 * (n + 64) + 2 * n
    out = (ctypes.c_int32 * cap)()
    got = _lib().srt_pack_plan((ctypes.c_int32 * n)(*widths), n, out, cap)
    _check(got)
    return list(out[:got])


class NativeTable:
    """A native table view over numpy buffers (kept alive by this object).

    Each column spec is ``(DType, values, validity_words)``. Fixed-width
    columns pass their storage array as ``values``; STRING columns pass an
    ``(offsets int32[n+1], chars uint8[...])`` tuple (the Arrow layout)."""

    def __init__(self, columns: "list[tuple[DType, object, Optional[np.ndarray]]]"):
        c = ctypes
        self._bufs = []  # keep ndarray refs alive
        n_cols = len(columns)
        has_strings = any(dt.id == TypeId.STRING for dt, _, _ in columns)
        if not columns:
            num_rows = 0
        elif columns[0][0].id == TypeId.STRING:
            num_rows = len(columns[0][1][0]) - 1  # offsets has n+1 entries
        else:
            num_rows = len(columns[0][1])
        ids = (c.c_int32 * n_cols)(*[int(dt.id) for dt, _, _ in columns])
        scales = (c.c_int32 * n_cols)(*[dt.scale for dt, _, _ in columns])
        data = (c.c_void_p * n_cols)()
        validity = (c.POINTER(c.c_uint32) * n_cols)()
        offsets = (c.POINTER(c.c_int32) * n_cols)()
        chars = (c.POINTER(c.c_uint8) * n_cols)()
        for i, (dt, values, vwords) in enumerate(columns):
            if dt.id == TypeId.STRING:
                offs, ch = values
                offs = np.ascontiguousarray(offs, dtype=np.int32)
                ch = np.ascontiguousarray(ch, dtype=np.uint8)
                if ch.size == 0:  # keep a non-null pointer for the ABI
                    ch = np.zeros(1, np.uint8)
                self._bufs.extend((offs, ch))
                offsets[i] = offs.ctypes.data_as(c.POINTER(c.c_int32))
                chars[i] = ch.ctypes.data_as(c.POINTER(c.c_uint8))
            else:
                values = np.ascontiguousarray(values)
                self._bufs.append(values)
                data[i] = values.ctypes.data_as(c.c_void_p)
            if vwords is not None:
                vwords = np.ascontiguousarray(vwords, dtype=np.uint32)
                self._bufs.append(vwords)
                validity[i] = vwords.ctypes.data_as(c.POINTER(c.c_uint32))
        lib = _lib()
        if has_strings:
            self.handle = lib.srt_table_create2(
                ids, scales, n_cols, num_rows,
                c.cast(data, c.POINTER(c.c_void_p)), validity, offsets,
                chars)
        else:
            self.handle = lib.srt_table_create(
                ids, scales, n_cols, num_rows,
                c.cast(data, c.POINTER(c.c_void_p)), validity)
        _handle(self.handle)
        self.num_rows = num_rows
        self.num_columns = n_cols

    def close(self):
        if self.handle:
            _lib().srt_table_free(self.handle)
            self.handle = 0

    def to_device(self) -> "DeviceTable":
        """Upload the columns to the card once; kernels then chain over
        the returned handle with no per-call transfers."""
        return table_to_device(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@traced("native.convert_to_rows")
def convert_to_rows(table: NativeTable) -> "list[np.ndarray]":
    """Row conversion -> list of (num_rows, size_per_row) uint8 arrays (one
    a batch of at most 2 GB, on either route)."""
    lib = _lib()
    handles = (ctypes.c_int64 * 64)()
    n = lib.srt_convert_to_rows(table.handle, handles, 64)
    _check(n)
    out = []
    for i in range(n):
        h = handles[i]
        rows = lib.srt_row_batch_num_rows(h)
        spr = lib.srt_row_batch_size_per_row(h)
        arr = _copy(lib.srt_row_batch_data(h), rows * spr, np.uint8)
        out.append(arr.reshape(rows, spr))
        lib.srt_row_batch_free(h)
    return out


def _unpack_valid(words: np.ndarray, n: int) -> np.ndarray:
    """Validity words (bit r % 32 of word r / 32) -> n bools."""
    bits = np.unpackbits(np.ascontiguousarray(words, np.uint32).view(
        np.uint8), bitorder="little")
    return bits[:n].astype(bool)


@traced("native.convert_from_rows")
def convert_from_rows(rows: np.ndarray, schema: Sequence[DType]):
    """Rows -> list of (values, valid_bool) numpy pairs."""
    lib = _lib()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    num_rows = rows.shape[0]
    n_cols = len(schema)
    ids, scales = _ids_scales(schema)
    handles = (ctypes.c_int64 * n_cols)()
    rc = lib.srt_convert_from_rows(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_rows,
        ids, scales, n_cols, handles)
    _check(rc)
    out = []
    for i, dt in enumerate(schema):
        h = handles[i]
        np_dt = dt.storage_dtype
        values = _copy(ctypes.cast(lib.srt_column_data(h),
                                   ctypes.POINTER(ctypes.c_uint8)),
                       num_rows * np_dt.itemsize, np.uint8).view(np_dt)
        words = _copy(lib.srt_column_validity(h), (num_rows + 31) // 32,
                      np.uint32)
        out.append((values, _unpack_valid(words, num_rows)))
        lib.srt_column_free(h)
    return out


@traced("native.murmur3_table")
def murmur3_table(table: NativeTable, seed: int = 42) -> np.ndarray:
    out = np.empty(table.num_rows, np.int32)
    _check(_lib().srt_murmur3_table(
        table.handle, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))))
    return out


@traced("native.xxhash64_table")
def xxhash64_table(table: NativeTable, seed: int = 42) -> np.ndarray:
    out = np.empty(table.num_rows, np.int64)
    _check(_lib().srt_xxhash64_table(
        table.handle, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))))
    return out


@traced("native.hive_hash_table")
def hive_hash_table(table: NativeTable) -> np.ndarray:
    out = np.empty(table.num_rows, np.int32)
    _check(_lib().srt_hive_hash_table(
        table.handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))))
    return out


# ---------------------------------------------------------------------------
# Relational kernels: sort / joins / groupby
# ---------------------------------------------------------------------------


def _flags(v, keep: list):
    """A per-column byte flag array (None stays None) and its length."""
    if v is None:
        return None, 0
    arr = np.asarray(v, np.uint8)
    keep.append(arr)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.shape[0]


@traced("native.sort_order")
def sort_order(keys: NativeTable, ascending=None,
               nulls_first=None) -> np.ndarray:
    """Stable lexicographic argsort over all key columns (Spark ordering:
    NaN greatest; per-column asc / nulls-first flags)."""
    out = np.empty(keys.num_rows, np.int32)
    keep: list = []
    asc_p, asc_n = _flags(ascending, keep)
    nf_p, nf_n = _flags(nulls_first, keep)
    if asc_p is not None and nf_p is not None and asc_n != nf_n:
        raise CudfLikeError("ascending/nulls_first lengths differ")
    _check(_lib().srt_sort_order(
        keys.handle, asc_p, nf_p, nf_n or asc_n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))))
    return out


def _join_pairs(h: int):
    lib = _lib()
    _handle(h)
    try:
        n = lib.srt_join_result_size(h)
        has_right = lib.srt_join_result_has_right(h) == 1
        # left-only (semi/anti) results have no right side: the explicit
        # has_right flag is the protocol, never pointer nullness
        return (_copy(lib.srt_join_result_left(h), n, np.int32),
                _copy(lib.srt_join_result_right(h), n if has_right else 0,
                      np.int32))
    finally:
        lib.srt_join_result_free(h)


@traced("native.inner_join")
def inner_join(left_keys: NativeTable,
               right_keys: NativeTable) -> "tuple[np.ndarray, np.ndarray]":
    """Inner equi-join on all columns; SQL null semantics (null never
    matches). Returns (left_row_indices, right_row_indices)."""
    return _join_pairs(_lib().srt_inner_join(left_keys.handle,
                                             right_keys.handle))


@traced("native.left_join")
def left_join(left_keys: NativeTable,
              right_keys: NativeTable) -> "tuple[np.ndarray, np.ndarray]":
    """Left outer join: every left row appears; unmatched pair with -1."""
    return _join_pairs(_lib().srt_left_join(left_keys.handle,
                                            right_keys.handle))


@traced("native.left_semi_join")
def left_semi_join(left_keys: NativeTable,
                   right_keys: NativeTable) -> np.ndarray:
    """Left rows with >= 1 match (ascending row order)."""
    return _join_pairs(_lib().srt_left_semi_anti_join(
        left_keys.handle, right_keys.handle, 1))[0]


@traced("native.left_anti_join")
def left_anti_join(left_keys: NativeTable,
                   right_keys: NativeTable) -> np.ndarray:
    """Left rows with NO match; null-key rows match nothing, so they are
    included (Spark left_anti semantics)."""
    return _join_pairs(_lib().srt_left_semi_anti_join(
        left_keys.handle, right_keys.handle, 0))[0]


@traced("native.groupby_sum_count")
def groupby_sum_count(keys: NativeTable, values: NativeTable) -> dict:
    """Groupby over all key columns: sum/min/max/avg + count of every
    value column, count(*) sizes, and the representative (first) row per
    group, groups in order of that row.

    Returns {"rep_rows", "sizes", "sums", "mins", "maxs", "means",
    "counts"} (per-col arrays) with sums/mins/maxs widened per Spark
    (int64 / float64); means are double (NaN for all-null groups, whose
    min/max slots hold 0 — gate on counts)."""
    h = _lib().srt_groupby(keys.handle, values.handle)
    return _read_groupby_result(h, values.num_columns)


def _read_groupby_result(h: int, n_vals: int) -> dict:
    """Copy a groupby-result handle's arrays out and free it (shared by
    the host-table and resident entry points)."""
    lib = _lib()
    _handle(h)
    try:
        g = lib.srt_groupby_num_groups(h)
        out = {"rep_rows": _copy(lib.srt_groupby_rep_rows(h), g, np.int32),
               "sizes": _copy(lib.srt_groupby_sizes(h), g, np.int64),
               "sums": [], "mins": [], "maxs": [], "means": [],
               "counts": []}
        for v in range(n_vals):
            is_float = lib.srt_groupby_sum_is_float(h, v) == 1
            for key, fn_f, fn_i in (
                    ("sums", lib.srt_groupby_fsums, lib.srt_groupby_isums),
                    ("mins", lib.srt_groupby_fmins, lib.srt_groupby_imins),
                    ("maxs", lib.srt_groupby_fmaxs, lib.srt_groupby_imaxs)):
                out[key].append(_copy(fn_f(h, v), g, np.float64) if is_float
                                else _copy(fn_i(h, v), g, np.int64))
            out["means"].append(_copy(lib.srt_groupby_means(h, v), g,
                                      np.float64))
            out["counts"].append(_copy(lib.srt_groupby_counts(h, v), g,
                                       np.int64))
        return out
    finally:
        lib.srt_groupby_free(h)


def cast_string_to_int64(strings: "list[str]", ansi: bool = False):
    """Spark CAST(string AS LONG) over a python string list. Returns
    (values int64 array, valid bool array); raises in ANSI mode."""
    return _cast_strings(strings, ansi, to_float=False)


def cast_string_to_float64(strings: "list[str]", ansi: bool = False):
    """Spark CAST(string AS DOUBLE). Returns (values, valid)."""
    return _cast_strings(strings, ansi, to_float=True)


def _string_buffers(strings):
    """(chars uint8, offsets int32[n+1]) of a python string list; chars
    keeps a non-null pointer when empty."""
    enc = [s.encode() for s in strings]
    offsets = np.zeros(len(enc) + 1, np.int32)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    joined = b"".join(enc)
    chars = np.frombuffer(joined, np.uint8) if joined else \
        np.empty(1, np.uint8)
    return chars, offsets


def _cast_strings(strings, ansi, to_float):
    c = ctypes
    chars, offsets = _string_buffers(strings)
    n = len(strings)
    valid = np.empty(n, np.uint8)
    bad = c.c_int32(-1)
    out = np.empty(n, np.float64 if to_float else np.int64)
    fn = (_lib().srt_cast_string_to_float64 if to_float
          else _lib().srt_cast_string_to_int64)
    rc = fn(chars.ctypes.data_as(c.POINTER(c.c_uint8)),
            offsets.ctypes.data_as(c.POINTER(c.c_int32)), n,
            1 if ansi else 0,
            out.ctypes.data_as(c.POINTER(c.c_double if to_float
                                         else c.c_int64)),
            valid.ctypes.data_as(c.POINTER(c.c_uint8)), c.byref(bad))
    if rc < 0:
        raise CudfLikeError(
            f"ANSI cast failure at row {bad.value}: "
            f"{strings[bad.value]!r}")
    return out, valid.astype(bool)


def get_json_object(chars: np.ndarray, offsets: np.ndarray,
                    valid: np.ndarray, path: str):
    """The native get_json_object walker over Arrow string buffers (a
    byte of ``valid`` a row): (values bytes, offsets int32[n+1], ok
    bool[n]), or None for a path it does not parse (Spark: all NULL)."""
    lib = _lib()
    c = ctypes
    n = offsets.shape[0] - 1
    chars = np.ascontiguousarray(chars, dtype=np.uint8)
    if chars.size == 0:  # a non-null pointer for the ABI
        chars = np.zeros(1, np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    h = lib.srt_get_json_object(
        chars.ctypes.data_as(c.POINTER(c.c_uint8)),
        offsets.ctypes.data_as(c.POINTER(c.c_int32)), n,
        valid.ctypes.data_as(c.POINTER(c.c_uint8)), path.encode("utf-8"))
    if not h:
        return None
    try:
        offs = _copy(lib.srt_json_result_offsets(h), n + 1, np.int32)
        ok = _copy(lib.srt_json_result_valid(h), n, np.uint8).astype(bool)
        buf = ctypes.string_at(lib.srt_json_result_chars(h), int(offs[-1]))
    finally:
        lib.srt_json_result_free(h)
    return buf, offs, ok


def arena_stats() -> dict:
    lib = _lib()
    return {
        "bytes_in_use": lib.srt_arena_bytes_in_use(),
        "peak_bytes": lib.srt_arena_peak_bytes(),
        "outstanding_allocations": lib.srt_arena_outstanding(),
        "live_handles": lib.srt_live_handles(),
    }


# ---------------------------------------------------------------------------
# The CUDA engine (the reference's pjrt_* functions' twins)
# ---------------------------------------------------------------------------


def cuda_init(device: int = 0) -> None:
    """Start the engine on CUDA device ``device`` (``load()`` does this
    for its device)."""
    _check(_lib().srt_cuda_init(device))


def cuda_available() -> bool:
    return available() and bool(_lib().srt_cuda_available())


def cuda_device_count() -> int:
    return _lib().srt_cuda_device_count()


def cuda_platform_name() -> str:
    return _lib().srt_cuda_platform_name().decode()


def kernel_launches() -> dict:
    """The engine's ``__global__`` launches per kernel name since the last
    ``reset_kernel_launches()`` (K4 ``murmur3_int32``, K5
    ``murmur3_int64``, K6 ``pack_rows`` and its own kernels); {} on a
    library without CUDA."""
    lib = _lib()
    names = [n for n in lib.srt_cuda_kernel_names().decode().split(",") if n]
    return {n: lib.srt_cuda_kernel_launches(n.encode()) for n in names}


def reset_kernel_launches() -> None:
    _lib().srt_cuda_reset_kernel_launches()


def cuda_live_buffers() -> int:
    """Engine buffers alive (resident columns and results)."""
    return _lib().srt_cuda_live_buffers()


# ---------------------------------------------------------------------------
# Device-resident tables and buffers
# ---------------------------------------------------------------------------
# Data stays on the card between calls; only 8-byte handles cross the
# boundary (reference: RowConversionJni.cpp:36,63): upload once with
# NativeTable.to_device(), chain kernels over handles, fetch() at the end.


class DeviceBuffer:
    """Owns one engine buffer on the card (a kernel result)."""

    def __init__(self, handle: int):
        self._h = handle

    @property
    def handle(self) -> int:
        return self._h

    def nbytes(self) -> int:
        return _lib().srt_device_buffer_bytes(self._h)

    def fetch(self, dtype, count: int = -1) -> np.ndarray:
        """Copy the payload into a fresh host array (``count`` values;
        default: the whole buffer)."""
        dtype = np.dtype(dtype)
        if count < 0:
            nbytes = self.nbytes()
            if nbytes < 0:
                raise CudfLikeError("unknown device buffer handle")
            count = nbytes // dtype.itemsize
        out = np.empty(count, dtype)
        _check(_lib().srt_device_buffer_fetch(self._h, out.ctypes.data,
                                              out.nbytes))
        return out

    def then(self, program_name: str) -> "DeviceBuffer":
        """Run one of the engine's hashes over this buffer on the card,
        named as the reference names its programs: ``murmur3:<sig>:<N>``
        or ``xxhash64:<sig>:<N>`` (sig one of ``i l u v f d``, N values,
        seed 42). Any other name raises the reference's "no AOT program"
        error."""
        return DeviceBuffer(_handle(_lib().srt_device_buffer_kernel(
            program_name.encode(), self._h)))

    def from_rows(self, num_rows: int, schema: Sequence[DType]
                  ) -> "list[tuple[DeviceBuffer, DeviceBuffer]]":
        """Rows of ``schema`` in this buffer -> each column's (data,
        validity words) buffers, on the card."""
        n = len(schema)
        ids, scales = _ids_scales(schema)
        out = (ctypes.c_int64 * (2 * n))()
        _check(_lib().srt_convert_from_rows_device(self._h, num_rows, ids,
                                                   scales, n, out))
        return [(DeviceBuffer(out[i]), DeviceBuffer(out[n + i]))
                for i in range(n)]

    def free(self) -> None:
        if self._h:
            _lib().srt_device_buffer_free(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()


class DeviceTable:
    """Resident columns uploaded once from a NativeTable."""

    def __init__(self, handle: int, num_columns: int):
        self._h = handle
        self.num_columns = num_columns

    @property
    def handle(self) -> int:
        return self._h

    def num_rows(self) -> int:
        return _lib().srt_device_table_num_rows(self._h)

    def murmur3(self, seed: int = 42) -> DeviceBuffer:
        return DeviceBuffer(_handle(_lib().srt_murmur3_table_device(
            self._h, seed)))

    def xxhash64(self, seed: int = 42) -> DeviceBuffer:
        return DeviceBuffer(_handle(_lib().srt_xxhash64_table_device(
            self._h, seed)))

    def to_rows(self) -> DeviceBuffer:
        """All rows in the row format, one buffer (no 2 GB batch split on
        the card)."""
        return DeviceBuffer(_handle(_lib().srt_convert_to_rows_device(
            self._h)))

    def sort_order(self, ascending=None) -> DeviceBuffer:
        """Stable argsort over the columns (integral keys): an int32
        buffer of row indices."""
        keep: list = []
        asc_p, asc_n = _flags(ascending, keep)
        return DeviceBuffer(_handle(_lib().srt_sort_order_device(
            self._h, asc_p, asc_n)))

    def inner_join(self, right: "DeviceTable") \
            -> "tuple[np.ndarray, np.ndarray]":
        """Resident inner join under the unique-right contract; only the
        index result comes back. Raises on overflow (a left row matching
        more than one right row): resident tables hold no host copy to
        fall back to."""
        return _join_pairs(_lib().srt_inner_join_device(self._h, right._h))

    def groupby_sum_count(self, values: "DeviceTable") -> dict:
        """Resident groupby: this table's columns are the keys, ``values``
        the value columns; only the per-group results come back. Same
        dict as the host ``groupby_sum_count``."""
        h = _lib().srt_groupby_device(self._h, values._h)
        return _read_groupby_result(h, values.num_columns)

    def free(self) -> None:
        if self._h:
            _lib().srt_device_table_free(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()


@traced("native.table_to_device")
def table_to_device(table: NativeTable) -> DeviceTable:
    """Upload a host NativeTable's columns to the card (once)."""
    return DeviceTable(_handle(_lib().srt_table_to_device(table.handle)),
                       table.num_columns)


def live_device_handles() -> int:
    return _lib().srt_live_device_handles()


def live_handles() -> int:
    """Live native handle count (columns + tables + batches) — the
    refcount-debug leak check."""
    return _lib().srt_live_handles()


def from_rows_was_device() -> bool:
    """True when this thread's last convert_from_rows decoded on the
    card rather than the host decoder."""
    return bool(_lib().srt_from_rows_was_device())


def kernel_was_device(kernel: str) -> int:
    """Route provenance for any auto-routing kernel: 1 = this thread's
    last call ran on the card, 0 = host route, 2 = the last device call
    FAILED, -1 = never ran. Kernels: murmur3, xxhash64, to_rows,
    from_rows, sort_order, inner_join, groupby."""
    return int(_lib().srt_kernel_was_device(kernel.encode()))


ROUTE_KERNELS = ("murmur3", "xxhash64", "to_rows", "from_rows",
                 "sort_order", "inner_join", "groupby")

# ---------------------------------------------------------------------------
# Resource adaptor (SparkResourceAdaptor / RmmSpark analog)
# ---------------------------------------------------------------------------

RA_OK = 0
RA_RETRY_OOM = 1
RA_SPLIT_AND_RETRY_OOM = 2
RA_INVALID = 3


def ra_configure(pool_bytes: int) -> None:
    _lib().srt_ra_configure(pool_bytes)


def ra_task_register(task_id: int) -> None:
    _lib().srt_ra_task_register(task_id)
    # the C ABI cannot enumerate tasks, so registration feeds the obs
    # reliability snapshot's per-task metric aggregation
    from .obs.report import ra_track_task
    ra_track_task(task_id)


def ra_task_done(task_id: int) -> None:
    _lib().srt_ra_task_done(task_id)
    from .obs.report import ra_track_task
    ra_track_task(task_id, False)


def ra_task_retry_done(task_id: int) -> None:
    _lib().srt_ra_task_retry_done(task_id)


def ra_alloc(task_id: int, nbytes: int, timeout_ms: int = -1) -> None:
    """Reserve logical device memory for a task; raises the Spark retry
    exceptions (``utils/faults.RetryOOM``, ``SplitAndRetryOOM``)."""
    rc = _lib().srt_ra_alloc(task_id, nbytes, timeout_ms)
    if rc == RA_OK:
        return
    if rc == RA_RETRY_OOM:
        raise RetryOOM(f"task {task_id}: retry ({nbytes} bytes)")
    if rc == RA_SPLIT_AND_RETRY_OOM:
        raise SplitAndRetryOOM(f"task {task_id}: split and retry")
    raise CudfLikeError(f"resource adaptor: invalid call (task {task_id})")


def ra_free(task_id: int, nbytes: int) -> None:
    rc = _lib().srt_ra_free(task_id, nbytes)
    if rc != RA_OK:
        raise CudfLikeError(f"resource adaptor: bad free (task {task_id})")


def ra_stats() -> dict:
    lib = _lib()
    return {"pool_bytes": lib.srt_ra_pool_bytes(),
            "in_use": lib.srt_ra_in_use(),
            "active_tasks": lib.srt_ra_active_tasks()}


def ra_task_metrics(task_id: int) -> dict:
    out = np.zeros(6, np.int64)
    rc = _lib().srt_ra_task_metrics(
        task_id, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != RA_OK:
        raise CudfLikeError(f"unknown task {task_id}")
    keys = ("allocated", "peak", "retry_oom", "split_retry_oom",
            "block_time_ms", "blocked_count")
    return dict(zip(keys, out.tolist()))
