"""Shared set-up of the native-bridge tests (``test_torch_native*.py``,
``test_torch_arrow_native.py``, and the native cases of the obs,
reliability and get_json_object files).

``native_libraries`` (once a test process) builds the port's library on
the CPU (``native.load(device="cpu")``, the C++ compiler alone) and the
reference's with its own CMakeLists (``--target sparkrapidstpu``) into
``target/torch_native/ref-build/``, under a file lock so parallel workers
build once. ``reference_native`` (per test module) points the reference's
``native`` at that library by monkeypatching its ``_SEARCHED``, ``_LIB``
and ``SRT_NATIVE_LIB``, and restores them after the module: the JAX
package is not edited, and its own tests keep the state they expect.
"""

from __future__ import annotations

import fcntl
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
REF_BUILD = ROOT / "target" / "torch_native" / "ref-build"
REF_LIB = REF_BUILD / "libsparkrapidstpu.so"


def build_reference_library() -> Path:
    """The reference's ``libsparkrapidstpu.so``, built once (cmake)."""
    REF_BUILD.mkdir(parents=True, exist_ok=True)
    with open(REF_BUILD.parent / ".ref-build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not REF_LIB.exists():
            cmake = shutil.which("cmake")
            assert cmake, "cmake is needed to build the reference library"
            gen = ["-G", "Ninja"] if shutil.which("ninja") else []
            for cmd in ([cmake, "-S", str(ROOT / "src" / "main" / "cpp"),
                         "-B", str(REF_BUILD), *gen,
                         "-DCMAKE_BUILD_TYPE=Release",
                         "-DSRT_BUILD_TESTS=OFF", "-DSRT_USE_JNI=OFF"],
                        [cmake, "--build", str(REF_BUILD), "--target",
                         "sparkrapidstpu", "--parallel", "4"]):
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=600)
                assert out.returncode == 0, out.stdout + out.stderr
    return REF_LIB


@pytest.fixture(scope="session")
def native_libraries():
    """(the port's native module, loaded on the CPU; the reference
    library's path)."""
    from spark_rapids_jni_tpu_torch import native
    native.load(device="cpu")
    return native, build_reference_library()


@pytest.fixture(scope="module")
def reference_native(native_libraries):
    """The reference's ``native`` module bound to the built library for
    this test module."""
    from spark_rapids_jni_tpu import native as ref
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SRT_NATIVE_LIB", str(native_libraries[1]))
        mp.setattr(ref, "_SEARCHED", False)
        mp.setattr(ref, "_LIB", None)
        assert ref.available()
        yield ref


def port_dtype(dt):
    """The port's DType of a reference DType (type id and scale)."""
    from spark_rapids_jni_tpu_torch import types as T
    return T.DType(T.TypeId(int(dt.id)), dt.scale)


def port_specs(specs):
    """Reference ``NativeTable`` column specs with the port's DTypes."""
    return [(port_dtype(dt), vals, words) for dt, vals, words in specs]


def pack_valid(valid) -> np.ndarray:
    """Bool rows -> packed uint32 validity words (bit r % 32 of word
    r / 32)."""
    valid = np.asarray(valid, bool)
    words = np.zeros((len(valid) + 31) // 32, np.uint32)
    idx = np.nonzero(valid)[0]
    np.bitwise_or.at(words, idx // 32,
                     (np.uint32(1) << (idx % 32).astype(np.uint32)))
    return words


def string_buffers(strings):
    """(offsets int32[n+1], chars uint8[:]) Arrow buffers of a list."""
    enc = [s.encode() for s in strings]
    offs = np.zeros(len(enc) + 1, np.int32)
    np.cumsum([len(b) for b in enc], out=offs[1:])
    joined = b"".join(enc)
    chars = np.frombuffer(joined, np.uint8) if joined else \
        np.empty(0, np.uint8)
    return offs, chars


FAKE_ENGINE = ROOT / "tests" / "native_fake_engine.cpp"


def build_fake_engine_library() -> Path:
    """The port's library with ``tests/native_fake_engine.cpp`` (host
    memory, host kernels) in place of its device engine."""
    from spark_rapids_jni_tpu_torch import native
    return native.build(
        sources=native.HOST_SOURCES + native.JNI_SOURCES
        + (native.NATIVE / "c_api.cpp", FAKE_ENGINE),
        stem="libsrt_torch_native_fake_engine")
