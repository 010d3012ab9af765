"""The port's native bridge (``spark_rapids_jni_tpu_torch/native.py`` and
its library) against the reference's (``spark_rapids_jni_tpu/native.py``
over ``libsparkrapidstpu.so``), both built here and loaded on the CPU.

Mirrors ``test_native.py`` and ``test_device_resident.py``: the same
seeded tables through both bindings, the layout, row images (byte-equal),
rows back to columns, the hashes, the arena's leak counters, the resource
adaptor's retry escalation and hand-off (raising the port's
``utils/faults`` classes), HiveHash, the route sentinels of the host
route, and every device entry point failing cleanly with no engine. Then
the port's own: K6's C++ plan (``csrc/native/pack_plan.hpp``) equal to
``ops.cuda_kernels.pack_plan`` and the JNI bridge's symbols in the
library. The device routes run on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import re
import threading
import time

import numpy as np
import pytest

import spark_rapids_jni_tpu as srt
from spark_rapids_jni_tpu.types import DType as RefDType, TypeId as RefTypeId
from spark_rapids_jni_tpu.utils.errors import CudfLikeError as RefError

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.ops import cuda_kernels
from spark_rapids_jni_tpu_torch.ops.row_layout import fixed_width_layout
from spark_rapids_jni_tpu_torch.utils import faults
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

from torch_native_support import (ROOT, native_libraries,  # noqa: F401
                                  pack_valid, port_dtype, port_specs,
                                  reference_native)


@pytest.fixture
def both(native_libraries, reference_native):  # noqa: F811
    return native_libraries[0], reference_native


def _random_specs(n=257, seed=0):
    """The reference test's eight-type table with 15% nulls, as reference
    column specs."""
    rng = np.random.default_rng(seed)
    specs = []
    for dt, np_dt in [
        (srt.INT64, np.int64), (srt.FLOAT64, np.float64),
        (srt.INT32, np.int32), (srt.BOOL8, np.int8),
        (srt.FLOAT32, np.float32), (srt.INT8, np.int8),
        (srt.decimal32(-3), np.int32), (srt.decimal64(-8), np.int64),
    ]:
        if np_dt is np.int8:
            vals = rng.integers(0, 2, n).astype(np.int8) \
                if dt.id == RefTypeId.BOOL8 \
                else rng.integers(-128, 127, n).astype(np.int8)
        elif np_dt is np.float64:
            vals = rng.standard_normal(n)
        elif np_dt is np.float32:
            vals = rng.standard_normal(n).astype(np.float32)
        else:
            info = np.iinfo(np_dt)
            vals = rng.integers(info.min, info.max, n, dtype=np_dt)
        specs.append((dt, vals, pack_valid(rng.random(n) < 0.85)))
    return specs


def test_layout_agrees(both):
    nat, ref = both
    schema = [srt.INT64, srt.BOOL8, srt.decimal32(-2), srt.FLOAT32,
              srt.INT16]
    got = nat.compute_fixed_width_layout([port_dtype(d) for d in schema])
    assert got == ref.compute_fixed_width_layout(schema)
    spr, starts, _ = fixed_width_layout([8, 1, 4, 4, 2])
    assert (got[0], got[1]) == (spr, starts)


@pytest.mark.parametrize("n", [257, 100_003])
def test_row_images_bit_identical(both, n):
    nat, ref = both
    specs = _random_specs(n=n, seed=n)
    with nat.NativeTable(port_specs(specs)) as nt, \
            ref.NativeTable(specs) as rt:
        got, want = nat.convert_to_rows(nt), ref.convert_to_rows(rt)
        assert nat.kernel_was_device("to_rows") == 0
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])


def test_from_rows_agrees(both):
    nat, ref = both
    specs = _random_specs(n=100, seed=3)
    with ref.NativeTable(specs) as rt:
        img = ref.convert_to_rows(rt)[0]
    schema = [dt for dt, _, _ in specs]
    got = nat.convert_from_rows(img, [port_dtype(d) for d in schema])
    want = ref.convert_from_rows(img, schema)
    assert nat.kernel_was_device("from_rows") == \
        ref.kernel_was_device("from_rows") == 0
    assert not nat.from_rows_was_device()
    for (gv, gok), (wv, wok) in zip(got, want):
        np.testing.assert_array_equal(gok, wok)
        np.testing.assert_array_equal(gv.view(np.uint8), wv.view(np.uint8))


def test_hashes_agree(both):
    nat, ref = both
    specs = _random_specs(n=500, seed=7)
    with nat.NativeTable(port_specs(specs)) as nt, \
            ref.NativeTable(specs) as rt:
        for fn in ("murmur3_table", "xxhash64_table"):
            for seed in (42, -7):
                np.testing.assert_array_equal(
                    getattr(nat, fn)(nt, seed), getattr(ref, fn)(rt, seed))
        assert nat.kernel_was_device("murmur3") == \
            ref.kernel_was_device("murmur3") == 0
        assert nat.kernel_was_device("xxhash64") == 0


def test_no_handle_or_arena_leaks(both):
    nat, _ = both
    specs = port_specs(_random_specs(n=64, seed=9))
    with nat.NativeTable(specs) as nt:
        nat.convert_to_rows(nt)
        img = nat.convert_to_rows(nt)[0]
        nat.convert_from_rows(img, [dt for dt, _, _ in specs])
    stats = nat.arena_stats()
    assert stats["live_handles"] == 0
    assert stats["outstanding_allocations"] == 0
    assert stats["bytes_in_use"] == 0
    assert nat.live_device_handles() == 0


def test_resource_adaptor_retry_escalation(both):
    nat, ref = both
    for mod, retry, split in ((nat, faults.RetryOOM,
                               faults.SplitAndRetryOOM),
                              (ref, ref.RetryOOM, ref.SplitAndRetryOOM)):
        mod.ra_configure(1000)
        mod.ra_task_register(7)
        mod.ra_alloc(7, 800)
        with pytest.raises(retry):
            mod.ra_alloc(7, 800)
        with pytest.raises(split):
            mod.ra_alloc(7, 800)
        mod.ra_alloc(7, 100)  # split fits; escalation clears
    m = nat.ra_task_metrics(7)
    assert m == ref.ra_task_metrics(7)
    assert m["retry_oom"] == 1 and m["split_retry_oom"] == 1
    assert m["allocated"] == 900 and m["peak"] == 900
    for mod in (nat, ref):
        mod.ra_task_done(7)
        assert mod.ra_stats()["in_use"] == 0


def test_resource_adaptor_blocking_handoff(both):
    nat, ref = both
    for mod in (nat, ref):
        mod.ra_configure(1000)
        mod.ra_task_register(1)
        mod.ra_task_register(2)
        mod.ra_alloc(1, 900)
        got = {}

        def second():
            mod.ra_alloc(2, 600, 5000)  # blocks until task 1 frees
            got["ok"] = True

        t = threading.Thread(target=second)
        t.start()
        time.sleep(0.05)
        mod.ra_free(1, 900)
        t.join(timeout=10)
        assert got.get("ok")
        m = mod.ra_task_metrics(2)
        assert m["blocked_count"] == 1 and m["allocated"] == 600
        mod.ra_task_done(1)
        mod.ra_task_done(2)


def test_native_hive_hash_agrees(both):
    nat, ref = both
    rng = np.random.default_rng(5)
    i64 = rng.integers(-2**62, 2**62, 100).astype(np.int64)
    f64 = rng.standard_normal(100)
    f64[:3] = [0.0, -0.0, np.nan]
    i32 = rng.integers(-2**31, 2**31 - 1, 100).astype(np.int32)
    valid = pack_valid(rng.random(100) > 0.2)
    specs = [(srt.INT64, i64, valid), (srt.FLOAT64, f64, None),
             (srt.INT32, i32, None)]
    with nat.NativeTable(port_specs(specs)) as nt, \
            ref.NativeTable(specs) as rt:
        np.testing.assert_array_equal(nat.hive_hash_table(nt),
                                      ref.hive_hash_table(rt))


def test_route_sentinels_equal_the_reference(both):
    """Every auto-routing kernel on the host route reads 0 in both
    libraries after a call (this thread); unknown names read -1."""
    nat, ref = both
    specs = _random_specs(n=40, seed=11)
    keys = [(srt.INT64, np.arange(40, dtype=np.int64) % 7, None)]
    with nat.NativeTable(port_specs(specs)) as nt, \
            ref.NativeTable(specs) as rt, \
            nat.NativeTable(port_specs(keys)) as nk, \
            ref.NativeTable(keys) as rk:
        for mod, t, k in ((nat, nt, nk), (ref, rt, rk)):
            mod.murmur3_table(t)
            mod.xxhash64_table(t)
            img = mod.convert_to_rows(t)[0]
            mod.convert_from_rows(img, [d for d, _, _ in (
                port_specs(specs) if mod is nat else specs)])
            mod.sort_order(k)
            mod.inner_join(k, k)
            mod.groupby_sum_count(k, k)
    for kernel in nat.ROUTE_KERNELS + ("no_such_kernel",):
        assert nat.kernel_was_device(kernel) == \
            ref.kernel_was_device(kernel), kernel
    assert nat.kernel_was_device("groupby") == 0
    assert nat.kernel_was_device("no_such_kernel") == -1


def test_device_entry_points_fail_cleanly_without_engine(both):
    """No engine in this process: every resident entry point raises the
    binding's CudfLikeError, as the reference's does, and leaves no
    handle behind."""
    nat, ref = both
    before = (nat.live_handles(), nat.live_device_handles())
    spec = [(RefDType(RefTypeId.INT64), np.arange(8, dtype=np.int64), None)]
    t, rt = nat.NativeTable(port_specs(spec)), ref.NativeTable(spec)
    try:
        with pytest.raises(RefError, match="not initialized"):
            ref.table_to_device(rt)
        with pytest.raises(CudfLikeError, match="not initialized"):
            nat.table_to_device(t)
        bogus = nat.DeviceTable(12345, 1)
        for call in (bogus.murmur3, bogus.xxhash64, bogus.to_rows,
                     bogus.sort_order, lambda: bogus.inner_join(bogus),
                     lambda: bogus.groupby_sum_count(bogus)):
            with pytest.raises(CudfLikeError, match="not initialized"):
                call()
        buf = nat.DeviceBuffer(777)
        with pytest.raises(CudfLikeError, match="no AOT program"):
            buf.then("chain:x")
        with pytest.raises(CudfLikeError, match="not initialized"):
            buf.then("murmur3:l:8")
        with pytest.raises(CudfLikeError, match="not initialized"):
            buf.fetch(np.int64, 8)
        with pytest.raises(CudfLikeError, match="not initialized"):
            buf.from_rows(8, [T.INT64])
        with pytest.raises(CudfLikeError, match="built without CUDA"):
            nat.cuda_init(0)
        assert not nat.cuda_available() and nat.cuda_live_buffers() == 0
        assert nat.kernel_was_device("inner_join") == 2  # failed, not host
        assert nat.kernel_launches() == {}
    finally:
        t.close()
        rt.close()
    assert (nat.live_handles(), nat.live_device_handles()) == before


@pytest.mark.parametrize("widths", [
    (8, 8, 4, 1, 4, 1, 4, 8) * 4,          # TestTables, 32 columns
    (8, 8, 4, 1, 4, 1, 4, 8) * 13,         # 104 columns
    (1,) * 1500,                            # segments: rows of 1688 bytes
    (2, 8, 1, 4, 8, 2, 2, 1, 8),
    (4,),
])
def test_pack_plan_equals_python(native_libraries, widths):  # noqa: F811
    """K6's plan as the engine builds it (pack_plan.hpp) equals the
    port's Python ``pack_plan``, word for word."""
    nat = native_libraries[0]
    assert nat.pack_plan_words(widths) == \
        list(cuda_kernels.pack_plan(tuple(widths)).words())


def test_jni_symbols_resolve(native_libraries):  # noqa: F811
    """Every ``Java_com_nvidia_spark_rapids_tpu_*`` entry of the compiled
    JNI sources (the reference's but PjrtEngineJni.cpp, and the port's
    own engine_jni.cpp in its place) is exported by the port's library,
    so a JVM that loads it reaches them, every PjrtEngine native
    included."""
    nat = native_libraries[0]
    lib = nat._lib()
    names = set()
    for src in nat.JNI_SOURCES:
        names |= set(re.findall(r"\b(Java_com_nvidia_spark_rapids_tpu_\w+)",
                                src.read_text()))
    assert len(names) > 40
    missing = [n for n in sorted(names) if not hasattr(lib, n)]
    assert not missing
    assert (ROOT / "src" / "main" / "cpp" / "jni" /
            "PjrtEngineJni.cpp") not in nat.JNI_SOURCES
    assert nat.NATIVE / "engine_jni.cpp" in nat.JNI_SOURCES
    java = (ROOT / "src" / "main" / "java" / "com" / "nvidia" / "spark" /
            "rapids" / "tpu" / "PjrtEngine.java").read_text()
    natives = re.findall(r"private static native \w+ (\w+)\(", java)
    assert len(natives) == 6
    for name in natives:
        assert hasattr(lib, f"Java_com_nvidia_spark_rapids_tpu_PjrtEngine_"
                       f"{name}"), name


def test_pjrt_engine_natives_under_the_fake_engine(
        native_libraries):  # noqa: F811
    """The mock-``JNIEnv`` driver (``tests/torch_jni_engine_driver.cpp``)
    against the port's library with the stand-in engine, in a child: a
    murmurHash3 before init takes the host route (0); a null pluginPath
    and a malformed device option throw, leaving the engine down; init
    on device 0 starts it (idempotently); the engine's queries answer;
    registerProgram throws (null arguments first, with the reference's
    message) and no program reads registered; the same murmurHash3 then
    routes to the device (1) and equals the host route."""
    import json
    import subprocess
    from spark_rapids_jni_tpu_torch import native
    from torch_native_support import build_fake_engine_library
    driver = native.build_jni_driver(
        build_fake_engine_library(),
        ROOT / "tests" / "torch_jni_engine_driver.cpp")
    proc = subprocess.run([str(driver), "host stand-in", "5000"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {
        "rows": 5000, "host_sentinel": 0,
        "null_path": "pluginPath must not be null",
        "bad_device": "the device option must be a non-negative integer",
        "init_error": "", "available": True, "device_count": 1,
        "platform": "host stand-in",
        "register_null": "name and mlir must not be null",
        "register_refused": "the CUDA engine compiles its kernels into the "
                            "library and keeps no StableHLO program "
                            "registry",
        "registered": False, "device_sentinel": 1, "equal": True,
        "failures": 0}


FAKE_ENGINE_SCRIPT = r'''
import sys
import numpy as np
sys.path.insert(0, ROOT)
from spark_rapids_jni_tpu import native as ref
from spark_rapids_jni_tpu.types import DType as RD, TypeId as RT
from spark_rapids_jni_tpu_torch import native as nat
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

nat.build = lambda *a, **k: FAKE
nat.load(device="cpu")
assert not nat.cuda_available()
nat.cuda_init(0)
assert nat.cuda_available() and nat.cuda_platform_name() == "host stand-in"
assert ref.available()

rng = np.random.default_rng(3)
n = 5000
cols = [(RT.INT32, rng.integers(-2**31, 2**31, n).astype(np.int32)),
        (RT.INT64, rng.integers(-2**62, 2**62, n)),
        (RT.TIMESTAMP_MICROSECONDS, rng.integers(-2**60, 2**60, n)),
        (RT.FLOAT32, rng.standard_normal(n).astype(np.float32)),
        (RT.FLOAT64, rng.standard_normal(n))]
def pair(cs):
    return (nat.NativeTable([(T.DType(T.TypeId(int(t))), v, None)
                             for t, v in cs]),
            ref.NativeTable([(RD(t), v, None) for t, v in cs]))
def routed(kernel, want):
    got = nat.kernel_was_device(kernel)
    assert got == want, (kernel, got, want)

t, rt = pair(cols)
nat.reset_kernel_launches()
assert (nat.murmur3_table(t) == ref.murmur3_table(rt)).all()
routed("murmur3", 1)
assert nat.kernel_launches() == {"murmur3_int32": 2, "murmur3_int64": 3}
assert (nat.xxhash64_table(t, 7) == ref.xxhash64_table(rt, 7)).all()
routed("xxhash64", 1)
rows = nat.convert_to_rows(t)
routed("to_rows", 1)
assert len(rows) == 1 and (rows[0] == ref.convert_to_rows(rt)[0]).all()
schema = [T.DType(T.TypeId(int(c))) for c, _ in cols]
back = nat.convert_from_rows(rows[0], schema)
routed("from_rows", 1)
assert nat.from_rows_was_device()
for (v, ok), (_, want) in zip(back, cols):
    assert ok.all() and (v.view(np.uint8) == want.view(np.uint8)).all()

keys = [(RT.INT32, rng.integers(0, 50, n).astype(np.int32)),
        (RT.INT64, rng.integers(-3, 3, n))]
k, rk = pair(keys)
assert (nat.sort_order(k, [False, True]) ==
        ref.sort_order(rk, [False, True])).all()
routed("sort_order", 1)
fk, rfk = pair([cols[3]])  # float keys stay on the host
assert (nat.sort_order(fk) == ref.sort_order(rfk)).all()
routed("sort_order", 0)
right = rng.permutation(1000)[:300].astype(np.int64)
left = rng.integers(0, 1000, n)
l, rl = pair([(RT.INT64, left)])
r, rr = pair([(RT.INT64, right)])
for g, w in zip(nat.inner_join(l, r), ref.inner_join(rl, rr)):
    assert (g == w).all()
routed("inner_join", 1)
dup, rdup = pair([(RT.INT64, np.concatenate([right, right[:5]]))])
for g, w in zip(nat.inner_join(l, dup), ref.inner_join(rl, rdup)):
    assert (g == w).all()
routed("inner_join", 0)  # a multi-match: the host route
v, rv = pair([cols[1], cols[4], cols[0]])
gn, gr = nat.groupby_sum_count(k, v), ref.groupby_sum_count(rk, rv)
routed("groupby", 1)
for key in ("rep_rows", "sizes"):
    assert (gn[key] == gr[key]).all()
for key in ("sums", "mins", "maxs", "means", "counts"):
    for a, b in zip(gn[key], gr[key]):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)

# resident: every route, sentinel 1, results equal the host tables'
dt = t.to_device()
assert dt.num_rows() == n and nat.live_device_handles() == 1
with dt.murmur3() as b, b.then(f"murmur3:i:{n}") as c:
    routed("murmur3", 1)
    m3 = b.fetch(np.int32)
    assert (m3 == ref.murmur3_table(rt)).all()
    one, rone = pair([(RT.INT32, m3)])
    assert (c.fetch(np.int32) == ref.murmur3_table(rone)).all()
with dt.xxhash64(7) as b:
    assert (b.fetch(np.int64) == ref.xxhash64_table(rt, 7)).all()
with dt.to_rows() as b:
    routed("to_rows", 1)
    assert b.nbytes() == rows[0].nbytes
    assert (b.fetch(np.uint8) == rows[0].reshape(-1)).all()
    for i, (d, w) in enumerate(b.from_rows(n, schema)):
        routed("from_rows", 1)
        assert (d.fetch(cols[i][1].dtype) == cols[i][1]).all()
        words = w.fetch(np.uint32)
        assert (words[:-1] == 0xFFFFFFFF).all()
        d.free(); w.free()
    try:
        b.then("chain:x")
        raise SystemExit("expected the no-program error")
    except CudfLikeError as e:
        assert "no AOT program" in str(e)
    try:
        b.then(f"murmur3:i:{n}")  # the buffer's size does not match
        raise SystemExit("expected a size error")
    except CudfLikeError as e:
        assert "does not match" in str(e)
    routed("murmur3", 2)
dk, dv = k.to_device(), v.to_device()
with dk.sort_order([False, True]) as b:
    routed("sort_order", 1)
    assert (b.fetch(np.int32) == ref.sort_order(rk, [False, True])).all()
g2 = dk.groupby_sum_count(dv)
routed("groupby", 1)
assert (g2["rep_rows"] == gr["rep_rows"]).all()
dl, dr, dd = l.to_device(), r.to_device(), dup.to_device()
li, ri = dl.inner_join(dr)
routed("inner_join", 1)
assert (li == ref.inner_join(rl, rr)[0]).all()
try:
    dl.inner_join(dd)
    raise SystemExit("expected the overflow error")
except CudfLikeError as e:
    assert "overflow" in str(e)
routed("inner_join", 2)  # failed: no host copy to fall back to
fdt = fk.to_device()
try:
    fdt.sort_order()
    raise SystemExit("expected float keys to be refused")
except CudfLikeError as e:
    assert "float keys" in str(e)
routed("sort_order", 2)
for x in (dt, dk, dv, dl, dr, dd, fdt):
    x.free()
for x in (t, k, v, l, r, dup, fk, one):
    x.close()
assert nat.live_handles() == 0 and nat.live_device_handles() == 0
assert nat.cuda_live_buffers() == 0
print("FAKE-ENGINE-PASS")
'''


def test_device_routes_through_a_host_engine(native_libraries):  # noqa: F811
    """The C ABI's device half with a stand-in engine
    (``tests/native_fake_engine.cpp``, host memory and host kernels) in a
    child process: every route both ways with sentinel 1, results equal
    to the reference binding's host route, float keys and multi-match
    joins on the host route (0), the resident overflow and refused float
    keys as errors (2), ``then`` and ``from_rows`` on resident buffers,
    and every handle and engine buffer freed. The engine is process-wide,
    so the child keeps it out of this worker."""
    import os
    import subprocess
    import sys
    from torch_native_support import build_fake_engine_library
    fake = build_fake_engine_library()
    code = FAKE_ENGINE_SCRIPT.replace("ROOT", repr(str(ROOT))).replace(
        "FAKE", repr(str(fake)), 1)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["SRT_NATIVE_LIB"] = str(native_libraries[1])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "FAKE-ENGINE-PASS" in proc.stdout
