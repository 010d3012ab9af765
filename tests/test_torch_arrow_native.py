"""Arrow C Data Interface -> the port's native table views (zero copy),
against the reference's binding on the same pyarrow arrays.

Mirrors ``test_arrow_native.py``: fixed-width and STRING columns hash as
the same columns built from raw numpy; sort and groupby over imported
tables; the release callback runs exactly once, on close (and on a
refused import); sliced arrays, struct-level nulls and dictionaries are
refused with the reference's messages.
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu.types import DType as RefDType, TypeId as RefTypeId
from spark_rapids_jni_tpu.utils.errors import CudfLikeError as RefError

from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

from torch_native_support import (native_libraries,  # noqa: F401
                                  pack_valid, port_specs, reference_native)

pa = pytest.importorskip("pyarrow")

I64 = RefDType(RefTypeId.INT64)
STR = RefDType(RefTypeId.STRING)


@pytest.fixture
def both(native_libraries, reference_native):  # noqa: F811
    return native_libraries[0], reference_native


def test_arrow_fixed_width_and_strings_hash(both):
    nat, ref = both
    rng = np.random.default_rng(31)
    n = 1000
    ints = rng.integers(-2**62, 2**62, n, dtype=np.int64)
    ivalid = rng.random(n) > 0.2
    words = ["", "spark", "naïve", "日本語", "x" * 33]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    svalid = rng.random(n) > 0.1
    arrow = pa.StructArray.from_arrays(
        [pa.array([int(v) if ok else None for v, ok in zip(ints, ivalid)],
                  pa.int64()),
         pa.array([s if ok else None for s, ok in zip(strs, svalid)],
                  pa.utf8())], names=["k", "s"])
    with nat.ArrowTable(arrow) as at, ref.ArrowTable(arrow) as rt:
        assert (at.num_rows, at.num_columns) == (rt.num_rows, rt.num_columns)
        got = (nat.murmur3_table(at, seed=42), nat.xxhash64_table(at, seed=42))
        want = (ref.murmur3_table(rt, seed=42),
                ref.xxhash64_table(rt, seed=42))
    # and the same logical columns built from raw numpy buffers
    enc = [s.encode() for s in strs]
    chars = b"".join(b if ok else b"" for b, ok in zip(enc, svalid))
    offs = np.zeros(n + 1, np.int32)
    np.cumsum([len(b) if ok else 0 for b, ok in zip(enc, svalid)],
              out=offs[1:])
    specs = [(I64, ints, pack_valid(ivalid)),
             (STR, (offs, np.frombuffer(chars, np.uint8)), pack_valid(svalid))]
    with nat.NativeTable(port_specs(specs)) as nt:
        raw = (nat.murmur3_table(nt, seed=42), nat.xxhash64_table(nt, seed=42))
    for g, w, r in zip(got, want, raw):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)


def test_arrow_table_sort_and_groupby(both):
    nat, ref = both
    t = pa.table({
        "k": pa.array([3, 1, 2, 1, 3, 2], pa.int64()),
        "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], pa.float64()),
    })
    for mod in (nat, ref):
        with mod.ArrowTable.from_pyarrow(t.select(["k"])) as keys:
            order = mod.sort_order(keys)
            assert np.asarray(t["k"])[order].tolist() == [1, 1, 2, 2, 3, 3]
            with mod.ArrowTable.from_pyarrow(t.select(["v"])) as vals:
                g = mod.groupby_sum_count(keys, vals)
                by_key = {int(t["k"][int(r)].as_py()): float(g["sums"][0][i])
                          for i, r in enumerate(g["rep_rows"])}
                assert by_key == {1: 6.0, 2: 9.0, 3: 6.0}


def test_arrow_release_fires_on_close(both):
    nat, _ = both
    arr = pa.StructArray.from_arrays(
        [pa.array(np.arange(64, dtype=np.int64))], names=["x"])
    before = nat.live_handles()
    pool = pa.total_allocated_bytes()
    at = nat.ArrowTable(arr)
    assert nat.live_handles() == before + 1
    at.close()
    at.close()  # a second close releases nothing more
    assert nat.live_handles() == before
    assert pa.total_allocated_bytes() == pool
    # the exported structs were moved: the producer's are released
    assert at._array.release is None and at._schema.release is None


def test_arrow_sliced_array_rejected(both):
    nat, ref = both
    arr = pa.StructArray.from_arrays(
        [pa.array(np.arange(64, dtype=np.int64))], names=["x"])
    before = nat.live_handles()
    with pytest.raises(CudfLikeError, match="offset|sliced") as got:
        nat.ArrowTable(arr.slice(8, 16))
    with pytest.raises(RefError) as want:
        ref.ArrowTable(arr.slice(8, 16))
    assert str(got.value) == str(want.value)
    assert nat.live_handles() == before


def test_arrow_struct_level_nulls_rejected(both):
    nat, ref = both
    arr = pa.StructArray.from_arrays(
        [pa.array(np.arange(8, dtype=np.int64))], names=["x"],
        mask=pa.array([False, True] * 4))
    with pytest.raises(CudfLikeError, match="struct-level nulls") as got:
        nat.ArrowTable(arr)
    with pytest.raises(RefError) as want:
        ref.ArrowTable(arr)
    assert str(got.value) == str(want.value)


def test_arrow_dictionary_rejected(both):
    nat, ref = both
    dict_arr = pa.array(["a", "b", "a", "c"]).dictionary_encode()
    arr = pa.StructArray.from_arrays([dict_arr], names=["d"])
    with pytest.raises(CudfLikeError, match="dictionary") as got:
        nat.ArrowTable(arr)
    with pytest.raises(RefError) as want:
        ref.ArrowTable(arr)
    assert str(got.value) == str(want.value)
