"""The port's batching utilities against the reference's: the row-bucket
grid, column padding, the plan cache's eviction, the batch knobs and the
batched join.

- ``bucket_sizes`` over 0-100,000 at several floors, and ``bucket_rows``
  at the reference's configured floor;
- ``pad_column`` / ``pad_table`` byte-equal (data, validity words,
  offsets and bytes) for INT32, INT64, DECIMAL128, STRING and STRUCT,
  with and without nulls;
- ``PlanCacheLRU``'s eviction counters, its release of an evicted or
  cleared entry, and its byte charge with least-recently-used eviction;
- ``batch_route``, ``max_batch_queries`` (with its clamp counter and
  flight note) and ``batch_capacity`` over the same settings;
- ``inner_join_batched`` against the reference's and against K solo
  ``inner_join`` calls, narrow and wide keys
  (``tests/test_sort_join_groupby.py``'s cases).
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import obs as ref_obs
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.config import get_config as ref_get_config
from spark_rapids_jni_tpu.config import set_config as ref_set_config
from spark_rapids_jni_tpu.ops import fused_pipeline as ref_fp
from spark_rapids_jni_tpu.ops import inner_join_batched as ref_ijb
from spark_rapids_jni_tpu.utils import batching as ref_batching
from spark_rapids_jni_tpu.utils import plan_cache as ref_plan_cache

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import fused_pipeline as fp
from spark_rapids_jni_tpu_torch.ops import inner_join, inner_join_batched
from spark_rapids_jni_tpu_torch.utils import batching, plan_cache

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("SRT_BATCH_ROUTE", "SRT_BATCH_MAX", "SRT_PLAN_CACHE_SIZE"):
        monkeypatch.delenv(k, raising=False)
    obs.reset_all()
    floor = ref_get_config().shape_bucket_floor
    yield
    obs.reset_all()
    ref_set_config(shape_bucket_floor=floor)


@pytest.mark.parametrize("floor", [0, 1, 7, 64, 1024, 4096])
def test_bucket_sizes_equal_reference(floor):
    for n in list(range(0, 5000)) + list(range(5000, 100_001, 37)) \
            + [100_000]:
        assert batching.bucket_sizes(n, floor) == \
            ref_batching.bucket_sizes(n, floor), (n, floor)


@pytest.mark.parametrize("floor", [None, 0, 512, 3000])
def test_bucket_rows_reads_the_floor(floor):
    """The reference reads its floor from the config; the port takes it
    as an argument, the reference's default 1024 when none is given."""
    ref_set_config(shape_bucket_floor=1024 if floor is None else floor)
    for n in (0, 1, 500, 1023, 1025, 3001, 70_000):
        got = (batching.bucket_rows(n) if floor is None
               else batching.bucket_rows(n, floor))
        assert got == ref_batching.bucket_rows(n)


def _bytes(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _same_column(got: Column, want: RefColumn) -> None:
    assert got.size == want.size
    assert got.dtype.id == want.dtype.id
    if want.data is None:
        assert got.data is None
    else:
        assert _bytes(got.data.numpy()) == _bytes(want.data)
    assert (got.validity is None) == (want.validity is None)
    if want.validity is not None:
        assert _bytes(got.validity.numpy()) == _bytes(want.validity)
    assert len(got.children) == len(want.children)
    for g, w in zip(got.children, want.children):
        _same_column(g, w)


def _columns(kind: str, n: int, nulls: bool):
    rng = np.random.default_rng(5)
    valid = rng.random(n) > 0.3 if nulls else None
    if kind in ("int32", "int64"):
        v = rng.integers(-10**6, 10**6, n).astype(kind)
        return (Column.from_numpy(v, valid, device=CPU),
                RefColumn.from_numpy(v, valid))
    if kind == "decimal128":
        ints = [None if (valid is not None and not valid[i])
                else int(rng.integers(-2**62, 2**62)) * 2**40
                for i in range(n)]
        return (Column.decimal128_from_ints(ints, -3, device=CPU),
                RefColumn.decimal128_from_ints(ints, -3))
    if kind == "string":
        strs = [None if (valid is not None and not valid[i])
                else "x" * int(rng.integers(0, 9)) for i in range(n)]
        return (Column.strings_from_list(strs, device=CPU),
                RefColumn.strings_from_list(strs))
    a = rng.integers(0, 100, n).astype(np.int32)
    b = rng.integers(0, 100, n).astype(np.int64)
    return (Column.struct_from_children(
                [Column.from_numpy(a, device=CPU),
                 Column.from_numpy(b, valid, device=CPU)], valid,
                field_names=["a", "b"]),
            RefColumn.struct_from_children(
                [RefColumn.from_numpy(a), RefColumn.from_numpy(b, valid)],
                valid, field_names=["a", "b"]))


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("kind", ["int32", "int64", "decimal128", "string",
                                  "struct"])
def test_pad_column_byte_equal(kind, nulls):
    got, want = _columns(kind, 37, nulls)
    for target in (37, 40, 64, 1024):
        _same_column(batching.pad_column(got, target),
                     ref_batching.pad_column(want, target))


def test_pad_table_byte_equal():
    cols = [_columns(k, 21, k != "int64")
            for k in ("int32", "int64", "string")]
    got = batching.pad_table(Table([g for g, _ in cols]), 48)
    want = ref_batching.pad_table(RefTable([w for _, w in cols]), 48)
    assert got.num_rows == want.num_rows == 48
    for g, w in zip(got.columns, want.columns):
        _same_column(g, w)


@pytest.mark.parametrize("cap,inserts", [(1, 3), (2, 5), (4, 4)])
def test_plan_cache_evictions_equal_reference(cap, inserts, monkeypatch):
    monkeypatch.setenv("SRT_PLAN_CACHE_SIZE", str(cap))
    port = plan_cache.PlanCacheLRU("t", ("a.evictions", "a.evictions.t"))
    ref = ref_plan_cache.PlanCacheLRU("t", ("a.evictions",
                                            "a.evictions.t"))
    released = []
    rbefore = ref_obs.kernel_stats()
    for i in range(inserts):
        port[i] = {"release": lambda i=i: released.append(i)}
        ref[i] = {"i": i}
        port.get(0)  # recency: 0 stays while it is read
        ref.get(0)
    delta = obs.kernel_stats()
    rdelta = ref_obs.stats_since(rbefore)
    assert len(port) == len(ref) == min(cap, inserts)
    for name in ("a.evictions", "a.evictions.t"):
        assert delta.get(name, 0) == rdelta.get(name, 0)
    assert len(released) == max(0, inserts - cap)
    assert 0 not in released or cap == 1
    port.clear()
    assert len(port) == 0
    assert sorted(released) == list(range(inserts))


def test_plan_cache_charges_bytes_and_evicts_oldest():
    port = plan_cache.PlanCacheLRU("t", ("a.evictions", "a.evictions.t"))
    released = []
    for i in range(3):
        port[i] = {"bytes": 10 * (i + 1),
                   "release": lambda i=i: released.append(i)}
    port[3] = "not a dict"  # charges nothing
    assert port.nbytes() == 60
    port.get(0)  # 1 is now the least recently used
    keep = port.get(1)
    assert port.evict_oldest(keep=keep)  # 1 is kept: 2 goes
    assert released == [2] and port.nbytes() == 30
    assert port.evict_oldest()  # "not a dict" goes, releasing nothing
    assert port.evict_oldest() and port.evict_oldest(keep=keep) is False
    assert released == [2, 0] and len(port) == 1
    assert port.nbytes() == 20
    assert obs.kernel_stats().get("a.evictions.t") == 3


@pytest.mark.parametrize("route", [None, "padded", "ragged", "auto",
                                   "bogus", "RAGGED"])
def test_batch_route_equals_reference(route, monkeypatch):
    if route is not None:
        monkeypatch.setenv("SRT_BATCH_ROUTE", route)
    assert fp.batch_route() == ref_fp.batch_route()


@pytest.mark.parametrize("k", [None, "0", "1", "3", "8", "16", "17", "64",
                               "nope"])
def test_max_batch_queries_equals_reference(k, monkeypatch):
    if k is not None:
        monkeypatch.setenv("SRT_BATCH_MAX", k)
    rbefore = ref_obs.kernel_stats()
    assert fp.max_batch_queries() == ref_fp.max_batch_queries()
    rdelta = ref_obs.stats_since(rbefore)
    got = obs.kernel_stats().get("serving.batch.max_clamped", 0)
    assert got == rdelta.get("serving.batch.max_clamped", 0)
    if k in ("17", "64"):
        assert got == 1
        notes = [e for e in obs.flight_snapshot()["events"]
                 if e["kind"] == "batch.max_clamped"]
        assert len(notes) <= 1


def test_batch_capacity_equals_reference():
    assert fp.BATCH_CAPACITIES == ref_fp.BATCH_CAPACITIES
    for k in range(0, 20):
        assert fp.batch_capacity(k) == ref_fp.batch_capacity(k)


def _key_tables(keys):
    return ([Table([Column.from_numpy(k, device=CPU)]) for k in keys],
            [RefTable([RefColumn.from_numpy(k)]) for k in keys])


def _pairs(li, ri):
    return sorted(zip(np.asarray(li).tolist(), np.asarray(ri).tolist()))


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_inner_join_batched_narrow(seed):
    rng = np.random.default_rng(seed)
    lk = [rng.integers(0, 40, 150).astype(np.int64) for _ in range(4)]
    rk = [rng.integers(0, 40, 120).astype(np.int64) for _ in range(4)]
    lefts, rlefts = _key_tables(lk)
    rights, rrights = _key_tables(rk)
    before = obs.kernel_stats()
    outs = inner_join_batched(lefts, rights)
    assert obs.stats_since(before).get(
        "rel.route.join.batched.narrow") == 1
    ref_outs = ref_ijb(rlefts, rrights)
    for (li, ri), (rli, rri), lt, rt, l_, r_ in zip(
            outs, ref_outs, lefts, rights, lk, rk):
        assert li.dtype == ri.dtype == torch.int32
        assert (l_[li.numpy()] == r_[ri.numpy()]).all()
        assert _pairs(li, ri) == _pairs(rli, rri)
        sli, sri = inner_join(lt, rt)
        assert torch.equal(li, sli) and torch.equal(ri, sri)


def test_inner_join_batched_wide():
    rng = np.random.default_rng(10)
    lk = rng.integers(-2**62, 2**62, 100).astype(np.int64)
    rk = np.concatenate([lk[:25],
                         rng.integers(-2**62, 2**62, 75).astype(np.int64)])
    lefts, rlefts = _key_tables([lk, rk])
    rights, rrights = _key_tables([rk, lk])
    before = obs.kernel_stats()
    outs = inner_join_batched(lefts, rights)
    assert obs.stats_since(before).get("rel.route.join.batched.wide") == 1
    ref_outs = ref_ijb(rlefts, rrights)
    for (li, ri), (rli, rri), lt, rt in zip(outs, ref_outs, lefts, rights):
        assert li.shape[0] >= 25
        assert _pairs(li, ri) == _pairs(rli, rri)
        sli, sri = inner_join(lt, rt)
        assert torch.equal(li, sli) and torch.equal(ri, sri)


def test_inner_join_batched_rejects_what_the_reference_rejects():
    a = Table([Column.from_numpy(np.arange(5, dtype=np.int64), device=CPU)])
    b = Table([Column.from_numpy(np.arange(6, dtype=np.int64), device=CPU)])
    nullable = Table([Column.from_numpy(np.arange(5, dtype=np.int64),
                                        np.array([1, 0, 1, 1, 1], bool),
                                        device=CPU)])
    with pytest.raises(Exception, match="nonzero"):
        inner_join_batched([], [])
    with pytest.raises(Exception, match="share a row count"):
        inner_join_batched([a, b], [a, a])
    with pytest.raises(Exception, match="non-nullable"):
        inner_join_batched([nullable], [a])
