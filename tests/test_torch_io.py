"""Arrow and Parquet interchange of the PyTorch/CUDA port, against the JAX
package.

The same pyarrow tables go through both packages' ``from_arrow``: every
column's type, values and validity must be byte-equal (fixed-width with
nulls, dates and timestamps, strings, DECIMAL32/64 and DECIMAL128 in the
port's (N, 2) int64 lanes, STRUCT with its field names), and
``to_arrow`` must give back the same Arrow table. The Parquet case reads
a written file with ``read_parquet`` (whole and projected), joins and
aggregates it (``tests/test_io_copying.py``'s pipeline) and holds the
result against the reference's.
"""

import datetime
import decimal

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from spark_rapids_jni_tpu.io import from_arrow as ref_from_arrow  # noqa
from spark_rapids_jni_tpu.io import read_parquet as ref_read_parquet  # noqa
from spark_rapids_jni_tpu.io import to_arrow as ref_to_arrow  # noqa

from spark_rapids_jni_tpu_torch.columnar import Table  # noqa: E402
from spark_rapids_jni_tpu_torch.io import (from_arrow,  # noqa: E402
                                           read_parquet, to_arrow)
from spark_rapids_jni_tpu_torch.ops import (groupby_aggregate,  # noqa
                                            inner_join)

CPU = torch.device("cpu")


def _same_column(c, r) -> None:
    assert c.dtype.id.value == r.dtype.id.value
    assert c.dtype.scale == r.dtype.scale
    assert c.size == r.size
    assert c.to_pylist() == r.to_pylist()
    if c.data is not None:  # the same bytes (DECIMAL128: uint64 lanes there)
        assert c.data.numpy().tobytes() == np.asarray(r.data).tobytes()
    assert (c.validity is None) == (r.validity is None)
    if c.validity is not None:
        np.testing.assert_array_equal(c.validity.numpy(),
                                      np.asarray(r.validity))
    assert len(c.children) == len(r.children)
    if c.field_names is not None or getattr(r, "field_names", None):
        assert tuple(c.field_names) == tuple(r.field_names)
    for a, b in zip(c.children, r.children):
        _same_column(a, b)


TABLES = {
    "fixed_width": lambda: pa.table({
        "a": pa.array([1, 2, None, 4], pa.int64()),
        "b": pa.array([1.5, None, 3.5, 4.5], pa.float64()),
        "c": pa.array([True, False, None, True], pa.bool_()),
        "d": pa.array([10, 20, 30, 40], pa.int32()),
        "e": pa.array([-1, None, 7, 127], pa.int8()),
        "f": pa.array([1.25, 2.5, None, -0.0], pa.float32()),
        "g": pa.array([3, 2, 1, None], pa.uint16()),
    }),
    "dates": lambda: pa.table({
        "d": pa.array([datetime.date(2020, 1, 2), datetime.date(2000, 2, 29),
                       datetime.date(1969, 12, 31), datetime.date(1, 1, 1)],
                      pa.date32()),
        "t": pa.array([0, 1_600_000_000_000_000, None, -5],
                      pa.timestamp("us")),
    }),
    "strings_and_decimals": lambda: pa.table({
        "s": pa.array(["x", None, "yz", ""], pa.string()),
        "d": pa.array([None, 1, 2, -3], pa.decimal128(10, 2)),
        "d9": pa.array([5, None, -7, 0], pa.decimal128(7, 3)),
        "d38": pa.array([decimal.Decimal("12345678901234567890.1234"),
                         None, decimal.Decimal("-" + "9" * 30 + ".5"),
                         decimal.Decimal(42)], pa.decimal128(38, 4)),
    }),
    "struct": lambda: pa.table({
        "st": pa.array([{"x": 1, "y": "a"}, None, {"x": None, "y": "bc"},
                        {"x": 4, "y": None}],
                       pa.struct([("x", pa.int64()), ("y", pa.string())])),
        "k": pa.array([1, 2, 3, 4], pa.int64()),
    }),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_arrow_round_trip_matches_reference(name):
    t = TABLES[name]()
    got, want = from_arrow(t, device=CPU), ref_from_arrow(t)
    assert got.num_rows == want.num_rows == t.num_rows
    assert got.num_columns == want.num_columns
    for c, r in zip(got.columns, want.columns):
        _same_column(c, r)
    back = to_arrow(got, names=t.column_names)
    ref_back = ref_to_arrow(want, names=t.column_names)
    assert back.equals(ref_back), (back, ref_back)
    assert back.column_names == t.column_names


def test_arrow_values():
    t = TABLES["strings_and_decimals"]()
    dev = from_arrow(t, device=CPU)
    assert dev.columns[0].to_pylist() == ["x", None, "yz", ""]
    assert dev.columns[1].to_pylist() == [None, 100, 200, -300]
    back = to_arrow(dev, names=t.column_names)
    assert [None if v is None else str(v) for v in
            back.column("d").to_pylist()] == [None, "1.00", "2.00", "-3.00"]
    assert back.column("s").to_pylist() == ["x", None, "yz", ""]


def test_null_dates_decode():
    # with a NULL the reference's fill for date32 (an int64 scalar cast)
    # is refused by pyarrow; the port fills from int32
    t = pa.table({"d": pa.array([datetime.date(2020, 1, 2), None],
                                pa.date32())})
    col = from_arrow(t, device=CPU).columns[0]
    assert col.to_pylist() == [18263, None]
    back = to_arrow(Table([col]), names=["d"])
    assert back.column("d").to_pylist() == [18263, None]


def test_parquet_join_groupby_pipeline(tmp_path):
    rng = np.random.default_rng(13)
    n = 5000
    trips = pa.table({
        "vendor": pa.array(rng.integers(0, 5, n), pa.int64()),
        "fare": pa.array(rng.uniform(3, 80, n), pa.float64()),
    })
    vendors = pa.table({
        "vendor": pa.array(np.arange(5), pa.int64()),
        "active": pa.array([1, 1, 0, 1, 0], pa.int64()),
    })
    p1, p2 = tmp_path / "trips.parquet", tmp_path / "vendors.parquet"
    pq.write_table(trips, p1, row_group_size=1000)
    pq.write_table(vendors, p2)
    t_trips = read_parquet(str(p1), device=CPU)
    ref_trips = ref_read_parquet(str(p1))
    for c, r in zip(t_trips.columns, ref_trips.columns):
        _same_column(c, r)
    proj = read_parquet(str(p1), columns=["fare"], device=CPU)
    assert proj.num_columns == 1
    _same_column(proj.columns[0], t_trips.columns[1])
    t_vendors = read_parquet(str(p2), device=CPU)
    li, ri = inner_join(Table([t_trips.columns[0]]),
                        Table([t_vendors.columns[0]]))
    assert li.shape[0] == n  # every trip matches one vendor
    out = groupby_aggregate(Table([t_trips.columns[0]]),
                            Table([t_trips.columns[1]]),
                            [(0, "sum"), (0, "count_all")])
    sums = dict(zip(out.columns[0].to_pylist(), out.columns[1].to_pylist()))
    v = np.asarray(trips.column("vendor"))
    f = np.asarray(trips.column("fare"))
    for key in range(5):
        np.testing.assert_allclose(sums[key], f[v == key].sum(), rtol=1e-12)
