"""Row <-> column conversion of the PyTorch/CUDA port against the JAX
package, on the same numpy columns (built as in ``test_torch_hashing``).

- ``convert_to_rows`` gives the reference's bytes and offsets exactly,
  for fixed-width schemas with and without nulls (K6 on its plain
  version here), and for DECIMAL128 and STRING schemas (the torch
  route);
- ``convert_from_rows`` of those rows gives back every valid value and
  every validity bit, float NaN payloads byte for byte, and equals the
  reference's decoding of the same bytes;
- batches split below 2 GB in multiples of 32 rows, as
  ``tests/test_row_conversion.py`` checks it, and with a lowered cap the
  split batches carry the reference's bytes;
- under ``SRT_METRICS`` each conversion records its span with the step
  spans nested under it; with both switches off it builds no span.
"""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu as srt
from spark_rapids_jni_tpu.ops import row_conversion as ref_rc

from spark_rapids_jni_tpu_torch import config as port_config
from spark_rapids_jni_tpu_torch import obs as port_obs
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.obs import spans as port_spans
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
from spark_rapids_jni_tpu_torch.tpcds.carry import table_from_arrays
from spark_rapids_jni_tpu_torch.types import DType, TypeId
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

from test_torch_hashing import _both, _column_arrays

# BASELINE config 2 / TestTables.java: eight types, repeated 4x
TEST_TABLES_8 = [(TypeId.INT64, 0), (TypeId.FLOAT64, 0), (TypeId.INT32, 0),
                 (TypeId.BOOL8, 0), (TypeId.FLOAT32, 0), (TypeId.INT8, 0),
                 (TypeId.DECIMAL32, -3), (TypeId.DECIMAL64, -8)]


def _arrays(rng, schema, n, null_share=0.15):
    out = []
    for tid, _ in schema:
        dtype, data, valid = _column_arrays(rng, tid, n)
        if null_share == 0:
            valid = np.ones(n, bool)
        out.append((dtype, data, valid))
    return out


def _port_schema(ref_table):
    return [DType(TypeId(int(d.id)), d.scale) for d in ref_table.schema()]


def _rows_equal(got_rows, want_rows):
    assert len(got_rows) == len(want_rows)
    for g, w in zip(got_rows, want_rows):
        assert g.dtype.id == TypeId.LIST and g.size == w.size
        np.testing.assert_array_equal(g.offsets.data.numpy(),
                                      np.asarray(w.offsets.data))
        assert g.child.data.dtype == torch.int8
        np.testing.assert_array_equal(g.child.data.numpy(),
                                      np.asarray(w.child.data))


def _tables_equal(got: Table, arrays) -> None:
    """Every valid value (bytes) and every validity bit of ``got`` equals
    the host arrays it was built from."""
    assert got.num_columns == len(arrays)
    for col, ((tid, scale), data, valid) in zip(got.columns, arrays):
        assert col.dtype == DType(TypeId(tid), scale)
        np.testing.assert_array_equal(col.valid_bool().numpy(), valid)
        if tid == TypeId.STRING:
            offsets, chars = data
            want = [bytes(chars[offsets[i]:offsets[i + 1]]).decode()
                    if valid[i] else None for i in range(len(valid))]
            assert col.to_pylist() == want
            continue
        got_v = col.data.numpy()
        want_v = np.asarray(data).view(got_v.dtype).reshape(got_v.shape)
        np.testing.assert_array_equal(
            got_v.view(np.uint8).reshape(len(valid), -1)[valid],
            want_v.view(np.uint8).reshape(len(valid), -1)[valid])


@pytest.mark.parametrize("n,null_share", [(1000, 0.0), (1000, 0.01),
                                          (37, 0.5), (1, 0.15)])
def test_test_tables_schema_rows_equal_reference(n, null_share):
    rng = np.random.default_rng(n)
    schema = TEST_TABLES_8 * 4
    arrays = _arrays(rng, schema, n, null_share)
    ref, got = _both(arrays)
    before = kernel_stats()
    rows = rc.convert_to_rows(got)
    assert stats_since(before) == {"row_conversion.route.pack_rows": 1}
    assert rows[0].child.size == 200 * n  # the 200-byte row
    _rows_equal(rows, ref_rc.convert_to_rows(ref))
    _tables_equal(rc.convert_from_rows(rows[0], got.schema()), arrays)


def test_wide_table_rows_equal_reference():
    # 105 columns: K6 takes any number of columns, as the reference's
    # _pack_rows_compiled and copy_from_fixed_width_columns do
    rng = np.random.default_rng(105)
    n = 300
    schema = TEST_TABLES_8 * 13 + [(TypeId.INT16, 0)]
    arrays = _arrays(rng, schema, n)
    ref, got = _both(arrays)
    before = kernel_stats()
    rows = rc.convert_to_rows(got)
    assert stats_since(before) == {"row_conversion.route.pack_rows": 1}
    _rows_equal(rows, ref_rc.convert_to_rows(ref))
    _tables_equal(rc.convert_from_rows(rows[0], got.schema()), arrays)


@pytest.mark.parametrize("repeats", [4, 13], ids=["32_columns",
                                                 "104_columns"])
@pytest.mark.parametrize("null_share", [0.0, 0.15], ids=["all_valid",
                                                         "nulls"])
def test_from_rows_equals_reference(repeats, null_share):
    # the reference's rows decoded by both packages: every column's
    # validity words (K3's table form here, the reference's per-column
    # pack there) and data equal
    rng = np.random.default_rng(repeats * 100 + int(null_share * 100))
    n = 1001
    arrays = _arrays(rng, TEST_TABLES_8 * repeats, n, null_share)
    ref, got = _both(arrays)
    want_rows = ref_rc.convert_to_rows(ref)[0]
    rows = rc.convert_to_rows(got)[0]
    np.testing.assert_array_equal(rows.child.data.numpy(),
                                  np.asarray(want_rows.child.data))
    want = ref_rc.convert_from_rows(want_rows, ref.schema())
    back = rc.convert_from_rows(rows, got.schema())
    assert back.num_columns == want.num_columns == 8 * repeats
    for pc, rcol in zip(back.columns, want.columns):
        assert pc.validity.dtype == torch.uint32
        np.testing.assert_array_equal(pc.validity.numpy(),
                                      np.asarray(rcol.validity))
        np.testing.assert_array_equal(
            pc.data.numpy().view(np.uint8),
            np.asarray(rcol.data).view(np.uint8))


def test_reference_round_trip_table():
    # RowConversionTest.java:30-38: one null per column
    arrays = []
    for (tid, scale), vals in zip(TEST_TABLES_8, [
            [1, None, 3, 4, 5], [1.0, 2.0, None, 4.0, 5.0],
            [1, 2, 3, None, 5], [1, 0, 1, 1, None],
            [1.0, 2.0, 4.0, None, 5.0], [1, 2, 3, None, 5],
            [12345, None, 12521, 12451, 65317],
            [123456790, 987654321, None, 1, 32]]):
        st = DType(tid, scale).storage_dtype
        arrays.append(((int(tid), scale),
                       np.array([0 if v is None else v for v in vals], st),
                       np.array([v is not None for v in vals])))
    ref, got = _both(arrays)
    rows = rc.convert_to_rows(got)
    _rows_equal(rows, ref_rc.convert_to_rows(ref))
    back = rc.convert_from_rows(rows[0], got.schema())
    _tables_equal(back, arrays)
    assert back.columns[0].to_pylist() == [1, None, 3, 4, 5]


@pytest.mark.parametrize("schema", [
    [(TypeId.INT64, 0), (TypeId.STRING, 0), (TypeId.FLOAT32, 0),
     (TypeId.STRING, 0)],
    TEST_TABLES_8 * 4 + [(TypeId.STRING, 0), (TypeId.STRING, 0)],
    [(TypeId.DECIMAL128, -2), (TypeId.INT8, 0), (TypeId.INT16, 0)],
    [(TypeId.STRING, 0), (TypeId.DECIMAL128, 0), (TypeId.BOOL8, 0)],
], ids=["mixed", "test_tables_plus_strings", "decimal128", "all"])
def test_torch_route_rows_equal_reference(schema):
    rng = np.random.default_rng(len(schema))
    n = 300
    arrays = _arrays(rng, schema, n)
    ref, got = _both(arrays)
    before = kernel_stats()
    rows = rc.convert_to_rows(got)
    assert stats_since(before) == {"row_conversion.route.torch": 1}
    _rows_equal(rows, ref_rc.convert_to_rows(ref))
    _tables_equal(rc.convert_from_rows(rows[0], got.schema()), arrays)
    # the reference decodes the port's bytes, the port the reference's
    ref_back = ref_rc.convert_from_rows(ref_rc.convert_to_rows(ref)[0],
                                        ref.schema())
    for pc, rcol in zip(rc.convert_from_rows(rows[0], got.schema()).columns,
                        ref_back.columns):
        assert _canon(pc.to_pylist()) == _canon(rcol.to_pylist())


def _canon(values):
    """NaN as a string, so that equal lists compare equal."""
    return ["nan" if isinstance(v, float) and v != v else v for v in values]


def test_float_nan_payloads_survive_byte_exact():
    bits64 = np.array([0x7FF8000000000000, 0xFFF8000000000000,
                       0x7FF0000000000001, 0x0000000000000001,
                       0x8000000000000000], np.uint64)
    bits32 = np.array([0x7FC00000, 0xFFC00001, 0x7F800001, 0x00000001,
                       0x80000000], np.uint32)
    arrays = [((int(TypeId.FLOAT64), 0), bits64.view(np.float64),
               np.ones(5, bool)),
              ((int(TypeId.FLOAT32), 0), bits32.view(np.float32),
               np.array([1, 1, 0, 1, 1], bool))]
    t = table_from_arrays(*zip(*arrays), device="cpu")
    rows = rc.convert_to_rows(t)
    raw = rows[0].child.data.numpy().view(np.uint8).reshape(5, -1)
    np.testing.assert_array_equal(raw[:, :8].copy().view(np.uint64)[:, 0],
                                  bits64)
    back = rc.convert_from_rows(rows[0], t.schema())
    np.testing.assert_array_equal(back.columns[0].data.numpy()
                                  .view(np.uint64), bits64)
    got32 = back.columns[1].data.numpy().view(np.uint32)
    np.testing.assert_array_equal(got32[[0, 1, 3, 4]], bits32[[0, 1, 3, 4]])


def test_layouts_equal_reference():
    from spark_rapids_jni_tpu import types as RT
    for schema in (TEST_TABLES_8 * 4, [(TypeId.BOOL8, 0), (TypeId.INT16, 0),
                                       (TypeId.DURATION_DAYS, 0)],
                   [(TypeId.INT8, 0), (TypeId.DECIMAL128, 0),
                    (TypeId.INT32, 0), (TypeId.STRING, 0)]):
        port = [DType(t, s) for t, s in schema]
        ref = [RT.DType(RT.TypeId(int(t)), s) for t, s in schema]
        pl, rl = rc.RowLayout(port), ref_rc.RowLayout(ref)
        assert (pl.starts, pl.sizes, pl.validity_offset, pl.var_start) == \
            (rl.starts, rl.sizes, rl.validity_offset, rl.var_start)
        if not any(t == TypeId.STRING for t, _ in schema):
            assert rc.compute_fixed_width_layout(port) == \
                tuple(ref_rc.compute_fixed_width_layout(ref))
    assert rc.compute_fixed_width_layout(
        [DType(t, s) for t, s in TEST_TABLES_8 * 4])[0] == 200


def test_batching_splits_below_2gb():
    # tests/test_row_conversion.py's arithmetic, for the 200-byte row
    size_per_row = rc.compute_fixed_width_layout(
        [DType(t, s) for t, s in TEST_TABLES_8 * 4])[0]
    rows = rc.max_rows_per_batch(size_per_row)
    assert rows == 10_737_408 and rows % 32 == 0
    assert rows * size_per_row < srt.types.SIZE_TYPE_MAX
    assert (rows + 32) * size_per_row >= srt.types.SIZE_TYPE_MAX
    # 12,000,000 rows split as 10,737,408 + 1,262,592
    assert 12_000_000 - rows == 1_262_592


@pytest.mark.parametrize("schema", [TEST_TABLES_8,
                                    TEST_TABLES_8 + [(TypeId.STRING, 0)]],
                         ids=["fixed", "strings"])
def test_split_batches_carry_the_reference_bytes(schema, monkeypatch):
    rng = np.random.default_rng(9)
    n = 333
    arrays = _arrays(rng, schema, n)
    ref, got = _both(arrays)
    want = ref_rc.convert_to_rows(ref)[0]
    want_offs = np.asarray(want.offsets.data)
    want_bytes = np.asarray(want.child.data)
    # a cap of about 100 rows: batches of 96 rows, 32-row multiples
    row_bytes = rc.RowLayout(got.schema()).var_start
    if any(t == TypeId.STRING for t, _ in schema):
        row_bytes += rc.align_offset(max(
            rc.max_length(c) for c in got.columns
            if c.dtype.id == TypeId.STRING), 8)
    monkeypatch.setattr(rc, "SIZE_TYPE_MAX", row_bytes * 100)
    batches = rc.convert_to_rows(got)
    assert [b.size for b in batches] == [96, 96, 96, 45]
    start = 0
    for b in batches:
        offs = b.offsets.data.numpy()
        lo = want_offs[start]
        np.testing.assert_array_equal(offs, want_offs[start:start + b.size
                                                      + 1] - lo)
        np.testing.assert_array_equal(
            b.child.data.numpy(), want_bytes[lo:lo + offs[-1]])
        back = rc.convert_from_rows(b, got.schema())
        _tables_equal(back, [
            (d, (data[0][start:start + b.size + 1] - data[0][start],
                 data[1][data[0][start]:]) if d[0] == TypeId.STRING else
             data[start:start + b.size], v[start:start + b.size])
            for d, data, v in arrays])
        start += b.size


def test_empty_table_and_rejections():
    arrays = _arrays(np.random.default_rng(3), TEST_TABLES_8, 0)
    ref, got = _both(arrays)
    rows = rc.convert_to_rows(got)
    assert len(rows) == 1 and rows[0].size == 0
    assert rc.convert_from_rows(rows[0], got.schema()).num_rows == 0
    lst = Column.list_of_int8(torch.zeros(4, dtype=torch.int8),
                              torch.tensor([0, 2, 4], dtype=torch.int32))
    with pytest.raises(CudfLikeError):
        rc.convert_to_rows(Table([lst]))
    arrays = _arrays(np.random.default_rng(4), TEST_TABLES_8, 10)
    _, got = _both(arrays)
    rows = rc.convert_to_rows(got)
    with pytest.raises(CudfLikeError, match="layout"):
        rc.convert_from_rows(rows[0], got.schema()[:-1])
    with pytest.raises(CudfLikeError, match="list"):
        rc.convert_from_rows(got.columns[0], got.schema())


@pytest.mark.parametrize("schema", [TEST_TABLES_8,
                                    TEST_TABLES_8 + [(TypeId.STRING, 0)]],
                         ids=["fixed", "string"])
def test_one_row_batch_decodes_to_dense_columns(schema):
    # a one-row batch's decoded columns are packed copies: a strided
    # one-row view keeps its stride through ``contiguous``, and byte
    # views of it (hashing, packing rows again) refuse it
    from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
    arrays = _arrays(np.random.default_rng(1), schema, 1, 0.0)
    _, got = _both(arrays)
    rows = rc.convert_to_rows(got)
    back = rc.convert_from_rows(rows[0], got.schema())
    _tables_equal(back, arrays)
    for col in back.columns:
        if col.data is not None:
            assert col.data.stride() == (1,)
            K.as_bytes(col.data)
    assert torch.equal(rc.convert_to_rows(back)[0].child.data,
                       rows[0].child.data)


def _two_batches(monkeypatch, metrics: bool):
    """A 150-row fixed-width table that a lowered cap splits into two
    batches (96 + 54 rows), with the port's switches from the
    environment alone: ``SRT_METRICS`` as given, ``SRT_TRACE_ENABLED``
    off."""
    monkeypatch.setattr(port_config, "_overrides", {})
    monkeypatch.delenv("SRT_TRACE_ENABLED", raising=False)
    if metrics:
        monkeypatch.setenv("SRT_METRICS", "1")
    else:
        monkeypatch.delenv("SRT_METRICS", raising=False)
    _, got = _both(_arrays(np.random.default_rng(21), TEST_TABLES_8, 150))
    monkeypatch.setattr(rc, "SIZE_TYPE_MAX",
                        rc.RowLayout(got.schema()).var_start * 100)
    port_obs.reset_spans()
    return got


def _under(recs, top):
    """``recs`` other than ``top`` all lie inside it, one level down."""
    for r in recs:
        assert r.parent == top.name and r.depth == top.depth + 1, r.name
        assert top.start_ns <= r.start_ns
        assert r.start_ns + r.dur_ns <= top.start_ns + top.dur_ns


def test_conversion_spans_nest_under_the_call(monkeypatch):
    got = _two_batches(monkeypatch, metrics=True)
    rows = rc.convert_to_rows(got)
    assert [b.size for b in rows] == [96, 54]
    recs = port_obs.span_records()
    top = [r for r in recs if r.name == "row_conversion.convert_to_rows"]
    assert len(top) == 1 and top[0].depth == 0 and top[0].parent is None
    assert top[0].attrs == {"rows": 150, "columns": 8, "batches": 2,
                            "route": "pack_rows"}
    steps = [r for r in recs if r is not top[0]]
    assert sorted(r.name for r in steps) == sorted(
        f"row_conversion.to_rows.{s}" for s in ("slice", "pack", "offsets")
        for _ in range(2))
    _under(steps, top[0])

    mark = port_obs.span_mark()
    back = rc.convert_from_rows(rows[1], got.schema())
    assert back.num_rows == 54
    recs = port_obs.spans_since(mark)
    top = [r for r in recs if r.name == "row_conversion.convert_from_rows"]
    assert len(top) == 1
    assert top[0].attrs == {"rows": 54, "columns": 8,
                            "route": "fixed_width"}
    steps = [r for r in recs if r is not top[0]]
    assert sorted(r.name for r in steps) == [
        "row_conversion.from_rows.decode",
        "row_conversion.from_rows.validity"]
    _under(steps, top[0])


def test_conversion_with_both_switches_off_builds_no_span(monkeypatch):
    built = []
    init = port_spans._SpanCtx.__init__

    def counting_init(self, name, attrs):
        built.append(name)
        init(self, name, attrs)

    monkeypatch.setattr(port_spans._SpanCtx, "__init__", counting_init)
    got = _two_batches(monkeypatch, metrics=False)
    for b in rc.convert_to_rows(got):
        rc.convert_from_rows(b, got.schema())
    assert built == [] and port_obs.span_records() == []
    # the count sees every span once a switch is on: 1 + 3 a batch to
    # rows, 3 a batch back
    monkeypatch.setenv("SRT_METRICS", "1")
    for b in rc.convert_to_rows(got):
        rc.convert_from_rows(b, got.schema())
    assert len(built) == 7 + 2 * 3 == len(port_obs.span_records())
