"""Nested (STRUCT / LIST / STRING) rows of the PyTorch/CUDA port against
the JAX package on the same numpy inputs (on the CPU): the layout, the
row bytes of ``convert_to_rows_nested`` and the columns that
``convert_from_rows_nested`` gives back, all byte-equal (float NaN
payloads included), with nulls at every node of the schema tree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as ref_types
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.columnar import bitmask as ref_bitmask
from spark_rapids_jni_tpu.ops import nested_rows as ref_nested

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.ops import nested_rows, row_conversion
from spark_rapids_jni_tpu_torch.tpcds.carry import table_from_arrays

CPU = torch.device("cpu")
TID = T.TypeId
# TestTables.java's eight types
FLAT = [(TID.INT64, 0), (TID.FLOAT64, 0), (TID.INT32, 0), (TID.BOOL8, 0),
        (TID.FLOAT32, 0), (TID.INT8, 0), (TID.DECIMAL32, -3),
        (TID.DECIMAL64, -8)]
STRUCT, LIST, STRING = ((int(TID.STRUCT), 0), (int(TID.LIST), 0),
                        (int(TID.STRING), 0))


def _ref_column(dt, data, valid):
    """The reference's column of one ``table_from_arrays`` entry."""
    tid = ref_types.TypeId(int(dt[0]))
    if tid == ref_types.TypeId.STRUCT:
        dts, datas, valids, *names = data
        return RefColumn.struct_from_children(
            [_ref_column(*x) for x in zip(dts, datas, valids)], valid,
            names[0] if names else None)
    words = (None if valid is None or np.all(valid)
             else ref_bitmask.pack(jnp.asarray(valid)))
    if tid == ref_types.TypeId.STRING:
        offs, chars = data
        return RefColumn(ref_types.STRING, len(offs) - 1, None, words,
                         children=(RefColumn(ref_types.INT32, len(offs),
                                             jnp.asarray(offs)),
                                   RefColumn(ref_types.UINT8, len(chars),
                                             jnp.asarray(chars))))
    if tid == ref_types.TypeId.LIST:
        offs, elems, edt = data
        elem = RefColumn.from_numpy(elems, None, ref_types.DType.from_ids(
            int(edt[0]), int(edt[1])))
        return RefColumn(ref_types.LIST, len(offs) - 1, None, words,
                         children=(RefColumn(ref_types.INT32, len(offs),
                                             jnp.asarray(offs)), elem))
    return RefColumn.from_numpy(data, valid, ref_types.DType.from_ids(
        int(dt[0]), int(dt[1])))


def _values(rng, tid, n):
    if tid in (TID.FLOAT64, TID.FLOAT32):
        ft = np.float64 if tid == TID.FLOAT64 else np.float32
        x = rng.standard_normal(n).astype(ft)
        ints = x.view(np.int64 if ft == np.float64 else np.int32)
        pats = ([0x7FF8000000000001, -0x7FFFFFFFFFFFF, -2**63,
                 0x7FF0000000000000] if ft == np.float64 else
                [0x7FC00001, -0x3FFFFF, -2**31, 0x7F800000])
        ints[::7] = np.array(pats * n, ints.dtype)[:ints[::7].size]
        return x
    if tid == TID.BOOL8:
        return rng.integers(0, 2, n).astype(np.int8)
    st = T.DType(tid, -3 if tid == TID.DECIMAL32 else
                 -8 if tid == TID.DECIMAL64 else 0).storage_dtype
    info = np.iinfo(st)
    return rng.integers(info.min, info.max, n, dtype=st, endpoint=True)


def _valid(rng, n, share):
    return rng.random(n) >= share


def _string(rng, n, share):
    lens = rng.integers(0, 33, n)
    valid = _valid(rng, n, share)
    lens[~valid & (rng.random(n) < 0.5)] = 0
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    chars = rng.integers(0x61, 0x7B, int(offs[-1])).astype(np.uint8)
    return (offs, chars), valid


def _list(rng, n, share, etid=TID.INT64, max_len=8):
    lens = rng.integers(0, max_len + 1, n)
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    return (offs, _values(rng, etid, int(offs[-1])), (int(etid), 0)), \
        _valid(rng, n, share)


def roster_schema(rng, n, share=0.01):
    """The roster's nested-rows table as ``table_from_arrays`` entries:
    the eight TestTables types, STRUCT<INT32, FLOAT64, STRING 0-32 B>,
    LIST<INT64> of 0-8 elements and a STRUCT nesting a STRUCT, nulls at
    every node (``share`` each)."""
    dtypes, datas, valids = [], [], []
    for tid, scale in FLAT:
        dtypes.append((int(tid), scale))
        datas.append(_values(rng, tid, n))
        valids.append(_valid(rng, n, share))
    s, sv = _string(rng, n, share)
    dtypes.append(STRUCT)
    datas.append(([(int(TID.INT32), 0), (int(TID.FLOAT64), 0), STRING],
                  [_values(rng, TID.INT32, n), _values(rng, TID.FLOAT64, n),
                   s], [_valid(rng, n, share), _valid(rng, n, share), sv],
                  ("i", "f", "s")))
    valids.append(_valid(rng, n, share))
    lst, lv = _list(rng, n, share)
    dtypes.append(LIST)
    datas.append(lst)
    valids.append(lv)
    inner = ([(int(TID.INT16), 0), (int(TID.DECIMAL64), -2)],
             [_values(rng, TID.INT16, n), _values(rng, TID.DECIMAL64, n)],
             [_valid(rng, n, share), _valid(rng, n, share)])
    dtypes.append(STRUCT)
    datas.append(([STRUCT, (int(TID.INT64), 0)],
                  [inner, _values(rng, TID.INT64, n)],
                  [_valid(rng, n, share), _valid(rng, n, share)]))
    valids.append(_valid(rng, n, share))
    return dtypes, datas, valids


def _both(dtypes, datas, valids):
    ref = RefTable([_ref_column(*x) for x in zip(dtypes, datas, valids)])
    return ref, table_from_arrays(dtypes, datas, valids, device=CPU)


def _same_column(got, want):
    """Every node's validity, every fixed-width leaf's bytes (all rows:
    both decode the same row bytes) and every variable-width leaf's
    offsets and element bytes equal."""
    assert int(got.dtype.id) == int(want.dtype.id)
    np.testing.assert_array_equal(got.valid_bool().numpy(),
                                  np.asarray(want.valid_bool()))
    assert len(got.children) == len(want.children)
    if got.dtype.id == TID.STRUCT:
        assert got.field_names == want.field_names
    if got.data is not None:
        np.testing.assert_array_equal(
            got.data.numpy().view(np.uint8),
            np.ascontiguousarray(np.asarray(want.data)).view(np.uint8))
    for g, w in zip(got.children, want.children):
        _same_column(g, w)


def _pylist(col):
    """Host values with floats as their bit patterns (NaN payloads)."""
    ok = col.valid_bool().numpy()
    if col.dtype.id in (TID.FLOAT64, TID.FLOAT32):
        it = np.int64 if col.dtype.id == TID.FLOAT64 else np.int32
        vals = col.to_numpy()[0].view(it)
        return [int(v) if o else None for v, o in zip(vals, ok)]
    if col.dtype.id == TID.STRUCT:
        fields = [_pylist(c) for c in col.children]
        return [tuple(f[i] for f in fields) if o else None
                for i, o in enumerate(ok)]
    if col.dtype.id == TID.LIST:
        offs, elems = col.offsets.data.numpy(), _pylist(col.child)
        return [elems[offs[i]:offs[i + 1]] if o else None
                for i, o in enumerate(ok)]
    return col.to_pylist()


LIST_ELEMS = [(TID.INT32, 0), (TID.FLOAT64, 0), (TID.INT8, 0),
              (TID.BOOL8, 0), (TID.DECIMAL64, -2)]
N_ROWS, NULL_SHARE = 257, 0.2


def _table_arrays(rng, n, share):
    """The roster schema plus a LIST of each element width."""
    dtypes, datas, valids = roster_schema(rng, n, share)
    for tid, scale in LIST_ELEMS:
        (offs, elems, _), lv = _list(rng, n, share, tid, max_len=5)
        dtypes.append(LIST)
        datas.append((offs, elems, (int(tid), scale)))
        valids.append(lv)
    return dtypes, datas, valids


@pytest.fixture(scope="module")
def case():
    """One table through both packages (the reference compiles for each
    shape, about ten seconds, so every test here shares it)."""
    ref, got = _both(*_table_arrays(np.random.default_rng(6), N_ROWS,
                                    NULL_SHARE))
    tree = nested_rows.type_tree(got)
    rows = nested_rows.convert_to_rows_nested(got)
    ref_rows = ref_nested.convert_to_rows_nested(ref)
    return dict(ref=ref, got=got, tree=tree, rows=rows, ref_rows=ref_rows,
                back=nested_rows.convert_from_rows_nested(rows, tree),
                ref_back=ref_nested.convert_from_rows_nested(
                    ref_rows, ref_nested.type_tree(ref)))


N_COLUMNS = len(FLAT) + 3 + len(LIST_ELEMS)


def test_layout_equals_reference(case):
    lay = nested_rows.NestedRowLayout(case["tree"])
    ref_lay = ref_nested.NestedRowLayout(ref_nested.type_tree(case["ref"]))
    assert (lay.slot_starts, lay.leaf_kinds, lay.n_nodes,
            lay.validity_offset, lay.validity_bytes, lay.var_start) == (
        ref_lay.slot_starts, ref_lay.leaf_kinds, ref_lay.n_nodes,
        ref_lay.validity_offset, ref_lay.validity_bytes, ref_lay.var_start)
    assert lay.n_nodes % 8 != 0  # the validity bytes end mid-byte


def test_row_bytes_equal_reference(case):
    rows, want = case["rows"], case["ref_rows"]
    assert rows.size == N_ROWS
    np.testing.assert_array_equal(rows.offsets.data.numpy(),
                                  np.asarray(want.offsets.data))
    np.testing.assert_array_equal(rows.child.data.numpy(),
                                  np.asarray(want.child.data))


@pytest.mark.parametrize("ci", range(N_COLUMNS))
def test_decoded_column_equals_reference(case, ci):
    _same_column(case["back"].columns[ci], case["ref_back"].columns[ci])


@pytest.mark.parametrize("ci", range(N_COLUMNS))
def test_round_trip_keeps_every_value(case, ci):
    assert _pylist(case["back"].columns[ci]) == \
        _pylist(case["got"].columns[ci])


@pytest.mark.parametrize("n", [0, 1, 33])
def test_round_trip_small_tables(n):
    _, got = _both(*_table_arrays(np.random.default_rng(n), n, 0.5))
    back = nested_rows.convert_from_rows_nested(
        nested_rows.convert_to_rows_nested(got), nested_rows.type_tree(got))
    assert back.num_rows == n
    for g, w in zip(back.columns, got.columns):
        assert _pylist(g) == _pylist(w)


def test_flat_schema_bytes_equal_the_string_row_format():
    """A schema without nested columns gives the bytes of the row
    format's STRING layout (``row_conversion.convert_to_rows``)."""
    rng = np.random.default_rng(4)
    n = 200
    s, sv = _string(rng, n, 0.1)
    dtypes = [(int(TID.INT64), 0), STRING, (int(TID.FLOAT64), 0)]
    datas = [_values(rng, TID.INT64, n), s, _values(rng, TID.FLOAT64, n)]
    valids = [_valid(rng, n, 0.1), sv, None]
    t = table_from_arrays(dtypes, datas, valids, device=CPU)
    old = row_conversion.convert_to_rows(t)[0]
    new = nested_rows.convert_to_rows_nested(t)
    assert torch.equal(old.offsets.data, new.offsets.data)
    assert torch.equal(old.child.data, new.child.data)


def test_layout_walks_struct_nodes():
    t = table_from_arrays(
        [STRUCT], [([(int(TID.INT64), 0), STRING],
                    [np.zeros(2, np.int64),
                     (np.array([0, 1, 2], np.int32),
                      np.array([97, 98], np.uint8))], [None, None])],
        [None], device=CPU)
    lay = nested_rows.NestedRowLayout(nested_rows.type_tree(t))
    assert lay.n_nodes == 3 and lay.leaf_kinds == ["fixed", "var"]


def test_decode_takes_every_node_validity_from_k3_table_form(monkeypatch):
    """The decode reads all nodes' validity with one call of K3's table
    form, on the rows' validity bytes in place (a strided view)."""
    from spark_rapids_jni_tpu_torch.columnar import bitmask
    calls = []
    real = bitmask.pack_fields

    def spy(vbytes, n_fields):
        calls.append((tuple(vbytes.shape), vbytes.stride(), n_fields))
        return real(vbytes, n_fields)
    monkeypatch.setattr(bitmask, "pack_fields", spy)
    rng = np.random.default_rng(5)
    _, got = _both(*roster_schema(rng, 40, 0.2))
    lay = nested_rows.NestedRowLayout(nested_rows.type_tree(got))
    nested_rows.convert_from_rows_nested(
        nested_rows.convert_to_rows_nested(got), nested_rows.type_tree(got))
    assert calls == [((40, lay.validity_bytes), (lay.var_start, 1),
                      lay.n_nodes)]
