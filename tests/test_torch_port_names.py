"""The reference's small public names that the port lacked, each held
against the reference on the same seeded numpy inputs:

- ``columnar/bitmask``: ``count_unset`` and ``all_valid_words``;
- ``Column.from_numpy_batch`` (one host-to-device copy for many columns);
- ``RowLayout.fixed_size_per_row``;
- ``HostTable.chunk_page_arrays`` and ``ParquetHostTable.chunk_page_arrays``;
- ``ops/keys``: ``key_lanes`` (the reference's uint32 lanes, as int64
  tensors) and ``string_pad_widths``;
- ``obs.report.reset_ra_tasks``, called by ``obs.reset_all``;
- ``utils/errors.null_check`` and ``utils/floatbits.bits_to_float64``;
- ``tpcds/data``: ``ingest``, ``as_table`` and ``as_sharded_table`` (the
  last on a gloo group of 2 ranks, in subprocesses);
- ``tpcds/oplib/registry.registry_revision``, part of
  ``tpcds/rel.planner_env_key``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spark_rapids_jni_tpu as srt
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.columnar import bitmask as ref_bitmask
from spark_rapids_jni_tpu.exec import HostTable as RefHostTable
from spark_rapids_jni_tpu.exec import ParquetHostTable as RefParquet
from spark_rapids_jni_tpu.ops import keys as ref_keys
from spark_rapids_jni_tpu.ops.row_conversion import RowLayout as RefRowLayout
from spark_rapids_jni_tpu.tpcds import data as ref_data
from spark_rapids_jni_tpu.utils import errors as ref_errors
from spark_rapids_jni_tpu.utils import floatbits as ref_floatbits

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table, bitmask
from spark_rapids_jni_tpu_torch.exec import HostTable, ParquetHostTable
from spark_rapids_jni_tpu_torch.obs import report
from spark_rapids_jni_tpu_torch.ops import keys
from spark_rapids_jni_tpu_torch.ops.row_conversion import RowLayout
from spark_rapids_jni_tpu_torch.tpcds import data, generate
from spark_rapids_jni_tpu_torch.tpcds.oplib import registry
from spark_rapids_jni_tpu_torch.tpcds.rel import planner_env_key
from spark_rapids_jni_tpu_torch.utils import errors, floatbits

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 100, 1000])
def test_bitmask_count_unset_and_all_valid_words(n):
    valid = np.random.default_rng(n).random(n) > 0.3
    words = bitmask.pack_host(valid)
    got = bitmask.count_unset(torch.from_numpy(words), n)
    assert got.dtype == torch.int32
    assert int(got) == int(ref_bitmask.count_unset(jnp.asarray(words), n)) \
        == int((~valid).sum())
    np.testing.assert_array_equal(bitmask.all_valid_words(n),
                                  ref_bitmask.all_valid_words(n))


def test_from_numpy_batch_equals_reference():
    rng = np.random.default_rng(3)
    arrays = [rng.integers(-50, 50, 100), rng.random(7).astype(np.float32),
              rng.integers(0, 9, 33).astype(np.int32),
              rng.random(5) > 0.5, np.arange(3, dtype=np.uint16),
              np.zeros(0, np.int64)]
    got = Column.from_numpy_batch(arrays, device=CPU)
    want = RefColumn.from_numpy_batch(arrays)
    for g, w, a in zip(got, want, arrays):
        assert (g.dtype.id.value, g.size) == (w.dtype.id.value, w.size)
        assert (g.value_range, g.unique) == (w.value_range, w.unique)
        assert g.validity is None
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        assert g.data.data_ptr() % 64 == got[0].data.data_ptr() % 64


@pytest.mark.parametrize("schema", [
    (T.INT64,), (T.INT8, T.INT64, T.INT32), (T.BOOL8,) * 9,
    (T.FLOAT32, T.INT16, T.decimal64(-2), T.decimal128(-3)),
    (T.INT32, T.STRING, T.INT8),
], ids=["one", "mixed", "nine_bytes", "decimals", "string"])
def test_fixed_size_per_row_equals_reference(schema):
    ref_schema = [srt.types.DType(srt.types.TypeId(int(dt.id)), dt.scale)
                  for dt in schema]
    assert RowLayout(schema).fixed_size_per_row == \
        RefRowLayout(ref_schema).fixed_size_per_row


def _frame(n: int, seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"a": rng.integers(0, 1 << 40, n),
                         "b": rng.random(n),
                         "c": rng.integers(-9, 9, n).astype(np.int32)})


def _pages_equal(got, want):
    assert len(got) == len(want)
    for (gp, gn, gr, gd, gt), (wp, wn, wr, wd, wt) in zip(got, want):
        assert (gn, gr, gd, gt) == (wn, wr, wd, wt)
        assert len(gp) == len(wp)
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("start, live, cap, page_bytes", [
    (0, 1000, 1024, 1024), (512, 300, 512, 4096), (990, 10, 64, 256),
    (0, 0, 128, 1024), (100, 700, 700, 1 << 16)])
def test_host_table_chunk_page_arrays_equal_reference(start, live, cap,
                                                      page_bytes):
    df = _frame(1000)
    mine, ref = HostTable.from_df(df), RefHostTable.from_df(df)
    _, mcols, *_ = mine.snapshot()
    _, rcols, *_ = ref.snapshot()
    _pages_equal(mine.chunk_page_arrays(mcols, start, live, cap,
                                        page_bytes),
                 ref.chunk_page_arrays(rcols, start, live, cap, page_bytes))


@pytest.mark.parametrize("start, live, cap, page_bytes", [
    (0, 1500, 2048, 4096), (700, 900, 1024, 1024), (0, 0, 256, 1024)])
def test_parquet_chunk_page_arrays_equal_reference(tmp_path, start, live,
                                                   cap, page_bytes):
    path = str(tmp_path / "t.parquet")
    _frame(1600, 4).to_parquet(path, row_group_size=500, index=False)
    mine, ref = ParquetHostTable(path), RefParquet(path)
    try:
        _, mcols, *_ = mine.snapshot()
        _, rcols, *_ = ref.snapshot()
        _pages_equal(mine.chunk_page_arrays(mcols, start, live, cap,
                                            page_bytes),
                     ref.chunk_page_arrays(rcols, start, live, cap,
                                           page_bytes))
    finally:
        mine.close()
        ref.close()


def _key_columns(rng, n):
    """(port column, reference column) pairs of every lane family."""
    valid = rng.random(n) > 0.2
    f64 = rng.standard_normal(n)
    f64[::9] = -0.0
    f64[1::13] = np.inf
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[::7] = -np.inf
    ints = [rng.integers(-2**62, 2**62, n), rng.integers(-2**31, 2**31, n)
            .astype(np.int32), rng.integers(-128, 128, n).astype(np.int8),
            rng.integers(0, 2**63, n).astype(np.uint64),
            rng.integers(0, 2**32, n).astype(np.uint32), f64, f32]
    out = [(Column.from_numpy(v, valid, device=CPU),
            RefColumn.from_numpy(v, valid)) for v in ints]
    dec = [int(x) for x in rng.integers(-2**62, 2**62, n)]
    dec = [d * (1 << 60) if i % 3 else -d for i, d in enumerate(dec)]
    out.append((Column.decimal128_from_ints(dec, -2, device=CPU),
                RefColumn.decimal128_from_ints(dec, -2)))
    words = ["", "a", "ab\x00", "abc", "zzzzz", "ünï", "b" * 11, None]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    out.append((Column.strings_from_list(strs, device=CPU),
                RefColumn.strings_from_list(strs)))
    kids = out[1], out[5]
    out.append((Column.struct_from_children([k[0] for k in kids]),
                RefColumn.struct_from_children([k[1] for k in kids])))
    return out


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
def test_key_lanes_equal_reference(descending):
    for mine, ref in _key_columns(np.random.default_rng(11), 300):
        got = keys.key_lanes(mine, descending=descending)
        want = ref_keys.key_lanes(ref, descending=descending)
        assert len(got) == len(want), mine.dtype
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(w).astype(np.int64), str(mine.dtype))


def test_string_pad_widths_and_padded_lanes_equal_reference():
    rng = np.random.default_rng(2)
    tabs, refs = [], []
    for n, width in ((50, 3), (40, 17), (30, 0)):
        strs = ["x" * int(k) for k in rng.integers(0, width + 1, n)]
        tabs.append(Table([Column.from_numpy(np.arange(n), device=CPU),
                           Column.strings_from_list(strs, device=CPU)]))
        refs.append(RefTable([RefColumn.from_numpy(np.arange(n)),
                              RefColumn.strings_from_list(strs)]))
    pads = keys.string_pad_widths(tabs)
    assert pads == ref_keys.string_pad_widths(refs) == (24,)
    assert keys.string_pad_widths(tabs[:1] * 2) == \
        ref_keys.string_pad_widths(refs[:1] * 2)
    for t, r in zip(tabs, refs):
        got = keys.key_lanes(t.columns[1], string_pad=pads[0])
        want = ref_keys.key_lanes(r.columns[1], string_pad=pads[0])
        assert len(got) == len(want) == pads[0] // 4 + 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w).astype(np.int64))


def test_reset_all_drops_the_ra_task_ids():
    from spark_rapids_jni_tpu import obs as ref_obs
    from spark_rapids_jni_tpu.obs import report as ref_report
    report.ra_track_task(5)
    ref_report.ra_track_task(5)
    assert list(report._ra_task_ids()) == [5] \
        == list(ref_report._ra_task_ids())
    report.reset_ra_tasks()
    assert report._ra_task_ids() == []
    report.ra_track_task(6)
    obs.reset_all()
    ref_obs.reset_all()
    assert not report._ra_task_ids() and not ref_report._ra_task_ids()


@pytest.mark.parametrize("mod", [errors, ref_errors],
                         ids=["port", "reference"])
def test_null_check(mod):
    mod.null_check(0, "unused")
    with pytest.raises(ValueError, match="table must not be null"):
        mod.null_check(None, "table must not be null")


def test_bits_to_float64_equals_reference():
    rng = np.random.default_rng(8)
    f = np.concatenate([rng.standard_normal(100),
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324]])
    bits = f.view(np.int64)
    for b in (bits, bits.view(np.uint64), bits[:50].astype(np.int32)):
        got = floatbits.bits_to_float64(torch.from_numpy(b.copy()))
        want = np.asarray(ref_floatbits.bits_to_float64(jnp.asarray(b)))
        np.testing.assert_array_equal(got.numpy().view(np.int64),
                                      want.view(np.int64))


def test_ingest_and_as_table_equal_reference():
    frames = generate(sf=0.2, seed=4)
    mine = data.ingest(frames, device=CPU)
    ref = ref_data.ingest(frames)
    assert data.DECIMAL_COLUMNS == ref_data.DECIMAL_COLUMNS
    assert mine.keys() == ref.keys()
    for name in mine:
        assert mine[name].names == ref[name].names
        for g, w in zip(mine[name].table.columns, ref[name].table.columns):
            assert (g.dtype.id.value, g.dtype.scale) == \
                (w.dtype.id.value, w.dtype.scale)
        pd.testing.assert_frame_equal(mine[name].to_df(), ref[name].to_df())
    df = pd.DataFrame({"i": np.arange(5, dtype=np.int32),
                       "f": np.linspace(0, 1, 5),
                       "s": ["a", None, "ccc", "", "é"]})
    got, want = data.as_table(df, device=CPU), ref_data.as_table(df)
    for g, w in zip(got.columns, want.columns):
        assert g.dtype.id.value == w.dtype.id.value
        assert g.to_pylist() == w.to_pylist()


SHARD_WORKER = textwrap.dedent('''
    import sys
    root, rank, world, init, out = sys.argv[1:6]
    sys.path.insert(0, root)
    import numpy as np
    import pandas as pd
    from spark_rapids_jni_tpu_torch.parallel import distributed, make_mesh
    from spark_rapids_jni_tpu_torch.tpcds.data import as_sharded_table
    distributed.initialize(init, int(world), int(rank), backend="gloo",
                           timeout_s=60)
    mesh = make_mesh({"part": int(world)}, device_type="cpu")
    n = 1001
    df = pd.DataFrame({"a": np.arange(n, dtype=np.int64) * 3,
                       "b": np.linspace(0, 1, n)})
    table, mask = as_sharded_table(df, mesh)
    np.savez(f"{out}/r{rank}.npz", mask=mask.numpy(),
             **{f"c{i}": c.data.numpy() for i, c in enumerate(table.columns)})
    distributed.shutdown()
''')


def test_as_sharded_table_chunks_equal_reference(tmp_path):
    """Each rank of a 2-rank gloo group holds its ``shard_capacity``-row
    chunk: the chunks in rank order are the reference's row-sharded
    global arrays (padding and mask included)."""
    from spark_rapids_jni_tpu.parallel import make_mesh as ref_make_mesh
    script = tmp_path / "worker.py"
    script.write_text(SHARD_WORKER)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    init = f"file://{tmp_path / 'init'}"
    procs = [subprocess.Popen([sys.executable, str(script), str(ROOT),
                               str(r), "2", init, str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    ranks = [np.load(tmp_path / f"r{r}.npz") for r in range(2)]
    n = 1001
    df = pd.DataFrame({"a": np.arange(n, dtype=np.int64) * 3,
                       "b": np.linspace(0, 1, n)})
    table, mask = ref_data.as_sharded_table(df, ref_make_mesh({"part": 2}))
    np.testing.assert_array_equal(
        np.concatenate([r["mask"] for r in ranks]), np.asarray(mask))
    for i, col in enumerate(table.columns):
        np.testing.assert_array_equal(
            np.concatenate([r[f"c{i}"] for r in ranks]),
            np.asarray(col.data))


def test_registry_revision_keys_the_planner(monkeypatch):
    rev = registry.registry_revision()
    assert len(rev) == 16 and int(rev, 16) >= 0
    assert rev in planner_env_key()
    monkeypatch.setattr(registry, "_REVISION", None)
    assert registry.registry_revision() == rev  # a content digest
    spec = next(iter(registry.registered().values()))
    registry.register_operator(spec)  # the same lowering again
    assert registry.registry_revision() == rev
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    registry.register_operator(registry.OperatorSpec(
        name="test_noop", mask_class="rowwise", partition="local",
        lowering=lambda r: r, oracle=lambda df: df))
    changed = registry.registry_revision()
    assert changed != rev and changed in planner_env_key()
    monkeypatch.setattr(registry, "_REVISION", None)
