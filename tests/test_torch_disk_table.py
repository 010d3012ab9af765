"""Disk-backed morsel streaming of the PyTorch/CUDA port, against the JAX
package, on the same pyarrow-written Parquet files.

It mirrors ``tests/test_disk_table.py``'s single-device cases: the row-group
helpers (``read_parquet`` byte-equal with ``pq.read_table`` and with the
reference, projection inside the read, footer stats), chunk windows
byte-equal with a host table and with the reference's table, ingest tokens
equal to the reference's, q1/q3/q9 streamed from disk equal to the
reference's streamed and in-core results, the prefetcher's bounds and clean
shutdown, the ``disk`` fault seam retried bit-exact, the zone-map matrix
(all-skip reads nothing, none-skip, partial skip byte-equal with skipping
off, NaN degradation, all-NULL groups, the stale-footer backstop) with the
reference's counters, and ``append_file`` with and without dictionary
growth.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import obs as ref_obs
from spark_rapids_jni_tpu.exec import ParquetHostTable as RefParquet
from spark_rapids_jni_tpu.exec import \
    reset_standing_state as ref_reset_standing
from spark_rapids_jni_tpu.io.parquet import \
    read_parquet as ref_read_parquet
from spark_rapids_jni_tpu.io.parquet import \
    row_group_stats as ref_row_group_stats
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df
from spark_rapids_jni_tpu.tpcds.rel import run_fused as ref_run_fused

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.exec import (HostTable, ParquetHostTable,
                                             reset_standing_state)
from spark_rapids_jni_tpu_torch.exec.runner import run_morsels
from spark_rapids_jni_tpu_torch.io import from_arrow
from spark_rapids_jni_tpu_torch.io.parquet import (open_parquet,
                                                   read_parquet,
                                                   read_row_group,
                                                   row_group_stats)
from spark_rapids_jni_tpu_torch.tpcds import PLANS
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
from spark_rapids_jni_tpu_torch.utils import faults

from test_torch_morsel import compare

CPU = torch.device("cpu")
FACTS = ("store_sales", "web_sales", "catalog_sales", "store_returns")


def _write(df: pd.DataFrame, path, rows_per_group: int) -> str:
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                   str(path), row_group_size=rows_per_group)
    return str(path)


@pytest.fixture(scope="module")
def data():
    return ref_generate(sf=0.1, seed=42)


@pytest.fixture(scope="module")
def rels(data):
    return {k: rel_from_df(v, device=CPU) for k, v in data.items()}


@pytest.fixture(scope="module")
def ref_rels(data):
    return {k: ref_rel_from_df(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def fact_paths(data, tmp_path_factory):
    d = tmp_path_factory.mktemp("facts")
    return {f: _write(data[f], d / f"{f}.parquet",
                      max(64, len(data[f]) // 8)) for f in FACTS}


@pytest.fixture
def disk_rels(rels, fact_paths):
    out, tables = dict(rels), []
    for f in FACTS:
        out[f] = ParquetHostTable(fact_paths[f])
        tables.append(out[f])
    yield out
    for t in tables:
        t.close()


# --------------------------------------------------------------------------
# 1. io/parquet.py helpers
# --------------------------------------------------------------------------

def test_read_parquet_byte_equal(fact_paths):
    path = fact_paths["store_sales"]
    got = read_parquet(path, device=CPU)
    whole = from_arrow(pq.read_table(path), device=CPU)
    ref = ref_read_parquet(path)
    assert got.num_rows == whole.num_rows == ref.num_rows
    for a, b, r in zip(got.columns, whole.columns, ref.columns):
        assert a.data.numpy().tobytes() == b.data.numpy().tobytes()
        assert a.data.numpy().tobytes() == np.asarray(r.data).tobytes()


def test_read_row_group_projects_and_counts(fact_paths, monkeypatch):
    monkeypatch.setenv("SRT_METRICS", "1")  # histograms record only then
    pf = open_parquet(fact_paths["store_sales"])
    full = pf.read_row_group(0)
    hist = obs.REGISTRY.histogram("io.disk.read_ns")
    seen = hist.snapshot()["count"]
    before = obs.kernel_stats()
    got = read_row_group(pf, 0, columns=["ss_item_sk", "ss_quantity"])
    d = obs.stats_since(before)
    assert got.column_names == ["ss_item_sk", "ss_quantity"]
    np.testing.assert_array_equal(got.column("ss_item_sk").to_numpy(),
                                  full.column("ss_item_sk").to_numpy())
    assert d.get("io.disk.groups_read") == 1
    assert d.get("io.disk.bytes_read", 0) > 0
    assert hist.snapshot()["count"] == seen + 1


def test_row_group_stats_match_reference(tmp_path):
    df = pd.DataFrame({"k": np.arange(100, dtype=np.int64),
                       "s": [f"v{i % 7}" for i in range(100)],
                       "n": pd.array([None] * 32 + list(range(68)),
                                     dtype="Int64")})
    path = _write(df, tmp_path / "t.parquet", 32)
    pf = open_parquet(path)
    for g in range(pf.metadata.num_row_groups):
        assert row_group_stats(pf, g) == ref_row_group_stats(pf, g)


# --------------------------------------------------------------------------
# 2. row groups as morsels: chunk windows and tokens
# --------------------------------------------------------------------------

def test_chunk_arrays_match_host_table_and_reference(tmp_path):
    rng = np.random.default_rng(7)
    df = pd.DataFrame({
        "k": rng.integers(0, 50, 500).astype(np.int64),
        "v": rng.normal(size=500),
        "s": [f"cat{int(i)}" for i in rng.integers(0, 9, 500)],
    })
    path = _write(df, tmp_path / "t.parquet", 128)
    disk, ref, ram = ParquetHostTable(path), RefParquet(path), \
        HostTable.from_df(df)
    dsnap, fsnap, rsnap = disk.snapshot(), ref.snapshot(), ram.snapshot()
    assert disk.snapshot_rows(dsnap) == ram.snapshot_rows(rsnap) == 500
    assert disk.batch_tokens() == ref.batch_tokens()
    assert len(disk.batch_tokens()) == 1
    for name in disk.names:
        assert dsnap[1][name].value_range == fsnap[1][name].value_range
    for base, live, cap in ((0, 64, 64), (100, 128, 128),
                            (120, 200, 256), (384, 116, 128),
                            (500, 0, 64)):
        d = disk.chunk_arrays(dsnap[1], base, live, cap)
        f = ref.chunk_arrays(fsnap[1], base, live, cap)
        r = ram.chunk_arrays(rsnap[1], base, live, cap)
        for a, b, c in zip(d, f, r):
            assert a.tobytes() == b.tobytes() == c.tobytes()
        for a, b in zip(disk.chunk_views(dsnap[1], base, live), d):
            assert a.tobytes() == b[:live].tobytes()
    disk.close()
    ref.close()


# --------------------------------------------------------------------------
# 3. streamed from disk == the reference's streamed and in-core runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["q1", "q3", "q9"])
def test_disk_streamed_matches_reference(qname, disk_rels, rels, ref_rels,
                                         fact_paths):
    before = obs.kernel_stats()
    info = {}
    got = run_morsels(PLANS[qname], disk_rels, info, morsels=4,
                      device=CPU).to_df()
    d = obs.stats_since(before)
    assert d.get("rel.morsel_fallbacks", 0) == 0, d
    assert d.get("io.disk.groups_read", 0) > 0
    assert info["io"]["groups_read"] > 0
    compare(got, run_fused(PLANS[qname], rels, device=CPU).to_df(), qname)
    ref_disk = dict(ref_rels)
    tabs = [RefParquet(fact_paths[f]) for f in FACTS]
    ref_disk.update(zip(FACTS, tabs))
    try:
        want = ref_run_fused(getattr(RQ, f"_{qname}"), ref_disk,
                             morsels=4).to_df()
    finally:
        for t in tabs:
            t.close()
    compare(got, want, f"{qname} vs reference", 1e-12, 0)


# --------------------------------------------------------------------------
# 4. the prefetcher
# --------------------------------------------------------------------------

def test_prefetch_bounded_and_overlapping(tmp_path):
    df = pd.DataFrame({"k": np.arange(2048, dtype=np.int64),
                       "v": np.arange(2048, dtype=np.float64)})
    path = _write(df, tmp_path / "t.parquet", 128)  # 16 groups
    t = ParquetHostTable(path, prefetch_depth=2)
    snap = t.snapshot()
    for base in range(0, 2048, 128):
        t.chunk_arrays(snap[1], base, 128, 128)
        st = t.io_stats()
        assert st["cached_groups"] <= 2 + 2
        assert st["queued_reads"] <= 2 + 1
    st = t.io_stats()
    assert st["groups_read"] == 16  # each group decoded once
    assert st["prefetch_hits"] > 0
    assert st["prefetch_hits"] + st["prefetch_misses"] == 16
    t.close()


def test_prefetch_clean_shutdown_midstream_and_restart(tmp_path):
    df = pd.DataFrame({"k": np.arange(1024, dtype=np.int64)})
    path = _write(df, tmp_path / "t.parquet", 128)
    t = ParquetHostTable(path)
    snap = t.snapshot()
    a0 = t.chunk_arrays(snap[1], 0, 128, 128)
    t.close()
    t.close()  # idempotent
    assert not t._prefetch._thread.is_alive()
    a1 = t.chunk_arrays(snap[1], 0, 128, 128)  # the reader restarts
    for x, y in zip(a0, a1):
        np.testing.assert_array_equal(x, y)
    t.close()


def test_disk_fault_seam_retried_bitexact(tmp_path):
    df = pd.DataFrame({"k": np.arange(256, dtype=np.int64)})
    path = _write(df, tmp_path / "t.parquet", 64)
    t = ParquetHostTable(path)
    clean = t.chunk_arrays(t.snapshot()[1], 0, 64, 64)
    t.close()
    t2 = ParquetHostTable(path)
    faults.configure("disk:raise:1")
    try:
        before = obs.kernel_stats()
        retried = t2.chunk_arrays(t2.snapshot()[1], 0, 64, 64)
        d = obs.stats_since(before)
    finally:
        faults.reset()
    assert d.get("io.disk.retries", 0) >= 1
    assert t2.io_stats()["retries"] >= 1
    for x, y in zip(clean, retried):
        np.testing.assert_array_equal(x, y)
    t2.close()


# --------------------------------------------------------------------------
# 5. zone maps, against the reference's counters and answers
# --------------------------------------------------------------------------

def _zones_frame() -> pd.DataFrame:
    # 4 groups x 64 rows, disjoint k ranges: footer min/max are selective
    k = np.concatenate([np.arange(gi * 1000, gi * 1000 + 64)
                        for gi in range(4)]).astype(np.int64)
    return pd.DataFrame({"k": k, "v": np.arange(256, dtype=np.int64),
                         "g": np.zeros(256, dtype=np.int64)})


def _sum_plan(t):
    return t["tbl"].groupby(["g"], [("v", "sum", "total")])


def _both(path, filters, morsels, poison=None):
    """(port result, port counters, reference result, its counters) of
    the sum plan over the filtered view of ``path``."""
    out = []
    for cls, run, stats, reset in (
            (ParquetHostTable, lambda p, r: run_fused(p, r, morsels=morsels,
                                                      device=CPU),
             obs, reset_standing_state),
            (RefParquet, lambda p, r: ref_run_fused(p, r, morsels=morsels),
             ref_obs, ref_reset_standing)):
        reset()
        before = stats.kernel_stats()
        t = cls(path, filters=filters)
        if poison is not None:
            poison(t)
        try:
            got = run(_sum_plan, {"tbl": t}).to_df()
        finally:
            t.close()
        out += [got, stats.stats_since(before)]
    return out


ZONE_KEYS = ("exec.morsel.zonemap_skipped", "exec.morsel.zonemap_untrusted",
             "io.disk.groups_read", "io.disk.stale_stats",
             "rel.morsel_fallbacks")


def _same_counters(d, rd):
    for key in ZONE_KEYS:
        assert d.get(key, 0) == rd.get(key, 0), (key, d, rd)


def test_zonemap_all_skip_reads_nothing(tmp_path):
    path = _write(_zones_frame(), tmp_path / "t.parquet", 64)
    got, d, want, rd = _both(path, [("k", "ge", 10_000)], 4)
    assert d.get("exec.morsel.zonemap_skipped", 0) == 4
    assert d.get("io.disk.groups_read", 0) == 0
    assert len(got) == 0
    compare(got, want, "all skip", 0, 0)
    _same_counters(d, rd)


def test_zonemap_none_skip_matches_unfiltered(tmp_path):
    df = _zones_frame()
    path = _write(df, tmp_path / "t.parquet", 64)
    got, d, want, rd = _both(path, [("k", "ge", 0)], 4)
    assert d.get("exec.morsel.zonemap_skipped", 0) == 0
    assert int(got["total"].iloc[0]) == int(df["v"].sum())
    compare(got, want, "none skip", 0, 0)
    _same_counters(d, rd)


def test_zonemap_partial_skip_byte_equal_vs_disabled(tmp_path,
                                                     monkeypatch):
    df = _zones_frame()
    path = _write(df, tmp_path / "t.parquet", 64)
    got, d, want, rd = _both(path, [("k", "between", (2000, 10**6))], 4)
    assert d.get("exec.morsel.zonemap_skipped", 0) == 2
    _same_counters(d, rd)
    compare(got, want, "partial skip vs reference", 0, 0)
    monkeypatch.setenv("SRT_DISK_ZONEMAP", "0")
    unskipped, d0, _, _ = _both(path, [("k", "between", (2000, 10**6))], 4)
    assert d0.get("exec.morsel.zonemap_skipped", 0) == 0
    compare(got, unskipped, "skip vs disabled", 0, 0)
    assert int(got["total"].iloc[0]) == int(
        df.loc[df["k"] >= 2000, "v"].sum())


def test_zonemap_nan_float_degrades_counted(tmp_path):
    v = np.arange(256, dtype=np.float64)
    v[5] = np.nan
    df = pd.DataFrame({"x": v, "v": np.arange(256, dtype=np.int64),
                       "g": np.zeros(256, dtype=np.int64)})
    path = _write(df, tmp_path / "t.parquet", 64)
    got, d, want, rd = _both(path, [("x", "ge", 1e6)], 4)
    assert d.get("exec.morsel.zonemap_skipped", 0) == 0
    assert d.get("exec.morsel.zonemap_untrusted", 0) == 4
    assert len(got) == 0
    compare(got, want, "nan", 0, 0)
    _same_counters(d, rd)


def test_zonemap_all_null_group_skips(tmp_path):
    k = pd.array([float(i) for i in range(64)] + [None] * 64,
                 dtype="Int64")
    df = pd.DataFrame({"k": k, "v": np.arange(128, dtype=np.int64),
                       "g": np.zeros(128, dtype=np.int64)})
    path = _write(df, tmp_path / "t.parquet", 64)
    got, d, want, rd = _both(path, [("k", "ge", 0)], 2)
    assert d.get("exec.morsel.zonemap_skipped", 0) == 1
    assert int(got["total"].iloc[0]) == int(df["v"][:64].sum())
    compare(got, want, "all null", 0, 0)
    _same_counters(d, rd)


def test_stale_footer_backstop_falls_back_incore(tmp_path):
    df = _zones_frame()
    path = _write(df, tmp_path / "t.parquet", 64)

    def poison(t):
        # the footer now claims k <= 5 on a group that will be decoded
        with t._lock:
            t._state.groups[0].stats["k"] = ("int", 0, 5)

    got, d, want, rd = _both(path, [("k", "ge", 0)], 4, poison=poison)
    assert d.get("io.disk.stale_stats", 0) >= 1
    assert d.get("rel.morsel_fallbacks", 0) == 1
    assert int(got["total"].iloc[0]) == int(df["v"].sum())
    compare(got, want, "stale footer", 0, 0)
    assert d.get("io.disk.stale_stats", 0) == rd.get("io.disk.stale_stats")
    assert rd.get("rel.morsel_fallbacks", 0) == 1


# --------------------------------------------------------------------------
# 6. append_file
# --------------------------------------------------------------------------

def test_append_file_folds_only_the_delta(tmp_path, monkeypatch):
    monkeypatch.setenv("SRT_MORSEL_BYTES", "8192")
    reset_standing_state()
    rng = np.random.default_rng(3)

    def mk(n):
        return pd.DataFrame({
            "k": rng.integers(0, 20, n).astype(np.int64),
            "v": rng.integers(0, 1000, n).astype(np.int64),
            "s": [f"c{int(i)}" for i in rng.integers(0, 5, n)]})

    df1, df2 = mk(512), mk(256)
    p1 = _write(df1, tmp_path / "a.parquet", 128)
    p2 = _write(df2, tmp_path / "b.parquet", 128)

    def _plan(t):
        return t["tbl"].groupby(["k"], [("v", "sum", "total")]).sort(["k"])

    t, ref = ParquetHostTable(p1), RefParquet(p1)
    run_fused(_plan, {"tbl": t}, device=CPU).to_df()  # standing state
    t.append_file(p2)
    ref.append_file(p2)
    assert t.batch_tokens() == ref.batch_tokens()
    before = obs.kernel_stats()
    info = {}
    got = run_morsels(_plan, {"tbl": t}, info, device=CPU).to_df()
    d = obs.stats_since(before)
    assert info.get("provenance") == "delta"
    assert d.get("rel.morsel_delta_reuse") == 1
    assert info["morsel"]["folded_rows"]["tbl"] == 512
    full = pd.concat([df1, df2]).reset_index(drop=True)
    compare(got, ref_run_fused(_plan, {"tbl": ref_rel_from_df(full)})
            .to_df(), "append delta", 0, 0)
    t.close()
    ref.close()


def test_append_file_dict_growth_rebuilds(tmp_path):
    df1 = pd.DataFrame({"k": np.arange(128, dtype=np.int64),
                        "s": ["a", "b"] * 64})
    df2 = pd.DataFrame({"k": np.arange(128, 192, dtype=np.int64),
                        "s": ["zz"] * 64})  # a new category
    p1 = _write(df1, tmp_path / "a.parquet", 64)
    p2 = _write(df2, tmp_path / "b.parquet", 64)
    t, ref = ParquetHostTable(p1), RefParquet(p1)
    tok1 = t.batch_tokens()
    before = obs.kernel_stats()
    t.append_file(p2)
    ref.append_file(p2)
    assert obs.stats_since(before).get("rel.morsel_dict_rebuilds") == 1
    tok2 = t.batch_tokens()
    assert tok2 == ref.batch_tokens()
    assert len(tok2) == 2 and tok2[0] != tok1[0]

    def _plan(tt):
        return tt["tbl"].groupby(["s"], [("k", "sum", "total")]).sort(["s"])

    got = run_fused(_plan, {"tbl": t}, morsels=2, device=CPU).to_df()
    full = pd.concat([df1, df2]).reset_index(drop=True)
    compare(got, ref_run_fused(_plan, {"tbl": ref_rel_from_df(full)})
            .to_df(), "dict growth append", 0, 0)
    t.close()
    ref.close()
