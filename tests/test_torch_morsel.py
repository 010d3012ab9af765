"""Out-of-core morsel execution of the PyTorch/CUDA port, against the JAX
package.

Both packages stream q1-q10 from host tables built from the same frames
(the reference's ``generate(sf=0.3, seed=42)``, the reference test's
data): the port's streamed result must equal the reference's streamed
result (integers exact, floats ``rtol=1e-12, atol=0``), and each must
equal its own in-core run at the reference test's ``rtol=atol=1e-9``
(``tests/test_morsel_exec.py``). The morsel and route counters must agree
between the packages, and the port keeps its one counted host sync a
query. The host-table encodings, chunk views and ingest tokens, and the
planner's capacities over a grid, are byte-equal to the reference's; the
append/delta, no-op re-run, divergence, dictionary-growth, dispatch-fault
replay, terminal top-k and fallback cases mirror the reference test's.
Everything runs on the CPU (``device="cpu"``), where the pump's staging
buffers are plain host tensors.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_jni_tpu import obs as ref_obs
from spark_rapids_jni_tpu.exec import HostTable as RefHostTable
from spark_rapids_jni_tpu.exec import plan_morsels as ref_plan_morsels
from spark_rapids_jni_tpu.exec import \
    reset_morsel_budget_probe as ref_reset_probe
from spark_rapids_jni_tpu.exec import \
    reset_standing_state as ref_reset_standing
from spark_rapids_jni_tpu.exec.runner import run_morsels as ref_run_morsels
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df
from spark_rapids_jni_tpu.tpcds.rel import run_fused as ref_run_fused

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.exec import (HostTable, morsel_bytes_budget,
                                             plan_morsels, rel_append,
                                             reset_morsel_budget_probe,
                                             reset_standing_state)
from spark_rapids_jni_tpu_torch.exec.runner import run_morsels
from spark_rapids_jni_tpu_torch.tpcds import PLANS
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
from spark_rapids_jni_tpu_torch.utils import faults

CPU = torch.device("cpu")
FACTS = ("store_sales", "web_sales", "catalog_sales", "store_returns")
QNAMES = [f"q{i}" for i in range(1, 11)]
# the route counters a morsel run's one pass over the plan shows
ROUTES = ("rel.route.join.presence_morsel.semi",
          "rel.route.join.presence_morsel.anti",
          "rel.route.groupby.two_phase.morsel")


def compare(got: pd.DataFrame, want: pd.DataFrame, ctx: str,
            rtol: float = 1e-9, atol: float = 1e-9) -> None:
    assert list(got.columns) == list(want.columns), ctx
    assert len(got) == len(want), f"{ctx}: {len(got)} vs {len(want)}"
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=rtol,
                atol=atol, equal_nan=True, err_msg=f"{ctx}:{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{ctx}:{c}")


@pytest.fixture(scope="module")
def data():
    return ref_generate(sf=0.3, seed=42)


@pytest.fixture(scope="module")
def rels(data):
    return {k: rel_from_df(v, device=CPU) for k, v in data.items()}


@pytest.fixture(scope="module")
def ref_rels(data):
    return {k: ref_rel_from_df(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def host_rels(data, rels):
    out = dict(rels)
    for f in FACTS:
        out[f] = HostTable.from_df(data[f])
    return out


@pytest.fixture(scope="module")
def ref_host_rels(data, ref_rels):
    out = dict(ref_rels)
    for f in FACTS:
        out[f] = RefHostTable.from_df(data[f])
    return out


@pytest.fixture(autouse=True)
def _fresh_probes():
    # no budget probe and no standing state carries over between tests
    # (a kept accumulator would make a repeated layout a delta run)
    for reset in (reset_morsel_budget_probe, ref_reset_probe,
                  reset_standing_state, ref_reset_standing):
        reset()
    yield
    reset_morsel_budget_probe()
    ref_reset_probe()


# --------------------------------------------------------------------------
# 1. q1-q10 streamed: the port against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qname", QNAMES)
@pytest.mark.parametrize("n_morsels", [1, 4])
def test_query_morsel_matches_reference(qname, n_morsels, host_rels,
                                        ref_host_rels, rels, ref_rels):
    before = obs.kernel_stats()
    info = {}
    got = run_morsels(PLANS[qname], host_rels, info, morsels=n_morsels,
                      device=CPU).to_df()
    delta = obs.stats_since(before)
    ref_before = ref_obs.kernel_stats()
    ref_info = {}
    want = ref_run_morsels(getattr(RQ, f"_{qname}"), ref_host_rels,
                           ref_info, morsels=n_morsels).to_df()
    ref_delta = ref_obs.stats_since(ref_before)
    compare(got, want, f"{qname}/m{n_morsels} vs reference", rtol=1e-12,
            atol=0)
    compare(got, run_fused(PLANS[qname], rels, device=CPU).to_df(),
            f"{qname}/m{n_morsels} vs in-core")
    compare(want, ref_run_fused(getattr(RQ, f"_{qname}"),
                                ref_rels).to_df(),
            f"{qname}/m{n_morsels} reference vs its in-core")
    for key in ("exec.morsel.folded", "rel.morsel_fallbacks"):
        assert delta.get(key, 0) == ref_delta.get(key, 0), (key, delta,
                                                            ref_delta)
    assert delta.get("rel.morsel_fallbacks", 0) == 0, delta
    if n_morsels > 1:
        assert delta.get("exec.morsel.folded", 0) >= n_morsels
    assert info["morsel"]["n_morsels"] == ref_info["morsel"]["n_morsels"]
    assert (info["morsel"]["capacity_rows"]
            == ref_info["morsel"]["capacity_rows"])
    for key in ROUTES:
        assert (info["trace_counters"].get(key, 0)
                == ref_info["trace_counters"].get(key, 0)), key
    assert delta.get("rel.host_syncs", 0) <= 1, delta


# --------------------------------------------------------------------------
# 2. host tables and the planner, byte for byte
# --------------------------------------------------------------------------

@pytest.mark.parametrize("table", FACTS)
def test_host_table_matches_reference(table, data):
    df = data[table]
    ht, ref = HostTable.from_df(df), RefHostTable.from_df(df)
    assert ht.names == ref.names
    assert (ht.num_rows, ht.row_bytes, ht.nbytes) == (
        ref.num_rows, ref.row_bytes, ref.nbytes)
    snap, rsnap = ht.snapshot(), ref.snapshot()
    assert snap[3] == rsnap[3]  # ingest tokens
    for name in ht.names:
        c, r = snap[1][name], rsnap[1][name]
        assert c.dtype.id.value == r.dtype.id.value
        assert c.dtype.scale == r.dtype.scale
        assert c.value_range == r.value_range
        assert c.data.dtype == r.data.dtype
        assert c.data.tobytes() == r.data.tobytes()
    assert sorted(snap[2]) == sorted(rsnap[2])
    for name in snap[2]:
        assert list(snap[2][name]) == list(rsnap[2][name])
    n = ht.num_rows
    for base, live, cap in ((0, 64, 64), (100, 128, 128),
                            (n - 100, 100, 256), (n, 0, 64)):
        got = ht.chunk_arrays(snap[1], base, live, cap)
        want = ref.chunk_arrays(rsnap[1], base, live, cap)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for a, b in zip(ht.chunk_views(snap[1], base, live), got):
            assert a.tobytes() == b[:live].tobytes()


class _Fake:
    def __init__(self, rows: int, row_bytes: int):
        self.num_rows = rows
        self.row_bytes = row_bytes


@pytest.mark.parametrize("mesh_parts", [1, 2, 8])
@pytest.mark.parametrize("force", [None, 1, 2, 3, 8])
def test_plan_morsels_matches_reference(force, mesh_parts):
    grid = [({"a": (10_000, 40)}, 8192), ({"a": (10_000, 40)}, 1 << 20),
            ({"a": (1_000_000, 96), "b": (250_000, 80)}, 1 << 24),
            ({"a": (1_000_000, 96), "b": (7, 8)}, 64),
            ({"a": (5, 8)}, None), ({"a": (12345, 16), "b": (3, 200),
                                    "c": (99_999, 24)}, 1 << 16)]
    for spec, budget in grid:
        stream = {n: _Fake(r, b) for n, (r, b) in spec.items()}
        got = plan_morsels(stream, budget, force_min=force,
                           mesh_parts=mesh_parts)
        want = ref_plan_morsels(stream, budget, force_min=force,
                                mesh_parts=mesh_parts)
        assert (got is None) == (want is None), (spec, budget)
        if got is None:
            continue
        assert got.capacities == want.capacities, (spec, budget)
        assert got.window_bytes == want.window_bytes
        assert got.budget_unmet == want.budget_unmet
        rows = {n: r for n, (r, _) in spec.items()}
        assert got.n_morsels(rows) == want.n_morsels(rows)


def test_plan_morsels_verdicts_and_unmet(data):
    ht = HostTable.from_df(data["store_returns"])
    assert plan_morsels({"sr": ht}, budget=4 * ht.nbytes) is None
    assert plan_morsels({"sr": ht}, budget=None) is None
    ss = HostTable.from_df(data["store_sales"])
    before = obs.kernel_stats()
    plan = plan_morsels({"ss": ss}, budget=64)
    assert plan.budget_unmet
    assert obs.stats_since(before).get("rel.morsel_budget_unmet") == 1


def test_headroom_probe_sizes_budget():
    shim = faults.FakeDeviceMemory(n_devices=2, limit_bytes=1 << 20)
    shim.set_used_fraction(0.5)
    shim.install()
    try:
        # 1/8 of the 512 KiB headroom, pow2-floored (the reference's case)
        assert morsel_bytes_budget() == 65536
    finally:
        shim.uninstall()
    assert morsel_bytes_budget(CPU) is None  # a CPU reports nothing


# --------------------------------------------------------------------------
# 3. append / delta recomputation
# --------------------------------------------------------------------------

def _delta_setup(data, rels, monkeypatch):
    """q1 over a half-ingested store_returns under a tiny budget, so both
    the first and the appended runs stream (the reference test's)."""
    monkeypatch.setenv("SRT_MORSEL_BYTES", "4096")
    reset_standing_state()
    sr = data["store_returns"]
    half = len(sr) // 2
    ht = HostTable.from_df(sr.iloc[:half].reset_index(drop=True))
    host = dict(rels)
    host["store_returns"] = ht
    return sr, half, ht, host


def _ref_q1(ref_rels, sr):
    return ref_run_fused(RQ._q1, {**ref_rels,
                                  "store_returns": ref_rel_from_df(sr)})


def test_append_delta_recompute(data, rels, ref_rels, monkeypatch):
    sr, half, ht, host = _delta_setup(data, rels, monkeypatch)
    r1 = run_fused(PLANS["q1"], host, device=CPU).to_df()
    first = sr.iloc[:half].reset_index(drop=True)
    compare(r1, _ref_q1(ref_rels, first).to_df(), "initial", 1e-12, 0)
    rel_append(ht, sr.iloc[half:].reset_index(drop=True))
    before = obs.kernel_stats()
    info = {}
    r2 = run_morsels(PLANS["q1"], host, info, device=CPU).to_df()
    d = obs.stats_since(before)
    compare(r2, _ref_q1(ref_rels, sr).to_df(), "append == full recompute",
            1e-9, 1e-9)
    assert info.get("provenance") == "delta"
    assert d.get("rel.morsel_delta_reuse") == 1
    assert info["morsel"]["folded_rows"]["store_returns"] == half
    assert info["morsel"]["delta"] is True
    assert d.get("rel.host_syncs", 0) <= 1


def test_delta_rerun_without_append_folds_nothing(data, rels, monkeypatch):
    _, _, ht, host = _delta_setup(data, rels, monkeypatch)
    run_fused(PLANS["q1"], host, device=CPU).to_df()
    before = obs.kernel_stats()
    info = {}
    run_morsels(PLANS["q1"], host, info, device=CPU).to_df()
    d = obs.stats_since(before)
    assert info["morsel"]["n_morsels"] == 0
    assert d.get("rel.dispatches.exec.morsel.partial", 0) == 0
    assert d.get("rel.dispatches.exec.morsel.merge", 0) == 1
    assert d.get("exec.morsel.h2d_bytes", 0) == 0


def test_delta_invalidation_on_divergence(data, rels, ref_rels,
                                          monkeypatch):
    sr, half, ht, host = _delta_setup(data, rels, monkeypatch)
    run_fused(PLANS["q1"], host, device=CPU).to_df()
    shuffled = sr.iloc[:half].iloc[::-1].reset_index(drop=True)
    host["store_returns"] = HostTable.from_df(shuffled)
    before = obs.kernel_stats()
    got = run_fused(PLANS["q1"], host, device=CPU).to_df()
    d = obs.stats_since(before)
    assert d.get("rel.morsel_delta_invalidations", 0) >= 1
    compare(got, _ref_q1(ref_rels, shuffled).to_df(), "diverged prefix",
            1e-9, 1e-9)


def test_dict_growth_append_rebuilds_and_stays_correct():
    df = pd.DataFrame({"k": np.arange(6, dtype=np.int64),
                       "s": ["a", "b", "a", "c", "b", "a"]})
    more = pd.DataFrame({"k": np.arange(6, 9, dtype=np.int64),
                         "s": ["zz", "a", "zz"]})
    ht, ref = HostTable.from_df(df), RefHostTable.from_df(df)
    before = obs.kernel_stats()
    rel_append(ht, more)
    ref.append(more)
    assert obs.stats_since(before).get("rel.morsel_dict_rebuilds") == 1
    assert ht.batch_tokens() == ref.batch_tokens()
    assert len(ht.batch_tokens()) == 1  # the ingest log reset

    def _plan(t):
        return t["tbl"].groupby(["s"], [("k", "sum", "total")]).sort(["s"])

    got = run_fused(_plan, {"tbl": ht}, morsels=2, device=CPU).to_df()
    full = pd.concat([df, more]).reset_index(drop=True)
    compare(got, ref_run_fused(_plan, {"tbl": ref_rel_from_df(full)})
            .to_df(), "dict growth", 1e-12, 0)


def test_append_widening_counted():
    df = pd.DataFrame({"k": np.arange(100, dtype=np.int64)})
    ht, ref = HostTable.from_df(df), RefHostTable.from_df(df)
    more = pd.DataFrame({"k": np.arange(100_000, 100_010, dtype=np.int64)})
    before = obs.kernel_stats()
    ht.append(more)
    ref.append(more)
    assert obs.stats_since(before).get("rel.morsel_stats_widened") == 1
    assert ht.batch_tokens() == ref.batch_tokens()
    assert (ht.snapshot()[1]["k"].value_range
            == ref.snapshot()[1]["k"].value_range)


# --------------------------------------------------------------------------
# 4. a dispatch fault mid-stream: the retry replays bit-exact
# --------------------------------------------------------------------------

def test_dispatch_fault_midstream_retry_bitexact(data, rels, ref_rels,
                                                 monkeypatch):
    sr, half, ht, host = _delta_setup(data, rels, monkeypatch)
    run_fused(PLANS["q1"], host, device=CPU).to_df()  # standing state
    rel_append(ht, sr.iloc[half:].reset_index(drop=True))
    faults.configure("dispatch:raise:1")
    try:
        with pytest.raises(faults.InjectedFault):
            run_fused(PLANS["q1"], host, device=CPU).to_df()
    finally:
        faults.reset()
    before = obs.kernel_stats()
    got = run_fused(PLANS["q1"], host, device=CPU).to_df()
    d = obs.stats_since(before)
    assert d.get("rel.morsel_delta_reuse") == 1
    # the retry equals a clean delta run bit for bit
    reset_standing_state()
    clean_ht = HostTable.from_df(sr.iloc[:half].reset_index(drop=True))
    clean = {**host, "store_returns": clean_ht}
    run_fused(PLANS["q1"], clean, device=CPU).to_df()
    rel_append(clean_ht, sr.iloc[half:].reset_index(drop=True))
    compare(got, run_fused(PLANS["q1"], clean, device=CPU).to_df(),
            "post-fault retry", 0, 0)
    compare(got, _ref_q1(ref_rels, sr).to_df(), "post-fault vs reference",
            1e-9, 1e-9)


# --------------------------------------------------------------------------
# 5. terminal top-k over streamed rows; a plan that cannot stream
# --------------------------------------------------------------------------

def _topq(t):
    ss = t["store_sales"]
    f = ss.filter(ss.data("ss_quantity") >= 15)
    return (f.select("ss_item_sk", "ss_sales_price", "ss_quantity")
             .sort(["ss_sales_price", "ss_item_sk"],
                   descending=[True, False]).head(20))


def test_terminal_topk_streams(host_rels, ref_host_rels):
    before = obs.kernel_stats()
    got = run_fused(_topq, host_rels, morsels=4, device=CPU).to_df()
    delta = obs.stats_since(before)
    assert delta.get("rel.morsel_fallbacks", 0) == 0, delta
    assert delta.get("exec.morsel.folded", 0) >= 4
    want = ref_run_fused(_topq, ref_host_rels, morsels=4).to_df()
    compare(got, want, "topk", 0, 0)


def test_terminal_stream_without_limit_falls_back(host_rels, ref_rels):
    def _plan(t):
        ss = t["store_sales"]
        return (ss.filter(ss.data("ss_quantity") >= 15)
                  .select("ss_item_sk", "ss_quantity")
                  .sort(["ss_item_sk", "ss_quantity"]))

    before = obs.kernel_stats()
    got = run_fused(_plan, host_rels, morsels=4, device=CPU).to_df()
    delta = obs.stats_since(before)
    assert delta.get("rel.morsel_fallbacks", 0) == 1
    compare(got, ref_run_fused(_plan, ref_rels).to_df(), "fallback", 0, 0)


# --------------------------------------------------------------------------
# 6. the run's facts: info, gauges, the overlap histogram
# --------------------------------------------------------------------------

def test_morsel_info_and_overlap_histogram(host_rels, monkeypatch):
    monkeypatch.setenv("SRT_METRICS", "1")  # histograms record only then
    hist = obs.REGISTRY.histogram("exec.morsel.overlap_ns")
    seen = hist.snapshot()["count"]
    info = {}
    run_morsels(PLANS["q3"], host_rels, info, morsels=4, device=CPU).to_df()
    m = info["morsel"]
    assert m["n_morsels"] >= 4
    assert m["peak_model_bytes"] >= m["window_bytes"] > 0
    assert m["acc_bytes"] > 0 and m["h2d_bytes"] > 0
    assert obs.gauge("exec.morsel.peak_model_bytes").value == \
        m["peak_model_bytes"]
    # the pump staged morsel k+1 while k ran: one overlap a later morsel
    assert hist.snapshot()["count"] - seen == m["n_morsels"] - 1
