"""The port's ``parallel/`` against the JAX package and a numpy model.

Host pieces against the reference's functions on the same numpy inputs
made from a seed: Spark hash partition ids (K4/K5's plain versions on
the CPU), range bounds and range partition ids, ``shard_capacity``,
``pad_rows``, ``exchange_wire_bytes``, ``plan_exchange`` and
``plan_exchange_hier``, the route knobs and the scratch override.

Collective pieces on gloo groups of 2 and 4 ranks (subprocesses, one
group a world size, ``init_method=file://`` under ``tmp_path``, a 60 s
collective timeout, a 120 s limit a group with its children killed on
expiry): every collective against a numpy model of the reference's
folds, on a 1-D mesh and, at 4 ranks, on the tuple axis of a 2 x 2
``intra x part`` mesh; ``exchange_columns`` single-shot equal to staged
and to the model, the hierarchical tiers equal to the flat exchange; and
``shuffle_table`` losing no row under skew, with its retry rounds.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.parallel import comm_plan as ref_cp
from spark_rapids_jni_tpu.parallel import mesh as ref_mesh
from spark_rapids_jni_tpu.parallel import partition as ref_part
from spark_rapids_jni_tpu.parallel import shuffle as ref_shuffle

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.parallel import comm_plan as cp
from spark_rapids_jni_tpu_torch.parallel import mesh as port_mesh
from spark_rapids_jni_tpu_torch.parallel import partition as part
from spark_rapids_jni_tpu_torch.parallel import shuffle

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GROUP_TIMEOUT_S = 120


def _cols(rng, n):
    """Seeded key columns: int32 with nulls, int64, float64 with NaN and
    signed zeros."""
    i32 = rng.integers(-2**31, 2**31, n).astype(np.int32)
    i64 = rng.integers(-2**62, 2**62, n).astype(np.int64)
    f64 = rng.standard_normal(n)
    f64[::7] = np.nan
    f64[1::11] = -0.0
    f64[2::11] = 0.0
    valid = rng.random(n) > 0.1
    return [(i32, valid), (i64, None), (f64, None)]


def _tables(cols):
    port = Table([Column.from_numpy(v, m, device=CPU) for v, m in cols])
    ref = RefTable([RefColumn.from_numpy(v, m) for v, m in cols])
    return port, ref


# --------------------------------------------------------------------------
# host pieces against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nparts", [1, 3, 8, 13])
@pytest.mark.parametrize("which", [[0], [1], [2], [0, 1, 2]],
                         ids=["int32", "int64", "float64", "all"])
def test_hash_partition_ids_equal_reference(nparts, which):
    cols = _cols(np.random.default_rng(5), 4099)
    port, ref = _tables([cols[i] for i in which])
    got = part.hash_partition_ids(port, nparts).numpy()
    want = np.asarray(ref_part.hash_partition_ids(ref, nparts))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < nparts


@pytest.mark.parametrize("nparts", [1, 2, 5, 16])
def test_range_partitioning_equals_reference(nparts):
    rng = np.random.default_rng(9)
    n = 3000
    k1 = rng.integers(0, 40, n).astype(np.int64)
    k2 = rng.integers(-500, 500, n).astype(np.int32)
    v2 = rng.random(n) > 0.05
    port, ref = _tables([(k1, None), (k2, v2)])
    pb = part.sample_range_bounds(port, nparts, seed=3)
    rb = ref_part.sample_range_bounds(ref, nparts, seed=3)
    assert pb.num_rows == rb.num_rows == max(nparts - 1, 0)
    for pc, rc in zip(pb.columns, rb.columns):
        pv, pm = pc.to_numpy()
        rv, rm = rc.to_numpy()
        np.testing.assert_array_equal(pm, rm)
        np.testing.assert_array_equal(pv[pm], rv[rm])
    got = part.range_partition_ids(port, pb).numpy()
    want = np.asarray(ref_part.range_partition_ids(ref, rb))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_shard_capacity_and_pad_rows_equal_reference(n, shards):
    assert part.shard_capacity(n, shards) == ref_part.shard_capacity(
        n, shards)
    a = np.random.default_rng(n).integers(-9, 9, (n, 3)).astype(np.int64)
    got = part.pad_rows(torch.from_numpy(a), shards).numpy()
    want = np.asarray(ref_part.pad_rows(jnp.asarray(a), shards))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity,shards", [(1, 1), (96, 8), (1000, 3)])
def test_exchange_wire_bytes_equals_reference(capacity, shards):
    datas = [np.zeros((5,), np.int64), np.zeros((5, 2), np.int64),
             np.zeros((5,), np.int8), np.zeros((5,), np.float32)]
    tensors = [torch.from_numpy(d) for d in datas]
    assert shuffle.exchange_wire_bytes(tensors, capacity, shards) \
        == shuffle.exchange_wire_bytes(datas, capacity, shards) \
        == ref_shuffle.exchange_wire_bytes(datas, capacity, shards)


PLAN_GRID = [(c, s, cb, b) for c in (1, 37, 1000, 250_000)
             for s in (1, 2, 8) for cb in ([8], [8, 8, 4], [1], [16, 1])
             for b in (None, 1, 4096, 65536, 1 << 24)]


@pytest.mark.parametrize("capacity,shards,col_bytes,budget", PLAN_GRID)
def test_plan_exchange_equals_reference(capacity, shards, col_bytes, budget,
                                        monkeypatch):
    monkeypatch.delenv("SRT_SHUFFLE_SCRATCH_BYTES", raising=False)
    got = cp.plan_exchange(capacity, shards, col_bytes, budget)
    want = ref_cp.plan_exchange(capacity, shards, col_bytes, budget)
    assert vars(got) == vars(want)
    assert (got.route, got.fits_budget) == (want.route, want.fits_budget)
    assert cp.single_shot_scratch_bytes(capacity, shards, col_bytes) == \
        ref_cp.single_shot_scratch_bytes(capacity, shards, col_bytes)


@pytest.mark.parametrize("capacity", [1, 500, 80_000])
@pytest.mark.parametrize("a,b", [(2, 2), (2, 4), (4, 2)])
@pytest.mark.parametrize("budget", [None, 8192, 1 << 20])
@pytest.mark.parametrize("route", ["intra", "neighborhood"])
def test_plan_exchange_hier_equals_reference(capacity, a, b, budget, route,
                                             monkeypatch):
    monkeypatch.delenv("SRT_SHUFFLE_SCRATCH_BYTES", raising=False)
    got = cp.plan_exchange_hier(capacity, a, b, [8, 4, 4], budget, route)
    want = ref_cp.plan_exchange_hier(capacity, a, b, [8, 4, 4], budget,
                                     route)
    assert [vars(s) for s in got.stages] == [vars(s) for s in want.stages]
    for attr in ("route", "rounds", "peak_scratch_bytes",
                 "flat_peak_scratch_bytes", "fits_budget", "total_bytes",
                 "n_shards", "payload_bytes", "max_col_bytes"):
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("name,values,fn", [
    ("SRT_SHUFFLE_JOIN_ROUTE",
     ["", "auto", "exchange", "reduce_scatter", "bogus", " exchange "],
     "shuffle_join_route"),
    ("SRT_SHUFFLE_INTRA", ["", "auto", "flat", "x", "flat "],
     "intra_exchange_route"),
    ("SRT_SHUFFLE_NEIGHBORHOOD", ["", "0", "1", "2", "4", "x", "-3"],
     "neighborhood_size"),
    ("SRT_SHUFFLE_SCRATCH_BYTES", ["", "0", "65536", "x", "-5"],
     "scratch_budget")])
def test_knobs_normalise_as_the_reference(name, values, fn, monkeypatch):
    for v in values:
        monkeypatch.setenv(name, v)
        assert getattr(cp, fn)() == getattr(ref_cp, fn)(), (name, v)


def test_scratch_override_shrinks_and_releases(monkeypatch):
    monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "65536")
    cp.reset_scratch_override()
    try:
        assert cp.shrink_scratch_budget(holder="a") == 32768
        assert cp.scratch_budget() == 32768 and cp.scratch_override_active()
        cp.release_scratch_override("b")  # a bystander changes nothing
        assert cp.scratch_budget() == 32768
        cp.release_scratch_override("a")
        assert cp.scratch_budget() == 65536
        monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "4096")
        assert cp.shrink_scratch_budget() is None  # at the floor
    finally:
        cp.reset_scratch_override()


@pytest.mark.parametrize("logical", [("data",), ("replica", "data"),
                                     ("intra", "data"), (None, "data"),
                                     ("data", "data"), ("bogus",)])
def test_logical_to_physical_equals_reference(logical):
    assert port_mesh.logical_to_physical(logical) == \
        ref_mesh.logical_to_physical(logical)


# --------------------------------------------------------------------------
# collectives, exchanges and shuffle_table on gloo ranks
# --------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
    from spark_rapids_jni_tpu_torch.parallel import (
        all_gather_rows, all_reduce, all_to_all_blocks, axis_index_flat,
        distributed, exchange_columns, exchange_columns_hier,
        hash_partition_ids, make_mesh, plan_exchange, plan_exchange_hier,
        reduce_scatter_extreme, reduce_scatter_sum, replica_submeshes,
        mesh_axes_key, shuffle_rows, shuffle_table)

    rank, world, init, out = (int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5])
    distributed.initialize(init, world, rank, backend="gloo", timeout_s=60)
    res = {"info": distributed.process_info()}
    t = torch.from_numpy
    W = 12 * world  # divides by every shard count

    def inputs(tag):
        rng = np.random.default_rng([rank, tag])
        return (rng.integers(-1000, 1000, (W, 3)).astype(np.int64),
                rng.standard_normal(W), rng.random(W) < 0.5)

    def collectives(mesh, axis, tag):
        x, f, b = inputs(tag)
        r = {"g": axis_index_flat(axis, mesh), "x": x, "f": f, "b": b}
        r["gather"] = all_gather_rows(t(x), axis, mesh).numpy()
        r["gather_b"] = all_gather_rows(t(b), axis, mesh).numpy()
        r["rs_sum"] = reduce_scatter_sum(t(x), axis, mesh).numpy()
        r["rs_min"] = reduce_scatter_extreme(t(x), axis, "min", mesh).numpy()
        r["rs_max"] = reduce_scatter_extreme(t(x), axis, "max", mesh).numpy()
        r["ar_sum"] = all_reduce(t(f), axis, mesh, "sum").numpy()
        r["ar_max"] = all_reduce(t(x), axis, mesh, "max").numpy()
        if isinstance(axis, str):
            p = mesh.axis_size(axis)
            r["a2a"] = all_to_all_blocks(
                t(x).reshape(p, -1, 3), axis, mesh).numpy()
            r["a2a_b"] = all_to_all_blocks(
                t(b).reshape(p, -1), axis, mesh).numpy()
        return r

    mesh = make_mesh({"part": world}, device_type="cpu")
    res["flat"] = collectives(mesh, "part", 1)
    res["key"] = mesh_axes_key(mesh)
    if world == 4:
        m2 = make_mesh({"intra": 2, "part": 2}, device_type="cpu")
        res["tuple"] = collectives(m2, ("intra", "part"), 2)
        res["inner"] = collectives(m2, "part", 3)
        r2 = make_mesh({"replica": 2, "part": 2}, device_type="cpu")
        subs = replica_submeshes(r2)
        res["subs"] = [(s.local, mesh_axes_key(s)) for s in subs]
        mine = [s for s in subs if s.local][0]
        res["sub_gather"] = all_gather_rows(
            torch.tensor([rank]), "part", mine).numpy()

    # exchange_columns: single shot, staged, and the hierarchical tiers
    rng = np.random.default_rng([rank, 7])
    n_local = 96
    v64 = rng.integers(-9e8, 9e8, n_local).astype(np.int64)
    vf = rng.standard_normal(n_local)
    live = rng.random(n_local) < 0.8
    pids = rng.integers(0, world, n_local).astype(np.int32)
    res["ex_in"] = (v64, vf, live, pids)
    single = exchange_columns([t(v64), t(vf)], t(live), t(pids), "part",
                              n_local, mesh=mesh)
    staged_plan = plan_exchange(n_local, world, [8, 8], budget=1024)
    staged = exchange_columns([t(v64), t(vf)], t(live), t(pids), "part",
                              n_local, plan=staged_plan, mesh=mesh)
    res["ex_rounds"] = staged_plan.rounds
    res["ex_single"] = [single[0][0].numpy(), single[0][1].numpy(),
                        single[1].numpy(), int(single[2])]
    res["ex_staged"] = [staged[0][0].numpy(), staged[0][1].numpy(),
                        staged[1].numpy(), int(staged[2])]

    def delivered(outs, rlive):
        keep = rlive.numpy()
        return sorted(zip(outs[0].numpy()[keep].tolist(),
                          outs[1].numpy()[keep].tolist()))

    res["ex_flat_set"] = delivered(single[0], single[1])
    if world == 4:
        hp = plan_exchange_hier(n_local, 2, 2, [8, 8, 4], budget=None,
                                route="neighborhood")
        o, rl = exchange_columns_hier([t(v64), t(vf)], t(live), t(pids),
                                      "part", hp, mesh=mesh)
        res["ex_neigh_set"] = delivered(o, rl)
        hp = plan_exchange_hier(n_local, 2, 2, [8, 8, 4], budget=None,
                                route="intra")
        o, rl = exchange_columns_hier([t(v64), t(vf)], t(live), t(pids),
                                      "part", hp, intra_axis="intra",
                                      mesh=m2)
        res["ex_intra_set"] = delivered(o, rl)
        res["ex_intra_g"] = axis_index_flat(("intra", "part"), m2)

    # shuffle_rows with a small capacity: the residual rows come back
    rows = rng.integers(0, 256, (64, 16)).astype(np.uint8)
    rpids = np.where(rng.random(64) < 0.7, 0,
                     rng.integers(0, world, 64)).astype(np.int32)
    sr = shuffle_rows(mesh, t(rows), t(rpids), 4, "part")
    res["sr"] = (rows, rpids, sr.rows.numpy(), sr.valid.numpy(),
                 sr.overflow.numpy(), sr.resid.numpy())

    # shuffle_table under skew: fixed-width (K6 / K3's table form) and
    # with a STRING column (the torch route)
    n = 500 + 37 * rank
    key = np.where(rng.random(n) < 0.8, 42,
                   rng.integers(0, 10_000, n)).astype(np.int32)
    k64 = rng.integers(-2**40, 2**40, n).astype(np.int64)
    val = rng.standard_normal(n)
    vvalid = rng.random(n) > 0.1
    strs = ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(0, 12)))
            if rng.random() > 0.1 else None for _ in range(n)]
    fixed = Table([Column.from_numpy(key, device="cpu"),
                   Column.from_numpy(k64, device="cpu"),
                   Column.from_numpy(val, vvalid, device="cpu")])
    withstr = Table(list(fixed.columns) + [
        Column.strings_from_list(strs, device="cpu")])
    res["st_in"] = (key, k64, val, vvalid, strs)
    for name, tbl in (("fixed", fixed), ("string", withstr)):
        before = kernel_stats()
        got, over = shuffle_table(mesh, tbl, [0, 1], capacity=8)
        st = stats_since(before)
        cols = []
        for c in got.columns:
            cols.append(c.to_pylist())
        pid = hash_partition_ids(Table([got.column(0), got.column(1)]),
                                 world).numpy()
        res[f"st_{name}"] = (cols, pid, over.numpy(), st)
    with open(os.path.join(out, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    distributed.shutdown()
""")


def _spawn(world: int, tmp: Path):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    init = f"file://{tmp / 'init'}"
    procs = []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script), str(ROOT), str(rank), str(world),
             init, str(tmp)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _finish(procs, tmp: Path, deadline: float) -> "list[dict]":
    """Wait for every rank until ``deadline``; kill them all on expiry or
    on a failed rank, and fail with the ranks' logs."""
    world = len(procs)
    failed = None
    for rank, (p, _) in enumerate(procs):
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed = (rank, rc)
            break
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    if failed:
        logs = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:]
                         for r in range(world))
        pytest.fail(f"rank {failed[0]} ended with {failed[1]}:\n{logs}")
    return [pickle.loads((tmp / f"r{r}.pkl").read_bytes())
            for r in range(world)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups' per-rank results (the groups run concurrently)."""
    started = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"par{world}")
        started[world] = (_spawn(world, tmp), tmp,
                          time.monotonic() + GROUP_TIMEOUT_S)
    try:
        return {w: _finish(*g) for w, g in started.items()}
    finally:  # no rank outlives the fixture, whatever failed
        for procs, _, _ in started.values():
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def group(request, groups):
    return request.param, groups[request.param]


def _model(ranks: "list[dict]", key: str, p: int):
    """Every shard's expected results from the inputs, in the reference's
    row-major fold order (shard g is the rank whose flat index is g)."""
    by_g = {r[key]["g"]: r[key] for r in ranks}
    assert sorted(by_g) == list(range(p))
    xs = [by_g[g]["x"] for g in range(p)]
    fs = [by_g[g]["f"] for g in range(p)]
    bs = [by_g[g]["b"] for g in range(p)]
    tot = np.sum(xs, axis=0)
    w = xs[0].shape[0] // p
    return {g: {"gather": np.concatenate(xs), "gather_b": np.concatenate(bs),
                "rs_sum": tot[g * w:(g + 1) * w],
                "rs_min": np.min(xs, axis=0)[g * w:(g + 1) * w],
                "rs_max": np.max(xs, axis=0)[g * w:(g + 1) * w],
                "ar_sum": np.sum(fs, axis=0), "ar_max": np.max(xs, axis=0),
                "a2a": np.stack([xs[j].reshape(p, -1, 3)[g]
                                 for j in range(p)]),
                "a2a_b": np.stack([bs[j].reshape(p, -1)[g]
                                   for j in range(p)])}
            for g in range(p)}


def test_collectives_equal_the_numpy_model(group):
    world, ranks = group
    _check_model(ranks, "flat", world)


@pytest.mark.parametrize("layout", ["tuple", "inner"])
def test_collectives_on_the_two_by_two_mesh(groups, layout):
    ranks = groups[4]
    if layout == "tuple":
        # the (intra, part) tuple axis folds in row-major shard order
        _check_model(ranks, layout, 4)
        return
    # one axis of the 2 x 2 mesh: each intra row is its own group
    for row in (0, 1):
        _check_model([r for i, r in enumerate(ranks) if i // 2 == row],
                     layout, 2)


def _check_model(ranks, layout, p):
    model = _model(ranks, layout, p)
    for r in ranks:
        got = r[layout]
        want = model[got["g"]]
        for k, v in want.items():
            if k not in got:
                continue
            if v.dtype.kind == "f":
                np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0,
                                           err_msg=f"{layout} {k}")
            else:
                np.testing.assert_array_equal(got[k], v,
                                              err_msg=f"{layout} {k}")


def test_process_info_and_mesh_keys(group):
    world, ranks = group
    for rank, r in enumerate(ranks):
        assert r["info"]["process_index"] == rank
        assert r["info"]["process_count"] == world
        assert r["info"]["backend"] == "gloo"
        assert r["key"] == (("part", world), tuple(range(world)))
        if world == 4:
            assert r["subs"] == [(rank // 2 == 0, (("part", 2), (0, 1))),
                                 (rank // 2 == 1, (("part", 2), (2, 3)))]
            base = 2 * (rank // 2)
            np.testing.assert_array_equal(r["sub_gather"], [base, base + 1])


def test_exchange_single_shot_equals_staged_and_model(group):
    world, ranks = group
    assert ranks[0]["ex_rounds"] > 2
    n_local = 96
    for g, r in enumerate(ranks):
        for a, b in zip(r["ex_single"][:3], r["ex_staged"][:3]):
            np.testing.assert_array_equal(a, b)
        assert r["ex_single"][3] == r["ex_staged"][3] == 0
        v64, vf, rlive = r["ex_single"][:3]
        for s, src in enumerate(ranks):
            sv, sf, slive, spids = src["ex_in"]
            sel = slive & (spids == g)
            k = int(sel.sum())
            lane = slice(s * n_local, s * n_local + n_local)
            np.testing.assert_array_equal(v64[lane][:k], sv[sel])
            np.testing.assert_array_equal(vf[lane][:k], sf[sel])
            assert rlive[lane][:k].all() and not rlive[lane][k:].any()


def test_hierarchical_exchanges_deliver_the_flat_rows(groups):
    ranks = groups[4]  # the two-stage tiers factor 4 ranks as 2 x 2
    for r in ranks:
        assert r["ex_neigh_set"] == r["ex_flat_set"]
    by_g = {r["ex_intra_g"]: r for r in ranks}
    for g, r in by_g.items():
        assert r["ex_intra_set"] == ranks[g]["ex_flat_set"]


def test_shuffle_rows_keeps_back_only_the_overflow(group):
    world, ranks = group
    got = {g: [] for g in range(world)}
    for g, r in enumerate(ranks):
        rows, pids, recv, valid, over, resid = r["sr"]
        assert int(over[0]) == int(resid.sum())
        sent = ~resid
        for s in range(world):
            lane = valid.reshape(world, 4)[s]
            got[g].extend(map(bytes, recv.reshape(world, 4, -1)[s][lane]))
        for d in range(world):
            assert int((sent & (pids == d)).sum()) <= 4
            assert int((resid & (pids == d)).sum()) == max(
                0, int((pids == d).sum()) - 4)
    for d in range(world):
        want = [bytes(r["sr"][0][i]) for r in ranks
                for i in np.nonzero(~r["sr"][5] & (r["sr"][1] == d))[0]]
        assert sorted(got[d]) == sorted(want)


@pytest.mark.parametrize("schema", ["fixed", "string"])
def test_shuffle_table_loses_no_row_under_skew(group, schema):
    world, ranks = group

    def rows_of(cols):
        return list(zip(*cols))

    sent = []
    for r in ranks:
        key, k64, val, vvalid, strs = r["st_in"]
        cols = [key.tolist(), k64.tolist(),
                [v if ok else None for v, ok in zip(val.tolist(), vvalid)]]
        if schema == "string":
            cols.append(strs)
        sent += rows_of(cols)
    received = []
    retries = 0
    for g, r in enumerate(ranks):
        cols, pid, over, st = r[f"st_{schema}"]
        assert (pid == g).all()  # every row landed on its hash partition
        np.testing.assert_array_equal(over, ranks[0][f"st_{schema}"][2])
        assert over.shape == (world,)
        received += rows_of(cols)
        retries = max(retries, st.get("shuffle.retry_rounds", 0))
        assert st.get("shuffle.overflow_rows", 0) == \
            st.get("shuffle.retry_rows", 0)
    key = lambda row: tuple((x is None, x if x is not None else 0)  # noqa
                            for x in row)
    assert sorted(received, key=key) == sorted(sent, key=key)
    assert retries >= 1  # the skewed key overflowed capacity 8
