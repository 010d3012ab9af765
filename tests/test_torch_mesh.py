"""q1-q20 of the PyTorch/CUDA port over a gloo mesh, against the JAX package.

``run_fused(plan, rels, mesh=...)`` is SPMD: each rank is a process, calls
it with the same global rels and gets the same result. Two groups run as
subprocesses, one of 2 ranks and one of 4, each with one gloo process
group (``init_method=file://`` under ``tmp_path``, a 60 s collective
timeout, one thread a rank) in which every pass below runs q1-q20 at
sf 0.5, seed 7, with ``SRT_BROADCAST_THRESHOLD=8192`` (the reference's
test value: the fact tables, ``date_dim`` and ``customer`` shard):

- 2 ranks: the 1-D ``part`` mesh;
- 4 ranks: the 1-D mesh at the defaults, with each collective route
  forced (``SRT_SHUFFLE_JOIN_ROUTE=exchange`` / ``reduce_scatter``,
  ``SRT_GROUPBY_PSUM_WIDTH=1``, ``SRT_SHUFFLE_SCRATCH_BYTES=65536``,
  ``SRT_SHUFFLE_NEIGHBORHOOD=2``), with the kernel routes forced (their
  plain versions on the CPU), and on the 2 x 2 ``replica x part`` and
  ``intra x part`` meshes.

Every rank's result must equal the reference's single-device
``run_fused`` and the port's pandas oracle (integers exact, floats
``rtol=atol=1e-9``, the reference's bound for merge order,
``tests/test_distributed_plan.py``), with no ``rel.dist_fallbacks`` and
at most one counted host sync a rank a query; over the corpus every
collective route is counted. Each group has a 300 s limit (its children
are killed on expiry); the reference computes while the groups run.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from spark_rapids_jni_tpu.tpcds import QUERIES as REF_QUERIES
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df

from spark_rapids_jni_tpu_torch.tpcds import QUERIES, generate

ROOT = Path(__file__).resolve().parents[1]
QS = [f"q{i}" for i in range(1, 21)]
SF, SEED, THRESHOLD = 0.5, 7, "8192"
GROUP_TIMEOUT_S = 300
BUDGET = 65536

# (pass name, mesh kind, env): the 2-rank group runs the first only
PASSES = {
    2: [("default", "part", {})],
    4: [("default", "part", {}),
        ("exchange", "part", {"SRT_SHUFFLE_JOIN_ROUTE": "exchange"}),
        ("reduce_scatter", "part",
         {"SRT_SHUFFLE_JOIN_ROUTE": "reduce_scatter"}),
        ("scattered", "part", {"SRT_GROUPBY_PSUM_WIDTH": "1"}),
        ("staged", "part", {"SRT_SHUFFLE_SCRATCH_BYTES": str(BUDGET)}),
        ("neighborhood", "part", {"SRT_SHUFFLE_NEIGHBORHOOD": "2"}),
        ("kernels", "part", {"SRT_JOIN_METHOD": "cuda",
                             "SRT_DENSE_GROUPBY": "cuda"}),
        ("replica_x_part", "replica", {}),
        ("intra_x_part", "intra", {})],
}
CASES = [(w, name) for w, ps in PASSES.items() for name, _, _ in ps]

WORKER = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
    from spark_rapids_jni_tpu_torch.parallel import distributed, make_mesh
    from spark_rapids_jni_tpu_torch.tpcds import PLANS, generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused

    rank, world = int(sys.argv[2]), int(sys.argv[3])
    init, out = sys.argv[4], sys.argv[5]
    passes, queries, sf, seed = pickle.loads(bytes.fromhex(sys.argv[6]))
    distributed.initialize(init, world, rank, backend="gloo", timeout_s=60)
    meshes = {"part": make_mesh({"part": world}, device_type="cpu")}
    if world == 4:
        meshes["replica"] = make_mesh({"replica": 2, "part": 2},
                                      device_type="cpu")
        meshes["intra"] = make_mesh({"intra": 2, "part": 2},
                                    device_type="cpu")
    data = generate(sf=sf, seed=seed)
    rels = {n: rel_from_df(df, device="cpu") for n, df in data.items()}
    results = {}
    for name, kind, env in passes:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            for q in queries:
                before = kernel_stats()
                got = run_fused(PLANS[q], rels, mesh=meshes[kind]).to_df()
                results[(name, q)] = (got, stats_since(before))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    with open(os.path.join(out, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    distributed.shutdown()
""")


def spawn(world: int, tmp: Path, args_hex: str):
    """Start one gloo group of ``world`` ranks running the worker."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, SRT_BROADCAST_THRESHOLD=THRESHOLD,
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    init = f"file://{tmp / 'init'}"
    procs = []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script), str(ROOT), str(rank), str(world),
             init, str(tmp), args_hex], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def finish(procs, tmp: Path, deadline: float) -> "list[dict]":
    """Wait for every rank until ``deadline``; kill them all on expiry
    or on a failed rank, and fail with the ranks' logs."""
    failed = None
    for rank, (p, log) in enumerate(procs):
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
                         for r in range(len(procs)))
        pytest.fail(f"rank {failed[0]} ended with {failed[1]}:\n{logs}")
    return [pickle.loads((tmp / f"r{r}.pkl").read_bytes())
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' per-rank results, the reference's single-device
    results and the port's oracles (the reference computes while the
    groups run)."""
    groups = {}
    for world, passes in PASSES.items():
        tmp = tmp_path_factory.mktemp(f"mesh{world}")
        args = pickle.dumps((passes, QS, SF, SEED)).hex()
        groups[world] = (spawn(world, tmp, args), tmp,
                         time.monotonic() + GROUP_TIMEOUT_S)
    try:
        data = ref_generate(sf=SF, seed=SEED)
        ref_rels = {n: ref_rel_from_df(df) for n, df in data.items()}
        want = {q: REF_QUERIES[q][0](ref_rels) for q in QS}
        own = generate(sf=SF, seed=SEED)
        oracle = {q: QUERIES[q][1](own) for q in QS}
        got = {w: finish(*g) for w, g in groups.items()}
    finally:  # no rank outlives the fixture, whatever failed
        for procs, _, _ in groups.values():
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return data, own, want, oracle, got


def assert_frames_match(got, want, what, rtol=1e-9):
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=rtol,
                atol=rtol, equal_nan=True, err_msg=f"{what}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{c}")


def test_port_generator_equals_reference(runs):
    data, own, *_ = runs
    assert sorted(data) == sorted(own)
    for name in data:
        pd.testing.assert_frame_equal(own[name], data[name], check_exact=True)


@pytest.mark.parametrize("qname", QS)
@pytest.mark.parametrize("world,pname", CASES,
                         ids=[f"{w}ranks-{n}" for w, n in CASES])
def test_mesh_query_equals_reference(runs, world, pname, qname):
    _, _, want, oracle, got = runs
    for rank, res in enumerate(got[world]):
        frame, _ = res[(pname, qname)]
        what = f"{qname} {pname} rank {rank}/{world}"
        assert_frames_match(frame, want[qname], what)
        assert_frames_match(frame, oracle[qname], what + " (oracle)")


@pytest.mark.parametrize("world,pname", CASES,
                         ids=[f"{w}ranks-{n}" for w, n in CASES])
def test_mesh_no_fallback_one_sync(runs, world, pname):
    for rank, res in enumerate(runs[-1][world]):
        for q in QS:
            _, st = res[(pname, q)]
            assert st.get("rel.dist_fallbacks", 0) == 0, (q, rank, st)
            assert st.get("rel.fused_fallbacks", 0) == 0, (q, rank, st)
            assert st.get("rel.host_syncs", 0) <= 1, (q, rank, st)
            assert st.get("shuffle.overflow_rows", 0) == 0, (q, rank, st)
            assert st.get("rel.route.dist.shard_table", 0) >= 1, (q, st)


def _corpus(got, world, names=None) -> dict:
    total: dict = {}
    for (pname, _), (_, st) in got[world][0].items():
        if names is None or pname in names:
            for k, v in st.items():
                total[k] = total.get(k, 0) + v
    return total


@pytest.mark.parametrize("route", [
    "rel.route.join.presence_psum", "rel.route.join.shuffle_hash",
    "rel.route.join.reduce_scatter", "rel.route.dist.all_gather",
    "rel.route.join.broadcast", "rel.route.groupby.two_phase.replicated",
    "rel.route.groupby.two_phase.scattered", "rel.route.window.exchange",
    "rel.route.shuffle.staged", "rel.route.shuffle.single_shot",
    "rel.route.shuffle.neighborhood", "rel.route.shuffle.intra",
    "rel.route.sort.topk", "rel.route.join.probe.cuda",
    "rel.route.groupby.dense.cuda"])
def test_every_route_counted_in_the_corpus(runs, route):
    total = _corpus(runs[-1], 4)
    assert any(k == route or k.startswith(route + ".") for k in total), \
        sorted(total)


def test_default_routes_on_two_ranks(runs):
    total = _corpus(runs[-1], 2)
    for route in ("rel.route.join.presence_psum.semi",
                  "rel.route.join.reduce_scatter.inner",
                  "rel.route.groupby.two_phase.replicated",
                  "rel.route.window.exchange", "rel.route.sort.topk"):
        assert total.get(route, 0) >= 1, (route, sorted(total))
    assert total.get("shuffle.bytes_exchanged", 0) > 0


def test_staged_pass_respects_the_budget(runs):
    res = runs[-1][4][0]
    staged = sum(res[("staged", q)][1].get("rel.route.shuffle.staged", 0)
                 for q in QS)
    assert staged >= 1
    for q in QS:
        st = res[("staged", q)][1]
        assert st.get("rel.route.shuffle.budget_unmet", 0) == 0, (q, st)
        assert st.get("shuffle.peak_scratch_bytes", 0) <= BUDGET, (q, st)
        # staging changes when bytes move, never how many
        assert st.get("shuffle.bytes.exchange", 0) == \
            res[("default", q)][1].get("shuffle.bytes.exchange", 0), q


@pytest.mark.parametrize("pname", ["replica_x_part", "intra_x_part"])
def test_two_by_two_meshes_equal_the_flat_mesh(runs, pname):
    res = runs[-1][4]
    for rank in range(4):
        for q in QS:
            assert_frames_match(res[rank][(pname, q)][0],
                                res[0][("default", q)][0],
                                f"{q} {pname} rank {rank}", rtol=1e-9)


def test_hierarchical_tiers_undercut_the_flat_peak(runs):
    res = runs[-1][4][0]
    for pname in ("neighborhood", "intra_x_part"):
        total = _corpus(runs[-1], 4, {pname})
        assert 0 < total["shuffle.peak_scratch_bytes"] \
            < total["shuffle.flat_peak_scratch_bytes"], (pname, total)
    assert res[("default", "q3")][1].get("rel.route.shuffle.single_shot",
                                         0) >= 1
