"""The morsel route of the PyTorch/CUDA port over a gloo mesh, against the
JAX package.

Two groups run as subprocesses, of 2 and of 4 ranks, each one gloo
process group (``init_method=file://`` under ``tmp_path``, a 60 s
collective timeout, one thread a rank). Every rank builds the four fact
tables of ``generate(sf=0.3, seed=42)`` (the reference's morsel test
data) as host tables, keeps the dimensions resident with
``SRT_BROADCAST_THRESHOLD=8192`` (``date_dim`` and ``customer`` shard, so
the collective join routes meet streamed chunks), and runs q3, q9 and
q10 through ``run_fused(plan, rels, mesh=mesh, morsels=4)``, and q3 once
more with store_sales streamed from Parquet row groups. Every rank's
result must equal the reference's single-device in-core result (integers
exact, floats ``rtol=atol=1e-9``), with no morsel fallback and at most
one counted host sync a query; the morsel count, capacities and skip
decisions must be equal on every rank, and each rank must stage only its
slice (``capacity / p`` rows a table a morsel).
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu.tpcds import QUERIES as REF_QUERIES
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df

from test_torch_morsel import compare

ROOT = Path(__file__).resolve().parents[1]
QS = ("q3", "q9", "q10")
SF, SEED, THRESHOLD, MORSELS = 0.3, 42, "8192", 4
GROUP_TIMEOUT_S = 240
WORLDS = (2, 4)
# what must read alike on every rank
AGREED = ("exec.morsel.folded", "exec.morsel.dispatch_skipped",
          "exec.morsel.zonemap_skipped", "rel.morsel_fallbacks",
          "rel.dispatches.exec.morsel.partial")

WORKER = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    from spark_rapids_jni_tpu_torch.exec import HostTable, ParquetHostTable
    from spark_rapids_jni_tpu_torch.exec.runner import run_morsels
    from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
    from spark_rapids_jni_tpu_torch.parallel import distributed, make_mesh
    from spark_rapids_jni_tpu_torch.tpcds import PLANS, generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df

    rank, world = int(sys.argv[2]), int(sys.argv[3])
    init, out = sys.argv[4], sys.argv[5]
    queries, sf, seed, morsels, ss_path = pickle.loads(
        bytes.fromhex(sys.argv[6]))
    distributed.initialize(init, world, rank, backend="gloo", timeout_s=60)
    mesh = make_mesh({"part": world}, device_type="cpu")
    data = generate(sf=sf, seed=seed)
    facts = ("store_sales", "web_sales", "catalog_sales", "store_returns")
    rels = {n: (HostTable.from_df(df) if n in facts
                else rel_from_df(df, device="cpu"))
            for n, df in data.items()}
    disk = dict(rels, store_sales=ParquetHostTable(ss_path))
    results = {}
    for label, q, tables in ([(q, q, rels) for q in queries]
                             + [("disk q3", "q3", disk)]):
        before = kernel_stats()
        info = {}
        got = run_morsels(PLANS[q], tables, info, mesh=mesh,
                          morsels=morsels).to_df()
        results[label] = (got, stats_since(before), info.get("morsel"))
    disk["store_sales"].close()
    with open(os.path.join(out, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    distributed.shutdown()
""")


def spawn(world: int, tmp: Path, args_hex: str):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, SRT_BROADCAST_THRESHOLD=THRESHOLD,
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("SRT_MORSEL_BYTES", None)
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
    """Both groups' per-rank results and the reference's single-device
    in-core results (computed while the groups run)."""
    data = ref_generate(sf=SF, seed=SEED)
    ss_dir = tmp_path_factory.mktemp("mesh_morsel_facts")
    ss_path = str(ss_dir / "store_sales.parquet")
    pq.write_table(pa.Table.from_pandas(data["store_sales"],
                                        preserve_index=False),
                   ss_path, row_group_size=len(data["store_sales"]) // 6)
    groups = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"mesh_morsel{world}")
        args = pickle.dumps((QS, SF, SEED, MORSELS, ss_path)).hex()
        groups[world] = (spawn(world, tmp, args), tmp,
                         time.monotonic() + GROUP_TIMEOUT_S)
    try:
        ref_rels = {n: ref_rel_from_df(df) for n, df in data.items()}
        want = {q: REF_QUERIES[q][0](ref_rels) for q in QS}
        got = {w: finish(*g) for w, g in groups.items()}
    finally:
        for procs, _, _ in groups.values():
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return want, got


LABELS = QS + ("disk q3",)


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_morsel_equals_reference(runs, world, label):
    want, got = runs
    q = label.split()[-1]
    for rank, res in enumerate(got[world]):
        frame, st, _ = res[label]
        compare(frame, want[q], f"{label} rank {rank}/{world}")
        assert st.get("rel.morsel_fallbacks", 0) == 0, (rank, st)
        assert st.get("exec.morsel.folded", 0) >= MORSELS, (rank, st)
        assert st.get("rel.host_syncs", 0) <= 1, (rank, st)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_morsel_ranks_agree(runs, world):
    _, got = runs
    for label in LABELS:
        ranks = [res[label] for res in got[world]]
        facts = [(m["n_morsels"], m["capacity_rows"], m["zonemap_skipped"],
                  tuple(st.get(k, 0) for k in AGREED))
                 for _, st, m in ranks]
        assert all(f == facts[0] for f in facts), (label, facts)
        # each rank stages capacity / p rows of every table a morsel
        for _, _, m in ranks:
            assert all(c % world == 0 for c in m["capacity_rows"].values())
        assert len({m["h2d_bytes"] for _, _, m in ranks}) == 1


def test_mesh_morsel_routes_compose(runs):
    """Over 4 ranks the morsel merges compose with the collectives: the
    groupby partials all-reduce before the morsel merge, q10's streamed
    build sides OR presence bitmaps over ranks and morsels, and streamed
    chunks probe the sharded ``date_dim`` through the reduce-scatter
    join."""
    _, got = runs
    total: dict = {}
    for label in LABELS:
        for k, v in got[4][0][label][1].items():
            total[k] = total.get(k, 0) + v
    for route in ("rel.route.groupby.two_phase.morsel",
                  "rel.route.groupby.two_phase.replicated",
                  "rel.route.join.presence_morsel.semi",
                  "rel.route.join.reduce_scatter.inner"):
        assert total.get(route, 0) >= 1, (route, sorted(total))
    assert total.get("exec.morsel.budget_agreed", 0) <= 1
