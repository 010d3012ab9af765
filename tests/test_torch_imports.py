"""The PyTorch/CUDA port stands alone: neither ``spark_rapids_jni_tpu_torch``
nor ``chip_smoke.py`` imports ``jax`` or any module of the JAX package
``spark_rapids_jni_tpu``, and ``chip_smoke.py`` fails without a GPU or
outside a checkout of the repository, printing no result.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spark_rapids_jni_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_jni_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_sources_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for rel in ("tpcds/rel.py", "tpcds/carry.py", "ops/cuda_kernels.py",
                "columnar/bitmask.py", "obs/__init__.py", "ops/hashing.py",
                "ops/hive_hash.py", "ops/row_conversion.py",
                "ops/row_layout.py", "columnar/strings.py",
                "utils/int128.py", "ops/decimal_utils.py",
                "ops/string_ops.py", "tpcds/oplib/strings.py",
                "tpcds/oplib/decimals.py", "tpcds/oplib/windows.py",
                "tpcds/oplib/registry.py", "tpcds/queries.py",
                "ops/copying.py", "ops/conditional.py", "ops/zorder.py",
                "ops/histogram.py", "ops/tdigest.py",
                "ops/get_json_object.py", "ops/map_utils.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/distributed.py", "parallel/collectives.py",
                "parallel/partition.py", "parallel/comm_plan.py",
                "parallel/shuffle.py", "tpcds/dist.py",
                "config.py", "obs/metrics.py", "obs/memory.py",
                "utils/faults.py", "io/__init__.py", "io/arrow.py",
                "io/parquet.py", "exec/__init__.py", "exec/host_table.py",
                "exec/morsel.py", "exec/pages.py", "exec/runner.py",
                "exec/disk_table.py", "obs/report.py", "obs/flight.py",
                "obs/slo.py", "obs/server.py", "obs/recompile.py",
                "obs/spans.py", "utils/tracing.py", "serving/__init__.py",
                "serving/executor.py", "serving/reliability.py",
                "serving/result_cache.py", "serving/aot_cache.py",
                "serving/batcher.py", "serving/scheduler.py",
                "utils/batching.py", "utils/plan_cache.py",
                "obs/history.py", "obs/rollup.py",
                "serving/control_plane.py", "tune/__init__.py",
                "tune/space.py", "tune/store.py", "tune/runner.py"):
        assert rel in names
    for src in ("hash_join_probe.cu", "ragged_groupby.cu",
                "bitmask_pack.cu", "murmur3.cu", "pack_rows.cu"):
        assert (PORT / "csrc" / src).exists()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_no_forbidden_import_statement(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""  # no GPU, even on a machine with one
    return env


def test_import_loads_no_jax_module():
    # only modules the imports themselves load count (an interpreter
    # startup hook may preload others)
    code = (
        "import sys, json\n"
        "before = set(sys.modules)\n"
        "import spark_rapids_jni_tpu_torch\n"
        "import spark_rapids_jni_tpu_torch.tpcds.carry\n"
        "import spark_rapids_jni_tpu_torch.tpcds.oplib.relational\n"
        "import spark_rapids_jni_tpu_torch.ops.cuda_kernels\n"
        "import spark_rapids_jni_tpu_torch.ops.hashing\n"
        "import spark_rapids_jni_tpu_torch.ops.hive_hash\n"
        "import spark_rapids_jni_tpu_torch.ops.row_conversion\n"
        "import spark_rapids_jni_tpu_torch.utils.int128\n"
        "import spark_rapids_jni_tpu_torch.ops.decimal_utils\n"
        "import spark_rapids_jni_tpu_torch.ops.string_ops\n"
        "import spark_rapids_jni_tpu_torch.parallel\n"
        "import spark_rapids_jni_tpu_torch.parallel.distributed\n"
        "import spark_rapids_jni_tpu_torch.tpcds.dist\n"
        "import spark_rapids_jni_tpu_torch.serving\n"
        "import spark_rapids_jni_tpu_torch.obs.server\n"
        "import spark_rapids_jni_tpu_torch.utils.tracing\n"
        "from spark_rapids_jni_tpu_torch.tpcds.oplib import registry\n"
        "registry.ensure_loaded()\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _forbidden(m)]


def test_chip_smoke_fails_without_a_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
