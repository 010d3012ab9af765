"""Nothing a cell's run loads is JAX or the JAX package, by top-level
module name compared whole (the port's name begins with the JAX
package's)."""

import ast
import json
import subprocess
import sys

import pytest

from harness import runner, spec as S

CELLS = [c["name"] for c in S.load_spec()["workloads"]]
PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {tests!r}, {root!r}]
from bench_small import run_small
line = run_small({cell!r}, seconds=0.5, trace={trace})
print(json.dumps({{"correct": line["correct"],
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell, trace):
    code = PROBE.format(bench=str(S.BENCH_DIR),
                        tests=str(S.BENCH_DIR / "tests"), root=str(S.ROOT),
                        cell=cell, trace=trace)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(S.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "spark_rapids_jni_tpu_torch" in got["modules"]
    assert not set(got["modules"]) & set(runner.FORBIDDEN)


def test_no_source_imports_jax():
    for path in S.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if node.level == 0 else []
            for n in names:
                assert n.split(".")[0] not in runner.FORBIDDEN, (path, n)


def test_forbidden_names_compare_whole(monkeypatch):
    mod = type(sys)("stand_in")
    monkeypatch.setitem(sys.modules, "spark_rapids_jni_tpu_torch.x", mod)
    monkeypatch.setitem(sys.modules, "jaxtools", mod)
    assert "spark_rapids_jni_tpu" not in runner.forbidden_modules() or \
        "spark_rapids_jni_tpu" in sys.modules
    assert "jax" not in runner.forbidden_modules() or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", mod)
    assert "jaxlib" in runner.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(S.ROOT))
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_benchmark_alone_fails(cuda_card, tmp_path):
    """With only BENCHMARK.json and the benchmark's files, there is no
    program to measure: the run exits with an error and no result."""
    import shutil
    shutil.copytree(S.BENCH_DIR, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(S.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
