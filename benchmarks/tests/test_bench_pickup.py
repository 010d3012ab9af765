"""A later configuration, traffic mix or metric is new files and new
entries: the harness picks them up without an edit."""

import json
import shutil

from harness import spec as S

from bench_small import run_small


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(S.BENCH_DIR, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(S.ROOT / "BENCHMARK.json", root)
    return root


def test_new_config_mix_and_metric_are_picked_up(tmp_path):
    root = _copy(tmp_path)
    bench = root / "benchmarks"
    config = S.load_config("spark_rows_32col_12m")
    config.update(name="spark_rows_8col_test", repeats=1, row_bytes=48)
    (bench / "configs" / "spark_rows_8col_test.json").write_text(
        json.dumps(config))
    (bench / "traffic" / "to_rows_test.json").write_text(json.dumps({
        "driver": "rows", "direction": "to_rows", "trace_seconds": 1}))
    (bench / "metrics" / "conversions.test.py").write_text(
        '"""Conversions answered in the window."""\n\n\n'
        "def read(ctx):\n    return len(ctx.window.counted())\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "spark_rows_8col_test", "source": "a test",
        "file": "benchmarks/configs/spark_rows_8col_test.json",
        "reduced": ["rows"], "why": "a test configuration"})
    spec["workloads"].append({
        "name": "rows_8col.to_rows_test", "config": "spark_rows_8col_test",
        "traffic": "to_rows_test", "chips": 1, "why": "a test cell"})
    spec["end_to_end"].append({
        "name": "conversions.test", "unit": "conversions",
        "better": "higher", "bound": 0.05, "source": "host_clock",
        "workloads": ["rows_8col.to_rows_test"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    spec = S.load_spec(root)
    cell = S.find_cell(spec, "rows_8col.to_rows_test")
    files = S.cell_files(spec, cell, bench)
    assert files["config"].name == "spark_rows_8col_test.json"
    assert files["traffic"].name == "to_rows_test.json"
    assert files["metric:conversions.test"].is_file()
    line = run_small("rows_8col.to_rows_test", seconds=0.3, bench_dir=bench)
    assert line["correct"]
    got = line["metrics"]["conversions.test"]
    assert got["value"] == line["attempted"] > 0
    assert set(line["metrics"]) == {"setup_s", "conversions.test"}
