"""Every file the benchmark names loads, and BENCHMARK.json keeps to
the shape the harness reads."""

import json
import re

import pytest

from harness import spec as S

SPEC = S.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [c["name"] for c in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((S.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert key in data, f"{key} is reduced but not in the file"
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = S.find_cell(SPEC, cell)
    files = S.cell_files(SPEC, c)
    for role, path in files.items():
        assert path.is_file(), role
    traffic = S.load_traffic(c["traffic"])
    driver = S.load_driver(traffic["driver"])
    for fn in ("setup", "window", "check", "launches", "control"):
        assert callable(getattr(driver, fn))
    assert c["chips"] == 1


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers_load(metric):
    assert callable(S.load_metric(metric["name"]).read)
    assert metric["better"] in ("lower", "higher")
    assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", metric["unit"])
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_layers_move(cell):
    e2e = {m["name"] for m in S.end_to_end_metrics(SPEC, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = S.per_layer_metrics(SPEC, cell)
    assert layers
    for m in layers:
        assert m["moves"] in e2e


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in SPEC["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
