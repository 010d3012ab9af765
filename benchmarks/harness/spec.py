"""Find everything of a cell by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``), and the mix names its driver
(``drivers/<driver>.py``). Every metric is a reader of its own,
``metrics/<name>.py``. A new cell, mix or metric is new files and new
entries: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_spec(root: Path = ROOT) -> dict:
    """The checkout's ``BENCHMARK.json``."""
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in spec['workloads']]}")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(Path(bench_dir) / "configs" / f"{name}.json")


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(Path(bench_dir) / "traffic" / f"{name}.json")


def _module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{label}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(Path(bench_dir) / "drivers" / f"{name}.py", "driver")


def load_metric(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader of metric ``name``: a module with ``read(ctx)``, which
    returns the value, or None where the run has nothing to read."""
    return _module(Path(bench_dir) / "metrics" / f"{name}.py", "metric")


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_metrics(spec: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports, in the file's order."""
    return [m for m in spec["end_to_end"] if _in_cell(m, cell)]


def per_layer_metrics(spec: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def cell_files(spec: dict, cell: dict, bench_dir: Path = BENCH_DIR
               ) -> Dict[str, Path]:
    """Every file a run of ``cell`` reads, by role."""
    traffic = load_traffic(cell["traffic"], bench_dir)
    files = {"config": Path(bench_dir) / "configs" / f"{cell['config']}.json",
             "traffic": Path(bench_dir) / "traffic" / f"{cell['traffic']}.json",
             "driver": Path(bench_dir) / "drivers" / f"{traffic['driver']}.py"}
    for m in (end_to_end_metrics(spec, cell["name"])
              + per_layer_metrics(spec, cell["name"])):
        files[f"metric:{m['name']}"] = (Path(bench_dir) / "metrics"
                                        / f"{m['name']}.py")
    return files
