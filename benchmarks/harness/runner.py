"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line.

A run with ``trace`` off reports the cell's end-to-end metrics over
one window of ``seconds``. A run with ``trace`` on reports the cell's
per-layer metrics from three windows of ``trace_seconds`` (the traffic
file's, at most ``seconds``; the last at most ``HOST_TRACE_SECONDS``),
each read for what it alone measures:

1. untraced: the host's pace, the yardstick the traced windows' paces
   are set beside (the result's ``pace``);
2. ``torch.profiler`` recording the device alone: each device
   operation's time, the device's busy time and its idle share in that
   same window;
3. the profiler recording the host and the device, with the program's
   ranges (``SRT_TRACE_ENABLED``) and the benchmark's on: the device's
   time inside the benchmark's ranges, what the host did in each idle
   gap.

Every request of every window is judged against the reference.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import spec as S
from .trace import (WINDOW_RANGE, Trace, device_only, from_profiler,
                    hand_kernel_count)

FORBIDDEN = ("jax", "jaxlib", "flax", "spark_rapids_jni_tpu")
HOST_TRACE_SECONDS = 1.5  # the host-and-device trace's window, at most


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare_env(root: Path, traffic: dict) -> None:
    """The program's environment, set before it is imported: its knobs
    at their defaults but for the traffic's own, its metrics and its
    profiler ranges off (a traced run turns the ranges on for the window
    that reads them), and every build and kernel cache at a fixed
    directory inside the checkout."""
    for k in [k for k in os.environ if k.startswith("SRT_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in traffic.get("env", {}).items()})
    os.environ["SRT_METRICS"] = "0"
    os.environ["SRT_TRACE_ENABLED"] = "0"
    cache = Path(root) / "target" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


@dataclass
class Context:
    """What a metric's reader may read."""

    cell: str
    config: dict
    traffic: dict
    setup_s: float
    peak_bytes: int
    window: Any
    trace: Optional[Trace] = None
    trace_complete: bool = False
    host_trace: Optional[Trace] = None


def _traced_window(driver, state, length: float, cuda: bool):
    """A window under a profiler of the device's activity alone: each
    device operation's time, and the device's busy time and idle share
    over this same window. The profiler slows the host's launches, so
    no host pace is read from it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    launched = driver.launches(state)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        win = driver.window(state, length, traced=False)
        if cuda:
            torch.cuda.synchronize()
        length_s = time.perf_counter() - t
    launched = driver.launches(state) - launched
    return win, device_only(prof, length_s), launched


def _host_traced_window(driver, state, length: float, cuda: bool):
    """A shorter window under a profiler of the host and the device,
    with the benchmark's ranges: it places the device's operations
    inside the calls that launched them and names what the host did in
    each idle gap. The host runs slower under it; no time of its own is
    read from it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    launched = driver.launches(state)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_RANGE):
            win = driver.window(state, length, traced=True)
            if cuda:
                torch.cuda.synchronize()
    launched = driver.launches(state) - launched
    return win, from_profiler(prof), launched


def _saw_every_launch(tr: Trace, launched: int, what: str) -> bool:
    seen = hand_kernel_count(tr)
    if seen != launched:
        print(f"bench: the profiler of the {what} saw {seen} of {launched} "
              "hand-kernel launches; the metrics read from that trace are "
              "left out", file=sys.stderr)
    return seen == launched


def _merged(win, more):
    """The window with the host-traced window's requests after it: every
    answer of the run is judged."""
    if not more:
        return win
    out = copy.copy(win)
    out.requests = list(win.requests) + list(more)
    return out


def _pace(win) -> Optional[float]:
    """Requests answered a second over a window."""
    return len(win.counted()) / win.seconds if win.seconds > 0 else None


def run_cell(spec: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str, t0: float, split: dict,
             config: Optional[dict] = None,
             traffic: Optional[dict] = None,
             bench_dir: Path = S.BENCH_DIR) -> dict:
    """Run ``cell`` once and return its result line (a dict). ``config``
    and ``traffic`` replace the cell's files (the CPU tests' small
    sizes); ``t0`` is the process's start on ``time.perf_counter``."""
    import torch
    name = cell["name"]
    config = config or S.load_config(cell["config"], bench_dir)
    traffic = traffic or S.load_traffic(cell["traffic"], bench_dir)
    driver = S.load_driver(traffic["driver"], bench_dir)
    cuda = torch.device(device).type == "cuda"

    state = driver.setup(config, traffic, seed, device, split)
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    length = min(seconds, traffic.get("trace_seconds", seconds)) \
        if trace else seconds
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    win = driver.window(state, length, traced=False)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    tr = host_tr = trace_win = None
    complete, more = False, []
    if trace:
        trace_win, tr, launched = _traced_window(driver, state, length,
                                                 cuda)
        complete = _saw_every_launch(tr, launched, "device")
        os.environ["SRT_TRACE_ENABLED"] = "1"
        host_win, host_tr, launched = _host_traced_window(
            driver, state, min(length, HOST_TRACE_SECONDS), cuda)
        os.environ["SRT_TRACE_ENABLED"] = "0"
        if not _saw_every_launch(host_tr, launched, "host and device"):
            host_tr = None
        more = trace_win.requests + host_win.requests

    run_peak = torch.cuda.max_memory_allocated() if cuda else 0
    t = time.perf_counter()
    checks, failed = driver.check(state, _merged(win, more))
    check_s = time.perf_counter() - t
    del state
    ctx = Context(cell=name, config=config, traffic=traffic,
                  setup_s=setup_s, peak_bytes=peak,
                  window=win, trace=tr, trace_complete=complete, host_trace=host_tr)
    wanted = (S.per_layer_metrics(spec, name) if trace
              else S.end_to_end_metrics(spec, name))
    metrics = {}
    for m in wanted:
        v = S.load_metric(m["name"], bench_dir).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": cell["chips"] if cuda else 0,
                   "memory_peak_bytes": max(run_peak, setup_peak)}
    line: Dict[str, Any] = {
        "correct": all(c["value"] <= c["limit"] for c in checks),
        "attempted": len(win.requests) + len(more), "failed": failed,
        "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_us() / 1e6
        device_info["window_s"] = tr.window_us / 1e6
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": (host_tr.gaps_by_host_op()
                                           if host_tr is not None else [])}
        line["trace_complete"] = complete
        line["pace"] = {"untraced_per_s": _pace(win),
                        "device_traced_per_s": _pace(trace_win)}
    line["setup_split"] = split
    line["check_s"] = check_s
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    return line


def emit(line: dict) -> None:
    """Each number compared beside its limit as the last lines on
    standard error, then the result line as the last line on standard
    output."""
    for k, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
