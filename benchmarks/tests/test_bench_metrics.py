"""The metric arithmetic on synthetic inputs."""

import pytest

from harness import readers, roofline
from harness.runner import Context
from harness.trace import Trace
from harness.window import Request, Window
from harness import spec as S


def _ctx(window=None, trace=None, config=None, peak=0, host_trace=None):
    return Context(cell="c", config=config or {}, traffic={},
                   setup_s=12.5, peak_bytes=peak,
                   window=window or Window(0.0, 1.0, 1.0),
                   trace=trace, trace_complete=trace is not None,
                   host_trace=host_trace)


def test_rate_is_over_the_whole_window():
    w = Window(start=10.0, close=12.0, end=12.5)
    w.requests = [Request("a", due=10.0 + i * 0.1, done=10.05 + i * 0.1,
                          work=1000) for i in range(25)]
    w.requests.append(Request("late", due=12.4, done=12.6, work=1000))
    w.requests.append(Request("err", due=11.0, done=11.1, work=1000,
                              error="boom"))
    assert readers.window_rate(_ctx(w)) == pytest.approx(25_000 / 2.5)
    assert S.load_metric("rows_per_s").read(_ctx(w)) == \
        pytest.approx(10_000.0)


def test_rows_rate_counts_work():
    w = Window(start=0.0, close=1.0, end=2.0)
    w.requests = [Request("r", due=0.0, done=1.0, work=12_000_000),
                  Request("r", due=1.0, done=2.0, work=12_000_000)]
    assert S.load_metric("rows_per_s").read(_ctx(w)) == 12_000_000


def _trace():
    # window 0-1000 us; ops at 100-300 and 200-400 (overlap), 600-700;
    # a hand kernel 800-850; a range's shadow on the device timeline
    ops = [(100, 300, "aten_gather_kernel"), (200, 400, "add_kernel"),
           (600, 700, "Memcpy DtoH"),
           (800, 850, "void pack_rows_kernel<4>(int*)")]
    host = [(0, 1000, "bench::window"), (50, 450, "bench::to_rows"),
            (450, 460, "aten::empty"), (500, 900, "bench::to_rows"),
            (510, 790, "aten::nonzero")]
    return Trace(window=(0.0, 1000.0), device_ops=ops, host_events=host,
                 ranges={"bench::window": [(0, 1000)],
                         "bench::to_rows": [(50, 450), (500, 900)]})


def test_busy_and_gaps_from_a_trace():
    tr = _trace()
    assert tr.busy_intervals() == [(100, 400), (600, 700), (800, 850)]
    assert tr.busy_us() == 450
    gaps = dict((k, v) for k, v in tr.gaps_by_host_op())
    assert sum(gaps.values()) == pytest.approx(550e-6)
    # gap mid-points 50, 500, 750, 925 us
    assert gaps == pytest.approx({"bench::to_rows": 300e-6,
                                  "bench::to_rows > aten::nonzero": 100e-6,
                                  "no host op": 150e-6})


def test_idle_over_the_device_traced_window():
    # 450 us busy in a 1000 us window: idle 55%
    ctx = _ctx(trace=_trace())
    assert readers.idle_share(ctx) == pytest.approx(55.0)
    assert S.load_metric("device_idle_share.rows").read(ctx) == \
        pytest.approx(55.0)
    # a device-only trace: its length from the host's clock
    dev = Trace(window=(float("-inf"), float("inf")),
                device_ops=[(5.0, 15.0, "k"), (10.0, 30.0, "k")],
                host_events=[], length_us=100.0)
    assert readers.idle_share(_ctx(trace=dev)) == pytest.approx(75.0)
    ctx.trace_complete = False
    assert readers.idle_share(ctx) is None
    assert readers.idle_share(_ctx()) is None


def test_row_bytes_of_the_32_column_schema():
    cfg = S.load_config("spark_rows_32col_12m")
    widths = [readers.TYPE_BYTES[t.partition(":")[0]]
              for t in cfg["types"]] * cfg["repeats"]
    size, starts, voff = roofline.row_layout(widths)
    assert size == cfg["row_bytes"] == 200
    assert starts[:8] == [0, 8, 16, 20, 24, 28, 32, 40] and voff == 192
    n = cfg["rows"]
    assert roofline.column_bytes(widths, n) == n * 152 + 32 * 4 * 375_000
    total = roofline.conversion_bytes(widths, n)
    assert total == 4_272_000_000
    assert roofline.least_seconds(total) * 1e3 == pytest.approx(1.2752,
                                                                abs=1e-4)


def test_conversion_roofline_reads_device_time_in_its_ranges():
    cfg = {"types": ["INT64"], "repeats": 1, "rows": 1_000_000}
    ctx = _ctx(host_trace=_trace(), config=cfg)
    least = 2 * roofline.least_seconds(roofline.conversion_bytes([8], 10**6))
    # inside the two ranges: 100-300, 200-400 (first), 600-700 and
    # 800-850 (second): 550 us of device time
    assert readers.conversion_roofline(ctx, "bench::to_rows") == \
        pytest.approx(100 * least / 550e-6)
    assert readers.conversion_roofline(ctx, "bench::from_rows") is None


def test_setup_and_peak():
    ctx = _ctx(peak=3 * 2**30)
    assert S.load_metric("setup_s").read(ctx) == 12.5
    assert S.load_metric("peak_device_gib").read(ctx) == 3.0


def test_a_device_only_trace_reads_its_window_from_the_host():
    tr = Trace(window=(float("-inf"), float("inf")),
               device_ops=[(5.0, 15.0, "k"), (10.0, 30.0, "k")],
               host_events=[], length_us=100.0)
    assert tr.busy_us() == 25.0 and tr.window_us == 100.0


def test_a_traced_run_sets_its_pace_beside_the_untraced():
    from bench_small import run_small
    line = run_small("rows_32col.to_rows", seconds=0.3, trace=True)
    assert line["correct"] and line["trace_complete"]
    pace = line["pace"]
    assert pace["untraced_per_s"] > 0 and pace["device_traced_per_s"] > 0
    dev = line["device"]
    assert line["metrics"]["device_idle_share.rows"]["value"] == \
        pytest.approx(100 * (1 - dev["busy_s"] / dev["window_s"]))
