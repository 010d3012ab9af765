"""The readers of the program's own ranges (``harness/program_spans``)
on synthetic traces, and on a traced CPU run of each cell."""

import pytest

from harness import program_spans as P
from harness import spec as S
from harness.runner import Context
from harness.trace import Trace
from harness.window import Window

TO_ROWS = "srt::row_conversion.convert_to_rows"
FROM_ROWS = "srt::row_conversion.convert_from_rows"
READERS = ("to_rows_host_us.rows", "from_rows_host_us.rows",
           "idle_in_program_share.rows")


def _ctx(host_trace):
    return Context(cell="c", config={}, traffic={}, setup_s=1.0,
                   peak_bytes=0, window=Window(0.0, 1.0, 1.0),
                   host_trace=host_trace)


def _trace(program=None):
    """Window 0-1000 us; the device busy 100-400 and 600-700, so idle
    0-100, 400-600 and 700-1000 (600 us); the benchmark's ranges, and
    the program's where given."""
    ranges = {"bench::window": [(0, 1000)],
              "bench::to_rows": [(0, 450), (450, 1000)]}
    ranges.update(program or {})
    host = sorted((s, e, n) for n, spans in ranges.items()
                  for s, e in spans)
    return Trace(window=(0.0, 1000.0),
                 device_ops=[(100, 400, "void pack_rows_kernel<4>(int*)"),
                             (600, 700, "direct_copy_kernel_cuda")],
                 host_events=host, ranges=ranges)


@pytest.mark.parametrize("name", READERS)
def test_no_program_range_reads_none(name):
    reader = S.load_metric(name)
    assert reader.read(_ctx(_trace())) is None
    assert reader.read(_ctx(None)) is None


def test_host_time_is_the_median_range():
    tr = _trace({TO_ROWS: [(0, 100), (200, 500), (600, 800)],
                 FROM_ROWS: [(100, 150), (300, 400)]})
    assert S.load_metric("to_rows_host_us.rows").read(_ctx(tr)) == 200
    assert S.load_metric("from_rows_host_us.rows").read(_ctx(tr)) == 75
    assert P.median_range_us(tr, "srt::absent") is None


def test_idle_share_counts_the_overlap_not_the_midpoint():
    # 50-250 covers 50 us of the first gap; 450-650 150 of the second,
    # with a nested step adding nothing; 900-1100 the gap's last 100,
    # the rest past the window
    tr = _trace({TO_ROWS: [(50, 250), (450, 650), (900, 1100)],
                 "srt::row_conversion.to_rows.pack": [(460, 500)]})
    assert P.idle_in_program_share(tr) == pytest.approx(50.0)
    assert S.load_metric("idle_in_program_share.rows").read(_ctx(tr)) == \
        pytest.approx(50.0)
    # a range inside a busy stretch covers no idle
    assert P.idle_in_program_share(
        _trace({TO_ROWS: [(120, 380)]})) == 0.0


def test_readers_are_entries_of_the_cells_that_read_them():
    spec = S.load_spec()
    for cell, want in (("rows_32col.roundtrip", set(READERS)),
                       ("rows_32col.to_rows",
                        set(READERS) - {"from_rows_host_us.rows"})):
        names = {m["name"] for m in S.per_layer_metrics(spec, cell)}
        assert names & set(READERS) == want


@pytest.mark.parametrize("cell", ["rows_32col.roundtrip",
                                  "rows_32col.to_rows"])
def test_a_traced_run_reads_the_programs_ranges(cell):
    from bench_small import run_small
    line = run_small(cell, seconds=0.3, trace=True)
    assert line["correct"]
    got = line["metrics"]
    want = S.per_layer_metrics(S.load_spec(), cell)
    for m in want:
        if m["name"] in READERS:
            assert got[m["name"]]["value"] >= 0, m["name"]
    # no device operation runs on the CPU: the window is idle throughout,
    # and the conversions cover part of it
    assert 0 < got["idle_in_program_share.rows"]["value"] <= 100
