"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a small size, with one fault planted where the answer
is produced: a row byte altered, half of the rows left out, a returned
value altered.
"""

import pytest

from bench_small import run_small


@pytest.mark.parametrize("cell", ["rows_32col.roundtrip",
                                  "rows_32col.to_rows"])
def test_row_byte_altered_is_caught(cell, monkeypatch):
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    real = rc.convert_to_rows

    def broken(table):
        out = real(table)
        out[0].child.data[5] ^= 0x10  # a byte of the first row's int64
        return out
    monkeypatch.setattr(rc, "convert_to_rows", broken)
    line = run_small(cell, seconds=0.3)
    assert not line["correct"]
    assert line["checks"]["row_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", ["rows_32col.roundtrip",
                                  "rows_32col.to_rows"])
def test_half_the_rows_left_out_is_caught(cell, monkeypatch):
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    real = rc.convert_to_rows

    def broken(table):
        out = real(table)
        b = out[0]
        half = b.size // 2
        row = b.child.size // b.size
        return [Column.list_of_int8(b.child.data[:half * row],
                                    b.offsets.data[:half + 1])]
    monkeypatch.setattr(rc, "convert_to_rows", broken)
    line = run_small(cell, seconds=0.3)
    assert not line["correct"]
    assert line["checks"]["row_mismatches"]["value"] > 0


def test_returned_value_altered_is_caught(monkeypatch):
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    real = rc.convert_from_rows

    def broken(rows, schema):
        out = real(rows, schema)
        out.columns[1].data[-1] += 1.0  # the last row's first float64
        return out
    monkeypatch.setattr(rc, "convert_from_rows", broken)
    line = run_small("rows_32col.roundtrip", seconds=0.3,
                     seed=2**31 + 3)
    assert not line["correct"]
    assert line["checks"]["column_mismatches"]["value"] > 0
    assert line["checks"]["row_mismatches"]["value"] == 0


@pytest.mark.parametrize("cell", ["rows_32col.roundtrip",
                                  "rows_32col.to_rows"])
def test_sound_row_runs_are_correct(cell):
    line = run_small(cell, seconds=0.3)
    assert line["correct"]
    assert all(c["value"] == 0 for c in line["checks"].values())
