"""get_json_object of the PyTorch/CUDA port against the JAX package on the
same inputs (on the CPU).

Mirrors ``test_get_json_object.py``: the path semantics, surrogate
pairs, invalid UTF-8 and truncated escapes, the 60-document fuzz corpus
with its nine paths, where the device route must equal the port's own
Python walker and the reference row for row, and the native library's
walker (both libraries built and loaded on the CPU) against the Python
walker and the reference's native walker. Then the port's own parts: the
log-step running max/min against ``torch.cummax``/``cummin``, chunked
rows, the host routes' counters and the quoted-name routes.
"""

import importlib
import json
import random

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.ops.get_json_object import \
    get_json_object as ref_get_json_object

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.ops import get_json_object as gjo_fn
from spark_rapids_jni_tpu_torch.ops.get_json_object import (
    _device_eval, _parse_path, _python_eval, _running, _running_sum,
    get_json_object)

from torch_native_support import (native_libraries,  # noqa: F401
                                  reference_native)

# the module (``ops`` exports the function under the module's name)
gjo = importlib.import_module("spark_rapids_jni_tpu_torch.ops.get_json_object")
CPU = torch.device("cpu")

DOCS = [
    '{"a": 1, "b": "x"}',
    '{"a": {"b": [10, 20, {"c": "deep"}]}}',
    '{"s": "he said \\"hi\\"\\n"}',
    '{"arr": [1, 2.5, true, null, "five"]}',
    '{"a": null}',
    'not json at all',
    '{"num": -12.5e3}',
    '{"obj": {"k": 1}, "l": [1,2]}',
    '{"u": "\\u00e9\\u4e2d"}',
    '',
    None,
    '{"a" : { "b" : "spaced" } }',
]


def _col(docs):
    return Column.strings_from_list(docs, device=CPU)


@pytest.mark.parametrize("path,expected", [
    ("$.a", ["1", '{"b": [10, 20, {"c": "deep"}]}', None, None, None, None,
             None, None, None, None, None, '{ "b" : "spaced" }']),
    ("$.a.b", [None, '[10, 20, {"c": "deep"}]', None, None, None, None,
               None, None, None, None, None, "spaced"]),
    ("$.a.b[1]", [None, "20", None, None, None, None, None, None, None,
                  None, None, None]),
    ("$.a.b[2].c", [None, "deep", None, None, None, None, None, None, None,
                    None, None, None]),
    ("$.s", [None, None, 'he said "hi"\n', None, None, None, None, None,
             None, None, None, None]),
    ("$.arr[3]", [None] * 12),  # JSON null -> SQL NULL
    ("$.arr[4]", [None, None, None, "five", None, None, None, None, None,
                  None, None, None]),
    ("$.num", [None, None, None, None, None, None, "-12.5e3", None, None,
               None, None, None]),
    ("$.l", [None, None, None, None, None, None, None, "[1,2]", None,
             None, None, None]),
    ("$.u", [None, None, None, None, None, None, None, None, "é中", None,
             None, None]),
])
def test_get_json_object_semantics(path, expected):
    out = get_json_object(_col(DOCS), path)
    assert out.to_pylist() == expected
    assert out.to_pylist() == ref_get_json_object(
        RefColumn.strings_from_list(DOCS), path).to_pylist()


def test_invalid_path_all_null():
    assert get_json_object(_col(DOCS), "a.b").to_pylist() == \
        [None] * len(DOCS)


def test_package_exports_the_function():
    assert gjo_fn is get_json_object


def test_surrogate_pair_escapes():
    docs = [
        json.dumps({"a": "😀"}),
        '{"a": "\\ud83d\\ude00"}',
        '{"a": "\\ud800"}',
        '{"a": "\\udc00tail"}',
        json.dumps({"a": "mix😀é\U0001F680"}),
    ]
    out = get_json_object(_col(docs), "$.a").to_pylist()
    assert out == ["😀", "😀", "�", "�tail", "mix😀é\U0001F680"]
    steps = _parse_path("$.a")
    assert _python_eval(_col(docs), steps).to_pylist() == out


def test_invalid_utf8_expansion_does_not_crash():
    doc = b'{"a": "\\n' + b"\xff" * 10 + b'"}'
    out = get_json_object(_col([doc, b'{"a": "x"}']), "$.a").to_pylist()
    assert out[0] == "\n" + "�" * 10
    assert out[1] == "x"


def test_truncated_unicode_escape():
    out = get_json_object(_col(['{"a": "tail\\u123"}']), "$.a").to_pylist()
    assert "ģ" not in (out[0] or "")
    assert out == ref_get_json_object(RefColumn.strings_from_list(
        ['{"a": "tail\\u123"}']), "$.a").to_pylist()


def _fuzz_docs():
    rnd = random.Random(42)

    def rand_value(depth):
        r = rnd.random()
        if depth > 2 or r < 0.25:
            return rnd.choice([
                1, -3.5, 12345678, True, False, None, "plain",
                'quote"inside', "tab\there", "unié", "", "emoji😀x",
                "\U0001F680 rocket"])
        if r < 0.55:
            return {rnd.choice("abcde"): rand_value(depth + 1)
                    for _ in range(rnd.randint(0, 3))}
        return [rand_value(depth + 1) for _ in range(rnd.randint(0, 3))]

    docs = []
    for _ in range(60):
        v = {k: rand_value(0) for k in "abc"}
        s = json.dumps(v)
        if rnd.random() < 0.3:
            s = json.dumps(v, indent=rnd.choice([None, 1, 2]))
        docs.append(s)
    return docs + ["", None, "broken{", "[1,2", '{"a"}', "   42  ", '"top"']


FUZZ_PATHS = ["$.a", "$.b", "$.a.b", "$.a[0]", "$.a[1].c", "$.c.d.e", "$[0]",
              "$", "$.a.b[2]"]


@pytest.fixture(scope="module")
def fuzz():
    docs = _fuzz_docs()
    return docs, _col(docs), RefColumn.strings_from_list(docs)


@pytest.mark.parametrize("path", FUZZ_PATHS)
def test_device_python_and_reference_agree_fuzz(fuzz, path):
    _, col, ref = fuzz
    steps = _parse_path(path)
    dev = _device_eval(col, steps).to_pylist()
    py = _python_eval(col, steps).to_pylist()
    assert dev == py, (path, [(i, d, p) for i, (d, p)
                              in enumerate(zip(dev, py)) if d != p][:5])
    assert dev == ref_get_json_object(ref, path).to_pylist()


def test_chunks_give_the_same_rows(fuzz, monkeypatch):
    _, col, _ = fuzz
    whole = {p: get_json_object(col, p).to_pylist() for p in FUZZ_PATHS}
    monkeypatch.setattr(gjo, "CHUNK_CELLS", 700)  # a few rows a chunk
    for p in FUZZ_PATHS:
        assert get_json_object(col, p).to_pylist() == whole[p], p


@pytest.mark.parametrize("width", [1, 2, 7, 64, 129])
def test_running_max_and_min_equal_torch_scans(width):
    g = torch.Generator().manual_seed(width)
    x = torch.randint(-50, 50, (33, width), generator=g, dtype=torch.int16)
    assert torch.equal(_running(x, torch.maximum),
                       torch.cummax(x, dim=1).values)
    want = torch.cummin(x.flip(1), dim=1).values.flip(1)
    assert torch.equal(_running(x, torch.minimum, reverse=True), want)


@pytest.mark.parametrize("width", [1, 5, 128, 129, 300])
def test_running_sum_equals_cumsum(width):
    g = torch.Generator().manual_seed(width)
    x = torch.randint(-1, 2, (17, width), generator=g, dtype=torch.int16)
    for pdt in (torch.int16, torch.int32):
        assert torch.equal(_running_sum(x, pdt),
                           torch.cumsum(x, 1, dtype=pdt))
    b = x > 0
    assert torch.equal(_running_sum(b, torch.int16),
                       torch.cumsum(b, 1, dtype=torch.int16))


def test_long_field_names_and_documents():
    # a name as long as the widest document, and documents wider than
    # one 128-column block of the running sums
    name = "n" * 150
    docs = ['{"%s": 1}' % name, '{"a": [%s]}' % ",".join(["7"] * 100),
            '{"%s": {"x": "y"}}' % ("m" * 200)]
    col, ref = _col(docs), RefColumn.strings_from_list(docs)
    for path in ("$." + name, "$.a[99]", "$.a[0]", "$.%s.x" % ("m" * 200)):
        assert get_json_object(col, path).to_pylist() == \
            ref_get_json_object(ref, path).to_pylist(), path
    # a name longer than the widest document: the reference's shifted
    # compare fails on its shapes there; the port matches nothing, as
    # its walker does
    path = "$." + "n" * 300
    assert get_json_object(col, path).to_pylist() == [None] * 3
    assert _python_eval(col, _parse_path(path)).to_pylist() == [None] * 3


def test_host_routes_are_counted(monkeypatch):
    # without the native library in the process, whatever another test
    # of this worker loaded
    monkeypatch.setattr(gjo.native, "_LIB", None)
    docs = ['{"a": "x\\ty"}', '{"a": "plain"}', '{"a": "\\u00e9"}', None]
    before = kernel_stats()
    out = get_json_object(_col(docs), "$.a")
    stats = stats_since(before)
    assert out.to_pylist() == ["x\ty", "plain", "é", None]
    assert stats.get("get_json_object.host_unescape_rows") == 2
    assert "get_json_object.python_walker_rows" not in stats
    # a field name with a quote takes the Python walker, as in the
    # reference
    before = kernel_stats()
    qdocs = ['{"k\\"q": 5}', '{"k\\"q": [1]}', '{"x": 1}']
    got = get_json_object(_col(qdocs), "$['k\\\"q']").to_pylist()
    stats = stats_since(before)
    assert stats.get("get_json_object.python_walker_rows") == 3
    assert got == ref_get_json_object(RefColumn.strings_from_list(qdocs),
                                      "$['k\\\"q']").to_pylist()


def test_output_is_assembled_with_validity_of_its_rows():
    out = get_json_object(_col(DOCS), "$.a")
    assert out.validity is not None
    np.testing.assert_array_equal(
        out.valid_bool().numpy(),
        [v is not None for v in out.to_pylist()])
    all_hit = get_json_object(_col(['{"a": 1}', '{"a": "x"}']), "$.a")
    assert all_hit.validity is None  # no null row, no mask
    assert get_json_object(_col([]), "$.a").size == 0


@pytest.mark.parametrize("seed", [1, 2])
def test_seeded_documents_equal_reference(seed):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(300):
        v = {"a": {"b": [int(rng.integers(100)), {"c": "s" * (i % 5)}]},
             "k": "v\\n" if i % 17 == 0 else "w", "n": None}
        s = json.dumps(v, indent=None if i % 3 else 1)
        if i % 23 == 0:
            s = s[:-3]  # truncated
        docs.append(None if i % 10 == 0 else s)
    col, ref = _col(docs), RefColumn.strings_from_list(docs)
    for path in ["$.a", "$.a.b", "$.a.b[1].c", "$.a.b[0]", "$['k']", "$.n",
                 "$.zz", "$.a.b[5]"]:
        assert get_json_object(col, path).to_pylist() == \
            ref_get_json_object(ref, path).to_pylist(), path


# --------------------------------------------------------------------------
# the native walker (src/main/cpp/src/get_json_object.cpp in the port's
# library), both libraries loaded on the CPU
# --------------------------------------------------------------------------

NATIVE_PATHS = ["$.a", "$.a.b", "$.a.b[0]", "$.a.b[2].c", "$.s", "$.arr[2]",
                "$.obj", "$['a']", "$.u"]


def test_native_and_python_agree(native_libraries,  # noqa: F811
                                 reference_native):  # noqa: F811
    from spark_rapids_jni_tpu.ops.get_json_object import \
        _native_eval as ref_native_eval
    from spark_rapids_jni_tpu.ops.get_json_object import \
        _parse_path as ref_parse_path
    col, ref = _col(DOCS), RefColumn.strings_from_list(DOCS)
    for path in NATIVE_PATHS:
        nat = gjo._native_eval(col, path).to_pylist()
        assert nat == _python_eval(col, _parse_path(path)).to_pylist(), path
        assert nat == ref_native_eval(ref, path,
                                      ref_parse_path(path)).to_pylist(), path


def test_native_surrogate_pairs_agree(native_libraries):  # noqa: F811
    docs = [json.dumps({"a": "😀"}), '{"a": "\\ud83d\\ude00"}',
            '{"a": "\\ud800"}', '{"a": "\\udc00t"}', '{"a": "\\u+123"}',
            json.dumps({"a": "mix😀é"})]
    col = _col(docs)
    assert gjo._native_eval(col, "$.a").to_pylist() == \
        _python_eval(col, _parse_path("$.a")).to_pylist()


def test_quoted_names_take_the_native_walker(native_libraries,  # noqa: F811
                                             reference_native):  # noqa: F811
    """With the library loaded, a field name holding a quote or a
    backslash takes the native walker (no Python walker rows), as the
    reference routes it; the rows equal the reference's."""
    qdocs = ['{"k\\"q": 5}', '{"k\\"q": [1]}', '{"x": 1}', None,
             '{"b\\\\s": "v"}']
    for path in ("$['k\\\"q']", "$['b\\\\s']"):
        before = kernel_stats()
        got = get_json_object(_col(qdocs), path).to_pylist()
        assert "get_json_object.python_walker_rows" not in \
            stats_since(before)
        assert got == ref_get_json_object(RefColumn.strings_from_list(qdocs),
                                          path).to_pylist(), path
