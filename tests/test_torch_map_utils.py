"""from_json -> MAP of the PyTorch/CUDA port against the JAX package on the
same inputs (on the CPU).

Mirrors every case of ``test_map_utils.py``, then holds seeded corpora
(the get_json_object fuzz documents, objects with escapes, duplicates,
nested values and malformed rows) against the reference and Python's
``json``: keys, values, offsets and row validity equal.
"""

import json
import random

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.ops import map_utils as ref_map

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.ops.map_utils import (
    from_json_to_map, get_map_value, map_keys, map_to_pylist, map_values)

CPU = torch.device("cpu")


def _col(rows):
    return Column.strings_from_list(rows, device=CPU)


def test_basic_objects():
    rows = ['{"a": "1", "b": "x"}', '{}', '{"k": 42}',
            '{"s": "he said \\"hi\\""}']
    assert map_to_pylist(from_json_to_map(_col(rows))) == [
        {"a": "1", "b": "x"}, {}, {"k": "42"}, {"s": 'he said "hi"'}]


def test_scalar_value_forms():
    m = from_json_to_map(_col(
        ['{"i": -17, "f": 2.5e3, "t": true, "fa": false, "n": null}']))
    assert map_to_pylist(m)[0] == {"i": "-17", "f": "2.5e3", "t": "true",
                                   "fa": "false", "n": None}


def test_nested_values_keep_raw_json():
    got = map_to_pylist(from_json_to_map(_col(
        ['{"o": {"x": [1, 2]}, "a": [true, "s"]}'])))[0]
    assert json.loads(got["o"]) == {"x": [1, 2]}
    assert json.loads(got["a"]) == [True, "s"]


def test_invalid_rows_null():
    rows = ['[1,2]', '"str"', '17', 'nope', '{"a": }', '{"a": 1',
            '{"a": 1} tail', '{1: 2}', '{"a": nope}', '{"a": truefalse}',
            '{"a": 01}', None]
    assert map_to_pylist(from_json_to_map(_col(rows))) == [None] * len(rows)


def test_whitespace_and_duplicates():
    m = from_json_to_map(_col(['  { "a" : 1 , "a" : 2 }  ']))
    assert map_keys(m).to_pylist() == ["a", "a"]
    assert map_values(m).to_pylist() == ["1", "2"]
    assert map_to_pylist(m) == [{"a": "2"}]


def test_get_map_value():
    m = from_json_to_map(_col(['{"a": "1", "b": "2"}', '{"b": "3"}', 'bad',
                               None]))
    assert get_map_value(m, "b").to_pylist() == ["2", "3", None, None]
    assert get_map_value(m, "a").to_pylist() == ["1", None, None, None]


def test_offsets_shape():
    m = from_json_to_map(_col(['{"a": 1, "b": 2}', '{}', '{"c": 3}']))
    np.testing.assert_array_equal(m.offsets.data.numpy(), [0, 2, 2, 3])
    assert m.size == 3


# --------------------------------------------------------------------------
# seeded corpora against the reference and Python's json
# --------------------------------------------------------------------------

def _corpus(seed, n):
    rnd = random.Random(seed)
    scalars = [1, -3.5, 1e21, True, False, None, "plain", 'q"uote',
               "tab\there", "unié", "", "😀", "back\\slash"]

    def value(depth):
        r = rnd.random()
        if depth > 1 or r < 0.6:
            return rnd.choice(scalars)
        if r < 0.8:
            return {rnd.choice("xyz"): value(depth + 1)
                    for _ in range(rnd.randint(0, 2))}
        return [value(depth + 1) for _ in range(rnd.randint(0, 2))]

    rows = []
    for _ in range(n):
        obj = {rnd.choice(["a", "b", "k é", 'q"k']): value(0)
               for _ in range(rnd.randint(0, 4))}
        s = json.dumps(obj, indent=rnd.choice([None, None, 1]),
                       ensure_ascii=rnd.random() < 0.5)
        r = rnd.random()
        if r < 0.05:
            s = s[:-1]  # truncated
        elif r < 0.08:
            s = s + " x"  # trailing garbage
        elif r < 0.1:
            s = '{"a": 1, "a": 2}'  # duplicates
        elif r < 0.12:
            s = None
        rows.append(s)
    return rows


def _same_map(got, want):
    np.testing.assert_array_equal(got.offsets.data.numpy(),
                                  np.asarray(want.children[0].data))
    np.testing.assert_array_equal(got.valid_bool().numpy(),
                                  np.asarray(want.valid_bool()))
    assert map_keys(got).to_pylist() == ref_map.map_keys(want).to_pylist()
    assert map_values(got).to_pylist() == \
        ref_map.map_values(want).to_pylist()
    assert got.child.field_names == ("key", "value")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_from_json_to_map_equals_reference_and_json(seed):
    rows = _corpus(seed, 400)
    got = from_json_to_map(_col(rows))
    _same_map(got, ref_map.from_json_to_map(RefColumn.strings_from_list(rows)))
    for r, d in zip(rows, map_to_pylist(got)):
        if d is None:
            continue
        want = json.loads(r)
        assert d.keys() == want.keys()
        for k, v in want.items():
            # strings unescaped; other values their raw JSON text
            if v is None or isinstance(v, str):
                assert d[k] == v
            else:
                assert json.loads(d[k]) == v
    for key in ("a", "b", 'q"k', "missing"):
        assert get_map_value(got, key).to_pylist() == ref_map.get_map_value(
            ref_map.from_json_to_map(RefColumn.strings_from_list(rows)),
            key).to_pylist()


def test_get_json_object_fuzz_documents_equal_reference():
    from test_torch_get_json_object import _fuzz_docs
    rows = _fuzz_docs()
    _same_map(from_json_to_map(_col(rows)),
              ref_map.from_json_to_map(RefColumn.strings_from_list(rows)))


def test_tokenizer_rows_are_counted():
    before = kernel_stats()
    m = from_json_to_map(_col(['{"a": 1}', None, "bad"]))
    assert stats_since(before).get("map_utils.host_tokenizer_rows") == 3
    assert m.validity is not None
    assert m.valid_bool().tolist() == [True, False, False]
    assert from_json_to_map(_col(['{"a": 1}'])).validity is None
    empty = from_json_to_map(_col([]))
    assert empty.size == 0 and empty.offsets.data.tolist() == [0]
