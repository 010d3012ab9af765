"""Regular expressions of the PyTorch/CUDA port against the JAX package on
the same inputs (on the CPU): ``regexp_contains`` and
``regexp_full_match`` byte-equal for every pattern of
``tests/test_regexp.py`` and more, the host route taken for exactly the
patterns the reference sends there (``regexp.host_fallback_calls``), and
``regexp_extract``. Both are also held against Python's ``re``.
"""

import re

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.ops import regexp as ref_rx
from spark_rapids_jni_tpu.utils.tracing import kernel_stats as ref_stats

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.ops import regexp as rx

CPU = torch.device("cpu")
# tests/test_regexp.py's patterns, then the host-route ones and more
PATTERNS = [
    "abc", "a.c", "a*", "ab+c", "colou?r", "[0-9]+", "[^0-9]+",
    "[a-cx-z]b", r"\d+\.\d+", r"\w+@\w+", "(cat|dog)s?", "a(b|c)*d",
    "^start", "end$", "^full$", r"\s", "x.*y", "(?:ab)+",
    r"(a)b\1", "a|b$", "^a|b", "^b|zz", "café", "[à]", "日本", ".", "..",
    "[^x]+", "a{2}", "(a|b|c|d|e|f|g|h|i|j|k|l|m|n|o|p)+z", r"^[a-z]+\d*$",
    r"[\w\s]+", r"(ab|cd)*(e|f)?$", r"\D\S\W", "a+?", r"[\]a]", "q"]
FALLBACK = "regexp.host_fallback_calls"


@pytest.fixture(scope="module")
def columns():
    rng = np.random.default_rng(61)
    alphabet = list("abcdxyz019. @\t-_]") + [
        "cat", "dog", "start", "end", "colour", "color", "3.14", "é",
        "日本", "aa", "ü", "café", "à"]
    strs = ["".join(str(rng.choice(alphabet))
                    for _ in range(int(rng.integers(0, 9))))
            for _ in range(1500)]
    strs += ["", None, "start middle end", "full", "aba", "abc"]
    return strs, RefColumn.strings_from_list(strs), \
        Column.strings_from_list(strs, device=CPU)


def _python(strs, pattern, full):
    # on the device \d \w \s are ASCII classes, as Java's are and as
    # re's are with re.ASCII; the host route is re itself
    try:
        rx._get_compiled(pattern)
        flags = re.ASCII
    except rx._Unsupported:
        flags = 0
    rx_ = re.compile(pattern, flags)
    fn = rx_.fullmatch if full else rx_.search
    return [None if s is None else int(bool(fn(s))) for s in strs]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regexp_matches_reference_and_re(columns, pattern):
    strs, ref, col = columns
    for fn, full in ((rx.regexp_contains, False),
                     (rx.regexp_full_match, True)):
        ref_fn = getattr(ref_rx, fn.__name__)
        before, ref_before = kernel_stats(), ref_stats()
        got = fn(col, pattern).to_pylist()
        ours = stats_since(before).get(FALLBACK, 0)
        want = ref_fn(ref, pattern).to_pylist()
        theirs = ref_stats().get(FALLBACK, 0) - ref_before.get(FALLBACK, 0)
        assert got == want
        assert ours == theirs
        if not (full and re.search(r"^\^|\$$", pattern)):
            assert got == _python(strs, pattern, full)


def test_device_patterns_never_take_the_host_route(columns):
    _, _, col = columns
    before = kernel_stats()
    for p in PATTERNS[:18]:
        rx.regexp_contains(col, p)
        rx.regexp_full_match(col, p)
    assert stats_since(before).get(FALLBACK, 0) == 0


@pytest.mark.parametrize("pattern", ["", "^$"])
def test_empty_patterns_match_re(columns, pattern):
    # the reference's compiler has no predicate to stack for these and
    # raises; the port answers as Python's re does
    strs, _, col = columns
    for fn, full in ((rx.regexp_contains, False),
                     (rx.regexp_full_match, True)):
        assert fn(col, pattern).to_pylist() == _python(strs, pattern, full)


@pytest.mark.parametrize("pattern,group", [(r"(\d+)\.(\d+)", 1),
                                           (r"(\d+)\.(\d+)", 2),
                                           (r"(a|b)+(c)?", 2),
                                           (r"([a-z]+)@", 1)])
def test_regexp_extract_matches_reference(columns, pattern, group):
    _, ref, col = columns
    assert rx.regexp_extract(col, pattern, group).to_pylist() == \
        ref_rx.regexp_extract(ref, pattern, group).to_pylist()


def test_step_tables_fold_every_transition():
    # each group table entry is the union of the transitions' targets out
    # of the states of its subset
    preds, trans, *_ = rx._get_compiled("(cat|dog)s?|x.*y")
    tables = rx._step_tables("(cat|dog)s?|x.*y")
    for b in (ord("c"), ord("x"), ord("s"), 0xC3, 0xA9):
        for src in range(8 * tables.shape[0]):
            want = 0
            for s, pi, dst in trans:
                if s == src and preds[pi].mask[b]:
                    want |= dst
            assert tables[src // 8, b, 1 << (src % 8)] == want
