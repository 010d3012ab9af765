"""TPC-DS by the specification on the port, on the CPU at a small size.

The generator's tables (``tpcds/spec_data.py``): clause 3's SF10 row
counts as data, the divided counts, the columns' types and domains, the
tickets' structure and the NULL shares. The null-aware routes: joins
(inner, left, semi, anti) and groupbys over nullable keys agree on the
fused dense route, the eager general route and the plain reference
(the benchmark's ``benchmarks/reference/tpcds.py``, loaded by path).
q1-q20 over the spec's tables through ``run_fused`` equal the plain
reference, fused wherever a nullable key was the only obstacle. Over the miniature, q1-q20 give what they gave
before the spec's tables came (digests of their frames).
"""

import decimal
import hashlib
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_jni_tpu_torch.columnar import Column, Table, bitmask
from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.tpcds import PLANS, generate
from spark_rapids_jni_tpu_torch.tpcds import spec_data as SD
from spark_rapids_jni_tpu_torch.tpcds.data import ingest
from spark_rapids_jni_tpu_torch.tpcds.rel import Rel, run_fused
from spark_rapids_jni_tpu_torch.types import INT32, INT64, TypeId

_REFERENCE = (Path(__file__).resolve().parents[1] / "benchmarks"
              / "reference" / "tpcds.py")
_spec = importlib.util.spec_from_file_location("benchmark_reference_tpcds",
                                               _REFERENCE)
R = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = R
_spec.loader.exec_module(R)

SEED = 2**31 + 11
DIVISOR = 2000
QUERIES = [f"q{i}" for i in range(1, 21)]

# clause 3's rows at SF10, written out again
SF10 = {"store_sales": 28_800_991, "store_returns": 2_875_432,
        "catalog_sales": 14_401_261, "web_sales": 7_197_566,
        "customer": 500_000, "customer_address": 250_000,
        "customer_demographics": 1_920_800, "item": 102_000, "store": 102,
        "promotion": 500, "date_dim": 73_049}
# clause 2's column counts of the tables generated
COLUMNS = {"store_sales": 23, "store_returns": 20, "catalog_sales": 34,
           "web_sales": 34, "customer": 18, "customer_address": 13,
           "customer_demographics": 9, "item": 22, "store": 29,
           "promotion": 19, "date_dim": 28}
# the queries whose plans need the general route at any size: a groupby
# over i_brand_id (9,015,010 values wide) with a second key
GENERAL_AT_ANY_SIZE = {"q3", "q17"}


@pytest.fixture(scope="module")
def spec():
    rels = SD.generate_spec(10, seed=SEED, device="cpu", divisor=DIVISOR)
    return rels, R.read_tables(rels)


def _valid(col: Column) -> np.ndarray:
    if col.validity is None:
        return np.ones(col.size, bool)
    return bitmask.unpack(col.validity, col.size).numpy()


# --------------------------------------------------------------------------
# The generator
# --------------------------------------------------------------------------

def test_sf10_row_counts_are_clause_3s():
    assert SD.SPEC_ROWS[10] == SF10
    assert SD.row_counts(10) == SF10


def test_divided_row_counts(spec):
    rels, _ = spec
    want = SD.row_counts(10, DIVISOR)
    assert {n: r.num_rows for n, r in rels.items()} == want
    assert want["date_dim"] == SF10["date_dim"]
    assert want["customer_demographics"] == SF10["customer_demographics"]
    assert want["store_sales"] == -(-SF10["store_sales"] // DIVISOR)
    assert want["store"] == 102 and want["promotion"] == 500


def test_columns_and_types(spec):
    rels, _ = spec
    assert {n: len(r.names) for n, r in rels.items()} == COLUMNS
    ss = rels["store_sales"]
    for name in ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                 "ss_ticket_number", "ss_quantity"):
        assert ss.col(name).dtype == INT32, name
    for name in ("ss_list_price", "ss_sales_price", "ss_ext_sales_price",
                 "ss_coupon_amt", "ss_net_profit"):
        dt = ss.col(name).dtype
        assert dt.id == TypeId.DECIMAL32 and dt.scale == -2, name
    for table, name in (("customer_demographics", "cd_gender"),
                        ("customer_address", "ca_zip"),
                        ("item", "i_product_name"), ("store", "s_state")):
        r = rels[table]
        cats = r.dicts[name]
        assert r.col(name).dtype == INT64
        assert list(cats) == sorted(set(cats))  # code order = string order
    assert rels["date_dim"].col("d_date").dtype.id == TypeId.TIMESTAMP_DAYS
    assert rels["promotion"].col("p_cost").dtype.id == TypeId.DECIMAL64


def test_domains_and_stats(spec):
    rels, _ = spec
    for name, r in rels.items():
        for cname, c in zip(r.names, r.table.columns):
            if c.value_range is None:
                continue
            lo, hi = c.value_range
            ok = _valid(c)
            d = c.data.numpy()[ok]
            assert d.size == 0 or (d.min() >= lo and d.max() <= hi), cname
            assert c._stats_flags[0], cname
    dd = rels["date_dim"].to_df()
    assert dd.d_date_sk.iloc[0] == 2_415_022 and dd.d_year.iloc[0] == 1900
    assert dd.d_date_sk.iloc[-1] == 2_488_070 and dd.d_year.iloc[-1] == 2100
    assert dd.d_day_name.iloc[0] == "Tuesday"  # 1900-01-02
    ss = rels["store_sales"]
    sold = ss.col("ss_sold_date_sk")
    d = sold.data.numpy()[_valid(sold)]
    assert d.min() >= SD.SALES_FIRST and d.max() <= SD.SALES_LAST
    assert SD.SALES_FIRST == 2_450_816 and SD.SALES_LAST == 2_452_642
    cd = rels["customer_demographics"].to_df()
    combos = cd[["cd_gender", "cd_marital_status", "cd_education_status",
                 "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
                 "cd_dep_employed_count", "cd_dep_college_count"]]
    assert not combos.duplicated().any()  # the cross product, once


def test_tickets_and_prices(spec):
    rels, _ = spec
    ss = rels["store_sales"]
    cols = {n: (ss.col(n).data.numpy().astype(np.int64), _valid(ss.col(n)))
            for n in ss.names}
    t = cols["ss_ticket_number"][0]
    assert np.all(np.diff(t) >= 0)
    for shared in ("ss_sold_date_sk", "ss_customer_sk", "ss_store_sk"):
        d, ok = cols[shared]
        frame = pd.DataFrame({"t": t[ok], "d": d[ok]})
        assert (frame.groupby("t").d.nunique() == 1).all(), shared
    items = pd.DataFrame({"t": t, "i": cols["ss_item_sk"][0]})
    assert not items.duplicated().any()  # (item, ticket) is the key
    sizes = np.bincount(t)[1:]
    assert sizes[:-1].min() >= 8 and sizes.max() <= 16
    q, qv = cols["ss_quantity"]
    p, pv = cols["ss_sales_price"]
    e, ev = cols["ss_ext_sales_price"]
    ok = qv & pv & ev
    assert np.array_equal(e[ok], q[ok] * p[ok])


def test_null_shares(spec):
    rels, _ = spec
    pk = {"store_sales": ("ss_item_sk", "ss_ticket_number"),
          "catalog_sales": ("cs_item_sk", "cs_order_number"),
          "web_sales": ("ws_item_sk", "ws_order_number"),
          "store_returns": ("sr_item_sk", "sr_ticket_number")}
    for table, keys in pk.items():
        r = rels[table]
        for name, c in zip(r.names, r.table.columns):
            share = 1.0 - _valid(c).mean()
            if name in keys:
                assert c.validity is None, name
            else:
                assert 0.025 < share < 0.055, (name, share)
                assert np.all(c.data.numpy()[~_valid(c)] == 0), name
    for table in ("customer", "item", "store", "date_dim"):
        assert all(c.validity is None for c in rels[table].table.columns)


def test_generation_is_seeded():
    a = SD.generate_spec(10, seed=5, device="cpu", divisor=20_000)
    b = SD.generate_spec(10, seed=5, device="cpu", divisor=20_000)
    c = SD.generate_spec(10, seed=6, device="cpu", divisor=20_000)
    x = a["web_sales"].col("ws_net_paid").data
    assert torch.equal(x, b["web_sales"].col("ws_net_paid").data)
    assert not torch.equal(x, c["web_sales"].col("ws_net_paid").data)


# --------------------------------------------------------------------------
# Nullable keys: fused route, eager route and the plain reference
# --------------------------------------------------------------------------

def _col(values, valid, trusted=True, unique=False):
    data = torch.tensor(values, dtype=torch.int32)
    v = torch.tensor(valid)
    c = Column(INT32, len(values), data, bitmask.pack(v) if not all(valid)
               else None)
    if trusted:
        c.value_range = (0, 9)
        c.unique = unique
    return c


def _rels(trusted: bool):
    # probe keys with NULLs (data under a NULL is garbage), build keys
    # unique over their valid values, one NULL build key
    lk = _col([1, 2, 0, 3, 9, 5, 2, 7], [1, 1, 0, 1, 1, 0, 1, 1], trusted)
    lv = Column(INT64, 8, torch.arange(8, dtype=torch.int64) * 10)
    rk = _col([2, 3, 5, 1, 6], [1, 1, 1, 0, 1], trusted, unique=True)
    rv = Column(INT64, 5, torch.tensor([200, 300, 500, 999, 600]))
    return {"l": Rel(Table([lk, lv]), ["k", "v"]),
            "r": Rel(Table([rk, rv]), ["rk", "rv"])}


def _frames(rels):
    return R.read_tables(rels)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_nullable_key_joins_agree(how):
    def plan(t):
        j = t["l"].join(t["r"], ["k"], ["rk"], how=how)
        return j.sort(["v"])

    want = R.to_pandas(R.sort(R.join(_frames(_rels(True))["l"],
                                     _frames(_rels(True))["r"], "k", "rk",
                                     how), ["v"]))
    before = kernel_stats()
    fused = run_fused(plan, _rels(True), device="cpu").to_df()
    st = stats_since(before)
    assert st.get("rel.fused_fallbacks", 0) == 0, st
    assert st.get(f"rel.route.join.dense_nullable.{how}", 0) == 1, st
    before = kernel_stats()
    eager = plan(_rels(False)).to_df()  # no stats: the general kernels
    st = stats_since(before)
    assert st.get(f"rel.route.join.general.{how}", 0) == 1, st
    for got in (fused, eager):
        assert R.frame_mismatches(got, want) == 0, (got, want)
    # v 20 (NULL key) and v 50 (NULL key) never match; v 0 (key 1)
    # matches only the NULL build row, so never
    matched = {"inner": [10, 30, 60], "semi": [10, 30, 60],
               "anti": [0, 20, 40, 50, 70], "left": list(range(0, 80, 10))}
    assert want["v"].tolist() == matched[how]


def test_nullable_key_groupby_agrees():
    aggs = [("v", "sum", "s"), ("v", "count", "n"), ("v", "mean", "m")]

    def plan(t):
        return t["l"].groupby(["k"], aggs).sort(["k"])

    f = _frames(_rels(True))["l"]
    want = R.to_pandas(R.sort(R.groupby(f, ["k"], aggs), ["k"]))
    assert want["k"].isna().iloc[0]  # the NULL group, first
    before = kernel_stats()
    fused = run_fused(plan, _rels(True), device="cpu").to_df()
    st = stats_since(before)
    assert st.get("rel.route.groupby.dense_nullable", 0) == 1, st
    assert st.get("rel.fused_fallbacks", 0) == 0, st
    before = kernel_stats()
    eager = plan(_rels(False)).to_df()
    assert stats_since(before).get("rel.route.groupby.general", 0) == 1
    for got in (fused, eager):
        assert R.frame_mismatches(got, want) == 0, (got, want)


def test_all_null_group_sums_are_null():
    # a group whose values are all NULL sums to NULL on both routes
    k = Column(INT32, 4, torch.tensor([1, 1, 2, 2], dtype=torch.int32),
               value_range=(1, 2))
    v = Column(INT64, 4, torch.tensor([5, 6, 0, 0]),
               bitmask.pack(torch.tensor([True, True, False, False])))
    for trusted in (True, False):
        kk = Column(INT32, 4, k.data, value_range=k.value_range
                    if trusted else None)
        rel = {"x": Rel(Table([kk, v]), ["k", "v"])}
        got = run_fused(lambda t: t["x"].groupby(
            ["k"], [("v", "sum", "s"), ("v", "mean", "m")]).sort(["k"]),
            rel, device="cpu").to_df()
        assert got["s"].tolist()[0] == 11 and pd.isna(got["s"].tolist()[1])
        assert pd.isna(got["m"].tolist()[1])


# --------------------------------------------------------------------------
# q1-q20 over the spec's tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qname", QUERIES)
def test_spec_query_matches_plain_reference(spec, qname):
    rels, frames = spec
    before = kernel_stats()
    got = run_fused(PLANS[qname], rels, device="cpu").to_df()
    st = stats_since(before)
    want = R.run_query(qname, frames)
    assert R.frame_mismatches(got, want) == 0, (got.head(), want.head())
    fell_back = st.get("rel.fused_fallbacks", 0)
    assert fell_back == (1 if qname in GENERAL_AT_ANY_SIZE else 0), st


@pytest.mark.parametrize("qname", ["q2", "q4", "q5", "q7", "q8", "q10",
                                   "q16", "q19"])
def test_nullable_keys_take_the_fused_routes(spec, qname):
    rels, _ = spec
    before = kernel_stats()
    run_fused(PLANS[qname], rels, device="cpu").to_df()
    st = stats_since(before)
    assert st.get("rel.fused_fallbacks", 0) == 0, st
    assert any(k.startswith(("rel.route.join.dense_nullable.",
                             "rel.route.groupby.dense_nullable"))
               for k in st), st
    assert not any(k.startswith(("rel.route.join.general.",
                                 "rel.route.groupby.general")) for k in st)


def test_the_control_fails(spec):
    _, frames = spec
    bad = sum(R.frame_mismatches(R.run_query(q, frames, control=True),
                                 R.run_query(q, frames)) for q in QUERIES)
    assert bad > 0


def test_a_wrong_answer_is_caught(spec):
    _, frames = spec
    want = R.run_query("q13", frames)
    got = want.copy()
    got.loc[3, "total"] = got.loc[3, "total"] + decimal.Decimal("0.01")
    assert R.frame_mismatches(got, want) == 1
    assert R.frame_mismatches(got.iloc[:-1], want) > 0


@pytest.mark.parametrize("qname,col,kind", [
    ("q13", "total", float), ("q7", "agg2", decimal.Decimal),
    ("q12", "qty", float)])
def test_a_cell_of_another_type_is_caught(spec, qname, col, kind):
    """A money sum as float64, however near its Decimal, is another
    result; so is a mean as a Decimal, or a count as a float."""
    _, frames = spec
    want = R.run_query(qname, frames)
    valid = int(want[col].notna().sum())
    assert valid > 0
    got = want.copy()
    got[col] = pd.Series([x if pd.isna(x) else kind(x)
                          for x in got[col]], dtype=object)
    assert R.frame_mismatches(got, want) == valid


# --------------------------------------------------------------------------
# The miniature's outputs are unchanged
# --------------------------------------------------------------------------

# sha1 of each frame (column names, then every value: floats by their
# hex, decimals and ints by repr, strings as themselves) at sf=0.5,
# seed 7, as the templates gave them before they read the spec's tables
MINI_DIGESTS = {
    "q1": "49e5f8e7ba1f059b", "q2": "54da0badbcacbba2",
    "q3": "b78b2f23ae289849", "q4": "d100ea280f5ac46f",
    "q5": "79925aa7fdf0089a", "q6": "583d278f2beb3638",
    "q7": "bc17e002fcf7d558", "q8": "7e1a5153aec9e2f9",
    "q9": "81cb15be795677f8", "q10": "5e9ba78fc45e9488",
    "q11": "95b57baba9199d19", "q12": "94513a943cf77c47",
    "q13": "5d73f5a8bcda6ded", "q14": "9e939b85f0f8b69d",
    "q15": "d417b433c7767fb4", "q16": "5fc7f74f1333f20c",
    "q17": "c99381131a993e05", "q18": "77e6449161e22a3d",
    "q19": "b6e1cfa47bf3ac66", "q20": "93e35bb8f012abab",
}


def _canon(v) -> str:
    if v is None:
        return "None"
    if isinstance(v, np.generic) and not isinstance(v, np.str_):
        v = v.item()
    if isinstance(v, float):
        return "nan" if math.isnan(v) else v.hex()
    return "s:" + v if isinstance(v, str) else repr(v)


def _digest(df: pd.DataFrame) -> str:
    h = hashlib.sha1()
    for c in df.columns:
        h.update(("|" + c + ":").encode())
        h.update(",".join(_canon(v) for v in df[c].tolist()).encode())
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def mini():
    return ingest(generate(sf=0.5, seed=7), device="cpu")


@pytest.mark.parametrize("qname", QUERIES)
def test_miniature_outputs_unchanged(mini, qname):
    got = run_fused(PLANS[qname], mini, device="cpu").to_df()
    assert _digest(got) == MINI_DIGESTS[qname]


# --------------------------------------------------------------------------
# The dictionary route over a 102,000-category dictionary
# --------------------------------------------------------------------------

def _like_by_bytes(s: str, pattern: str, escape: str = "\\") -> bool:
    """LIKE by a walk over the set of reachable byte positions: ``%``
    any, ``_`` a byte and its continuation bytes, a literal its byte."""
    from spark_rapids_jni_tpu_torch.ops import string_ops
    b = s.encode("utf-8")
    starts = {0}
    for t in string_ops.like_tokens(pattern, escape):
        if t[0] == "%":
            starts = set(range(min(starts), len(b) + 1)) if starts else set()
        elif t[0] == "_":
            nxt = set()
            for p in starts:
                if p < len(b):
                    q = p + 1
                    while q < len(b) and (b[q] & 0xC0) == 0x80:
                        q += 1
                    nxt.add(q)
            starts = nxt
        else:
            starts = {p + 1 for p in starts if p < len(b) and b[p] == t[1]}
    return len(b) in starts


def test_host_like_equals_the_byte_walk():
    from spark_rapids_jni_tpu_torch.tpcds.oplib import strings as S
    rng = np.random.default_rng(3)
    alpha = list("ab%_\\\n") + ["é", "€"]
    for _ in range(20_000):
        s = "".join(rng.choice(list("ab\n_%é€"), rng.integers(0, 7)))
        p = "".join(rng.choice(alpha, rng.integers(0, 6)))
        assert S._host_like(s, p) == _like_by_bytes(s, p), (s, p)


def test_whole_dictionary_like_equals_the_regex():
    """LIKE over a whole dictionary (a literal with ``%`` at its ends)
    matches what each category's regex matches; other patterns and
    dictionaries fall back (None)."""
    from spark_rapids_jni_tpu_torch.tpcds.oplib import strings as S
    rng = np.random.default_rng(5)
    words = ["".join(rng.choice(list("ab_%é€\\"), rng.integers(0, 6)))
             for _ in range(300)]
    cats = np.unique(np.array(words + [""]))
    tried = 0
    for _ in range(2_000):
        p = "".join(rng.choice(list("ab%é\\_"), rng.integers(0, 5)))
        got = S._like_dict(cats, p, "\\")
        if got is None:
            continue
        tried += 1
        want = [S._host_like(str(c), p) for c in cats]
        assert got.tolist() == want, p
    assert tried > 200
    assert S._like_dict(cats, "a_b", "\\") is None
    assert S._like_dict(cats, "a%b", "\\") is None
    assert S._like_dict(cats.astype(object), "a%", "\\") is None


def test_whole_dictionary_slice_equals_pythons():
    from spark_rapids_jni_tpu_torch.tpcds.oplib import strings as S
    cats = np.unique(np.array(["", "a", "ab", "abcdef", "é€x", "zz€é"]))
    for start in range(0, 8):
        for length in range(1, 8):
            got = S._dict_slice(cats, start, length)
            if start >= 6:
                assert got is None
                continue
            assert got.tolist() == [str(c)[start:start + length]
                                    for c in cats], (start, length)
    assert S._dict_slice(cats, -1, 2) is None
    assert S._dict_slice(cats, 0, 0) is None
    assert S._dict_slice(cats.astype(object), 0, 2) is None
    assert S._dict_slice(np.array(["a\x00b", "c"]), 0, 2) is None


def test_dictionary_string_ops_over_the_spec_item(spec):
    """LIKE and substr over i_product_name's dictionary, each row read
    through its code, against Python's own string operations."""
    from spark_rapids_jni_tpu_torch.tpcds.oplib import strings as S
    rels, _ = spec
    item = rels["item"]
    names = np.asarray(item.dicts["i_product_name"])
    codes = item.data("i_product_name").tolist()
    for pattern, want in (("e%", lambda n: n.startswith("e")),
                          ("%ought%", lambda n: "ought" in n),
                          ("_b%", lambda n: n[1:2] == "b")):
        got = S.like(item, "i_product_name", pattern).numpy().tolist()
        assert got == [want(str(names[c])) for c in codes], pattern
    p5 = S.substr(item, "i_product_name", 0, 5, "p5")
    assert p5.to_df()["p5"].tolist() == [str(names[c])[:5] for c in codes]
