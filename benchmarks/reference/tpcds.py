"""q1-q20 over the specification's tables in plain PyTorch.

The plain reference of the port's templates (``tpcds/queries.py``) over
``tpcds/spec_data.generate_spec``'s tables, written from Spark's
semantics and not from the port's code: it imports nothing of the port
and reads the generator's output by its format alone (a table's
``names``, ``dicts`` and ``table.columns``, each column's ``data``,
packed ``validity`` words and ``dtype``). Each query compacts as it
goes and syncs freely; nothing in it is a kernel of the port.

Semantics: a NULL key matches nothing in an inner, left or semi join (a
left join keeps the row with its right side NULL, an anti join keeps
it); a predicate over a NULL is false; a groupby gathers the NULL keys
into one group, ordered first; ``sum``, ``count`` and ``mean`` skip
NULLs, and a sum or mean over no valid value is NULL; money sums are
exact (int64 over the unscaled cents, out as ``Decimal``); a mean is
float64, the exact sum over the count in the money's units; a ratio is
float64; decimal arithmetic is exact, a product past its result type
NULL (Spark's CheckOverflow); RANK() shares ties and leaves gaps,
ROW_NUMBER() breaks ties by the order's next key; every sort, window
order included, puts NULLs first. q9's empty bucket reads NaN. The
constants are ``PARAMS``, the templates' ``SPEC_PARAMS`` written out
again (the benchmark's configuration states them a third time, and its
tests hold the three equal).

``run_query(name, frames)`` gives a query's pandas frame from
``read_tables(rels)``; ``frame_mismatches`` compares two frames cell by
cell. ``control=True`` computes every money sum in float32 instead of
exactly: one precision below the decimals the configuration states.
"""

from __future__ import annotations

import decimal
import math
from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
import torch

INT32_MAX = 2**31 - 1

# each template's constants, by the configuration's names
PARAMS = {
    "q2.years": (2001, 2002), "q2.week_shift": 53,
    "q3.moy": 11, "q3.manufact_id": 128,
    "q4.years": (2001, 2002),
    "q6.year_moy": (2001, 1),
    "q7.gender": "M", "q7.marital_status": "S", "q7.channel_off": "N",
    "q8.zip_below": "40000", "q8.year": 1998, "q8.moy_upto": 3,
    "q9.buckets": ((1, 20), (21, 40), (41, 60), (61, 80), (81, 100)),
    "q10.county_below": "Green",
    "q11.state_contains": "A",
    "q12.name_like": "e%",
    "q14.net_over": "100.00",
    "q20.name_like": "%ought%",
}


class V:
    """A column: data, valid rows (None: all valid), a decimal's scale
    (None otherwise) and a string column's sorted dictionary."""

    __slots__ = ("data", "valid", "scale", "cats")

    def __init__(self, data, valid=None, scale=None, cats=None):
        self.data, self.valid, self.scale, self.cats = data, valid, scale, cats

    def ok(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool,
                              device=self.data.device)
        return self.valid

    def take(self, idx: torch.Tensor) -> "V":
        return V(self.data[idx], None if self.valid is None
                 else self.valid[idx], self.scale, self.cats)


Frame = Dict[str, V]


def _unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    bits = (words.to(torch.int64)[:, None]
            >> torch.arange(32, device=words.device)[None, :]) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def read_tables(rels: dict) -> Dict[str, Frame]:
    """The generator's tables as frames of ``V``."""
    out = {}
    for name, rel in rels.items():
        f = {}
        for cname, c in zip(rel.names, rel.table.columns):
            kind = c.dtype.id.name
            f[cname] = V(c.data, None if c.validity is None
                         else _unpack(c.validity, c.size),
                         c.dtype.scale if kind.startswith("DECIMAL")
                         else None, rel.dicts.get(cname))
        out[name] = f
    return out


# --------------------------------------------------------------------------
# Relational building blocks
# --------------------------------------------------------------------------

def _nrows(f: Frame) -> int:
    return next(iter(f.values())).data.shape[0]


def take(f: Frame, idx: torch.Tensor) -> Frame:
    return {k: v.take(idx) for k, v in f.items()}


def where(f: Frame, pred: torch.Tensor) -> Frame:
    return take(f, torch.nonzero(pred).reshape(-1))


def valid_all(f: Frame, *names: str) -> torch.Tensor:
    out = torch.ones(_nrows(f), dtype=torch.bool,
                     device=next(iter(f.values())).data.device)
    for n in names:
        out = out & f[n].ok()
    return out


def code_of(v: V, s: str) -> int:
    """The dictionary code of the string ``s`` (-1: absent)."""
    i = int(np.searchsorted(v.cats, s))
    return i if i < len(v.cats) and v.cats[i] == s else -1


def like(pattern: str):
    """SQL LIKE as a predicate over a string: ``%`` any characters,
    ``_`` one character, the rest itself, the whole string matched."""
    def match(s: str) -> bool:
        ends = {0}  # the lengths of ``s``'s prefixes matched so far
        for ch in pattern:
            if ch == "%":
                ends = set(range(min(ends), len(s) + 1)) if ends else set()
            else:
                ends = {i + 1 for i in ends
                        if i < len(s) and ch in ("_", s[i])}
        return len(s) in ends
    return match


def str_mask(v: V, fn) -> torch.Tensor:
    """Rows whose string satisfies ``fn``."""
    lut = torch.tensor([bool(fn(str(c))) for c in v.cats],
                       device=v.data.device)
    return lut[v.data.to(torch.int64)] & v.ok()


def join(left: Frame, right: Frame, lk: str, rk: str,
         how: str = "inner") -> Frame:
    """An equi-join on one key whose valid build keys are unique (inner,
    left), or any build side (semi, anti)."""
    lv, rv = left[lk], right[rk]
    lkey = lv.data.to(torch.int64)
    bvalid = torch.nonzero(rv.ok()).reshape(-1)
    bkeys = rv.data.to(torch.int64)[bvalid]
    if how in ("semi", "anti"):
        hit = torch.isin(lkey, bkeys) & lv.ok()
        return where(left, hit if how == "semi" else ~hit)
    sk, perm = torch.sort(bkeys, stable=True)
    if sk.numel() > 1 and bool((sk[1:] == sk[:-1]).any()):
        raise ValueError(f"join build key {rk!r} is not unique")
    if sk.numel() == 0:
        hit = torch.zeros_like(lkey, dtype=torch.bool)
        pos = torch.zeros_like(lkey)
    else:
        pos = torch.clamp(torch.searchsorted(sk, lkey), max=sk.numel() - 1)
        hit = (sk[pos] == lkey) & lv.ok()
    ridx = bvalid[perm[pos]] if sk.numel() else pos
    if how == "inner":
        li = torch.nonzero(hit).reshape(-1)
        out = take(left, li)
        out.update(take(right, ridx[li]))
        return out
    out = dict(left)
    for k, v in right.items():  # left: the right side NULL where unmatched
        g = v.take(ridx) if sk.numel() else v.take(torch.zeros_like(ridx))
        g.valid = g.ok() & hit
        out[k] = g
    return out


def concat(a: Frame, b: Frame) -> Frame:
    out = {}
    for k in a:
        x, y = a[k], b[k]
        valid = None if x.valid is None and y.valid is None else \
            torch.cat([x.ok(), y.ok()])
        out[k] = V(torch.cat([x.data, y.data]), valid, x.scale, x.cats)
    return out


def _key_matrix(f: Frame, keys: Sequence[str]) -> torch.Tensor:
    """(n, 2 x keys) int64: each key's validity then its value (0 where
    NULL): lexicographic order is the keys' order, NULLs first."""
    cols = []
    for k in keys:
        v = f[k]
        ok = v.ok()
        cols += [ok.to(torch.int64),
                 torch.where(ok, v.data.to(torch.int64), 0)]
    return torch.stack(cols, 1)


def groupby(f: Frame, keys: Sequence[str], aggs, control=False) -> Frame:
    """GROUP BY ``keys`` in ascending key order (NULLs first); ``aggs``
    = [(column, "sum" | "count" | "mean", out)]."""
    km = _key_matrix(f, keys)
    uniq, inv = torch.unique(km, dim=0, return_inverse=True)
    g = uniq.shape[0]
    dev = km.device
    out: Frame = {}
    for i, k in enumerate(keys):
        v = f[k]
        ok = uniq[:, 2 * i] == 1
        out[k] = V(uniq[:, 2 * i + 1].to(v.data.dtype),
                   None if bool(ok.all()) else ok, None, v.cats)
    for col, agg, name in aggs:
        v = f[col]
        ok = v.ok()
        n = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
            0, inv, ok.to(torch.int64))
        if agg == "count":
            out[name] = V(n)
            continue
        if v.data.is_floating_point():
            s = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
                0, inv, torch.where(ok, v.data.to(torch.float64), 0.0))
        elif control and agg == "sum" and _scaled(v):
            # the control: money summed in float32, in its units
            s = torch.zeros(g, dtype=torch.float32, device=dev).index_add_(
                0, inv, torch.where(ok, v.data.to(torch.float32)
                                    / 10.0 ** -v.scale, 0.0))
            out[name] = V(s, n > 0, "float32", None)
            continue
        else:
            s = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
                0, inv, torch.where(ok, v.data.to(torch.int64), 0))
        if agg == "sum":
            out[name] = V(s, n > 0, v.scale, None)
        else:  # mean: the exact sum over the count, in the units
            m = s.to(torch.float64) / torch.clamp(n, min=1).to(torch.float64)
            if _scaled(v):
                m = m / 10.0 ** -v.scale
            out[name] = V(m, n > 0)
    return out


def _order(f: Frame, by: Sequence[str], desc: Sequence[bool]) -> torch.Tensor:
    """A stable permutation by ``by`` (NULLs first in either direction)."""
    n = _nrows(f)
    dev = next(iter(f.values())).data.device
    perm = torch.arange(n, device=dev)
    for k, d in reversed(list(zip(by, desc))):
        v = f[k]
        vals = v.data[perm]
        if vals.dtype == torch.bool:
            vals = vals.to(torch.int64)
        _, o = torch.sort(vals, stable=True, descending=d)
        perm = perm[o]
        nul = (~v.ok()[perm]).to(torch.int64)
        _, o = torch.sort(nul, stable=True, descending=True)
        perm = perm[o]
    return perm


def sort(f: Frame, by: Sequence[str], desc: Optional[Sequence[bool]] = None,
         limit: Optional[int] = None) -> Frame:
    perm = _order(f, by, desc or [False] * len(by))
    return take(f, perm[:limit] if limit is not None else perm)


def window_number(f: Frame, part: Sequence[str], order: Sequence[str],
                  desc: Sequence[bool], kind: str) -> torch.Tensor:
    """ROW_NUMBER() or RANK() over PARTITION BY ``part`` ORDER BY
    ``order``, in ``f``'s row order."""
    n = _nrows(f)
    dev = next(iter(f.values())).data.device
    pk = _key_matrix(f, part)
    _, pid = torch.unique(pk, dim=0, return_inverse=True)
    pf = dict(f)
    pf["__part"] = V(pid)
    perm = _order(pf, ["__part"] + list(order), [False] + list(desc))
    sp = pid[perm]
    pos = torch.arange(n, device=dev)
    new_part = torch.ones(n, dtype=torch.bool, device=dev)
    new_part[1:] = sp[1:] != sp[:-1]
    start = torch.cummax(torch.where(new_part, pos, 0), 0).values
    if kind == "row_number":
        num = pos - start + 1
    else:
        changed = new_part.clone()
        for k in order:
            v = f[k]
            d, ok = v.data[perm], v.ok()[perm]
            neq = (ok[1:] != ok[:-1]) | (ok[1:] & (d[1:] != d[:-1]))
            changed[1:] |= neq
        first = torch.cummax(torch.where(changed, pos, 0), 0).values
        num = first - start + 1
    out = torch.empty(n, dtype=torch.int64, device=dev)
    out[perm] = num
    return out


def partition_sum_count(f: Frame, part: str, col: str):
    """(sum, count) of ``col``'s valid values over each row's partition."""
    km = _key_matrix(f, [part])
    _, inv = torch.unique(km, dim=0, return_inverse=True)
    v = f[col]
    ok = v.ok()
    g = int(inv.max()) + 1 if inv.numel() else 0
    s = torch.zeros(g, dtype=torch.int64, device=km.device).index_add_(
        0, inv, torch.where(ok, v.data.to(torch.int64), 0))
    c = torch.zeros(g, dtype=torch.int64, device=km.device).index_add_(
        0, inv, ok.to(torch.int64))
    return s[inv], c[inv]


def _scaled(v: V) -> bool:
    """A decimal's unscaled values (not the control's float32 sums)."""
    return isinstance(v.scale, int)


def num(v: V) -> torch.Tensor:
    """float64 values in their units."""
    x = v.data.to(torch.float64)
    return x / 10.0 ** -v.scale if _scaled(v) else x


def dec_binary(a: V, b: V, op: str, out_scale: int,
               limit: int) -> V:
    """Exact decimal ``a op b`` at ``out_scale`` (the operands' scales
    add for a product, are equal for a difference); outside
    [-limit - 1, limit] NULL."""
    x, y = a.data.to(torch.int64), b.data.to(torch.int64)
    r = x * y if op == "mul" else x - y
    ok = a.ok() & b.ok() & (r <= limit) & (r >= -limit - 1)
    return V(torch.where(ok, r, 0), ok, out_scale)


# --------------------------------------------------------------------------
# q1-q20
# --------------------------------------------------------------------------

def _rename(f: Frame, **m: str) -> Frame:
    return {m.get(k, k): v for k, v in f.items()}


def _select(f: Frame, *names: str) -> Frame:
    return {n: f[n] for n in names}


def q1(t, control=False):
    ctr = groupby(t["store_returns"], ["sr_customer_sk", "sr_store_sk"],
                  [("sr_return_amt", "sum", "ctr_total")], control)
    avg = _rename(groupby(ctr, ["sr_store_sk"],
                          [("ctr_total", "mean", "avg_total")]),
                  sr_store_sk="store2")
    j = join(ctr, avg, "sr_store_sk", "store2")
    f = where(j, (num(j["ctr_total"]) > 1.2 * j["avg_total"].data)
              & valid_all(j, "ctr_total", "avg_total"))
    res = join(f, t["customer"], "sr_customer_sk", "c_customer_sk")
    return sort(_select(res, "c_customer_sk", "ctr_total"),
                ["c_customer_sk", "ctr_total"], limit=100)


def q2(t, control=False):
    dd = t["date_dim"]

    def weekly(fact, datecol, extcol, year):
        d = where(dd, dd["d_year"].data == year)
        j = join(t[fact], d, datecol, "d_date_sk")
        return groupby(j, ["d_week_seq"], [(extcol, "sum", "total")],
                       control)

    def year_total(year):
        w = weekly("web_sales", "ws_sold_date_sk", "ws_ext_sales_price",
                   year)
        c = _rename(weekly("catalog_sales", "cs_sold_date_sk",
                           "cs_ext_sales_price", year),
                    d_week_seq="cweek", total="ctot")
        j = join(w, c, "d_week_seq", "cweek")
        tot = V(j["total"].data + j["ctot"].data,
                j["total"].ok() & j["ctot"].ok(), j["total"].scale)
        return {"d_week_seq": j["d_week_seq"], "total": tot}

    first, second = PARAMS["q2.years"]
    y1 = year_total(first)
    y2 = _rename(year_total(second), d_week_seq="week2", total="total2")
    y1["next_week"] = V(y1["d_week_seq"].data.to(torch.int64)
                        + PARAMS["q2.week_shift"])
    j = join(y1, y2, "next_week", "week2")
    ratio = V(j["total"].data.to(torch.float64)
              / j["total2"].data.to(torch.float64),
              j["total"].ok() & j["total2"].ok())
    return sort({"d_week_seq": j["d_week_seq"], "ratio": ratio},
                ["d_week_seq"])


def q3(t, control=False):
    dd, it = t["date_dim"], t["item"]
    j = join(t["store_sales"], where(dd, dd["d_moy"].data
                                     == PARAMS["q3.moy"]),
             "ss_sold_date_sk", "d_date_sk")
    j = join(j, where(it, it["i_manufact_id"].data
                      == PARAMS["q3.manufact_id"]), "ss_item_sk",
             "i_item_sk")
    gb = groupby(j, ["d_year", "i_brand_id"],
                 [("ss_ext_sales_price", "sum", "sum_agg")], control)
    return sort(gb, ["d_year", "sum_agg", "i_brand_id"],
                [False, True, False], limit=100)


def q4(t, control=False):
    dd = t["date_dim"]

    def chan_year(fact, datecol, custcol, extcol, year, out):
        j = join(t[fact], where(dd, dd["d_year"].data == year), datecol,
                 "d_date_sk")
        return _rename(groupby(j, [custcol], [(extcol, "sum", out)],
                               control), **{custcol: "cust"})

    first, second = PARAMS["q4.years"]
    ss98 = chan_year("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                     "ss_ext_sales_price", first, "ss98")
    ss99 = chan_year("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                     "ss_ext_sales_price", second, "ss99")
    ws98 = chan_year("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
                     "ws_ext_sales_price", first, "ws98")
    ws99 = chan_year("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
                     "ws_ext_sales_price", second, "ws99")
    j = join(join(join(ss98, _rename(ss99, cust="c2"), "cust", "c2"),
                  _rename(ws98, cust="c3"), "cust", "c3"),
             _rename(ws99, cust="c4"), "cust", "c4")
    d = {k: j[k].data for k in ("ss98", "ss99", "ws98", "ws99")}
    keep = ((d["ws99"] * d["ss98"] > d["ss99"] * d["ws98"])
            & (d["ss98"] > 0) & (d["ws98"] > 0)
            & valid_all(j, "ss98", "ss99", "ws98", "ws99"))
    return sort(_select(where(j, keep), "cust", "ss98", "ss99", "ws98",
                        "ws99"), ["cust"], limit=100)


def q5(t, control=False):
    s = groupby(t["store_sales"], ["ss_store_sk"],
                [("ss_ext_sales_price", "sum", "sales"),
                 ("ss_net_profit", "sum", "profit")], control)
    r = _rename(groupby(t["store_returns"], ["sr_store_sk"],
                        [("sr_return_amt", "sum", "returns_")], control),
                sr_store_sk="store2")
    j = join(s, r, "ss_store_sk", "store2", how="left")
    ret = j["returns_"]
    filled = torch.where(ret.ok(), ret.data, torch.zeros_like(ret.data))
    prof = j["profit"]
    out = {"ss_store_sk": j["ss_store_sk"], "sales": j["sales"],
           "returns_f": V(filled, None, ret.scale),
           "net": V(prof.data - filled, prof.valid, prof.scale)}
    return sort(out, ["ss_store_sk"])


def q6(t, control=False):
    it = t["item"]
    avgcat = _rename(groupby(it, ["i_category_id"],
                             [("i_current_price", "mean", "avg_price")]),
                     i_category_id="cat2")
    pricey = join(it, avgcat, "i_category_id", "cat2")
    pricey = where(pricey, num(pricey["i_current_price"])
                   > 1.2 * pricey["avg_price"].data)
    dd = t["date_dim"]
    year, moy = PARAMS["q6.year_moy"]
    may = where(dd, (dd["d_year"].data == year) & (dd["d_moy"].data == moy))
    j = join(t["store_sales"], may, "ss_sold_date_sk", "d_date_sk")
    j = join(j, pricey, "ss_item_sk", "i_item_sk")
    j = join(j, t["customer"], "ss_customer_sk", "c_customer_sk")
    j = join(j, t["customer_address"], "c_current_addr_sk", "ca_address_sk")
    gb = groupby(j, ["ca_state"], [("ss_quantity", "count", "cnt")])
    gb = where(gb, gb["cnt"].data >= 10)
    return sort(gb, ["cnt", "ca_state"], [True, False])


def q7(t, control=False):
    cd, pr = t["customer_demographics"], t["promotion"]
    off = PARAMS["q7.channel_off"]
    cdf = where(cd, (cd["cd_gender"].data
                     == code_of(cd["cd_gender"], PARAMS["q7.gender"]))
                & (cd["cd_marital_status"].data
                   == code_of(cd["cd_marital_status"],
                              PARAMS["q7.marital_status"])))
    prf = where(pr, (pr["p_channel_email"].data
                     == code_of(pr["p_channel_email"], off))
                | (pr["p_channel_event"].data
                   == code_of(pr["p_channel_event"], off)))
    j = join(t["store_sales"], cdf, "ss_cdemo_sk", "cd_demo_sk")
    j = join(j, prf, "ss_promo_sk", "p_promo_sk")
    j = join(j, t["item"], "ss_item_sk", "i_item_sk")
    gb = groupby(j, ["i_item_sk"], [("ss_quantity", "mean", "agg1"),
                                    ("ss_sales_price", "mean", "agg2"),
                                    ("ss_ext_sales_price", "mean", "agg3")])
    return sort(gb, ["i_item_sk"], limit=100)


def q8(t, control=False):
    ca = t["customer_address"]
    zip_below = PARAMS["q8.zip_below"]
    pref = where(ca, str_mask(ca["ca_zip"], lambda s: s < zip_below))
    cust = join(t["customer"], pref, "c_current_addr_sk", "ca_address_sk",
                "semi")
    dd = t["date_dim"]
    qd = where(dd, (dd["d_year"].data == PARAMS["q8.year"])
               & (dd["d_moy"].data <= PARAMS["q8.moy_upto"]))
    j = join(t["store_sales"], qd, "ss_sold_date_sk", "d_date_sk")
    j = join(j, cust, "ss_customer_sk", "c_customer_sk", "semi")
    j = join(j, t["store"], "ss_store_sk", "s_store_sk")
    gb = groupby(j, ["s_store_name"], [("ss_net_profit", "sum", "profit")],
                 control)
    return sort(gb, ["s_store_name"])


def q9(t, control=False):
    ss = t["store_sales"]
    qty, ext = ss["ss_quantity"], ss["ss_ext_sales_price"]
    out = {}
    for lo, hi in PARAMS["q9.buckets"]:
        sel = (qty.data >= lo) & (qty.data <= hi) & qty.ok() & ext.ok()
        cnt = int(sel.sum())
        total = int(torch.where(sel, ext.data.to(torch.int64), 0).sum())
        val = (float(total) / max(cnt, 1)) / 10.0 ** -ext.scale \
            if cnt else float("nan")
        out[f"bucket_{lo}_{hi}"] = V(torch.tensor([val],
                                                  dtype=torch.float64))
    return out


def q10(t, control=False):
    ca = t["customer_address"]
    below = PARAMS["q10.county_below"]
    counties = where(ca, str_mask(ca["ca_county"], lambda s: s < below))
    cust = join(t["customer"], counties, "c_current_addr_sk",
                "ca_address_sk", "semi")
    cust = join(cust, t["store_sales"], "c_customer_sk", "ss_customer_sk",
                "semi")
    in_web = join(cust, t["web_sales"], "c_customer_sk",
                  "ws_bill_customer_sk", "semi")
    in_cat = join(join(cust, t["catalog_sales"], "c_customer_sk",
                       "cs_bill_customer_sk", "semi"),
                  t["web_sales"], "c_customer_sk", "ws_bill_customer_sk",
                  "anti")
    j = join(concat(in_web, in_cat), t["customer_demographics"],
             "c_current_cdemo_sk", "cd_demo_sk")
    gb = groupby(j, ["cd_gender", "cd_marital_status"],
                 [("cd_education_status", "count", "cnt")])
    return sort(gb, ["cd_gender", "cd_marital_status"])


def q11(t, control=False):
    j = join(t["store_sales"], t["store"], "ss_store_sk", "s_store_sk")
    part = PARAMS["q11.state_contains"]
    j = where(j, str_mask(j["s_state"], lambda s: part in s))
    gb = groupby(j, ["s_state"], [("ss_ext_sales_price", "sum", "rev"),
                                  ("ss_quantity", "count", "cnt")], control)
    return sort(gb, ["s_state"])


def q12(t, control=False):
    it = t["item"]
    names = it["i_product_name"]
    it = where(it, str_mask(names, like(PARAMS["q12.name_like"])))
    cats5 = np.array([str(c)[:5] for c in names.cats])
    new_cats, remap = np.unique(cats5, return_inverse=True)
    it["prod5"] = V(torch.as_tensor(remap, device=names.data.device)[
        it["i_product_name"].data.to(torch.int64)], None, None, new_cats)
    j = join(t["store_sales"], it, "ss_item_sk", "i_item_sk")
    gb = groupby(j, ["prod5"], [("ss_quantity", "sum", "qty")])
    return sort(gb, ["prod5"])


def _revenue(f: Frame) -> V:
    """list price x quantity, DECIMAL64 at scale -2."""
    p, q = f["ss_list_price"], f["ss_quantity"]
    return dec_binary(p, V(q.data, q.valid, 0), "mul", p.scale,
                      2**63 - 1)


def q13(t, control=False):
    ss = dict(t["store_sales"])
    ss["revenue"] = _revenue(ss)
    gb = groupby(ss, ["ss_store_sk"], [("revenue", "sum", "total")],
                 control)
    return sort(gb, ["ss_store_sk"])


def q14(t, control=False):
    ss = dict(t["store_sales"])
    net = dec_binary(ss["ss_list_price"], ss["ss_coupon_amt"], "sub", -2,
                     2**63 - 1)
    ss["net"] = net
    over = int(decimal.Decimal(PARAMS["q14.net_over"]).scaleb(-net.scale))
    f = where(ss, (net.data > over) & net.ok())
    gb = groupby(f, ["ss_store_sk"], [("net", "sum", "net_total"),
                                      ("net", "count", "n_big")], control)
    return sort(gb, ["ss_store_sk"])


def q15(t, control=False):
    ss = dict(t["store_sales"])
    ss["cross"] = dec_binary(ss["ss_list_price"], ss["ss_coupon_amt"],
                             "mul", -4, INT32_MAX)
    gb = groupby(ss, ["ss_store_sk"], [("cross", "sum", "cross_sum"),
                                       ("cross", "count", "n_ok")], control)
    return sort(gb, ["ss_store_sk"])


def q16(t, control=False):
    gb = groupby(t["store_sales"], ["ss_store_sk", "ss_item_sk"],
                 [("ss_ext_sales_price", "sum", "rev")], control)
    gb = where(gb, gb["rev"].ok())
    gb["rn"] = V(window_number(gb, ["ss_store_sk"], ["rev", "ss_item_sk"],
                               [True, False], "row_number"))
    f = where(gb, gb["rn"].data <= 3)
    return sort(_select(f, "ss_store_sk", "ss_item_sk", "rev", "rn"),
                ["ss_store_sk", "rn"])


def q17(t, control=False):
    j = join(t["store_sales"], t["item"], "ss_item_sk", "i_item_sk")
    gb = groupby(j, ["i_category_id", "i_brand_id"],
                 [("ss_quantity", "count", "cnt")])
    gb["rnk"] = V(window_number(gb, ["i_category_id"], ["cnt"], [True],
                                "rank"))
    return sort(_select(gb, "i_category_id", "i_brand_id", "cnt", "rnk"),
                ["i_category_id", "rnk", "i_brand_id"])


def q18(t, control=False):
    ss = dict(t["store_sales"])
    s, c = partition_sum_count(ss, "ss_store_sk", "ss_quantity")
    q = ss["ss_quantity"]
    f = where(ss, (q.data.to(torch.int64) * c > s) & q.ok())
    gb = groupby(f, ["ss_store_sk"], [("ss_quantity", "count", "n_above"),
                                      ("ss_quantity", "sum", "qty_above")])
    return sort(gb, ["ss_store_sk"])


def q19(t, control=False):
    ss = dict(t["store_sales"])
    rk = window_number(ss, ["ss_customer_sk"], ["ss_sold_date_sk"], [False],
                       "rank")
    f = where(ss, rk == 1)
    gb = groupby(f, ["ss_customer_sk"],
                 [("ss_quantity", "count", "first_day_buys")])
    return sort(gb, ["ss_customer_sk"], limit=100)


def q20(t, control=False):
    it = t["item"]
    it = where(it, str_mask(it["i_product_name"],
                            like(PARAMS["q20.name_like"])))
    j = join(t["store_sales"], it, "ss_item_sk", "i_item_sk")
    j = join(j, t["store"], "ss_store_sk", "s_store_sk")
    j["revenue"] = _revenue(j)
    gb = groupby(j, ["s_state", "ss_store_sk"],
                 [("revenue", "sum", "rev_total"),
                  ("ss_quantity", "sum", "qty_total")], control)
    gb = where(gb, gb["qty_total"].ok())
    gb["rn"] = V(window_number(gb, ["s_state"], ["qty_total", "ss_store_sk"],
                               [True, False], "row_number"))
    f = where(gb, gb["rn"].data <= 2)
    return sort(_select(f, "s_state", "ss_store_sk", "rev_total",
                        "qty_total", "rn"), ["s_state", "rn"])


QUERIES = {f"q{i}": globals()[f"q{i}"] for i in range(1, 21)}


# --------------------------------------------------------------------------
# Frames out, and their comparison
# --------------------------------------------------------------------------

def to_pandas(f: Frame) -> pd.DataFrame:
    """Python values: ints, floats, ``Decimal`` (exact; a control's
    float32 sum as the float's own decimal expansion), strings; None for
    NULL."""
    out = {}
    for name, v in f.items():
        data = v.data.cpu()
        ok = v.ok().cpu().tolist()
        if v.cats is not None:
            vals = [str(v.cats[c]) for c in data.tolist()]
        elif v.scale == "float32":
            vals = [decimal.Decimal(float(x)) for x in data.tolist()]
        elif v.scale is not None:
            vals = [decimal.Decimal(int(x)).scaleb(v.scale)
                    for x in data.tolist()]
        else:
            vals = data.tolist()
        out[name] = [x if k else None for x, k in zip(vals, ok)]
    return pd.DataFrame(out)


def run_query(name: str, frames: Dict[str, Frame],
              control: bool = False) -> pd.DataFrame:
    return to_pandas(QUERIES[name](frames, control))


def _same(got, want, rtol: float) -> bool:
    """One cell, held to ``want``'s type: a ``Decimal`` only by an equal
    ``Decimal`` (a float, however near, is another result), a float by a
    float within ``rtol`` (NaN by NaN), an integer, string or flag by an
    equal one of its own type."""
    if want is None or got is None:
        return got is None and want is None
    if isinstance(want, decimal.Decimal):
        return isinstance(got, decimal.Decimal) and got == want
    if isinstance(want, float):
        if not isinstance(got, float):
            return False
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return abs(got - want) <= rtol * max(abs(got), abs(want))
    return type(got) is type(want) and got == want


def frame_mismatches(got: pd.DataFrame, want: pd.DataFrame,
                     rtol: float = 1e-9) -> int:
    """Cells of ``want`` that ``got`` does not hold, each of its type
    (``_same``): keys, counts and decimals exactly, floats within
    ``rtol``. A frame of other columns or rows mismatches in every cell
    of the larger."""
    cells = max(len(got), len(want)) * max(len(got.columns),
                                          len(want.columns), 1)
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        return max(cells, 1)
    bad = 0
    for c in want.columns:
        for a, b in zip(got[c].tolist(), want[c].tolist()):
            bad += not _same(_py(a), _py(b), rtol)
    return bad


def _py(x):
    """numpy scalars and pandas' missing values as Python values."""
    if x is None:
        return None
    if isinstance(x, float) and math.isnan(x):
        return x
    if isinstance(x, np.generic):
        return x.item()
    try:
        if pd.isna(x):
            return None
    except (TypeError, ValueError):
        pass
    return x
