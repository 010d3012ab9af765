"""TPC-DS q1-q20 query templates + pandas oracles.

Port of ``spark_rapids_jni_tpu/tpcds/queries.py``: each template is the
structural miniature of its TPC-DS namesake (same join graph,
aggregation shape and ordering) composed from the port's Rel layer, and
runs through ``rel.run_fused``. q11-q20 add the operator library's
string predicates and projections, exact decimal arithmetic with
overflow -> NULL, and window functions. ``QUERIES[name]`` is
``(template, oracle)``; both produce a pandas frame with identical
columns over the same generated data. Float aggregates differ from the
oracle's in the last bits (accumulation order), so harnesses compare
floats with a tolerance; decimals are exact.
"""

from __future__ import annotations

import decimal

import numpy as np
import torch

from .oplib import decimals as D
from .oplib import strings as S

from .rel import Rel, Table, numeric, run_fused


def _rename(rel: Rel, **renames: str) -> Rel:
    return rel.rename(**renames)


# --------------------------------------------------------------------------
# q1: customers returning more than 1.2x their store's average return
# --------------------------------------------------------------------------

def _q1(t):
    ctr = t["store_returns"].groupby(
        ["sr_customer_sk", "sr_store_sk"],
        [("sr_return_amt", "sum", "ctr_total")])
    avg = _rename(ctr.groupby(["sr_store_sk"],
                              [("ctr_total", "mean", "avg_total")]),
                  sr_store_sk="store2")
    j = ctr.join(avg, ["sr_store_sk"], ["store2"])
    f = j.filter(j.data("ctr_total") > 1.2 * j.data("avg_total"))
    res = f.join(t["customer"], ["sr_customer_sk"], ["c_customer_sk"])
    return (res.select("c_customer_sk", "ctr_total")
               .sort(["c_customer_sk", "ctr_total"]).head(100))


def q1(t, device=None):
    return run_fused(_q1, t, device=device).to_df()


def q1_oracle(d):
    sr = d["store_returns"]
    ctr = (sr.groupby(["sr_customer_sk", "sr_store_sk"], as_index=False)
             .agg(ctr_total=("sr_return_amt", "sum")))
    avg = (ctr.groupby("sr_store_sk", as_index=False)
              .agg(avg_total=("ctr_total", "mean")))
    j = ctr.merge(avg, on="sr_store_sk")
    f = j[j.ctr_total > 1.2 * j.avg_total]
    res = f.merge(d["customer"], left_on="sr_customer_sk",
                  right_on="c_customer_sk")
    return (res[["c_customer_sk", "ctr_total"]]
            .sort_values(["c_customer_sk", "ctr_total"], kind="stable")
            .head(100).reset_index(drop=True))


# --------------------------------------------------------------------------
# q2: web+catalog weekly revenue, year-over-year ratio
# --------------------------------------------------------------------------

def _weekly(t, fact, datecol, extcol, year):
    dd = t["date_dim"]
    d = dd.filter(dd.data("d_year") == year)
    j = t[fact].join(d, [datecol], ["d_date_sk"])
    return j.groupby(["d_week_seq"], [(extcol, "sum", "total")])


def _q2(t):
    def year_total(year):
        w = _rename(_weekly(t, "web_sales", "ws_sold_date_sk",
                            "ws_ext_sales_price", year),
                    total="wtot")
        c = _rename(_weekly(t, "catalog_sales", "cs_sold_date_sk",
                            "cs_ext_sales_price", year),
                    d_week_seq="cweek", total="ctot")
        j = w.join(c, ["d_week_seq"], ["cweek"])
        return j.with_column(
            "total", numeric(j.data("wtot") + j.data("ctot")))

    y1 = year_total(1998).select("d_week_seq", "total")
    y2 = _rename(year_total(1999).select("d_week_seq", "total"),
                 d_week_seq="week2", total="total2")
    shifted = y1.with_column(
        "next_week", numeric(y1.data("d_week_seq") + 52))
    j = shifted.join(y2, ["next_week"], ["week2"])
    out = j.with_column(
        "ratio", numeric(j.data("total") / j.data("total2")))
    return out.select("d_week_seq", "ratio").sort(["d_week_seq"])


def q2(t, device=None):
    return run_fused(_q2, t, device=device).to_df()


def q2_oracle(d):
    def weekly(fact, datecol, extcol, year):
        dd = d["date_dim"]
        j = d[fact].merge(dd[dd.d_year == year], left_on=datecol,
                          right_on="d_date_sk")
        return (j.groupby("d_week_seq", as_index=False)
                 .agg(total=(extcol, "sum")))

    def year_total(year):
        w = weekly("web_sales", "ws_sold_date_sk",
                   "ws_ext_sales_price", year)
        c = weekly("catalog_sales", "cs_sold_date_sk",
                   "cs_ext_sales_price", year)
        j = w.merge(c, on="d_week_seq", suffixes=("_w", "_c"))
        j["total"] = j.total_w + j.total_c
        return j[["d_week_seq", "total"]]

    y1, y2 = year_total(1998), year_total(1999)
    y1 = y1.assign(next_week=y1.d_week_seq + 52)
    j = y1.merge(y2, left_on="next_week", right_on="d_week_seq",
                 suffixes=("", "_y2"))
    j["ratio"] = j.total / j.total_y2
    return (j[["d_week_seq", "ratio"]]
            .sort_values("d_week_seq", kind="stable")
            .reset_index(drop=True))


# --------------------------------------------------------------------------
# q3: November brand revenue by year for one manufacturer
# --------------------------------------------------------------------------

def _q3(t):
    dd = t["date_dim"]
    it = t["item"]
    nov = dd.filter(dd.data("d_moy") == 11)
    manu = it.filter(it.data("i_manufact_id") == 5)
    j = (t["store_sales"]
         .join(nov, ["ss_sold_date_sk"], ["d_date_sk"])
         .join(manu, ["ss_item_sk"], ["i_item_sk"]))
    gb = j.groupby(["d_year", "i_brand_id"],
                   [("ss_ext_sales_price", "sum", "sum_agg")])
    return gb.sort(["d_year", "sum_agg", "i_brand_id"],
                   descending=[False, True, False]).head(100)


def q3(t, device=None):
    return run_fused(_q3, t, device=device).to_df()


def q3_oracle(d):
    dd, it = d["date_dim"], d["item"]
    j = (d["store_sales"]
         .merge(dd[dd.d_moy == 11], left_on="ss_sold_date_sk",
                right_on="d_date_sk")
         .merge(it[it.i_manufact_id == 5], left_on="ss_item_sk",
                right_on="i_item_sk"))
    gb = (j.groupby(["d_year", "i_brand_id"], as_index=False)
           .agg(sum_agg=("ss_ext_sales_price", "sum")))
    return (gb.sort_values(["d_year", "sum_agg", "i_brand_id"],
                           ascending=[True, False, True], kind="stable")
            .head(100).reset_index(drop=True))


# --------------------------------------------------------------------------
# q4: customers whose web growth outpaces store growth
# --------------------------------------------------------------------------

def _q4(t):
    def chan_year(fact, datecol, custcol, extcol, year, out):
        dd = t["date_dim"]
        d = dd.filter(dd.data("d_year") == year)
        j = t[fact].join(d, [datecol], ["d_date_sk"])
        return _rename(j.groupby([custcol], [(extcol, "sum", out)]),
                       **{custcol: "cust"})

    ss98 = chan_year("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                     "ss_ext_sales_price", 1998, "ss98")
    ss99 = chan_year("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                     "ss_ext_sales_price", 1999, "ss99")
    ws98 = chan_year("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
                     "ws_ext_sales_price", 1998, "ws98")
    ws99 = chan_year("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
                     "ws_ext_sales_price", 1999, "ws99")
    j = (ss98.join(_rename(ss99, cust="c2"), ["cust"], ["c2"])
             .join(_rename(ws98, cust="c3"), ["cust"], ["c3"])
             .join(_rename(ws99, cust="c4"), ["cust"], ["c4"]))
    growth_ok = (j.data("ws99") * j.data("ss98") >
                 j.data("ss99") * j.data("ws98"))
    f = j.filter(growth_ok & (j.data("ss98") > 0) & (j.data("ws98") > 0))
    return (f.select("cust", "ss98", "ss99", "ws98", "ws99")
             .sort(["cust"]).head(100))


def q4(t, device=None):
    return run_fused(_q4, t, device=device).to_df()


def q4_oracle(d):
    def chan_year(fact, datecol, custcol, extcol, year, out):
        dd = d["date_dim"]
        j = d[fact].merge(dd[dd.d_year == year], left_on=datecol,
                          right_on="d_date_sk")
        g = (j.groupby(custcol, as_index=False).agg(**{out: (extcol,
                                                             "sum")}))
        return g.rename(columns={custcol: "cust"})

    ss98 = chan_year("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                     "ss_ext_sales_price", 1998, "ss98")
    ss99 = chan_year("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                     "ss_ext_sales_price", 1999, "ss99")
    ws98 = chan_year("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
                     "ws_ext_sales_price", 1998, "ws98")
    ws99 = chan_year("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
                     "ws_ext_sales_price", 1999, "ws99")
    j = ss98.merge(ss99, on="cust").merge(ws98, on="cust").merge(
        ws99, on="cust")
    f = j[(j.ws99 * j.ss98 > j.ss99 * j.ws98) & (j.ss98 > 0) &
          (j.ws98 > 0)]
    return (f[["cust", "ss98", "ss99", "ws98", "ws99"]]
            .sort_values("cust", kind="stable").head(100)
            .reset_index(drop=True))


# --------------------------------------------------------------------------
# q5: per-store sales/returns/net rollup (left join: stores w/o returns)
# --------------------------------------------------------------------------

def _q5(t):
    s = t["store_sales"].groupby(
        ["ss_store_sk"],
        [("ss_ext_sales_price", "sum", "sales"),
         ("ss_net_profit", "sum", "profit")])
    r = _rename(t["store_returns"].groupby(
        ["sr_store_sk"], [("sr_return_amt", "sum", "returns_")]),
        sr_store_sk="store2")
    j = s.join(r, ["ss_store_sk"], ["store2"], how="left")
    ret = j.col("returns_")
    filled = torch.where(ret.valid_bool(), ret.data, 0.0)
    out = j.with_column("returns_f", numeric(filled))
    out = out.with_column(
        "net", numeric(out.data("profit") - filled))
    return (out.select("ss_store_sk", "sales", "returns_f", "net")
               .sort(["ss_store_sk"]))


def q5(t, device=None):
    return run_fused(_q5, t, device=device).to_df()


def q5_oracle(d):
    s = (d["store_sales"].groupby("ss_store_sk", as_index=False)
         .agg(sales=("ss_ext_sales_price", "sum"),
              profit=("ss_net_profit", "sum")))
    r = (d["store_returns"].groupby("sr_store_sk", as_index=False)
         .agg(returns_f=("sr_return_amt", "sum")))
    j = s.merge(r, left_on="ss_store_sk", right_on="sr_store_sk",
                how="left")
    j["returns_f"] = j["returns_f"].fillna(0.0)
    j["net"] = j.profit - j.returns_f
    return (j[["ss_store_sk", "sales", "returns_f", "net"]]
            .sort_values("ss_store_sk", kind="stable")
            .reset_index(drop=True))


# --------------------------------------------------------------------------
# q6: states with >=10 customers buying items priced 1.2x category avg
# --------------------------------------------------------------------------

def _q6(t):
    it = t["item"]
    avgcat = _rename(it.groupby(["i_category_id"],
                                [("i_current_price", "mean",
                                  "avg_price")]),
                     i_category_id="cat2")
    pricey = it.join(avgcat, ["i_category_id"], ["cat2"])
    pricey = pricey.filter(pricey.data("i_current_price") >
                           1.2 * pricey.data("avg_price"))
    dd = t["date_dim"]
    may99 = dd.filter((dd.data("d_year") == 1999) &
                      (dd.data("d_moy") == 5))
    j = (t["store_sales"]
         .join(may99, ["ss_sold_date_sk"], ["d_date_sk"])
         .join(pricey, ["ss_item_sk"], ["i_item_sk"])
         .join(t["customer"], ["ss_customer_sk"], ["c_customer_sk"])
         .join(t["customer_address"], ["c_current_addr_sk"],
               ["ca_address_sk"]))
    gb = j.groupby(["ca_state"], [("ss_quantity", "count", "cnt")])
    f = gb.filter(gb.data("cnt") >= 10)
    return f.sort(["cnt", "ca_state"], descending=[True, False])


def q6(t, device=None):
    return run_fused(_q6, t, device=device).to_df()


def q6_oracle(d):
    it = d["item"]
    avgcat = (it.groupby("i_category_id", as_index=False)
                .agg(avg_price=("i_current_price", "mean")))
    pricey = it.merge(avgcat, on="i_category_id")
    pricey = pricey[pricey.i_current_price > 1.2 * pricey.avg_price]
    dd = d["date_dim"]
    j = (d["store_sales"]
         .merge(dd[(dd.d_year == 1999) & (dd.d_moy == 5)],
                left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(pricey, left_on="ss_item_sk", right_on="i_item_sk")
         .merge(d["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
         .merge(d["customer_address"], left_on="c_current_addr_sk",
                right_on="ca_address_sk"))
    gb = (j.groupby("ca_state", as_index=False)
           .agg(cnt=("ss_quantity", "count")))
    f = gb[gb.cnt >= 10]
    return (f.sort_values(["cnt", "ca_state"], ascending=[False, True],
                          kind="stable").reset_index(drop=True))


# --------------------------------------------------------------------------
# q7: demographic average item metrics under promotion filters
# --------------------------------------------------------------------------

def _q7(t):
    cd = t["customer_demographics"]
    cdf = cd.filter((cd.data("cd_gender") == 0) &
                    (cd.data("cd_marital_status") == 1))
    pr = t["promotion"]
    prf = pr.filter((pr.data("p_channel_email") == 0) |
                    (pr.data("p_channel_event") == 0))
    j = (t["store_sales"]
         .join(cdf, ["ss_cdemo_sk"], ["cd_demo_sk"])
         .join(prf, ["ss_promo_sk"], ["p_promo_sk"])
         .join(t["item"], ["ss_item_sk"], ["i_item_sk"]))
    gb = j.groupby(["i_item_sk"],
                   [("ss_quantity", "mean", "agg1"),
                    ("ss_sales_price", "mean", "agg2"),
                    ("ss_ext_sales_price", "mean", "agg3")])
    return gb.sort(["i_item_sk"]).head(100)


def q7(t, device=None):
    return run_fused(_q7, t, device=device).to_df()


def q7_oracle(d):
    cd = d["customer_demographics"]
    pr = d["promotion"]
    j = (d["store_sales"]
         .merge(cd[(cd.cd_gender == 0) & (cd.cd_marital_status == 1)],
                left_on="ss_cdemo_sk", right_on="cd_demo_sk")
         .merge(pr[(pr.p_channel_email == 0) | (pr.p_channel_event == 0)],
                left_on="ss_promo_sk", right_on="p_promo_sk")
         .merge(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    gb = (j.groupby("i_item_sk", as_index=False)
           .agg(agg1=("ss_quantity", "mean"),
                agg2=("ss_sales_price", "mean"),
                agg3=("ss_ext_sales_price", "mean")))
    return (gb.sort_values("i_item_sk", kind="stable").head(100)
            .reset_index(drop=True))


# --------------------------------------------------------------------------
# q8: store net profit for customers in preferred zips (semi joins)
# --------------------------------------------------------------------------

def _q8(t):
    ca = t["customer_address"]
    preferred = ca.filter(ca.data("ca_zip") < 40_000)
    cust = t["customer"].join(preferred, ["c_current_addr_sk"],
                              ["ca_address_sk"], how="semi")
    dd = t["date_dim"]
    q1_98 = dd.filter((dd.data("d_year") == 1998) &
                      (dd.data("d_moy") <= 3))
    j = (t["store_sales"]
         .join(q1_98, ["ss_sold_date_sk"], ["d_date_sk"])
         .join(cust, ["ss_customer_sk"], ["c_customer_sk"], how="semi")
         .join(t["store"], ["ss_store_sk"], ["s_store_sk"]))
    gb = j.groupby(["s_store_name"],
                   [("ss_net_profit", "sum", "profit")])
    return gb.sort(["s_store_name"])


def q8(t, device=None):
    return run_fused(_q8, t, device=device).to_df()


def q8_oracle(d):
    ca = d["customer_address"]
    pref = ca[ca.ca_zip < 40_000]
    cust = d["customer"][d["customer"].c_current_addr_sk.isin(
        pref.ca_address_sk)]
    dd = d["date_dim"]
    j = (d["store_sales"]
         .merge(dd[(dd.d_year == 1998) & (dd.d_moy <= 3)],
                left_on="ss_sold_date_sk", right_on="d_date_sk"))
    j = j[j.ss_customer_sk.isin(cust.c_customer_sk)]
    j = j.merge(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
    gb = (j.groupby("s_store_name", as_index=False)
           .agg(profit=("ss_net_profit", "sum")))
    return (gb.sort_values("s_store_name", kind="stable")
            .reset_index(drop=True))


# --------------------------------------------------------------------------
# q9: quantity-bucket conditional aggregates (CASE WHEN shape)
# --------------------------------------------------------------------------

_Q9_BUCKETS = [(1, 4), (5, 8), (9, 12), (13, 16), (17, 20)]


def _q9(t):
    # CASE WHEN buckets as five masked reductions; the result is a
    # single-row Rel, so the scalar math stays on the device and inside
    # the fused run. The reductions go through the Rel scalar API
    # (sum_where/count_where), which applies the row mask.
    ss = t["store_sales"]
    qty = ss.data("ss_quantity")
    ext = ss.data("ss_ext_sales_price")
    cols, names = [], []
    for lo, hi in _Q9_BUCKETS:
        sel = (qty >= lo) & (qty <= hi)
        cnt = ss.count_where(sel)
        total = ss.sum_where(ext, sel)
        val = torch.where(cnt > 0, total / torch.clamp(cnt, min=1),
                          float("nan"))
        cols.append(numeric(torch.reshape(val, (1,))))
        names.append(f"bucket_{lo}_{hi}")
    return Rel(Table(cols), names)


def q9(t, device=None):
    return run_fused(_q9, t, device=device).to_df()


def q9_oracle(d):
    ss = d["store_sales"]
    out = {}
    for lo, hi in _Q9_BUCKETS:
        sel = ss[(ss.ss_quantity >= lo) & (ss.ss_quantity <= hi)]
        out[f"bucket_{lo}_{hi}"] = [sel.ss_ext_sales_price.mean()
                                    if len(sel) else float("nan")]
    import pandas as pd
    return pd.DataFrame(out)


# --------------------------------------------------------------------------
# q10: demographics of county customers active in store AND web/catalog
# --------------------------------------------------------------------------

def _q10(t):
    ca = t["customer_address"]
    counties = ca.filter(ca.data("ca_county") <= 7)
    cust = (t["customer"]
            .join(counties, ["c_current_addr_sk"], ["ca_address_sk"],
                  how="semi")
            .join(t["store_sales"], ["c_customer_sk"],
                  ["ss_customer_sk"], how="semi"))
    in_web = cust.join(t["web_sales"], ["c_customer_sk"],
                       ["ws_bill_customer_sk"], how="semi")
    in_cat_only = (cust
                   .join(t["catalog_sales"], ["c_customer_sk"],
                         ["cs_bill_customer_sk"], how="semi")
                   .join(t["web_sales"], ["c_customer_sk"],
                         ["ws_bill_customer_sk"], how="anti"))
    active = in_web.concat(in_cat_only)
    j = active.join(t["customer_demographics"], ["c_current_cdemo_sk"],
                    ["cd_demo_sk"])
    gb = j.groupby(["cd_gender", "cd_marital_status"],
                   [("cd_education", "count", "cnt")])
    return gb.sort(["cd_gender", "cd_marital_status"])


def q10(t, device=None):
    return run_fused(_q10, t, device=device).to_df()


def q10_oracle(d):
    ca = d["customer_address"]
    counties = ca[ca.ca_county <= 7]
    c = d["customer"]
    cust = c[c.c_current_addr_sk.isin(counties.ca_address_sk)]
    cust = cust[cust.c_customer_sk.isin(d["store_sales"].ss_customer_sk)]
    web = set(d["web_sales"].ws_bill_customer_sk)
    cat = set(d["catalog_sales"].cs_bill_customer_sk)
    active = cust[cust.c_customer_sk.map(
        lambda k: k in web or k in cat)]
    j = active.merge(d["customer_demographics"],
                     left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
    gb = (j.groupby(["cd_gender", "cd_marital_status"], as_index=False)
           .agg(cnt=("cd_education", "count")))
    return (gb.sort_values(["cd_gender", "cd_marital_status"],
                           kind="stable").reset_index(drop=True))


# --------------------------------------------------------------------------
# q11-q20: the operator-library surface (tpcds/oplib/) — string
# predicates/projections, decimal price math with overflow -> NULL, and
# window functions, all through the same fused runner and budgets.
# --------------------------------------------------------------------------

# q11: revenue by state for stores in states containing "A" (string
# predicate on a dictionary-encoded dimension column)

def _q11(t):
    j = t["store_sales"].join(t["store"], ["ss_store_sk"], ["s_store_sk"])
    f = j.filter(S.contains(j, "s_state", "A"))
    gb = f.groupby(["s_state"],
                   [("ss_ext_sales_price", "sum", "rev"),
                    ("ss_quantity", "count", "cnt")])
    return gb.sort(["s_state"])


def q11(t, device=None):
    return run_fused(_q11, t, device=device).to_df()


def q11_oracle(d):
    j = d["store_sales"].merge(d["store"], left_on="ss_store_sk",
                               right_on="s_store_sk")
    f = j[j.s_state.str.contains("A", regex=False)]
    gb = (f.groupby("s_state", as_index=False)
           .agg(rev=("ss_ext_sales_price", "sum"),
                cnt=("ss_quantity", "count")))
    return (gb.sort_values("s_state", kind="stable")
            .reset_index(drop=True))


# q12: quantity by product-name prefix for items whose name matches a
# LIKE pattern (string projection feeding a dense groupby)

def _q12(t):
    it = t["item"].filter(S.like(t["item"], "i_product_name", "S%"))
    it = S.substr(it, "i_product_name", 0, 5, "prod5")
    j = t["store_sales"].join(it, ["ss_item_sk"], ["i_item_sk"])
    gb = j.groupby(["prod5"], [("ss_quantity", "sum", "qty")])
    return gb.sort(["prod5"])


def q12(t, device=None):
    return run_fused(_q12, t, device=device).to_df()


def q12_oracle(d):
    it = d["item"]
    it = it[it.i_product_name.str.startswith("S")].copy()
    it["prod5"] = it.i_product_name.str.slice(0, 5)
    j = d["store_sales"].merge(it, left_on="ss_item_sk",
                               right_on="i_item_sk")
    gb = j.groupby("prod5", as_index=False).agg(qty=("ss_quantity",
                                                     "sum"))
    return gb.sort_values("prod5", kind="stable").reset_index(drop=True)


# q13: exact decimal revenue per store (decimal multiply + decimal sum)

def _q13(t):
    ss = D.as_decimal(t["store_sales"], "ss_list_price_cents", -2)
    ss = D.as_decimal(ss, "ss_quantity", 0, out="qty_dec")
    ss = D.arith(ss, "mul", "ss_list_price_cents", "qty_dec",
                 ("dec64", -2), "revenue")
    gb = ss.groupby(["ss_store_sk"], [("revenue", "sum", "total")])
    return gb.sort(["ss_store_sk"])


def q13(t, device=None):
    return run_fused(_q13, t, device=device).to_df()


def q13_oracle(d):
    ss = d["store_sales"]
    cents = ss.ss_list_price_cents.astype(object) * ss.ss_quantity
    g = (ss.assign(_c=cents).groupby("ss_store_sk", as_index=False)
         .agg(total=("_c", "sum")))
    g["total"] = g["total"].map(
        lambda v: decimal.Decimal(int(v)).scaleb(-2))
    return (g.sort_values("ss_store_sk", kind="stable")
            .reset_index(drop=True))


# q14: big-ticket nets — decimal subtract, exact literal comparison,
# grouped decimal aggregates

def _q14(t):
    ss = D.as_decimal(t["store_sales"], "ss_list_price_cents", -2)
    ss = D.as_decimal(ss, "ss_coupon_amt_cents", -2)
    ss = D.arith(ss, "sub", "ss_list_price_cents",
                 "ss_coupon_amt_cents", ("dec64", -2), "net")
    f = ss.filter(D.cmp(ss, "net", "gt", "100.00"))
    gb = f.groupby(["ss_store_sk"], [("net", "sum", "net_total"),
                                     ("net", "count", "n_big")])
    return gb.sort(["ss_store_sk"])


def q14(t, device=None):
    return run_fused(_q14, t, device=device).to_df()


def q14_oracle(d):
    ss = d["store_sales"]
    net = (ss.ss_list_price_cents - ss.ss_coupon_amt_cents).astype(object)
    f = ss.assign(_net=net)[net > 10_000]
    g = (f.groupby("ss_store_sk", as_index=False)
         .agg(net_total=("_net", "sum"), n_big=("_net", "size")))
    g["net_total"] = g["net_total"].map(
        lambda v: decimal.Decimal(int(v)).scaleb(-2))
    g["n_big"] = g["n_big"].astype(np.int64)
    return (g.sort_values("ss_store_sk", kind="stable")
            .reset_index(drop=True))


# q15: Spark CheckOverflow — DECIMAL32 products overflow to NULL, the
# nulls are skipped by sum/count, and every overflow is counted
# (rel.route.decimal.overflow via the runtime-counter channel)

def _q15(t):
    ss = D.as_decimal(t["store_sales"], "ss_list_price_cents", -2)
    ss = D.as_decimal(ss, "ss_coupon_amt_cents", -2)
    ss = D.arith(ss, "mul", "ss_list_price_cents",
                 "ss_coupon_amt_cents", ("dec32", -4), "cross")
    gb = ss.groupby(["ss_store_sk"], [("cross", "sum", "cross_sum"),
                                      ("cross", "count", "n_ok")])
    return gb.sort(["ss_store_sk"])


def q15(t, device=None):
    return run_fused(_q15, t, device=device).to_df()


def q15_oracle(d):
    ss = d["store_sales"]
    limit = 2**31 - 1
    prod = (ss.ss_list_price_cents.astype(object)
            * ss.ss_coupon_amt_cents)
    ok = prod <= limit
    g = (ss.assign(_p=prod.where(ok), _ok=ok)
         .groupby("ss_store_sk", as_index=False)
         .agg(cross_sum=("_p", lambda s: s.dropna().sum()),
              n_ok=("_ok", "sum")))
    g["cross_sum"] = g["cross_sum"].map(
        lambda v: decimal.Decimal(int(v)).scaleb(-4))
    g["n_ok"] = g["n_ok"].astype(np.int64)
    return (g.sort_values("ss_store_sk", kind="stable")
            .reset_index(drop=True))


# q16: top-3 items per store by revenue — window row_number over a
# grouped aggregate, rank filter, deterministic tiebreak

def _q16(t):
    gb = t["store_sales"].groupby(
        ["ss_store_sk", "ss_item_sk"],
        [("ss_ext_sales_price", "sum", "rev")])
    w = gb.window(["ss_store_sk"], ["rev", "ss_item_sk"],
                  [("row_number", None, "rn")],
                  descending=[True, False])
    f = w.filter(w.data("rn") <= 3)
    return (f.select("ss_store_sk", "ss_item_sk", "rev", "rn")
             .sort(["ss_store_sk", "rn"]))


def q16(t, device=None):
    return run_fused(_q16, t, device=device).to_df()


def q16_oracle(d):
    gb = (d["store_sales"]
          .groupby(["ss_store_sk", "ss_item_sk"], as_index=False)
          .agg(rev=("ss_ext_sales_price", "sum")))
    o = gb.sort_values(["rev", "ss_item_sk"], ascending=[False, True],
                       kind="stable")
    gb["rn"] = (o.groupby("ss_store_sk").cumcount() + 1) \
        .reindex(gb.index).astype(np.int64)
    f = gb[gb.rn <= 3]
    return (f[["ss_store_sk", "ss_item_sk", "rev", "rn"]]
            .sort_values(["ss_store_sk", "rn"], kind="stable")
            .reset_index(drop=True))


# q17: brand popularity rank within category — RANK() with real ties
# (equal sale counts share a rank, gaps after)

def _q17(t):
    j = t["store_sales"].join(t["item"], ["ss_item_sk"], ["i_item_sk"])
    gb = j.groupby(["i_category_id", "i_brand_id"],
                   [("ss_quantity", "count", "cnt")])
    w = gb.window(["i_category_id"], ["cnt"],
                  [("rank", None, "rnk")], descending=[True])
    return (w.select("i_category_id", "i_brand_id", "cnt", "rnk")
             .sort(["i_category_id", "rnk", "i_brand_id"]))


def q17(t, device=None):
    return run_fused(_q17, t, device=device).to_df()


def q17_oracle(d):
    j = d["store_sales"].merge(d["item"], left_on="ss_item_sk",
                               right_on="i_item_sk")
    gb = (j.groupby(["i_category_id", "i_brand_id"], as_index=False)
          .agg(cnt=("ss_quantity", "count")))
    gb["rnk"] = (gb.groupby("i_category_id")["cnt"]
                 .rank(method="min", ascending=False).astype(np.int64))
    return (gb[["i_category_id", "i_brand_id", "cnt", "rnk"]]
            .sort_values(["i_category_id", "rnk", "i_brand_id"],
                         kind="stable").reset_index(drop=True))


# q18: above-average baskets — sum/count over partition on the raw fact
# table (the sharded exchange_by_keys shape), exact integer algebra

def _q18(t):
    ss = t["store_sales"]
    w = ss.window(["ss_store_sk"], [],
                  [("sum", "ss_quantity", "store_qty"),
                   ("count", "ss_quantity", "store_n")])
    f = w.filter(w.data("ss_quantity") * w.data("store_n")
                 > w.data("store_qty"))
    gb = f.groupby(["ss_store_sk"], [("ss_quantity", "count", "n_above"),
                                     ("ss_quantity", "sum", "qty_above")])
    return gb.sort(["ss_store_sk"])


def q18(t, device=None):
    return run_fused(_q18, t, device=device).to_df()


def q18_oracle(d):
    ss = d["store_sales"]
    g = ss.groupby("ss_store_sk")["ss_quantity"]
    above = ss[ss.ss_quantity * g.transform("count")
               > g.transform("sum")]
    gb = (above.groupby("ss_store_sk", as_index=False)
          .agg(n_above=("ss_quantity", "count"),
               qty_above=("ss_quantity", "sum")))
    return (gb.sort_values("ss_store_sk", kind="stable")
            .reset_index(drop=True))


# q19: first-day purchases per customer — RANK over the fact table
# (rank==1 is an order-stable SET: every purchase on the customer's
# earliest date), then a per-customer rollup

def _q19(t):
    ss = t["store_sales"]
    w = ss.window(["ss_customer_sk"], ["ss_sold_date_sk"],
                  [("rank", None, "visit_rank")])
    f = w.filter(w.data("visit_rank") == 1)
    gb = f.groupby(["ss_customer_sk"],
                   [("ss_quantity", "count", "first_day_buys")])
    return gb.sort(["ss_customer_sk"]).head(100)


def q19(t, device=None):
    return run_fused(_q19, t, device=device).to_df()


def q19_oracle(d):
    ss = d["store_sales"]
    first = ss.groupby("ss_customer_sk")["ss_sold_date_sk"] \
        .transform("min")
    f = ss[ss.ss_sold_date_sk == first]
    gb = (f.groupby("ss_customer_sk", as_index=False)
          .agg(first_day_buys=("ss_quantity", "count")))
    return (gb.sort_values("ss_customer_sk", kind="stable")
            .head(100).reset_index(drop=True))


# q20: all three families in one plan — LIKE-filtered items, exact
# decimal revenue, and a per-state store ranking window

def _q20(t):
    it = t["item"].filter(S.like(t["item"], "i_product_name", "%0%"))
    j = (t["store_sales"]
         .join(it, ["ss_item_sk"], ["i_item_sk"])
         .join(t["store"], ["ss_store_sk"], ["s_store_sk"]))
    j = D.as_decimal(j, "ss_list_price_cents", -2)
    j = D.as_decimal(j, "ss_quantity", 0, out="qty_dec")
    j = D.arith(j, "mul", "ss_list_price_cents", "qty_dec",
                ("dec64", -2), "revenue")
    gb = j.groupby(["s_state", "ss_store_sk"],
                   [("revenue", "sum", "rev_total"),
                    ("ss_quantity", "sum", "qty_total")])
    w = gb.window(["s_state"], ["qty_total", "ss_store_sk"],
                  [("row_number", None, "rn")],
                  descending=[True, False])
    f = w.filter(w.data("rn") <= 2)
    return (f.select("s_state", "ss_store_sk", "rev_total",
                     "qty_total", "rn")
             .sort(["s_state", "rn"]))


def q20(t, device=None):
    return run_fused(_q20, t, device=device).to_df()


def q20_oracle(d):
    it = d["item"]
    it = it[it.i_product_name.str.contains("0", regex=False)]
    j = (d["store_sales"]
         .merge(it, left_on="ss_item_sk", right_on="i_item_sk")
         .merge(d["store"], left_on="ss_store_sk",
                right_on="s_store_sk"))
    j = j.assign(_rev=j.ss_list_price_cents.astype(object)
                 * j.ss_quantity)
    gb = (j.groupby(["s_state", "ss_store_sk"], as_index=False)
          .agg(rev_total=("_rev", "sum"),
               qty_total=("ss_quantity", "sum")))
    o = gb.sort_values(["qty_total", "ss_store_sk"],
                       ascending=[False, True], kind="stable")
    gb["rn"] = (o.groupby("s_state").cumcount() + 1) \
        .reindex(gb.index).astype(np.int64)
    gb["rev_total"] = gb["rev_total"].map(
        lambda v: decimal.Decimal(int(v)).scaleb(-2))
    f = gb[gb.rn <= 2]
    return (f[["s_state", "ss_store_sk", "rev_total", "qty_total", "rn"]]
            .sort_values(["s_state", "rn"], kind="stable")
            .reset_index(drop=True))


QUERIES = {
    "q1": (q1, q1_oracle),
    "q2": (q2, q2_oracle),
    "q3": (q3, q3_oracle),
    "q4": (q4, q4_oracle),
    "q5": (q5, q5_oracle),
    "q6": (q6, q6_oracle),
    "q7": (q7, q7_oracle),
    "q8": (q8, q8_oracle),
    "q9": (q9, q9_oracle),
    "q10": (q10, q10_oracle),
    "q11": (q11, q11_oracle),
    "q12": (q12, q12_oracle),
    "q13": (q13, q13_oracle),
    "q14": (q14, q14_oracle),
    "q15": (q15, q15_oracle),
    "q16": (q16, q16_oracle),
    "q17": (q17, q17_oracle),
    "q18": (q18, q18_oracle),
    "q19": (q19, q19_oracle),
    "q20": (q20, q20_oracle),
}

# the plan functions, for callers that drive run_fused themselves
PLANS = {q: globals()[f"_{q}"] for q in QUERIES}
