"""TPC-DS miniature data generator (scaled star schema).

A copy of ``spark_rapids_jni_tpu/tpcds/data.py`` (the port imports
nothing of the reference). ``generate``: row counts scale linearly with
``sf`` from ~10k store_sales rows at sf=1, with big fact tables, small
dimensions and skewed foreign keys. The draws come from numpy
``default_rng(seed)`` in the reference's order, so the frames are equal
to the reference's for the same (sf, seed). ``ingest`` turns the frames
into rels with the schema's decimal columns typed; ``as_table`` and
``as_sharded_table`` build plain tables, the second one this rank's row
chunk over a mesh.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

_STATES = ["CA", "TX", "NY", "WA", "GA", "OH", "MI", "IL", "NC", "TN"]
_CATEGORIES = ["Books", "Home", "Electronics", "Music", "Shoes",
               "Sports", "Women", "Men"]


def generate(sf: float = 1.0, seed: int = 0) -> "dict[str, pd.DataFrame]":
    """Generate the miniature star schema at scale factor ``sf``."""
    rng = np.random.default_rng(seed)
    n_ss = max(int(10_000 * sf), 100)
    n_ws = max(n_ss // 4, 50)
    n_cs = max(n_ss // 3, 50)
    n_sr = max(n_ss // 10, 20)
    n_item = max(int(200 * np.sqrt(sf)), 20)
    n_cust = max(int(500 * np.sqrt(sf)), 50)
    n_store = max(int(12 * np.sqrt(sf)), 4)
    n_addr = max(n_cust // 2, 20)
    n_demo = 40
    n_promo = 30

    # 5 years x 52 weeks x 7 days of date rows
    n_date = 5 * 52 * 7
    day = np.arange(n_date)
    date_dim = pd.DataFrame({
        "d_date_sk": day,
        "d_year": 1998 + day // 364,
        "d_moy": (day % 364) // 30 % 12 + 1,
        "d_week_seq": day // 7,
        "d_dom": day % 30 + 1,
    })

    item = pd.DataFrame({
        "i_item_sk": np.arange(n_item),
        "i_brand_id": rng.integers(1, 50, n_item),
        "i_category_id": rng.integers(0, len(_CATEGORIES), n_item),
        "i_manufact_id": rng.integers(1, 20, n_item),
        "i_current_price": np.round(rng.uniform(0.5, 300, n_item), 2),
    })
    item["i_category"] = [
        _CATEGORIES[c] for c in item["i_category_id"]]

    store = pd.DataFrame({
        "s_store_sk": np.arange(n_store),
        "s_state": [_STATES[i % len(_STATES)] for i in range(n_store)],
        "s_store_name": [f"store_{i:03d}" for i in range(n_store)],
    })

    customer_address = pd.DataFrame({
        "ca_address_sk": np.arange(n_addr),
        "ca_state": [_STATES[i] for i in rng.integers(0, len(_STATES),
                                                      n_addr)],
        "ca_zip": rng.integers(10_000, 99_999, n_addr),
        "ca_county": rng.integers(0, 25, n_addr),
    })

    customer = pd.DataFrame({
        "c_customer_sk": np.arange(n_cust),
        "c_current_addr_sk": rng.integers(0, n_addr, n_cust),
        "c_current_cdemo_sk": rng.integers(0, n_demo, n_cust),
    })

    customer_demographics = pd.DataFrame({
        "cd_demo_sk": np.arange(n_demo),
        "cd_gender": rng.integers(0, 2, n_demo),
        "cd_marital_status": rng.integers(0, 3, n_demo),
        "cd_education": rng.integers(0, 5, n_demo),
    })

    promotion = pd.DataFrame({
        "p_promo_sk": np.arange(n_promo),
        "p_channel_email": rng.integers(0, 2, n_promo),
        "p_channel_event": rng.integers(0, 2, n_promo),
    })

    def fact(n, prefix, cust_col, with_store=False):
        # zipf-flavored item skew: hot items dominate, like real sales
        items = (rng.zipf(1.3, n) - 1) % n_item
        df = pd.DataFrame({
            f"{prefix}_sold_date_sk": rng.integers(0, n_date, n),
            f"{prefix}_item_sk": items,
            cust_col: rng.integers(0, n_cust, n),
            f"{prefix}_quantity": rng.integers(1, 21, n),
            f"{prefix}_sales_price": np.round(rng.uniform(1, 150, n), 2),
            f"{prefix}_ext_sales_price": 0.0,
            f"{prefix}_net_profit": np.round(rng.normal(8, 30, n), 2),
        })
        df[f"{prefix}_ext_sales_price"] = np.round(
            df[f"{prefix}_quantity"] * df[f"{prefix}_sales_price"], 2)
        if with_store:
            df[f"{prefix}_store_sk"] = rng.integers(0, n_store, n)
        return df

    store_sales = fact(n_ss, "ss", "ss_customer_sk", with_store=True)
    store_sales["ss_cdemo_sk"] = rng.integers(0, n_demo, n_ss)
    store_sales["ss_promo_sk"] = rng.integers(0, n_promo, n_ss)
    web_sales = fact(n_ws, "ws", "ws_bill_customer_sk")
    catalog_sales = fact(n_cs, "cs", "cs_bill_customer_sk")

    store_returns = pd.DataFrame({
        "sr_returned_date_sk": rng.integers(0, n_date, n_sr),
        "sr_item_sk": rng.integers(0, n_item, n_sr),
        "sr_customer_sk": rng.integers(0, n_cust, n_sr),
        "sr_store_sk": rng.integers(0, n_store, n_sr),
        "sr_return_amt": np.round(rng.uniform(1, 200, n_sr), 2),
    })

    # Operator-library columns (q11-q20: strings, decimals, windows).
    # Drawn AFTER every pre-existing draw on purpose: the rng stream
    # consumed by the columns above is untouched, so q1-q10 outputs stay
    # byte-identical across library revisions (the oplib regression
    # contract in tests/test_oplib.py).
    item["i_product_name"] = [
        f"{_CATEGORIES[c]}_{b:02d}_{i:04d}"
        for i, (c, b) in enumerate(zip(item["i_category_id"],
                                       item["i_brand_id"]))]
    # exact money amounts as integer cents (ingest declares them
    # DECIMAL64 scale -2, or templates reinterpret in-plan via
    # oplib.decimals.as_decimal); the wide range makes DECIMAL32
    # products genuinely overflow in q15's CheckOverflow shape
    store_sales["ss_list_price_cents"] = rng.integers(100, 60_001, n_ss)
    store_sales["ss_coupon_amt_cents"] = rng.integers(0, 60_001, n_ss)
    web_sales["ws_list_price_cents"] = rng.integers(100, 30_001, n_ws)

    return {
        "date_dim": date_dim,
        "item": item,
        "store": store,
        "customer": customer,
        "customer_address": customer_address,
        "customer_demographics": customer_demographics,
        "promotion": promotion,
        "store_sales": store_sales,
        "store_returns": store_returns,
        "web_sales": web_sales,
        "catalog_sales": catalog_sales,
    }


# Integer cents columns typed DECIMAL64 at ingest (the reference's
# DECIMAL_COLUMNS: value = stored * 10^scale).
DECIMAL_COLUMNS = {
    "ss_list_price_cents": -2,
    "ss_coupon_amt_cents": -2,
    "ws_list_price_cents": -2,
}


def ingest(data: "dict[str, pd.DataFrame]", device=None):
    """Generated frames -> Rel dict on ``device`` (``cuda`` unless the
    caller passes another), the schema's decimal columns typed DECIMAL64
    (``tpcds/rel.rel_from_df``'s ``decimals``)."""
    from .rel import rel_from_df
    out = {}
    for name, df in data.items():
        decs = {c: s for c, s in DECIMAL_COLUMNS.items() if c in df.columns}
        out[name] = rel_from_df(df, decimals=decs or None, device=device)
    return out


def as_table(df: pd.DataFrame, device=None):
    """pandas frame -> Table on ``device`` (``cuda`` unless the caller
    passes another); object columns become STRING, int32 widens to
    int64."""
    from ..columnar import Column, Table
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    cols = []
    for name in df.columns:
        s = df[name]
        if not pd.api.types.is_numeric_dtype(s.dtype):
            cols.append(Column.strings_from_list(
                [None if v is None else str(v) for v in s], device=dev))
        else:
            arr = np.ascontiguousarray(s.to_numpy())
            if arr.dtype == np.int32:
                arr = arr.astype(np.int64)
            cols.append(Column.from_numpy(arr, device=dev))
    return Table(cols)


def as_sharded_table(df: pd.DataFrame, mesh, axis=None):
    """pandas frame -> this rank's row chunk of it over ``mesh`` and a
    bool mask of the chunk's real rows: the frame's fixed-width columns
    padded to ``shard_capacity`` rows a shard along ``axis`` (default
    ``part``), on the mesh's device. Every rank calls it with the same
    frame. For whole queries ``run_fused(plan, rels, mesh=...)`` shards
    its inputs itself; this serves hand-built pipelines over the mesh."""
    import torch
    from ..columnar import Column, Table
    from ..parallel import PART_AXIS, shard_capacity
    from ..utils.errors import expects
    axis = axis or PART_AXIS
    p = int(mesh.shape[axis])
    index = mesh.axis_index(axis)
    dev = mesh.device
    plain = as_table(df, device="cpu")
    n = plain.num_rows
    cap = shard_capacity(n, p)
    start = index * cap
    cols = []
    for c in plain.columns:
        expects(c.data is not None and not c.children,
                "as_sharded_table shards fixed-width columns only")
        part = c.data[min(start, n):min(start + cap, n)]
        pad = torch.zeros((cap - part.shape[0],) + tuple(part.shape[1:]),
                          dtype=part.dtype)
        cols.append(Column(c.dtype, cap, torch.cat([part, pad]).to(dev),
                           value_range=c.value_range, unique=c.unique))
    mask = (start + torch.arange(cap, dtype=torch.int64, device=dev)) < n
    return Table(cols), mask
