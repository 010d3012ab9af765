"""TPC-DS's power test through the port: one stream of the port's
q1-q20 over the specification's tables, pass after pass.

Set-up makes the configuration's tables on the device from the seed
(``tpcds/spec_data.generate_spec``; ``rows`` is store_sales' row count
and sets the divisor of the scaled tables, so the CPU tests' small sizes
are the same configuration cut down) and runs one pass to warm every
path. A request is one pass: q1, q2, ..., q20 in the traffic's order,
each through ``rel.run_fused`` and in hand as a pandas frame
(``to_df()``) before the next starts; passes run back to back from one
client. A pass's ``work`` is the rows of the base tables its plans read,
each table once a query. After the window every pass's 20 frames are
judged against the plain reference (``reference/tpcds.py``), computed
once over the same tables: keys, counts and decimals exactly, floats
within the configuration's ``float_rtol``. The tables themselves are
held to what the configuration states of them (``table_faults``): the
reference reads the generator's output, so a fault there would feed
both sides alike.

Each window carries what the program counted over it: the planner's
route counters (``routes``), K1's and K2's launch shapes (``shapes``)
and the hand kernels' launches (``launches``), which the per-layer
readers turn into the general route's share and the kernels' bytes.
"""

from __future__ import annotations

import datetime
import math
import sys

from harness.window import Request, Window, now
from reference import tpcds as ref

KERNELS = ("hash_join_probe", "ragged_groupby_sum_count", "bitmask_pack",
           "bitmask_pack_fields")


class State:
    pass


class _Reads(dict):
    """The tables as a plan sees them, noting each one it reads into
    ``read``."""

    def __init__(self, tables, read: set):
        super().__init__(tables)
        self.read = read

    def __getitem__(self, name):
        self.read.add(name)
        return super().__getitem__(name)


def _tables_read(run_fused, plan, rels, device) -> set:
    """The base tables ``plan`` reads: those it asks for, not those the
    runner looks over before it runs the plan."""
    read: set = set()
    run_fused(lambda t: plan(_Reads(t, read)), rels, device=device).to_df()
    return read


def _divisor(config) -> int:
    full = int(config["tables"]["store_sales"])
    return max(1, -(-full // int(config["rows"])))


# a foreign key's table by the key's name past its table's prefix and
# role (``ss_sold_date_sk``, ``cs_bill_customer_sk``: date_dim, customer)
REFERENCES = (("date_sk", "date_dim"), ("time_sk", "time_dim"),
              ("item_sk", "item"), ("customer_sk", "customer"),
              ("cdemo_sk", "customer_demographics"),
              ("hdemo_sk", "household_demographics"),
              ("addr_sk", "customer_address"), ("store_sk", "store"),
              ("promo_sk", "promotion"), ("reason_sk", "reason"),
              ("call_center_sk", "call_center"),
              ("catalog_page_sk", "catalog_page"),
              ("ship_mode_sk", "ship_mode"), ("warehouse_sk", "warehouse"),
              ("web_page_sk", "web_page"), ("web_site_sk", "web_site"))
JULIAN = 1_721_425  # date.toordinal() + JULIAN = the Julian day number


def _jdn(day: str) -> int:
    return datetime.date.fromisoformat(day).toordinal() + JULIAN


def _expected_rows(config, divisor: int) -> dict:
    """The configuration's row counts cut as the CPU tests cut them: a
    scaled table of 1,000 rows or more divided by ``divisor``, to at
    least 1,000; ``fixed_tables`` (the same at every scale factor)
    whole."""
    fixed = set(config["fixed_tables"])
    return {t: n if t in fixed or n < 1000 or divisor == 1
            else max(-(-n // divisor), 1000)
            for t, n in config["tables"].items()}


def _type_of(rel, name: str, c) -> str:
    kind = c.dtype.id.name
    if name in rel.dicts:
        return "STRING"
    return f"{kind}({c.dtype.scale})" if kind.startswith("DECIMAL") \
        else kind


def table_faults(rels: dict, config: dict) -> list:
    """What the generated tables break of the configuration's statement
    of them, read through the same format the reference reads: the
    tables and their row counts; each column's name, type and order;
    a NULL share within six standard deviations of ``null_share`` where
    the column is nullable and no NULL where it is not; a sorted, unique
    dictionary under every STRING column, its codes inside it; each
    dimension's surrogate key (its first column) dense and unique, from
    1 (``d_date_sk`` from ``date_dim_from``'s Julian day; ``time_dim``'s
    keys, not generated, from 0); every foreign key inside its
    table's keys, sales dates inside ``sales_dates``; every stated
    ``value_range`` holding its column's values."""
    import numpy as np
    import torch
    faults = []
    want_rows = _expected_rows(config, _divisor(config))
    if sorted(rels) != sorted(want_rows):
        return [f"tables {sorted(rels)}, not {sorted(want_rows)}"]
    frames = ref.read_tables(rels)
    share = float(config["null_share"])
    keys = {}  # table -> (lo, hi) of its surrogate key
    for t, n in config["foreign_key_ranges"].items():
        keys[t] = (0, n - 1) if t == "time_dim" else (1, n)
    for t, rel in rels.items():
        if any(c.endswith(":NULL") for c in config["columns"][t]):
            continue  # a fact table; a dimension holds no NULL
        first = rel.names[0]
        v = frames[t][first]
        n = rel.num_rows
        lo = _jdn(config["date_dim_from"]) if t == "date_dim" else 1
        uniq = torch.unique(v.data).numel()
        keys[t] = (lo, lo + n - 1)
        if uniq != n or int(v.data.min()) != lo or \
                int(v.data.max()) != lo + n - 1:
            faults.append(f"{t}.{first}: not dense from {lo}")
    sold = tuple(_jdn(d) for d in config["sales_dates"])
    for t, rel in rels.items():
        if rel.num_rows != want_rows[t]:
            faults.append(f"{t}: {rel.num_rows} rows, not {want_rows[t]}")
        stated = [c.split(":") for c in config["columns"][t]]
        got = [[name, _type_of(rel, name, c)]
               for name, c in zip(rel.names, rel.table.columns)]
        if [s[:2] for s in stated] != got:
            faults.append(f"{t}: columns {got}, not {stated}")
            continue
        n = rel.num_rows
        for (name, _, *null), c in zip(stated, rel.table.columns):
            v = frames[t][name]
            ok = v.ok()
            nulls = n - int(ok.sum())
            if null:
                band = 6 * math.sqrt(share * (1 - share) / n) + 1 / n
                if abs(nulls / n - share) > band:
                    faults.append(f"{t}.{name}: NULL share {nulls / n}")
            elif nulls:
                faults.append(f"{t}.{name}: {nulls} NULLs")
            if not bool(ok.any()):
                continue
            vals = v.data[ok].to(torch.int64)
            lo, hi = int(vals.min()), int(vals.max())
            if v.cats is not None:
                cats = np.asarray(v.cats)
                if len(cats) == 0 or lo < 0 or hi >= len(cats) or \
                        (len(cats) > 1 and not bool((cats[1:] > cats[:-1])
                                                    .all())):
                    faults.append(f"{t}.{name}: dictionary unsorted or "
                                  "codes outside it")
            ref_t = next((r for suffix, r in REFERENCES
                          if name.endswith("_" + suffix)), None)
            if ref_t is not None and ref_t != t:
                klo, khi = sold if name.endswith("_sold_date_sk") \
                    else keys[ref_t]
                if lo < klo or hi > khi:
                    faults.append(f"{t}.{name}: keys [{lo}, {hi}] outside "
                                  f"{ref_t}'s [{klo}, {khi}]")
            stats = getattr(c, "value_range", None)
            if stats is not None and (lo < stats[0] or hi > stats[1]):
                faults.append(f"{t}.{name}: values [{lo}, {hi}] outside "
                              f"its value_range {tuple(stats)}")
    return faults


def setup(config, traffic, seed, device, split) -> State:
    st = State()
    t = now()
    import torch
    from spark_rapids_jni_tpu_torch.obs import kernel_stats
    from spark_rapids_jni_tpu_torch.ops import cuda_kernels
    from spark_rapids_jni_tpu_torch.tpcds.queries import PLANS
    from spark_rapids_jni_tpu_torch.tpcds.rel import run_fused
    from spark_rapids_jni_tpu_torch.tpcds.spec_data import generate_spec
    split["port_import_s"] = now() - t
    st.torch, st.kernels, st.stats = torch, cuda_kernels, kernel_stats
    st.run_fused, st.device = run_fused, device
    st.cuda = torch.device(device).type == "cuda"
    st.config, st.traffic = config, traffic
    st.queries = list(traffic["queries"])
    st.plans = [PLANS[q] for q in st.queries]
    if st.cuda:
        t = now()
        cuda_kernels.kernels()
        split["library_s"] = now() - t

    t = now()
    st.rels = generate_spec(int(config["scale_factor"]), seed, device,
                            divisor=_divisor(config))
    _synchronize(st)
    split["generate_s"] = now() - t
    st.rows = {n: r.num_rows for n, r in st.rels.items()}

    t = now()
    st.work = sum(st.rows[n] for plan in st.plans
                  for n in _tables_read(run_fused, plan, st.rels, device))
    _synchronize(st)
    split["warm_s"] = now() - t
    st.passes = []
    return st


def _synchronize(st) -> None:
    if st.cuda:
        st.torch.cuda.synchronize()


def launches(st) -> int:
    """K1-K3's launches so far (``cuda_kernels.LAUNCHES``)."""
    return sum(st.kernels.LAUNCHES[k] for k in KERNELS)


def _counters(st) -> dict:
    c = {k: v for k, v in st.stats().items() if k.startswith("rel.route.")}
    c.update({f"shape.{k}": v for k, v in st.kernels.LAUNCH_SHAPES.items()})
    c.update({f"launch.{k}": st.kernels.LAUNCHES[k] for k in KERNELS})
    return c


def window(st, seconds: float, traced: bool = False) -> Window:
    before = _counters(st)
    start = now()
    win = Window(start=start, close=start + seconds)
    while True:
        t = now()
        if t >= win.close:
            break
        r = Request("power_pass", due=t, work=st.work)
        frames = []
        try:
            for plan in st.plans:
                frames.append(st.run_fused(plan, st.rels,
                                           device=st.device).to_df())
        except Exception as e:  # noqa: BLE001 - a failed pass is counted
            r.error = f"{type(e).__name__}: {e}"
        r.done = now()
        win.requests.append(r)
        st.passes.append(frames if r.error is None else None)
    win.end = win.requests[-1].done if win.requests else now()
    after = _counters(st)
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    win.routes = {k: v for k, v in delta.items()
                  if k.startswith("rel.route.") and v}
    win.shapes = {k[len("shape."):]: v for k, v in delta.items()
                  if k.startswith("shape.") and v}
    win.launches = {k[len("launch."):]: v for k, v in delta.items()
                    if k.startswith("launch.")}
    return win


def _reference(st, control: bool = False) -> dict:
    frames = ref.read_tables(st.rels)
    return {q: ref.run_query(q, frames, control=control)
            for q in st.queries}


def check(st, win: Window):
    """(the numbers compared, each with its limit; failed requests):
    every pass's frames against the reference's."""
    failed = sum(1 for r in win.requests if r.error is not None)
    faults = table_faults(st.rels, st.config)
    for f in faults[:20]:
        print(f"bench: table fault: {f}", file=sys.stderr)
    want = _reference(st)
    rtol = float(st.config["float_rtol"])
    bad = 0
    for frames in st.passes:
        if frames is None:
            continue
        for q, got in zip(st.queries, frames):
            bad += ref.frame_mismatches(got, want[q], rtol)
    if not any(f is not None for f in st.passes):
        failed = max(failed, 1)
        bad = max(bad, 1)
    st.passes = []
    st.rels = None
    limits = st.config["limits"]
    return [{"name": "mismatches", "value": bad,
             "limit": limits["mismatches"]},
            {"name": "table_faults", "value": len(faults),
             "limit": limits["table_faults"]}], failed


def control(config, traffic, seed, device) -> list:
    """The control: the reference put in the program's place with every
    money sum in float32, one precision below the configuration's
    decimals, at the cell's size, judged as a pass is."""
    from spark_rapids_jni_tpu_torch.tpcds.spec_data import generate_spec
    st = State()
    st.queries = list(traffic["queries"])
    st.rels = generate_spec(int(config["scale_factor"]), seed, device,
                            divisor=_divisor(config))
    want = _reference(st)
    low = _reference(st, control=True)
    rtol = float(config["float_rtol"])
    bad = sum(ref.frame_mismatches(low[q], want[q], rtol)
              for q in st.queries)
    return [{"name": "mismatches", "value": bad,
             "limit": config["limits"]["mismatches"]}]
