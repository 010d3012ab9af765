"""Spark's row format through the port: ``convert_to_rows`` of one
batch of columns, and in a round trip ``convert_from_rows`` of every row
batch it gives.

Set-up makes the configuration's batch on the device from the seed: its
schema's columns (``types`` x ``repeats``), ``null_share`` of each
column's rows null, the float columns carrying NaN payloads, signed
zeros and infinities. It converts the batch once each way the traffic
uses. The window then converts back to back, with a synchronise after
each call (``"direction": "to_rows"``) or after the batch's conversion
to rows and after each row batch's conversion back
(``"direction": "roundtrip"``); a round trip counts each row once. The
last conversion's rows and columns are judged after the window against
the reference (``reference/rows.py``): every valid slot's bytes and
every validity bit.
"""

from __future__ import annotations

from contextlib import nullcontext

from harness.window import Request, Window, now
from reference import rows as ref

# +-0.0, +-inf and NaN payloads, as the integer bits of each float width
F64_SPECIALS = (0, -2**63, 0x7FF0000000000000, -0x10000000000000,
                0x7FF8000000000000, -0x8000000000000, 0x7FF0000000000001)
F32_SPECIALS = (0, -2**31, 0x7F800000, -0x800000, 0x7FC00000, -0x400000,
                0x7F800001)


class State:
    pass


def _dtype(T, name: str):
    """``INT64`` or ``DECIMAL64:-8`` -> the port's type."""
    base, _, scale = name.partition(":")
    if scale:
        return {"DECIMAL32": T.decimal32, "DECIMAL64": T.decimal64}[base](
            int(scale))
    return getattr(T, base)


def _specials(torch, x, bits, every: int):
    ints = x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)
    at = torch.arange(0, x.numel(), every, device=x.device)
    pats = torch.tensor(bits, dtype=ints.dtype, device=x.device)
    ints[at] = pats[torch.arange(at.numel(), device=x.device) % len(bits)]
    return x


def make_batch(torch, dtypes, n: int, null_share: float, gen, dev):
    """(data, validity words) of each column, from ``gen``."""
    datas, valids = [], []
    for dt in dtypes:
        td = dt.to_torch()
        if td == torch.float64:
            d = _specials(torch, torch.randn(n, generator=gen, device=dev,
                                             dtype=td), F64_SPECIALS, 101)
        elif td == torch.float32:
            d = _specials(torch, torch.randn(n, generator=gen, device=dev,
                                             dtype=td), F32_SPECIALS, 103)
        elif dt.id.name == "BOOL8":
            d = torch.randint(0, 2, (n,), generator=gen, device=dev,
                              dtype=td)
        else:
            info = torch.iinfo(td)
            d = torch.randint(info.min, info.max, (n,), generator=gen,
                              device=dev, dtype=td)
        datas.append(d)
        valids.append(ref.pack_words(
            torch.rand(n, generator=gen, device=dev) >= null_share))
    return datas, valids


def setup(config, traffic, seed, device, split) -> State:
    st = State()
    t = now()
    import torch
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import cuda_kernels, row_conversion
    split["port_import_s"] = now() - t
    st.torch, st.kernels = torch, cuda_kernels
    st.rc = row_conversion
    st.cuda = torch.device(device).type == "cuda"
    st.config, st.traffic = config, traffic
    st.roundtrip = traffic["direction"] == "roundtrip"
    if st.cuda:
        t = now()
        cuda_kernels.kernels()
        split["library_s"] = now() - t

    t = now()
    dtypes = [_dtype(T, name) for name in config["types"]] \
        * int(config["repeats"])
    st.n = int(config["rows"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    st.datas, st.valids = make_batch(torch, dtypes, st.n,
                                     float(config["null_share"]), gen,
                                     device)
    st.table = Table([Column(dt, st.n, d, v) for dt, d, v
                      in zip(dtypes, st.datas, st.valids)])
    st.schema = st.table.schema()
    _synchronize(st)
    split["generate_s"] = now() - t

    t = now()
    st.last = None
    _convert(st, traced=False)
    st.last = None
    _synchronize(st)
    split["warm_s"] = now() - t
    return st


def _convert(st, traced: bool) -> None:
    """One conversion of the batch; its output is kept in ``st.last``."""
    from torch.profiler import record_function

    def span(name):
        return record_function(name) if traced else nullcontext()
    with span("bench::to_rows"):
        rows = st.rc.convert_to_rows(st.table)
        _synchronize(st)
    back = []
    if st.roundtrip:
        for b in rows:
            with span("bench::from_rows"):
                back.append(st.rc.convert_from_rows(b, st.schema))
                _synchronize(st)
    st.last = (rows, back)


def _synchronize(st) -> None:
    if st.cuda:
        st.torch.cuda.synchronize()


def launches(st) -> int:
    """The hand kernels' launches so far (``cuda_kernels.LAUNCHES``)."""
    return sum(st.kernels.LAUNCHES.values())


def window(st, seconds: float, traced: bool = False) -> Window:
    start = now()
    win = Window(start=start, close=start + seconds)
    while True:
        t = now()
        if t >= win.close:
            break
        st.last = None  # the previous conversion's output is let go
        r = Request("roundtrip" if st.roundtrip else "to_rows", due=t,
                    work=st.n)
        try:
            _convert(st, traced)
        except Exception as e:  # noqa: BLE001 - a failed call is counted
            r.error = f"{type(e).__name__}: {e}"
        r.done = now()
        win.requests.append(r)
    win.end = win.requests[-1].done if win.requests else now()
    return win


def check(st, win: Window):
    """(the numbers compared, each with its limit; failed requests):
    the last conversion's rows and columns against the reference."""
    st.table = None
    failed = sum(1 for r in win.requests if r.error is not None)
    if st.last is None:
        bad_rows = bad_cols = st.n
        failed = max(failed, 1)
    else:
        rows, back = st.last
        mats = [b.child.data.view(st.torch.uint8).reshape(b.size, -1)
                for b in rows]
        bad_rows = ref.row_mismatches(mats, st.datas, st.valids)
        bad_cols = 0
        if st.roundtrip:
            cols = [[(c.data, c.validity) for c in t.columns] for t in back]
            bad_cols = ref.column_mismatches(cols, st.datas, st.valids)
    st.last = None
    limits = st.config["limits"]
    checks = [{"name": "row_mismatches", "value": bad_rows,
               "limit": limits["row_mismatches"]}]
    if st.roundtrip:
        checks.append({"name": "column_mismatches", "value": bad_cols,
                       "limit": limits["column_mismatches"]})
    return checks, failed


def control(config, traffic, seed, device) -> list:
    """The control: the reference put in the program's place, computed
    one precision below the configuration's (float64 columns through
    float32), at the cell's size, judged as a run's output is."""
    import torch
    from spark_rapids_jni_tpu_torch import types as T
    dtypes = [_dtype(T, name) for name in config["types"]] \
        * int(config["repeats"])
    n = int(config["rows"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    datas, valids = make_batch(torch, dtypes, n, float(config["null_share"]),
                               gen, device)
    rows = ref.pack(datas, valids, control=True)
    limits = config["limits"]
    out = [{"name": "row_mismatches",
            "value": ref.row_mismatches([rows], datas, valids),
            "limit": limits["row_mismatches"]}]
    del rows
    if traffic["direction"] == "roundtrip":
        low = [(d.to(torch.float32).to(torch.float64)
                if d.dtype == torch.float64 else d, v)
               for d, v in zip(datas, valids)]
        out.append({"name": "column_mismatches",
                    "value": ref.column_mismatches([low], datas, valids),
                    "limit": limits["column_mismatches"]})
    return out
