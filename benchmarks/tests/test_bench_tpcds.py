"""The TPC-DS power cell at a tiny size on the CPU: a sound run is
correct, a wrong answer planted in the program is caught, a fault
planted in the generated tables is caught, the control (money sums in
float32) comes out not correct, and the configuration states what the
port runs."""

import copy
import dataclasses
import datetime
import json
import time

import pytest

from harness import runner, spec as S

CELL = "tpcds_sf10.power"
TINY = 12_000  # store_sales rows: the scaled tables cut by 2,401


def _tiny():
    spec = S.load_spec()
    cell = S.find_cell(spec, CELL)
    config = copy.deepcopy(S.load_config(cell["config"]))
    traffic = copy.deepcopy(S.load_traffic(cell["traffic"]))
    config["rows"] = TINY
    return spec, cell, config, traffic


def _run(trace: bool = False, seed: int = 2**31 + 13) -> dict:
    spec, cell, config, traffic = _tiny()
    runner.prepare_env(S.ROOT, traffic)
    return runner.run_cell(spec, cell, seed, 0.5, trace, "cpu",
                           time.perf_counter(), {}, config=config,
                           traffic=traffic)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_a_sound_run_is_correct(trace):
    line = _run(trace)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["mismatches"]["value"] == 0
    if trace:
        assert {"device_idle_share.tpcds",
                "idle_in_program_share.tpcds"} <= set(line["metrics"])
        share = line["metrics"]["general_route_share.tpcds"]["value"]
        assert 0 < share < 100  # q3 and q17 group over i_brand_id
    else:
        assert line["metrics"]["rows_per_s"]["value"] > 0


def test_a_wrong_answer_is_caught(monkeypatch):
    from spark_rapids_jni_tpu_torch.tpcds import rel
    real = rel.Rel.to_df

    def off_by_a_cent(self):
        df = real(self)
        if "total" in df.columns and len(df):  # q13's revenue
            df.loc[0, "total"] += type(df.loc[0, "total"])("0.01")
        return df
    monkeypatch.setattr(rel.Rel, "to_df", off_by_a_cent)
    line = _run()
    assert not line["correct"]
    assert line["checks"]["mismatches"]["value"] > 0


def test_a_float_in_place_of_a_decimal_is_caught(monkeypatch):
    from spark_rapids_jni_tpu_torch.tpcds import rel
    real = rel.Rel.to_df

    def money_as_float(self):
        df = real(self)
        if "total" in df.columns:  # q13's revenue, a DECIMAL sum
            df["total"] = df["total"].astype("float64")
        return df
    monkeypatch.setattr(rel.Rel, "to_df", money_as_float)
    line = _run()
    assert not line["correct"]
    assert line["checks"]["mismatches"]["value"] > 0


@pytest.fixture(scope="module")
def tiny_tables():
    from spark_rapids_jni_tpu_torch.tpcds.spec_data import generate_spec
    _, _, config, traffic = _tiny()
    driver = S.load_driver(traffic["driver"])
    rels = generate_spec(10, 2**31 + 13, "cpu",
                         divisor=driver._divisor(config))
    return driver, config, rels


def _with_column(rels, table, name, **change):
    """``rels`` with one column of ``table`` replaced (``change`` its
    fields; ``cats`` its dictionary), the others shared."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.tpcds.rel import Rel
    rel = rels[table]
    i = rel.names.index(name)
    dicts = dict(rel.dicts)
    if "cats" in change:
        dicts[name] = change.pop("cats")
    cols = list(rel.table.columns)
    cols[i] = dataclasses.replace(cols[i], **change)
    return {**rels, table: Rel(Table(cols), list(rel.names), dicts=dicts)}


def _fault(kind, rels):
    import torch
    from spark_rapids_jni_tpu_torch.columnar import Table, bitmask
    from spark_rapids_jni_tpu_torch.tpcds.rel import Rel
    ss = rels["store_sales"]
    n = ss.num_rows
    if kind == "null_share":  # a third more of ss_customer_sk NULL
        c = ss.col("ss_customer_sk")
        valid = bitmask.unpack(c.validity, n) & (torch.arange(n) % 3 > 0)
        return _with_column(rels, "store_sales", "ss_customer_sk",
                            validity=bitmask.pack(valid))
    if kind == "null_in_a_key":  # ss_item_sk is the primary key's
        valid = torch.arange(n) > 0
        return _with_column(rels, "store_sales", "ss_item_sk",
                            validity=bitmask.pack(valid))
    if kind == "dictionary_order":  # the same strings, the order reversed
        cd = rels["customer_demographics"]
        cats = cd.dicts["cd_gender"]
        c = cd.col("cd_gender")
        return _with_column(rels, "customer_demographics", "cd_gender",
                            data=len(cats) - 1 - c.data, cats=cats[::-1])
    if kind == "key_domain":  # every store key past the stores
        c = ss.col("ss_store_sk")
        lo, hi = c.value_range
        return _with_column(rels, "store_sales", "ss_store_sk",
                            data=c.data + 1000, value_range=(lo + 1000,
                                                             hi + 1000))
    if kind == "value_range":  # stats narrower than the values
        return _with_column(rels, "item", "i_manufact_id",
                            value_range=(1, 10))
    if kind == "column_missing":
        it = rels["item"]
        return {**rels, "item": Rel(Table(list(it.table.columns[:-1])),
                                    list(it.names[:-1]), dicts=it.dicts)}
    raise ValueError(kind)


def test_the_generated_tables_hold_the_configuration(tiny_tables):
    driver, config, rels = tiny_tables
    assert driver.table_faults(rels, config) == []


@pytest.mark.parametrize("kind", ["null_share", "null_in_a_key",
                                  "dictionary_order", "key_domain",
                                  "value_range", "column_missing"])
def test_a_fault_in_the_generated_tables_is_caught(tiny_tables, kind):
    driver, config, rels = tiny_tables
    assert driver.table_faults(_fault(kind, rels), config), kind


def test_the_configuration_states_what_runs():
    """The configuration's statement of the tables and the templates'
    constants is the generator's, the port's and the reference's."""
    from reference import tpcds as ref
    from spark_rapids_jni_tpu_torch.tpcds import spec_data as SD
    from spark_rapids_jni_tpu_torch.tpcds.queries import SPEC_PARAMS
    config = S.load_config(S.find_cell(S.load_spec(), CELL)["config"])

    def jdn(day):
        return datetime.date.fromisoformat(day).toordinal() + SD.JULIAN

    assert config["tables"] == SD.SPEC_ROWS[config["scale_factor"]]
    assert config["rows"] == config["tables"]["store_sales"]
    assert config["null_share"] == SD.NULL_SHARE
    assert config["foreign_key_ranges"] == SD.OTHER_ROWS
    assert set(SD.OTHER_ROWS) <= set(config["tables_left_out"])
    assert not set(config["tables"]) & set(config["tables_left_out"])
    assert config["fixed_tables"] == list(SD.FIXED_TABLES)
    assert jdn(config["date_dim_from"]) == SD.DATE_SK_LO
    assert [jdn(d) for d in config["sales_dates"]] == [SD.SALES_FIRST,
                                                        SD.SALES_LAST]
    assert config["assumed"] == SD.ASSUMED
    as_json = lambda d: json.loads(json.dumps(d))  # noqa: E731
    assert config["constants"] == as_json(SPEC_PARAMS) == \
        as_json(ref.PARAMS)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_the_float32_control_fails(seed):
    _, cell, config, traffic = _tiny()
    checks = S.load_driver(traffic["driver"]).control(config, traffic,
                                                      seed, "cpu")
    assert checks[0]["name"] == "mismatches"
    assert checks[0]["value"] > checks[0]["limit"]
