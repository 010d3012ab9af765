"""TPC-DS tables by the specification, made on the device.

The tables q1-q20 read, with every column of TPC-DS v3.2 clause 2 in
the column's type: identifiers and integers INT32, ``DECIMAL(p,2)``
money DECIMAL32 (DECIMAL64 past 9 digits) at scale -2, dates
TIMESTAMP_DAYS, ``CHAR``/``VARCHAR`` dictionary-encoded strings (int64
codes over a sorted host dictionary, as ``rel.rel_from_df`` ingests
them). Row counts are clause 3's for the scale factor (``SPEC_ROWS``);
``date_dim`` and ``customer_demographics`` have the same rows at every
scale factor.

Domains follow the specification: surrogate keys dense from 1,
``d_date_sk`` the Julian day (2,415,022 = 1900-01-02 to 2,488,070 =
2100-01-01), sales dated 1998-01-02 to 2003-01-02, ``customer_
demographics`` the cross product of its eight attributes. A ticket's
(an order's) rows share its date, customer, store and the like, and its
items are distinct; ``ss_ext_sales_price`` = quantity x price. Every
fact column but the primary key's is NULL on ``NULL_SHARE`` of its
rows (its data there is 0, outside every key domain). Draws are uniform
over each domain where ``dsdgen`` has distributions; ``ASSUMED`` lists
every such choice, and the benchmark's configuration repeats it.

``generate_spec(sf, seed, device, divisor)`` returns ingested Rels:
each integer and string column carries its domain as ``value_range``,
verified by construction, and surrogate keys are marked unique, so the
fused planner takes its dense routes without a device check.
``divisor`` divides the scaled tables' rows (the CPU tests' small
sizes). The draws come from one ``torch.Generator`` seeded with
``seed``, on ``device``.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Column, Table, bitmask
from ..obs import span
from ..types import INT32, INT64, TIMESTAMP_DAYS, decimal32, decimal64
from ..utils.device import resolve_device

# clause 3's row counts, by scale factor
SPEC_ROWS: Dict[int, Dict[str, int]] = {
    10: {"store_sales": 28_800_991, "store_returns": 2_875_432,
         "catalog_sales": 14_401_261, "web_sales": 7_197_566,
         "customer": 500_000, "customer_address": 250_000,
         "customer_demographics": 1_920_800, "item": 102_000,
         "store": 102, "promotion": 500, "date_dim": 73_049},
}
# row counts of the tables the foreign keys name that q1-q20 never read
# (not generated; their keys are drawn over these ranges), at SF10
OTHER_ROWS = {"time_dim": 86_400, "household_demographics": 7_200,
              "reason": 45, "call_center": 24, "catalog_page": 12_000,
              "ship_mode": 20, "warehouse": 10, "web_page": 200,
              "web_site": 42}
FIXED_TABLES = ("date_dim", "customer_demographics")
NULL_SHARE = 0.04

DATE_SK_LO = 2_415_022  # 1900-01-02 as a Julian day number
JULIAN = 1_721_425      # date.toordinal() + JULIAN = Julian day number
SALES_FIRST = _dt.date(1998, 1, 2).toordinal() + JULIAN
SALES_LAST = _dt.date(2003, 1, 2).toordinal() + JULIAN
EPOCH_JDN = _dt.date(1970, 1, 1).toordinal() + JULIAN

ASSUMED = [
    f"null share: {NULL_SHARE:.0%} of the rows of every fact column outside"
    " the primary key, drawn independently a column; dimension columns"
    " hold no NULL",
    "uniform draws over each key and value domain where dsdgen draws"
    " from its distributions (dates, customers, items, prices, states)",
    "ticket sizes U[8, 16] (store_sales), order sizes U[4, 14]"
    " (catalog_sales, web_sales); a ticket's items distinct",
    "prices: wholesale U[1.00, 100.00], list = wholesale x (1 + U[0, 2]),"
    " sales = list x (1 - U[0, 1]), quantity U[1, 100], tax U[0, 9]%,"
    " a coupon on a fifth of the rows of U[0, 100]% of the sale",
    "store_returns: a tenth of the sales rows, drawn without replacement;"
    " returned U[1, 90] days after the sale, U[1, quantity] units",
    "strings: dictionary codes over fixed word lists (names, cities,"
    " counties, streets, states), product names from the digits of the"
    " item key in dsdgen's syllables, ids 16 characters over 'A'-'P'",
    "i_brand_id = i_category_id x 10^6 + i_class_id x 10^3 + brand"
    " U[1, 10]; i_manufact_id U[1, 1000]",
    "d_week_seq = (d_date_sk - 2415022) / 7 + 1,"
    " d_month_seq = (d_year - 1900) x 12 + d_moy - 1",
]

SYLLABLES = ("ought", "able", "pri", "ese", "anti", "cally", "ation",
             "eing", "bar", "n st")
CATEGORIES = ("Books", "Children", "Electronics", "Home", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women")
STATES = ("AK", "AL", "AR", "AZ", "CA", "CO", "CT", "DC", "DE", "FL", "GA",
          "HI", "IA", "ID", "IL", "IN", "KS", "KY", "LA", "MA", "MD", "ME",
          "MI", "MN", "MO", "MS", "MT", "NC", "ND", "NE", "NH", "NJ", "NM",
          "NV", "NY", "OH", "OK", "OR", "PA", "RI", "SC", "SD", "TN", "TX",
          "UT", "VA", "VT", "WA", "WI", "WV", "WY")
_COUNTY_ROOTS = ("Adams", "Barrow", "Bronx", "Clay", "Dona Ana", "Essex",
                 "Fairfield", "Franklin", "Green", "Harmon", "Jackson",
                 "Jefferson", "Kittitas", "La Porte", "Lincoln", "Marion",
                 "Mercer", "Nelson", "Oglethorpe", "Perry", "Pike", "Rush",
                 "Salem", "Toole", "Union", "Walker", "Washington", "Ziebach")
COUNTIES = tuple(f"{c} County" for c in _COUNTY_ROOTS)
CITIES = ("Antioch", "Bethel", "Clinton", "Concord", "Fairview",
          "Five Points", "Georgetown", "Greenwood", "Jamestown", "Lakeside",
          "Liberty", "Midway", "Mount Zion", "Oak Grove", "Oakland",
          "Pleasant Hill", "Riverside", "Salem", "Shiloh", "Spring Hill",
          "Summit", "Union", "Wildwood")
STREETS = ("Main", "Oak", "Park", "Pine", "Maple", "Cedar", "Elm", "View",
           "Lake", "Hill", "Walnut", "Spring", "North", "Ridge", "Church",
           "Willow", "Mill", "Sunset", "Railroad", "Jackson")
STREET_TYPES = ("Ave", "Blvd", "Boulevard", "Cir.", "Circle", "Court",
                "Ct.", "Dr.", "Drive", "Lane", "Ln", "Parkway", "Pkwy",
                "RD", "Road", "ST", "Street", "Way", "Wy")
FIRST_NAMES = ("James", "Mary", "John", "Patricia", "Robert", "Jennifer",
               "Michael", "Linda", "William", "Elizabeth", "David",
               "Barbara", "Richard", "Susan", "Joseph", "Jessica", "Thomas",
               "Sarah", "Charles", "Karen")
LAST_NAMES = ("Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
              "Miller", "Davis", "Rodriguez", "Martinez", "Hernandez",
              "Lopez", "Gonzalez", "Wilson", "Anderson", "Thomas", "Taylor",
              "Moore", "Jackson", "Martin")
COLORS = ("almond", "antique", "aquamarine", "azure", "beige", "black",
          "blue", "brown", "burlywood", "chartreuse", "chocolate", "coral",
          "cornflower", "cream", "cyan", "dark", "deep", "dim", "dodger",
          "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
          "goldenrod", "green", "grey", "honeydew", "hot", "indian",
          "ivory", "khaki", "lace", "lavender", "lawn", "lemon", "light",
          "lime", "linen")
UNITS = ("Box", "Bunch", "Bundle", "Carton", "Case", "Cup", "Dozen", "Dram",
         "Each", "Gram", "Gross", "Lb", "N/A", "Ounce", "Pallet", "Pound",
         "Tbl", "Ton", "Tsp", "Unknown")
SIZES = ("N/A", "economy", "extra large", "large", "medium", "petite",
         "small")
GENDERS = ("M", "F")
MARITAL = ("M", "S", "D", "W", "U")
EDUCATION = ("Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown")
CREDIT = ("Good", "High Risk", "Low Risk", "Unknown")
DAY_NAMES = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday")


def row_counts(sf: int = 10, divisor: int = 1) -> Dict[str, int]:
    """Rows of each generated table at ``sf``, the scaled tables of 1,000
    rows or more divided by ``divisor`` (to at least 1,000)."""
    rows = SPEC_ROWS[sf]
    return {t: n if t in FIXED_TABLES or n < 1000
            else max(-(-n // divisor), 1000) for t, n in rows.items()}


# --------------------------------------------------------------------------
# Column building
# --------------------------------------------------------------------------

class _Columns:
    """One table's columns in order, with their dictionaries."""

    def __init__(self, n: int, dev: torch.device):
        self.n, self.dev = n, dev
        self.names: List[str] = []
        self.cols: List[Column] = []
        self.dicts: Dict[str, np.ndarray] = {}

    def _add(self, name: str, col: Column, stats: Optional[Tuple[int, int]],
             unique: bool = False) -> None:
        col.value_range = stats
        col.unique = unique if stats is not None else None
        col._stats_flags = (stats is not None, unique and stats is not None)
        self.names.append(name)
        self.cols.append(col)

    def int32(self, name: str, data: torch.Tensor, lo: int, hi: int,
              unique: bool = False) -> None:
        self._add(name, Column(INT32, self.n, data.to(torch.int32)),
                  (int(lo), int(hi)), unique)

    def money(self, name: str, cents: torch.Tensor, digits: int = 7) -> None:
        dt = decimal32(-2) if digits <= 9 else decimal64(-2)
        self._add(name, Column(dt, self.n, cents.to(dt.to_torch())), None)

    def date(self, name: str, jdn: torch.Tensor) -> None:
        self._add(name, Column(TIMESTAMP_DAYS, self.n,
                               (jdn - EPOCH_JDN).to(torch.int32)), None)

    def string(self, name: str, words, idx: torch.Tensor) -> None:
        """A dictionary column whose row ``i`` holds ``words[idx[i]]``."""
        words = np.asarray(words)
        cats, inv = np.unique(words, return_inverse=True)
        cats.flags.writeable = False
        lut = torch.from_numpy(inv.astype(np.int64)).to(self.dev)
        self.dicts[name] = cats
        self._add(name, Column(INT64, self.n, lut[idx.to(torch.int64)]),
                  (0, len(cats) - 1))

    def sorted_string(self, name: str, cats: np.ndarray,
                      codes: torch.Tensor) -> None:
        """A dictionary column over ``cats``, already sorted and unique."""
        cats.flags.writeable = False
        self.dicts[name] = cats
        self._add(name, Column(INT64, self.n, codes.to(torch.int64)),
                  (0, len(cats) - 1))

    def rel(self):
        from .rel import Rel
        return Rel(Table(self.cols), self.names, dicts=self.dicts)


def _ids(keys: np.ndarray) -> np.ndarray:
    """16-character ids over 'A'-'P', in the order of ``keys`` (>= 0):
    sorted keys give sorted ids."""
    k = keys.astype(np.int64)
    digits = (k[:, None] >> (4 * np.arange(15, -1, -1))[None, :]) & 15
    chars = (digits + ord("A")).astype(np.uint8)
    return chars.view("S16").reshape(-1).astype("U16")


def _syllable_names(keys: np.ndarray) -> np.ndarray:
    """dsdgen-style names: the syllable of each decimal digit of a key."""
    return np.array(["".join(SYLLABLES[int(d)] for d in str(int(k)))
                     for k in keys])


def _apply_nulls(col: Column, gen: torch.Generator,
                 share: float = NULL_SHARE) -> Column:
    """``col`` with ``share`` of its rows NULL (data 0 there)."""
    valid = torch.rand(col.size, generator=gen, device=col.data.device) \
        >= share
    col.data = torch.where(valid, col.data, torch.zeros_like(col.data))
    col.validity = bitmask.pack(valid)
    return col


class _Draw:
    """Uniform draws from the table generator."""

    def __init__(self, gen: torch.Generator, dev: torch.device):
        self.gen, self.dev = gen, dev

    def ints(self, lo: int, hi: int, n: int) -> torch.Tensor:
        """int64 U[lo, hi]."""
        return torch.randint(int(lo), int(hi) + 1, (n,), generator=self.gen,
                             device=self.dev, dtype=torch.int64)

    def share(self, p: float, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self.gen, device=self.dev) < p


# --------------------------------------------------------------------------
# Dimensions
# --------------------------------------------------------------------------

def _date_dim(n: int, dev) -> _Columns:
    jdn = np.arange(DATE_SK_LO, DATE_SK_LO + n, dtype=np.int64)
    days = (jdn - EPOCH_JDN).astype("datetime64[D]")
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    dow = (jdn + 1) % 7  # 0 = Sunday
    qoy = (month - 1) // 3 + 1
    month_seq = (year - 1900) * 12 + month - 1
    quarter_seq = (year - 1900) * 4 + qoy - 1
    week_seq = (jdn - DATE_SK_LO) // 7 + 1
    first_dom = jdn - dom + 1
    nxt = (days.astype("datetime64[M]") + 1).astype("datetime64[D]")
    last_dom = (nxt.astype(np.int64) + EPOCH_JDN) - 1
    holiday = ((month == 12) & (dom == 25)) | ((month == 1) & (dom == 1)) \
        | ((month == 7) & (dom == 4))
    weekend = (dow == 0) | (dow == 6)
    following = np.concatenate([[False], holiday[:-1]])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    lo_y, hi_y = int(year.min()), int(year.max())
    b = _Columns(n, dev)
    b.int32("d_date_sk", t(jdn), jdn[0], jdn[-1], unique=True)
    b.sorted_string("d_date_id", _ids(jdn - DATE_SK_LO),
                    torch.arange(n, device=dev))
    b.date("d_date", t(jdn))
    b.int32("d_month_seq", t(month_seq), month_seq.min(), month_seq.max())
    b.int32("d_week_seq", t(week_seq), week_seq.min(), week_seq.max())
    b.int32("d_quarter_seq", t(quarter_seq), quarter_seq.min(),
            quarter_seq.max())
    b.int32("d_year", t(year), lo_y, hi_y)
    b.int32("d_dow", t(dow), 0, 6)
    b.int32("d_moy", t(month), 1, 12)
    b.int32("d_dom", t(dom), 1, 31)
    b.int32("d_qoy", t(qoy), 1, 4)
    b.int32("d_fy_year", t(year), lo_y, hi_y)
    b.int32("d_fy_quarter_seq", t(quarter_seq), quarter_seq.min(),
            quarter_seq.max())
    b.int32("d_fy_week_seq", t(week_seq), week_seq.min(), week_seq.max())
    b.string("d_day_name", DAY_NAMES, t((dow + 6) % 7))
    qname = np.char.add(year.astype("U4"),
                        np.char.add("Q", qoy.astype("U1")))
    cats, inv = np.unique(qname, return_inverse=True)
    b.sorted_string("d_quarter_name", cats, t(inv))
    yn = ("N", "Y")
    b.string("d_holiday", yn, t(holiday.astype(np.int64)))
    b.string("d_weekend", yn, t(weekend.astype(np.int64)))
    b.string("d_following_holiday", yn, t(following.astype(np.int64)))
    b.int32("d_first_dom", t(first_dom), first_dom.min(), first_dom.max())
    b.int32("d_last_dom", t(last_dom), last_dom.min(), last_dom.max())
    ly = np.maximum(jdn - 365, DATE_SK_LO)
    lq = np.maximum(jdn - 91, DATE_SK_LO)
    b.int32("d_same_day_ly", t(ly), ly.min(), ly.max())
    b.int32("d_same_day_lq", t(lq), lq.min(), lq.max())
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    for c in ("d_current_day", "d_current_week", "d_current_month",
              "d_current_quarter", "d_current_year"):
        b.string(c, ("N",), zeros)
    return b


def _customer_demographics(n: int, dev) -> _Columns:
    # the cross product, the first attribute varying fastest
    sizes = (len(GENDERS), len(MARITAL), len(EDUCATION), 20, len(CREDIT),
             7, 7, 7)
    expect = int(np.prod(sizes))
    k = torch.arange(n, dtype=torch.int64, device=dev) % expect
    digit = []
    for s in sizes:
        digit.append(k % s)
        k = k // s
    b = _Columns(n, dev)
    b.int32("cd_demo_sk", torch.arange(1, n + 1, device=dev), 1, n,
            unique=True)
    b.string("cd_gender", GENDERS, digit[0])
    b.string("cd_marital_status", MARITAL, digit[1])
    b.string("cd_education_status", EDUCATION, digit[2])
    b.int32("cd_purchase_estimate", (digit[3] + 1) * 500, 500, 10_000)
    b.string("cd_credit_rating", CREDIT, digit[4])
    b.int32("cd_dep_count", digit[5], 0, 6)
    b.int32("cd_dep_employed_count", digit[6], 0, 6)
    b.int32("cd_dep_college_count", digit[7], 0, 6)
    return b


def _address_columns(b: _Columns, d: _Draw, prefix: str, n: int) -> None:
    """The street-to-country columns a customer_address and a store
    share (``prefix`` ``ca_`` or ``s_``)."""
    b.string(f"{prefix}street_number", [str(i) for i in range(1, 1001)],
             d.ints(0, 999, n))
    b.string(f"{prefix}street_name", STREETS, d.ints(0, len(STREETS) - 1, n))
    b.string(f"{prefix}street_type", STREET_TYPES,
             d.ints(0, len(STREET_TYPES) - 1, n))
    b.string(f"{prefix}suite_number", [f"Suite {i}" for i in range(100)],
             d.ints(0, 99, n))
    b.string(f"{prefix}city", CITIES, d.ints(0, len(CITIES) - 1, n))
    b.string(f"{prefix}county", COUNTIES, d.ints(0, len(COUNTIES) - 1, n))
    b.string(f"{prefix}state", STATES, d.ints(0, len(STATES) - 1, n))
    zips = np.char.zfill(np.arange(10_000, 100_000).astype("U5"), 5)
    b.sorted_string(f"{prefix}zip", zips, d.ints(0, len(zips) - 1, n))
    b.string(f"{prefix}country", ("United States",),
             torch.zeros(n, dtype=torch.int64, device=b.dev))
    b.money(f"{prefix}gmt_offset", -100 * d.ints(5, 10, n), digits=5)


def _customer_address(n: int, d: _Draw) -> _Columns:
    b = _Columns(n, d.dev)
    b.int32("ca_address_sk", torch.arange(1, n + 1, device=d.dev), 1, n,
            unique=True)
    b.sorted_string("ca_address_id", _ids(np.arange(n)),
                    torch.arange(n, device=d.dev))
    _address_columns(b, d, "ca_", n)
    b.string("ca_location_type", ("apartment", "condo", "single family"),
             d.ints(0, 2, n))
    return b


def _customer(n: int, rows: dict, d: _Draw) -> _Columns:
    dev = d.dev
    b = _Columns(n, dev)
    b.int32("c_customer_sk", torch.arange(1, n + 1, device=dev), 1, n,
            unique=True)
    b.sorted_string("c_customer_id", _ids(np.arange(n)),
                    torch.arange(n, device=dev))
    b.int32("c_current_cdemo_sk",
            d.ints(1, rows["customer_demographics"], n), 1,
            rows["customer_demographics"])
    hd = OTHER_ROWS["household_demographics"]
    b.int32("c_current_hdemo_sk", d.ints(1, hd, n), 1, hd)
    b.int32("c_current_addr_sk", d.ints(1, rows["customer_address"], n), 1,
            rows["customer_address"])
    first = d.ints(SALES_FIRST - 3650, SALES_LAST, n)
    b.int32("c_first_shipto_date_sk", first + d.ints(0, 30, n),
            SALES_FIRST - 3650, SALES_LAST + 30)
    b.int32("c_first_sales_date_sk", first, SALES_FIRST - 3650, SALES_LAST)
    b.string("c_salutation", ("Dr.", "Miss", "Mr.", "Mrs.", "Ms.", "Sir"),
             d.ints(0, 5, n))
    fi = d.ints(0, len(FIRST_NAMES) - 1, n)
    li = d.ints(0, len(LAST_NAMES) - 1, n)
    b.string("c_first_name", FIRST_NAMES, fi)
    b.string("c_last_name", LAST_NAMES, li)
    b.string("c_preferred_cust_flag", ("N", "Y"), d.ints(0, 1, n))
    b.int32("c_birth_day", d.ints(1, 28, n), 1, 28)
    b.int32("c_birth_month", d.ints(1, 12, n), 1, 12)
    b.int32("c_birth_year", d.ints(1924, 1992, n), 1924, 1992)
    b.string("c_birth_country", CITIES, d.ints(0, len(CITIES) - 1, n))
    b.string("c_login", ("",), torch.zeros(n, dtype=torch.int64,
                                           device=dev))
    domains = ("aol.com", "gmail.com", "hotmail.com", "yahoo.com")
    emails = [f"{f}.{la}@{m}" for f in FIRST_NAMES for la in LAST_NAMES
              for m in domains]
    mi = d.ints(0, len(domains) - 1, n)
    b.string("c_email_address", emails,
             (fi * len(LAST_NAMES) + li) * len(domains) + mi)
    b.int32("c_last_review_date_sk", d.ints(SALES_FIRST, SALES_LAST, n),
            SALES_FIRST, SALES_LAST)
    return b


def _item(n: int, d: _Draw) -> _Columns:
    dev = d.dev
    b = _Columns(n, dev)
    keys = np.arange(1, n + 1)
    b.int32("i_item_sk", torch.from_numpy(keys).to(dev), 1, n, unique=True)
    # two revisions of an item share its id
    b.sorted_string("i_item_id", _ids(np.arange((n + 1) // 2)),
                    torch.arange(n, device=dev) // 2)
    b.date("i_rec_start_date", d.ints(SALES_FIRST - 1500, SALES_FIRST, n))
    b.date("i_rec_end_date", d.ints(SALES_LAST, SALES_LAST + 1500, n))
    descs = [" ".join(SYLLABLES[(i * 7 + j) % 10] + COLORS[(i + j) % 40]
                      for j in range(6)) for i in range(1000)]
    b.string("i_item_desc", descs, d.ints(0, 999, n))
    price = d.ints(9, 9999, n)
    b.money("i_current_price", price)
    b.money("i_wholesale_cost", price * d.ints(20, 90, n) // 100)
    cat = d.ints(1, len(CATEGORIES), n)
    cls = d.ints(1, 16, n)
    brand = d.ints(1, 10, n)
    brand_id = cat * 1_000_000 + cls * 1_000 + brand
    b.int32("i_brand_id", brand_id, 1_001_001, 10_016_010)
    bnames = [f"{SYLLABLES[c % 10]}{SYLLABLES[k % 10]} #{r}"
              for c in range(1, 11) for k in range(1, 17)
              for r in range(1, 11)]
    b.string("i_brand", bnames, ((cat - 1) * 16 + cls - 1) * 10 + brand - 1)
    b.int32("i_class_id", cls, 1, 16)
    b.string("i_class", [f"class {c:02d}" for c in range(1, 17)], cls - 1)
    b.int32("i_category_id", cat, 1, len(CATEGORIES))
    b.string("i_category", CATEGORIES, cat - 1)
    manu = d.ints(1, 1000, n)
    b.int32("i_manufact_id", manu, 1, 1000)
    b.string("i_manufact", _syllable_names(np.arange(1, 1001)), manu - 1)
    b.string("i_size", SIZES, d.ints(0, len(SIZES) - 1, n))
    b.string("i_formulation", [f"{i:020d}" for i in range(200)],
             d.ints(0, 199, n))
    b.string("i_color", COLORS, d.ints(0, len(COLORS) - 1, n))
    b.string("i_units", UNITS, d.ints(0, len(UNITS) - 1, n))
    b.string("i_container", ("Unknown",),
             torch.zeros(n, dtype=torch.int64, device=dev))
    b.int32("i_manager_id", d.ints(1, 100, n), 1, 100)
    b.string("i_product_name", _syllable_names(keys),
             torch.arange(n, device=dev))
    return b


def _store(n: int, d: _Draw) -> _Columns:
    dev = d.dev
    b = _Columns(n, dev)
    b.int32("s_store_sk", torch.arange(1, n + 1, device=dev), 1, n,
            unique=True)
    b.sorted_string("s_store_id", _ids(np.arange((n + 1) // 2)),
                    torch.arange(n, device=dev) // 2)
    b.date("s_rec_start_date", d.ints(SALES_FIRST - 1500, SALES_FIRST, n))
    b.date("s_rec_end_date", d.ints(SALES_LAST, SALES_LAST + 1500, n))
    b.int32("s_closed_date_sk", d.ints(SALES_FIRST, SALES_LAST, n),
            SALES_FIRST, SALES_LAST)
    b.string("s_store_name", SYLLABLES, d.ints(0, len(SYLLABLES) - 1, n))
    b.int32("s_number_employees", d.ints(200, 300, n), 200, 300)
    b.int32("s_floor_space", d.ints(5_000_000, 10_000_000, n), 5_000_000,
            10_000_000)
    b.string("s_hours", ("8AM-12AM", "8AM-4PM", "8AM-8AM"), d.ints(0, 2, n))
    names = [f"{f} {la}" for f in FIRST_NAMES for la in LAST_NAMES]
    b.string("s_manager", names, d.ints(0, len(names) - 1, n))
    b.int32("s_market_id", d.ints(1, 10, n), 1, 10)
    b.string("s_geography_class", ("Unknown",),
             torch.zeros(n, dtype=torch.int64, device=dev))
    b.string("s_market_desc", [" ".join(SYLLABLES[i:i + 4])
                               for i in range(7)], d.ints(0, 6, n))
    b.string("s_market_manager", names, d.ints(0, len(names) - 1, n))
    b.int32("s_division_id", torch.ones(n, device=dev), 1, 1)
    b.string("s_division_name", ("Unknown",),
             torch.zeros(n, dtype=torch.int64, device=dev))
    b.int32("s_company_id", torch.ones(n, device=dev), 1, 1)
    b.string("s_company_name", ("Unknown",),
             torch.zeros(n, dtype=torch.int64, device=dev))
    _address_columns(b, d, "s_", n)
    b.money("s_tax_precentage", d.ints(0, 11, n), digits=5)
    return b


def _promotion(n: int, rows: dict, d: _Draw) -> _Columns:
    dev = d.dev
    b = _Columns(n, dev)
    b.int32("p_promo_sk", torch.arange(1, n + 1, device=dev), 1, n,
            unique=True)
    b.sorted_string("p_promo_id", _ids(np.arange(n)),
                    torch.arange(n, device=dev))
    start = d.ints(SALES_FIRST, SALES_LAST, n)
    b.int32("p_start_date_sk", start, SALES_FIRST, SALES_LAST)
    b.int32("p_end_date_sk", start + d.ints(1, 60, n), SALES_FIRST + 1,
            SALES_LAST + 60)
    b.int32("p_item_sk", d.ints(1, rows["item"], n), 1, rows["item"])
    b.money("p_cost", torch.full((n,), 100_000, device=dev), digits=15)
    b.int32("p_response_target", torch.ones(n, device=dev), 1, 1)
    b.string("p_promo_name", SYLLABLES, d.ints(0, 9, n))
    for ch in ("dmail", "email", "catalog", "tv", "radio", "press", "event",
               "demo"):
        b.string(f"p_channel_{ch}", ("N", "Y"), d.ints(0, 1, n))
    b.string("p_channel_details", [" ".join(SYLLABLES[i:i + 3])
                                   for i in range(8)], d.ints(0, 7, n))
    b.string("p_purpose", ("Unknown",),
             torch.zeros(n, dtype=torch.int64, device=dev))
    b.string("p_discount_active", ("N", "Y"), d.ints(0, 1, n))
    return b


# --------------------------------------------------------------------------
# Facts
# --------------------------------------------------------------------------

def _groups(d: _Draw, n: int, lo: int, hi: int):
    """Rows in consecutive groups (tickets, orders) of U[lo, hi] rows:
    (group number from 1, row's position in its group, group count)."""
    m = -(-n // lo) + 1
    sizes = d.ints(lo, hi, m)
    ends = torch.cumsum(sizes, 0)
    rows = torch.arange(n, dtype=torch.int64, device=d.dev)
    g = torch.searchsorted(ends, rows, right=True)
    pos = rows - (ends[g] - sizes[g])
    return g + 1, pos, int(g[-1]) + 1


def _distinct_items(d: _Draw, g: torch.Tensor, pos: torch.Tensor,
                    n_groups: int, n_item: int) -> torch.Tensor:
    """Items 1..n_item, distinct within a group of at most 16 rows:
    base + pos x step modulo n_item, step in [1, n_item / 16]."""
    base = d.ints(0, n_item - 1, n_groups + 1)
    step = d.ints(1, max(n_item // 16, 1), n_groups + 1)
    return (base[g] + pos * step[g]) % n_item + 1


def _pricing(d: _Draw, n: int, ship: bool) -> Dict[str, torch.Tensor]:
    """The money columns of a sales line, in cents (int64)."""
    qty = d.ints(1, 100, n)
    wholesale = d.ints(100, 10_000, n)
    lst = wholesale * (100 + d.ints(0, 200, n)) // 100
    sales = lst * (100 - d.ints(0, 100, n)) // 100
    ext_sales = qty * sales
    ext_wholesale = qty * wholesale
    ext_list = qty * lst
    tax = ext_sales * d.ints(0, 9, n) // 100
    coupon = torch.where(d.share(0.2, n),
                         ext_sales * d.ints(0, 100, n) // 100, 0)
    net_paid = ext_sales - coupon
    out = {"quantity": qty, "wholesale_cost": wholesale, "list_price": lst,
           "sales_price": sales, "ext_discount_amt": qty * (lst - sales),
           "ext_sales_price": ext_sales,
           "ext_wholesale_cost": ext_wholesale, "ext_list_price": ext_list,
           "ext_tax": tax, "coupon_amt": coupon}
    if ship:
        shipc = ext_list * d.ints(0, 50, n) // 100
        out["ext_ship_cost"] = shipc
        out["net_paid"] = net_paid
        out["net_paid_inc_tax"] = net_paid + tax
        out["net_paid_inc_ship"] = net_paid + shipc
        out["net_paid_inc_ship_tax"] = net_paid + shipc + tax
    else:
        out["net_paid"] = net_paid
        out["net_paid_inc_tax"] = net_paid + tax
    out["net_profit"] = net_paid - ext_wholesale
    return out


_SS_MONEY = ("wholesale_cost", "list_price", "sales_price",
             "ext_discount_amt", "ext_sales_price", "ext_wholesale_cost",
             "ext_list_price", "ext_tax", "coupon_amt", "net_paid",
             "net_paid_inc_tax", "net_profit")
_CS_MONEY = ("wholesale_cost", "list_price", "sales_price",
             "ext_discount_amt", "ext_sales_price", "ext_wholesale_cost",
             "ext_list_price", "ext_tax", "coupon_amt", "ext_ship_cost",
             "net_paid", "net_paid_inc_tax", "net_paid_inc_ship",
             "net_paid_inc_ship_tax", "net_profit")


def _store_sales(n: int, rows: dict, d: _Draw):
    """(store_sales's columns, its raw columns for store_returns)."""
    dev = d.dev
    t, pos, n_t = _groups(d, n, 8, 16)
    per = lambda lo, hi: d.ints(lo, hi, n_t + 1)[t]  # noqa: E731
    raw = {"sold_date_sk": per(SALES_FIRST, SALES_LAST),
           "sold_time_sk": per(0, OTHER_ROWS["time_dim"] - 1),
           "item_sk": _distinct_items(d, t, pos, n_t, rows["item"]),
           "customer_sk": per(1, rows["customer"]),
           "cdemo_sk": per(1, rows["customer_demographics"]),
           "hdemo_sk": per(1, OTHER_ROWS["household_demographics"]),
           "addr_sk": per(1, rows["customer_address"]),
           "store_sk": per(1, rows["store"]),
           "promo_sk": d.ints(1, rows["promotion"], n),
           "ticket_number": t}
    raw.update(_pricing(d, n, ship=False))
    b = _Columns(n, dev)
    keys = [("sold_date_sk", SALES_FIRST, SALES_LAST),
            ("sold_time_sk", 0, OTHER_ROWS["time_dim"] - 1),
            ("item_sk", 1, rows["item"]),
            ("customer_sk", 1, rows["customer"]),
            ("cdemo_sk", 1, rows["customer_demographics"]),
            ("hdemo_sk", 1, OTHER_ROWS["household_demographics"]),
            ("addr_sk", 1, rows["customer_address"]),
            ("store_sk", 1, rows["store"]),
            ("promo_sk", 1, rows["promotion"]),
            ("ticket_number", 1, n_t)]
    for k, lo, hi in keys:
        b.int32(f"ss_{k}", raw[k], lo, hi)
    b.int32("ss_quantity", raw["quantity"], 1, 100)
    for m in _SS_MONEY:
        b.money(f"ss_{m}", raw[m])
    return b, raw, ("ss_item_sk", "ss_ticket_number")


def _store_returns(n: int, ss_raw: dict, n_ss: int, rows: dict, d: _Draw):
    dev = d.dev
    pick = torch.randperm(n_ss, generator=d.gen, device=dev)[:n]
    src = {k: v[pick] for k, v in ss_raw.items()}
    rq = (torch.rand(n, generator=d.gen, device=dev)
          * src["quantity"]).to(torch.int64) + 1
    amt = rq * src["sales_price"]
    tax = amt * d.ints(0, 9, n) // 100
    fee = d.ints(50, 10_000, n)
    ship = rq * src["list_price"] * d.ints(0, 50, n) // 100
    inc = amt + tax
    cash = inc * d.ints(0, 100, n) // 100
    charge = (inc - cash) * d.ints(0, 100, n) // 100
    credit = inc - cash - charge
    b = _Columns(n, dev)
    b.int32("sr_returned_date_sk", src["sold_date_sk"] + d.ints(1, 90, n),
            SALES_FIRST + 1, SALES_LAST + 90)
    b.int32("sr_return_time_sk", d.ints(0, OTHER_ROWS["time_dim"] - 1, n),
            0, OTHER_ROWS["time_dim"] - 1)
    b.int32("sr_item_sk", src["item_sk"], 1, rows["item"])
    b.int32("sr_customer_sk", src["customer_sk"], 1, rows["customer"])
    b.int32("sr_cdemo_sk", src["cdemo_sk"], 1,
            rows["customer_demographics"])
    b.int32("sr_hdemo_sk", src["hdemo_sk"], 1,
            OTHER_ROWS["household_demographics"])
    b.int32("sr_addr_sk", src["addr_sk"], 1, rows["customer_address"])
    b.int32("sr_store_sk", src["store_sk"], 1, rows["store"])
    b.int32("sr_reason_sk", d.ints(1, OTHER_ROWS["reason"], n), 1,
            OTHER_ROWS["reason"])
    b.int32("sr_ticket_number", src["ticket_number"], 1,
            int(ss_raw["ticket_number"][-1]))
    b.int32("sr_return_quantity", rq, 1, 100)
    b.money("sr_return_amt", amt)
    b.money("sr_return_tax", tax)
    b.money("sr_return_amt_inc_tax", inc)
    b.money("sr_fee", fee)
    b.money("sr_return_ship_cost", ship)
    b.money("sr_refunded_cash", cash)
    b.money("sr_reversed_charge", charge)
    b.money("sr_store_credit", credit)
    b.money("sr_net_loss", ship + fee + tax - cash // 10)
    return b, ("sr_item_sk", "sr_ticket_number")


def _channel_sales(prefix: str, n: int, rows: dict, d: _Draw):
    """catalog_sales (``cs``) or web_sales (``ws``) in the spec's
    column order."""
    dev = d.dev
    o, pos, n_o = _groups(d, n, 4, 14)
    per = lambda lo, hi: d.ints(lo, hi, n_o + 1)[o]  # noqa: E731
    sold = per(SALES_FIRST, SALES_LAST)
    r = rows
    cust, cdemo = (1, r["customer"]), (1, r["customer_demographics"])
    hdemo = (1, OTHER_ROWS["household_demographics"])
    addr = (1, r["customer_address"])
    b = _Columns(n, dev)

    def key(name, lo, hi, data=None):
        b.int32(f"{prefix}_{name}", per(lo, hi) if data is None else data,
                lo, hi)

    key("sold_date_sk", SALES_FIRST, SALES_LAST, sold)
    key("sold_time_sk", 0, OTHER_ROWS["time_dim"] - 1)
    key("ship_date_sk", SALES_FIRST + 2, SALES_LAST + 90,
        sold + per(2, 90))
    if prefix == "ws":
        key("item_sk", 1, r["item"],
            _distinct_items(d, o, pos, n_o, r["item"]))
    key("bill_customer_sk", *cust)
    key("bill_cdemo_sk", *cdemo)
    key("bill_hdemo_sk", *hdemo)
    key("bill_addr_sk", *addr)
    key("ship_customer_sk", *cust)
    key("ship_cdemo_sk", *cdemo)
    key("ship_hdemo_sk", *hdemo)
    key("ship_addr_sk", *addr)
    if prefix == "cs":
        key("call_center_sk", 1, OTHER_ROWS["call_center"])
        key("catalog_page_sk", 1, OTHER_ROWS["catalog_page"])
        key("ship_mode_sk", 1, OTHER_ROWS["ship_mode"])
        key("warehouse_sk", 1, OTHER_ROWS["warehouse"])
        key("item_sk", 1, r["item"],
            _distinct_items(d, o, pos, n_o, r["item"]))
    else:
        key("web_page_sk", 1, OTHER_ROWS["web_page"])
        key("web_site_sk", 1, OTHER_ROWS["web_site"])
        key("ship_mode_sk", 1, OTHER_ROWS["ship_mode"])
        key("warehouse_sk", 1, OTHER_ROWS["warehouse"])
    key("promo_sk", 1, r["promotion"], d.ints(1, r["promotion"], n))
    key("order_number", 1, n_o, o)
    money = _pricing(d, n, ship=True)
    b.int32(f"{prefix}_quantity", money["quantity"], 1, 100)
    for m in _CS_MONEY:
        b.money(f"{prefix}_{m}", money[m])
    return b, (f"{prefix}_item_sk", f"{prefix}_order_number")


def _finish(b: _Columns, pk: Tuple[str, ...], gen: torch.Generator):
    """A fact table's NULLs: every column outside the primary key."""
    for name, col in zip(b.names, b.cols):
        if name not in pk:
            _apply_nulls(col, gen)
    return b.rel()


def generate_spec(sf: int = 10, seed: int = 0, device=None,
                  divisor: int = 1) -> dict:
    """The tables q1-q20 read, by the specification at scale factor
    ``sf`` (module docstring), as Rels on ``device`` (``cuda`` unless the
    caller passes another), the scaled tables' rows divided by
    ``divisor``."""
    dev = resolve_device(device)
    rows = row_counts(sf, divisor)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**63)
    d = _Draw(gen, dev)
    out = {}

    def made(name, fn):
        with span("tpcds.generate", table=name, rows=rows[name]):
            out[name] = fn()

    made("date_dim", lambda: _date_dim(rows["date_dim"], dev).rel())
    made("customer_demographics", lambda: _customer_demographics(
        rows["customer_demographics"], dev).rel())
    made("customer_address",
         lambda: _customer_address(rows["customer_address"], d).rel())
    made("customer", lambda: _customer(rows["customer"], rows, d).rel())
    made("item", lambda: _item(rows["item"], d).rel())
    made("store", lambda: _store(rows["store"], d).rel())
    made("promotion", lambda: _promotion(rows["promotion"], rows, d).rel())
    ss_parts = {}

    def store_sales():
        b, raw, pk = _store_sales(rows["store_sales"], rows, d)
        ss_parts["raw"] = raw
        return _finish(b, pk, gen)

    made("store_sales", store_sales)

    def store_returns():
        b, pk = _store_returns(rows["store_returns"], ss_parts.pop("raw"),
                               rows["store_sales"], rows, d)
        return _finish(b, pk, gen)

    made("store_returns", store_returns)
    made("catalog_sales", lambda: _finish(
        *_channel_sales("cs", rows["catalog_sales"], rows, d), gen))
    made("web_sales", lambda: _finish(
        *_channel_sales("ws", rows["web_sales"], rows, d), gen))
    return out
