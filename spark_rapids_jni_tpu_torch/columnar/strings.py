"""String columns as dictionary codes over sorted categories.

The reference ingests non-null string columns as int64 codes into a
host-side sorted dictionary (``rel.py`` ``rel_from_df``, the Parquet
dictionary-page idiom): code order equals lexicographic string order, so
sorts and groupbys on codes match string semantics and no string bytes
reach the device plan. This slice carries that representation only; the
byte-level STRING column the reference keeps for columns with nulls is
not ported yet.
"""

from __future__ import annotations

import numpy as np


def dictionary_encode(values) -> "tuple[np.ndarray, np.ndarray]":
    """(int64 codes, sorted categories) of a pandas Series; a null
    value gets code -1."""
    import pandas as pd
    codes, cats = pd.factorize(values, sort=True)
    return codes.astype(np.int64), np.asarray(cats)

