"""Device tables: ordered collections of equal-length columns."""

from __future__ import annotations

from typing import Tuple

from ..utils.errors import expects
from .column import Column


class Table:
    """The ``cudf::table_view`` analog."""

    def __init__(self, columns):
        columns: Tuple[Column, ...] = tuple(columns)
        if columns:
            n = columns[0].size
            for c in columns:
                expects(c.size == n,
                        "all columns in a table must have equal size")
        self.columns = columns

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        return self.columns[0].size if self.columns else 0

    def column(self, i: int) -> Column:
        return self.columns[i]

    def schema(self) -> list:
        """The columns' ``DType``s, in order."""
        return [c.dtype for c in self.columns]

    def __iter__(self):
        return iter(self.columns)

    def __repr__(self) -> str:
        return f"Table({self.num_rows} rows x {self.num_columns} cols)"
