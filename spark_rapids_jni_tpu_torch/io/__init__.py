"""Host interchange of the port: Arrow tables and Parquet files."""

from .arrow import from_arrow, to_arrow
from .parquet import read_parquet

__all__ = ["from_arrow", "to_arrow", "read_parquet"]
