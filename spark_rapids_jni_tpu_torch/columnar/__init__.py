from .column import Column
from .table import Table
from . import bitmask

__all__ = ["Column", "Table", "bitmask"]
