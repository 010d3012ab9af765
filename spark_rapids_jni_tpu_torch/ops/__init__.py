"""Relational kernels of the port: sort, gather, joins, groupby, the
fused dense primitives and the hand-written CUDA kernels; and the Spark
roster modules ported so far (sketches, dates, nested rows, the casts and
string functions)."""

from .sort import sorted_order, gather
from .join import inner_join, left_join, left_semi_join, left_anti_join
from .groupby import groupby_aggregate
from .fused_pipeline import (
    DenseKeyMap, dense_map_applicable, build_dense_map, dense_lookup,
    dense_groupby_sum_count, dense_groupby_table, dense_groupby_method,
    dense_groupby_extreme,
)
from . import hllpp
from . import bloom_filter
from . import datetime
from . import datetime_rebase
from . import timezone
from . import cast_strings
from . import float_to_string
from . import parse_uri
from . import regexp

__all__ = [
    "hllpp", "bloom_filter", "datetime", "datetime_rebase", "timezone",
    "cast_strings", "float_to_string", "parse_uri", "regexp",
    "sorted_order", "gather", "inner_join", "left_join", "left_semi_join",
    "left_anti_join", "groupby_aggregate", "DenseKeyMap",
    "dense_map_applicable", "build_dense_map", "dense_lookup",
    "dense_groupby_sum_count", "dense_groupby_table",
    "dense_groupby_method", "dense_groupby_extreme",
]
