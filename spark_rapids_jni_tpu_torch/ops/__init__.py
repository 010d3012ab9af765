"""Relational kernels of the port: sort, gather, copying, joins,
groupby, the fused dense primitives and the hand-written CUDA kernels;
and the Spark roster modules (sketches, percentiles, dates, nested rows,
the casts and string functions, JSON, maps, z-order, conditionals), under
the reference's names."""

from .sort import sorted_order, sort_by_key, sort, gather
from .copying import apply_boolean_mask, concatenate, concat_columns, \
    slice_rows
from .conditional import if_else, case_when, coalesce
from .get_json_object import get_json_object
from .join import (inner_join, inner_join_batched, left_join,
                   left_semi_join, left_anti_join)
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
from . import map_utils
from . import histogram
from . import tdigest
from . import zorder

__all__ = [
    "hllpp", "bloom_filter", "datetime", "datetime_rebase", "timezone",
    "cast_strings", "float_to_string", "parse_uri", "regexp",
    "map_utils", "histogram", "tdigest", "zorder", "get_json_object",
    "if_else", "case_when", "coalesce", "apply_boolean_mask",
    "concatenate", "concat_columns", "slice_rows", "sort_by_key", "sort",
    "sorted_order", "gather", "inner_join", "inner_join_batched",
    "left_join", "left_semi_join", "left_anti_join", "groupby_aggregate",
    "DenseKeyMap",
    "dense_map_applicable", "build_dense_map", "dense_lookup",
    "dense_groupby_sum_count", "dense_groupby_table",
    "dense_groupby_method", "dense_groupby_extreme",
]
