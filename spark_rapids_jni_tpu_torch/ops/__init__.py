"""Relational kernels of the port: sort, gather, joins, groupby, the
fused dense primitives and the hand-written CUDA kernels."""

from .sort import sorted_order, gather
from .join import inner_join, left_join, left_semi_join, left_anti_join
from .groupby import groupby_aggregate
from .fused_pipeline import (
    DenseKeyMap, dense_map_applicable, build_dense_map, dense_lookup,
    dense_groupby_sum_count, dense_groupby_table, dense_groupby_method,
    dense_groupby_extreme,
)

__all__ = [
    "sorted_order", "gather", "inner_join", "left_join", "left_semi_join",
    "left_anti_join", "groupby_aggregate", "DenseKeyMap",
    "dense_map_applicable", "build_dense_map", "dense_lookup",
    "dense_groupby_sum_count", "dense_groupby_table",
    "dense_groupby_method", "dense_groupby_extreme",
]
