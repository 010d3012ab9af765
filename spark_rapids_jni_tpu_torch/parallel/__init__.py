"""The mesh on ``torch.distributed``: one process a device, SPMD.

Port of ``spark_rapids_jni_tpu/parallel/``: meshes (``mesh``), process
initialisation (``distributed``), the raw collectives (``collectives``),
Spark's hash and range partitioning (``partition``), the communication
planner (``comm_plan``) and the columnar shuffle (``shuffle``). NCCL
carries the collectives on CUDA, gloo on the CPU.
"""

from .comm_plan import (CommPlan, HierCommPlan, intra_exchange_route,
                        neighborhood_size, plan_exchange,
                        plan_exchange_hier, scratch_budget,
                        shuffle_join_route, single_shot_scratch_bytes)
from .collectives import (all_gather_rows, all_reduce, all_to_all_blocks,
                          axis_index_flat, reduce_scatter_extreme,
                          reduce_scatter_sum)
from .mesh import (DEFAULT_AXIS_RULES, INTRA_AXIS, PART_AXIS, REPLICA_AXIS,
                   Mesh, data_axes, default_mesh, logical_to_physical,
                   make_mesh, make_mesh_2d, make_mesh_3d, mesh_axes_key,
                   replica_submeshes)
from .partition import hash_partition_ids, pad_rows, shard_capacity
from .shuffle import (ShuffleResult, exchange_columns, exchange_columns_hier,
                      exchange_wire_bytes, shuffle_rows, shuffle_table)

__all__ = [
    "PART_AXIS",
    "REPLICA_AXIS",
    "INTRA_AXIS",
    "DEFAULT_AXIS_RULES",
    "logical_to_physical",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_3d",
    "mesh_axes_key",
    "replica_submeshes",
    "data_axes",
    "default_mesh",
    "hash_partition_ids",
    "shard_capacity",
    "pad_rows",
    "exchange_columns",
    "exchange_columns_hier",
    "exchange_wire_bytes",
    "shuffle_rows",
    "shuffle_table",
    "ShuffleResult",
    "CommPlan",
    "HierCommPlan",
    "plan_exchange",
    "plan_exchange_hier",
    "intra_exchange_route",
    "neighborhood_size",
    "scratch_budget",
    "shuffle_join_route",
    "single_shot_scratch_bytes",
    "all_to_all_blocks",
    "all_gather_rows",
    "axis_index_flat",
    "reduce_scatter_sum",
    "reduce_scatter_extreme",
    "Mesh",
    "all_reduce",
]
