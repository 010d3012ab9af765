"""Hash and range partitioning: Spark's partitioner semantics on device.

Port of ``spark_rapids_jni_tpu/parallel/partition.py``. Partition id =
``pmod(murmur3(row), num_partitions)`` with seed 42, exactly what the
Spark plugin computes before a shuffle; the row hash runs K4 (4-byte
columns) and K5 (8-byte columns) on the card (``ops.hashing``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Table
from ..ops.hashing import murmur3_table


def hash_partition_ids(keys: Table, num_partitions: int,
                       seed: int = 42) -> torch.Tensor:
    """(N,) int32 partition ids in [0, num_partitions)."""
    h = murmur3_table(keys, seed=seed).to(torch.int64)
    # Java's % then pmod: remainder with the dividend's sign, made >= 0
    return torch.remainder(h, int(num_partitions)).to(torch.int32)


def shard_capacity(n_rows: int, n_shards: int) -> int:
    """Per-shard row capacity of a row-sharded table: the smallest chunk
    whose ``n_shards`` chunks cover ``n_rows``, at least 1 (every shard
    holds the same shape; the tail's unused slots are dead rows)."""
    return max(1, -(-int(n_rows) // int(n_shards)))


def pad_rows(data: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Pad a row-major tensor with zero rows to ``n_shards *
    shard_capacity``. Padding rows are DEAD: callers mask them."""
    n = int(data.shape[0])
    total = shard_capacity(n, n_shards) * n_shards
    if total == n:
        return data
    pad = torch.zeros((total - n,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return torch.cat([data, pad])


# ---------------------------------------------------------------------------
# Range partitioning (Spark RangePartitioner analog, for sort shuffles)
# ---------------------------------------------------------------------------

def sample_range_bounds(keys: Table, num_partitions: int,
                        samples_per_partition: int = 20, seed: int = 0
                        ) -> Table:
    """``num_partitions - 1`` split rows, Spark RangePartitioner's shape:
    sample about 20 rows an output partition, sort the sample, take
    evenly spaced rows (ascending by the full lexicographic key)."""
    from ..ops.sort import gather, sorted_order

    n = keys.num_rows
    dev = keys.columns[0].device
    if num_partitions <= 1 or n == 0:
        return gather(keys, torch.zeros(0, dtype=torch.int64, device=dev))
    want = min(n, max(num_partitions * samples_per_partition, 1))
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n, size=want, replace=False)).astype(np.int64)
    sample = gather(keys, torch.from_numpy(rows).to(dev))
    ssorted = gather(sample, sorted_order(sample))
    pos = np.clip((np.arange(1, num_partitions) * want) // num_partitions,
                  0, want - 1).astype(np.int64)
    return gather(ssorted, torch.from_numpy(pos).to(dev))


def range_partition_ids(keys: Table, bounds: Table) -> torch.Tensor:
    """(N,) int32 partition ids under the lexicographic key order: a row
    equal to boundary ``i`` lands in partition ``i`` (inclusive upper
    bounds, Spark's convention); null keys rank lowest."""
    from ..ops.keys import row_ranks

    n = keys.num_rows
    dev = keys.columns[0].device
    if bounds.num_rows == 0:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    sorted_ranks, perm = row_ranks([keys, bounds], nulls_equal=True)
    ranks = torch.empty_like(sorted_ranks)
    ranks[perm] = sorted_ranks
    sb = torch.sort(ranks[n:]).values
    return torch.searchsorted(sb, ranks[:n].contiguous(),
                              side="left").to(torch.int32)
