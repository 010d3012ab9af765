"""Serving: the single-process serving path and the fleet scheduler.

Port of ``spark_rapids_jni_tpu/serving/``, the parts ported so far:

- **executor**: :class:`QueryExecutor`, a bounded-queue worker over
  ``run_fused`` with admission control, returning :class:`PendingQuery`
  handles;
- **scheduler**: :class:`FleetScheduler`, N workers over per-tenant
  weighted-fair queues under strict priority classes, admission budgets
  with shed-lowest-priority-first (:class:`QueryShed`), the result cache
  at submit, micro-batching windows, supervised workers, retries with
  backoff and deadlines at dequeue;
- **batcher**: micro-query batching, up to K compatible submissions in
  one batched dispatch (``tpcds/rel.run_fused_batched``, a CUDA graph
  replayed on the card), falling back route-counted to per-query
  dispatch;
- **result_cache**: the content-keyed result cache (whole entries on
  the device, leased from the page ledger while the page pool is on);
- **aot_cache**: the result cache's key constructors and the batch
  program's graph capture (``capture_graph``);
- **reliability**: the retry matrix, backoff, :class:`QueryExpired` and
  :class:`QueryPoisoned`, read by the scheduler.

The control plane, the scheduler's replica slices over a mesh and a disk
tier for captured programs are not ported yet.
"""

from . import aot_cache  # noqa: F401
from . import batcher  # noqa: F401
from . import reliability  # noqa: F401
from . import result_cache  # noqa: F401
from .executor import PendingQuery, QueryExecutor  # noqa: F401
from .reliability import (QueryExpired, QueryPoisoned,  # noqa: F401
                          RetryPolicy)
from .result_cache import ResultCache  # noqa: F401
from .scheduler import (FleetScheduler, QueryShed,  # noqa: F401
                        TenantConfig)

__all__ = ["aot_cache", "batcher", "reliability", "result_cache",
           "PendingQuery", "QueryExecutor", "FleetScheduler",
           "TenantConfig", "QueryShed", "QueryExpired", "QueryPoisoned",
           "RetryPolicy", "ResultCache"]
