"""Serving: the single-process serving path and the fleet scheduler.

Port of ``spark_rapids_jni_tpu/serving/``:

- **executor**: :class:`QueryExecutor`, a bounded-queue worker over
  ``run_fused`` with admission control, returning :class:`PendingQuery`
  handles;
- **scheduler**: :class:`FleetScheduler`, N workers over per-tenant
  weighted-fair queues under strict priority classes, admission budgets
  with shed-lowest-priority-first (:class:`QueryShed`), the result cache
  at submit, micro-batching windows, supervised workers, retries with
  backoff and deadlines at dequeue; with ``mesh=``, one worker a rank
  on its replica slice, every decision agreed across ranks
  (:class:`DeliveredResult` carries a result to ranks outside the
  serving slice);
- **control_plane**: the SLO-driven policy layer (predictive shedding,
  batch tuning, memory-pressure degradation, autoscaling) behind
  ``SRT_CONTROL_PLANE=1``, failing safe on the ``control`` fault seam;
- **batcher**: micro-query batching, up to K compatible submissions in
  one batched dispatch (``tpcds/rel.run_fused_batched``, a CUDA graph
  replayed on the card), falling back route-counted to per-query
  dispatch;
- **result_cache**: the content-keyed result cache (whole entries on
  the device, leased from the page ledger while the page pool is on);
- **aot_cache**: the result cache's key constructors, the batch
  program's graph capture (``capture_graph``) and the disk tier
  (``SRT_AOT_CACHE_DIR``: the kernel library and the capture manifest,
  ``warm_disk``);
- **reliability**: the retry matrix, backoff, :class:`QueryExpired` and
  :class:`QueryPoisoned`, read by the scheduler.
"""

from . import aot_cache  # noqa: F401
from . import batcher  # noqa: F401
from . import control_plane  # noqa: F401
from . import reliability  # noqa: F401
from . import result_cache  # noqa: F401
from .control_plane import ControlPlane, ControlPolicy  # noqa: F401
from .executor import PendingQuery, QueryExecutor  # noqa: F401
from .reliability import (QueryExpired, QueryPoisoned,  # noqa: F401
                          RetryPolicy)
from .result_cache import ResultCache  # noqa: F401
from .scheduler import (DeliveredResult, FleetScheduler,  # noqa: F401
                        QueryShed, RemoteQueryError, SliceFailed,
                        TenantConfig)

__all__ = ["aot_cache", "batcher", "control_plane", "reliability",
           "result_cache", "PendingQuery", "QueryExecutor", "FleetScheduler",
           "TenantConfig", "QueryShed", "QueryExpired", "QueryPoisoned",
           "RetryPolicy", "ResultCache", "ControlPlane", "ControlPolicy",
           "DeliveredResult", "RemoteQueryError", "SliceFailed"]
