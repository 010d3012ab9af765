"""Serving: the single-process serving path.

Port of ``spark_rapids_jni_tpu/serving/``, the parts ported so far:

- **executor**: :class:`QueryExecutor`, a bounded-queue worker over
  ``run_fused`` with admission control, returning :class:`PendingQuery`
  handles;
- **result_cache**: the content-keyed result cache (whole entries on
  the device, leased from the page ledger while the page pool is on);
- **aot_cache**: its token half, the result cache's key constructors;
- **reliability**: the retry matrix, backoff, :class:`QueryExpired` and
  :class:`QueryPoisoned`.

Micro-batching (``batcher``), the fleet scheduler, the control plane and
the XLA half of ``aot_cache`` are not ported yet.
"""

from . import aot_cache  # noqa: F401
from . import reliability  # noqa: F401
from . import result_cache  # noqa: F401
from .executor import PendingQuery, QueryExecutor  # noqa: F401
from .reliability import (QueryExpired, QueryPoisoned,  # noqa: F401
                          RetryPolicy)
from .result_cache import ResultCache  # noqa: F401

__all__ = ["aot_cache", "reliability", "result_cache", "PendingQuery",
           "QueryExecutor", "QueryExpired", "QueryPoisoned", "RetryPolicy",
           "ResultCache"]
