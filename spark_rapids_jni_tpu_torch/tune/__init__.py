"""Measurement-driven knob tuner.

Port of ``spark_rapids_jni_tpu/tune/``:

- ``space.py``: one ``TunableSpec`` a knob, with a small static ladder of
  candidate values, the workload it is measured on and its oracle
  (byte-equality of the full query result against the incumbent).
- ``runner.py``: measures each ladder through the real ``run_fused``
  path on the device (warm-up, then the minimum of a few samples) and
  keeps the fastest candidate whose result equals the incumbent's.
- ``store.py``: the winner table, keyed by the revision the kernels run
  under (torch, CUDA, the card, the kernel library's digest), written
  atomically under ``SRT_AOT_CACHE_DIR/tuned/``; a corrupt or stale
  table reads as empty, counted ``tune.store.tuned_stale``.

Every tuned knob resolves env > tuned winner > code default
(``config.tuned_*``); the winners that shape a plan ride
``tpcds/rel.planner_env_key``. The package root imports only the store:
``space`` and the runner load on first access.
"""

from .store import (active_table, active_table_digest, active_winner,
                    agree_active_table, load_table,
                    reset_active_table_for_testing, revision_digest,
                    revision_key, set_active_table, store_table, table_path)

__all__ = [
    "SPECS", "TunableSpec", "spec_by_knob", "tuned_planner_key",
    "active_table", "active_table_digest", "active_winner",
    "agree_active_table", "load_table", "reset_active_table_for_testing",
    "revision_digest", "revision_key", "set_active_table", "store_table",
    "table_path", "tune",
]

_SPACE_ATTRS = ("SPECS", "TunableSpec", "spec_by_knob", "tuned_planner_key")


def __getattr__(name: str):
    if name in _SPACE_ATTRS:
        from . import space
        return getattr(space, name)
    if name == "tune":
        from .runner import tune as _tune
        return _tune
    raise AttributeError(name)
