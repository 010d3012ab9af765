"""Operator registry: the contract layer between the mask-algebra core
(tpcds/rel.py) and the operator library (tpcds/oplib/*).

Port of ``spark_rapids_jni_tpu/tpcds/oplib/registry.py``. Every operator
the core dispatches is declared once with its lowering, its
mask-composition class and its pandas oracle; the core reaches
lowerings only through :func:`dispatch`. This slice registers the
relational family (join, groupby) on one device: there is no
partitioned (``collective``) behaviour yet, and no plan cache for a
registry revision to key.
"""

from __future__ import annotations

import importlib
import threading
from dataclasses import dataclass, field
from typing import Callable, Tuple

MASK_CLASSES = ("rowwise", "segmented", "terminal")

# The operator modules ensure_loaded() imports.
OPERATOR_MODULES = ("relational",)


@dataclass(frozen=True)
class OperatorSpec:
    """One registered operator: its lowering and declared contract."""

    name: str
    mask_class: str
    lowering: Callable
    oracle: Callable
    params: Tuple[str, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if self.mask_class not in MASK_CLASSES:
            raise ValueError(f"operator {self.name!r}: unknown mask class "
                             f"{self.mask_class!r} (known: {MASK_CLASSES})")
        if not callable(self.lowering) or not callable(self.oracle):
            raise ValueError(f"operator {self.name!r}: lowering and oracle "
                             "must be callable")


_REGISTRY: "dict[str, OperatorSpec]" = {}
_LOCK = threading.RLock()
_LOADED = False


def operator(name: str, *, mask_class: str, oracle: Callable,
             params: Tuple[str, ...] = ()):
    """Decorator registering a lowering function as an operator."""
    def deco(fn: Callable) -> Callable:
        spec = OperatorSpec(name=name, mask_class=mask_class, lowering=fn,
                            oracle=oracle, params=tuple(params))
        with _LOCK:
            old = _REGISTRY.get(name)
            if old is not None and old.lowering.__qualname__ != fn.__qualname__:
                raise ValueError(f"duplicate operator name {name!r}")
            _REGISTRY[name] = spec
        return fn
    return deco


def ensure_loaded() -> None:
    """Import the operator modules once so their registrations land."""
    global _LOADED
    if _LOADED:
        return
    with _LOCK:
        if not _LOADED:
            for mod in OPERATOR_MODULES:
                importlib.import_module(f"{__package__}.{mod}")
            _LOADED = True


def lookup(name: str) -> OperatorSpec:
    ensure_loaded()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"unknown operator {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return spec


def dispatch(name: str, *args, **kwargs):
    """The core's one entry into operator lowerings."""
    return lookup(name).lowering(*args, **kwargs)

