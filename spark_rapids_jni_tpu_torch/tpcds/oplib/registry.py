"""Operator registry: the contract layer between the mask-algebra core
(tpcds/rel.py) and the operator library (tpcds/oplib/*).

Port of ``spark_rapids_jni_tpu/tpcds/oplib/registry.py``. Every operator
the core dispatches is declared once with its lowering, its
mask-composition class, its partition behaviour and its pandas oracle;
the core reaches lowerings only through :func:`dispatch`. The operator
modules load lazily, on the first lookup. The partition behaviour
(``local``, ``collective``, ``exchange_by_keys``) is declared as in the
reference. ``registry_revision()`` digests the registered set and the
lowering modules' source; it rides ``tpcds/rel.planner_env_key``, so a
batch-cache entry or a result-cache token never outlives an edit of the
operator library.
"""

from __future__ import annotations

import hashlib
import importlib
import sys
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

MASK_CLASSES = ("rowwise", "segmented", "terminal")
PARTITION_BEHAVIORS = ("local", "collective", "exchange_by_keys")

# The operator modules ensure_loaded() imports.
OPERATOR_MODULES = ("relational", "strings", "decimals", "windows")


@dataclass(frozen=True)
class OperatorSpec:
    """One registered operator: its lowering and declared contract."""

    name: str
    mask_class: str
    partition: str
    lowering: Callable
    oracle: Callable
    params: Tuple[str, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if self.mask_class not in MASK_CLASSES:
            raise ValueError(f"operator {self.name!r}: unknown mask class "
                             f"{self.mask_class!r} (known: {MASK_CLASSES})")
        if self.partition not in PARTITION_BEHAVIORS:
            raise ValueError(
                f"operator {self.name!r}: unknown partition behavior "
                f"{self.partition!r} (known: {PARTITION_BEHAVIORS})")
        if not callable(self.lowering):
            raise ValueError(f"operator {self.name!r}: lowering must be "
                             "callable")
        if not callable(self.oracle):
            raise ValueError(f"operator {self.name!r}: oracle must be "
                             "callable")


_REGISTRY: "dict[str, OperatorSpec]" = {}
_LOCK = threading.RLock()
_LOADED = False
_REVISION: Optional[str] = None  # guarded-by: _LOCK


def register_operator(spec: OperatorSpec) -> OperatorSpec:
    """Add one operator. Registering the same lowering again is allowed;
    a different lowering under a taken name is refused."""
    global _REVISION
    with _LOCK:
        old = _REGISTRY.get(spec.name)
        if old is not None and (
                (old.lowering.__module__, old.lowering.__qualname__)
                != (spec.lowering.__module__, spec.lowering.__qualname__)):
            raise ValueError(f"duplicate operator name {spec.name!r}")
        _REGISTRY[spec.name] = spec
        _REVISION = None  # the registry changed: digest it again
    return spec


def operator(name: str, *, mask_class: str, partition: str,
             oracle: Callable, params: Tuple[str, ...] = ()):
    """Decorator registering a lowering function as an operator."""
    def deco(fn: Callable) -> Callable:
        register_operator(OperatorSpec(
            name=name, mask_class=mask_class, partition=partition,
            lowering=fn, oracle=oracle, params=tuple(params)))
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


def registered() -> "dict[str, OperatorSpec]":
    """Every registered operator, by name."""
    ensure_loaded()
    return dict(_REGISTRY)


def dispatch(name: str, *args, **kwargs):
    """The core's one entry into operator lowerings."""
    return lookup(name).lowering(*args, **kwargs)


def registry_revision() -> str:
    """Content digest of the registered operator set: the names, the
    declared contracts and the lowering modules' source."""
    global _REVISION
    ensure_loaded()
    with _LOCK:
        if _REVISION is not None:
            return _REVISION
        h = hashlib.sha256()
        modules = set()
        for name in sorted(_REGISTRY):
            spec = _REGISTRY[name]
            h.update(f"{name}|{spec.mask_class}|{spec.partition}|"
                     f"{','.join(spec.params)}\n".encode())
            modules.add(spec.lowering.__module__)
        for mod in sorted(modules):
            src = getattr(sys.modules.get(mod), "__file__", None)
            try:
                with open(src, "rb") as f:
                    h.update(hashlib.sha256(f.read()).digest())
            except (OSError, TypeError):
                h.update(mod.encode())  # no source: the name stands in
        _REVISION = h.hexdigest()[:16]
        return _REVISION
