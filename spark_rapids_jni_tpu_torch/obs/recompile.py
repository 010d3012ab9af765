"""Compile events: what the port builds at run time, and where.

Port of ``spark_rapids_jni_tpu/obs/recompile.py``, its eager analog.
The reference wraps ``jax.jit`` (``tracked_jit``) to attribute each
trace-and-compile to its call site and signature, and listens to
``jax.monitoring`` for every XLA backend compile. Eager PyTorch
compiles no program per shape, so neither has a twin here.

The one compile the port does at run time is the first-use ``nvcc``
build of the hand-kernel library (``ops/cuda_kernels.kernels()``): it
is recorded here as a ``compile`` event at site
``ops.cuda_kernels.build``, with its wall time and the span it fell in,
so a cold server's first ``ExecutionReport`` shows the build in its
``recompiles`` section. Loading a library already built from the same
sources records nothing. The batched runner's capture of a window's
program into a CUDA graph (``serving/aot_cache.capture_graph``) is the
other: one ``compile`` event at site ``rel.fused_batch.<query>`` with
the capacity and the capture's wall time. ``record_event`` respects the
``SRT_METRICS`` gate, as in the reference.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..config import metrics_enabled
from .metrics import REGISTRY
from .spans import current_span_name

_records: list = []  # guarded-by: _lock
_lock = threading.Lock()
_seq = 0  # guarded-by: _lock


class RecompileRecord:
    __slots__ = ("seq", "site", "kind", "signature", "span", "duration_s")

    def __init__(self, seq, site, kind, signature, span, duration_s=None):
        self.seq = seq
        self.site = site
        self.kind = kind  # "compile"
        self.signature = signature
        self.span = span
        self.duration_s = duration_s

    def to_dict(self) -> dict:
        return {"seq": self.seq, "site": self.site, "kind": self.kind,
                "signature": self.signature, "span": self.span,
                "duration_s": self.duration_s}


def record_event(site: str, kind: str, signature: tuple,
                 duration_s: Optional[float] = None) -> None:
    """Record one compile event at ``site`` (counted ``jit.<kind>s``)
    when metrics are on."""
    global _seq
    if not metrics_enabled():
        return
    with _lock:
        _seq += 1
        _records.append(RecompileRecord(_seq, site, kind, tuple(signature),
                                        current_span_name(), duration_s))
    REGISTRY.counter(f"jit.{kind}s").inc()


def mark() -> int:
    with _lock:
        return _seq


def records_since(watermark: int = 0) -> list:
    out = []
    with _lock:
        for r in reversed(_records):
            if r.seq <= watermark:
                break
            out.append(r)
    out.reverse()
    return out


def recompile_records() -> list:
    return records_since(0)


def reset_recompiles() -> None:
    with _lock:
        _records.clear()


def _leaf_sig(leaf) -> str:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype).replace("torch.", "")
        return f"{name}[{','.join(map(str, shape))}]"
    r = repr(leaf)
    return r if len(r) <= 64 else r[:61] + "..."


def _flatten(x, out: list) -> str:
    """Leaves of nested tuples, lists and dicts into ``out``; returns the
    structure as a string (the reference's pytree treedef)."""
    if isinstance(x, (tuple, list)):
        inner = ",".join(_flatten(v, out) for v in x)
        return f"({inner})" if isinstance(x, tuple) else f"[{inner}]"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k!r}:{_flatten(x[k], out)}"
                              for k in sorted(x, key=repr)) + "}"
    out.append(x)
    return "*"


def signature_of(args: tuple, kwargs: dict) -> tuple:
    """Hashable abstract signature of a call: per-leaf ``dtype[shape]``
    (repr for non-tensor leaves) plus the nesting structure."""
    leaves: list = []
    tree = _flatten((tuple(args), dict(kwargs)), leaves)
    return tuple(_leaf_sig(x) for x in leaves) + (tree,)
