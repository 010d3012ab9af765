"""Cache tokens: content-stable keys for the result cache.

Port of the token half of ``spark_rapids_jni_tpu/serving/aot_cache.py``:
``plan_code_digest`` (a plan function's bytecode and its module's
source), ``token_digest`` (sha256 over a token tuple's repr) and
``result_token``, the one constructor of result-cache keys. Tokens are
stable across processes, so a fresh ingest of equal content hits and a
changed value misses.

``environment_key`` names what a cached result was computed under: the
torch and CUDA versions and the digest of the hand-kernel library's
sources and flags (``ops/cuda_kernels.library_path``), where the
reference names jax, jaxlib and the device topology.

**Graph capture.** The reference's XLA half lowers and compiles a plan
into an executable (``lower_and_compile``) and keeps it in memory and
on disk (``persistent_jit``, ``load_entry``/``store_entry``). The port's
counterpart is ``capture_graph``: the batched runner's program (a plan
run once a slot, ``tpcds/rel.run_fused_batched``) warmed up once on a
side stream, then captured into a ``torch.cuda.CUDAGraph``, so that
every later window of the same batch key launches every kernel of every
slot with one CPU call (``CapturedGraph.replay``). The capture is
recorded as a ``compile`` event at its site (``obs/recompile.py``).

**The disk tier** (``SRT_AOT_CACHE_DIR``; unset = off). The reference
serializes its compiled executables; a CUDA graph has no serialized
form. What a fresh process can reuse is kept instead:

- the kernel library: with the tier on, ``ops/cuda_kernels`` builds it
  into ``<dir>/kernels/`` (its name carrying the digest of the sources
  and flags, a ``.json`` header beside it holding its format and
  sha256), so a fresh process binds it there without ``nvcc``;
- a manifest of the batch-cache keys that captured
  (``<dir>/graphs/manifest.json``: the plan's module, name and code
  digest, the environment key, the digest of the rels' fingerprints and
  planner knobs, the capacity rung and the slot count):
  ``note_capture`` adds one after each capture, and ``warm_disk(rels)``
  captures every entry that matches ``rels`` before the first window, so
  that window replays and reports provenance ``warm_disk``.

Writes are atomic (tmp file, then ``os.replace``). A corrupt entry (a
header or sha256 that does not match, an unreadable manifest) or a
stale one (another format, environment or plan digest) counts
``aot.fallback``, is dropped, and the process builds or captures as if
it were cold; nothing raises. ``aot.disk_hits`` counts libraries loaded
and entries warmed, ``aot.disk_misses`` manifest entries whose rels are
not at hand, ``aot.saves`` what was written.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import json
import os
import sys
import threading
import time
import types
from pathlib import Path
from typing import Optional

import torch

from ..config import env_str
from ..obs import count

# bump when the disk tier's layout changes: older entries read as stale
AOT_FORMAT_VERSION = 1


@functools.lru_cache(maxsize=1)
def environment_key() -> tuple:
    """torch and CUDA versions and the kernel library's source digest."""
    from ..ops.cuda_kernels import library_path
    return (torch.__version__, torch.version.cuda, library_path().stem)


def _const_digest(h, const) -> None:
    """Digest one code constant process-stably: nested code objects
    recurse (their repr embeds an address), sets hash sorted element
    reprs (string hashing reorders them between processes), tuples
    recurse."""
    if isinstance(const, types.CodeType):
        _hash_code(h, const)
    elif isinstance(const, (frozenset, set)):
        h.update(b"\x00fs")
        for r in sorted(map(repr, const)):
            h.update(r.encode())
    elif isinstance(const, tuple):
        h.update(b"\x00tu")
        for c in const:
            _const_digest(h, c)
    else:
        h.update(repr(const).encode())


def _hash_code(h, code) -> None:
    h.update(code.co_code)
    for const in code.co_consts:
        _const_digest(h, const)


@functools.lru_cache(maxsize=256)
def plan_code_digest(plan) -> str:
    """Process-stable identity of a plan function: qualified name,
    bytecode digest and, where resolvable, its module's source digest
    (editing any template of a module changes its plans' digests)."""
    h = hashlib.sha256()
    h.update(getattr(plan, "__module__", "").encode())
    h.update(getattr(plan, "__qualname__", repr(plan)).encode())
    code = getattr(plan, "__code__", None)
    if code is not None:
        _hash_code(h, code)
    try:
        h.update(inspect.getsource(sys.modules[plan.__module__]).encode())
    except (KeyError, OSError, TypeError):
        # a plan without source (a REPL): the bytecode digest still keys
        # it, a weaker key, counted
        count("aot.source_digest_misses")
    return h.hexdigest()


def token_digest(parts: tuple) -> str:
    """sha256 over the repr of a token tuple."""
    return hashlib.sha256(repr(parts).encode()).hexdigest()


def result_token(plan, parts: tuple) -> str:
    """The result-cache key: the plan code digest, the caller's content
    parts (rel fingerprints, ingest content digests, planner knobs, mesh
    descriptor) and the environment key. Every result-cache get and put
    keys through here, never through an object's identity."""
    return token_digest(("result", plan_code_digest(plan), parts,
                         environment_key()))


class CapturedGraph:
    """A captured CUDA graph: its static ``outputs`` (the tensors the
    captured run returned, rewritten in place by every replay, in the
    graph's private memory pool), the hand-kernel ``launches`` one
    replay makes, and ``pool_bytes``, what the allocator reserved while
    capturing: the private pool's size, an upper bound when other
    threads allocate at the same time."""

    __slots__ = ("graph", "outputs", "launches", "capture_s", "pool_bytes")

    def __init__(self, graph, outputs, launches: dict, capture_s: float,
                 pool_bytes: int = 0):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes

    def replay(self) -> None:
        """Launch the captured work on the current stream; the wrappers
        counted nothing while capturing, so the replay adds their
        launches to ``cuda_kernels.LAUNCHES``."""
        from ..ops import cuda_kernels as K
        self.graph.replay()
        K.LAUNCHES.update(self.launches)

    def release(self) -> None:
        """Drop the graph and its outputs: the private pool goes back to
        the allocator once nothing else holds its tensors."""
        self.graph = None
        self.outputs = None


def capture_graph(fn, *, site: str, signature: tuple = (),
                  device=None) -> CapturedGraph:
    """Capture ``fn()`` (a function of static buffers, returning tensors)
    into a CUDA graph on ``device``.

    ``fn`` runs once eagerly on a side stream first (the warm-up: the
    kernel library's first build, the allocator's blocks, the memoized
    uploads and the host-side plan decisions all happen there), then once
    under capture on the same stream. The capture uses
    ``capture_error_mode="thread_local"``: other threads' eager queries
    on the device (their allocations and host syncs, on the default
    stream, which the non-blocking side stream does not wait on) neither
    break this capture nor are refused by it, while a synchronising call
    inside ``fn`` itself fails the capture. A failed capture raises the
    error ``fn`` raised (or the capture's own) and leaves the stream out
    of capture mode. Recorded as a ``compile`` event at ``site``."""
    from ..obs.recompile import record_event
    from ..ops import cuda_kernels as K
    t0 = time.perf_counter_ns()
    dev = torch.device("cuda") if device is None else torch.device(device)
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()  # the warm-up: runs, counts its launches
        with K.capture_launches() as launches:
            reserved = torch.cuda.memory_reserved(dev)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # an invalidated capture ends in its own error
                raise
            graph.capture_end()
            pool_bytes = max(0, torch.cuda.memory_reserved(dev) - reserved)
    cur.wait_stream(side)
    capture_s = (time.perf_counter_ns() - t0) / 1e9
    record_event(site, "compile", tuple(signature), duration_s=capture_s)
    return CapturedGraph(graph, outputs, dict(launches), capture_s,
                         pool_bytes)


# --------------------------------------------------------------------------
# The disk tier
# --------------------------------------------------------------------------

_manifest_lock = threading.Lock()


def cache_dir() -> Optional[str]:
    """The disk tier's directory, or None when it is off."""
    d = env_str("SRT_AOT_CACHE_DIR", "").strip()
    return d or None


def _atomic_write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _drop(*paths) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def _manifest_path() -> Optional[str]:
    d = cache_dir()
    return None if d is None else os.path.join(d, "graphs", "manifest.json")


def _read_manifest(path: str) -> list:
    """The manifest's entries; an unreadable one counts ``aot.fallback``
    and is dropped."""
    if not os.path.exists(path):
        return []
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("format") != AOT_FORMAT_VERSION:
            raise ValueError("stale manifest format")
        entries = doc["entries"]
        if not isinstance(entries, list):
            raise ValueError("malformed manifest")
        return entries
    except Exception:
        count("aot.fallback")
        _drop(path)
        return []


def _write_manifest(path: str, entries: list) -> None:
    try:
        _atomic_write(path, json.dumps(
            {"format": AOT_FORMAT_VERSION, "entries": entries},
            indent=1, sort_keys=True).encode())
        count("aot.saves")
    except OSError:
        count("aot.save_errors")


def _env_repr() -> str:
    return repr(environment_key())


def batch_key_digest(parts: tuple) -> str:
    """Process-stable digest of a batch key's content (rel fingerprints,
    planner knobs, the capacity and route): the manifest's match key."""
    return token_digest(("batch", parts))


def note_capture(plan, key_digest: str, cap: int, k: int,
                 rtag: str) -> None:
    """Add one captured batch key to the manifest (a no-op when the tier
    is off or it is there already)."""
    path = _manifest_path()
    if path is None:
        return
    ent = {"module": getattr(plan, "__module__", ""),
           "plan": getattr(plan, "__qualname__", ""),
           "plan_digest": plan_code_digest(plan), "env": _env_repr(),
           "key": key_digest, "cap": int(cap), "k": int(k), "route": rtag}
    with _manifest_lock:
        entries = _read_manifest(path)
        if any(e.get("key") == key_digest and e.get("env") == ent["env"]
               for e in entries):
            return
        entries.append(ent)
        _write_manifest(path, entries)


def _resolve_plan(ent: dict):
    mod = sys.modules.get(ent.get("module", ""))
    if mod is None:
        import importlib
        mod = importlib.import_module(ent["module"])
    obj = mod
    for part in ent["plan"].split("."):
        obj = getattr(obj, part)
    return obj


def warm_disk(rels: dict, device=None, _graph: Optional[bool] = None
              ) -> list:
    """Capture, before the first window, every manifest entry whose key
    ``rels`` matches: the entry's plan runs one batched window of its
    slot count over ``rels`` (the capture and one replay), and the first
    real window of that key replays, reporting provenance ``warm_disk``.
    Stale entries (another environment or plan digest) count
    ``aot.fallback`` and leave the manifest; entries ``rels`` does not
    match count ``aot.disk_misses``. Returns the names of the plans
    warmed."""
    path = _manifest_path()
    if path is None:
        return []
    from ..tpcds import rel as relmod
    with _manifest_lock:
        entries = _read_manifest(path)
    env = _env_repr()
    keep, warmed = [], []
    for ent in entries:
        try:
            plan = _resolve_plan(ent)
            stale = (ent.get("env") != env
                     or ent.get("plan_digest") != plan_code_digest(plan))
        except Exception:
            plan, stale = None, True
        if stale:
            count("aot.fallback")
            continue
        keep.append(ent)
        k = max(2, int(ent.get("k", 2)))
        if not relmod.warm_batch_entry(plan, [rels] * k, device,
                                       ent.get("key", ""), graph=_graph):
            count("aot.disk_misses")
            continue
        count("aot.disk_hits")
        warmed.append(getattr(plan, "__name__", "plan").lstrip("_"))
    if len(keep) != len(entries):
        with _manifest_lock:
            _write_manifest(path, keep)
    return warmed
