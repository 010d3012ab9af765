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
recorded as a ``compile`` event at its site (``obs/recompile.py``). A
graph has no serialized form, so there is no disk tier: a fresh process
captures again.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import sys
import time
import types

import torch

from ..obs import count


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
