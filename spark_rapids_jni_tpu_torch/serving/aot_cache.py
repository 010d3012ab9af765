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

The reference's XLA half (``lower_and_compile``, ``persistent_jit``, the
disk tier's ``load_entry``/``store_entry``) serializes compiled
executables; eager PyTorch compiles no plan, and its analog waits for a
written decision with the fleet.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import sys
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
