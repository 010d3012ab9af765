"""The disk tier of the port's ``serving/aot_cache.py`` on the CPU.

The reference serializes compiled executables (its warm-disk cases in
``tests/test_serving.py``); a CUDA graph has no serialized form, so the
port keeps the kernel library and a manifest of captured batch keys
(the module docstring). On the CPU the library is a stand-in file (no
``nvcc`` here) and the capture the batched tests' stand-in graph:

1. **Library**: ``cuda_kernels.kernels`` builds into the tier (a
   stand-in build and ``CDLL``), then binds that copy checked by its
   sha256, with no build, counted ``aot.saves`` / ``aot.disk_hits``;
   corrupt bytes, a stale header, a missing header and the ``aot_load``
   fault seam each fall back (``aot.fallback``), drop the library and
   build it anew; with the tier off it builds under ``BUILD_DIR``.
2. **Manifest**: a captured window adds its batch key once; after the
   batch cache is cleared (a fresh process's state) ``warm_disk``
   captures it before the first window, which replays and reports
   provenance ``warm_disk`` (the next one ``warm_memory``), its results
   equal to the serial run; rels with another fingerprint miss; a
   stale entry (another environment or plan digest) and a corrupt
   manifest fall back and leave.
"""

import json
from pathlib import Path

import pytest
import torch

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
from spark_rapids_jni_tpu_torch.serving import aot_cache
from spark_rapids_jni_tpu_torch.tpcds import PLANS
from spark_rapids_jni_tpu_torch.tpcds import rel as R
from spark_rapids_jni_tpu_torch.utils import faults

NAME = "libsrt_torch_kernels-0123456789abcdef.so"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("SRT_AOT_CACHE_DIR", str(tmp_path / "aot"))
    monkeypatch.setenv("SRT_METRICS", "1")
    monkeypatch.delenv("SRT_BATCH_ROUTE", raising=False)
    obs.reset_all()
    faults.reset()
    R.clear_batch_cache()
    yield
    faults.reset()
    R.clear_batch_cache()
    obs.reset_all()


def _stats(prefix="aot."):
    return {k: v for k, v in obs.kernel_stats().items()
            if k.startswith(prefix)}


# --------------------------------------------------------------------------
# 1. the kernel library
# --------------------------------------------------------------------------

LIB = b"\x7fELF stand-in library bytes"


@pytest.fixture()
def lib(monkeypatch):
    """``kernels()`` with ``nvcc`` and ``ctypes`` stood in: ``_build``
    writes stand-in bytes and counts itself, ``CDLL`` records the path
    it binds. ``nvcc=False`` makes a build raise, as in a process
    without ``nvcc``."""
    state = {"builds": 0, "bound": [], "nvcc": True}

    def build(out):
        if not state["nvcc"]:
            raise RuntimeError("nvcc not found")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(LIB)
        state["builds"] += 1

    class _Lib:
        def __getattr__(self, item):
            return type("F", (), {})()

    monkeypatch.setattr(K, "_build", build)
    monkeypatch.setattr(K.ctypes, "CDLL",
                        lambda path: state["bound"].append(path) or _Lib())

    def bind():
        K.kernels.cache_clear()
        try:
            K.kernels()
        finally:
            K.kernels.cache_clear()
        return Path(state["bound"][-1])

    state["bind"] = bind
    yield state
    K.kernels.cache_clear()


def test_library_round_trip(tmp_path, lib):
    so = lib["bind"]()  # the tier is empty: a build, stored there
    assert so == tmp_path / "aot" / "kernels" / K.library_path().name
    assert lib["builds"] == 1 and so.read_bytes() == LIB
    head = json.loads(so.with_suffix(".json").read_text())
    assert head["name"] == so.name and head["format"] == 1
    assert _stats() == {"aot.saves": 1, "aot.bytes_written": len(LIB)}
    assert lib["bind"]() == so  # intact: bound again, no second build
    st = _stats()
    assert lib["builds"] == 1 and st["aot.disk_hits"] == 1
    assert st["aot.bytes_read"] == st["aot.bytes_written"] == len(LIB)


def _corrupt_bytes(so, head):
    so.write_bytes(so.read_bytes()[:-3] + b"xyz")


def _stale_header(so, head):
    meta = json.loads(head.read_text())
    meta["format"] = 999
    head.write_text(json.dumps(meta))


def _missing_header(so, head):
    head.unlink()


def _other_name(so, head):
    meta = json.loads(head.read_text())
    meta["name"] = "libsrt_torch_kernels-ffffffffffffffff.so"
    head.write_text(json.dumps(meta))


@pytest.mark.parametrize("damage", [_corrupt_bytes, _stale_header,
                                    _missing_header, _other_name],
                         ids=["corrupt_bytes", "stale_format",
                              "missing_header", "other_name"])
def test_library_bad_entry_falls_back(lib, damage):
    so = lib["bind"]()
    damage(so, so.with_suffix(".json"))
    assert lib["bind"]() == so  # dropped and built anew
    assert lib["builds"] == 2 and so.read_bytes() == LIB
    assert _stats()["aot.fallback"] == 1
    assert lib["bind"]() == so and lib["builds"] == 2  # intact again


def test_library_fault_seam_is_a_corrupt_entry(lib):
    lib["bind"]()
    faults.configure("aot_load:corrupt:1")
    lib["bind"]()
    st = obs.kernel_stats()
    assert lib["builds"] == 2 and st["aot.fallback"] == 1
    assert st["serving.fault.injected.aot_load.corrupt"] == 1


def test_library_tier_off_without_the_knob(tmp_path, lib, monkeypatch):
    monkeypatch.delenv("SRT_AOT_CACHE_DIR")
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    assert lib["bind"]().parent == tmp_path / "build"
    assert lib["bind"]().parent == tmp_path / "build"
    assert lib["builds"] == 1 and _stats() == {}


def test_kernels_binds_the_disk_copy_without_nvcc(tmp_path, lib):
    """A fresh process without ``nvcc`` over a filled tier: ``kernels``
    binds the tier's library and never builds."""
    so = lib["bind"]()
    lib["nvcc"] = False
    obs.reset_all()
    assert lib["bind"]() == so and lib["builds"] == 1
    assert _stats()["aot.disk_hits"] == 1
    so.with_suffix(".json").unlink()  # now it would have to build
    with pytest.raises(RuntimeError, match="nvcc"):
        lib["bind"]()


# --------------------------------------------------------------------------
# 2. the capture manifest and warm_disk
# --------------------------------------------------------------------------

def _copy_into(dst, src):
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif dst is not None:
        for x, y in zip(dst, src):
            _copy_into(x, y)


class _StandInGraph:
    """``capture_graph`` on the CPU: real runs of the program, a replay
    writing into the captured outputs."""

    pool_bytes = 0

    def __init__(self, fn, site, signature):
        fn()
        with K.capture_launches() as launches:
            self.outputs = fn()
        self.fn, self.launches, self.capture_s = fn, dict(launches), 0.0

    def replay(self):
        with K.capture_launches():
            _copy_into(self.outputs, self.fn())

    def release(self):
        self.outputs = None


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(
        aot_cache, "capture_graph",
        lambda fn, *, site, signature=(), device=None:
        _StandInGraph(fn, site, signature))


@pytest.fixture(scope="module")
def data():
    from spark_rapids_jni_tpu_torch.tpcds import generate
    return generate(sf=0.3, seed=5)


@pytest.fixture(scope="module")
def rels(data):
    return {k: R.rel_from_df(v, device="cpu") for k, v in data.items()}


def _window(q, rels, k=2):
    before = len(obs.recent_reports())
    outs = R.run_fused_batched(PLANS[q], [rels] * k, device="cpu",
                               _graph=True)
    reps = obs.recent_reports()[before:]
    return outs, reps[-1].provenance


def _manifest(tmp_path):
    return json.loads((tmp_path / "aot" / "graphs" /
                       "manifest.json").read_text())


@pytest.mark.parametrize("q", ["q3", "q9"])
def test_manifest_round_trip_reports_warm_disk(q, stand_in, rels,
                                               tmp_path):
    serial = R.run_fused(PLANS[q], rels, device="cpu").to_df()
    _, prov = _window(q, rels)
    assert prov == "cold_compile"
    _window(q, rels)  # a replay: the manifest keeps one entry
    ents = _manifest(tmp_path)["entries"]
    assert len(ents) == 1 and ents[0]["plan"] == f"_{q}"
    assert ents[0]["k"] == 2 and ents[0]["cap"] == 2
    # a fresh process's state: no batch-cache entry
    R.clear_batch_cache()
    obs.reset_all()
    assert aot_cache.warm_disk(rels, device="cpu", _graph=True) == [q]
    assert _stats()["aot.disk_hits"] == 1
    outs, prov = _window(q, rels)
    assert prov == "warm_disk"
    for o in outs:
        assert o.to_df().equals(serial)
    _, prov = _window(q, rels)
    assert prov == "warm_memory"


def test_manifest_other_rels_miss(stand_in, rels, data):
    _window("q3", rels)
    R.clear_batch_cache()
    obs.reset_all()
    small = {k: R.rel_from_df(v.head(len(v) // 2), device="cpu")
             for k, v in data.items()}
    assert aot_cache.warm_disk(small, device="cpu", _graph=True) == []
    assert _stats() == {"aot.disk_misses": 1}
    # the entry stays for the rels it was captured over
    assert aot_cache.warm_disk(rels, device="cpu", _graph=True) == ["q3"]


@pytest.mark.parametrize("field,value", [("env", "('other',)"),
                                         ("plan_digest", "0" * 64),
                                         ("plan", "_no_such_plan")])
def test_manifest_stale_entry_falls_back(stand_in, rels, tmp_path, field,
                                         value):
    _window("q3", rels)
    path = tmp_path / "aot" / "graphs" / "manifest.json"
    doc = json.loads(path.read_text())
    doc["entries"][0][field] = value
    path.write_text(json.dumps(doc))
    R.clear_batch_cache()
    obs.reset_all()
    assert aot_cache.warm_disk(rels, device="cpu", _graph=True) == []
    assert _stats() == {"aot.fallback": 1, "aot.saves": 1}
    assert _manifest(tmp_path)["entries"] == []  # the stale entry left
    _, prov = _window("q3", rels)
    assert prov == "cold_compile"


@pytest.mark.parametrize("blob", ["{torn", '{"format": 99, "entries": []}',
                                  '{"format": 1, "entries": 3}'])
def test_manifest_corrupt_falls_back(stand_in, rels, tmp_path, blob):
    path = tmp_path / "aot" / "graphs" / "manifest.json"
    path.parent.mkdir(parents=True)
    path.write_text(blob)
    assert aot_cache.warm_disk(rels, device="cpu", _graph=True) == []
    assert _stats()["aot.fallback"] == 1
    assert not path.exists()
    _window("q3", rels)  # captures and writes a fresh manifest
    assert len(_manifest(tmp_path)["entries"]) == 1


def test_eager_windows_write_no_manifest(rels, tmp_path):
    R.run_fused_batched(PLANS["q3"], [rels, rels], device="cpu")
    assert not (tmp_path / "aot" / "graphs").exists()
    assert aot_cache.warm_disk(rels, device="cpu") == []
