"""K1-K3 of the PyTorch/CUDA port against the JAX package's Pallas kernels.

On the CPU each wrapper in ``spark_rapids_jni_tpu_torch.ops.cuda_kernels``
runs its plain PyTorch version; here those are held against
``hash_join_probe_pallas``, ``ragged_groupby_sum_count_pallas`` and
``bitmask_pack_pallas`` run in Pallas interpret mode, as
``tests/test_pallas_kernels.py`` runs them, on the same numpy inputs.
Results must be equal. The route policies are checked with
``backend="cuda"`` and the forcing knobs. The kernels themselves run on
the card in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import bitmask as ref_bitmask
from spark_rapids_jni_tpu.ops import fused_pipeline as ref_fp
from spark_rapids_jni_tpu.ops import join as ref_join
from spark_rapids_jni_tpu.ops.pallas_kernels import (
    _key_lanes_u32, _probe_hash, bitmask_pack_pallas,
    hash_join_probe_pallas, ragged_groupby_sum_count_pallas)

from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
from spark_rapids_jni_tpu_torch.ops import fused_pipeline as fp
from spark_rapids_jni_tpu_torch.ops import join as pj


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# K1: hash-join probe
# --------------------------------------------------------------------------

def _probe_both(build, probe, bmask=None, pmask=None):
    ref = hash_join_probe_pallas(
        jnp.asarray(build), jnp.asarray(probe),
        build_live=None if bmask is None else jnp.asarray(bmask),
        probe_live=None if pmask is None else jnp.asarray(pmask))
    got = K.hash_join_probe(
        _t(build), _t(probe), build_live=None if bmask is None else _t(bmask),
        probe_live=None if pmask is None else _t(pmask))
    return ([np.asarray(r) for r in ref], [g.numpy() for g in got])


def _assert_probe_equal(build, probe, bmask=None, pmask=None):
    (ri, rf), (gi, gf) = _probe_both(build, probe, bmask, pmask)
    assert gi.dtype == np.int32 and gf.dtype == np.bool_
    np.testing.assert_array_equal(gf, rf)
    np.testing.assert_array_equal(gi, ri)
    return rf


def test_probe_hash_matches_reference_lanes():
    rng = np.random.default_rng(3)
    keys = np.concatenate([
        rng.integers(-2**63, 2**63 - 1, 4000, dtype=np.int64),
        np.array([0, -1, 2**63 - 1, -2**63, 2**32, 2**32 - 1], np.int64)])
    lo, hi = _key_lanes_u32(jnp.asarray(keys))
    ref = np.asarray(_probe_hash(lo, hi)).astype(np.int64)
    np.testing.assert_array_equal(K.probe_hash(_t(keys)).numpy(), ref)


def test_probe_parity_uniform_and_out_of_range():
    rng = np.random.default_rng(11)
    build = rng.permutation(20000)[:3000].astype(np.int64)
    probe = np.concatenate([
        rng.choice(build, 2000),
        rng.integers(-5000, 40000, 3000, dtype=np.int64)])
    found = _assert_probe_equal(build, probe)
    assert found.sum() >= 2000


def test_probe_parity_skewed_keys():
    rng = np.random.default_rng(12)
    build = (rng.permutation(50000)[:4000] + 100).astype(np.int64)
    hot = build[:40]
    probe = np.where(rng.random(6000) < 0.9,
                     hot[rng.integers(0, 40, 6000)],
                     rng.integers(0, 60000, 6000).astype(np.int64))
    _assert_probe_equal(build, probe)


def test_probe_masked_build_and_probe():
    rng = np.random.default_rng(13)
    build = rng.permutation(8000)[:1000].astype(np.int64)
    probe = rng.integers(0, 8000, 2500, dtype=np.int64)
    bmask = rng.random(1000) > 0.5
    pmask = rng.random(2500) > 0.3
    _assert_probe_equal(build, probe, bmask, pmask)


def test_probe_wide_keys_collide_on_low_lanes():
    # keys equal in the low 32 bits but not the high ones: the table must
    # compare whole keys
    base = np.arange(300, dtype=np.int64)
    build = np.concatenate([base, base + (1 << 40)])
    probe = np.concatenate([base + (1 << 40), base + (2 << 40), base])
    _assert_probe_equal(build, probe)


def test_probe_empty_and_all_filtered():
    build = np.arange(100, dtype=np.int64)
    idx, found = K.hash_join_probe(_t(build), torch.zeros(0, dtype=torch.int64))
    assert idx.shape == (0,) and found.shape == (0,)
    assert idx.dtype == torch.int32 and found.dtype == torch.bool
    _assert_probe_equal(np.zeros(0, np.int64), build)
    _assert_probe_equal(build, build, bmask=np.zeros(100, bool))


def test_probe_equals_dense_lookup_oracle():
    # the planner's contract: with unique live build keys the kernel route
    # and the direct-address route agree
    from spark_rapids_jni_tpu_torch.columnar import Column
    rng = np.random.default_rng(14)
    build = rng.permutation(9000)[:2500].astype(np.int64)
    probe = rng.integers(-100, 9100, 7000, dtype=np.int64)
    bmask = rng.random(2500) > 0.2
    col = Column.from_numpy(build, device=torch.device("cpu"))
    dmap = fp.build_dense_map(col, _t(bmask))
    want = fp.dense_lookup(dmap, _t(probe))
    got = K.hash_join_probe(_t(build), _t(probe), build_live=_t(bmask))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------------------------
# K2: ragged groupby
# --------------------------------------------------------------------------

def _groupby_both(slots, live, vals, width):
    rs, rc = ragged_groupby_sum_count_pallas(
        jnp.asarray(slots), jnp.asarray(live), jnp.asarray(vals), width)
    gs, gc = K.ragged_groupby_sum_count(_t(slots), _t(live), _t(vals), width)
    assert gs.dtype == torch.int64 and gc.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    return gs.numpy(), gc.numpy()


@pytest.mark.parametrize("width,n", [(33, 700), (1300, 2000), (4096, 1500)])
def test_ragged_groupby_parity(width, n):
    rng = np.random.default_rng(width)
    slots = rng.integers(0, width, n).astype(np.int32)
    vals = rng.integers(-2**62, 2**62, n).astype(np.int64)
    live = rng.random(n) > 0.3
    _groupby_both(slots, live, vals, width)


def test_ragged_groupby_skewed_slots():
    rng = np.random.default_rng(99)
    width, n = 2048, 3000
    slots = np.where(rng.random(n) < 0.9, rng.integers(0, 41, n),
                     rng.integers(0, width, n)).astype(np.int32)
    vals = rng.integers(-2**62, 2**62, n).astype(np.int64)
    _groupby_both(slots, np.ones(n, bool), vals, width)


def test_ragged_groupby_mod64_wrap_is_exact():
    s, c = _groupby_both(np.zeros(4, np.int32), np.ones(4, bool),
                         np.full(4, 2**62, np.int64), 1)
    assert int(s[0]) == 0 and int(c[0]) == 4
    # values near +-2^63 wrap in both directions
    vals = np.array([2**63 - 1, 2**63 - 1, -2**63, -2**63, 5], np.int64)
    _groupby_both(np.zeros(5, np.int32), np.ones(5, bool), vals, 1)


def test_ragged_groupby_empty_all_masked_and_out_of_range():
    _groupby_both(np.zeros(0, np.int32), np.zeros(0, bool),
                  np.zeros(0, np.int64), 7)
    s, c = _groupby_both(np.zeros(50, np.int32), np.zeros(50, bool),
                         np.ones(50, np.int64), 7)
    assert not s.any() and not c.any()
    # out-of-range slots are skipped (the reference requires them dead;
    # the port's kernel and plain version drop them either way)
    slots = np.array([-1, 7, 100, 3], np.int32)
    gs, gc = K.ragged_groupby_sum_count(
        _t(slots), torch.ones(4, dtype=torch.bool),
        torch.tensor([1, 2, 3, 4]), 7)
    assert gs.tolist() == [0, 0, 0, 4, 0, 0, 0]
    assert gc.tolist() == [0, 0, 0, 1, 0, 0, 0]


def test_ragged_groupby_rejects_float_values():
    from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError
    with pytest.raises(CudfLikeError, match="integral"):
        K.ragged_groupby_sum_count(torch.zeros(3, dtype=torch.int32),
                                   torch.ones(3, dtype=torch.bool),
                                   torch.ones(3, dtype=torch.float64), 4)


# --------------------------------------------------------------------------
# K3: bitmask pack
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 8192 + 5])
def test_bitmask_pack_parity(n):
    rng = np.random.default_rng(n)
    valid = rng.random(n) > 0.4
    ref = np.asarray(bitmask_pack_pallas(jnp.asarray(valid), interpret=True))
    got = K.bitmask_pack(_t(valid))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_bitmask.pack(jnp.asarray(valid))))


def test_bitmask_pack_padding_bits_zero_and_empty():
    got = K.bitmask_pack(torch.ones(33, dtype=torch.bool))
    assert got.tolist() == [0xFFFFFFFF, 1]
    assert K.bitmask_pack(torch.zeros(0, dtype=torch.bool)).shape == (0,)


def test_wrappers_do_not_count_cpu_calls():
    before = dict(K.LAUNCHES)
    K.bitmask_pack(torch.ones(40, dtype=torch.bool))
    K.hash_join_probe(torch.arange(10), torch.arange(20))
    K.ragged_groupby_sum_count(torch.zeros(4, dtype=torch.int32),
                               torch.ones(4, dtype=torch.bool),
                               torch.ones(4, dtype=torch.int64), 2)
    assert dict(K.LAUNCHES) == before


# --------------------------------------------------------------------------
# Route policies: the reference's TPU+Pallas branch on backend "cuda"
# --------------------------------------------------------------------------

def test_route_caps_match_reference():
    assert pj.CUDA_JOIN_MAX_CAPACITY == ref_join.PALLAS_JOIN_MAX_CAPACITY
    assert pj.CUDA_JOIN_MIN_PROBE_ROWS == ref_join.PALLAS_JOIN_MIN_PROBE_ROWS
    assert fp.CUDA_GROUPBY_MAX_WIDTH == ref_fp.PALLAS_GROUPBY_MAX_WIDTH
    assert K.RAGGED_MAX_WIDTH == ref_fp.PALLAS_GROUPBY_MAX_WIDTH
    for n in (0, 1, 63, 64, 65, 15_811, 262_144, 10**6):
        assert pj.hash_table_capacity(n) == ref_join.hash_table_capacity(n)


@pytest.mark.parametrize("n_build,n_probe", [
    (15_811, 10_000_000), (1000, 1 << 14), (1000, (1 << 14) - 1),
    (ref_join.PALLAS_JOIN_MAX_CAPACITY // 2, 1 << 20),
    (ref_join.PALLAS_JOIN_MAX_CAPACITY, 1 << 20)])
def test_join_probe_method_auto_mirrors_reference(n_build, n_probe,
                                                  monkeypatch):
    monkeypatch.delenv("SRT_JOIN_METHOD", raising=False)
    from spark_rapids_jni_tpu.config import set_config
    set_config(use_pallas=True)
    try:
        want = ref_join.join_probe_method(n_build, n_probe, backend="tpu")
    finally:
        set_config(use_pallas=False)
    got = pj.join_probe_method(n_build, n_probe, backend="cuda")
    assert got == {"pallas": "cuda", "xla": "xla"}[want]
    assert pj.join_probe_method(n_build, n_probe, backend="cpu") == "xla"


def test_join_probe_method_forcing_and_degrade(monkeypatch):
    monkeypatch.setenv("SRT_JOIN_METHOD", "xla")
    assert pj.join_probe_method(1000, 1 << 20, backend="cuda") == "xla"
    monkeypatch.setenv("SRT_JOIN_METHOD", "cuda")
    assert pj.join_probe_method(1000, 10, backend="cpu") == "cuda"
    before = kernel_stats()
    assert pj.join_probe_method(pj.CUDA_JOIN_MAX_CAPACITY, 1 << 20,
                                backend="cuda") == "xla"
    assert stats_since(before) == {"rel.route.join.cuda_degraded": 1}


@pytest.mark.parametrize("width", [1, 6, 379, 4096, 8192, 8193, 1 << 20])
def test_dense_groupby_method_auto_on_cuda(width, monkeypatch):
    monkeypatch.delenv("SRT_DENSE_GROUPBY", raising=False)
    want = "cuda" if width <= ref_fp.PALLAS_GROUPBY_MAX_WIDTH else "scatter"
    assert fp.dense_groupby_method(width, backend="cuda") == want
    # the one-hot route is never auto-picked here, and CPU tensors take
    # the plain scatter route
    assert fp.dense_groupby_method(width, backend="cpu") == "scatter"


def test_dense_groupby_method_forcing_and_degrade(monkeypatch):
    for mode in ("onehot", "scatter"):
        monkeypatch.setenv("SRT_DENSE_GROUPBY", mode)
        assert fp.dense_groupby_method(64, backend="cuda") == mode
    monkeypatch.setenv("SRT_DENSE_GROUPBY", "cuda")
    assert fp.dense_groupby_method(4096, backend="cpu") == "cuda"
    before = kernel_stats()
    assert fp.dense_groupby_method(fp.CUDA_GROUPBY_MAX_WIDTH * 2,
                                   backend="cuda") == "scatter"
    assert stats_since(before) == {"rel.route.groupby.cuda_degraded": 1}


def test_float_values_stay_on_scatter():
    rng = np.random.default_rng(5)
    slots = _t(rng.integers(0, 50, 400).astype(np.int32))
    live = torch.ones(400, dtype=torch.bool)
    vals = _t(rng.standard_normal(400))
    before = kernel_stats()
    s_c, c_c = fp.dense_groupby_sum_count(slots, live, vals, 50, "cuda")
    s_x, c_x = fp.dense_groupby_sum_count(slots, live, vals, 50, "scatter")
    assert torch.equal(s_c, s_x) and torch.equal(c_c, c_x)
    assert stats_since(before).get(
        "rel.route.groupby.cuda.float_scatter", 0) == 1
