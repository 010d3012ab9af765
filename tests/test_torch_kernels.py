"""K1-K6 of the PyTorch/CUDA port against the JAX package's Pallas kernels.

On the CPU each wrapper in ``spark_rapids_jni_tpu_torch.ops.cuda_kernels``
runs its plain PyTorch version; here those are held against
``hash_join_probe_pallas``, ``ragged_groupby_sum_count_pallas``,
``bitmask_pack_pallas``, ``murmur3_int32_pallas``,
``murmur3_int64_table_pallas`` and ``pack_rows_pallas`` run in Pallas
interpret mode, as ``tests/test_pallas_kernels.py`` and
``tests/test_pallas.py`` run them, on the same numpy inputs. K6's word
plan, which only the CUDA kernel reads, is checked here by a numpy
model of the kernel's loop.
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

from spark_rapids_jni_tpu_torch.columnar import bitmask
from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
from spark_rapids_jni_tpu_torch.ops import fused_pipeline as fp
from spark_rapids_jni_tpu_torch.ops import join as pj
from spark_rapids_jni_tpu_torch.ops.row_layout import fixed_width_layout
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError


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


# K3's table form: every column of the row format's validity bytes

def _fields_reference(vbytes: np.ndarray, n_fields: int) -> np.ndarray:
    """The JAX package's per-column route: unpack_bytes, then pack each
    column."""
    valid = ref_bitmask.unpack_bytes(jnp.asarray(vbytes), n_fields)
    return np.stack([np.asarray(ref_bitmask.pack(valid[:, c]))
                     for c in range(n_fields)]).reshape(
                         n_fields, (vbytes.shape[0] + 31) // 32)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000])
@pytest.mark.parametrize("n_fields", [1, 7, 8, 9, 32, 33, 104])
def test_bitmask_pack_fields_parity(n_fields, n):
    rng = np.random.default_rng(1000 * n_fields + n)
    nbytes = (n_fields + 7) // 8
    vbytes = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    want = _fields_reference(vbytes, n_fields)
    got = K.bitmask_pack_fields_plain(_t(vbytes), n_fields)
    assert got.dtype == torch.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.bitmask_pack_fields(_t(vbytes), n_fields).numpy(), want)
    # row c is what the vector form makes of column c
    valid = torch.from_numpy(np.asarray(ref_bitmask.unpack_bytes(
        jnp.asarray(vbytes), n_fields)))
    for c in range(n_fields):
        np.testing.assert_array_equal(
            got[c].numpy(), K.bitmask_pack(valid[:, c].contiguous()).numpy())


@pytest.mark.parametrize("n_fields,row_bytes,voff", [
    (32, 200, 196), (104, 640, 624), (9, 24, 19), (1500, 1688, 1500)])
def test_bitmask_pack_fields_strided_view(n_fields, row_bytes, voff):
    # a view of a row matrix, as convert_from_rows passes it: row stride
    # ``row_bytes``, first byte at ``voff``
    rng = np.random.default_rng(n_fields)
    n = 1001
    mat = _t(rng.integers(0, 256, (n, row_bytes), dtype=np.uint8))
    nbytes = (n_fields + 7) // 8
    view = mat[:, voff:voff + nbytes]
    assert view.stride() == (row_bytes, 1)
    want = _fields_reference(view.numpy(), n_fields)
    np.testing.assert_array_equal(
        K.bitmask_pack_fields(view, n_fields).numpy(), want)
    np.testing.assert_array_equal(
        bitmask.pack_fields(view, n_fields).numpy(), want)


def test_bitmask_pack_fields_rejects_bad_inputs():
    with pytest.raises(CudfLikeError, match="validity bytes"):
        K.bitmask_pack_fields(torch.zeros((4, 2), dtype=torch.uint8), 17)
    with pytest.raises(CudfLikeError, match="uint8"):
        K.bitmask_pack_fields(torch.zeros(4, dtype=torch.uint8), 8)


def _gather8(x: np.ndarray) -> np.ndarray:
    """K3's bit gather of 8 bool bytes (a little-endian uint64): byte i
    to bit i."""
    with np.errstate(over="ignore"):
        return ((x & np.uint64(0x0101010101010101))
                * np.uint64(0x0102040810204080)) >> np.uint64(56)


def _k3_vector_model(buf: np.ndarray, start: int, n: int) -> np.ndarray:
    """numpy model of ``bitmask_pack_kernel`` on the view
    ``buf[start:start + n]`` (``buf`` begins on a 16-byte boundary):
    aligned 16-byte chunks from 16-byte boundary below the view, bytes
    outside the view masked to 0, then each output word a funnel shift of
    two gathered words by the view's offset past that boundary."""
    lo, hi = start, start + n
    base, shift = lo & ~15, lo & 15
    n_words = (n + 31) // 32
    padded = np.zeros(max(len(buf), base + 32 * (n_words + 1)) + 16,
                      np.uint8)
    padded[:len(buf)] = buf

    def chunk_bits(c):
        if c + 16 <= lo or c >= hi:
            return 0
        q = padded[c:c + 16].view(np.uint64)
        bits = int(_gather8(q[0])) | int(_gather8(q[1])) << 8
        if c < lo:
            bits &= 0xFFFF << (lo - c)
        if c + 16 > hi:
            bits &= 0xFFFF >> (c + 16 - hi)
        return bits & 0xFFFF

    g = [chunk_bits(base + 32 * k) | chunk_bits(base + 32 * k + 16) << 16
         for k in range(n_words + 1)]
    return np.array([((g[w + 1] << 32 | g[w]) >> shift) & 0xFFFFFFFF
                     for w in range(n_words)], np.uint32)


@pytest.mark.parametrize("start", [0, 1, 5, 8, 15, 16, 17])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 33, 1023, 1024, 1057])
def test_bitmask_pack_bit_gather_model_equals_pack_host(start, n):
    # the kernel's arithmetic: 64-bit multiply gather, masks at the view's
    # ends and the funnel shift for a view off a 16-byte boundary; the
    # bytes around the view are 0/1 as well and must not leak in
    rng = np.random.default_rng(start * 10_000 + n)
    buf = (rng.random(start + n + 48) < 0.5).astype(np.uint8)
    want = bitmask.pack_host(buf[start:start + n].astype(bool))
    np.testing.assert_array_equal(_k3_vector_model(buf, start, n), want)


def test_bitmask_pack_gather_is_lsb_first():
    for i in range(8):
        x = np.array([1 << (8 * i)], np.uint64)
        assert int(_gather8(x)[0]) == 1 << i
    assert int(_gather8(np.array([0x0101010101010101], np.uint64))[0]) \
        == 0xFF


def _transpose32_model(rows: np.ndarray) -> np.ndarray:
    """numpy model of K3's ``transpose32``: 32 lanes' uint32 rows, five
    shuffle-xor rounds swapping the off-diagonal j x j blocks."""
    x = rows.astype(np.uint64)
    lane = np.arange(32)
    j = 16
    while j:
        m = np.uint64(0xFFFFFFFF // ((1 << j) + 1))
        full = np.uint64(0xFFFFFFFF)
        y = x[lane ^ j]
        hi = (x & (~m & full)) | ((y >> np.uint64(j)) & m)
        lo = (x & m) | ((y << np.uint64(j)) & (~m & full))
        x = np.where((lane & j) != 0, hi, lo)
        j >>= 1
    return x.astype(np.uint32)


@pytest.mark.parametrize("seed", range(4))
def test_bitmask_fields_transpose_model(seed):
    # lane r's word (bit c = column c of row r) becomes lane c's word
    # (bit r = row r of column c): the table form's 32 x 32 step
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    bits = (rows[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    want = (bits.T.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(axis=1).astype(np.uint32)
    np.testing.assert_array_equal(_transpose32_model(rows), want)


def _k2_reduce_model(width: int, blocks: int, warps: int = 32) -> None:
    """numpy model of step 3 of ``ragged_groupby_kernel``: every slot is
    written once, by one warp that (with its parts) reads every block's
    workspace row once, and the parts stay inside the 1024-slot buffer."""
    written = np.zeros(width, int)
    reads = np.zeros((width, blocks), int)
    per = ((width + blocks - 1) // blocks + 31) // 32 * 32
    for b in range(blocks):
        lo, hi = b * per, min(width, b * per + per)
        ncol = (hi - lo + 31) // 32 if hi > lo else 0
        if ncol == 0:
            continue
        if ncol >= warps:
            for warp in range(warps):
                for col in range(warp, ncol, warps):
                    for lane in range(32):
                        s = lo + col * 32 + lane
                        if s < hi:
                            reads[s] += 1
                            written[s] += 1
            continue
        parts = warps // ncol
        for warp in range(warps):
            col, part = divmod(warp, parts)
            for lane in range(32):
                s = lo + col * 32 + lane
                if col < ncol and s < hi:
                    reads[s, part::parts] += 1
                    if part == 0:
                        assert (warp + parts - 1) * 32 + lane < warps * 32
                        written[s] += 1
    assert (written == 1).all() and (reads == 1).all()


@pytest.mark.parametrize("width", [1, 6, 10, 31, 32, 33, 379, 1000, 1024,
                                   4096, 8191, 8192])
@pytest.mark.parametrize("blocks", [1, 2, 7, 31, 132])
def test_ragged_groupby_reduce_partition_model(width, blocks):
    _k2_reduce_model(width, blocks)


def test_ragged_copies_fit_shared_memory():
    # one copy a thread (1024) or a power of two up to one a warp (32),
    # always within the budget and K2's 227 KB of shared memory
    for width in range(1, K.RAGGED_MAX_WIDTH + 1):
        copies = K.ragged_copies(width)
        assert copies == 1024 or copies in (1, 2, 4, 8, 16, 32)
        assert copies * width * 12 <= K.RAGGED_COPY_BYTES <= 227 * 1024
        assert (copies == 1024) == (width <= 16)
        if copies < 32:
            assert 2 * copies * width * 12 > K.RAGGED_COPY_BYTES


def test_dense_groupby_cuda_route_skips_dead_and_out_of_range_rows():
    # the cuda route hands the mask and slots to K2 as they are; dead,
    # negative and too-large slots must fall out there
    rng = np.random.default_rng(17)
    for width in (1, 10, 33, 8192):
        n = 3001
        slots = rng.integers(-width - 5, 2 * width + 5, n).astype(np.int32)
        mask = rng.random(n) > 0.3
        vals = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64,
                            endpoint=True)
        got = fp.dense_groupby_sum_count(_t(slots), _t(mask), _t(vals),
                                         width, "cuda")
        want = ref_fp.dense_groupby_sum_count(
            jnp.asarray(slots), jnp.asarray(mask), jnp.asarray(vals), width)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        # the reference's kernel, given only the rows it takes
        ok = mask & (slots >= 0) & (slots < width)
        rs, rcnt = ragged_groupby_sum_count_pallas(
            jnp.asarray(np.where(ok, slots, 0).astype(np.int32)),
            jnp.asarray(ok), jnp.asarray(vals), width)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(rs))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(rcnt))


def test_wrappers_do_not_count_cpu_calls():
    before = dict(K.LAUNCHES)
    K.bitmask_pack(torch.ones(40, dtype=torch.bool))
    K.hash_join_probe(torch.arange(10), torch.arange(20))
    K.ragged_groupby_sum_count(torch.zeros(4, dtype=torch.int32),
                               torch.ones(4, dtype=torch.bool),
                               torch.ones(4, dtype=torch.int64), 2)
    seeds = torch.full((4,), 42, dtype=torch.int32)
    K.murmur3_int32(torch.arange(4, dtype=torch.int32), seeds)
    K.murmur3_int64(torch.arange(4), seeds)
    K.pack_rows([torch.arange(4)], [8])
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


# --------------------------------------------------------------------------
# K4, K5: murmur3 of one 4-byte block / one 8-byte value
# --------------------------------------------------------------------------

def _edge_values(rng, n, bits):
    """n values of a signed ``bits``-wide type, a third of them within
    1000 of its extremes or of zero."""
    lo, hi = -2**(bits - 1), 2**(bits - 1) - 1
    dt = np.int32 if bits == 32 else np.int64
    v = rng.integers(lo, hi, n, dtype=dt, endpoint=True)
    near = rng.integers(0, 1000, n, dtype=dt)
    pick = rng.integers(0, 6, n)
    v = np.where(pick == 0, hi - near, v)
    v = np.where(pick == 1, lo + near, v)
    return np.where(pick == 2, near - 500, v).astype(dt)


@pytest.mark.parametrize("n", [700, 4099])
def test_murmur3_int32_parity(n):
    from spark_rapids_jni_tpu.ops.pallas_kernels import murmur3_int32_pallas
    rng = np.random.default_rng(n)
    blocks = _edge_values(rng, n, 32)
    seeds = _edge_values(rng, n, 32)
    want = np.asarray(murmur3_int32_pallas(jnp.asarray(blocks),
                                           jnp.asarray(seeds),
                                           interpret=True))
    got = K.murmur3_int32(_t(blocks), _t(seeds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [700, 4099])
def test_murmur3_int64_table_parity(n):
    from spark_rapids_jni_tpu.ops.pallas_kernels import (
        murmur3_int64_pallas, murmur3_int64_table_pallas)
    rng = np.random.default_rng(n + 1)
    cols = [_edge_values(rng, n, 64) for _ in range(3)]
    want = np.asarray(murmur3_int64_table_pallas(
        [jnp.asarray(c) for c in cols], seed=42, interpret=True))
    # the port chains K5 over int64 columns in hashing.murmur3_table
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import hashing
    got = hashing.murmur3_table(Table([
        Column.from_numpy(c, device="cpu") for c in cols]), seed=42)
    np.testing.assert_array_equal(got.numpy(), want)
    seeds = _edge_values(rng, n, 32)
    want1 = np.asarray(murmur3_int64_pallas(
        jnp.asarray(cols[0]), jnp.asarray(seeds), interpret=True))
    np.testing.assert_array_equal(
        K.murmur3_int64(_t(cols[0]), _t(seeds)).numpy(), want1)


def test_murmur3_wrappers_check_types_and_empty():
    with pytest.raises(CudfLikeError, match="int32 seeds"):
        K.murmur3_int32(torch.arange(4, dtype=torch.int32),
                        torch.arange(4))
    with pytest.raises(CudfLikeError, match="int64"):
        K.murmur3_int64(torch.arange(4, dtype=torch.int32),
                        torch.arange(4, dtype=torch.int32))
    empty = torch.zeros(0, dtype=torch.int32)
    assert K.murmur3_int32(empty, empty).shape == (0,)
    assert K.murmur3_int64(torch.zeros(0, dtype=torch.int64),
                           empty).shape == (0,)


# --------------------------------------------------------------------------
# K6: row pack
# --------------------------------------------------------------------------

_WIDTH_NP = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _columns(rng, widths, n):
    return [rng.integers(np.iinfo(_WIDTH_NP[w]).min,
                         np.iinfo(_WIDTH_NP[w]).max, n,
                         dtype=_WIDTH_NP[w], endpoint=True) for w in widths]


def _emulate_pack_kernel(columns, widths, validity):
    """What csrc/pack_rows.cu computes, in numpy, walking as it walks: for
    each item (a tile of T rows, one segment of the row; the last tile
    partial) it stages the segment's column runs and the validity words of
    its vote columns into one buffer laid out as the plan says, copies
    each staged column into its place in a zeroed row image (rows
    ``img_stride`` bytes apart), builds each validity byte from the staged
    words 32 rows at a time, and stores the image's rows, or their slice
    of the segment."""
    plan = K.pack_plan(tuple(widths))
    n, tile, stride = columns[0].shape[0], plan.tile_rows, plan.img_stride
    assert tile % 32 == 0 and stride % 16 == 8
    assert plan.smem_bytes <= (K.PACK_SMEM_BYTES if tile >= 128
                               else K.PACK_SMEM_ONE_BLOCK)
    raw = [c.view(np.uint8) for c in columns]
    out = np.zeros((n, plan.size_per_row), np.uint8)
    for c0, c1, lo, hi, vc0, vc1, vst_at in plan.segments:
        assert hi - lo <= stride
        for r0 in range(0, n, tile):
            rows = min(tile, n - r0)
            buf = np.zeros(plan.buf_bytes, np.uint8)
            for c in range(c0, c1):
                at, width = plan.cols[c][0] & 0xFFFFFF, plan.cols[c][0] >> 24
                assert width == widths[c] and at + tile * width <= vst_at
                buf[at:at + rows * width] = raw[c][r0 * width:(r0 + rows)
                                                   * width]
            groups, nvc = -(-rows // 32), vc1 - vc0
            assert vst_at + 4 * (tile // 32) * nvc <= plan.buf_bytes
            vst = np.full((groups, nvc), 0xFFFFFFFF, np.uint32)
            for c in range(vc0, vc1):
                if validity[c] is not None:
                    vst[:, c - vc0] = validity[c][r0 // 32:r0 // 32 + groups]
            buf[vst_at:vst_at + vst.nbytes] = vst.reshape(-1).view(np.uint8)
            image = np.zeros((tile, stride), np.uint8)
            for c in range(c0, c1):
                at, width = plan.cols[c][0] & 0xFFFFFF, plan.cols[c][0] >> 24
                to = plan.cols[c][1] - lo
                image[:rows, to:to + width] = \
                    buf[at:at + rows * width].reshape(rows, width)
            staged = buf[vst_at:vst_at + 4 * groups * nvc].view(
                np.uint32).reshape(groups, nvc)
            rl = np.arange(rows)
            for b in range(vc0 // 8, -(-vc1 // 8)) if vc1 > vc0 else ():
                byte = np.zeros(rows, np.int64)
                for c in range(8 * b, min(8 * b + 8, vc1)):
                    byte |= ((staged[rl >> 5, c - vc0] >> (rl & 31)) & 1) \
                        << (c - 8 * b)
                image[:rows, plan.validity_offset + b - lo] = byte
            out[r0:r0 + rows, lo:hi] = image[:rows, :hi - lo]
    return out.view(np.int32)


def _reference_rows(cols, valids):
    """The JAX package's ``convert_to_rows`` bytes, and the packed
    validity words the port takes (None for an all-valid column)."""
    from spark_rapids_jni_tpu.columnar import Column as RefColumn
    from spark_rapids_jni_tpu.columnar import Table as RefTable
    from spark_rapids_jni_tpu.ops.row_conversion import convert_to_rows
    ref = RefTable([RefColumn.from_numpy(c, v) for c, v in zip(cols, valids)])
    want = np.asarray(convert_to_rows(ref)[0].child.data).view(np.uint8)
    words = [None if v.all() else np.array(ref_bitmask.pack(
        jnp.asarray(v))) for v in valids]
    return want, words


def _assert_pack_equals(cols, widths, words, want):
    got = K.pack_rows([_t(c) for c in cols], widths,
                      [None if w is None else _t(w) for w in words])
    np.testing.assert_array_equal(got.numpy().view(np.uint8).reshape(-1),
                                  want)
    np.testing.assert_array_equal(
        _emulate_pack_kernel(cols, widths, words).view(np.uint8)
        .reshape(-1), want)


@pytest.mark.parametrize("widths", [
    (8, 4, 2, 1),
    (1, 8, 2, 4, 1, 1, 2, 8, 4),
    (8, 8, 4, 1, 4, 1, 4, 8) * 4,  # TestTables.java's schema, 32 columns
])
def test_pack_rows_parity_all_valid(widths):
    from spark_rapids_jni_tpu.ops.pallas_kernels import pack_rows_pallas
    rng = np.random.default_rng(len(widths))
    n = 700  # not a multiple of the Pallas row tile
    cols = _columns(rng, widths, n)
    want = np.asarray(pack_rows_pallas([jnp.asarray(c) for c in cols],
                                       list(widths), interpret=True))
    got = K.pack_rows([_t(c) for c in cols], widths)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    np.testing.assert_array_equal(
        _emulate_pack_kernel(cols, widths, [None] * len(widths)),
        want.view(np.int32))


@pytest.mark.parametrize("n", [1, 33, 1000])
def test_pack_rows_with_nulls_equals_convert_to_rows(n):
    widths = (8, 4, 1, 2, 8, 1, 4, 1, 2)
    rng = np.random.default_rng(n + 7)
    cols = _columns(rng, widths, n)
    valids = [rng.random(n) > 0.3 for _ in widths]
    valids[2][:] = True  # one column without validity words
    want, words = _reference_rows(cols, valids)
    _assert_pack_equals(cols, widths, words, want)


def test_pack_rows_wide_table_equals_convert_to_rows():
    # 150 columns of every width, two thirds nullable: more validity
    # bytes than one 32-column vote and more words than one warp pass
    rng = np.random.default_rng(150)
    widths = tuple(int(w) for w in rng.choice([1, 2, 4, 8], 150))
    n = 97
    cols = _columns(rng, widths, n)
    valids = [np.ones(n, bool) if i % 3 == 0 else rng.random(n) > 0.3
              for i in range(len(widths))]
    want, words = _reference_rows(cols, valids)
    _assert_pack_equals(cols, widths, words, want)


# (schema, rows): T - 1, T and T + 1 rows of TestTables.java's schema
# (T = 192) and of a schema of 1- and 2-byte columns only (T = 256); a
# schema whose 32-row tile overflows shared memory, made in segments
_TESTTABLES = (8, 8, 4, 1, 4, 1, 4, 8) * 4
_NARROW = (1, 2, 2, 1, 1, 1, 2, 1, 2, 2, 1)
_SEGMENTED = (8, 1, 8, 8, 2, 8, 4, 8) * 48


@pytest.mark.parametrize("widths,n", [
    (_TESTTABLES, 191), (_TESTTABLES, 192), (_TESTTABLES, 193),
    (_NARROW, 255), (_NARROW, 256), (_NARROW, 257),
    (_SEGMENTED, 33),
], ids=["testtables-T-1", "testtables-T", "testtables-T+1", "narrow-T-1",
        "narrow-T", "narrow-T+1", "segmented"])
def test_pack_rows_tile_edges_equal_convert_to_rows(widths, n):
    plan = K.pack_plan(widths)
    assert (plan.tile_rows, len(plan.segments) > 1) == {
        _TESTTABLES: (192, False), _NARROW: (256, False),
        _SEGMENTED: (32, True)}[widths]
    rng = np.random.default_rng(n + len(widths))
    cols = _columns(rng, widths, n)
    valids = [np.ones(n, bool) if i % 4 == 0 else rng.random(n) > 0.2
              for i in range(len(widths))]
    want, words = _reference_rows(cols, valids)
    _assert_pack_equals(cols, widths, words, want)


def test_pack_plan_layout():
    # | A BOOL8 | B INT16 | C INT32 | -> 16 bytes, validity at byte 8
    # (RowConversion.java:60-72); tiles of 256 rows stage A at byte 0, B
    # at 256, C at 768, their 8 x 3 validity words at 1792; image rows are
    # 24 bytes apart (an odd number of 8-byte units)
    plan = K.pack_plan((1, 2, 4))
    assert (plan.size_per_row, plan.n_words, plan.validity_offset,
            plan.tile_rows, plan.img_stride) == (16, 4, 8, 256, 24)
    assert plan.cols == ((0 | 1 << 24, 0), (256 | 2 << 24, 2),
                         (768 | 4 << 24, 4))
    assert plan.segments == ((0, 3, 0, 16, 0, 3, 1792),)
    assert plan.buf_bytes == 1792 + 96 and plan.smem_bytes == \
        2 * 1888 + 256 * 24
    assert plan.words() == (0, 3, 0, 16, 0, 3, 1792, 0,
                            1 << 24, 0, 256 | 2 << 24, 2, 768 | 4 << 24, 4)
    # TestTables.java's 200-byte rows are an odd number of 8-byte units:
    # the image is the output's run of rows
    plan = K.pack_plan((8, 8, 4, 1, 4, 1, 4, 8) * 4)
    assert (plan.tile_rows, plan.img_stride) == (192, 200)
    # 640-byte rows: 64 rows with two blocks an SM, so one block takes the
    # SM for 128; image rows padded to 648 bytes
    plan = K.pack_plan((8, 8, 4, 1, 4, 1, 4, 8) * 13)
    assert (plan.tile_rows, plan.img_stride) == (128, 648)
    assert K.PACK_SMEM_BYTES < plan.smem_bytes <= K.PACK_SMEM_ONE_BLOCK


@pytest.mark.parametrize("widths", [_SEGMENTED, (1,) * 20_000,
                                    (4, 8, 1, 2) * 700])
def test_pack_plan_segments_partition_the_row(widths):
    # rows too wide for a 32-row tile: segments cut at 16-byte boundaries
    # own whole columns and bytes, cover the row in order, and their
    # buffers and images fit the block's shared memory together
    plan = K.pack_plan(widths)
    size, starts, voff = fixed_width_layout(widths)
    k = len(widths)
    assert plan.tile_rows == 32 and len(plan.segments) > 1
    assert plan.smem_bytes <= K.PACK_SMEM_BYTES
    c_at, b_at, v_at = 0, 0, 0
    for c0, c1, lo, hi, vc0, vc1, _ in plan.segments:
        assert (c0, lo) == (c_at, b_at) or c0 == c1
        assert lo % 16 == 0 and hi > lo and (hi - lo) % 8 == 0
        assert all(lo <= starts[c] and starts[c] + widths[c] <= hi
                   for c in range(c0, c1))
        if vc1 > vc0:
            assert vc0 == v_at and vc0 == 8 * max(lo - voff, 0)
            v_at = vc1
        c_at, b_at = max(c_at, c1), hi
    assert (c_at, b_at, v_at) == (k, size, k)


def test_pack_rows_rejects_bad_inputs():
    with pytest.raises(CudfLikeError, match="widths 1, 2, 4 or 8"):
        K.pack_rows([torch.zeros(4, dtype=torch.int64)] * 2, [8, 16])
    with pytest.raises(CudfLikeError, match="width"):
        K.pack_rows([torch.zeros(4, dtype=torch.int32)], [8])
    # 8 bytes, a validity byte, padding to 16: four words
    assert K.pack_rows([torch.zeros(0, dtype=torch.int64)], [8]).shape \
        == (0, 4)
