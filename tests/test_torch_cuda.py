"""K1-K7 on the card: each hand-written CUDA kernel of the PyTorch/CUDA
port against its plain PyTorch version on the same CUDA tensors, and the
hashing and row-conversion entry points on the card against the same
calls on the CPU.

These tests need a CUDA device and ``nvcc``; they carry the ``cuda``
marker and skip elsewhere. The file imports no JAX, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels build and "
                    "run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_hash_join_probe_equals_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    build = torch.randperm(40_000, generator=g, device=cuda_device)[:5000]
    probe = torch.randint(-1000, 41_000, (300_000,), generator=g,
                          device=cuda_device)
    blive = torch.rand(5000, generator=g, device=cuda_device) > 0.2
    plive = torch.rand(300_000, generator=g, device=cuda_device) > 0.1
    for args in ((build, probe), (build, probe, blive, plive)):
        got = K.hash_join_probe(*args)
        want = K.hash_join_probe_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _probe_case(dev, n_build, n_probe, seed, dead_probe=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    build = torch.randperm(4 * n_build + 8, generator=g, device=dev)[:n_build]
    blive = torch.rand(n_build, generator=g, device=dev) > 0.1
    probe = torch.randint(-8, 4 * n_build + 16, (n_probe,), generator=g,
                          device=dev)
    plive = (torch.zeros(n_probe, dtype=torch.bool, device=dev) if dead_probe
             else torch.rand(n_probe, generator=g, device=dev) > 0.05)
    return build, probe, blive, plive


@pytest.mark.cuda
@pytest.mark.parametrize("n_build,n_probe", [
    (0, 1000),          # empty build: capacity 128, the shared table
    (4096, 1),          # capacity 8192, the largest shared table
    (4097, 1),          # capacity 16384, the table on the card
    (4096, 10_000_003), (4097, 10_000_003), (1820, 31_622), (15_811, 7)])
def test_cuda_hash_join_probe_both_tables(cuda_device, n_build, n_probe):
    # build sizes on both sides of PROBE_SHARED_SLOTS, probes of 1 and
    # 10M + 3 rows (a last group of three)
    args = _probe_case(cuda_device, n_build, n_probe, n_build + n_probe)
    shared = K.probe_table_shared(n_build)
    assert shared == (n_build <= 4096)
    before = K.LAUNCHES["hash_join_probe"]
    got = K.hash_join_probe(*args)
    assert K.LAUNCHES["hash_join_probe"] == before + (1 if shared else 2)
    want = K.hash_join_probe_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n_probe > 100:
        assert bool(got[1].any()) == (n_build > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_build", [300, 9000])
def test_cuda_hash_join_probe_dead_and_unaligned(cuda_device, n_build):
    # an all-dead probe reports (0, False) everywhere; keys and live bytes
    # at odd offsets take the kernel's scalar loads
    build, probe, blive, _ = _probe_case(cuda_device, n_build, 50_001, 5,
                                         dead_probe=True)
    idx, found = K.hash_join_probe(build, probe, blive,
                                   torch.zeros_like(probe, dtype=torch.bool))
    assert not bool(found.any()) and not bool(idx.any())
    plive = torch.rand(50_001, device=cuda_device) > 0.3
    args = (build, probe[1:], blive, plive[1:])
    got, want = K.hash_join_probe(*args), K.hash_join_probe_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_hash_join_probe_duplicate_build_keys_terminate(cuda_device):
    # duplicate live build keys are outside the contract, but both tables
    # must still fill and every walk end
    for n_build in (1000, 6000):
        build = torch.arange(n_build, device=cuda_device) % 7
        idx, found = K.hash_join_probe(build, torch.arange(
            20, device=cuda_device))
        torch.cuda.synchronize()
        assert found[:7].all() and not found[7:].any()
        assert bool((build[idx[:7].long()] == torch.arange(
            7, device=cuda_device)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 6, 379, 8192])
def test_cuda_ragged_groupby_equals_plain(cuda_device, width):
    g = torch.Generator(device=cuda_device).manual_seed(width)
    n = 500_000
    slots = torch.randint(-2, width + 2, (n,), generator=g,
                          device=cuda_device, dtype=torch.int32)
    vals = torch.randint(-2**62, 2**62, (n,), generator=g,
                         device=cuda_device) * 2
    live = torch.rand(n, generator=g, device=cuda_device) > 0.25
    got = K.ragged_groupby_sum_count(slots, live, vals, width)
    want = K.ragged_groupby_sum_count_plain(slots, live, vals, width)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 32, 33, 1_000_003])
def test_cuda_bitmask_pack_equals_plain(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    valid = torch.rand(n, generator=g, device=cuda_device) > 0.5
    got = K.bitmask_pack(valid).to(torch.int64)
    assert torch.equal(got, K.bitmask_pack_plain(valid).to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 1, 5, 8, 15])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 1023, 1_000_003])
def test_cuda_bitmask_pack_views_off_alignment(cuda_device, start, n):
    # a view that starts `start` bytes past a 16-byte boundary, with
    # set flags on both sides of it that must not leak into the words
    g = torch.Generator(device=cuda_device).manual_seed(start * 7 + n)
    flags = torch.rand(n + 64, generator=g, device=cuda_device) > 0.5
    view = flags[start:start + n]
    assert view.data_ptr() % 16 == start % 16
    before = K.LAUNCHES["bitmask_pack"]
    got = K.bitmask_pack(view)
    assert K.LAUNCHES["bitmask_pack"] == before + 1
    assert torch.equal(got.to(torch.int64),
                       K.bitmask_pack_plain(view).to(torch.int64))


def _row_matrix(dev, n, row_bytes, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (n, row_bytes), generator=g, device=dev,
                         dtype=torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fields", [1, 9, 32, 33, 104, 1500])
@pytest.mark.parametrize("n", [1, 33, 1025, 100_003])
def test_cuda_bitmask_pack_fields_equals_plain(cuda_device, n_fields, n):
    # the validity bytes as a strided view of a row matrix (first byte at
    # an odd offset: bytes straddle 4-byte words) and as a matrix of
    # their own
    nbytes = (n_fields + 7) // 8
    row_bytes = (n_fields + nbytes + 7 + 7) // 8 * 8
    mat = _row_matrix(cuda_device, n, row_bytes, n_fields * 31 + n)
    for vbytes in (mat[:, n_fields + 1:n_fields + 1 + nbytes],
                   mat[:, :nbytes].contiguous()):
        before = K.LAUNCHES["bitmask_pack_fields"]
        got = K.bitmask_pack_fields(vbytes, n_fields)
        assert K.LAUNCHES["bitmask_pack_fields"] == before + 1
        assert got.shape == (n_fields, (n + 31) // 32)
        want = K.bitmask_pack_fields_plain(vbytes, n_fields)
        assert torch.equal(got.to(torch.int64), want.to(torch.int64))


@pytest.mark.cuda
def test_cuda_convert_from_rows_packs_validity_in_one_launch(cuda_device):
    import numpy as np
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    r = np.random.default_rng(2)
    n, k = 100_003, 104
    t = Table([Column.from_numpy(
        r.integers(-2**31, 2**31, n).astype(np.int32),
        r.random(n) > 0.2 if i % 3 else None, device=cuda_device)
        for i in range(k)])
    rows = rc.convert_to_rows(t)
    before = dict(K.LAUNCHES)
    back = rc.convert_from_rows(rows[0], t.schema())
    # K7 packs every column's words with the columns: K3 is not launched
    assert K.LAUNCHES["unpack_rows"] == before.get("unpack_rows", 0) + 1
    assert K.LAUNCHES["bitmask_pack_fields"] == \
        before.get("bitmask_pack_fields", 0)
    for a, b in zip(back.columns, t.columns):
        assert torch.equal(a.valid_bool(), b.valid_bool())


def _groupby_case(dev, n, width, seed, skew=False, dead=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    slots = torch.randint(-3, width + 3, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    if skew:  # nine rows in ten on the first two slots
        hot = torch.randint(0, min(2, width), (n,), generator=g, device=dev,
                            dtype=torch.int32)
        slots = torch.where(torch.rand(n, generator=g, device=dev) < 0.9,
                            hot, slots)
    mag = torch.randint(2**62, 2**63 - 1, (n,), generator=g, device=dev)
    values = torch.where(torch.rand(n, generator=g, device=dev) < 0.5,
                         -mag, mag)
    live = (torch.zeros(n, dtype=torch.bool, device=dev) if dead else
            torch.rand(n, generator=g, device=dev) > 0.2)
    return slots, live, values


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 10, 16, 17, 31, 32, 33, 512, 513, 1024,
                                   8192])
@pytest.mark.parametrize("n,skew,dead", [
    (1_000_003, True, False), (1_000_003, False, False),
    (1_000_003, False, True), (65_537, False, False), (65_536, True, False),
    (5_000, False, True), (5_000, False, False), (17, False, False),
    (0, False, False)])
def test_cuda_ragged_groupby_one_launch_equals_plain(cuda_device, width, n,
                                                     skew, dead):
    # values near +-2^63 (the sums wrap), N not a multiple of 16, skewed
    # and all-dead rows, no rows at all; one block, the small calls read
    # eagerly (up to 65,536 rows) and the chunked path; every call is one
    # launch and writes every slot, with nothing zeroed first
    args = _groupby_case(cuda_device, n, width, width + n, skew, dead) \
        + (width,)
    before = K.LAUNCHES["ragged_groupby_sum_count"]
    got = K.ragged_groupby_sum_count(*args)
    assert K.LAUNCHES["ragged_groupby_sum_count"] == before + 1
    want = K.ragged_groupby_sum_count_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if dead or n == 0:
        assert not bool(got[1].any()) and not bool(got[0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [10, 8192])
def test_cuda_ragged_groupby_back_to_back_and_unaligned(cuda_device, width):
    # calls queued back to back on one stream, each into fresh outputs
    # over reused workspace memory, then views off 16-byte alignment (the
    # kernel's byte-at-a-time path)
    cases = [_groupby_case(cuda_device, n, width, n)
             for n in (2_000_000, 31_622, 1_000_003)]
    outs = [K.ragged_groupby_sum_count(*c, width) for c in cases]
    for c, got in zip(cases, outs):
        want = K.ragged_groupby_sum_count_plain(*c, width)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    slots, live, values = cases[0]
    args = (slots[1:-4], live[3:-2], values[2:-3], width)
    got = K.ragged_groupby_sum_count(*args)
    want = K.ragged_groupby_sum_count_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_wrappers_check_their_inputs(cuda_device):
    from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError
    probe = torch.arange(100, device=cuda_device)
    with pytest.raises(CudfLikeError, match="must lie on"):
        K.hash_join_probe(torch.arange(10), probe)
    with pytest.raises(CudfLikeError, match="bool"):
        K.bitmask_pack(torch.ones(40, dtype=torch.int8, device=cuda_device))
    with pytest.raises(CudfLikeError, match="width"):
        K.ragged_groupby_sum_count(
            torch.zeros(4, dtype=torch.int32, device=cuda_device),
            torch.ones(4, dtype=torch.bool, device=cuda_device),
            torch.ones(4, dtype=torch.int64, device=cuda_device),
            K.RAGGED_MAX_WIDTH + 1)


@pytest.mark.cuda
def test_cuda_queries_with_kernel_routes_equal_oracle(cuda_device,
                                                      monkeypatch):
    # at sf=2 the auto routes would keep the small probes on the gather;
    # forcing the kernel routes sends every dense join and groupby
    # through K1/K2 on the card
    import numpy as np
    from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES, generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
    monkeypatch.setenv("SRT_JOIN_METHOD", "cuda")
    monkeypatch.setenv("SRT_DENSE_GROUPBY", "cuda")
    data = generate(sf=2, seed=7)
    rels = {n: rel_from_df(df, device=cuda_device) for n, df in data.items()}
    before = dict(K.LAUNCHES)
    for q, (_, oracle) in QUERIES.items():
        got = run_fused(PLANS[q], rels, device=cuda_device).to_df()
        want = oracle(data)
        assert list(got.columns) == list(want.columns), q
        assert len(got) == len(want), q
        for c in got.columns:
            g, w = got[c].to_numpy(), want[c].to_numpy()
            if g.dtype.kind == "f" or w.dtype.kind == "f":
                # atomic float sums: the repo's oracle bound
                np.testing.assert_allclose(g.astype(np.float64),
                                           w.astype(np.float64), rtol=1e-9,
                                           atol=1e-9, equal_nan=True,
                                           err_msg=f"{q}.{c}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{q}.{c}")
    for name in ("hash_join_probe", "ragged_groupby_sum_count",
                 "bitmask_pack"):
        assert K.LAUNCHES[name] > before.get(name, 0), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 1_000_003])
def test_cuda_murmur3_equals_plain(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    blocks = torch.randint(-2**31, 2**31, (n,), generator=g,
                           device=cuda_device, dtype=torch.int32)
    seeds = torch.randint(-2**31, 2**31, (n,), generator=g,
                          device=cuda_device, dtype=torch.int32)
    values = torch.randint(-2**63, 2**63 - 1, (n,), generator=g,
                           device=cuda_device)
    before = dict(K.LAUNCHES)
    assert torch.equal(K.murmur3_int32(blocks, seeds),
                       K.murmur3_int32_plain(blocks, seeds))
    assert torch.equal(K.murmur3_int64(values, seeds),
                       K.murmur3_int64_plain(values, seeds))
    assert K.LAUNCHES["murmur3_int32"] == before.get("murmur3_int32", 0) + 1
    assert K.LAUNCHES["murmur3_int64"] == before.get("murmur3_int64", 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 100_003])
def test_cuda_pack_rows_equals_plain(cuda_device, n):
    widths = (8, 8, 4, 1, 4, 1, 4, 8) * 4 + (2, 1)
    dtypes = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    g = torch.Generator(device=cuda_device).manual_seed(n)
    cols = [torch.randint(-2**62, 2**62, (n,), generator=g,
                          device=cuda_device).to(dtypes[w]) for w in widths]
    valid = [None if i % 3 == 0 else K.bitmask_pack(
        torch.rand(n, generator=g, device=cuda_device) > 0.2)
        for i in range(len(widths))]
    for v in (None, valid):
        got = K.pack_rows(cols, widths, v)
        assert torch.equal(got, K.pack_rows_plain(cols, widths, v))


_DTYPES = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _pack_case(dev, widths, n, seed, null_every=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    cols = [torch.randint(-2**62, 2**62, (n,), generator=g,
                          device=dev).to(_DTYPES[w]) for w in widths]
    valid = [None if i % null_every == 0 else K.bitmask_pack(
        torch.rand(n, generator=g, device=dev) > 0.2)
        for i in range(len(widths))]
    return cols, valid


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols,n", [(104, 33), (104, 100_003),
                                      (1500, 1000)])
def test_cuda_pack_rows_wide_equals_plain(cuda_device, n_cols, n):
    # 104 columns: past the 64 a by-value plan could hold; 1500 columns:
    # rows too wide for a 32-row tile, made in segments
    widths = tuple(int(w) for w in torch.tensor([1, 2, 4, 8])[
        torch.randint(0, 4, (n_cols,), generator=torch.Generator()
                      .manual_seed(n_cols))])
    cols, valid = _pack_case(cuda_device, widths, n, n_cols + n)
    before = K.LAUNCHES["pack_rows"]
    got = K.pack_rows(cols, widths, valid)
    assert K.LAUNCHES["pack_rows"] == before + 1
    assert torch.equal(got, K.pack_rows_plain(cols, widths, valid))


_TESTTABLES = (8, 8, 4, 1, 4, 1, 4, 8) * 4


@pytest.mark.cuda
@pytest.mark.parametrize("widths,tile", [
    (_TESTTABLES, 192), ((1, 2, 2, 1, 1, 1, 2, 1, 2, 2, 1), 256),
    ((8, 1, 8, 8, 2, 8, 4, 8) * 48, 32)])
def test_cuda_pack_rows_tile_edges_equal_plain(cuda_device, widths, tile):
    # T - 1, T, T + 1 rows and more tiles than the grid holds; the third
    # schema is made in segments
    assert K.pack_plan(widths).tile_rows == tile
    for n in (tile - 1, tile, tile + 1, 2000 * tile + 33):
        cols, valid = _pack_case(cuda_device, widths, n, n)
        assert torch.equal(K.pack_rows(cols, widths, valid),
                           K.pack_rows_plain(cols, widths, valid)), n


@pytest.mark.cuda
def test_cuda_pack_rows_slices_nulls_and_unaligned(cuda_device):
    # a batch that starts at a nonzero multiple of 32 rows (as
    # convert_to_rows cuts them), all-null columns, and columns that are
    # views at an odd offset (staged with byte loads)
    n = 100_000
    cols, valid = _pack_case(cuda_device, _TESTTABLES, n, 3)
    valid[1] = torch.zeros_like(valid[1])
    valid[5] = torch.zeros_like(valid[5])
    at = 32 * 1001
    part = [c[at:] for c in cols]
    pvalid = [None if v is None else v[at // 32:] for v in valid]
    assert torch.equal(K.pack_rows(part, _TESTTABLES, pvalid),
                       K.pack_rows_plain(part, _TESTTABLES, pvalid))
    odd = [c[1:] for c in cols]
    assert torch.equal(K.pack_rows(odd, _TESTTABLES),
                       K.pack_rows_plain(odd, _TESTTABLES))


def _unpack_case(dev, widths, n, seed, offset=0):
    """Rows of the schema's size with every byte random, as a view
    ``offset`` bytes into a larger buffer."""
    from spark_rapids_jni_tpu_torch.ops.row_layout import fixed_width_layout
    size = fixed_width_layout(widths)[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randint(0, 256, (n * size + 16,), generator=g, device=dev,
                        dtype=torch.uint8)
    return buf[offset:offset + n * size].view(n, size)


def _assert_unpack_equals_plain(rows, widths):
    before = K.LAUNCHES["unpack_rows"]
    fields = K.LAUNCHES["bitmask_pack_fields"]
    cols, words = K.unpack_rows(rows, widths)
    assert K.LAUNCHES["unpack_rows"] == before + (1 if rows.shape[0] else 0)
    # the plain version views the rows as each width's integers, which
    # needs a buffer aligned to 8 bytes: it reads a packed copy
    want_cols, want_words = K.unpack_rows_plain(rows.clone(), widths)
    # the plain version launches K3's plain form: nothing counted
    assert K.LAUNCHES["bitmask_pack_fields"] == fields
    assert torch.equal(words.view(torch.int32), want_words.view(torch.int32))
    for i, (c, w) in enumerate(zip(cols, want_cols)):
        assert c.dtype == w.dtype and c.stride() == (1,)
        assert torch.equal(c, w), f"column {i}"


_WIDE_104 = (8, 8, 4, 1, 4, 1, 4, 8) * 13
_BANDED = (8, 1, 8, 8, 2, 8, 4, 8) * 64


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n", [
    (_TESTTABLES, 1), (_TESTTABLES, 31), (_TESTTABLES, 33),
    (_TESTTABLES, 255), (_TESTTABLES, 257), (_TESTTABLES, 1_000_000),
    (_TESTTABLES + (2, 1), 100_003), ((1, 2, 2, 1, 1, 1, 2, 1, 2, 2, 1), 513),
    (_WIDE_104, 161), (_WIDE_104, 1_000_000), (_BANDED, 33),
    (_BANDED, 10_001), ((1,) * 1500, 1000)],
    ids=lambda v: str(len(v)) if isinstance(v, tuple) else str(v))
def test_cuda_unpack_rows_equals_plain(cuda_device, widths, n):
    # random bytes everywhere (padding, validity bits past the last
    # column): the columns and words equal the plain version's, byte for
    # byte; 1M rows of 32 and of 104 columns; a banded schema
    _assert_unpack_equals_plain(
        _unpack_case(cuda_device, widths, n, n + len(widths)), widths)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [8, 4, 1])
@pytest.mark.parametrize("widths", [_TESTTABLES, _WIDE_104],
                         ids=["32", "104"])
def test_cuda_unpack_rows_unaligned_views(cuda_device, widths, offset):
    # a row buffer viewed 8 bytes past a 16-byte boundary takes 8-byte
    # copies, 4 bytes past 4-byte copies, 1 byte past byte loads
    rows = _unpack_case(cuda_device, widths, 5000, offset, offset)
    assert rows.data_ptr() % 16 == offset
    _assert_unpack_equals_plain(rows, widths)


@pytest.mark.cuda
def test_cuda_convert_from_rows_two_batches_through_k7(cuda_device,
                                                       monkeypatch):
    # a lowered cap splits 40,000 rows into two batches (as 12M rows of
    # 200 bytes split under 2 GB): one K7 launch a batch, no K3, no slot
    # copies; every value and validity bit back
    import numpy as np
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    r = np.random.default_rng(7)
    n = 40_000
    types = [T.INT64, T.FLOAT64, T.INT32, T.BOOL8, T.FLOAT32, T.INT8,
             T.decimal32(-3), T.decimal64(-8)] * 4
    cols = []
    for dt in types:
        vals = r.integers(-2**62, 2**62, n).astype(
            np.dtype(dt.storage_dtype)) if dt.id != T.TypeId.BOOL8 else \
            r.integers(0, 2, n).astype(np.int8)
        cols.append(Column.from_numpy(vals, r.random(n) > 0.01, dt,
                                      device=cuda_device))
    t = Table(cols)
    monkeypatch.setattr(rc, "SIZE_TYPE_MAX", 200 * 30_000)
    rows = rc.convert_to_rows(t)
    assert [b.size for b in rows] == [29_984, 10_016]
    K.reset_launch_counts()
    before = kernel_stats()
    start = 0
    for b in rows:
        back = rc.convert_from_rows(b, t.schema())
        for a, c in zip(back.columns, t.columns):
            want = rc.slice_rows(c, start, start + b.size)
            ok = want.valid_bool()
            assert torch.equal(a.valid_bool(), ok)
            assert a.data.dtype == c.data.dtype
            assert torch.equal(K.as_bytes(a.data)[ok],
                               K.as_bytes(want.data)[ok])
        start += b.size
    assert dict(K.LAUNCHES) == {"unpack_rows": 2}
    assert stats_since(before) == {
        "row_conversion.from_rows.route.unpack_rows": 2}


@pytest.mark.cuda
def test_cuda_convert_from_rows_launches_only_k7(cuda_device):
    # under the profiler, a conversion back runs K7 and the pointer
    # table's copy, and nothing else on the card
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    r = np.random.default_rng(8)
    n = 200_000
    t = Table([Column.from_numpy(r.integers(-2**31, 2**31, n).astype(
        np.int32), r.random(n) > 0.1, device=cuda_device)
        for _ in range(32)])
    rows = rc.convert_to_rows(t)
    rc.convert_from_rows(rows[0], t.schema())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc.convert_from_rows(rows[0], t.schema())
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [x for x in names if "memcpy" not in x.lower()]
    assert len(kernels) == 1 and "inverse::pack_rows_kernel" in kernels[0]


@pytest.mark.cuda
def test_cuda_empty_inputs_launch_nothing(cuda_device):
    before = dict(K.LAUNCHES)
    e32 = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    e64 = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    assert K.murmur3_int32(e32, e32).shape == (0,)
    assert K.murmur3_int64(e64, e32).shape == (0,)
    assert K.pack_rows([e64, e32], [8, 4]).shape == (0, 4)
    cols, words = K.unpack_rows(torch.zeros((0, 16), dtype=torch.uint8,
                                            device=cuda_device), [8, 4])
    assert [c.shape for c in cols] == [(0,), (0,)]
    assert words.shape == (2, 0)
    assert dict(K.LAUNCHES) == before


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_inputs_on_two_devices(cuda_device):
    from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError
    on_card = torch.arange(64, dtype=torch.int32, device=cuda_device)
    on_cpu = torch.arange(64, dtype=torch.int32)
    before = dict(K.LAUNCHES)
    with pytest.raises(CudfLikeError, match="must lie on"):
        K.murmur3_int32(on_card, on_cpu)
    with pytest.raises(CudfLikeError, match="must lie on"):
        K.murmur3_int64(on_card.to(torch.int64), on_cpu)
    with pytest.raises(CudfLikeError, match="must lie on"):
        K.pack_rows([on_card, on_cpu], [4, 4])
    assert dict(K.LAUNCHES) == before


@pytest.mark.cuda
def test_cuda_hashing_and_rows_equal_cpu(cuda_device):
    import numpy as np
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import hashing, hive_hash
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    from spark_rapids_jni_tpu_torch import types as T
    n = 10_007

    def table(dev):
        r = np.random.default_rng(3)
        valid = [r.random(n) > 0.1 for _ in range(6)]
        f64 = r.standard_normal(n)
        f64[:4] = [np.nan, -0.0, np.inf, -np.nan]
        return Table([
            Column.from_numpy(r.integers(-2**31, 2**31, n).astype(np.int32),
                              valid[0], device=dev),
            Column.from_numpy(r.integers(-2**62, 2**62, n), valid[1],
                              device=dev),
            Column.from_numpy(f64, valid[2], device=dev),
            Column.from_numpy(r.standard_normal(n).astype(np.float32),
                              valid[3], device=dev),
            Column.from_numpy(r.integers(0, 2, n).astype(np.int8), valid[4],
                              T.BOOL8, device=dev),
            Column.from_numpy(r.integers(-10**6, 10**6, n), valid[5],
                              T.decimal64(-2), device=dev)])
    on_card, on_cpu = table(cuda_device), table("cpu")
    K.reset_launch_counts()
    for fn in (hashing.murmur3_table, hashing.xxhash64_table):
        assert torch.equal(fn(on_card).cpu(), fn(on_cpu)), fn.__name__
    # HiveHash has no decimal route (nor has the reference)
    assert torch.equal(
        hive_hash.hive_hash_table(Table(on_card.columns[:5])).cpu(),
        hive_hash.hive_hash_table(Table(on_cpu.columns[:5])))
    assert K.LAUNCHES["murmur3_int32"] == 3
    assert K.LAUNCHES["murmur3_int64"] == 3
    rows = rc.convert_to_rows(on_card)
    assert K.LAUNCHES["pack_rows"] == 1
    assert torch.equal(rows[0].child.data.cpu(),
                       rc.convert_to_rows(on_cpu)[0].child.data)
    back = rc.convert_from_rows(rows[0], on_card.schema())
    for a, b in zip(back.columns, on_card.columns):
        assert torch.equal(a.valid_bool(), b.valid_bool())
        ok = b.valid_bool()
        assert torch.equal(K.as_bytes(a.data)[ok], K.as_bytes(b.data)[ok])


def _decimal_product(dev, n, seed, out_dtype):
    """q15's shape: a DECIMAL32 product of two cent columns whose
    overflow rows are NULL, on ``dev``."""
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import decimal_utils
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randint(100, 60_001, (n,), generator=g).to(dev)
    b = torch.randint(0, 60_001, (n,), generator=g).to(dev)
    ca = Column(T.decimal64(-2), n, a)
    cb = Column(T.decimal64(-2), n, b)
    return decimal_utils.multiply(ca, cb, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10_000_000, 10_000_005])
def test_cuda_bitmask_pack_decimal_validity(cuda_device, n):
    # K3's vector form packs the overflow validity of a decimal result
    # on 10M rows (q13-q15, q20); the result equals the CPU's, and K3
    # agrees with its plain version on the validity and on views of it
    # off a 16-byte boundary
    from spark_rapids_jni_tpu_torch import types as T
    before = K.LAUNCHES["bitmask_pack"]
    got = _decimal_product(cuda_device, n, 15, T.decimal32(-4))
    assert K.LAUNCHES["bitmask_pack"] == before + 1
    want = _decimal_product(torch.device("cpu"), n, 15, T.decimal32(-4))
    valid = got.valid_bool()
    assert torch.equal(valid.cpu(), want.valid_bool())
    assert torch.equal(got.validity.cpu().to(torch.int64),
                       want.validity.to(torch.int64))
    assert torch.equal(got.data.cpu()[want.valid_bool()],
                       want.data[want.valid_bool()])
    assert 0 < int((~valid).sum()) < n
    for start in (0, 3, 5, 13):
        view = valid[start:n - 1]
        assert torch.equal(K.bitmask_pack(view), K.bitmask_pack_plain(view))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [379, 3790])
def test_cuda_ragged_groupby_folded_value_mask(cuda_device, width):
    # K2 with a value column whose validity (decimal overflow NULLs)
    # folds into the live mask, as q15's groupby and q20's (10 states x
    # 379 stores) give it, through the planner's cuda route
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.ops import fused_pipeline as fp
    n = 10_000_000
    col = _decimal_product(cuda_device, n, 16, T.decimal32(-4))
    g = torch.Generator(device=cuda_device).manual_seed(width)
    slots = torch.randint(0, width, (n,), generator=g, device=cuda_device,
                          dtype=torch.int32)
    mask = torch.rand(n, generator=g, device=cuda_device) > 0.3
    live = mask & col.valid_bool()
    before = K.LAUNCHES["ragged_groupby_sum_count"]
    got = fp.dense_groupby_sum_count(slots, live, col.data, width, "cuda")
    assert K.LAUNCHES["ragged_groupby_sum_count"] == before + 1
    want = K.ragged_groupby_sum_count_plain(slots, live, col.data, width)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) == int(live.sum())


# --------------------------------------------------------------------------
# The aggregation and date roster on the card against the same calls on
# the CPU, and K3 on the roster's shapes
# --------------------------------------------------------------------------

def _roster_table(dev, n, seed):
    """A nested table on ``dev`` from seeded host arrays: INT64, FLOAT64
    with NaN payloads, STRUCT<INT32, STRING, STRUCT<FLOAT32>>, LIST<INT64>
    and BOOL8, nulls at every node (9 nodes: not a multiple of 8)."""
    import numpy as np
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.tpcds.carry import table_from_arrays
    r = np.random.default_rng(seed)

    def valid():
        return r.random(n) > 0.1

    def ids(dt):
        return (int(dt.id), dt.scale)
    f64 = r.standard_normal(n)
    f64.view(np.int64)[::7] = -0x7FFFFFFFFFFFF  # a -NaN payload
    lens = r.integers(0, 33, n)
    soffs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    chars = r.integers(97, 123, int(soffs[-1])).astype(np.uint8)
    llens = r.integers(0, 9, n)
    loffs = np.concatenate([[0], np.cumsum(llens)]).astype(np.int32)
    inner = ([ids(T.FLOAT32)], [r.standard_normal(n).astype(np.float32)],
             [valid()])
    struct = ([ids(T.INT32), ids(T.STRING), ids(T.STRUCT)],
              [r.integers(-9, 9, n).astype(np.int32), (soffs, chars), inner],
              [valid(), valid(), valid()])
    return table_from_arrays(
        [ids(T.INT64), ids(T.FLOAT64), ids(T.STRUCT), ids(T.LIST),
         ids(T.BOOL8)],
        [r.integers(0, 50, n), f64, struct,
         (loffs, r.integers(-2**62, 2**62, int(loffs[-1])), ids(T.INT64)),
         r.integers(0, 2, n).astype(np.int8)],
        [valid(), valid(), valid(), valid(), valid()], device=dev)


def _key_struct(t):
    """A STRUCT key over the roster table's fields that may be keys:
    STRUCT<INT64, STRUCT<FLOAT32>, BOOL8>."""
    from spark_rapids_jni_tpu_torch.columnar import Column
    return Column.struct_from_children(
        [t.columns[0], t.columns[2].children[2], t.columns[4]])


@pytest.mark.cuda
def test_cuda_groupby_roster_aggs_equal_cpu(cuda_device):
    # the seven new aggregations (and a STRUCT key) on the card equal the
    # CPU's: integers and bools exact, var/std within rtol=1e-9 (atomic
    # float sums change the order); K3 packs each result's validity
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.ops import groupby
    n = 100_003
    aggs = [(1, "var"), (1, "std"), (0, "first"), (0, "last"),
            (4, "any"), (4, "all"), (1, "nunique"), (0, "nunique")]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        t = _roster_table(dev, n, 21)
        out[dev.type] = [groupby.groupby_aggregate(Table([k]), t, aggs)
                         for k in (t.columns[0], _key_struct(t))]
        if dev.type == "cuda":
            K.reset_launch_counts()
            groupby.groupby_aggregate(Table([t.columns[0]]), t, aggs)
            # the key's validity, and six results (nunique has no nulls)
            assert K.LAUNCHES["bitmask_pack"] == 7
            valid = groupby.groupby_aggregate(
                Table([t.columns[0]]), t, aggs[:1]).columns[1].valid_bool()
            assert torch.equal(K.bitmask_pack(valid),
                               K.bitmask_pack_plain(valid))
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.num_rows == want.num_rows
        for (_, agg), g, w in zip([(0, "key")] + aggs, got.columns,
                                  want.columns):
            assert torch.equal(g.valid_bool().cpu(), w.valid_bool()), agg
            if agg in ("var", "std"):
                ok = w.valid_bool()
                torch.testing.assert_close(g.data.cpu()[ok], w.data[ok],
                                           rtol=1e-9, atol=0, equal_nan=True)
            elif g.data is not None:
                ok = w.valid_bool()
                assert torch.equal(g.data.cpu()[ok], w.data[ok]), agg


@pytest.mark.cuda
def test_cuda_sort_keys_struct_and_nan_equal_cpu(cuda_device):
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.ops.sort import sorted_order
    t, tc = _roster_table(cuda_device, 50_001, 3), _roster_table("cpu",
                                                                 50_001, 3)
    got = sorted_order(Table([t.columns[1], _key_struct(t)]), [True, False])
    want = sorted_order(Table([tc.columns[1], _key_struct(tc)]),
                        [True, False])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 100_003])
def test_cuda_nested_rows_equal_cpu(cuda_device, n):
    # the rows' bytes equal the CPU's; the decode reads the 9 nodes'
    # validity with one launch of K3's table form, equal to its plain
    # version on those bytes
    from spark_rapids_jni_tpu_torch.ops import nested_rows
    t, tc = _roster_table(cuda_device, n, n), _roster_table("cpu", n, n)
    tree = nested_rows.type_tree(t)
    lay = nested_rows.NestedRowLayout(tree)
    assert lay.n_nodes == 9
    rows = nested_rows.convert_to_rows_nested(t)
    want = nested_rows.convert_to_rows_nested(tc)
    assert torch.equal(rows.child.data.cpu(), want.child.data)
    K.reset_launch_counts()
    back = nested_rows.convert_from_rows_nested(rows, tree)
    assert K.LAUNCHES["bitmask_pack_fields"] == 1
    fixed = rows.child.data.view(torch.uint8).reshape(-1)
    starts = rows.offsets.data[:-1].to(torch.int64)
    vbytes = fixed[starts[:, None] + lay.validity_offset
                   + torch.arange(lay.validity_bytes, device=cuda_device)]
    assert torch.equal(K.bitmask_pack_fields(vbytes, lay.n_nodes),
                       K.bitmask_pack_fields_plain(vbytes, lay.n_nodes))
    ref = nested_rows.convert_from_rows_nested(want, tree)

    def leaves(col):
        yield col
        for ch in col.children:
            yield from leaves(ch)
    for a, b in zip(back.columns, ref.columns):
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x.valid_bool().cpu(), y.valid_bool())
            if x.data is not None:
                assert torch.equal(K.as_bytes(x.data).cpu(),
                                   K.as_bytes(y.data))


@pytest.mark.cuda
def test_cuda_bloom_filter_equals_cpu(cuda_device):
    # Spark's runtime-filter size: 8,388,608 bits, k = 6; K3 packs the
    # bit plane in one launch, equal to its plain version on a plane of
    # that size
    import numpy as np
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import bloom_filter
    keys = np.random.default_rng(6).integers(-2**62, 2**62, 1_000_000)
    valid = np.arange(keys.size) % 97 != 0
    probe = np.random.default_rng(7).integers(-2**62, 2**62, 1_000_000)
    words = {}
    for dev in (cuda_device, torch.device("cpu")):
        K.reset_launch_counts()
        words[dev.type] = bloom_filter.build(
            Column.from_numpy(keys, valid, device=dev), 8_388_608, 6)
        if dev.type == "cuda":
            assert K.LAUNCHES["bitmask_pack"] == 1
        words[dev.type + "_hits"] = bloom_filter.probe(
            words[dev.type], Column.from_numpy(probe, device=dev), 6)
    assert torch.equal(words["cuda"].cpu(), words["cpu"])
    assert torch.equal(words["cuda_hits"].cpu(), words["cpu_hits"])
    g = torch.Generator(device=cuda_device).manual_seed(8)
    plane = torch.rand(8_388_608, generator=g, device=cuda_device) < 0.5
    assert torch.equal(K.bitmask_pack(plane), K.bitmask_pack_plain(plane))


@pytest.mark.cuda
def test_cuda_hllpp_equals_cpu(cuda_device):
    import numpy as np
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import hllpp
    r = np.random.default_rng(9)
    n = 500_003
    keys, vals = r.integers(0, 40, n), r.integers(0, 200_000, n)
    valid = r.random(n) > 0.05
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        col = Column.from_numpy(vals, valid, device=dev)
        gk, sk = hllpp.groupby_reduce(
            Table([Column.from_numpy(keys, device=dev)]), col, 9)
        out[dev.type] = (hllpp.reduce(col, 9), sk, gk.columns[0].data,
                         hllpp.estimate_column(sk, 9).data,
                         hllpp.estimate(hllpp.reduce(col, 14), 14))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_dates_and_timezones_equal_cpu(cuda_device):
    import os
    import numpy as np
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import datetime as dto
    from spark_rapids_jni_tpu_torch.ops import datetime_rebase as reb
    from spark_rapids_jni_tpu_torch.ops import timezone as tz
    r = np.random.default_rng(10)
    us = r.integers(-62135596800000000, 253402300799999999, 1_000_003)
    days = (us // 86_400_000_000).astype(np.int32)
    fns = [getattr(dto, f) for f in (
        "extract_year", "extract_month", "extract_day", "extract_hour",
        "extract_minute", "extract_second", "extract_microsecond",
        "day_of_week", "day_of_year")]
    fns += [lambda c, u=u: dto.truncate(c, u) for u in dto.TRUNCATE_UNITS]
    fns += [lambda c: dto.add_interval_days(c, -40),
            reb.rebase_gregorian_to_julian, reb.rebase_julian_to_gregorian]
    zones = [z for z in ("America/Los_Angeles", "Europe/Berlin",
                         "Asia/Kolkata")
             if os.path.isfile(os.path.join(config.tzdir(), z))]
    for z in zones:
        fns += [lambda c, z=z: tz.convert_utc_to_timezone(c, z),
                lambda c, z=z: tz.convert_timezone_to_utc(c, z)]
    for arr, dt in ((us, T.TIMESTAMP_MICROSECONDS), (days, T.TIMESTAMP_DAYS)):
        on_card = Column.from_numpy(arr, None, dt, device=cuda_device)
        on_cpu = Column.from_numpy(arr, None, dt, device="cpu")
        for fn in fns if dt == T.TIMESTAMP_MICROSECONDS else fns[:9] + [
                reb.rebase_gregorian_to_julian,
                reb.rebase_julian_to_gregorian]:
            assert torch.equal(fn(on_card).data.cpu(), fn(on_cpu).data)


def _cast_inputs():
    """Seeded strings for every cast (digits, signs, fractions,
    exponents, literals, dates, zones and garbage) and the numbers the
    to-string casts take, 10% nulls."""
    import numpy as np
    r = np.random.default_rng(12)
    n = 200_003
    pieces = ["12", "-7", "+3", " 9 ", "1.5", "e3", "E-2", "inf", "NaN",
              "2015-03-18", " 12:03:17", ".123456", "Z", "+05:30", " UTC",
              "x", "", "9223372036854775808", "-0", "ff", "0.0001"]
    pick = r.integers(0, len(pieces), (n, 3))
    strs = ["".join(pieces[i] for i in row) for row in pick]
    valid = r.random(n) > 0.1
    strs = [s if v else None for s, v in zip(strs, valid)]
    ints = r.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    bits = r.integers(0, 1 << 64, n, dtype=np.uint64)
    return strs, ints, bits.view(np.float64), \
        bits.astype(np.uint32).view(np.float32), valid


@pytest.mark.cuda
def test_cuda_casts_equal_cpu_and_launch_k3(cuda_device):
    import numpy as np
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import cast_strings as cs
    from spark_rapids_jni_tpu_torch.ops import regexp as rx
    strs, *_ = _cast_inputs()
    calls = {
        "int64": lambda c: cs.cast_to_integer(c),
        "int8": lambda c: cs.cast_to_integer(c, T.INT8),
        "float64": lambda c: cs.cast_to_float(c),
        "float32": lambda c: cs.cast_to_float(c, T.FLOAT32),
        "decimal64": lambda c: cs.cast_to_decimal(c, T.decimal64(-2)),
        "decimal32": lambda c: cs.cast_to_decimal(c, T.decimal32(0)),
        "date": cs.cast_to_date,
        "timestamp": cs.cast_to_timestamp,
        "contains": lambda c: rx.regexp_contains(c, r"[0-9]+\.[0-9]"),
        "full_match": lambda c: rx.regexp_full_match(c, r"-?\d+(\.\d*)?"),
    }
    on_card = Column.strings_from_list(strs, device=cuda_device)
    on_cpu = Column.strings_from_list(strs, device="cpu")
    for name, fn in calls.items():
        before = K.LAUNCHES["bitmask_pack"]
        got = fn(on_card)
        assert K.LAUNCHES["bitmask_pack"] == before + 1, name
        want = fn(on_cpu)
        ok = want.valid_bool()
        assert torch.equal(got.valid_bool().cpu(), ok), name
        assert torch.equal(K.as_bytes(got.data.cpu())[ok],
                           K.as_bytes(want.data)[ok]), name


@pytest.mark.cuda
def test_cuda_string_outputs_equal_cpu(cuda_device):
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import cast_strings as cs
    from spark_rapids_jni_tpu_torch.ops import float_to_string as fts
    from spark_rapids_jni_tpu_torch.ops import parse_uri
    strs, ints, f64, f32, valid = _cast_inputs()
    urls = [None if s is None else f"http://u@h{s[:4]}:80/p?k={s}#r"
            for s in strs]
    for dev_col, fn in (
            (lambda d: Column.from_numpy(ints, valid, device=d),
             cs.cast_integer_to_string),
            (lambda d: Column.from_numpy(ints, valid, T.decimal64(-4),
                                         device=d),
             cs.cast_decimal_to_string),
            (lambda d: Column.from_numpy(f64, valid, device=d),
             fts.cast_float_to_string),
            (lambda d: Column.from_numpy(f32, valid, device=d),
             fts.cast_float_to_string),
            (lambda d: Column.strings_from_list(strs, device=d),
             lambda c: cs.conv(c, 16, -10)),
            (lambda d: Column.strings_from_list(urls, device=d),
             lambda c: parse_uri.parse_url(c, "QUERY", "k")),
            (lambda d: Column.strings_from_list(urls, device=d),
             lambda c: parse_uri.parse_url(c, "HOST"))):
        got = fn(dev_col(cuda_device))
        assert got.device.type == cuda_device.type
        assert got.to_pylist() == fn(dev_col("cpu")).to_pylist()


# --------------------------------------------------------------------------
# roster II: copying, conditionals, z-order, percentiles, JSON and maps
# --------------------------------------------------------------------------

def _copy_table(dev, n, seed):
    """INT64, FLOAT32, STRING, DECIMAL128 and STRUCT<INT32, FLOAT64>,
    15% nulls at every node, from seeded host arrays."""
    import numpy as np
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    r = np.random.default_rng(seed)

    def valid():
        return r.random(n) > 0.15
    strs = [None if r.random() < 0.15 else "s" * int(r.integers(0, 9))
            for _ in range(n)]
    dec = [None if r.random() < 0.15 else int(r.integers(-2**62, 2**62))
           * 1000 for _ in range(n)]
    return Table([
        Column.from_numpy(r.integers(-2**62, 2**62, n), valid(), device=dev),
        Column.from_numpy(r.standard_normal(n).astype(np.float32), valid(),
                          device=dev),
        Column.strings_from_list(strs, device=dev),
        Column.decimal128_from_ints(dec, -3, device=dev),
        Column.struct_from_children(
            [Column.from_numpy(r.integers(0, 9, n).astype(np.int32),
                               valid(), device=dev),
             Column.from_numpy(r.standard_normal(n), valid(), device=dev)],
            valid(), ("a", "b"))])


@pytest.mark.cuda
def test_cuda_copying_and_conditionals_equal_cpu(cuda_device):
    # every nullable result's validity goes through K3 on the card, and
    # K3 equals its plain version on those bools
    import numpy as np
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import (
        apply_boolean_mask, case_when, coalesce, concatenate, if_else,
        slice_rows)
    n = 100_003
    r = np.random.default_rng(31)
    bits = r.integers(0, 2, (4, n)).astype(np.int8)
    cvalid = r.random((4, n)) > 0.1
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        t = _copy_table(dev, n, 30)
        conds = [Column.from_numpy(bits[i], cvalid[i], T.BOOL8, device=dev)
                 for i in range(4)]
        ints = t.columns[0]
        K.reset_launch_counts()
        res = {"mask": apply_boolean_mask(t, conds[0]),
               "slice": slice_rows(t, 33, 70_001),
               "concat": concatenate([slice_rows(t, 0, 5000),
                                      slice_rows(t, 60_000, n)]),
               "if_else": if_else(conds[1], ints, t.columns[0]),
               "case_when": case_when(list(zip(conds, [ints] * 4))),
               "coalesce": coalesce([ints, ints])}
        if dev.type == "cuda":
            assert K.LAUNCHES["bitmask_pack"] > 0
            valid = res["case_when"].valid_bool()
            assert torch.equal(K.bitmask_pack(valid),
                               K.bitmask_pack_plain(valid))
        out[dev.type] = {k: ([c.to_pylist() for c in v.columns]
                             if hasattr(v, "columns") else v.to_pylist())
                         for k, v in res.items()}
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_cuda_zorder_equal_cpu(cuda_device):
    import numpy as np
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import zorder
    r = np.random.default_rng(32)
    n = 200_001
    vals = [r.integers(-2**31, 2**31, n).astype(np.int32) for _ in range(4)]
    valid = [r.random(n) > 0.1 for _ in range(4)]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        t = Table([Column.from_numpy(v, ok, device=dev)
                   for v, ok in zip(vals, valid)])
        out[dev.type] = [zorder.interleave_bits(t).child.data,
                         zorder.hilbert_index(Table(t.columns[:3]), 21).data,
                         zorder.hilbert_index(Table(t.columns[:2]), 31).data]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_percentiles_equal_cpu(cuda_device):
    # histograms and exact percentiles bit-equal; digests: the same
    # centroids and weights, means within 1e-9 of the running |x| sum
    # over the weight (the card's cumsum adds in another order)
    import numpy as np
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import histogram as h
    from spark_rapids_jni_tpu_torch.ops import tdigest as td
    r = np.random.default_rng(33)
    n = 300_007
    keys = r.integers(0, 500, n)
    kvalid = r.random(n) > 0.02
    vals = r.integers(-50, 50, n).astype(np.float64)
    vals[::101] = np.nan
    vals[::103] = -0.0
    valid = r.random(n) > 0.1
    cont = r.standard_normal(n) * 100
    pcts = [0.0, 0.25, 0.5, 0.99, 1.0]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        kt = Table([Column.from_numpy(keys, kvalid, device=dev)])
        vc = Column.from_numpy(vals, valid, device=dev)
        cc = Column.from_numpy(cont, valid, device=dev)
        K.reset_launch_counts()
        pct = h.group_percentile(kt, vc, pcts)
        hk, hist = h.group_histogram(kt, vc)
        merged = h.merge_histograms([h.group_histogram(
            Table([Column.from_numpy(keys[a:b], kvalid[a:b], device=dev)]),
            Column.from_numpy(vals[a:b], valid[a:b], device=dev))
            for a, b in ((0, n // 2), (n // 2, n))])
        dk, dig = td.group_tdigest(kt, cc, 100)
        est = td.percentile_approx(dig, pcts)
        if dev.type == "cuda":
            assert K.LAUNCHES["bitmask_pack"] > 0
        out[dev.type] = (pct, hist, merged, dig, est)
    (pct, hist, merged, dig, est), (pct_c, hist_c, merged_c, dig_c,
                                    est_c) = out["cuda"], out["cpu"]
    def bits(x):  # a NaN's payload is the device's; -0.0 stays apart
        return x.cpu().nan_to_num(7.0).view(torch.int64)
    assert pct.columns[0].to_pylist() == pct_c.columns[0].to_pylist()
    for a, b in zip(pct.columns[1:], pct_c.columns[1:]):
        ok = b.valid_bool()
        assert torch.equal(a.valid_bool().cpu(), ok)
        assert torch.equal(bits(a.data)[ok], bits(b.data)[ok])
    for x, y in ((hist, hist_c), (merged[1], merged_c[1])):
        assert torch.equal(x.offsets.data.cpu(), y.offsets.data)
        assert torch.equal(bits(x.child.children[0].data),
                           bits(y.child.children[0].data))
        assert torch.equal(x.child.children[1].data.cpu(),
                           y.child.children[1].data)
    assert torch.equal(merged[1].offsets.data.cpu(), hist_c.offsets.data)
    assert torch.equal(dig.offsets.data.cpu(), dig_c.offsets.data)
    w = dig_c.child.children[1].data
    assert torch.equal(dig.child.children[1].data.cpu(), w)
    bound = 1e-9 * float(np.abs(cont[valid]).sum()) / w
    assert (dig.child.children[0].data.cpu()
            - dig_c.child.children[0].data).abs().le(bound).all()
    for a, b in zip(est.columns, est_c.columns):
        assert torch.equal(a.valid_bool().cpu(), b.valid_bool())


@pytest.mark.cuda
def test_cuda_get_json_object_and_maps_equal_cpu(cuda_device):
    # the output assembled on the card, its validity through K3 (one
    # launch a result with a null row)
    import json
    import random
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import get_json_object, map_utils
    rnd = random.Random(34)
    docs = []
    for i in range(20_000):
        v = {"a": {"b": [rnd.randint(0, 99), {"c": "x" * (i % 7)}]},
             "k": "e\\n" if i % 13 == 0 else "w", "n": None}
        s = json.dumps(v, indent=None if i % 3 else 1)
        docs.append(None if i % 10 == 0 else s[:-2] if i % 29 == 0 else s)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        col = Column.strings_from_list(docs, device=dev)
        K.reset_launch_counts()
        res = [get_json_object(col, p) for p in
               ("$.a", "$.a.b", "$.a.b[1].c", "$['k']", "$.n")]
        m = map_utils.from_json_to_map(col)
        if dev.type == "cuda":
            assert K.LAUNCHES["bitmask_pack"] == 6
            assert all(r.device.type == "cuda" for r in res)
        out[dev.type] = [r.to_pylist() for r in res] + [
            map_utils.map_to_pylist(m),
            map_utils.get_map_value(m, "k").to_pylist()]
    assert out["cuda"] == out["cpu"]


# --------------------------------------------------------------------------
# The mesh over NCCL: one rank on the card (NCCL takes one rank a card)
# --------------------------------------------------------------------------

MESH_QS = [f"q{i}" for i in range(1, 21)]
# (pass, env): the default threshold, then the reference test's (the
# dimensions shard too) with each join route, the scattered merge and
# staged exchanges
MESH_PASSES = [
    ("default", {}),
    ("threshold", {"SRT_BROADCAST_THRESHOLD": "8192"}),
    ("exchange", {"SRT_BROADCAST_THRESHOLD": "8192",
                  "SRT_SHUFFLE_JOIN_ROUTE": "exchange"}),
    ("reduce_scatter", {"SRT_BROADCAST_THRESHOLD": "8192",
                        "SRT_SHUFFLE_JOIN_ROUTE": "reduce_scatter"}),
    ("scattered", {"SRT_GROUPBY_PSUM_WIDTH": "1"}),
    ("staged", {"SRT_BROADCAST_THRESHOLD": "8192",
                "SRT_SHUFFLE_SCRATCH_BYTES": "65536"})]


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    import os
    from spark_rapids_jni_tpu_torch.parallel import distributed, make_mesh
    from spark_rapids_jni_tpu_torch.tpcds import generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    init = tmp_path_factory.mktemp("nccl") / "init"
    distributed.initialize(f"file://{init}", 1, 0, backend="nccl",
                           timeout_s=120)
    mesh = make_mesh({"part": 1}, device_type="cuda")
    data = generate(sf=2, seed=7)
    rels = {n: rel_from_df(df, device="cuda") for n, df in data.items()}
    yield mesh, rels
    distributed.shutdown()


def _frames_equal(got, want, what):
    import numpy as np
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=1e-9,
                atol=1e-9, equal_nan=True, err_msg=f"{what}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{c}")


_MESH_SEEN: dict = {}


@pytest.mark.cuda
@pytest.mark.parametrize("qname", MESH_QS)
@pytest.mark.parametrize("pname,env", MESH_PASSES,
                         ids=[p for p, _ in MESH_PASSES])
def test_cuda_nccl_mesh_equals_one_device(nccl_mesh, pname, env, qname,
                                          monkeypatch):
    from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    from spark_rapids_jni_tpu_torch.tpcds.rel import run_fused
    mesh, rels = nccl_mesh
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = run_fused(PLANS[qname], rels, device="cuda").to_df()
    before = kernel_stats()
    got = run_fused(PLANS[qname], rels, mesh=mesh).to_df()
    st = stats_since(before)
    _frames_equal(got, want, f"{qname} {pname}")
    assert st.get("rel.dist_fallbacks", 0) == 0, st
    assert st.get("rel.host_syncs", 0) <= 1, st
    for k, v in st.items():
        _MESH_SEEN[k] = _MESH_SEEN.get(k, 0) + v


@pytest.mark.cuda
@pytest.mark.parametrize("route", [
    "rel.route.join.presence_psum", "rel.route.join.shuffle_hash",
    "rel.route.join.reduce_scatter", "rel.route.dist.all_gather",
    "rel.route.groupby.two_phase.replicated",
    "rel.route.groupby.two_phase.scattered", "rel.route.window.exchange",
    "rel.route.shuffle.staged", "rel.route.join.probe.cuda"])
def test_cuda_nccl_mesh_takes_every_route(nccl_mesh, route):
    # runs after the parametrized queries above (file order)
    if not _MESH_SEEN:
        pytest.skip("the mesh query cases did not run")
    assert any(k == route or k.startswith(route + ".") for k in _MESH_SEEN)


@pytest.mark.cuda
@pytest.mark.parametrize("strings", [False, True])
def test_cuda_nccl_shuffle_table_keeps_every_row(nccl_mesh, strings):
    # one rank: every row comes back in its order, through retry rounds
    # when the capacity is too small (K4 and K5 hash the keys; K6 packs a
    # fixed-width table, K3's table form unpacks both)
    import numpy as np
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
    from spark_rapids_jni_tpu_torch.parallel import shuffle_table
    mesh, _ = nccl_mesh
    rng = np.random.default_rng(4)
    n = 50_000
    cols = [Column.from_numpy(rng.integers(-9, 9, n).astype(np.int32),
                              device="cuda"),
            Column.from_numpy(rng.integers(-2**60, 2**60, n),
                              rng.random(n) > 0.1, device="cuda"),
            Column.from_numpy(rng.standard_normal(n), device="cuda")]
    if strings:
        cols.append(Column.strings_from_list(
            [None if i % 9 == 0 else "s" * (i % 23) for i in range(n)],
            device="cuda"))
    table = Table(cols)
    for capacity in (None, 1000):
        K.reset_launch_counts()
        before = kernel_stats()
        got, over = shuffle_table(mesh, table, [0, 1], capacity=capacity)
        st = stats_since(before)
        assert K.LAUNCHES["murmur3_int32"] and K.LAUNCHES["murmur3_int64"]
        # a fixed-width table goes back through K7, a STRING one through
        # slot copies and K3's table form
        assert bool(K.LAUNCHES["bitmask_pack_fields"]) == strings
        assert bool(K.LAUNCHES["unpack_rows"]) == (not strings)
        assert bool(K.LAUNCHES["pack_rows"]) == (not strings)
        if capacity is None:
            assert int(over.sum()) == 0
        else:
            assert st.get("shuffle.retry_rounds", 0) >= 1
        for a, b in zip(got.columns, table.columns):
            assert a.to_pylist() == b.to_pylist()


# --------------------------------------------------------------------------
# The morsel pump on the card: pinned, double-buffered staging
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def morsel_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pump stages through pinned "
                    "memory and a copy stream on the card")
    from spark_rapids_jni_tpu_torch.exec import HostTable
    from spark_rapids_jni_tpu_torch.tpcds import generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df
    data = generate(sf=2, seed=7)
    rels = {n: rel_from_df(df, device="cuda") for n, df in data.items()}
    host = dict(rels)
    for f in ("store_sales", "web_sales", "catalog_sales", "store_returns"):
        host[f] = HostTable.from_df(data[f])
    return rels, host


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["268435456", "0"], ids=["paged", "whole"])
@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 11)])
def test_cuda_morsel_pump_equals_incore(morsel_tables, qname, pool,
                                        monkeypatch):
    from spark_rapids_jni_tpu_torch.exec import reset_standing_state
    from spark_rapids_jni_tpu_torch.exec.runner import run_morsels
    from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    from spark_rapids_jni_tpu_torch.tpcds.rel import run_fused
    rels, host = morsel_tables
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", pool)
    reset_standing_state()
    want = run_fused(PLANS[qname], rels).to_df()
    K.reset_launch_counts()
    before = kernel_stats()
    info = {}
    got = run_morsels(PLANS[qname], host, info, morsels=5).to_df()
    st = stats_since(before)
    _frames_equal(got, want, f"{qname} streamed ({pool})")
    assert st.get("rel.morsel_fallbacks", 0) == 0, st
    assert st.get("rel.host_syncs", 0) <= 1, st
    assert info["morsel"]["paged"] == (pool != "0")
    assert st.get("exec.morsel.folded", 0) >= 5
    if qname == "q6":  # its groupby folds through K2 every morsel
        assert K.LAUNCHES["ragged_groupby_sum_count"] >= 5
    # the planner sends a chunk's probe to K1 by its sizes, as in-core
    assert (K.LAUNCHES["hash_join_probe"] > 0) == (
        st.get("rel.route.join.probe.cuda", 0) > 0)


@pytest.mark.cuda
def test_cuda_staging_pinned_and_no_stale_rows(morsel_tables):
    import numpy as np
    from spark_rapids_jni_tpu_torch.exec.runner import _Staging
    dev = torch.device("cuda")
    layout = (("t", "a", np.dtype(np.int64).str, 1000),
              ("t", "b", np.dtype(np.float32).str, 1000))
    st = _Staging(layout, dev)
    assert all(h.is_pinned() for h in st.host)
    a = np.arange(1000, dtype=np.int64) + 7
    b = np.linspace(0, 1, 1000, dtype=np.float32)
    st.fill(0, [a, b], None)
    st.acquire(0)
    assert torch.equal(st.views[0][0].cpu(), torch.from_numpy(a))
    st.release(0)
    # a paged refill of 100 live rows (pages of 256 rows): the live
    # pages copy, the rows past them that the slot held are zeroed
    st.fill(0, [a[:100], b[:100]], [256, 256])
    st.acquire(0)
    got = st.views[0][0].cpu().numpy()
    assert (got[:100] == a[:100]).all() and (got[100:] == 0).all()
    assert (st.views[0][1].cpu().numpy()[100:] == 0).all()
    st.release(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_morsel_budget_from_free_memory(morsel_tables, monkeypatch):
    from spark_rapids_jni_tpu_torch.exec import (morsel_bytes_budget,
                                                 reset_morsel_budget_probe)
    monkeypatch.delenv("SRT_MORSEL_BYTES", raising=False)
    reset_morsel_budget_probe()
    try:
        free, _ = torch.cuda.mem_get_info()
        free += torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
        budget = morsel_bytes_budget(torch.device("cuda"))
        assert budget & (budget - 1) == 0
        assert budget <= free * 0.125 < 2 * budget * 1.05
    finally:
        reset_morsel_budget_probe()


@pytest.mark.cuda
def test_cuda_morsel_pump_adds_no_sync(morsel_tables):
    import warnings
    from spark_rapids_jni_tpu_torch.exec.runner import run_morsels
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    from spark_rapids_jni_tpu_torch.tpcds.rel import run_fused
    rels, host = morsel_tables

    def syncs(fn):
        fn()  # warm
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # (the mode's own notice, "Synchronization debug mode is a
        # prototype feature", is not a synchronising call)
        return sum("called a synchronizing" in str(w.message)
                   for w in caught)

    streamed = syncs(lambda: run_morsels(PLANS["q3"], host, morsels=8))
    incore = syncs(lambda: run_fused(PLANS["q3"], rels))
    assert streamed <= incore, (streamed, incore)


# --------------------------------------------------------------------------
# The serving path on the card: QueryExecutor, reports, result cache
# --------------------------------------------------------------------------

def _served_frames_equal(got, want, what):
    import numpy as np
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=1e-9,
                                       atol=1e-9, equal_nan=True,
                                       err_msg=f"{what}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{c}")


@pytest.mark.cuda
def test_cuda_executor_serves_q1_q20_with_reports(cuda_device, monkeypatch):
    from spark_rapids_jni_tpu_torch import obs
    from spark_rapids_jni_tpu_torch.serving import QueryExecutor
    from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES, generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df
    monkeypatch.setenv("SRT_METRICS", "1")
    monkeypatch.setenv("SRT_JOIN_METHOD", "cuda")
    monkeypatch.setenv("SRT_DENSE_GROUPBY", "cuda")
    data = generate(sf=2, seed=7)
    rels = {n: rel_from_df(df, device=cuda_device) for n, df in data.items()}
    before = dict(K.LAUNCHES)
    with QueryExecutor(device=cuda_device, max_queue=8,
                       max_in_flight=20) as ex:
        pend = {q: ex.submit(PLANS[q], rels) for q in QUERIES}
        for q, p in pend.items():
            _served_frames_equal(p.to_df(timeout=300), QUERIES[q][1](data),
                                 q)
    reports = {r.qid: r for r in obs.recent_reports()}
    for q, p in pend.items():
        rep = reports[p.qid]
        assert rep.query == q and rep.host_syncs <= 1
        assert rep.memory["devices"]["0"]["bytes_limit"] > 0
    for name in ("hash_join_probe", "ragged_groupby_sum_count",
                 "bitmask_pack"):
        assert K.LAUNCHES[name] > before.get(name, 0), name


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["0", str(1 << 28)], ids=["whole", "paged"])
def test_cuda_result_cache_hit_launches_nothing(cuda_device, monkeypatch,
                                                pool):
    from spark_rapids_jni_tpu_torch import obs
    from spark_rapids_jni_tpu_torch.serving import result_cache
    from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES, generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", str(1 << 30))
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", pool)
    monkeypatch.setenv("SRT_JOIN_METHOD", "cuda")
    monkeypatch.setenv("SRT_DENSE_GROUPBY", "cuda")
    result_cache.reset()
    try:
        data = generate(sf=2, seed=7)
        rels = {n: rel_from_df(df, device=cuda_device)
                for n, df in data.items()}
        for q in ("q1", "q5", "q6"):
            run_fused(PLANS[q], rels, device=cuda_device)
            torch.cuda.synchronize()
            launches, st = dict(K.LAUNCHES), obs.kernel_stats()
            got = run_fused(PLANS[q], rels, device=cuda_device)
            assert dict(K.LAUNCHES) == launches, q
            d = obs.stats_since(st)
            assert d.get("serving.result_cache.hits") == 1, d
            assert d.get("rel.host_syncs", 0) == 0, d
            _served_frames_equal(got.to_df(), QUERIES[q][1](data), q)
    finally:
        result_cache.reset()


@pytest.mark.cuda
def test_cuda_result_cache_keys_apart_across_devices(cuda_device,
                                                     monkeypatch):
    """The same content filled on the CPU misses on the card, and the
    other way round: each run's result lies on its own device."""
    from spark_rapids_jni_tpu_torch import obs
    from spark_rapids_jni_tpu_torch.serving import result_cache
    from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES, generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", str(1 << 30))
    result_cache.reset()
    try:
        data = generate(sf=2, seed=7)
        for first, second in (("cpu", cuda_device), (cuda_device, "cpu")):
            result_cache.reset()
            for dev in (first, second):
                rels = {n: rel_from_df(df, device=dev)
                        for n, df in data.items()}
                st = obs.kernel_stats()
                got = run_fused(PLANS["q3"], rels, device=dev)
                d = obs.stats_since(st)
                assert d.get("serving.result_cache.misses") == 1, (dev, d)
                assert d.get("serving.result_cache.hits", 0) == 0, (dev, d)
                assert all(c.device.type == torch.device(dev).type
                           for c in got.table.columns), dev
                _served_frames_equal(got.to_df(), QUERIES["q3"][1](data),
                                     f"q3 on {dev}")
            st = obs.kernel_stats()
            run_fused(PLANS["q3"], rels, device=second)
            assert obs.stats_since(st).get("serving.result_cache.hits") == 1
    finally:
        result_cache.reset()


@pytest.mark.cuda
def test_cuda_memory_gauges_and_probe(cuda_device):
    from spark_rapids_jni_tpu_torch.obs import memory
    from spark_rapids_jni_tpu_torch.parallel import comm_plan
    x = torch.empty(1 << 20, dtype=torch.uint8, device=cuda_device)
    stats = memory.sample_device_memory()
    assert stats[0]["bytes_in_use"] >= x.numel()
    assert stats[0]["peak_bytes_in_use"] >= stats[0]["bytes_in_use"]
    assert stats[0]["bytes_limit"] == \
        torch.cuda.get_device_properties(0).total_memory
    budget = memory.probed_scratch_budget(cuda_device)
    assert budget >= comm_plan.MIN_SCRATCH_BYTES
    assert budget & (budget - 1) == 0
    assert 0.0 < memory.device_used_fraction() < 1.0


# --------------------------------------------------------------------------
# The native bridge's CUDA engine (native.py, csrc/native/)
# --------------------------------------------------------------------------

def _native_cols(n, seed=5):
    import numpy as np
    from spark_rapids_jni_tpu_torch import types as T
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal(n).astype(np.float32)
    f64 = rng.standard_normal(n)
    f32[:4] = [0.0, -0.0, np.nan, -np.inf]
    f64[:4] = [-0.0, np.nan, np.inf, 0.0]
    return [(T.INT32, rng.integers(-2**31, 2**31, n).astype(np.int32)),
            (T.INT64, rng.integers(-2**62, 2**62, n)),
            (T.decimal64(-2), rng.integers(-10**15, 10**15, n)),
            (T.FLOAT32, f32), (T.FLOAT64, f64)]


@pytest.mark.cuda
def test_cuda_native_routes_equal_the_port_on_the_cpu(cuda_device):
    """Each device route of the native library, as a host table and
    resident, with sentinel 1, against the port's own CPU ops (hashes,
    rows) and numpy (sort, join, groupby) on the same seeded data."""
    import numpy as np
    from spark_rapids_jni_tpu_torch import native
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import hashing
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    native.load()
    assert native.cuda_available()
    n = 100_003
    cols = _native_cols(n)
    cpu = Table([Column.from_numpy(v, None, dt, device="cpu")
                 for dt, v in cols])
    t = native.NativeTable([(dt, v, None) for dt, v in cols])
    d = t.to_device()
    native.reset_kernel_launches()
    m3 = hashing.murmur3_table(cpu).numpy()
    assert (native.murmur3_table(t) == m3).all()
    assert native.kernel_was_device("murmur3") == 1
    with d.murmur3() as b:
        assert (b.fetch(np.int32) == m3).all()
    launches = native.kernel_launches()
    assert launches["murmur3_int32"] == 4 and launches["murmur3_int64"] == 6
    xx = hashing.xxhash64_table(cpu).numpy()
    assert (native.xxhash64_table(t) == xx).all()
    with d.xxhash64() as b:
        assert (b.fetch(np.int64) == xx).all()
    want_rows = rc.convert_to_rows(cpu)[0].child.data.numpy().view(np.uint8)
    rows = native.convert_to_rows(t)
    assert native.kernel_was_device("to_rows") == 1
    assert (rows[0].reshape(-1) == want_rows).all()
    with d.to_rows() as b:
        assert (b.fetch(np.uint8) == want_rows).all()
        for (dt, v), (data, words) in zip(cols, b.from_rows(n, [
                dt for dt, _ in cols])):
            assert (data.fetch(v.dtype).view(np.uint8) == v.view(np.uint8)
                    ).all()
            assert (words.fetch(np.uint32)[:-1] == 0xFFFFFFFF).all()
            data.free()
            words.free()
    back = native.convert_from_rows(rows[0], [dt for dt, _ in cols])
    assert native.kernel_was_device("from_rows") == 1
    for (v, ok), (_, want) in zip(back, cols):
        assert ok.all() and (v.view(np.uint8) == want.view(np.uint8)).all()
    # sort: a 32-bit key descending, then a 64-bit one ascending
    rng = np.random.default_rng(9)
    k1 = rng.integers(-40, 40, n).astype(np.int32)
    k2 = rng.integers(-2**62, 2**62, n)
    want = np.lexsort((k2, -k1.astype(np.int64)))
    k = native.NativeTable([(T.INT32, k1, None), (T.INT64, k2, None)])
    assert (native.sort_order(k, [False, True]) == want).all()
    assert native.kernel_was_device("sort_order") == 1
    # join under the unique-right contract: pairs by key, then left row
    right = rng.permutation(50_000)[:20_000].astype(np.int64) - 25_000
    left = rng.integers(-25_000, 25_000, n)
    pos = {int(v): i for i, v in enumerate(right)}
    li = np.array([i for i in np.lexsort((np.arange(n), left))
                   if int(left[i]) in pos], np.int32)
    ri = np.array([pos[int(left[i])] for i in li], np.int32)
    lt = native.NativeTable([(T.INT64, left, None)])
    rt = native.NativeTable([(T.INT64, right, None)])
    dl, dr = lt.to_device(), rt.to_device()
    for got in (native.inner_join(lt, rt), dl.inner_join(dr)):
        assert native.kernel_was_device("inner_join") == 1
        assert (got[0] == li).all() and (got[1] == ri).all()
    dl.free()
    dr.free()
    # groupby: groups by first row, int64 sums wrap, float sums in order
    g = rng.integers(0, 997, n).astype(np.int32)
    vi = rng.integers(-2**62, 2**62, n)
    vf = rng.standard_normal(n)
    kt = native.NativeTable([(T.INT32, g, None)])
    vt = native.NativeTable([(T.INT64, vi, None), (T.FLOAT64, vf, None)])
    res = native.groupby_sum_count(kt, vt)
    assert native.kernel_was_device("groupby") == 1
    _, first, inv = np.unique(g, return_index=True, return_inverse=True)
    order = np.argsort(first)
    isum = np.zeros(len(first), np.int64)
    fsum = np.zeros(len(first), np.float64)
    np.add.at(isum, inv, vi)
    np.add.at(fsum, inv, vf)
    assert (res["rep_rows"] == first[order]).all()
    assert (res["sizes"] == np.bincount(inv)[order]).all()
    assert (res["sums"][0] == isum[order]).all()
    np.testing.assert_allclose(res["sums"][1], fsum[order], rtol=1e-12)
    for x in (t, k, lt, rt, kt, vt):
        x.close()
    d.free()
    assert native.live_handles() == 0 and native.live_device_handles() == 0


@pytest.mark.cuda
def test_cuda_native_wide_and_unsigned_shapes(cuda_device):
    """The engine's less common shapes against the port's CPU ops and
    numpy: 40 columns (two launches of the multi-column hash and unpack
    kernels), mixed widths through K6, a row count off a 32-row word,
    unsigned keys in the sort, a two-column join and a two-key groupby."""
    import numpy as np
    from spark_rapids_jni_tpu_torch import native
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import hashing
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    native.load()
    U32, U64 = T.DType(T.TypeId.UINT32), T.DType(T.TypeId.UINT64)
    rng = np.random.default_rng(21)
    n = 1000
    types = [T.INT8, T.INT16, T.BOOL8, T.INT32, T.FLOAT32, T.INT64,
             T.FLOAT64, T.decimal32(-3), U32, U64] * 4

    def values(dt, m):
        if dt.id == T.TypeId.BOOL8:
            return rng.integers(0, 2, m, dtype=np.int8)
        if dt.is_floating:
            return rng.standard_normal(m).astype(dt.storage_dtype)
        info = np.iinfo(dt.storage_dtype)
        return rng.integers(info.min, info.max, m, dtype=dt.storage_dtype,
                            endpoint=True)

    cols = [(dt, values(dt, n)) for dt in types]
    cpu = Table([Column.from_numpy(v, None, dt, device="cpu")
                 for dt, v in cols])
    t = native.NativeTable([(dt, v, None) for dt, v in cols])
    want_rows = rc.convert_to_rows(cpu)[0].child.data.numpy().view(np.uint8)
    rows = native.convert_to_rows(t)
    assert native.kernel_was_device("to_rows") == 1
    assert (rows[0].reshape(-1) == want_rows).all()
    for (v, ok), (_, want) in zip(native.convert_from_rows(rows[0], types),
                                  cols):
        assert native.kernel_was_device("from_rows") == 1
        assert ok.all() and (v.view(np.uint8) == want.view(np.uint8)).all()
    d = t.to_device()
    with d.to_rows() as b:
        assert (b.fetch(np.uint8) == want_rows).all()
        for (dt, v), (data, words) in zip(cols, b.from_rows(n, types)):
            assert (data.fetch(v.dtype).view(np.uint8) == v.view(np.uint8)
                    ).all()
            w = words.fetch(np.uint32)
            assert (w[:-1] == 0xFFFFFFFF).all() and w[-1] == 0xFF
            data.free()
            words.free()
    d.free()
    # the hashes over the types the device hashes (no 1- or 2-byte types,
    # no DECIMAL32): 40 columns, two xxhash64 launches
    hashed = [(dt, v) for dt, v in cols if dt.id in (
        T.TypeId.INT32, T.TypeId.FLOAT32, T.TypeId.INT64, T.TypeId.FLOAT64,
        T.TypeId.UINT32, T.TypeId.UINT64)] * 2
    hcpu = Table([Column.from_numpy(v, None, dt, device="cpu")
                  for dt, v in hashed])
    h = native.NativeTable([(dt, v, None) for dt, v in hashed])
    assert len(hashed) > 32
    assert (native.xxhash64_table(h) == hashing.xxhash64_table(hcpu).numpy()
            ).all()
    assert native.kernel_was_device("xxhash64") == 1
    assert (native.murmur3_table(h) == hashing.murmur3_table(hcpu).numpy()
            ).all()
    assert native.kernel_was_device("murmur3") == 1
    # sort: a uint64 key descending, then an int32 key ascending
    m = 50_003
    u = rng.integers(0, 6, m).astype(np.uint64) << np.uint64(62)
    i = rng.integers(-3, 3, m).astype(np.int32)
    s = native.NativeTable([(U64, u, None), (T.INT32, i, None)])
    assert (native.sort_order(s, [False, True]) == np.lexsort((i, ~u))).all()
    assert native.kernel_was_device("sort_order") == 1
    # join on (uint32, int64), unique right: pairs by key, then left row
    ru = rng.integers(0, 2**32, 4000, dtype=np.uint32)
    ri64 = rng.integers(-5, 5, 4000)
    keys, first = np.unique(np.stack([ru.astype(np.int64), ri64], 1),
                            axis=0, return_index=True)
    ru, ri64 = ru[np.sort(first)], ri64[np.sort(first)]
    pick = rng.integers(0, len(ru), m)
    lu = np.where(rng.random(m) < 0.7, ru[pick], rng.integers(
        0, 2**32, m, dtype=np.uint32)).astype(np.uint32)
    li64 = ri64[pick]
    pos = {(int(a), int(b)): k for k, (a, b) in enumerate(zip(ru, ri64))}
    order = np.lexsort((np.arange(m), li64, lu))
    want_l = np.array([k for k in order if (int(lu[k]), int(li64[k])) in pos],
                      np.int32)
    want_r = np.array([pos[(int(lu[k]), int(li64[k]))] for k in want_l],
                      np.int32)
    lt = native.NativeTable([(U32, lu, None), (T.INT64, li64, None)])
    rt = native.NativeTable([(U32, ru, None), (T.INT64, ri64, None)])
    gl, gr = native.inner_join(lt, rt)
    assert native.kernel_was_device("inner_join") == 1
    assert (gl == want_l).all() and (gr == want_r).all()
    # groupby on (uint64, int32) keys: int32 and float32 values
    vi = rng.integers(-2**31, 2**31, m).astype(np.int32)
    vf = rng.standard_normal(m).astype(np.float32)
    kt = native.NativeTable([(U64, u, None), (T.INT32, i, None)])
    vt = native.NativeTable([(T.INT32, vi, None), (T.FLOAT32, vf, None)])
    res = native.groupby_sum_count(kt, vt)
    assert native.kernel_was_device("groupby") == 1
    _, first, inv = np.unique(np.stack([u.view(np.int64),
                                        i.astype(np.int64)], 1), axis=0,
                              return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(first)
    isum = np.zeros(len(first), np.int64)
    fsum = np.zeros(len(first), np.float64)
    np.add.at(isum, inv, vi.astype(np.int64))
    np.add.at(fsum, inv, vf.astype(np.float64))
    imin = np.full(len(first), 2**31, np.int64)
    np.minimum.at(imin, inv, vi.astype(np.int64))
    assert (res["rep_rows"] == first[order]).all()
    assert (res["sums"][0] == isum[order]).all()
    assert (res["mins"][0] == imin[order]).all()
    assert (res["sums"][1] == fsum[order]).all()  # each group's rows in order
    for x in (t, h, s, lt, rt, kt, vt):
        x.close()
    assert native.live_handles() == 0 and native.live_device_handles() == 0
