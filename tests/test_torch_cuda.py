"""K1-K3 on the card: each hand-written CUDA kernel of the PyTorch/CUDA
port against its plain PyTorch version on the same CUDA tensors.

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
