"""The CUDA kernels against their plain versions on the card, at edge
shapes the main path of chip_smoke.py does not reach: every d and word
count, k at each kernel template's edges and above the valid rows, ties,
tables too large for shared memory, ragged tiles.  Also one engine
history on CUDA against the same history on the CPU, which must agree bit
for bit (both read the same Cham table).

These tests need a CUDA device and nvcc; they are marked `cuda` and skip
elsewhere.  On a machine with a card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from repro_torch.core.cabin import CabinParams
from repro_torch.index import QueryEngine
from repro_torch.kernels import build
from repro_torch.kernels.cabin_build_sparse import ops as sparse_ops
from repro_torch.kernels.hamming import ops as hamming_ops
from repro_torch.kernels.topk_select import ops as topk_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _words(rng, n, w, dev):
    x = rng.integers(-(2**31), 2**31, size=(n, w)).astype(np.int32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("d", [1, 31, 200, 4096, 100_003,
                               sparse_ops.MAX_D])
def test_cabin_build_sparse_every_d(dev, d):
    rng = np.random.default_rng(d % 1000)
    idx = rng.integers(-5, 2**31 - 1, size=(9, 300)).astype(np.int32)
    val = rng.integers(-3, 50, size=(9, 300)).astype(np.int32)
    val[:, 250:] = 0
    i, v = torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)
    kw = dict(d=d, psi_seed=0x7FFFFFFF, pi_seed=12345)
    got = sparse_ops.cabin_build_sparse(i, v, **kw)
    assert torch.equal(got, sparse_ops.cabin_build_sparse_ref(i, v, **kw))
    if d == sparse_ops.MAX_D:
        with pytest.raises(ValueError):
            sparse_ops.cabin_build_sparse(i, v, d=d + 1, psi_seed=0,
                                          pi_seed=0)


@pytest.mark.parametrize("m,w", [(1, 1), (7, 33), (1000, 128), (3, 2000)])
def test_row_popcount(dev, m, w):
    x = _words(np.random.default_rng(m), m, w, dev)
    assert torch.equal(hamming_ops.row_popcount(x),
                       hamming_ops.row_popcount_ref(x))


@pytest.mark.parametrize("m,n,w", [(1, 1, 1), (65, 130, 33), (64, 64, 128),
                                   (3, 200, 1000)])
def test_pair_stats(dev, m, n, w):
    rng = np.random.default_rng(m + n)
    a, b = _words(rng, m, w, dev), _words(rng, n, w, dev)
    for op_inner, op_ham in ((True, True), (True, False), (False, True)):
        got = hamming_ops.pair_stats(a, b, op_inner=op_inner, op_ham=op_ham)
        want = hamming_ops.pair_stats_ref(a, b, op_inner=op_inner,
                                          op_ham=op_ham)
        for g, r in zip(got, want):
            assert (g is None and r is None) or torch.equal(g, r)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("k", [1, 16, 17, 64, 65, 256])
@pytest.mark.parametrize("w", [1, 5, 128, 2000])
def test_topk_select_edges(dev, metric, k, w):
    rng = np.random.default_rng(k * 10 + w)
    q = _words(rng, 5, w, dev)
    b = _words(rng, 600, w, dev)
    b[300:400] = b[100:200]  # equal distances: the lower column must win
    for m in (600, 300, k - 1 if k > 1 else 0):  # k > m: (+inf, -1) fill
        gv, gi = topk_ops.topk_select(q, b, k, d=32 * w - 7, metric=metric,
                                      m_valid=m)
        wv, wi = topk_ops.topk_select_ref(q, b, k, d=32 * w - 7,
                                          metric=metric, m_valid=m)
        assert torch.equal(gi, wi), (m, k)
        assert torch.equal(gv, wv), (m, k)


def test_topk_select_cap(dev):
    q = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="cap"):
        topk_ops.topk_select(q, q, topk_ops.MAX_K + 1, d=128)


def test_each_wrapper_counts_one_launch_per_call(dev):
    x = _words(np.random.default_rng(0), 8, 4, dev)
    before = dict(build.LAUNCHES)
    sparse_ops.cabin_build_sparse(x, x, d=64, psi_seed=1, pi_seed=2)
    hamming_ops.pair_stats(x, x)
    hamming_ops.row_popcount(x)
    topk_ops.topk_select(x, x, 3, d=128)
    for name in before:
        assert build.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_engine_on_cuda_equals_engine_on_cpu(dev, metric):
    rng = np.random.default_rng(1)
    params = CabinParams.create(5000, 300, seed=3)
    engines = [QueryEngine(params, metric=metric, band_rows=64, device=d)
               for d in ("cpu", dev)]

    def coo(n):
        idx = rng.integers(0, 5000, size=(n, 40)).astype(np.int32)
        val = rng.integers(0, 6, size=(n, 40)).astype(np.int32)
        return idx, val

    queries = coo(9)
    for step in range(4):
        batch = coo(400)
        ids = [e.add_sparse(*batch) for e in engines]
        assert np.array_equal(*ids)
        if step == 1:
            kill = rng.choice(engines[0].ids(), 60, replace=False)
            for e in engines:
                e.remove(kill)
        if step == 2:
            for e in engines:
                e.compact()
        (ci, cv), (gi, gv) = [e.topk(queries, 7) for e in engines]
        assert np.array_equal(ci, gi) and np.array_equal(cv, gv)
        r = float(np.median(cv[:, -1]))
        for a, b in zip(*[e.radius(queries, r) for e in engines]):
            assert np.array_equal(a, b)
        (ca, cd), (ga, gd) = [e.pairwise(queries) for e in engines]
        assert np.array_equal(ca, ga) and np.array_equal(cd, gd)
