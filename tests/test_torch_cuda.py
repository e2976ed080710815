"""The CUDA kernels against their plain versions on the card, at edge
shapes the main path of chip_smoke.py does not reach: every d and word
count, k at each kernel template's edges and above the valid rows, ties,
tables too large for shared memory, ragged tiles; for flash attention
S = 1 and S around the 64-row tile, Skv != S, GQA groups 1 to 8, head
dims 16 to 256 and Dh_v != Dh, in bfloat16 and float32 (within the
stated tolerance, `repro_torch.kernels.flash_attention.ref.tolerance`).  Also one index engine history and
one LM generation on CUDA against the same on the CPU: the index answers
agree bit for bit (both read the same Cham table), the LM's greedy tokens
are equal and its float32 logits agree to 1e-4 (summation order), or to
1e-3 with an int8 KV cache: quantisation is discontinuous, so a K/V value
within float32 noise of a rounding step lands one int8 level (1/127 of
its row's largest |value|) apart on the two devices (measured on an H100:
1.2e-4 on 1 of 9,216 logits).

These tests need a CUDA device and nvcc; they are marked `cuda` and skip
elsewhere.  On a machine with a card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ParallelConfig, reduced_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.core import allpairs
from repro_torch.core.cabin import CabinParams, sketch_sparse
from repro_torch.index import QueryEngine
from repro_torch.kernels import build
from repro_torch.kernels.cabin_build import ops as dense_ops
from repro_torch.kernels.cabin_build_sparse import ops as sparse_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine
from repro_torch.kernels.hamming import ops as hamming_ops
from repro_torch.kernels.topk_select import ops as topk_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _words(rng, n, w, dev):
    x = rng.integers(-(2**31), 2**31, size=(n, w)).astype(np.int32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("d", [1, 31, 200, 4096, 100_003,
                               sparse_ops.MAX_D, sparse_ops.MAX_D + 1,
                               2_000_001])
def test_cabin_build_sparse_every_d(dev, d):
    rng = np.random.default_rng(d % 1000)
    idx = rng.integers(-5, 2**31 - 1, size=(9, 300)).astype(np.int32)
    val = rng.integers(-3, 50, size=(9, 300)).astype(np.int32)
    val[:, 250:] = 0
    i, v = torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)
    kw = dict(d=d, psi_seed=0x7FFFFFFF, pi_seed=12345)
    got = sparse_ops.cabin_build_sparse(i, v, **kw)
    assert torch.equal(got, sparse_ops.cabin_build_sparse_ref(i, v, **kw))


def _coo_rows(rng, n, m, dev, offset=0):
    """(n, m) padded-COO rows: indices anywhere in int32, categories up to
    2**31 - 1 and negative, about a third of each row's tail padded, every
    fifth row all padding.  `offset` int32s in front of the data move its
    start off 16 bytes."""
    idx = rng.integers(-(2**31), 2**31, size=(n, m)).astype(np.int32)
    val = rng.integers(-3, 2**31, size=(n, m)).astype(np.int32)
    val[:, m - m // 3:] = 0
    val[::5] = 0
    val[rng.random((n, m)) < 0.1] = 0

    def place(x):
        flat = torch.zeros(offset + x.size, dtype=torch.int32, device=dev)
        flat[offset:] = torch.from_numpy(x.ravel()).to(dev)
        return flat[offset:].view(n, m)

    return place(idx), place(val)


# rows of several waves of the kernel's row groups at each d: one warp a
# row at d <= 232,448 (about 3,200 resident on an H100), one block of 256
# threads a row at MAX_D and above (hundreds)
CABIN_MANY = {1: 20000, 4096: 20000, sparse_ops.MAX_D: 400,
              sparse_ops.MAX_D + 1: 1700}


@pytest.mark.parametrize("shape", ["1x1", "13x297", "37x298", "9x296",
                                   "9x296+1", "3x5000", "many"])
@pytest.mark.parametrize("d", sorted(CABIN_MANY))
def test_cabin_build_sparse_rows_and_widths(dev, d, shape):
    """Row counts that are not a multiple of the rows a block sketches,
    m odd, m = 1, m wider than one chunk of slots, all-zero rows, inputs
    that start off 16 bytes ("+1"), and rows of several waves; each d on
    either side of the kernel's paths.  The plain version runs in row
    blocks (it holds (rows, d) int64)."""
    rows, m = ((CABIN_MANY[d], 298) if shape == "many"
               else map(int, shape.split("+")[0].split("x")))
    offset = 1 if shape.endswith("+1") else 0
    rng = np.random.default_rng(d % 997 + rows + m)
    i, v = _coo_rows(rng, rows, m, dev, offset)
    kw = dict(d=d, psi_seed=0x7FFFFFFF, pi_seed=12345)
    got = sparse_ops.cabin_build_sparse(i, v, **kw)
    step = max(1, (1 << 27) // (8 * d))
    for r0 in range(0, rows, step):
        want = sparse_ops.cabin_build_sparse_ref(i[r0:r0 + step],
                                                 v[r0:r0 + step], **kw)
        assert torch.equal(got[r0:r0 + step], want), r0
    assert not got[::5].any()  # all-padding rows sketch to zero


@pytest.mark.parametrize("m,w", [(1, 1), (7, 33), (1000, 128), (3, 2000)])
def test_row_popcount(dev, m, w):
    x = _words(np.random.default_rng(m), m, w, dev)
    assert torch.equal(hamming_ops.row_popcount(x),
                       hamming_ops.row_popcount_ref(x))


@pytest.mark.parametrize("w", [1, 3, 33, 128, 2000])
@pytest.mark.parametrize("n", [1, 127, 4097])
@pytest.mark.parametrize("m", [1, 7, 64, 65, 256])
def test_pair_stats(dev, m, n, w):
    """Rows of a on either side of the 64-row tile, rows of b around the
    256-row tile, words around the 16-word step and not a multiple of 4,
    every output switch."""
    rng = np.random.default_rng(m * 10007 + n * 31 + w)
    a, b = _words(rng, m, w, dev), _words(rng, n, w, dev)
    for op_inner, op_ham in ((True, True), (True, False), (False, True)):
        got = hamming_ops.pair_stats(a, b, op_inner=op_inner, op_ham=op_ham)
        want = hamming_ops.pair_stats_ref(a, b, op_inner=op_inner,
                                          op_ham=op_ham)
        for g, r in zip(got, want):
            assert (g is None and r is None) or torch.equal(g, r)


def test_pair_stats_unaligned_rows(dev):
    """Rows that start off 16 bytes take the 4-byte copies."""
    rng = np.random.default_rng(11)
    flat = _words(rng, 1, 70 * 64 + 1, dev)[0]
    a = flat[1:1 + 6 * 64].view(6, 64)
    b = flat[1 + 6 * 64:].view(64, 64)
    got = hamming_ops.pair_stats(a, b)
    want = hamming_ops.pair_stats_ref(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_threshold_pairs_on_cuda_equals_the_cpu(dev, metric, symmetric):
    """The radius scan's tile batches on the pair-stats kernel, against the
    same scan over the plain versions on the CPU: the same pairs in the
    same order."""
    rng = np.random.default_rng(4)
    params = CabinParams.create(5000, 300, seed=3)
    idx = rng.integers(0, 5000, size=(700, 40)).astype(np.int32)
    val = rng.integers(0, 6, size=(700, 40)).astype(np.int32)
    sk = sketch_sparse(params, torch.from_numpy(idx), torch.from_numpy(val))
    a, b = sk[:300], (None if symmetric else sk[300:])
    # halfway between two distinct distances a tenth of the way up
    vals = np.unique(hamming_ops.dist_matrix(a, sk, 300, metric=metric))
    cut = len(vals) // 10
    kw = dict(d=300, threshold=float((vals[cut] + vals[cut + 1]) / 2),
              metric=metric, block=64)
    if not symmetric:
        kw.update(n_valid=290, m_valid=377)
    want = allpairs.threshold_pairs(a, b, **kw)
    got = allpairs.threshold_pairs(a.to(dev), None if b is None else
                                   b.to(dev), **kw)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("k", [1, 10, 16, 17, 64, 65, 256, 257, 1000, 1024,
                               1025])
@pytest.mark.parametrize("nq", [1, 5, 65, 300])
@pytest.mark.parametrize("w", [1, 5, 128, 2000])
def test_topk_select_edges(dev, metric, k, nq, w):
    """Every select shape (k at each CAP edge, and past one pass), query
    tiles ragged or many, one word to a Cham table too large for shared
    memory; ties across tiles and splits; fewer rows than k."""
    rng = np.random.default_rng(k * 10 + w + nq)
    q = _words(rng, nq, w, dev)
    b = _words(rng, 600, w, dev)
    b[300:400] = b[100:200]  # equal distances: the lower column must win
    for m in (600, 300, min(k - 1, 599)):  # k > m: (+inf, -1) fill
        gv, gi = topk_ops.topk_select(q, b, k, d=32 * w - 7, metric=metric,
                                      m_valid=m)
        wv, wi = topk_ops.topk_select_ref(q, b, k, d=32 * w - 7,
                                          metric=metric, m_valid=m)
        assert torch.equal(gi, wi), (m, k)
        assert torch.equal(gv, wv), (m, k)


def test_topk_select_cap(dev):
    """One pass (one select and one merge launch, counted once) up to
    MAX_K keys; above it ceil(min(k, m) / MAX_K) passes."""
    rng = np.random.default_rng(3)
    q, b = _words(rng, 3, 4, dev), _words(rng, 2500, 4, dev)
    for k, m, passes in ((1, 2500, 1), (topk_ops.MAX_K, 2500, 1),
                         (topk_ops.MAX_K + 1, 2500, 2),
                         (2 * topk_ops.MAX_K, 2500, 2),
                         (3 * topk_ops.MAX_K, 2500, 3),
                         (3000, 700, 1), (3000, 1500, 2), (10, 0, 0)):
        before = build.LAUNCHES["topk_select"]
        gv, gi = topk_ops.topk_select(q, b, k, d=128, m_valid=m)
        assert build.LAUNCHES["topk_select"] - before == passes, (k, m)
        wv, wi = topk_ops.topk_select_ref(q, b, k, d=128, m_valid=m)
        assert torch.equal(gi, wi) and torch.equal(gv, wv), (k, m)


def test_topk_select_many_splits(dev):
    """A store of many splits and query tiles, with every row repeated:
    equal keys meet across split boundaries and in the merge."""
    rng = np.random.default_rng(5)
    q = _words(rng, 70, 16, dev)
    half = _words(rng, 20000, 16, dev)
    b = torch.cat([half, half])
    for k in (1, 10, 300, 1024):
        p = topk_ops.plan(70, b.shape[0], k, 16)
        assert p.splits > 1
        gv, gi = topk_ops.topk_select(q, b, k, d=500)
        wv, wi = topk_ops.topk_select_ref(q, b, k, d=500)
        assert torch.equal(gi, wi) and torch.equal(gv, wv), k


@pytest.mark.parametrize("offset", ["q", "b", "both"])
@pytest.mark.parametrize("k", [10, 1025])
def test_topk_select_takes_rows_off_16_bytes(dev, k, offset):
    """Contiguous views whose data starts 4 bytes past a 16-byte boundary,
    with W a multiple of 4 (the select kernel's 16-byte copies): the
    wrapper copies such an input before the launch, and the answers are
    bit-identical to the plain version's."""
    rng = np.random.default_rng(k)
    w, nq, m = 8, 5, 2000

    def shifted(n, off):
        flat = _words(rng, 1, n * w + 1, dev)[0]
        return flat[1:].view(n, w) if off else flat[: n * w].view(n, w)

    q = shifted(nq, offset in ("q", "both"))
    b = shifted(m, offset in ("b", "both"))
    assert q.is_contiguous() and b.is_contiguous()
    assert (q.data_ptr() % 16 != 0) == (offset in ("q", "both"))
    assert (b.data_ptr() % 16 != 0) == (offset in ("b", "both"))
    for metric in ("cham", "hamming"):
        gv, gi = topk_ops.topk_select(q, b, k, d=250, metric=metric)
        torch.cuda.synchronize()
        wv, wi = topk_ops.topk_select_ref(q, b, k, d=250, metric=metric)
        assert torch.equal(gi, wi) and torch.equal(gv, wv), metric


@pytest.mark.parametrize("d", [1, 31, 4096, 4097, sparse_ops.MAX_D,
                               sparse_ops.MAX_D + 1, 2_000_001])
def test_cabin_build_dense_every_d(dev, d):
    rng = np.random.default_rng(d % 1000)
    x = rng.integers(-3, 50, size=(7, 5000)).astype(np.int32)
    x[rng.random(x.shape) < 0.7] = 0
    x[0] = 0
    x[1, :3] = [2**31 - 1, -(2**31), -1]
    x[2:7] = 0  # rows holding only the last, or only the first, attribute
    x[2:6, -1] = [1, 2, 3, 4]
    x[6, 0] = 5
    xt = torch.from_numpy(x).to(dev)
    kw = dict(d=d, psi_seed=0x7FFFFFFF, pi_seed=12345)
    got = dense_ops.cabin_build(xt, **kw)
    assert torch.equal(got, dense_ops.cabin_build_ref(xt, **kw))


# (b, hq, hkv, s, skv, dh, dv, causal)
FLASH_CASES = [
    (1, 1, 1, 1, 1, 16, 16, True),
    (1, 2, 2, 1, 300, 128, 128, False),
    (2, 4, 1, 63, 63, 64, 64, True),
    (1, 8, 1, 65, 65, 128, 128, True),
    (1, 8, 8, 1000, 1000, 128, 128, True),
    (1, 4, 4, 65, 200, 256, 256, False),
    (2, 8, 2, 100, 37, 64, 32, False),
    (1, 4, 1, 130, 130, 16, 48, True),
    (1, 16, 2, 77, 77, 80, 80, True),
    (1, 4, 2, 70, 129, 256, 16, True),
    # S and Skv not multiples of the 64-row tiles, both masks
    (2, 8, 2, 191, 191, 128, 128, True),
    (1, 4, 2, 191, 250, 128, 64, False),
    (1, 2, 1, 33, 1000, 64, 64, True),
    (1, 2, 2, 1000, 33, 64, 192, True),
    (1, 6, 3, 127, 300, 256, 128, False),
    # the LM prefill's shape (llama3-8B, 4 x 1,024 tokens)
    (4, 32, 8, 1024, 1024, 128, 128, True),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_edges(dev, case, dtype):
    b, hq, hkv, s, skv, dh, dv, causal = case
    gen = torch.Generator(device=dev).manual_seed(s * 7 + dh)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, hq, s, dh), (b, hkv, skv, dh),
                             (b, hkv, skv, dv)))
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    want = flash_ops.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, hq, s, dv)
    assert flash_ops.tolerance_ratio(got, want) <= 1.0


def test_flash_attention_refuses_mixed_devices(dev):
    q = torch.zeros((1, 2, 4, 16), device=dev)
    with pytest.raises(ValueError, match="devices"):
        flash_ops.flash_attention(q, q.cpu(), q)


def test_flash_attention_refuses_unaligned_bfloat16(dev):
    q = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16, device=dev)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                          device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops.flash_attention(shifted, q, q)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_serve_engine_on_cuda_equals_the_cpu(dev, kv_dtype):
    cfg = reduced_for_smoke(get_config("llama3_8b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(3, cfg.vocab_size, (3, 70))
    pcfg = ParallelConfig(kv_cache_dtype=kv_dtype)
    runs = [ServeEngine(cfg, _to(params, d), pcfg, device=d).generate(
        prompts, 6, 80, keep_logits=True) for d in ("cpu", dev)]
    np.testing.assert_array_equal(runs[0].tokens, runs[1].tokens)
    tol = 1e-3 if kv_dtype == "int8" else 1e-4
    for name in ("prefill_logits", "step_logits"):
        torch.testing.assert_close(getattr(runs[1], name).cpu(),
                                   getattr(runs[0], name), rtol=tol, atol=tol)


def test_each_wrapper_counts_one_launch_per_call(dev):
    x = _words(np.random.default_rng(0), 8, 4, dev)
    before = dict(build.LAUNCHES)
    dense_ops.cabin_build(x, d=64, psi_seed=1, pi_seed=2)
    qf = torch.zeros((1, 2, 4, 16), device=dev)
    flash_ops.flash_attention(qf, qf, qf)
    sparse_ops.cabin_build_sparse(x, x, d=64, psi_seed=1, pi_seed=2)
    hamming_ops.pair_stats(x, x)
    hamming_ops.row_popcount(x)
    topk_ops.topk_select(x, x, 3, d=128)
    for name in before:
        assert build.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_engine_topk_any_k_on_cuda_equals_the_cpu(dev, metric):
    """topk up to and above the kernel's 1,024 keys a pass, on CUDA and on
    the CPU, against one sort of the alive store by the plain version."""
    rng = np.random.default_rng(2)
    params = CabinParams.create(5000, 300, seed=3)
    engines = [QueryEngine(params, metric=metric, band_rows=64, device=d)
               for d in ("cpu", dev)]
    idx = rng.integers(0, 5000, size=(1500, 40)).astype(np.int32)
    val = rng.integers(0, 6, size=(1500, 40)).astype(np.int32)
    for e in engines:
        e.add_sparse(idx[:1300], val[:1300])
        e.remove(np.arange(0, 1300, 7))
        e.add_sparse(idx[1300:], val[1300:])
    queries = ((idx[:5] + 1) % 5000, val[:5])
    mat, m_alive, alive_ids = engines[0].store.gather_alive()
    q_sk = engines[0]._sketch(queries)[0]
    for k in (1, 10, 256, 257, 1024, 1025):
        (ci, cv), (gi, gv) = [e.topk(queries, k) for e in engines]
        assert np.array_equal(ci, gi) and np.array_equal(cv, gv), k
        bv, bpos = topk_ops.topk_select_ref(q_sk, mat[:m_alive].contiguous(),
                                            k, d=300, metric=metric)
        assert np.array_equal(alive_ids[bpos.numpy()], ci), k
        assert np.array_equal(bv.numpy(), cv), k


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


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_width_zero_coo_on_cuda_equals_the_cpu(dev, metric, monkeypatch):
    """A COO batch of width 0 through add_sparse and topk on the card: the
    sparse Cabin kernel sees the padded width, never m = 0, and the
    answers equal the CPU engine's."""
    widths = []
    real = sparse_ops.cabin_build_sparse

    def spy(indices, values, **kw):
        widths.append(indices.shape[1])
        return real(indices, values, **kw)

    monkeypatch.setattr(sparse_ops, "cabin_build_sparse", spy)
    rng = np.random.default_rng(6)
    params = CabinParams.create(5000, 300, seed=3)
    engines = [QueryEngine(params, metric=metric, band_rows=64, device=d)
               for d in ("cpu", dev)]
    idx = rng.integers(0, 5000, size=(300, 40)).astype(np.int32)
    val = rng.integers(0, 6, size=(300, 40)).astype(np.int32)
    empty = (np.zeros((2, 0), np.int32), np.zeros((2, 0), np.int32))
    before = build.LAUNCHES["cabin_build_sparse"]
    for e in engines:
        e.add_sparse(idx, val)
        assert list(e.add_sparse(*empty)) == [300, 301]
    queries = (np.zeros((3, 0), np.int32), np.zeros((3, 0), np.int32))
    (ci, cv), (gi, gv) = [e.topk(queries, 5) for e in engines]
    assert np.array_equal(ci, gi) and np.array_equal(cv, gv)
    assert (gi[:, :2] == [300, 301]).all()
    assert build.LAUNCHES["cabin_build_sparse"] - before == 3
    assert 0 not in widths


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_front_door_on_cuda_equals_the_engine(dev, metric):
    """The FrontDoor's dispatcher thread drives a CUDA engine: coalesced
    topk and radius answers equal the engine's own, bit for bit, and a
    budgeted topk with a deadline that never fires is exact."""
    from repro_torch.serve import Deadline, FrontDoor

    rng = np.random.default_rng(9)
    params = CabinParams.create(5000, 300, seed=3)
    engine = QueryEngine(params, metric=metric, band_rows=64, device=dev)
    idx = rng.integers(0, 5000, size=(3000, 40)).astype(np.int32)
    val = rng.integers(0, 6, size=(3000, 40)).astype(np.int32)
    engine.add_sparse(idx, val)
    qs = [(torch.from_numpy(idx[i:i + 4] + 1).to(dev) % 5000,
           torch.from_numpy(val[i:i + 4]).to(dev)) for i in range(0, 32, 4)]
    with FrontDoor(engine, max_wait_ms=5.0) as fd:
        handles = [fd.submit("topk", q, k=7) for q in qs]
        far = fd.submit("topk", qs[0], k=7,
                        deadline=Deadline(timeout_ms=1e9))
        got = [h.result(timeout=60) for h in handles]
        r = float(np.median(got[0].dists[:, -1]))
        near = fd.radius(qs[1], r)
        far = far.result(timeout=60)
    want = [engine.topk(q, 7) for q in qs]
    for res, (ids, dists) in zip(got + [far], want + want[:1]):
        assert res.ok and not res.partial
        assert np.array_equal(res.ids, ids) and np.array_equal(res.dists,
                                                              dists)
    for a, b in zip(near.hits, engine.radius(qs[1], r)):
        assert np.array_equal(a, b)


# the widths a PubMed index migrates to under drift: theory.sketch_dim of
# a p95 density of 247 or 248 is 5,555 or 5,588 bits, W = 174 or 175 words
# (neither a multiple of 4)
MIGRATED_D = (5555, 5588)


@pytest.mark.parametrize("d", MIGRATED_D)
@pytest.mark.parametrize("rows", [1, 63, 64, 65, 257, 16384])
def test_kernels_at_the_migrated_width(dev, rows, d):
    """B1-B4 at W = 174 and 175 against their plain versions, at row
    counts on either side of each kernel's tiles."""
    w = (d + 31) // 32
    rng = np.random.default_rng(rows)
    i, v = _coo_rows(rng, rows, 298, dev)
    kw = dict(d=d, psi_seed=0x7FFFFFFF, pi_seed=12345)
    assert torch.equal(sparse_ops.cabin_build_sparse(i, v, **kw),
                       sparse_ops.cabin_build_sparse_ref(i, v, **kw))
    b = _words(rng, rows, w, dev)
    assert torch.equal(hamming_ops.row_popcount(b),
                       hamming_ops.row_popcount_ref(b))
    for nq in (1, 64, 65):
        q = _words(rng, nq, w, dev)
        for g, r in zip(hamming_ops.pair_stats(q, b),
                        hamming_ops.pair_stats_ref(q, b)):
            assert torch.equal(g, r), nq
        for metric in ("cham", "hamming"):
            for k in (1, 10, min(rows + 3, 300)):
                gv, gi = topk_ops.topk_select(q, b, k, d=d, metric=metric)
                wv, wi = topk_ops.topk_select_ref(q, b, k, d=d,
                                                  metric=metric)
                assert torch.equal(gi, wi) and torch.equal(gv, wv), (
                    nq, metric, k)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_lifecycle_on_cuda_equals_the_cpu(dev, metric, tmp_path):
    """Merge, shard, a journaled migration with a mid-migration query, and
    snapshots saved on one device and restored on the other: the engine on
    the card answers as the same history on the CPU, bit for bit."""
    rng = np.random.default_rng(2)
    params = CabinParams.create(5000, 256, seed=3)

    def coo(n):
        idx = rng.integers(0, 5000, size=(n, 40)).astype(np.int32)
        val = rng.integers(0, 6, size=(n, 40)).astype(np.int32)
        return idx, val

    parts = [coo(700), coo(500)]
    queries, late = coo(9), coo(64)
    runs = {}
    for d in ("cpu", dev):
        a = QueryEngine(params, metric=metric, band_rows=64, device=d)
        b = QueryEngine(params, metric=metric, band_rows=64, device=d)
        b.store._next_id = 700
        a.add_sparse(*parts[0])
        b.add_sparse(*parts[1])
        a.merge(b)
        a.shard(n_shards=3)
        a.remove(np.arange(0, 1200, 13))
        before = a.topk(queries, 7)
        a.migrate(d=5588, batch_rows=256, drive="manual",
                  journal_dir=str(tmp_path / f"journal-{torch.device(d).type}"),
                  journal_every=1)
        a.migration_step()
        a.add_sparse(*late)
        a.migration_step()
        mid = a.topk(queries, 7)
        r = float(np.median(mid[1][:, -1]))
        near = a.radius(queries, r)
        runs[torch.device(d).type] = (a, before, mid, near, r)
    (c, *cpu), (g, *gpu) = runs["cpu"], runs["cuda"]
    for x, y in zip(cpu[:2], gpu[:2]):
        assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
    for x, y in zip(cpu[2], g.radius(queries, cpu[3])):
        assert np.array_equal(x, y)
    # the CUDA journal restored on the CPU and the CPU's on the card
    for src, dst_dev, twin in (("cuda", "cpu", c), ("cpu", dev, g)):
        res = QueryEngine.restore(str(tmp_path / f"journal-{src}"),
                                  device=dst_dev, band_rows=64)
        assert res.migrating and res.store.device.type == torch.device(
            dst_dev).type
        for x, y in zip(res.topk(queries, 7), twin.topk(queries, 7)):
            assert np.array_equal(x, y)
    for e in (c, g):
        e.migrate_all()
    assert torch.equal(c.store.sk_buf[:c.store.size].cpu(),
                       g.store.sk_buf[:g.store.size].cpu())
    for x, y in zip(c.topk(queries, 7), g.topk(queries, 7)):
        assert np.array_equal(x, y)
    g.save(str(tmp_path / "snap"))
    res = QueryEngine.restore(str(tmp_path / "snap"), device="cpu",
                              band_rows=64)
    for x, y in zip(res.topk(queries, 7), c.topk(queries, 7)):
        assert np.array_equal(x, y)
