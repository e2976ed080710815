"""Plain versions of the port's kernels vs the JAX package's kernels and
oracles, on the same numpy inputs.

  * pair_stats / row_popcount (B3 / B4) vs the Pallas kernels in
    interpret mode: bit-identical.
  * topk_select (B2) vs `core.allpairs._topk_rows_impl` (through
    `topk_rows(mode="popcount")`) and `topk_select_ref`, not the Pallas
    kernel, whose sentinel fault is a known seed failure.  Ids and Hamming
    values exact, Cham values at rtol 1e-6 of their terms.  The kernel's
    split-then-merge pass, as its plain version computes it, against the
    one sort, and the launch plan at the main path's shapes.
  * dist_matrix, threshold_pairs and topk_rows_banded, which run on these
    kernels, vs their JAX twins.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import (assert_cham_close, assert_ids_equal_but_ties,
                           cham_term_scale)
from repro.kernels.hamming import kernel as jhk
from repro.kernels.hamming import ops as jhops
from repro.kernels.topk_select.ref import topk_select_ref
from repro_torch.kernels.hamming import ops as thops
from repro_torch.kernels.hamming.ref import pair_stats_ref, row_popcount_ref
from repro_torch.kernels.topk_select import ops as ttopk_ops
from repro_torch.kernels.topk_select import ref as ttopk

jall = importlib.import_module("repro.core.allpairs")
tall = importlib.import_module("repro_torch.core.allpairs")
jcabin = importlib.import_module("repro.core.cabin")
tcabin = importlib.import_module("repro_torch.core.cabin")

D = 256
# the reference oracles, jitted whole: eager jnp compiles op by op per shape
jtopk_ref = jax.jit(topk_select_ref,
                    static_argnames=("k", "d", "metric", "m_valid"))
jdist = jax.jit(jhops.dist_matrix,
                static_argnames=("d", "metric", "use_pallas"))


def _words(rng, n, w):
    return rng.integers(-(2**31), 2**31, size=(n, w)).astype(np.int32)


def _sketches(seed, n, d=D, density=40):
    """Real Cabin sketches (weights spread like served data)."""
    rng = np.random.default_rng(seed)
    m = 2 * density
    idx = rng.integers(0, 4000, size=(n, m)).astype(np.int32)
    val = rng.integers(0, 6, size=(n, m)).astype(np.int32)
    val[:, rng.integers(density // 2, m):] = 0
    p = tcabin.CabinParams.create(4000, d, seed=seed)
    return tcabin.sketch_sparse(p, torch.from_numpy(idx),
                                torch.from_numpy(val)).numpy()


def T(x) -> torch.Tensor:
    """A torch tensor of its own (jax's numpy views are read-only)."""
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("m,n,w", [(1, 1, 1), (16, 16, 8), (37, 29, 9),
                                   (64, 33, 17), (5, 130, 128)])
def test_pair_stats_ref_matches_pallas_interpret(m, n, w):
    rng = np.random.default_rng(m * 1000 + n)
    a, b = _words(rng, m, w), _words(rng, n, w)
    ri, rh = jhk.pair_stats(jnp.asarray(a), jnp.asarray(b), interpret=True,
                            bm=16, bn=16, bk=8)
    gi, gh = pair_stats_ref(T(a), T(b))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
    only_inner, none = pair_stats_ref(T(a), T(b), op_ham=False)
    assert none is None
    np.testing.assert_array_equal(only_inner.numpy(), np.asarray(ri))


@pytest.mark.parametrize("m,w", [(1, 1), (80, 12), (300, 128)])
def test_row_popcount_ref_matches_pallas_interpret(m, w):
    x = _words(np.random.default_rng(m), m, w)
    ref = jhk.row_popcount(jnp.asarray(x), interpret=True, bm=16)
    np.testing.assert_array_equal(row_popcount_ref(T(x)).numpy(),
                                  np.asarray(ref))
    np.testing.assert_array_equal(thops.row_popcount(T(x)).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_dist_matrix_matches_reference(metric):
    a, b = _sketches(1, 9), _sketches(2, 40)
    ref = np.asarray(jdist(jnp.asarray(a), jnp.asarray(b), d=D,
                           metric=metric, use_pallas=False))
    got = thops.dist_matrix(T(a), T(b), D, metric=metric).numpy()
    if metric == "hamming":
        np.testing.assert_array_equal(got, ref)
    else:
        assert_cham_close(got, ref, cham_term_scale(a, b, D))


def _check_topk(metric, a, b, gv, gi, rv, ri, ref_vals_k1=None):
    rows = b[np.maximum(ri, 0)]
    if metric == "hamming":
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gv, rv)
        return
    assert_cham_close(gv, rv, cham_term_scale(a, rows, D))
    assert_ids_equal_but_ties(gi, ri, rv if ref_vals_k1 is None
                              else ref_vals_k1)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("q,n,w,k,m_valid", [
    (1, 1, 1, 1, None),
    (9, 37, 8, 5, None),
    (33, 70, 9, 7, None),
    (5, 12, 4, 12, None),      # k == n: every column is a winner
    (6, 40, 8, 5, 17),         # masked tail columns
])
def test_topk_select_ref_matches_reference(metric, q, n, w, k, m_valid):
    rng = np.random.default_rng(q * 100 + n)
    a, b = _words(rng, q, w), _words(rng, n, w)
    m = n if m_valid is None else m_valid
    gv, gi = ttopk.topk_select_ref(T(a), T(b), k, d=D, metric=metric,
                                   m_valid=m_valid)
    ri, rv = jall.topk_rows(jnp.asarray(a), jnp.asarray(b), k, d=D,
                            metric=metric, mode="popcount", m_valid=m,
                            block=16)
    _check_topk(metric, a, b, gv.numpy(), gi.numpy(), rv, ri)
    ov, oi = jtopk_ref(jnp.asarray(a), jnp.asarray(b), k=k, d=D,
                       metric=metric, m_valid=m)
    _check_topk(metric, a, b, gv.numpy(), gi.numpy(), np.asarray(ov),
                np.asarray(oi))


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("k", [1, 1023, 1024, 1025, 2048, 3000, "m"])
def test_topk_select_rounds_equal_one_sort(metric, k):
    """Any k runs as passes of MAX_K keys, each floored at the last key of
    the pass before.  On the CPU each pass is `topk_split_round_ref` under
    the wrapper's plan (the kernel's split and merge, with the floor
    applied), so the wrapper's pass loop is the one the card runs; joined,
    the passes equal the one-sort plain version bit for bit, and the JAX
    package's oracle (ids and Hamming exact, Cham at its term tolerance).
    Rows 1600-1699 repeat rows 100-199, so equal distances must go to the
    lower column across pass boundaries."""
    rng = np.random.default_rng(17)
    a, b = _words(rng, 5, 8), _words(rng, 2600, 8)
    b[1600:1700] = b[100:200]
    for m in (2600, 2100):
        kk = m if k == "m" else k
        gv, gi = ttopk_ops.topk_select(T(a), T(b), kk, d=D, metric=metric,
                                       m_valid=m)
        wv, wi = ttopk.topk_select_ref(T(a), T(b), kk, d=D, metric=metric,
                                       m_valid=m)
        assert torch.equal(gi, wi) and torch.equal(gv, wv), (kk, m)
        if kk <= m:  # the oracle fills slots past m with masked columns
            ov, oi = jtopk_ref(jnp.asarray(a), jnp.asarray(b), k=kk, d=D,
                               metric=metric, m_valid=m)
            _check_topk(metric, a, b[:m], gv.numpy(), gi.numpy(),
                        np.asarray(ov), np.asarray(oi))


# (splits, rows_per_split, m_valid): one split; splits shorter than k;
# trailing empty splits; a split boundary inside the repeated rows; fewer
# valid rows than supplied
SPLITS = [(1, 300, None), (3, 100, None), (40, 8, None), (7, 64, 130),
          (5, 61, None), (300, 1, None), (4, 50, 151)]


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("splits,rows,m_valid", SPLITS)
@pytest.mark.parametrize("k", [1, 12, 130])
def test_split_then_merge_equals_one_sort(metric, splits, rows, m_valid, k):
    """The kernel's pass as the plain version splits it (per-split k-best
    lists, then their merge) equals the one sort bit for bit, with and
    without a floor key, and the JAX package's oracle.  Rows 150-209
    repeat rows 20-79: ties across split boundaries go to the lower
    column."""
    rng = np.random.default_rng(splits * 1000 + rows + k)
    a, b = _words(rng, 6, 5), _words(rng, 300, 5)
    b[150:210] = b[20:80]
    m = b.shape[0] if m_valid is None else m_valid
    if splits * rows < m:
        with pytest.raises(ValueError, match="cover"):
            ttopk.topk_split_round_ref(T(a), T(b), k, d=D, metric=metric,
                                       m_valid=m, splits=splits,
                                       rows_per_split=rows)
        return
    kw = dict(d=D, metric=metric, m_valid=m)
    sv, si = ttopk.topk_split_round_ref(T(a), T(b), k, **kw, splits=splits,
                                        rows_per_split=rows)
    ov, oi = ttopk.topk_round_ref(T(a), T(b), k, **kw)
    assert torch.equal(si, oi) and torch.equal(sv, ov)
    wv, wi = ttopk.topk_select_ref(T(a), T(b), k, **kw)
    assert torch.equal(si, wi) and torch.equal(sv, wv)
    if k <= m:
        jv, ji = jtopk_ref(jnp.asarray(a), jnp.asarray(b), k=k, **kw)
        _check_topk(metric, a, b[:m], sv.numpy(), si.numpy(), np.asarray(jv),
                    np.asarray(ji))
    # floored at each query's 5th key: the next keys, as one sort gives them
    floor = ttopk_ops._last_key(ov[:, :5], oi[:, :5])
    fv, fi = ttopk.topk_split_round_ref(T(a), T(b), k, **kw, floor=floor,
                                        splits=splits, rows_per_split=rows)
    gv, gi = ttopk.topk_round_ref(T(a), T(b), k, **kw, floor=floor)
    assert torch.equal(fi, gi) and torch.equal(fv, gv)
    want = min(k, m) - 5 if min(k, m) >= 5 else 0
    if want:
        assert torch.equal(fi[:, :want], wi[:, 5:5 + want])


def test_split_lists_hold_each_ranges_best():
    """The select launch's lists: split s holds the k smallest keys of its
    own column range, ascending, padded past the range's rows."""
    keys = torch.tensor([[50, 10, 40, 30, 20, 60, 5]], dtype=torch.int64)
    pad = ttopk.KEY_PAD
    lists = ttopk.split_lists_ref(keys, 2, 4, 2)
    assert lists.tolist() == [[[10, 50], [30, 40], [20, 60], [5, pad]]]
    assert ttopk.merge_lists_ref(lists, 3).tolist() == [[5, 10, 20]]
    assert ttopk.split_lists_ref(keys, 3, 1, 7).tolist() == [[[5, 10, 20]]]


@pytest.mark.parametrize("nq,m,k,w,want", [
    # the main path: 256 queries over the alive store, k = 10
    (256, 523101, 10, 128, (64, 64, 128, 66, 7936, 1351680)),
    # the largest band-walk chunk, and a small second chunk
    (256, 487424, 10, 128, (64, 64, 128, 66, 7424, 1351680)),
    (256, 35000, 10, 128, (64, 64, 128, 61, 576, 1249280)),
    # k = 1,024 for 16 queries: 8-query tiles, 61 splits of >= 8k rows;
    # above CAP = 128 one block a SM, so one split per SM and query tile
    (16, 523101, 1024, 128, (8, 512, 2048, 61, 8704, 7995392)),
    (16, 523101, 257, 128, (16, 256, 1024, 128, 4096, 4210688)),
    (16, 523101, 129, 128, (32, 128, 512, 132, 3968, 2179584)),
    (16, 523101, 65, 128, (64, 64, 256, 132, 3968, 1098240)),
    # edges: no rows, fewer rows than k, one query, one word a row
    (5, 0, 10, 128, (64, 64, 128, 1, 0, 400)),
    (5, 7, 10, 128, (64, 64, 128, 1, 64, 400)),
    (1, 523101, 10, 128, (64, 64, 128, 264, 1984, 21120)),
    (1, 523101, 10, 1, (64, 64, 128, 7, 74752, 560)),
])
def test_plan(nq, m, k, w, want):
    p = ttopk_ops.plan(nq, m, k, w)
    assert tuple(p) == want
    assert p.splits * p.rows_per_split >= m
    assert m == 0 or (p.splits - 1) * p.rows_per_split < m  # none empty
    assert p.rows_per_split % p.bn == 0 and p.cap >= 2 * k
    assert p.bq * p.cap * 8 <= 128 * 1024 and p.cap - p.bn >= k


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_topk_rows_pad_k_fills_with_inf_and_minus_one(metric):
    rng = np.random.default_rng(7)
    a, b = _words(rng, 4, 8), _words(rng, 16, 8)
    ri, rv = jall.topk_rows(jnp.asarray(a), jnp.asarray(b), 9, d=D,
                            metric=metric, mode="popcount", m_valid=5,
                            pad_k=True)
    gi, gv = tall.topk_rows(T(a), T(b), 9, d=D, metric=metric, m_valid=5,
                            pad_k=True)
    assert (gi[:, 5:] == -1).all() and np.isinf(gv[:, 5:]).all()
    _check_topk(metric, a, b, gv, gi, rv, ri)


def test_sketched_topk_on_real_sketches():
    """Real sketches have many equal weights: ties stress the
    lower-column rule."""
    a, b = _sketches(3, 12), _sketches(4, 300)
    for metric in ("cham", "hamming"):
        gv, gi = ttopk.topk_select_ref(T(a), T(b), 11, d=D, metric=metric)
        ri, rv = jall.topk_rows(jnp.asarray(a), jnp.asarray(b), 11, d=D,
                                metric=metric, mode="popcount")
        _, rv1 = jall.topk_rows(jnp.asarray(a), jnp.asarray(b), 12, d=D,
                                metric=metric, mode="popcount")
        _check_topk(metric, a, b, gv.numpy(), gi.numpy(), rv, ri, rv1)


def _midpoint_threshold(dist: np.ndarray) -> float:
    """A threshold halfway between two distinct distance values, so that
    no pair sits on the knife edge."""
    vals = np.unique(dist)
    mid = len(vals) // 3
    return float((vals[mid] + vals[mid + 1]) / 2)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_threshold_pairs_same_pairs_same_order(metric, symmetric):
    a, b = _sketches(5, 37), _sketches(6, 70)
    if symmetric:
        b = None
        dist = np.asarray(thops.dist_matrix(T(a), T(a), D, metric=metric))
    else:
        dist = np.asarray(thops.dist_matrix(T(a), T(b), D, metric=metric))
    thr = _midpoint_threshold(dist)
    kw = dict(d=D, threshold=thr, metric=metric, block=16)
    if symmetric:
        ref = jall.threshold_pairs(jnp.asarray(a), **kw, mode="popcount")
        got = tall.threshold_pairs(T(a), **kw)
    else:
        ref = jall.threshold_pairs(jnp.asarray(a), jnp.asarray(b), **kw,
                                   mode="popcount", n_valid=30, m_valid=61)
        got = tall.threshold_pairs(T(a), T(b), **kw, n_valid=30, m_valid=61)
    assert len(ref) > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_topk_rows_banded_matches_reference(metric):
    a = _sketches(8, 6)
    b = _sketches(9, 400)
    rng = np.random.default_rng(9)
    weights = np.unpackbits(b.view(np.uint8), axis=1).sum(1)
    order = np.argsort(weights, kind="stable")
    b_sorted = b[order]
    scores = tall.prune_score_host(weights[order], D, metric)
    np.testing.assert_array_equal(
        scores, jall.prune_score_host(weights[order], D, metric))
    band_rows = 32
    n_bands = -(-len(b) // band_rows)
    band_lo = np.array([scores[i * band_rows] for i in range(n_bands)])
    band_hi = np.array([scores[min((i + 1) * band_rows, len(b)) - 1]
                        for i in range(n_bands)])
    q_scores = tall.prune_score_host(
        np.unpackbits(a.view(np.uint8), axis=1).sum(1), D, metric)
    alive = rng.random(len(b)) > 0.2
    keys = order.astype(np.int64)  # tie-break by original row
    kw = dict(d=D, q_scores=q_scores, band_lo=band_lo, band_hi=band_hi,
              band_rows=band_rows, n_valid=len(b), metric=metric,
              order_by=keys, alive=alive)
    for k, init_kth in ((7, None), (7, np.full(6, 80.0, np.float32))):
        st_ref, st_got = {}, {}
        rp, rv = jall.topk_rows_banded(jnp.asarray(a), jnp.asarray(b_sorted),
                                       k, **kw, init_kth=init_kth,
                                       stats_out=st_ref, mode="popcount")
        gp, gv = tall.topk_rows_banded(T(a), T(b_sorted), k, **kw,
                                       init_kth=init_kth, stats_out=st_got)
        if metric == "hamming":
            np.testing.assert_array_equal(gp, rp)
            np.testing.assert_array_equal(gv, rv)
            assert st_got == st_ref
        else:
            rows = b_sorted[np.maximum(rp, 0)]
            assert_cham_close(gv, rv, cham_term_scale(a, rows, D))
            assert_ids_equal_but_ties(gp, rp, rv)


def test_kbest_lex_merge_matches_reference():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 5, size=(4, 12)).astype(np.float32)
    keys = rng.permutation(48).reshape(4, 12).astype(np.int64)
    extra = rng.integers(0, 100, size=(4, 12))
    for got, ref in zip(tall.kbest_lex_merge(5, vals, keys, extra),
                        jall.kbest_lex_merge(5, vals, keys, extra)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("d", [200, 256])
def test_cham_functions_match_reference(d):
    jcham = importlib.import_module("repro.core.cham")
    tcham = importlib.import_module("repro_torch.core.cham")
    a, b = _sketches(10, 8, d=d), _sketches(11, 8, d=d)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    wa = np.unpackbits(a.view(np.uint8), axis=1).sum(1).astype(np.int32)
    wb = np.unpackbits(b.view(np.uint8), axis=1).sum(1).astype(np.int32)
    inner = np.asarray(jhk.pair_stats(ja, jb, op_ham=False, interpret=True)[0])
    scale = cham_term_scale(a, b, d)
    got = tcham.binhamming_from_stats(T(wa)[:, None], T(wb)[None, :],
                                      T(inner), d).numpy()
    ref = np.asarray(jcham.binhamming_from_stats(
        jnp.asarray(wa)[:, None], jnp.asarray(wb)[None, :],
        jnp.asarray(inner), d))
    assert_cham_close(2 * got, 2 * ref, scale)
    assert_cham_close(tcham.cham_matrix(T(a), T(b), d).numpy(),
                      np.asarray(jcham.cham_matrix(ja, jb, d)), scale)
    assert_cham_close(tcham.cham(T(a), T(b), d).numpy(),
                      np.asarray(jcham.cham(ja, jb, d)),
                      np.diagonal(scale))
    np.testing.assert_array_equal(
        tcham.hamming_matrix_exact(T(a), T(b)).numpy(),
        np.asarray(jcham.hamming_matrix_exact(ja, jb)))
    # a row's distance to itself is exactly 0 through the table
    assert (tcham.cham_matrix(T(a), T(a), d).numpy().diagonal() == 0).all()
