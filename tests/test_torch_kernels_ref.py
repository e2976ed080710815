"""Plain versions of the port's kernels vs the JAX package's kernels and
oracles, on the same numpy inputs.

  * pair_stats / row_popcount (B3 / B4) vs the Pallas kernels in
    interpret mode: bit-identical.
  * topk_select (B2) vs `core.allpairs._topk_rows_impl` (through
    `topk_rows(mode="popcount")`) and `topk_select_ref`, not the Pallas
    kernel, whose sentinel fault is a known seed failure.  Ids and Hamming
    values exact, Cham values at rtol 1e-6 of their terms.
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
@pytest.mark.parametrize("k", [1, 255, 256, 257, 512, 1024, "m"])
def test_topk_select_rounds_equal_one_sort(metric, k):
    """Any k runs as rounds of MAX_K keys, each floored at the last key of
    the round before.  On the CPU each round is `topk_round_ref` (the
    kernel's round with the floor applied), so the wrapper's round loop is
    the one the card runs; joined, the rounds equal the one-sort plain
    version bit for bit, and the JAX package's oracle (ids and Hamming
    exact, Cham at its term tolerance).  Rows 600-699 repeat rows
    100-199, so equal distances must go to the lower column across round
    boundaries."""
    rng = np.random.default_rng(17)
    a, b = _words(rng, 5, 8), _words(rng, 1100, 8)
    b[600:700] = b[100:200]
    for m in (1100, 900):
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
