"""Comparison rules of the repro_torch parity tests, and their tests.

Integers (hashes, sketches, weights, inner products, Hamming distances,
ids under "hamming") must be bit-identical to the JAX package.  Cham
floats cannot be: the reference evaluates its logs per graph and is not
bit-stable across its own graphs, and the port reads one f32 table.  Cham
is a difference of logs, 2 * (2*T[u] - T[a] - T[b]), so an f32 rounding
difference in any term is relative to that term, not to the (smaller)
difference.  The tolerance is therefore rtol 1e-6 on each term:

    |got - ref| <= 1e-6 * 2 * (2*|T[u]| + |T[a]| + |T[b]|).

It is the reference's own noise level: its eager and jitted Cham matrices
of the same sketches agree within it (tested below), while a plain rtol
of 1e-6 on the value itself does not hold between them.  Ids may differ
only where the reference's own neighbouring distances are near-ties.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.cham import cham_table
from repro_torch.core.packing import popcount32

RTOL = 1e-6
TIE_RTOL = 1e-5


def cham_term_scale(q: np.ndarray, rows: np.ndarray, d: int) -> np.ndarray:
    """Per-pair term magnitude 2*(2|T[u]| + |T[a]| + |T[b]|) between packed
    rows q (Q, W) and rows (Q, K, W) (or (K, W), shared by every query)."""
    qt = torch.from_numpy(np.array(q, np.int32))
    rt = torch.from_numpy(np.array(rows, np.int32))
    if rt.ndim == 2:
        rt = rt[None].expand(qt.shape[0], -1, -1)
    wa = popcount32(qt).sum(-1).to(torch.int64)[:, None]
    wb = popcount32(rt).sum(-1).to(torch.int64)
    inner = popcount32(qt[:, None, :] & rt).sum(-1).to(torch.int64)
    table = cham_table(d, "cpu", q.shape[1]).abs()
    return (2.0 * (2.0 * table[wa + wb - inner] + table[wa] + table[wb])
            ).numpy()


def assert_cham_close(got, ref, scale) -> None:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    err = np.abs(got[finite].astype(np.float64) - ref[finite])
    lim = RTOL * np.broadcast_to(scale, ref.shape)[finite]
    bad = err > lim
    assert not bad.any(), (
        f"{int(bad.sum())} Cham values off by more than rtol {RTOL} of "
        f"their terms: worst {err[bad].max()} vs limit {lim[bad].min()}")


def assert_ids_equal_but_ties(got_ids, ref_ids, ref_vals) -> None:
    """ids equal, except where the reference's own neighbouring distances
    are within TIE_RTOL relative: there f32 noise may swap two ids.
    `ref_vals` has one column more than the ids (the reference's k+1-th
    distance), so a swap across the k-th place is judged too."""
    got_ids = np.asarray(got_ids)
    ref_ids = np.asarray(ref_ids)
    ref_vals = np.asarray(ref_vals, np.float64)
    k = ref_ids.shape[1]
    for qi, j in zip(*np.nonzero(got_ids != ref_ids)):
        v = ref_vals[qi, j]
        near = [ref_vals[qi, t] for t in (j - 1, j + 1)
                if 0 <= t < ref_vals.shape[1]]
        tie = any(abs(v - u) <= TIE_RTOL * max(abs(v), abs(u)) for u in near)
        assert tie, (f"query {qi} slot {j}/{k}: id {got_ids[qi, j]} vs "
                     f"reference {ref_ids[qi, j]} with no near-tie at "
                     f"{ref_vals[qi, max(j - 1, 0): j + 2]}")


# ---------------------------------------------------------------------------
# the rules themselves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [200, 256, 4096])
def test_reference_graphs_agree_within_the_term_tolerance(d):
    jcham = importlib.import_module("repro.core.cham")
    jcabin = importlib.import_module("repro.core.cabin")
    rng = np.random.default_rng(d)
    idx = rng.integers(0, 3000, size=(120, 60)).astype(np.int32)
    val = rng.integers(0, 5, size=(120, 60)).astype(np.int32)
    p = jcabin.CabinParams.create(3000, d, seed=1)
    sk = np.asarray(jcabin.sketch_sparse_jit(p, jnp.asarray(idx),
                                             jnp.asarray(val)))
    a, b = sk[:30], sk[30:]
    eager = np.asarray(jcham.cham_matrix(jnp.asarray(a), jnp.asarray(b), d))
    jitted = np.asarray(jax.jit(jcham.cham_matrix, static_argnums=2)(
        jnp.asarray(a), jnp.asarray(b), d))
    assert_cham_close(eager, jitted, cham_term_scale(a, b, d))


def test_cham_tolerance_rejects_a_real_difference():
    q = np.array([[0x0F0F0F0F] * 8], np.int32)
    rows = np.array([[0x00FF00FF] * 8], np.int32)
    scale = cham_term_scale(q, rows, 256)
    lim = float(RTOL * scale[0, 0])
    with pytest.raises(AssertionError, match="rtol"):
        assert_cham_close([[700.0 + 2 * lim]], [[700.0]], scale)
    assert_cham_close([[700.0 + lim / 2]], [[700.0]], scale)


def test_id_rule_allows_swaps_at_near_ties_only():
    vals = np.array([[1.0, 2.0, 2.0000001, 3.0]])
    assert_ids_equal_but_ties([[7, 5, 4]], [[7, 4, 5]], vals)
    with pytest.raises(AssertionError, match="no near-tie"):
        assert_ids_equal_but_ties([[4, 7, 5]], [[7, 4, 5]], vals)
    # the k-th place judged against the reference's (k+1)-th distance
    assert_ids_equal_but_ties([[7, 4, 9]], [[7, 4, 5]],
                              np.array([[1.0, 2.0, 3.0, 3.00000001]]))
