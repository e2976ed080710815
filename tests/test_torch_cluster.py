"""Clustering on the PyTorch port (device="cpu": every kernel replaced by
its plain version) against the JAX package's `repro.core.kmode`,
`allpairs.argmin_rows` / `rowsum` and `repro.cluster.ClusterIndex`.

Under hamming every distance is an integer, and the port equals the JAX
package bit for bit: argmin rows and distances, row sums, k-medoid labels,
medoids and centres, and every ClusterIndex state.  Under cham the
reference drifts by an ulp across its own graphs (ROADMAP queue C), so the
port's k-medoid engine is held to the reference's own control flow run on
the port's distances (`repro.core.kmode.kmode_precomputed` with the port's
Cham matrices, summed exactly in float64), which isolates the control flow
from that drift; and `rowsum`'s totals are exact (their bits do not depend
on the tiling or the device).  A `cluster/` snapshot written by either
package restores in the other.
"""

import dataclasses
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import assert_cham_close, cham_term_scale
from tests._hyp import given, settings, st

from repro.cluster import ClusterIndex as JaxClusterIndex
from repro.core import allpairs as jax_allpairs
from repro.core import kmode as jax_kmode
from repro.core.cabin import CabinParams as JaxParams
from repro.core.cabin import sketch_dense as jax_sketch_dense
from repro.index import QueryEngine as JaxEngine
from repro_torch import convert, obs
from repro_torch.cluster import ClusterIndex
from repro_torch.core import allpairs, kmode
from repro_torch.core.cham import cham_matrix, hamming_matrix_exact
from repro_torch.core.packing import padded_take
from repro_torch.index import MergeIncompatible, QueryEngine

N_DIMS = 400
D = 256
JP = JaxParams.create(N_DIMS, D, seed=1)
METRICS = ["cham", "hamming"]


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, N_DIMS), np.int32)
    for i in range(n):
        density = int(rng.integers(15, 60))
        idx = rng.choice(N_DIMS, size=density, replace=False)
        x[i, idx] = rng.integers(1, 8, size=density)
    return x


X = _rows(96, seed=0)
SK = np.asarray(jax_sketch_dense(JP, jnp.asarray(X)))
SK_T = torch.from_numpy(SK.copy())


def _params():
    return convert.params_from_reference(dataclasses.asdict(JP))


def _port_dist(metric):
    """The port's distance matrices as float64: exact sums in the
    reference's host oracle."""
    if metric == "cham":
        return lambda a, b: cham_matrix(
            torch.from_numpy(np.asarray(a, np.int32)),
            torch.from_numpy(np.asarray(b, np.int32)), D).numpy().astype(
                np.float64)
    return lambda a, b: hamming_matrix_exact(
        torch.from_numpy(np.asarray(a, np.int32)),
        torch.from_numpy(np.asarray(b, np.int32))).numpy().astype(np.float64)


def _engines(metric="cham", **kw):
    port = QueryEngine(_params(), metric=metric, device="cpu", **kw)
    ref = JaxEngine(JP, metric=metric, **kw)
    return port, ref


def _same_state(got, want):
    for a, b in zip(got.labels(), want.labels()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.medoid_ids, want.medoid_ids)
    if got.fitted or want.fitted:
        np.testing.assert_array_equal(got.centers, want.centers)
    assert (got.n_refits, got.mutations_since_refit) == (
        want.n_refits, want.mutations_since_refit)


# ---------------------------------------------------------------------------
# argmin_rows / rowsum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("block", [1, 7, 2048])
def test_argmin_rows_equals_reference(metric, block):
    centres = np.concatenate([SK[10:15], SK[10:12], SK[40:50]])  # ties
    for m_valid in (None, 1, 6, 17):
        got_i, got_d = allpairs.argmin_rows(
            SK_T, torch.from_numpy(centres), d=D, metric=metric,
            block=block, m_valid=m_valid)
        want_i, want_d = jax_allpairs.argmin_rows(
            SK, centres, d=D, metric=metric, block=block, m_valid=m_valid)
        dist = _port_dist(metric)(SK, centres)[:, :m_valid]
        np.testing.assert_array_equal(got_i, np.argmin(dist, axis=1))
        np.testing.assert_array_equal(got_d, dist.min(axis=1))
        if metric == "hamming":
            np.testing.assert_array_equal(got_i, want_i)
            np.testing.assert_array_equal(got_d, want_d)
        else:
            scale = cham_term_scale(SK, centres[want_i][:, None, :], D)
            assert_cham_close(got_d, want_d, scale[:, 0])
    # the first minimum: rows equal to a duplicated centre pick its first
    # copy
    got_i, got_d = allpairs.argmin_rows(SK_T[10:12], torch.from_numpy(
        centres), d=D, metric=metric, block=block)
    np.testing.assert_array_equal(got_i, [0, 1])
    np.testing.assert_array_equal(got_d, [0.0, 0.0])
    with pytest.raises(ValueError, match="m_valid"):
        allpairs.argmin_rows(SK_T, SK_T[:4], d=D, m_valid=5)


@pytest.mark.parametrize("metric", METRICS)
def test_rowsum_exact_and_equal_reference(metric):
    dist = _port_dist(metric)(SK, SK)
    want = dist.sum(axis=1)
    for block in (3, 64, 2048):
        np.testing.assert_array_equal(
            allpairs.rowsum(SK_T, d=D, metric=metric, block=block), want)
        np.testing.assert_array_equal(
            allpairs.rowsum(SK_T, SK_T, d=D, metric=metric, block=block),
            want)
    # padded_take's pad rows repeat row 0 and must never be counted
    members = np.array([5, 9, 30, 31, 70])
    sub = padded_take(SK_T, members)
    got = allpairs.rowsum(sub, d=D, metric=metric, m_valid=len(members))
    np.testing.assert_array_equal(
        got[:len(members)], dist[np.ix_(members, members)].sum(axis=1))
    ref = jax_allpairs.rowsum(SK, d=D, metric=metric)
    if metric == "hamming":
        np.testing.assert_array_equal(
            allpairs.rowsum(SK_T, d=D, metric=metric), ref)
    else:  # the reference sums in f32 in tile order
        np.testing.assert_allclose(want, ref, rtol=1e-6)
    assert allpairs.rowsum(SK_T[:0], d=D).shape == (0,)
    np.testing.assert_array_equal(
        allpairs.rowsum(SK_T[:3], SK_T, d=D, m_valid=0), np.zeros(3))


def test_rowsum_square_tiles_equal_one_tile(monkeypatch):
    """The symmetric path computes each off-diagonal square tile once for
    its rows and its columns; the totals must not move."""
    want = {m: allpairs.rowsum(SK_T, d=D, metric=m) for m in METRICS}
    nearest = {m: allpairs.argmin_rows(SK_T, SK_T[:20], d=D, metric=m)
               for m in METRICS}
    monkeypatch.setattr(allpairs, "_TILE_ELEMS", 17 * 17)
    for m in METRICS:
        np.testing.assert_array_equal(allpairs.rowsum(SK_T, d=D, metric=m),
                                      want[m])
        got = allpairs.argmin_rows(SK_T, SK_T[:20], d=D, metric=m, block=5)
        for a, b in zip(got, nearest[m]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[0][:20], np.arange(20))


# ---------------------------------------------------------------------------
# k-mode
# ---------------------------------------------------------------------------


def test_kmode_host_path_equals_reference():
    x = X[:40]
    for k, seed in ((1, 0), (3, 2), (5, 1)):
        got = kmode.kmode(x, k, n_iter=6, seed=seed)
        want = jax_kmode.kmode(x, k, n_iter=6, seed=seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    dup = np.repeat(X[:2], 10, axis=0)
    np.testing.assert_array_equal(kmode.kmode(dup, 4, n_iter=4)[0],
                                  jax_kmode.kmode(dup, 4, n_iter=4)[0])


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**16), st.integers(1, 9))
def test_kmode_packed_equals_reference(seed, k):
    """Full batch: under hamming the JAX package's labels, medoids and
    centres; under cham the reference's host oracle on the port's
    distances.  Duplicate-heavy inputs and k at or above the number of
    distinct rows included."""
    rng = np.random.default_rng(seed)
    if seed % 3 == 0:
        base = SK[rng.choice(96, size=int(rng.integers(1, 6)), replace=False)]
        sk = base[rng.integers(0, len(base), size=40)]
    else:
        sk = SK[rng.choice(96, size=int(rng.integers(8, 60)), replace=False)]
    for metric in METRICS:
        got = kmode.kmode_packed(sk, k, d=D, n_iter=8, seed=seed % 11,
                                 metric=metric, device="cpu")
        oracle = jax_kmode.kmode_precomputed(_port_dist(metric), sk, k,
                                             n_iter=8, seed=seed % 11)
        np.testing.assert_array_equal(got.labels, oracle)
        np.testing.assert_array_equal(sk[got.medoids], got.centers)
        if metric == "hamming":
            want = jax_kmode.kmode_packed(sk, k, d=D, n_iter=8,
                                          seed=seed % 11, metric=metric)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        lab, _ = allpairs.argmin_rows(torch.from_numpy(sk), torch.from_numpy(
            got.centers), d=D, metric=metric)
        np.testing.assert_array_equal(got.labels, lab)


@pytest.mark.parametrize("metric", METRICS)
def test_kmode_packed_minibatch_and_precomputed(metric):
    a = kmode.kmode_packed(SK, 4, d=D, n_iter=4, seed=5, batch_rows=24,
                           metric=metric, device="cpu")
    b = kmode.kmode_packed(SK_T, 4, d=D, n_iter=4, seed=5, batch_rows=24,
                           metric=metric, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    lab, _ = allpairs.argmin_rows(SK_T, torch.from_numpy(a.centers), d=D,
                                  metric=metric)
    np.testing.assert_array_equal(a.labels, lab)
    if metric == "hamming":
        want = jax_kmode.kmode_packed(SK, 4, d=D, n_iter=4, seed=5,
                                      batch_rows=24, metric=metric)
        for x, y in zip(a, want):
            np.testing.assert_array_equal(x, y)
    # the delegating and the oracle modes of kmode_precomputed
    np.testing.assert_array_equal(
        kmode.kmode_precomputed(None, SK, 3, n_iter=5, seed=1, sketch_dim=D,
                                metric=metric, device="cpu"),
        kmode.kmode_packed(SK, 3, d=D, n_iter=5, seed=1, metric=metric,
                           device="cpu").labels)
    np.testing.assert_array_equal(
        kmode.kmode_precomputed(_port_dist(metric), SK, 3, n_iter=5, seed=1),
        jax_kmode.kmode_precomputed(_port_dist(metric), SK, 3, n_iter=5,
                                    seed=1))


def test_kmode_api_validation():
    for bad in (lambda: kmode.kmode(np.zeros((0, 3), np.int32), 2),
                lambda: kmode.kmode(X[:4], 0),
                lambda: kmode.kmode(X[0], 2),
                lambda: kmode.kmode_packed(SK[:0], 2, d=D, device="cpu"),
                lambda: kmode.kmode_packed(SK[:4], 2, d=D, n_iter=0,
                                           device="cpu"),
                lambda: kmode.kmode_packed(SK[:4], 2, d=D, batch_rows=0,
                                           device="cpu"),
                lambda: kmode.kmode_precomputed(None, SK[:4], 2),
                lambda: kmode.kmode_precomputed(_port_dist("cham"), SK[:4],
                                                2, batch_rows=2)):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# ClusterIndex against the JAX package's
# ---------------------------------------------------------------------------


def test_cluster_index_bootstrap_and_incremental_assignment():
    port, ref = _engines("hamming", cache_entries=4)
    got, want = port.cluster(4, seed=0, n_iter=8), ref.cluster(4, seed=0,
                                                               n_iter=8)
    assert not got.fitted
    for lo, hi in ((0, 48), (48, 64)):
        np.testing.assert_array_equal(port.add_dense(X[lo:hi]),
                                      ref.add_dense(X[lo:hi]))
        _same_state(got, want)
    assert got.fitted and got.n_refits == 1 and got.counts.sum() == 64
    ids, lab = got.add_dense(X[64:70])
    np.testing.assert_array_equal(lab, want.add_dense(X[64:70])[1])
    np.testing.assert_array_equal(got.assign(X[64:70]), lab)
    np.testing.assert_array_equal(got.assign_packed(SK[64:70]), lab)
    np.testing.assert_array_equal(got.assign_packed(SK_T[64:70]), lab)
    assert got.assign(X[:0]).shape == (0,)
    assert got.assign_packed(SK[:0]).shape == (0,)
    assert got.label_of([]).shape == (0,)
    assert got.stats() == want.stats()


@pytest.mark.parametrize("metric", METRICS)
def test_cluster_index_follows_the_engine_metric(metric):
    port = QueryEngine(_params(), metric=metric, device="cpu")
    ci = ClusterIndex(port, 3, seed=4, n_iter=6)
    port.add_dense(X[:32])
    res = kmode.kmode_packed(SK[:32], 3, d=D, n_iter=6, seed=4,
                             metric=metric, device="cpu")
    np.testing.assert_array_equal(ci.labels()[1], res.labels)
    np.testing.assert_array_equal(ci.centers, res.centers)
    ids = port.add_dense(X[32:40])
    want, _ = allpairs.argmin_rows(SK_T[32:40], torch.from_numpy(
        res.centers), d=D, metric=metric)
    np.testing.assert_array_equal(ci.label_of(ids), want)


def test_cluster_index_remove_compact_bookkeeping():
    port, ref = _engines("hamming")
    got, want = ClusterIndex(port, 3, seed=1, n_iter=6), JaxClusterIndex(
        ref, 3, seed=1, n_iter=6)
    ids = port.add_dense(X[:40])
    ref.add_dense(X[:40])
    for e in (port, ref):
        e.remove(ids[5:15])
    _same_state(got, want)
    with pytest.raises(KeyError):
        got.label_of(ids[7])
    before = got.labels()
    port.compact()
    for a, b in zip(before, got.labels()):
        np.testing.assert_array_equal(a, b)
    assert got.counts.sum() == 30


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2**16), st.lists(st.integers(1, 14), min_size=1,
                                       max_size=5))
def test_cluster_refit_invariant_across_histories(seed, chunks):
    """Same final membership, same centres and labels after refit, whatever
    the add/remove/compact history, after a snapshot round trip, and the
    same as the JAX index's (hamming)."""
    rng = np.random.default_rng(seed)
    metric = ("cham", "hamming")[seed % 2]
    port = QueryEngine(_params(), metric=metric, device="cpu")
    ci = ClusterIndex(port, 3, seed=2, n_iter=6)
    pos = 0
    for c in chunks:
        take = X[pos: pos + c]
        if len(take) == 0:
            break
        port.add_dense(take)
        pos += len(take)
        alive = port.ids()
        if len(alive) > 3 and rng.random() < 0.6:
            kk = int(rng.integers(1, max(2, len(alive) // 3)))
            port.remove(rng.choice(alive, size=kk, replace=False))
        if rng.random() < 0.3:
            port.compact()
    survivors = port.ids()
    if len(survivors) == 0:
        return
    lab = ci.refit()
    fresh_e = QueryEngine(_params(), metric=metric, device="cpu")
    fresh = ClusterIndex(fresh_e, 3, seed=2, n_iter=6)
    fresh_e.add_dense(X[survivors])
    np.testing.assert_array_equal(lab, fresh.refit())
    np.testing.assert_array_equal(ci.centers, fresh.centers)
    np.testing.assert_array_equal(ci.counts, fresh.counts)
    if metric == "hamming":
        ref_e = JaxEngine(JP, metric=metric)
        ref = JaxClusterIndex(ref_e, 3, seed=2, n_iter=6)
        ref_e.add_dense(X[survivors])
        np.testing.assert_array_equal(lab, ref.refit())
    with tempfile.TemporaryDirectory() as td:
        ci.save(td, step=1)
        back = ClusterIndex.restore(td, device="cpu")
    np.testing.assert_array_equal(back.labels()[1], ci.labels()[1])
    np.testing.assert_array_equal(back.refit(), lab)


def test_cluster_index_refit_every_detach_and_empty_store():
    port, ref = _engines("hamming")
    got = ClusterIndex(port, 2, seed=0, n_iter=4, refit_every=10)
    want = JaxClusterIndex(ref, 2, seed=0, n_iter=4, refit_every=10)
    for lo, hi in ((0, 8), (8, 20)):
        port.add_dense(X[lo:hi])
        ref.add_dense(X[lo:hi])
        _same_state(got, want)
    assert got.n_refits == 2 and got.mutations_since_refit == 0
    for e in (port, ref):
        e.remove(e.ids())
    got.refit()
    want.refit()
    _same_state(got, want)
    assert not got.fitted and got.counts.sum() == 0
    with pytest.raises(RuntimeError, match="no centres"):
        got.assign(X[:2])
    port.add_dense(X[:6])
    assert got.fitted and got.counts.sum() == 6
    got.detach()
    n = len(got.labels()[0])
    port.add_dense(X[6:10])
    assert len(got.labels()[0]) == n
    other = port.cluster(3, seed=1, n_iter=4)
    assert len(other.labels()[0]) == 10
    for bad in (lambda: ClusterIndex(port, 0),
                lambda: ClusterIndex(port, 2, n_iter=0),
                lambda: ClusterIndex(port, 2, refit_every=0)):
        with pytest.raises(ValueError):
            bad()


def test_cluster_index_merge_equals_sequential_refit():
    x = X[:60]
    a, b, seq = (QueryEngine(_params(), metric="hamming", device="cpu")
                 for _ in range(3))
    b.store._next_id = 25
    ca, cb = a.cluster(4, seed=2), b.cluster(4, seed=2)
    a.add_dense(x[:25])
    b.add_dense(x[25:])
    ref = seq.cluster(4, seed=2)
    seq.add_dense(x)
    ref.refit()
    assert ca.merge(cb) is ca
    np.testing.assert_array_equal(ca.labels()[1], ref.labels()[1])
    np.testing.assert_array_equal(ca.centers, ref.centers)
    np.testing.assert_array_equal(ca.counts, ref.counts)
    ref_j = JaxEngine(JP, metric="hamming")
    cj = ref_j.cluster(4, seed=2)
    ref_j.add_dense(x)
    np.testing.assert_array_equal(ca.labels()[1], cj.refit())
    c = QueryEngine(_params(), device="cpu")
    c.store._next_id = 100
    c.add_dense(x[:4])
    with pytest.raises(MergeIncompatible):
        ca.merge(c.cluster(5, seed=2))
    with pytest.raises(MergeIncompatible):
        ca.merge(ca)


@pytest.mark.parametrize("metric", METRICS)
def test_cluster_index_survives_a_migration(metric):
    """At migrate_start the centres are re-sketched from the archive's raw
    rows: adds mid-migration are labelled against new-spec centres, the
    labels and counts carry over, and an auto-refit waits for the publish.
    Under hamming every step equals the JAX index's."""
    port, ref = _engines(metric)
    for e in (port, ref):  # attached after the archive holds the rows
        e.add_dense(X[:40])
    got = ClusterIndex(port, 3, seed=0, n_iter=5, refit_every=12)
    want = JaxClusterIndex(ref, 3, seed=0, n_iter=5, refit_every=12)
    for e in (port, ref):
        e.migrate(d=384, drive="manual", batch_rows=16)
    new = convert.params_from_reference(dataclasses.asdict(
        ref.migration.new_spec.params))
    assert got._centre_engine.params == new
    assert got._centre_engine.d == 384
    for e in (port, ref):
        e.migration_step()
        e.add_dense(X[40:56])  # 16 mutations: the refit waits
    assert got.n_refits == 1 and got._refit_pending
    with pytest.raises(RuntimeError, match="migration"):
        got.refit()
    from repro_torch.core.cabin import sketch_dense

    want_lab, _ = allpairs.argmin_rows(
        sketch_dense(new, torch.from_numpy(X[40:56])),
        torch.from_numpy(got.centers), d=384, metric=metric)
    np.testing.assert_array_equal(got.label_of(np.arange(40, 56)), want_lab)
    for e in (port, ref):
        e.migrate_all()
    assert got.n_refits == 2 and not got._refit_pending
    if metric == "hamming":
        _same_state(got, want)
    fresh_e = QueryEngine(new, metric=metric, device="cpu")
    fresh = fresh_e.cluster(3, seed=0, n_iter=5)
    fresh_e.add_dense(X[:56])
    np.testing.assert_array_equal(got.labels()[1], fresh.labels()[1])
    np.testing.assert_array_equal(got.centers, fresh.centers)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cluster_snapshots_cross_packages(writer):
    """The exact live state (labels assigned since the refit included)
    round-trips within the port and across the two packages, and the
    restored index keeps serving."""
    port, ref = _engines("hamming")
    got = ClusterIndex(port, 4, seed=0, n_iter=8)
    want = JaxClusterIndex(ref, 4, seed=0, n_iter=8, refit_every=50)
    got.refit_every = 50
    for e in (port, ref):
        e.add_dense(X[:50])
        e.add_dense(X[50:70])
    src = got if writer == "port" else want
    with tempfile.TemporaryDirectory() as td:
        src.save(td, step=2)
        back_port = ClusterIndex.restore(td, device="cpu")
        back_jax = JaxClusterIndex.restore(td)
    for back in (back_port, back_jax):
        _same_state(back, want)
        assert back.refit_every == 50
    ids, lab = back_port.add_dense(X[70:76])
    np.testing.assert_array_equal(lab, back_jax.add_dense(X[70:76])[1])
    np.testing.assert_array_equal(back_port.refit(), back_jax.refit())


def test_cluster_instruments_keep_the_reference_names():
    was = obs.enabled()
    obs.configure(True)
    obs.clear_trace()
    try:
        port = QueryEngine(_params(), device="cpu")
        ci = port.cluster(3, seed=0, n_iter=4)
        port.add_dense(X[:20])
        port.add_dense(X[20:30])
        ci.refit()
        prom = port.render_prom()
        assert 'engine_query_latency_ms_count{op="assign"} 1' in prom
        assert "cluster_refits_total 2" in prom
        names = {e["name"] for e in obs.trace_events()}
        assert {"cluster.refit", "cluster.assign"} <= names
    finally:
        obs.configure(was)
