"""The Mergeable contract on the PyTorch port (device="cpu": every kernel
replaced by its plain version), held against a sequential build and
against the JAX package merging the same way.

  * refusals: spec mismatch (both specs named), overlapping ids,
    self-merge, a migration in flight, differing metric or keep_raw;
    MergeIncompatible is a ValueError, and a refused merge changes nothing;
  * the store's append path (no epoch bump) and interleave path (epoch
    bump) give the JAX store's `state_tree`, array for array;
  * an engine merge equals a sequential build bit for bit (store, ids,
    topk, radius, both metrics), in any split and fold order, and equals
    the JAX engine merged the same way (integers exact, Cham within the
    parity tolerance of test_torch_parity);
  * the ``merge.combine`` crash leaves both inputs intact, and registries
    merge (counters sum, histograms union).

The helpers here are shared by the other lifecycle tests
(test_torch_shard, test_torch_migrate, test_torch_checkpoint).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_parity import (assert_cham_close, assert_ids_equal_but_ties,
                               cham_term_scale)
from tests._hyp import given, settings, st

from repro.core.cabin import CabinParams as JaxParams
from repro.index import QueryEngine as JaxEngine
from repro.index import RawArchive as JaxArchive
from repro_torch import convert, obs
from repro_torch.index import (Mergeable, MergeIncompatible, PartitionSet,
                               QueryEngine, RawArchive, SketchStore)
from repro_torch.runtime import faultinject

N_DIMS = 300
D = 128
JP = JaxParams(n_dims=N_DIMS, sketch_dim=D, psi_seed=3, pi_seed=4)
JP_OTHER = JaxParams(n_dims=N_DIMS, sketch_dim=D, psi_seed=11, pi_seed=12)
K = 5


def tparams(jp):
    return convert.params_from_reference(dataclasses.asdict(jp))


def rows(n, seed, lo=8, hi=40):
    """Dense categorical rows (n, N_DIMS), lo..hi attributes each."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, N_DIMS), np.int32)
    for r in range(n):
        cols = rng.choice(N_DIMS, size=int(rng.integers(lo, hi + 1)),
                          replace=False)
        x[r, cols] = rng.integers(1, 8, size=len(cols))
    return x


def port_engine(jp=JP, metric="cham", **kw):
    kw.setdefault("band_rows", 16)
    kw.setdefault("cache_entries", 0)
    return QueryEngine(tparams(jp), metric=metric, device="cpu", **kw)


def jax_engine(jp=JP, metric="cham", **kw):
    kw.setdefault("band_rows", 16)
    kw.setdefault("cache_entries", 0)
    return JaxEngine(jp, metric=metric, **kw)


def offset_engines(make, x, cuts):
    """One engine per slice of `x` at `cuts`, each id counter pre-offset
    as the reference's merge tree offsets its workers, so the id ranges
    are disjoint and equal to a sequential build's."""
    engines, base = [], 0
    for part in np.split(x, cuts):
        e = make()
        e.store._next_id = base
        if len(part):
            e.add_dense(part)
        base += len(part)
        engines.append(e)
    return engines


def store_arrays(x) -> dict:
    """A store's (or an engine's store's) snapshot arrays as numpy, either
    package."""
    store = getattr(x, "store", x)
    return {k: np.asarray(v) for k, v in store.state_tree().items()}


def assert_same_store(got, want):
    a, b = store_arrays(got), store_arrays(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_same_alive(got, want):
    """Same alive ids and packed rows (tombstones and slots may differ)."""
    m1, n1, i1 = got.store.gather_alive()
    m2, n2, i2 = want.store.gather_alive()
    assert n1 == n2
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(np.asarray(m1[:n1]), np.asarray(m2[:n2]))


def radius_of(eng, q, k=K):
    """A radius strictly between two of `eng`'s neighbour distances."""
    vals = np.unique(eng.topk(q, k)[1])
    if len(vals) < 2:
        return float(vals[0]) + 1.0
    return float((vals[len(vals) // 2] + vals[len(vals) // 2 + 1]) / 2)


def assert_same_answers(got, want, q, k=K, r=None):
    """Two port engines answer bit for bit: topk ids and distances, and
    radius ids."""
    r = radius_of(want, q, k) if r is None else r
    gi, gv = got.topk(q, k)
    wi, wv = want.topk(q, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)
    for a, b in zip(got.radius(q, r), want.radius(q, r)):
        np.testing.assert_array_equal(a, b)


def packed_rows(eng, ids) -> np.ndarray:
    """Host sketches of stored ids, through a port engine's store."""
    st = eng.store
    slots = np.searchsorted(st.ids_at(np.arange(st.size)), ids)
    return st.sk_buf[torch.from_numpy(np.asarray(slots))].numpy()


def assert_answers_as_jax(got, ref, q, k=K):
    """A port engine against a JAX engine of one spec: hamming exact, Cham
    within the term tolerance with ids equal but at near-ties; radius at
    a radius off every knife edge."""
    q_sk = got._sketch(q)[0].numpy()
    ri1, rv1 = ref.topk(q, k + 1)
    ri, rv = ri1[:, :k], rv1[:, :k]
    gi, gv = got.topk(q, k)
    if got.metric == "hamming":
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gv, rv)
    else:
        scale = cham_term_scale(q_sk, packed_rows(got, ri.ravel()).reshape(
            *ri.shape, -1), got.d)
        assert_cham_close(gv, rv, scale)
        assert_ids_equal_but_ties(gi, ri, rv1)
    vals = np.unique(rv1)
    r = float((vals[len(vals) // 2] + vals[len(vals) // 2 + 1]) / 2)
    for a, b in zip(got.radius(q, r), ref.radius(q, r)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def fi_clean():
    yield
    faultinject.disarm()


# ---------------------------------------------------------------------------
# the contract's surface and its refusals
# ---------------------------------------------------------------------------


def test_every_layer_is_mergeable_and_refusals_are_value_errors():
    assert issubclass(MergeIncompatible, ValueError)
    eng = port_engine()
    for thing in (eng, eng.store, eng.raw, eng.sync_layout(), eng.obs):
        assert isinstance(thing, Mergeable), type(thing)


def test_spec_mismatch_is_refused_naming_both_specs():
    a, b = port_engine(), port_engine(JP_OTHER)
    a.add_dense(rows(3, 1))
    b.store._next_id = 100
    b.add_dense(rows(3, 2))
    with pytest.raises(MergeIncompatible) as ei:
        a.merge(b)
    msg = str(ei.value)
    assert f"psi_seed={JP.psi_seed}" in msg
    assert f"psi_seed={JP_OTHER.psi_seed}" in msg
    assert "migrate" in msg
    assert len(a) == 3 and len(b) == 3
    sk = b.store.sk_buf[:2]
    with pytest.raises(MergeIncompatible, match=f"psi_seed={JP_OTHER.psi_seed}"):
        a.store.add_packed(sk, b.spec)
    assert len(a.store.add_packed(sk, None)) == 2  # spec-less: width only


def test_overlapping_ids_self_merge_and_config_mismatch_are_refused():
    x = rows(10, 3)
    a, b = port_engine(), port_engine()
    a.add_dense(x[:6])
    b.add_dense(x[4:])  # ids 0..5 on both sides
    va, vb = a.store.version, b.store.version
    with pytest.raises(MergeIncompatible, match="id-disjoint"):
        a.store.merge(b.store)
    with pytest.raises(MergeIncompatible, match="id-disjoint"):
        a.merge(b)
    with pytest.raises(MergeIncompatible, match="id-disjoint"):
        a.raw.merge(b.raw)
    assert (a.store.version, b.store.version) == (va, vb)
    assert len(a) == 6 and len(b) == 6 and len(a.raw) == 6
    for thing in (a, a.store, a.raw):
        with pytest.raises(MergeIncompatible, match="itself"):
            thing.merge(thing)
    c = port_engine(metric="hamming")
    c.store._next_id = 100
    with pytest.raises(MergeIncompatible, match="metric"):
        a.merge(c)
    with pytest.raises(MergeIncompatible, match="metric"):
        a.sync_layout().merge(c.sync_layout())
    e = port_engine(keep_raw=False)
    e.store._next_id = 100
    with pytest.raises(MergeIncompatible, match="keep_raw"):
        a.merge(e)


def test_merge_is_refused_mid_migration():
    x = rows(12, 4)
    a, b = offset_engines(port_engine, x, [8])
    a.migrate(d=2 * D, drive="manual")
    with pytest.raises(RuntimeError, match="migration"):
        a.merge(b)
    with pytest.raises(RuntimeError, match="migration"):
        b.merge(a)
    a.migrate_all()
    # drained, but `a` is now under the new spec: the same compatibility
    # check refuses it, naming the migrate fix
    with pytest.raises(MergeIncompatible, match="migrate"):
        a.merge(b)


def test_an_empty_other_is_a_validated_noop():
    a, b = offset_engines(port_engine, rows(8, 1), [8])  # b holds no row
    v = a.store.version
    a.merge(b)
    assert a.store.version == v and len(a) == 8
    assert a.store._next_id == 8  # the watermark still propagates
    assert a.obs_snapshot()["store_merges_total"] == 0
    with pytest.raises(MergeIncompatible):
        a.merge(port_engine(JP_OTHER))  # validated all the same


# ---------------------------------------------------------------------------
# the store's two paths, array for array the JAX store's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["append", "interleave"])
def test_store_merge_equals_the_jax_store(path):
    """Both packages merge the same stores (tombstones included): the
    merged state_tree, meta, epoch and merged-row events are equal."""
    x = rows(40, 7)
    cuts = [10, 25]
    tg = offset_engines(port_engine, x, cuts)
    jr = offset_engines(jax_engine, x, cuts)
    for e in (tg[1], jr[1]):
        e.remove([12, 20])
    order = [0, 2, 1] if path == "interleave" else [0, 1, 2]
    events = {"port": [], "jax": []}
    for which, engines in (("port", tg), ("jax", jr)):
        acc = engines[order[0]].store
        acc.subscribe(lambda ev, ids, slots, w=which: events[w].append(
            (ev, ids.tolist(), slots.tolist())))
        epoch = acc.epoch
        for j in order[1:]:
            acc.merge(engines[j].store)
        assert (acc.epoch - epoch) == (path == "interleave")
    got, want = tg[order[0]].store, jr[order[0]].store
    assert got.state_meta() == want.state_meta()
    assert got.removed_count == want.removed_count == 2
    assert_same_store(got, want)
    assert events["port"] == events["jax"]
    assert [e[0] for e in events["port"]] == ["merge", "merge"]


def test_raw_archive_merge_equals_the_jax_archive():
    x = rows(20, 9)
    got, want = RawArchive(), JaxArchive()
    other_got, other_want = RawArchive(), JaxArchive()
    for arc, oth in ((got, other_got), (want, other_want)):
        arc.put_dense(np.arange(0, 12), x[:12])
        oth.put_dense(np.arange(30, 38), x[12:])
        oth.drop([33])
        arc.merge(oth)
        arc.drop([4])
    a, b = got.state_tree(), want.state_tree()
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(got) == len(want) == 18
    np.testing.assert_array_equal(got.missing([4, 5, 33, 37]), [4, 33])


# ---------------------------------------------------------------------------
# engine merge == sequential build == the JAX engine merged the same way
# ---------------------------------------------------------------------------


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**16))
def test_engine_merge_equals_sequential_and_the_jax_engine(seed):
    rng = np.random.default_rng(seed)
    metric = ("cham", "hamming")[seed % 2]
    n = int(rng.integers(20, 48))
    x = rows(n, seed)
    k = int(rng.integers(2, 5))
    cuts = np.sort(rng.choice(np.arange(1, n), size=k - 1, replace=False))
    order = rng.permutation(k)
    merged = {}
    for name, make in (("port", port_engine), ("jax", jax_engine)):
        engines = offset_engines(lambda m=make: m(metric=metric), x, cuts)
        acc = engines[order[0]]
        for j in order[1:]:
            acc = acc.merge(engines[j])
        merged[name] = acc
    seq = port_engine(metric=metric)
    seq.add_dense(x)
    got = merged["port"]
    assert_same_alive(got, seq)
    np.testing.assert_array_equal(got.store.weights(), seq.store.weights())
    q = x[:4]
    assert_same_answers(got, seq, q)
    assert_same_store(got, merged["jax"])
    np.testing.assert_array_equal(got.raw.state_tree()["idx"],
                                  merged["jax"].raw.state_tree()["idx"])
    assert_answers_as_jax(got, merged["jax"], q)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_merged_engine_is_a_first_class_engine(metric):
    """add / remove / compact after a merge behave as on a sequential
    build, and the merged rows migrate like any others."""
    x = rows(40, 5)
    a, b = offset_engines(lambda: port_engine(metric=metric), x, [23])
    a.merge(b)
    seq = port_engine(metric=metric)
    seq.add_dense(x)
    for eng in (a, seq):
        eng.remove(np.array([3, 17, 29]))
        eng.add_dense(rows(6, seed=9))
        eng.compact()
        eng.add_dense(rows(3, seed=12))
    assert_same_store(a, seq)
    assert_same_answers(a, seq, x[:4])
    for eng in (a, seq):
        eng.migrate(d=2 * D, batch_rows=9, drive="eager")
    assert_same_store(a, seq)
    assert_same_answers(a, seq, x[:4])


def test_sharded_set_absorbs_an_append_merge_as_delta():
    """An in-order merge is an append (no epoch bump): each shard's base
    partition survives and the rows arrive as shard-routed delta; the
    answers equal the unsharded sequential build's bit for bit (the JAX
    package's own version of this test fails on its Cham drift)."""
    x = rows(40, 13)
    for metric in ("cham", "hamming"):
        a, b = offset_engines(
            lambda: port_engine(metric=metric, merge_ratio=None), x, [30])
        a.shard(n_shards=3)
        a.topk(x[:2], 3)  # build the sharded layout
        bases = [p for p in a._tiered.partitions() if p.kind == "sorted-banded"]
        a.merge(b)
        a.topk(x[:2], 3)  # the sync absorbs the tail
        now = [p for p in a._tiered.partitions() if p.kind == "sorted-banded"]
        assert all(p is q for p, q in zip(now, bases))
        assert a._tiered.delta_n == 10
        seq = port_engine(metric=metric, merge_ratio=None)
        seq.add_dense(x)
        assert_same_answers(a, seq, x[:5])


# ---------------------------------------------------------------------------
# crash row and registries
# ---------------------------------------------------------------------------


def test_merge_combine_crash_leaves_both_inputs_intact(fi_clean):
    assert "merge.combine" in faultinject.registered_points()
    x = rows(24, 41)
    a, b = offset_engines(port_engine, x, [15])
    va, vb = a.store.version, b.store.version
    ids_a, ids_b = a.ids().copy(), b.ids().copy()
    with faultinject.armed("merge.combine"):
        with pytest.raises(faultinject.InjectedCrash):
            a.merge(b)
    assert (a.store.version, b.store.version) == (va, vb)
    np.testing.assert_array_equal(a.ids(), ids_a)
    np.testing.assert_array_equal(b.ids(), ids_b)
    assert len(a.raw) == 15
    a.merge(b)  # re-run: nothing was half-applied
    seq = port_engine()
    seq.add_dense(x)
    assert_same_store(a, seq)
    assert_same_answers(a, seq, x[:4])


def test_registries_merge_counters_sum_and_gauges_stay_live():
    was = obs.enabled()
    obs.configure(True)
    try:
        x = rows(30, 8)
        a, b = offset_engines(lambda: port_engine(cache_entries=8), x, [18])
        for e in (a, b):
            e.topk(x[:2], 3)
            e.topk(x[:2], 3)  # a cache hit each
        b.radius(x[:2], 50.0)
        a.merge(b)
        snap = a.obs_snapshot()
        assert snap["store_rows_added_total"] == 30
        assert snap["store_merges_total"] == 1
        assert snap["engine_cache_hits_total"] == 2
        lat = snap["engine_query_latency_ms"]
        assert lat["op=topk"]["count"] == 4 and lat["op=radius"]["count"] == 1
        assert snap["engine_rows_alive"] == 30.0  # live, not frozen
        a.add_dense(rows(2, 1))
        assert a.obs_snapshot()["engine_rows_alive"] == 32.0
        assert a.stats()["cache_hits"] == 2
    finally:
        obs.configure(was)


def test_partition_set_merge_resyncs_against_the_merged_store():
    x = rows(20, 2)
    a, b = offset_engines(port_engine, x, [12])
    layout = PartitionSet(a.store, "cham", band_rows=4)
    a.store.merge(b.store)
    assert layout.merge(PartitionSet(b.store, "cham")) is layout
    assert layout.n_alive == 20
    with pytest.raises(MergeIncompatible, match="spec"):
        other = SketchStore(D, device="cpu")
        layout.merge(PartitionSet(other, "cham"))
