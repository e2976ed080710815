"""Spec migration on the PyTorch port (device="cpu"), held against the
JAX package's engine on the same history and against the port's own
fresh builds and per-tier brute force.

  * `SketchSpec` meta and `theory` equal the JAX package's;
  * `RawArchive.state_tree`, `batch` and `missing` equal the JAX archive's
    on one history (puts, dense puts, drops, a re-put, a merge, a restore);
  * a completed migration is bit-identical to a fresh build at the new
    spec, both metrics, and its store equals the JAX engine's migrated
    store array for array;
  * mid-migration topk and radius equal a per-tier brute-force scan of the
    plain versions (each tier in its own sketch space, merged by (value,
    id)) bit for bit, and the JAX engine at the same cursor;
  * auto-drift picks the JAX engine's d; `add_packed(raw=)` is archived;
    the migration gauges, counters, stats and events equal the reference's.
"""

import numpy as np
import pytest
import torch

from test_torch_merge import (JP, N_DIMS, assert_answers_as_jax,
                              assert_same_alive, assert_same_answers,
                              assert_same_store, jax_engine, port_engine,
                              rows, tparams)
from test_torch_parity import assert_ids_equal_but_ties
from tests._hyp import given, settings, st

from repro.core import theory as jtheory
from repro.core.cabin import CabinParams as JaxParams
from repro.index import RawArchive as JaxArchive
from repro.index import SketchSpec as JaxSpec
from repro_torch import obs
from repro_torch.core import theory
from repro_torch.core.cabin import sketch_dense
from repro_torch.index import RawArchive, SketchSpec, merge_topk_parts
from repro_torch.kernels.topk_select.ref import topk_select_ref

D_NEW = 256
JP_NEW = JaxParams(n_dims=N_DIMS, sketch_dim=D_NEW, psi_seed=JP.psi_seed,
                   pi_seed=JP.pi_seed)
K = 6


@pytest.fixture
def obs_on():
    was = obs.enabled()
    obs.configure(True)
    yield
    obs.configure(was)


def fresh_at_new_spec(x_by_id: dict, metric: str):
    """A port engine built at the new spec holding exactly `x_by_id`'s
    rows under their ids (add everything up to the largest id in id
    order, then remove the gaps)."""
    eng = port_engine(JP_NEW, metric=metric)
    hi = max(x_by_id) + 1
    full = np.zeros((hi, N_DIMS), np.int32)
    for i, row in x_by_id.items():
        full[i] = row
    eng.add_dense(full)
    gone = sorted(set(range(hi)) - set(x_by_id))
    if gone:
        eng.remove(np.asarray(gone, np.int64))
    return eng


def per_tier_brute_force(mig, q, k, r, metric):
    """(topk ids, dists), radius hits of the migration's three stores,
    each scanned whole by the plain top-k in its own sketch space."""
    parts, hits = [], [[] for _ in range(len(q))]
    for store, params in ((mig.src, mig.old_spec.params),
                          (mig.dst, mig.new_spec.params),
                          (mig.fresh, mig.new_spec.params)):
        mat, n, ids = store.gather_alive()
        if n == 0:
            continue
        q_sk = sketch_dense(params, torch.from_numpy(q))
        vals, pos = topk_select_ref(q_sk, mat[:n], n, d=params.sketch_dim,
                                    metric=metric)
        vals, pos = vals.numpy(), pos.numpy()
        parts.append((ids[pos[:, :k]], vals[:, :k]))
        for qi in range(len(q)):
            hits[qi].append(ids[pos[qi][vals[qi] < r]])
    total = sum(len(s) for s in (mig.src, mig.dst, mig.fresh))
    return (merge_topk_parts(min(k, total), parts),
            [np.sort(np.concatenate(h)) for h in hits])


# ---------------------------------------------------------------------------
# units: spec, theory, archive
# ---------------------------------------------------------------------------


def test_spec_meta_equals_the_jax_meta():
    spec = SketchSpec(0, tparams(JP))
    ref = JaxSpec(0, JP)
    assert spec.meta() == ref.meta()
    nxt, ref_nxt = spec.successor(tparams(JP_NEW)), ref.successor(JP_NEW)
    assert nxt.meta() == ref_nxt.meta() and nxt.version == 1
    assert SketchSpec.from_meta(ref_nxt.meta()) == nxt
    assert JaxSpec.from_meta(nxt.meta()) == ref_nxt
    bad = tparams(JaxParams(n_dims=N_DIMS + 1, sketch_dim=D_NEW,
                            psi_seed=1, pi_seed=2))
    with pytest.raises(ValueError, match="n_dims"):
        spec.successor(bad)


def test_theory_equals_the_reference():
    for s in (1, 2, 7, 64, 199, 248, 1000):
        for delta in (0.05, 0.1, 0.2):
            assert theory.sketch_dim(s, delta) == jtheory.sketch_dim(s, delta)
            assert (theory.theorem2_bound(s, delta)
                    == jtheory.theorem2_bound(s, delta))
    for d in (8, 32, 64, 256, 1024, 4096, 5588):
        assert (theory.max_density_for_dim(d)
                == jtheory.max_density_for_dim(d))
    assert theory.sketch_dim(248) == 5588


def test_raw_archive_equals_the_jax_archive_on_one_history():
    rng = np.random.default_rng(3)
    x = rows(30, 4)
    idx = rng.integers(0, N_DIMS, size=(10, 12)).astype(np.int32)
    val = rng.integers(0, 4, size=(10, 12)).astype(np.int32)  # 0 pads inside
    got, want = RawArchive(), JaxArchive()
    for arc, dense in ((got, torch.from_numpy(x[:15])), (want, x[:15])):
        arc.put(np.arange(100, 110), idx, val)
        arc.put_dense(np.arange(0, 15), dense)
        arc.put_dense(np.arange(15, 30), x[15:])
        arc.drop([3, 104, 999])
        arc.put(np.array([5]), idx[:1], val[:1])  # a re-put wins
    other_got, other_want = RawArchive(), JaxArchive()
    for arc in (other_got, other_want):
        arc.put(np.arange(200, 205), idx[:5] + 1, val[:5])
    got.merge(other_got)
    want.merge(other_want)
    a, b = got.state_tree(), want.state_tree()
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    probe = [0, 5, 29, 100, 109, 200, 204]
    for u, v in zip(got.batch(probe), want.batch(probe)):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(got.missing([3, 4, 104, 999]),
                                  want.missing([3, 4, 104, 999]))
    assert len(got) == len(want) and (5 in got) and (3 not in got)
    with pytest.raises(KeyError, match="104"):
        got.batch([1, 104])
    back = RawArchive.from_state(b)
    for k, v in back.state_tree().items():
        np.testing.assert_array_equal(v, b[k])
    assert len(RawArchive.from_state(RawArchive().state_tree())) == 0


# ---------------------------------------------------------------------------
# completed migration == fresh build == the JAX engine's
# ---------------------------------------------------------------------------


def _history(eng, x):
    ids = eng.add_dense(x[:32])
    eng.remove(ids[5:9])
    eng.compact()
    eng.migrate(d=D_NEW, batch_rows=7, drive="manual")
    mid = eng.add_dense(x[32:])  # lands in the new-spec tier
    eng.remove([int(mid[0])])


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_completed_migration_equals_a_fresh_build_and_the_jax_engine(metric):
    x = rows(40, 1)
    got, ref = port_engine(metric=metric), jax_engine(metric=metric)
    for eng in (got, ref):
        _history(eng, x)
        eng.migrate_all()
    assert not got.migrating and got.d == D_NEW and got.spec.version == 1
    fresh = fresh_at_new_spec({int(i): x[i] for i in got.ids()}, metric)
    assert_same_alive(got, fresh)
    q = rows(5, 2)
    for k in (1, 4, 50):
        assert_same_answers(got, fresh, q, k=k)
    assert_same_store(got, ref)
    assert got.store.state_meta() == ref.store.state_meta()
    assert_answers_as_jax(got, ref, q)


@settings(max_examples=4, deadline=None)
@given(st.lists(st.integers(0, 99), min_size=3, max_size=10),
       st.integers(0, 1))
def test_migration_identity_under_arbitrary_history(ops, metric_pick):
    metric = ("cham", "hamming")[metric_pick]
    rng = np.random.default_rng(sum(ops) + metric_pick)
    eng = port_engine(metric=metric)
    x_by_id: dict[int, np.ndarray] = {}
    seed = 100

    def add(n):
        nonlocal seed
        x = rows(n, seed)
        seed += 1
        for i, row in zip(eng.add_dense(x), x):
            x_by_id[int(i)] = row

    add(12)
    eng.migrate(d=D_NEW, batch_rows=3, drive="manual")
    for op in ops:
        which = op % 4
        if which == 0:
            add(int(rng.integers(1, 5)))
        elif which == 1 and len(x_by_id) > 2:
            gone = rng.choice(sorted(x_by_id), size=2, replace=False)
            eng.remove(np.sort(gone))
            for g in gone:
                del x_by_id[int(g)]
        elif which == 2:
            eng.compact()
        else:
            eng.migration_step()
    eng.migrate_all()
    fresh = fresh_at_new_spec(x_by_id, metric)
    np.testing.assert_array_equal(eng.ids(), fresh.ids())
    assert_same_answers(eng, fresh, rows(3, 99), k=5)


# ---------------------------------------------------------------------------
# mid-migration serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("n_shards", [1, 3])
def test_mid_migration_answers_equal_per_tier_brute_force(metric, n_shards):
    x = rows(36, 4)
    got, ref = port_engine(metric=metric), jax_engine(metric=metric)
    for eng in (got, ref):
        ids = eng.add_dense(x[:28])
        eng.remove(ids[2:5])
        eng.migrate(d=D_NEW, batch_rows=6, drive="manual")
        eng.migration_step()
        eng.add_dense(x[28:])
    got.shard(n_shards=n_shards)
    mig = got.migration
    assert len(mig.src) and len(mig.dst) and len(mig.fresh)
    assert mig.cursor == ref.migration.cursor
    q = rows(4, 5)
    r = 30.0 if metric == "hamming" else 45.0
    (want_ids, want_d), want_hits = per_tier_brute_force(mig, q, K, r, metric)
    gi, gd = got.topk(q, K)
    np.testing.assert_array_equal(gi, want_ids)
    np.testing.assert_array_equal(gd, want_d)
    for a, b in zip(got.radius(q, r), want_hits):
        np.testing.assert_array_equal(a, b)
    ri, rd = ref.topk(q, K)
    if metric == "hamming":
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gd, rd)
        for a, b in zip(got.radius(q, r), ref.radius(q, r)):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(gd, rd, rtol=1e-6)
        ri1, rd1 = ref.topk(q, K + 1)
        assert_ids_equal_but_ties(gi, ri, rd1)


def test_mid_migration_packed_queries_and_pairwise_are_refused():
    eng = port_engine()
    eng.add_dense(rows(10, 6))
    sk, _ = eng._sketch(rows(2, 7))
    eng.migrate(d=D_NEW, batch_rows=4, drive="manual")
    with pytest.raises(RuntimeError, match="spec-ambiguous"):
        eng.topk_packed(sk, 3)
    with pytest.raises(RuntimeError, match="spec-ambiguous"):
        eng.radius_packed(sk, 10.0)
    with pytest.raises(RuntimeError, match="mid-migration"):
        eng.pairwise(rows(2, 7))
    with pytest.raises(RuntimeError, match="raw"):
        eng.add_packed(sk)
    with pytest.raises(RuntimeError, match="already in flight"):
        eng.migrate(d=D_NEW)
    ids, dists, info = eng.topk_budgeted(rows(2, 7), 3)
    assert not info["partial"] and ids.shape == (2, 3)


def test_migration_needs_the_raw_rows_and_add_packed_raw_is_archived():
    eng = port_engine(keep_raw=False)
    eng.add_dense(rows(4, 8))
    with pytest.raises(RuntimeError, match="keep_raw"):
        eng.migrate(d=D_NEW)
    with pytest.raises(ValueError, match="keep_raw"):
        port_engine(keep_raw=False, auto_migrate=True)
    rng = np.random.default_rng(8)
    idx = rng.integers(0, N_DIMS, size=(6, 20)).astype(np.int32)
    val = rng.integers(1, 5, size=(6, 20)).astype(np.int32)
    strand = port_engine()
    sk, _ = strand._sketch((idx, val))
    strand.add_packed(sk)
    with pytest.raises(RuntimeError, match="no raw archive entry"):
        strand.migrate(d=D_NEW)
    eng = port_engine()
    eng.add_packed(sk, raw=(idx, val))
    assert len(eng.raw) == 6
    eng.migrate(d=D_NEW, drive="eager")
    seq = port_engine(JP_NEW)
    seq.add_sparse(idx, val)
    assert_same_alive(eng, seq)
    # mid-migration, add_packed with raw rows re-sketches them
    eng.migrate(d=2 * D_NEW, drive="manual")
    got = eng.add_packed(sk, raw=(idx, val))
    np.testing.assert_array_equal(got, np.arange(6, 12))
    assert len(eng.migration.fresh) == 6


def test_auto_drift_picks_the_jax_engines_dim_and_publishes():
    p_small = JaxParams(n_dims=N_DIMS, sketch_dim=32, psi_seed=JP.psi_seed,
                        pi_seed=JP.pi_seed)
    kw = dict(auto_migrate=True, drift_delta=0.2, drift_window=64,
              drift_pct=95.0)
    got, ref = port_engine(p_small, **kw), jax_engine(p_small, **kw)
    bound = theory.max_density_for_dim(32, 0.2)
    dense = rows(80, 12, lo=bound + 4, hi=bound + 8)
    for eng in (got, ref):
        eng.add_dense(dense[:64])
    assert got.migrating and ref.migrating
    target = got.migration.new_spec.d
    assert target == ref.migration.new_spec.d > 32
    for _ in range(80):
        if not got.migrating:
            break
        got.topk(dense[:1], 1)
    assert not got.migrating and got.d == target
    fresh = port_engine(JaxParams(n_dims=N_DIMS, sketch_dim=target,
                                  psi_seed=JP.psi_seed, pi_seed=JP.pi_seed))
    fresh.add_dense(dense[:64])
    assert_same_answers(got, fresh, dense[64:67], k=4)


def test_migration_gauges_counters_stats_and_events_equal_the_reference(
        obs_on):
    x = rows(30, 21)
    got, ref = port_engine(), jax_engine()
    events = {"got": [], "ref": []}
    gauges = ("engine_migration_progress", "engine_migration_cursor",
              "engine_observed_density_pct", "engine_density_dim_needed",
              "engine_rows_alive", "engine_sketch_dim")

    def reading(eng):
        snap = eng.obs_snapshot()
        out = {g: snap[g] for g in gauges}
        out["resketched"] = snap.get("migration_rows_resketched_total")
        out["phases"] = {lab: h["count"] for lab, h in snap.get(
            "migration_phase_ms", {}).items()}
        out["added"] = snap["store_rows_added_total"]
        return out

    readings = {"got": [], "ref": []}
    for name, eng in (("got", got), ("ref", ref)):
        eng.subscribe(lambda ev, ids, slots, store, n=name: events[n].append(
            (ev, ids.tolist())))
        eng.add_dense(x[:24])
        readings[name].append(reading(eng))
        eng.migrate(d=D_NEW, batch_rows=5, drive="manual")
        for step in range(7):
            eng.migration_step()
            if step == 2:
                eng.add_dense(x[24:])
                eng.remove([1, 25])
            readings[name].append(reading(eng))
            stats = eng.stats().get("migration")
            readings[name].append(stats)
    assert readings["got"] == readings["ref"]
    assert events["got"] == events["ref"]
    assert [e[0] for e in events["got"]][-1] == "migrate"
    assert 0.0 < readings["got"][1]["engine_migration_progress"] < 1.0
    assert readings["got"][-2]["engine_migration_progress"] == 1.0
    assert readings["got"][-1] is None  # published: no migration block
