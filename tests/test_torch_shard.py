"""Sharded serving on the PyTorch port (device="cpu"): a PartitionSet of
`n_shards` (base, delta) groups, rows routed by ``id % n_shards``.

  * `shard_of` and `SketchStore.route_slots` partition the alive set;
  * answers at n_shards in {1, 2, 3, 8} are bit-identical to the
    unsharded engine's under random mutation histories, both metrics (the
    JAX package's own sharded Cham drifts by an ulp across graphs, so the
    port is held to its own unsharded answers, and to the JAX sharded
    engine under "hamming");
  * a fold is shard-local, a re-shard changes the topology but not the
    answers, the ``shard.rebalance`` crash is retryable;
  * `stats()["n_shards"]`, `engine_shards` and one `partition_rows` label
    set per shard; `shard(mesh=...)` raises NotImplementedError.
"""

import numpy as np
import pytest

from test_torch_merge import (assert_same_answers, jax_engine, port_engine,
                              rows)
from tests._hyp import given, settings, st

from repro_torch import obs
from repro_torch.core.packing import np_popcount_rows
from repro_torch.index import PartitionSet
from repro_torch.index.partition import shard_of
from repro_torch.runtime import faultinject
from repro_torch.serve import Deadline

SHARDS = (1, 2, 3, 8)


@pytest.fixture
def fi_clean():
    yield
    faultinject.disarm()


@pytest.fixture
def obs_on():
    was = obs.enabled()
    obs.configure(True)
    yield
    obs.configure(was)


def test_shard_of_and_route_slots_partition_the_alive_set():
    eng = port_engine()
    eng.add_dense(rows(50, 1))
    eng.remove(np.arange(3, 50, 7))
    store = eng.store
    slots = store.alive_slots()
    for n in (1, 2, 3, 5, 8):
        parts = store.route_slots(slots, n)
        assert len(parts) == n
        np.testing.assert_array_equal(np.sort(np.concatenate(parts)), slots)
        for s, part in enumerate(parts):
            assert (np.diff(part) > 0).all()
            assert (shard_of(store.ids_at(part), n) == s).all()
    np.testing.assert_array_equal(shard_of(np.arange(10), 4),
                                  np.arange(10) % 4)


@settings(max_examples=4, deadline=None)
@given(st.lists(st.integers(0, 99), min_size=4, max_size=12),
       st.integers(0, 1))
def test_sharded_answers_bit_identical_to_unsharded(ops, metric_pick):
    """One random history of adds, removes, compactions and queries on an
    unsharded engine and on one engine per shard count: every answer
    equal bit for bit."""
    metric = ("cham", "hamming")[metric_pick]
    rng = np.random.default_rng(sum(ops) + metric_pick)
    plain = port_engine(metric=metric, merge_ratio=0.25)
    sharded = []
    for n in SHARDS:
        e = port_engine(metric=metric, merge_ratio=0.25)
        e.shard(n_shards=n)
        sharded.append(e)
    engines = [plain] + sharded
    seed = 100
    for e in engines:
        e.add_dense(rows(24, seed))
    q = rows(4, 7)
    for op in ops:
        which = op % 4
        if which == 0:
            seed += 1
            x = rows(int(rng.integers(1, 9)), seed)
            for e in engines:
                e.add_dense(x)
        elif which == 1 and len(plain) > 6:
            gone = rng.choice(plain.ids(), size=3, replace=False)
            for e in engines:
                e.remove(gone)
        elif which == 2:
            for e in engines:
                e.compact()
        else:
            for e in sharded:
                assert_same_answers(e, plain, q)
    for e, n in zip(sharded, SHARDS):
        assert e.stats()["n_shards"] == n
        assert_same_answers(e, plain, q, k=len(plain) + 3)


def test_fold_is_shard_local():
    """Tombstones in one shard trip that shard's fold alone: the other
    shards keep their base partitions (the same objects)."""
    eng = port_engine(merge_ratio=0.5)
    eng.add_dense(rows(64, 3))
    eng.shard(n_shards=4)
    q = rows(3, 4)
    eng.topk(q, 5)
    before = [g.base for g in eng._tiered._groups]
    merges = eng._tiered.n_merges
    eng.remove(np.arange(1, 64, 4)[:12])  # 12 of shard 1's 16 rows
    eng.topk(q, 5)
    after = [g.base for g in eng._tiered._groups]
    assert after[1] is not before[1]
    assert all(after[s] is before[s] for s in (0, 2, 3))
    assert eng._tiered.n_merges == merges + 1
    plain = port_engine(merge_ratio=0.5)
    plain.add_dense(rows(64, 3))
    plain.remove(np.arange(1, 64, 4)[:12])
    assert_same_answers(eng, plain, q)


def test_reshard_changes_topology_not_answers(obs_on):
    eng = port_engine(metric="hamming")
    eng.add_dense(rows(60, 5))
    q = rows(4, 6)
    want = eng.topk(q, 6)
    for n in (2, 5, 1, 3):
        eng.shard(n_shards=n)
        got = eng.topk(q, 6)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert eng.stats()["n_shards"] == n
        snap = eng.obs_snapshot()
        assert snap["engine_shards"] == float(n)
        labels = [lab for lab in snap["partition_rows"]
                  if "role=serve" in lab and "kind=sorted-banded" in lab]
        assert len(labels) >= n
        assert sum(snap["partition_rows"][f"device=cpu,kind={kind},role="
                                          f"serve,shard={s}"]
                   for s in range(n)
                   for kind in ("sorted-banded", "brute-delta")) == 60.0
        assert len(eng._tiered.partitions()) == 2 * n


def test_shard_rebalance_crash_is_retryable(fi_clean):
    """The rebuild crosses `shard.rebalance` before it replaces a group:
    a crash there leaves the engine serving, and the retry answers as the
    unsharded engine."""
    assert "shard.rebalance" in faultinject.registered_points()
    for metric in ("cham", "hamming"):
        eng = port_engine(metric=metric)
        eng.add_dense(rows(30, 8))
        q = rows(3, 9)
        want = eng.topk(q, 5)
        eng.shard(n_shards=4)
        with faultinject.armed("shard.rebalance"):
            with pytest.raises(faultinject.InjectedCrash):
                eng.topk(q, 5)
        got = eng.topk(q, 5)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        plain = port_engine(metric=metric)
        plain.add_dense(rows(30, 8))
        assert_same_answers(eng, plain, q)


def test_shard_takes_a_count_and_refuses_a_mesh():
    eng = port_engine()
    with pytest.raises(NotImplementedError, match="A10f"):
        eng.shard(object())
    with pytest.raises(ValueError, match="n_shards"):
        eng.shard()
    with pytest.raises(ValueError, match=">= 1"):
        eng.shard(n_shards=0)
    with pytest.raises(ValueError, match=">= 1"):
        PartitionSet(eng.store, "cham", n_shards=0)
    with pytest.raises(AttributeError, match="partitions"):
        eng.shard(n_shards=2)
        eng.sync_layout().base


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_hamming_equals_the_jax_sharded_engine(n):
    x = rows(48, 11)
    ref = jax_engine(metric="hamming")
    got = port_engine(metric="hamming")
    for e in (ref, got):
        e.add_dense(x)
        e.remove(np.arange(0, 48, 5))
        e.shard(n_shards=n)
    q = rows(5, 12)
    for a, b in zip(got.topk(q, 7), ref.topk(q, 7)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.radius(q, 60.0), ref.radius(q, 60.0)):
        np.testing.assert_array_equal(a, b)
    assert got.stats()["n_shards"] == ref.stats()["n_shards"] == n


def test_sharded_deadlines_and_a_direct_partition_set():
    """Budgets reach every shard's walk, and a PartitionSet built directly
    over the store serves every shard on the store's device, answers
    unchanged."""
    eng = port_engine(band_rows=4)
    eng.add_dense(rows(80, 13))
    q = rows(4, 14)
    want = eng.topk(q, 5)
    eng.shard(n_shards=3)
    ids, dists, info = eng.topk_budgeted(q, 5,
                                         deadline=Deadline(timeout_ms=1e9))
    assert not info["partial"]
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dists, want[1])
    ids, dists, info = eng.topk_budgeted(q, 5, deadline=Deadline(timeout_ms=0))
    assert info["partial"] and info["cert_gap"] > 0
    assert np.array_equal(ids < 0, np.isinf(dists))
    layout = PartitionSet(eng.store, "cham", band_rows=4, n_shards=3)
    assert [p.matrix.device.type for p in layout.partitions()
            if p.n_rows] == ["cpu"] * 3
    q_sk = eng._sketch(q)[0]
    got = layout.topk(q_sk, np_popcount_rows(q_sk.numpy()), 5, q_valid=4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
