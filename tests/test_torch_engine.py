"""repro_torch's QueryEngine (device="cpu": every kernel replaced by its
plain version) vs the JAX package's QueryEngine, replaying one mutation /
query history on both.

  * "hamming": ids and distances exact.
  * "cham": integer statistics exact (the sketches and ids are), distances
    at rtol 1e-6 of their terms, ids equal except at the reference's own
    near-ties (see test_torch_parity).
Inside the port, Cham is one function of the integer statistics, so topk,
radius and pairwise give bit-identical distances for the same pair.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

from test_torch_parity import (assert_cham_close, assert_ids_equal_but_ties,
                           cham_term_scale)
from repro.index import QueryEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import packing
from repro_torch.index import MergeIncompatible, PartitionSet, QueryEngine
from repro_torch.index.partition import topk_across_tiers
from repro_torch.kernels.topk_select.ref import topk_select_ref

jcabin = importlib.import_module("repro.core.cabin")
tcabin = importlib.import_module("repro_torch.core.cabin")

N_DIMS = 3000
M = 48
K = 5


def _coo(rng, n):
    idx = rng.integers(0, N_DIMS, size=(n, M)).astype(np.int32)
    val = rng.integers(1, 6, size=(n, M)).astype(np.int32)
    nnz = rng.integers(8, M, size=n)
    val[np.arange(M)[None, :] >= nnz[:, None]] = 0
    return idx, val


def _engines(metric, d, seed=1):
    ref = JaxEngine(jcabin.CabinParams.create(N_DIMS, d, seed), metric=metric,
                    band_rows=64)
    got = QueryEngine(
        convert.params_from_reference(dataclasses.asdict(ref.params)),
        metric=metric, band_rows=64, device="cpu")
    return ref, got


def _packed(engine, ids):
    """Host sketches of stored ids, through the engine's own store."""
    st = engine.store
    slots = np.searchsorted(st.ids_at(np.arange(st.size)), ids)
    return np.asarray(st.sk_buf[slots] if isinstance(st.sk_buf, torch.Tensor)
                      else np.asarray(st.sk_buf)[slots])


def _check_topk(ref, queries, gi, gv, q_sk, got, metric, d):
    """The port's top-K against the reference's: one reference call at
    K + 1, whose first K columns are its top-K (lexicographic order), and
    whose last column judges near-ties across the K-th place."""
    ri1, rv1 = ref.topk(queries, K + 1)
    ri, rv = ri1[:, :K], rv1[:, :K]
    if metric == "hamming":
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gv, rv)
    else:
        rows = _packed(got, ri.ravel()).reshape(*ri.shape, -1)
        assert_cham_close(gv, rv, cham_term_scale(q_sk, rows, d))
        assert_ids_equal_but_ties(gi, ri, rv1)
    return rv1


def _check_queries(ref, got, queries, metric, d):
    q_sk = got._sketch(queries)[0].numpy()
    np.testing.assert_array_equal(q_sk, np.asarray(ref._sketch(queries)[0])
                                  [: len(q_sk)])
    gi, gv = got.topk(queries, K)
    rv1 = _check_topk(ref, queries, gi, gv, q_sk, got, metric, d)

    # radius strictly between two distances: no pair on the knife edge
    vals = np.unique(rv1)
    r = float((vals[len(vals) // 2] + vals[len(vals) // 2 + 1]) / 2)
    for a, b in zip(got.radius(queries, r), ref.radius(queries, r)):
        np.testing.assert_array_equal(a, b)

    ids = ref.ids()[::3]
    rp_ids, rp = ref.pairwise(queries, ids)
    gp_ids, gp = got.pairwise(queries, ids)
    np.testing.assert_array_equal(gp_ids, rp_ids)
    if metric == "hamming":
        np.testing.assert_array_equal(gp, rp)
    else:
        assert_cham_close(gp, rp, cham_term_scale(q_sk, _packed(got, ids), d))
    # one Cham table: topk distances equal the pairwise entries bit for bit
    _, all_p = got.pairwise(queries)
    pos = np.searchsorted(got.ids(), gi)
    np.testing.assert_array_equal(np.take_along_axis(all_p, pos, axis=1), gv)


@pytest.mark.parametrize("metric", ["hamming", "cham"])
@pytest.mark.parametrize("d", [200, 256])
def test_engine_replays_reference_history(metric, d):
    rng = np.random.default_rng(d)
    ref, got = _engines(metric, d)
    queries = _coo(rng, 7)
    for step in range(4):
        batch = _coo(rng, 150)
        np.testing.assert_array_equal(got.add_sparse(*batch),
                                      ref.add_sparse(*batch))
        if step % 2:
            kill = rng.choice(ref.ids(), 25, replace=False)
            assert got.remove(kill) == ref.remove(kill)
        if step == 2:
            ref.compact()
            got.compact()
        if step != 1:
            _check_queries(ref, got, queries, metric, d)
    np.testing.assert_array_equal(got.ids(), ref.ids())
    assert len(got) == len(ref) == 550
    rs, gs = ref.stats(), got.stats()
    for key in ("n_alive", "size", "capacity", "version", "n_bands",
                "base_rows", "base_alive", "delta_rows", "tier_merges"):
        assert gs[key] == rs[key], key


@pytest.mark.parametrize("metric", ["hamming", "cham"])
def test_store_carried_across_from_reference(metric):
    """A JAX store's arrays (tombstones included) loaded through
    convert.store_from_reference answer like the JAX engine."""
    d = 200
    rng = np.random.default_rng(5)
    ref, got = _engines(metric, d, seed=4)
    ref.add_sparse(*_coo(rng, 300))
    ref.remove(rng.choice(ref.ids(), 40, replace=False))
    tree = ref.store.state_tree()
    got.store = convert.store_from_reference(
        tree["sk"], tree["ids"], tree["alive"], d, device="cpu",
        params=got.params)
    np.testing.assert_array_equal(got.store.weights(), ref.store.weights())
    queries = _coo(rng, 6)
    gi, gv = got.topk(queries, K)
    _check_topk(ref, queries, gi, gv, got._sketch(queries)[0].numpy(), got,
                metric, d)


def test_packed_queries_answer_like_raw_queries():
    rng = np.random.default_rng(3)
    _, got = _engines("cham", 256)
    got.add_sparse(*_coo(rng, 200))
    queries = _coo(rng, 5)
    sk = got._sketch(queries)[0]
    for a, b in zip(got.topk(queries, K), got.topk_packed(sk, K)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.radius(queries, 300.0),
                    got.radius_packed(sk, 300.0)):
        np.testing.assert_array_equal(a, b)
    assert got.stats()["cache_hits"] == 2  # the second calls hit the LRU


@pytest.mark.parametrize("metric", ["hamming", "cham"])
def test_add_packed_takes_the_reference_signature(metric):
    """add_packed(packed, raw=None, spec=None), as the JAX package's: a
    positional second argument is `raw`, and rows ingested either way
    answer as the same rows ingested by add_sparse."""
    assert (list(inspect.signature(QueryEngine.add_packed).parameters)
            == list(inspect.signature(JaxEngine.add_packed).parameters))
    rng = np.random.default_rng(8)
    engines = [_engines(metric, 256)[1] for _ in range(3)]
    idx, val = _coo(rng, 150)
    sk = engines[0]._sketch((idx, val))[0]
    ids = [engines[0].add_sparse(idx, val),
           engines[1].add_packed(sk, None, engines[1].spec),
           engines[2].add_packed(sk, raw=(idx, val))]
    queries = _coo(rng, 6)
    want = engines[0].topk(queries, K)
    r = float(np.median(want[1][:, -1]))
    for e, got_ids in zip(engines[1:], ids[1:]):
        np.testing.assert_array_equal(got_ids, ids[0])
        for a, b in zip(e.topk(queries, K), want):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(e.radius(queries, r), engines[0].radius(queries, r)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(MergeIncompatible, match="incompatible sketch specs"):
        engines[1].add_packed(sk, None, dataclasses.replace(
            engines[1].spec, version=1))


def test_topk_across_tiers_equals_one_scan_of_the_union():
    """Two partition sets over disjoint id ranges, merged with the running
    k-th bound, answer like one brute-force scan over both."""
    d = 256
    rng = np.random.default_rng(8)
    p = tcabin.CabinParams.create(N_DIMS, d, seed=2)
    sk = [tcabin.sketch_sparse(p, *map(torch.from_numpy, _coo(rng, n))).numpy()
          for n in (180, 90)]
    stores = [convert.store_from_reference(
        s, np.arange(len(s)) + off, np.ones(len(s), bool), d, device="cpu")
        for s, off in zip(sk, (0, 1000))]
    q = tcabin.sketch_sparse(p, *map(torch.from_numpy, _coo(rng, 6)))
    qw = packing.np_popcount_rows(q.numpy())
    for metric in ("cham", "hamming"):
        tiers = [(PartitionSet(st, metric, band_rows=32), q, qw)
                 for st in stores]
        ids, vals = topk_across_tiers(K, tiers, q_valid=6)
        union = torch.from_numpy(np.concatenate(sk))
        union_ids = np.concatenate([np.arange(180), np.arange(90) + 1000])
        bv, bpos = topk_select_ref(q, union, K, d=d, metric=metric)
        np.testing.assert_array_equal(ids, union_ids[bpos.numpy()])
        np.testing.assert_array_equal(vals, bv.numpy())


def test_dense_ingest_matches_sparse_ingest():
    rng = np.random.default_rng(2)
    idx, val = _coo(rng, 40)
    x = np.zeros((40, N_DIMS), np.int32)
    for i in range(40):  # later duplicate attributes win, as in the COO OR
        live = val[i] != 0
        x[i, idx[i, live]] = val[i, live]
    _, a = _engines("hamming", 256)
    _, b = _engines("hamming", 256)
    dedup = np.array([len(np.unique(r[v != 0])) == np.count_nonzero(v)
                      for r, v in zip(idx, val)])
    a.add_sparse(idx[dedup], val[dedup])
    b.add_dense(x[dedup])
    np.testing.assert_array_equal(a.store.sk_buf, b.store.sk_buf)


def test_inputs_are_validated_before_any_cast():
    rng = np.random.default_rng(4)
    _, got = _engines("hamming", 256)
    idx, val = _coo(rng, 3)
    wide = idx.astype(np.int64)
    wide[0, 0] = 2**32 + 5  # would wrap to 5 in int32
    with pytest.raises(ValueError, match="out of range"):
        got.add_sparse(wide, val)
    with pytest.raises(ValueError, match="matching"):
        got.add_sparse(idx, val[:, :-1])
    packed = got._sketch((idx, val))[0]
    with pytest.raises(TypeError, match="int32"):
        got.add_packed(packed.to(torch.int64))
    with pytest.raises(TypeError, match="int32"):
        got.topk_packed(packed.to(torch.int64), K)
    assert len(got.add_packed(packed)) == 3 and len(got) == 3


@pytest.mark.parametrize("metric", ["hamming", "cham"])
def test_coo_batches_of_width_zero_answer_as_the_reference(metric):
    """A COO batch of width 0 (rows with no attribute) is padded to the
    reference engine's smallest width bucket: it ingests as all-zero
    sketches with the next ids, and queries of width 0 answer as the
    reference's, through topk, radius and pairwise."""
    d = 256
    rng = np.random.default_rng(11)
    ref, got = _engines(metric, d)
    empty = (np.zeros((2, 0), np.int32), np.zeros((2, 0), np.int32))
    none = (np.zeros((0, 0), np.int32), np.zeros((0, 0), np.int32))
    for batch in (_coo(rng, 200), empty, none, _coo(rng, 40)):
        np.testing.assert_array_equal(got.add_sparse(*batch),
                                      ref.add_sparse(*batch))
    ids = ref.ids()
    np.testing.assert_array_equal(got.ids(), ids)
    np.testing.assert_array_equal(_packed(got, ids), _packed(ref, ids))
    assert not _packed(got, ids[200:202]).any()
    zero_q = (np.zeros((3, 0), np.int32), np.zeros((3, 0), np.int32))
    _check_queries(ref, got, zero_q, metric, d)
    assert (got.topk(zero_q, 2)[0] == [200, 201]).all()
    _check_queries(ref, got, _coo(rng, 5), metric, d)


@pytest.mark.parametrize("name", ["cluster"])
def test_methods_of_later_slices_raise_not_implemented(name):
    _, got = _engines("cham", 200)
    with pytest.raises(NotImplementedError, match="slice"):
        getattr(got, name)()
