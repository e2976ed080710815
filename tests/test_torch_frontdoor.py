"""repro_torch.serve.FrontDoor on the port's engine (device="cpu"): the
contracts of tests/test_frontdoor.py replayed on the port, and
`QueryEngine.topk_budgeted` held against the JAX package's.

Every ADMITTED request is answered exactly once, even when faultinject
kills a flush mid-flight; every `partial=False` answer is bit-identical to
the synchronous engine's; rejected requests carry a retry-after; bulk is
shed before interactive; deadline knife-edges (expired at admission,
expiring mid-walk, zero timeout) degrade to certified-partial answers.

Parity of `topk_budgeted` with the JAX engine, on one history:
  * deadline=None: ids and distances equal the port's `topk` bit for bit,
    and the JAX engine's `topk_budgeted`: exactly under "hamming", under
    "cham" within the parity contract (test_torch_parity: rtol 1e-6 of
    each Cham term, ids equal but at the reference's near-ties);
  * a scripted deadline that expires after 0, 1 or 2 band rounds: under
    "hamming" `partial`, `cert_gap`, ids and distances equal the JAX
    engine's exactly; under "cham" `partial` equal, `cert_gap` within
    CERT_GAP_ATOL (it is a Cham k-th value less a weight bound), ids
    equal except where two distances lie within 1 float32 ulp, and
    distances within the parity contract.

Every FrontDoor a test builds is closed when the test ends, and every
armed crash point is disarmed.  No test compares wall-clock times.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_parity import assert_cham_close, cham_term_scale
from repro.core.cabin import CabinParams as JaxParams
from repro.index import QueryEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import CabinParams
from repro_torch.index import QueryEngine
from repro_torch.runtime import faultinject
from repro_torch.serve import (CLASS_BULK, CLASS_INTERACTIVE, AdmissionQueue,
                               Deadline, FrontDoor, FrontDoorClosed,
                               RejectedError, ServiceEstimator)

N_DIMS = 400
P = CabinParams.create(N_DIMS, 256, seed=11)
# cert_gap is kth + margin - bound: a Cham value less a weight bound, so it
# carries the Cham values' f32 noise (ulps of values near 100)
CERT_GAP_ATOL = 1e-4


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, N_DIMS)) < 0.05).astype(np.int32)


def _run_threads(target, n):
    """Start n threads on target(i), join each with a timeout, and require
    that all finished."""
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


@pytest.fixture(scope="module")
def engine():
    eng = QueryEngine(P, band_rows=64, device="cpu")
    eng.add_dense(_rows(2048, 1))
    eng.compact()
    return eng


@pytest.fixture
def doors():
    """Builds front doors and closes every one at teardown, whatever the
    test did; disarms faultinject and stops hit recording."""
    made = []

    def make(eng, **kw):
        fd = FrontDoor(eng, **kw)
        made.append(fd)
        return fd

    yield make
    faultinject.disarm()
    faultinject.record_hits(False)
    faultinject.clear_hits()
    for fd in made:
        fd.close()
        assert not fd._thread.is_alive()


class GatedEngine:
    """Engine proxy whose query path blocks on a gate: makes queue buildup
    deterministic for backpressure tests."""

    def __init__(self, eng, gate):
        self._eng = eng
        self.obs = eng.obs
        self.device = eng.device
        self.gate = gate

    def topk(self, queries, k):
        self.gate.wait()
        return self._eng.topk(queries, k)

    def topk_budgeted(self, queries, k, deadline=None):
        self.gate.wait()
        return self._eng.topk_budgeted(queries, k, deadline=deadline)

    def radius(self, queries, r):
        self.gate.wait()
        return self._eng.radius(queries, r)


class CountdownDeadline:
    """Scripted deadline: `expired` flips True after `checks` reads, so a
    test places the expiry between band-walk rounds without sleeping."""

    def __init__(self, checks, remaining_s=1e-4):
        self.checks = checks
        self._rem = remaining_s

    def remaining_s(self):
        return self._rem

    @property
    def expired(self):
        self.checks -= 1
        return self.checks < 0


# ---------------------------------------------------------------------------
# deadline / estimator units
# ---------------------------------------------------------------------------


def test_deadline_clock_injection():
    t = [100.0]
    d = Deadline(timeout_ms=50.0, clock=lambda: t[0])
    assert not d.expired
    assert d.remaining_ms() == pytest.approx(50.0)
    t[0] = 100.049
    assert not d.expired
    t[0] = 100.051
    assert d.expired
    assert d.remaining_ms() < 0
    with pytest.raises(ValueError):
        Deadline()
    with pytest.raises(ValueError):
        Deadline(timeout_ms=1.0, at=1.0)
    assert Deadline(at=99.0, clock=lambda: t[0]).expired


def test_service_estimator_ewma_and_prior():
    est = ServiceEstimator(default_ms=20.0, alpha=0.5)
    assert est.estimate_ms("topk") == 20.0
    est.observe("topk", 10.0)
    assert est.estimate_ms("topk") == 10.0
    est.observe("topk", 20.0)
    assert est.estimate_ms("topk") == pytest.approx(15.0)
    assert est.estimate_ms("radius") == 20.0
    est.observe("topk", -5.0)
    assert est.estimate_ms("topk") == pytest.approx(15.0)
    with pytest.raises(ValueError):
        ServiceEstimator(default_ms=0.0)
    with pytest.raises(ValueError):
        ServiceEstimator(alpha=1.5)


# ---------------------------------------------------------------------------
# admission queue
# ---------------------------------------------------------------------------


class _FakeReq:
    def __init__(self, cls, rows=1, key=("topk", 10, "dense")):
        self.cls = cls
        self.rows = rows
        self.key = key


def test_admission_sheds_bulk_before_interactive():
    q = AdmissionQueue(interactive_limit=4, bulk_limit=4, bulk_headroom=0.5)
    q.offer(_FakeReq(CLASS_BULK))
    q.offer(_FakeReq(CLASS_INTERACTIVE))
    q.offer(_FakeReq(CLASS_INTERACTIVE))
    with pytest.raises(RejectedError) as ei:
        q.offer(_FakeReq(CLASS_BULK))
    assert ei.value.reason == "shed" and ei.value.cls == CLASS_BULK
    q.offer(_FakeReq(CLASS_INTERACTIVE))
    q.offer(_FakeReq(CLASS_INTERACTIVE))
    with pytest.raises(RejectedError) as ei:
        q.offer(_FakeReq(CLASS_INTERACTIVE))
    assert ei.value.reason == "full"
    assert q.depth(CLASS_INTERACTIVE) == 4 and q.depth(CLASS_BULK) == 1


def test_admission_bulk_full_and_retry_after_from_drain_rate():
    q = AdmissionQueue(interactive_limit=64, bulk_limit=2, bulk_headroom=1.0)
    q.offer(_FakeReq(CLASS_BULK))
    q.offer(_FakeReq(CLASS_BULK))
    with pytest.raises(RejectedError) as ei:
        q.offer(_FakeReq(CLASS_BULK))
    assert ei.value.reason == "full" and ei.value.retry_after_s > 0
    q.note_drained(10)  # 10 answered in the 5 s window: 2/s
    assert q.drain_rate() == pytest.approx(2.0)
    with pytest.raises(RejectedError) as ei:
        q.offer(_FakeReq(CLASS_BULK))
    assert ei.value.retry_after_s == pytest.approx(1.5)  # (2 + 1) / 2


def test_admission_take_group_prefers_interactive_and_coalesces():
    q = AdmissionQueue(interactive_limit=8, bulk_limit=8, bulk_headroom=1.0)
    other = ("topk", 5, "dense")
    q.offer(_FakeReq(CLASS_BULK, rows=2))
    q.offer(_FakeReq(CLASS_INTERACTIVE, rows=1))
    q.offer(_FakeReq(CLASS_INTERACTIVE, rows=1, key=other))
    q.offer(_FakeReq(CLASS_BULK, rows=3))
    group = q.take_group(max_rows=64)
    assert [g.cls for g in group] == [CLASS_INTERACTIVE, CLASS_BULK,
                                      CLASS_BULK]
    assert q.depth() == 1
    assert q.take_group(max_rows=64)[0].key == other
    q.close()
    assert q.take_group(max_rows=64) is None  # closed and drained


# ---------------------------------------------------------------------------
# front door: exactness, coalescing, deadline knife-edges
# ---------------------------------------------------------------------------


def test_concurrent_no_deadline_answers_bit_identical(engine, doors):
    batches = [_rows(3, 100 + i) for i in range(12)]
    want = [engine.topk(b, 10) for b in batches]
    results: list = [None] * len(batches)
    fd = doors(engine, max_wait_ms=1.0)

    def worker(i):
        results[i] = fd.topk(batches[i], 10)

    _run_threads(worker, len(batches))
    assert fd.double_answers == 0 and fd.answered == len(batches)
    for res, (ids, dists) in zip(results, want):
        assert res.ok and not res.partial and res.cert_gap == 0.0
        np.testing.assert_array_equal(res.ids, ids)
        np.testing.assert_array_equal(res.dists, dists)


def test_coo_requests_of_any_width_coalesce_into_one_flush(doors):
    """COO requests of widths 0, 5 and 9 (numpy and torch) share one key
    and flush as one engine call, padded with value-0 slots; each answer
    equals the engine's own on that request alone."""
    eng = QueryEngine(P, band_rows=64, device="cpu", cache_entries=0)
    rng = np.random.default_rng(3)
    eng.add_sparse(rng.integers(0, N_DIMS, (600, 12)),
                   rng.integers(0, 4, (600, 12)))
    reqs = [(np.zeros((2, 0), np.int32), np.zeros((2, 0), np.int32))]
    for m in (5, 9):
        reqs.append((rng.integers(0, N_DIMS, (3, m)),
                     rng.integers(1, 4, (3, m))))
    reqs.append(tuple(torch.from_numpy(a) for a in reqs[1]))
    want = [eng.topk(r, 4) for r in reqs]
    # the group flushes when its 11 rows have arrived, not on a timer
    fd = doors(eng, max_wait_ms=60_000.0, max_batch_rows=11)
    handles = [fd.submit("topk", r, k=4) for r in reqs]
    got = [h.result(timeout=30) for h in handles]
    assert eng.obs_snapshot()["frontdoor_flushes_total"] == 1
    for res, (ids, dists) in zip(got, want):
        assert res.ok and not res.partial
        np.testing.assert_array_equal(res.ids, ids)
        np.testing.assert_array_equal(res.dists, dists)


def test_assign_coalesces_with_top1(engine, doors):
    q = _rows(4, 7)
    ids1, d1 = engine.topk(q, 1)
    res = doors(engine).assign(q)
    assert res.ids.shape == (4,)
    np.testing.assert_array_equal(res.ids, ids1[:, 0])
    np.testing.assert_array_equal(res.dists, d1[:, 0])


def test_radius_through_front_door(engine, doors):
    q = _rows(3, 8)
    r = float(np.median(engine.topk(q, 5)[1])) + 0.5
    want = engine.radius(q, r)
    res = doors(engine).radius(q, r)
    assert res.ok and not res.partial and len(res.hits) == 3
    for got, exp in zip(res.hits, want):
        np.testing.assert_array_equal(got, exp)


def test_zero_timeout_contract_never_enqueued(engine, doors):
    fd = doors(engine)
    res = fd.submit("topk", _rows(2, 9), k=5, timeout_ms=0).result(timeout=5)
    assert res.partial and res.timed_out and res.ok
    assert res.ids.shape == (2, 0) and res.cert_gap == np.inf
    assert fd.queue.depth() == 0
    ra = fd.submit("assign", _rows(2, 9), timeout_ms=0).result(timeout=5)
    assert ra.timed_out and (ra.ids == -1).all()
    rr = fd.submit("radius", _rows(2, 9), r=1.0,
                   timeout_ms=0).result(timeout=5)
    assert rr.timed_out and [len(h) for h in rr.hits] == [0, 0]
    empty = fd.topk(np.zeros((0, N_DIMS), np.int32), 3)
    assert empty.ok and not empty.partial and empty.ids.shape == (0, 0)


def test_deadline_expiring_mid_flush_returns_certified_partial(engine,
                                                               doors):
    q = _rows(2, 10)
    fd = doors(engine, max_wait_ms=0.0)
    # one read at admission; the expiry then lands between band rounds.
    # The exact answer is computed AFTER: a budgeted query finding it in
    # the LRU would be served the exact answer
    res = fd.submit("topk", q, k=10,
                    deadline=CountdownDeadline(checks=1)).result(timeout=30)
    ids_x, d_x = engine.topk(q, 10)
    assert res.ok and res.partial and res.cert_gap > 0
    assert res.ids.shape == (2, 10)
    filled = res.ids >= 0
    assert np.all(res.dists[filled] >= d_x[filled])
    assert np.all(np.isinf(res.dists[~filled]))
    # degraded, not wrong: each returned id carries its true distance
    pos = np.searchsorted(engine.ids(), res.ids[filled])
    _, all_d = engine.pairwise(q)
    rows = np.nonzero(filled)[0]
    np.testing.assert_array_equal(all_d[rows, pos], res.dists[filled])


def test_partial_false_property_under_mixed_deadlines(engine, doors):
    """Whatever the deadline mix and thread interleaving, partial=False
    answers are bit-identical to the synchronous engine, and every request
    is answered exactly once: 40 threads, switching every 10 us."""
    pool = [_rows(2, 200 + i) for i in range(10)]
    want = [engine.topk(b, 8) for b in pool]
    rng = np.random.default_rng(0)
    jobs = [(int(rng.integers(len(pool))),
             [None, 0.0, 0.05, 50.0, None][int(rng.integers(5))])
            for _ in range(40)]
    out: list = [None] * len(jobs)
    fd = doors(engine, max_wait_ms=1.0, interactive_limit=len(jobs))

    def worker(j):
        qi, tmo = jobs[j]
        out[j] = fd.topk(pool[qi], 8, timeout_ms=tmo)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _run_threads(worker, len(jobs))
    finally:
        sys.setswitchinterval(interval)
    assert fd.double_answers == 0 and fd.answered == len(jobs)
    for j, res in enumerate(out):
        qi = jobs[j][0]
        assert res.ok
        if not res.partial:
            assert res.cert_gap == 0.0
            np.testing.assert_array_equal(res.ids, want[qi][0])
            np.testing.assert_array_equal(res.dists, want[qi][1])
        else:
            assert res.cert_gap > 0


# ---------------------------------------------------------------------------
# backpressure and shutdown
# ---------------------------------------------------------------------------


def _wait_until(cond, what):
    end = time.monotonic() + 30
    while not cond():
        assert time.monotonic() < end, what
        time.sleep(0.001)


def test_backpressure_sheds_bulk_first_through_front_door(engine, doors):
    gate = threading.Event()
    fd = doors(GatedEngine(engine, gate), interactive_limit=4, bulk_limit=4,
               bulk_headroom=0.5, max_wait_ms=0.0)
    try:
        handles = [fd.submit("topk", _rows(1, 20), k=5)]
        _wait_until(lambda: fd.queue.depth() == 0,
                    "the dispatcher never picked up")
        handles += [fd.submit("topk", _rows(1, 21 + i), k=5)
                    for i in range(4)]
        assert fd.queue.depth(CLASS_INTERACTIVE) == 4
        with pytest.raises(RejectedError) as ei:
            fd.submit("topk", _rows(1, 30), k=5, cls=CLASS_BULK)
        assert ei.value.reason == "shed"
        with pytest.raises(RejectedError) as ei:
            fd.submit("topk", _rows(1, 31), k=5)
        assert ei.value.reason == "full" and ei.value.retry_after_s > 0
        gate.set()
        for h in handles:
            assert h.result(timeout=30).ok
    finally:
        gate.set()
    snap = engine.obs_snapshot()
    assert snap["frontdoor_rejected_total"]["cls=bulk,reason=shed"] >= 1


def test_close_drains_admitted_requests(engine, doors):
    gate = threading.Event()
    fd = doors(GatedEngine(engine, gate), max_wait_ms=0.0)
    handles = [fd.submit("topk", _rows(1, 40 + i), k=3) for i in range(6)]
    closer = threading.Thread(target=fd.close)
    closer.start()
    _wait_until(lambda: not fd._running, "close never began")
    gate.set()  # release the engine AFTER close began: drain must finish
    closer.join(timeout=30)
    assert not closer.is_alive()
    for h in handles:
        assert h.result(timeout=5).ok  # drained, not dropped
    assert fd.answered == 6
    with pytest.raises((FrontDoorClosed, RejectedError)):
        fd.submit("topk", _rows(1, 50), k=3)


# ---------------------------------------------------------------------------
# chaos: crash points at enqueue / flush / publish
# ---------------------------------------------------------------------------


def test_crash_at_enqueue_is_not_an_ack(engine, doors):
    fd = doors(engine)
    with faultinject.armed("frontdoor.enqueue"):
        with pytest.raises(faultinject.InjectedCrash):
            fd.submit("topk", _rows(1, 60), k=5)
    assert fd.queue.depth() == 0 and fd.answered == 0
    res = fd.topk(_rows(1, 61), 5)
    assert res.ok and not res.partial


@pytest.mark.parametrize("point", ["frontdoor.flush", "frontdoor.publish"])
def test_crash_mid_flush_retries_exactly_once_answered(engine, doors, point):
    q = _rows(2, 70)
    want = engine.topk(q, 6)
    before = engine.obs_snapshot()
    fd = doors(engine, max_wait_ms=0.0, backoff_ms=0.1)
    faultinject.record_hits()
    faultinject.clear_hits()
    with faultinject.armed(point):
        res = fd.topk(q, 6)
    faultinject.record_hits(False)
    assert point in faultinject.hits()  # the crash actually fired
    assert res.ok and not res.partial
    np.testing.assert_array_equal(res.ids, want[0])
    np.testing.assert_array_equal(res.dists, want[1])
    assert fd.double_answers == 0 and fd.answered == 1
    snap = engine.obs_snapshot()
    for name in ("frontdoor_faults_total", "frontdoor_retries_total"):
        assert snap[name] - before.get(name, 0) == 1


def test_retries_exhausted_surface_as_error_result(engine, doors):
    class BrokenEngine:
        obs = engine.obs
        device = engine.device

        def topk(self, queries, k):
            raise RuntimeError("engine on fire")

    fd = doors(BrokenEngine(), max_retries=2, backoff_ms=0.1,
               max_wait_ms=0.0)
    res = fd.topk(_rows(1, 80), 5)
    assert not res.ok and isinstance(res.error, RuntimeError)
    assert fd.answered == 1 and fd.double_answers == 0


# ---------------------------------------------------------------------------
# topk_budgeted against the JAX package
# ---------------------------------------------------------------------------


def _coo(rng, n, m=40):
    idx = rng.integers(0, 3000, size=(n, m)).astype(np.int32)
    val = rng.integers(1, 6, size=(n, m)).astype(np.int32)
    val[np.arange(m)[None, :] >= rng.integers(6, m, size=n)[:, None]] = 0
    return idx, val


def _pair(metric):
    """The JAX engine and the port's, without result caches, over one
    history of 1,500 rows (removes, a compaction, a delta)."""
    rng = np.random.default_rng(17)
    ref = JaxEngine(JaxParams.create(3000, 256, 5), metric=metric,
                    band_rows=32, cache_entries=0, keep_raw=False)
    got = QueryEngine(
        convert.params_from_reference(dataclasses.asdict(ref.params)),
        metric=metric, band_rows=32, cache_entries=0, device="cpu")
    first, second = _coo(rng, 1400), _coo(rng, 100)
    for eng in (ref, got):
        eng.add_sparse(*first)
        eng.remove(np.arange(0, 1400, 9))
        eng.compact()
        eng.add_sparse(*second)
    return ref, got, _coo(rng, 6)


def _ulp_ties(vals, ids_a, ids_b):
    """True where ids differ and the neighbouring distances of the slot
    lie within 1 float32 ulp (the only place the id rule lets them)."""
    vals = np.asarray(vals, np.float32)
    bad = []
    for qi, j in zip(*np.nonzero(ids_a != ids_b)):
        v = vals[qi, j]
        near = [vals[qi, t] for t in (j - 1, j + 1) if 0 <= t < vals.shape[1]]
        if not any(abs(float(v) - float(u)) <= np.spacing(max(abs(v), abs(u)))
                   for u in near):
            bad.append((qi, j))
    return bad


def _check_answer(metric, got, ref, q_sk, rows_sk, d=256):
    (gi, gv, ginfo), (ri, rv, rinfo) = got, ref
    assert ginfo["partial"] == rinfo["partial"]
    if metric == "hamming":
        assert ginfo["cert_gap"] == rinfo["cert_gap"]
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gv, rv)
        return
    assert abs(ginfo["cert_gap"] - rinfo["cert_gap"]) <= CERT_GAP_ATOL
    assert not _ulp_ties(rv, gi, ri), (gi, ri)
    assert_cham_close(gv, rv, cham_term_scale(q_sk, rows_sk, d))


@pytest.mark.parametrize("metric", ["hamming", "cham"])
def test_topk_budgeted_without_deadline_equals_topk(metric):
    ref, got, q = _pair(metric)
    gi, gv, ginfo = got.topk_budgeted(q, 7)
    ti, tv = got.topk(q, 7)
    np.testing.assert_array_equal(gi, ti)
    np.testing.assert_array_equal(gv, tv)
    assert ginfo["partial"] is False and ginfo["cert_gap"] == 0.0
    ri, rv, rinfo = ref.topk_budgeted(q, 7)
    q_sk = got._sketch(q)[0].numpy()
    rows = got.store.sk_buf[np.searchsorted(got.store.ids_at(
        np.arange(got.store.size)), ri.ravel())].numpy().reshape(
            *ri.shape, -1)
    _check_answer(metric, (gi, gv, ginfo), (ri, rv, rinfo), q_sk, rows)


@pytest.mark.parametrize("checks", [0, 1, 2])
@pytest.mark.parametrize("metric", ["hamming", "cham"])
def test_topk_budgeted_under_a_scripted_deadline_equals_reference(metric,
                                                                  checks):
    ref, got, q = _pair(metric)
    r = ref.topk_budgeted(q, 7, deadline=CountdownDeadline(checks))
    g = got.topk_budgeted(q, 7, deadline=CountdownDeadline(checks))
    if checks == 0:
        assert g[2]["partial"] and g[2]["cert_gap"] > 0
    q_sk = got._sketch(q)[0].numpy()
    filled = r[0] >= 0
    rows = np.zeros((*r[0].shape, q_sk.shape[1]), np.int32)
    slots = np.searchsorted(got.store.ids_at(np.arange(got.store.size)),
                            r[0][filled])
    rows[filled] = got.store.sk_buf[slots].numpy()
    _check_answer(metric, g, r, q_sk, rows)
    # unfilled slots: id -1, distance inf, on both
    np.testing.assert_array_equal(g[0] < 0, np.isinf(g[1]))
    np.testing.assert_array_equal(g[0] < 0, r[0] < 0)
    # every returned id carries its true distance
    _, all_d = got.pairwise(q)
    pos = np.searchsorted(got.ids(), g[0][g[0] >= 0])
    np.testing.assert_array_equal(
        all_d[np.nonzero(g[0] >= 0)[0], pos], g[1][g[0] >= 0])
