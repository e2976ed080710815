"""repro_torch.obs and repro_torch.runtime.faultinject: the contracts of
tests/test_obs.py replayed on the port, and the port's flight recorder
held against the JAX package's.

  * instrument accuracy: pow2-bucket histogram quantiles within one bucket
    of the true order statistic, merge lossless at the bucket level,
    counters exact, readers safe under concurrent writers;
  * exporters: `render_prom()` is valid Prometheus text exposition and
    `export_trace()` loadable Chrome trace-event JSON whose spans cover the
    serving ops and whose instants mark faultinject crash points;
  * the off switch: REPRO_OBS=0 (env, in a subprocess) and
    `obs.configure(False)` hand every call site shared null instruments,
    and answers stay bit-identical;
  * faultinject: declared points, `hits()`, one arm one crash, the
    observer's instants, and `os._exit` in "exit" mode (in a subprocess
    only);
  * parity: the same history on the port's engine and the JAX package's
    (CPU) gives the same snapshot keys, less the reference's gauges whose
    state the port does not have yet, and the same counter, gauge and
    histogram counts.

No test here compares wall-clock times: histograms are held with
`observe()` values.
"""

import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.core.cabin import CabinParams as JaxParams
from repro.index import QueryEngine as JaxEngine
from repro_torch import convert, obs
from repro_torch.core import CabinParams
from repro_torch.index import QueryEngine
from repro_torch.obs.registry import Histogram, MetricsRegistry
from repro_torch.runtime import faultinject

SRC = str(Path(__file__).resolve().parents[1] / "src")
N_DIMS = 300
P = CabinParams(n_dims=N_DIMS, sketch_dim=64, psi_seed=21, pi_seed=22)

# the reference's gauge whose state the port has no counterpart of: the
# jit compile cache (the port has none)
DEFERRED_GAUGES = {"engine_compile_cache_entries"}


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, N_DIMS), np.int32)
    for r in range(n):
        cols = rng.choice(N_DIMS, size=rng.integers(8, 25), replace=False)
        x[r, cols] = rng.integers(1, 6, size=len(cols))
    return x


X = _rows(64, seed=0)
QUERIES = X[:4]


@pytest.fixture
def obs_restore():
    """Restore the port's obs switch (and the faultinject observer it
    binds) after a test that flips it."""
    was = obs.enabled()
    yield
    obs.configure(was)


@pytest.fixture
def fi_clean():
    """Leave faultinject as found: disarmed, not recording, no hits."""
    yield
    faultinject.disarm()
    faultinject.record_hits(False)
    faultinject.clear_hits()


def _same_or_adjacent_bucket(a: float, b: float) -> bool:
    return abs(math.frexp(a)[1] - math.frexp(b)[1]) <= 1


def journey(eng):
    """One serving history: adds, removes, queries, a cache hit."""
    eng.add_dense(X[:48])
    a = eng.topk(QUERIES, 5)
    r = eng.radius(QUERIES, 60.0)
    eng.remove(np.arange(5))
    b = eng.topk(QUERIES, 5)
    b2 = eng.topk(QUERIES, 5)  # LRU hit path
    eng.add_dense(X[48:])
    eng.compact()
    p = eng.pairwise(QUERIES[:2], eng.ids()[:10])
    return a, r, b, b2, p


# ---------------------------------------------------------------------------
# instrument accuracy
# ---------------------------------------------------------------------------


def test_histogram_quantiles_within_one_bucket():
    rng = np.random.default_rng(7)
    samples = rng.lognormal(mean=1.0, sigma=1.5, size=2000)
    h = Histogram()
    for v in samples:
        h.observe(float(v))
    assert h.count == len(samples)
    assert h.min == samples.min() and h.max == samples.max()
    np.testing.assert_allclose(h.sum, samples.sum(), rtol=1e-9)
    for p in (1, 25, 50, 75, 95, 99):
        want = float(np.percentile(samples, p))
        got = h.quantile(p)
        assert h.min <= got <= h.max
        assert _same_or_adjacent_bucket(got, want), (p, got, want)
    assert math.isnan(Histogram().quantile(50))
    h1 = Histogram()
    h1.observe(3.7)
    assert h1.quantile(50) == 3.7 == h1.quantile(99)


def test_histogram_merge_equals_union():
    rng = np.random.default_rng(8)
    a_s = rng.lognormal(1.0, 1.0, size=500)
    b_s = rng.lognormal(2.0, 0.5, size=700)
    ha, hb, hu = Histogram(), Histogram(), Histogram()
    for v in a_s:
        ha.observe(float(v))
        hu.observe(float(v))
    for v in b_s:
        hb.observe(float(v))
        hu.observe(float(v))
    ha.merge_from(hb)
    assert ha.count == hu.count and ha.buckets == hu.buckets
    assert ha.min == hu.min and ha.max == hu.max
    np.testing.assert_allclose(ha.sum, hu.sum, rtol=1e-9)
    for p in (10, 50, 90):
        assert ha.quantile(p) == hu.quantile(p)


def test_registry_merge_and_kind_collisions():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("reqs_total").inc(3)
    b.counter("reqs_total").inc(4)
    b.counter("other_total", shard="1").inc(2)
    a.histogram("lat_ms").observe(1.0)
    b.histogram("lat_ms").observe(9.0)
    a.merge(b)
    snap = a.snapshot()
    assert snap["reqs_total"] == 7
    assert snap["other_total"]["shard=1"] == 2
    assert snap["lat_ms"]["count"] == 2
    with pytest.raises(ValueError, match="already a Counter"):
        a.gauge("reqs_total")
    a.merge(obs.NULL_REGISTRY)
    assert a.snapshot()["reqs_total"] == 7


def test_render_prom_is_valid_exposition():
    r = MetricsRegistry()
    r.counter("engine_cache_hits_total").inc(5)
    r.gauge_fn("rows_alive", lambda: 42.0)
    h = r.histogram("lat_ms", op="topk")
    for v in (0.3, 0.9, 2.0, 2.1, 7.5):
        h.observe(v)
    lines = r.render_prom().strip().splitlines()
    assert "# TYPE engine_cache_hits_total counter" in lines
    assert "engine_cache_hits_total 5" in lines
    assert "rows_alive 42.0" in lines
    buckets = [ln for ln in lines if ln.startswith("lat_ms_bucket")]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert counts == sorted(counts)
    assert buckets[-1].startswith('lat_ms_bucket{op="topk",le="+Inf"}')
    assert counts[-1] == 5
    assert 'lat_ms_count{op="topk"} 5' in lines
    for ln in lines:
        if not ln.startswith("#"):
            float(ln.rsplit(" ", 1)[1])


def test_registry_reads_are_safe_under_concurrent_writes():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    c = reg.counter("events_total")
    n_writers, per_writer = 4, 3000
    stop = threading.Event()
    errors = []

    def writer(seed):
        for v in np.random.default_rng(seed).random(per_writer) * 1e4:
            h.observe(float(v))
            c.inc()

    def reader():
        sink = MetricsRegistry()
        while not stop.is_set():
            try:
                reg.render_prom()
                assert reg.snapshot()["lat_ms"]["count"] >= 0
                h.quantile(99)
                sink.merge(reg)
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)
                return

    writers = [threading.Thread(target=writer, args=(s,))
               for s in range(n_writers)]
    readers = [threading.Thread(target=reader) for _ in range(3)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join(timeout=120)
    stop.set()
    for t in readers:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in readers + writers)
    assert not errors, f"exporter raced a writer: {errors[:1]}"
    assert c.value == n_writers * per_writer
    buckets, count, total, mn, mx = h.state()
    assert count == n_writers * per_writer == sum(buckets.values())
    assert math.isfinite(total) and mn >= 0.0 and mx <= 1e4


def test_histogram_state_is_a_consistent_copy():
    h = Histogram()
    for v in (1.0, 3.0, 100.0):
        h.observe(v)
    buckets, count, total, mn, mx = h.state()
    assert count == 3 and total == pytest.approx(104.0)
    assert (mn, mx) == (1.0, 100.0)
    buckets[99] = 10**6
    assert h.state()[0] != buckets
    assert h.count == 3


def test_engine_latency_block_reads_its_histograms():
    """stats()["latency_ms"] and the snapshot read the same histograms;
    held with observed values, not wall-clock times."""
    eng = QueryEngine(P, device="cpu", registry=MetricsRegistry())
    assert "latency_ms" not in eng.stats()
    for v in (0.5, 1.5, 3.0, 6.0, 12.0):
        eng._h_lat["topk"].observe(v)
    eng._h_lat["radius"].observe(2.0)
    lat = eng.stats()["latency_ms"]
    assert set(lat) == {"topk", "radius"}
    snap = eng.obs_snapshot()["engine_query_latency_ms"]
    for op in lat:
        h = snap[f"op={op}"]
        assert lat[op] == {"count": h["count"], "p50": h["p50"],
                           "p95": h["p95"], "p99": h["p99"]}
    assert lat["topk"]["count"] == 5 and lat["radius"]["p50"] == 2.0
    assert 0.5 <= lat["topk"]["p50"] <= lat["topk"]["p99"] <= 12.0


# ---------------------------------------------------------------------------
# the off switch
# ---------------------------------------------------------------------------


def test_disabled_path_answers_bit_identically(obs_restore):
    obs.configure(True)
    eng_on = QueryEngine(P, cache_entries=4, device="cpu")
    assert not eng_on.obs.is_null
    on = journey(eng_on)
    assert eng_on.obs_snapshot()["engine_cache_hits_total"] == 1

    obs.configure(False)
    eng_off = QueryEngine(P, cache_entries=4, device="cpu")
    assert eng_off.obs.is_null and obs.new_registry() is obs.NULL_REGISTRY
    off = journey(eng_off)
    for got, want in zip(off, on):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (eng_off.cache_hits, eng_off.cache_misses) == \
        (eng_on.cache_hits, eng_on.cache_misses)
    assert eng_off.obs_snapshot() == {}
    assert eng_off.render_prom() == ""
    assert "latency_ms" not in eng_off.stats()
    assert "latency_ms" in eng_on.stats()
    obs.clear_trace()
    with obs.span("engine.topk"):
        obs.instant("crash_point", point="x")
    assert obs.trace_events() == []


def test_repro_obs_env_kills_the_layer_in_subprocess():
    child = (
        "import numpy as np\n"
        "from repro_torch import obs\n"
        "from repro_torch.core import CabinParams\n"
        "from repro_torch.index import QueryEngine\n"
        "from repro_torch.serve import FrontDoor\n"
        "assert not obs.enabled()\n"
        "assert obs.new_registry() is obs.NULL_REGISTRY\n"
        "p = CabinParams(n_dims=64, sketch_dim=32, psi_seed=1, pi_seed=2)\n"
        "eng = QueryEngine(p, device='cpu')\n"
        "assert eng.obs.is_null\n"
        "x = np.zeros((4, 64), np.int32)\n"
        "x[:, :5] = 1 + np.arange(5)\n"
        "eng.add_dense(x)\n"
        "eng.topk(x, 2)\n"
        "eng.compact()\n"
        "with FrontDoor(eng) as fd:\n"
        "    assert fd.topk(x, 2).ok\n"
        "assert fd.answered == 1\n"
        "assert eng.obs_snapshot() == {}\n"
        "assert 'latency_ms' not in eng.stats()\n"
        "assert obs.trace_events() == []\n"
        "print('NULLED')\n")
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_OBS="0")
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NULLED" in proc.stdout


# ---------------------------------------------------------------------------
# trace and crash points
# ---------------------------------------------------------------------------


def test_trace_is_loadable_and_covers_the_serving_ops(tmp_path, obs_restore,
                                                      fi_clean):
    obs.configure(True)
    obs.clear_trace()
    eng = QueryEngine(P, cache_entries=0, device="cpu")
    journey(eng)
    eng.topk_budgeted(QUERIES, 5)
    out = str(tmp_path / "trace.json")
    n = obs.export_trace(out)
    with open(out) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    assert len(evs) == n > 0
    names = {e["name"] for e in evs}
    assert {"engine.topk", "engine.radius", "engine.pairwise",
            "partition.merge", "store.compact", "crash_point"} <= names
    for e in evs:
        assert e["ph"] in ("X", "i")
        assert e["ts"] >= 0 and "pid" in e and "tid" in e
        if e["ph"] == "X":
            assert e["dur"] >= 0
    crossed = [e["args"]["point"] for e in evs if e["name"] == "crash_point"]
    assert crossed == ["store.compact"]
    # every partition.merge of a topk lies inside its engine.topk span
    tops = [e for e in evs if e["name"] == "engine.topk"]
    for m in (e for e in evs if e["name"] == "partition.merge"):
        assert any(t["ts"] <= m["ts"] and m["ts"] + m["dur"]
                   <= t["ts"] + t["dur"] for t in tops)
    assert obs.trace_events()
    obs.clear_trace()
    assert obs.trace_events() == []


def test_declared_points_of_the_port():
    import repro_torch.checkpoint  # noqa: F401  (declares the save path's)
    import repro_torch.serve  # noqa: F401  (declares the front door's)

    assert set(faultinject.registered_points()) == {
        "store.compact", "frontdoor.enqueue", "frontdoor.flush",
        "frontdoor.publish", "merge.combine", "shard.rebalance",
        "checkpointer.save.tmp_written", "checkpointer.save.arrays_written",
        "checkpointer.save.meta_written", "checkpointer.save.published",
        "migrate.start", "migrate.batch.resketched",
        "migrate.batch.committed", "migrate.fold", "migrate.published"}
    with pytest.raises(ValueError, match="unknown crash point"):
        faultinject.arm("heartbeat.tmp_written")
    with pytest.raises(ValueError, match="mode"):
        faultinject.arm("store.compact", mode="later")


def test_crash_at_compact_fires_once_and_changes_nothing(obs_restore,
                                                         fi_clean):
    """One arm, one crash: the compaction dies before it changes the store,
    the hit is recorded, the observer marks the crossing, and the next
    compaction runs."""
    obs.configure(True)
    obs.clear_trace()
    eng = QueryEngine(P, device="cpu")
    eng.add_dense(X[:20])
    eng.remove([3, 4])
    before = (eng.store.version, eng.store.size, eng.obs_snapshot()[
        "store_compactions_total"])
    faultinject.record_hits()
    faultinject.clear_hits()
    with faultinject.armed("store.compact"):
        with pytest.raises(faultinject.InjectedCrash) as ei:
            eng.compact()
    assert ei.value.point == "store.compact"
    assert (eng.store.version, eng.store.size, eng.obs_snapshot()[
        "store_compactions_total"]) == before
    eng.compact()  # disarmed on fire
    assert faultinject.hits() == ("store.compact", "store.compact")
    assert eng.store.size == 18
    assert eng.obs_snapshot()["store_compactions_total"] == 1
    instants = [e for e in obs.trace_events() if e["name"] == "crash_point"]
    assert [e["args"]["point"] for e in instants] == ["store.compact"] * 2
    obs.configure(False)  # no observer: crossings leave no instant
    obs.clear_trace()
    eng.compact()
    assert obs.trace_events() == []


def test_exit_mode_kills_a_child_process_only():
    """REPRO_CRASH_POINT in "exit" mode: the child dies at the point with
    EXIT_CODE and runs nothing after it."""
    child = (
        "import numpy as np\n"
        "from repro_torch.core import CabinParams\n"
        "from repro_torch.index import QueryEngine\n"
        "p = CabinParams(n_dims=64, sketch_dim=32, psi_seed=1, pi_seed=2)\n"
        "eng = QueryEngine(p, device='cpu')\n"
        "eng.add_dense(np.ones((3, 64), np.int32))\n"
        "print('BEFORE', flush=True)\n"
        "eng.compact()\n"
        "print('AFTER', flush=True)\n")
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_CRASH_POINT="store.compact",
               REPRO_CRASH_MODE="exit")
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == faultinject.EXIT_CODE, proc.stderr
    assert "BEFORE" in proc.stdout and "AFTER" not in proc.stdout


# ---------------------------------------------------------------------------
# parity with the JAX package's flight recorder
# ---------------------------------------------------------------------------


def _flat(snap: dict) -> dict:
    """name -> {label -> value}, gauges' labels by their `kind` only (the
    device label names the platform)."""
    out = {}
    for name, val in snap.items():
        if isinstance(val, dict) and "count" not in val:
            out[name] = {(lab.split("kind=")[1].split(",")[0]
                          if name == "partition_rows" else lab): v
                         for lab, v in val.items()}
        else:
            out[name] = val
    return out


@pytest.mark.parametrize("metric", ["hamming", "cham"])
def test_snapshot_parity_with_the_reference(metric, obs_restore):
    """The same history on both engines (CPU): the same metric names, less
    DEFERRED_GAUGES, and the same counter and gauge values and histogram
    counts."""
    obs.configure(True)
    ref = JaxEngine(JaxParams(n_dims=N_DIMS, sketch_dim=64, psi_seed=21,
                              pi_seed=22), metric=metric, cache_entries=4,
                    band_rows=8, keep_raw=False)
    got = QueryEngine(convert.params_from_reference(
        dict(n_dims=N_DIMS, sketch_dim=64, psi_seed=21, pi_seed=22)),
        metric=metric, cache_entries=4, band_rows=8, device="cpu")
    for eng in (ref, got):
        journey(eng)
        eng.topk_budgeted(QUERIES[1:], 3)
    rs, gs = ref.obs_snapshot(), got.obs_snapshot()
    assert DEFERRED_GAUGES <= set(rs)
    assert set(gs) == set(rs) - DEFERRED_GAUGES
    rs, gs = _flat(rs), _flat(gs)
    for name in gs:
        if name == "engine_query_latency_ms":
            assert ({op: h["count"] for op, h in gs[name].items()}
                    == {op: h["count"] for op, h in rs[name].items()}
                    == {"op=topk": 4, "op=radius": 1, "op=pairwise": 1})
        else:
            assert gs[name] == rs[name], name
    assert gs["engine_cache_hits_total"] == 1
    assert gs["index_banded_queries_total"] >= 4
    text = got.render_prom()
    assert 'engine_query_latency_ms_bucket{op="topk",le="+Inf"} 4' in text
    assert "engine_rows_alive 59.0" in text
    assert "store_rows_added_total 64" in text
