"""Document ingest of the PyTorch port (device="cpu": every kernel replaced
by its plain version) against the JAX package's `repro.index.ingest` and
`merge_tree`, and the kernel loader under threads:

  * `ingest_documents` gives the JAX engine's ids, store arrays and raw
    archive, with and without in-window dedup, and honours `max_docs`;
  * `bulk_ingest` over any shard split equals the sequential ingest bit
    for bit (store, archive, ids, the watermark after it), equals the JAX
    package's `bulk_ingest`, takes empty shards, and refuses an engine
    mid-migration; `merge_tree` reduces any count of engines and records
    its spans;
  * the kernel loader: threads that build the same libraries at first use
    build each once (a fake nvcc shows the race of a shared temporary
    file), and launch counts stay exact under threads.
"""

import dataclasses
import itertools
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tests._hyp import given, settings, st

from repro.core.cabin import CabinParams as JaxParams
from repro.data.pipeline import synthetic_documents as jax_documents
from repro.index import QueryEngine as JaxEngine
from repro.index import bulk_ingest as jax_bulk_ingest
from repro.index import ingest_documents as jax_ingest_documents
from repro_torch import convert, obs
from repro_torch.data.pipeline import synthetic_documents
from repro_torch.index import (QueryEngine, bulk_ingest, ingest_documents,
                               merge_tree)
from repro_torch.kernels import build

VOCAB = 300
JP = JaxParams.create(VOCAB, 256, seed=1)
DOCS = list(itertools.islice(synthetic_documents(
    VOCAB, seed=17, mean_len=64, dup_fraction=0.3), 48))


def _params():
    return convert.params_from_reference(dataclasses.asdict(JP))


def _engine(metric="cham", **kw):
    return QueryEngine(_params(), metric=metric, band_rows=16,
                       device="cpu", **kw)


def _jax_engine(metric="cham", **kw):
    return JaxEngine(JP, metric=metric, band_rows=16, **kw)


def _arrays(engine) -> dict:
    """The store's and the archive's snapshot arrays, either package."""
    out = {f"store/{k}": np.asarray(v)
           for k, v in engine.store.state_tree().items()}
    if engine.raw is not None:
        out.update({f"raw/{k}": np.asarray(v)
                    for k, v in engine.raw.state_tree().items()})
    return out


def _assert_same_arrays(got, want):
    a, b = _arrays(got), _arrays(want)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ---------------------------------------------------------------------------
# ingest_documents
# ---------------------------------------------------------------------------


def test_documents_match_the_reference_generator():
    want = itertools.islice(jax_documents(VOCAB, seed=17, mean_len=64,
                                          dup_fraction=0.3), len(DOCS))
    for got, ref in zip(DOCS, want):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("threshold", [None, 40.5])
def test_ingest_documents_equals_reference(metric, threshold):
    got_e, want_e = _engine(metric), _jax_engine(metric)
    got = ingest_documents(got_e, DOCS, window=16, dedup_threshold=threshold)
    want = jax_ingest_documents(want_e, DOCS, window=16,
                                dedup_threshold=threshold)
    assert got.dtype == np.int64 and got.shape == (len(DOCS),)
    np.testing.assert_array_equal(got, want)
    _assert_same_arrays(got_e, want_e)
    if threshold is not None:
        assert (got == -1).any()  # the stream holds near-duplicates
        np.testing.assert_array_equal(np.sort(got[got >= 0]), got_e.ids())
    # ingested documents are served: each one's nearest row is at
    # distance 0 (itself, or an equal sketch under a lower id)
    from repro_torch.data.dedup import docs_to_categorical

    kept = np.flatnonzero(got >= 0)[:6]
    ids, dists = got_e.topk(docs_to_categorical([DOCS[i] for i in kept],
                                                VOCAB), 1)
    assert (dists[:, 0] == 0).all() and (ids[:, 0] <= got[kept]).all()


def test_ingest_documents_max_docs_and_empty_streams(monkeypatch):
    eng = _engine()
    it = iter(DOCS)
    got = ingest_documents(eng, it, window=16, max_docs=20)
    assert got.shape == (20,) and len(eng) == 20
    rest = list(it)
    assert len(rest) == len(DOCS) - 20
    np.testing.assert_array_equal(rest[0], DOCS[20])

    def boom(*a, **k):
        raise AssertionError("an empty ingest must not sketch")

    monkeypatch.setattr(eng, "_sketch", boom)
    monkeypatch.setattr(eng, "add_sparse", boom)
    for out in (ingest_documents(eng, [], window=16),
                ingest_documents(eng, iter([]), dedup_threshold=0.5)):
        assert out.dtype == np.int64 and out.shape == (0,)


def test_ingest_with_dedup_mid_migration_lands_in_the_new_tier():
    eng = _engine()
    ingest_documents(eng, DOCS[:16], window=8)
    eng.migrate(d=512, drive="manual")
    ids = ingest_documents(eng, DOCS[16:32], window=8, dedup_threshold=40.5)
    kept = ids[ids >= 0]
    assert len(kept) and all(eng.migration.fresh.contains(int(i))
                             for i in kept)
    eng.migrate_all()
    assert eng.d == 512 and set(kept.tolist()) <= set(eng.ids().tolist())


# ---------------------------------------------------------------------------
# bulk_ingest and merge_tree
# ---------------------------------------------------------------------------


@settings(max_examples=6, deadline=None)
@given(st.lists(st.integers(0, 20), min_size=1, max_size=5),
       st.integers(0, 1))
def test_bulk_ingest_equals_sequential_any_split(cut_sizes, metric_i):
    """Any split into shards (empty shards too) and any worker count give
    the sequential build's ids, store and archive, and the watermark after
    it assigns the sequential engine's next ids."""
    metric = ("cham", "hamming")[metric_i]
    cuts = np.minimum(np.cumsum(cut_sizes), len(DOCS))
    shards = [list(s) for s in np.split(np.arange(len(DOCS)), cuts)]
    shards = [[DOCS[i] for i in s] for s in shards]
    seq = _engine(metric)
    ids_seq = ingest_documents(seq, DOCS, window=8)
    par = _engine(metric)
    ids_par = bulk_ingest(par, shards, workers=1 + len(cut_sizes) % 3,
                          window=8)
    np.testing.assert_array_equal(ids_par, ids_seq)
    _assert_same_arrays(par, seq)
    more = DOCS[:5]
    np.testing.assert_array_equal(ingest_documents(par, more, window=4),
                                  ingest_documents(seq, more, window=4))
    _assert_same_arrays(par, seq)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("threshold", [None, 40.5])
def test_bulk_ingest_equals_reference(metric, threshold):
    shards = [DOCS[:7], DOCS[7:19], [], DOCS[19:26], DOCS[26:]]
    got_e, want_e = _engine(metric), _jax_engine(metric)
    if threshold is None:  # a target that holds rows already
        ingest_documents(got_e, DOCS[:3], window=4)
        jax_ingest_documents(want_e, DOCS[:3], window=4)
    got = bulk_ingest(got_e, shards, workers=3, window=8,
                      dedup_threshold=threshold)
    want = jax_bulk_ingest(want_e, shards, workers=3, window=8,
                           dedup_threshold=threshold)
    np.testing.assert_array_equal(got, want)
    _assert_same_arrays(got_e, want_e)


def test_bulk_ingest_empty_and_refusals():
    eng = _engine()
    out = bulk_ingest(eng, [[], []], workers=2)
    assert out.dtype == np.int64 and out.shape == (0,) and len(eng) == 0
    ingest_documents(eng, DOCS[:8], window=8)
    eng.migrate(d=512, drive="manual")
    with pytest.raises(RuntimeError, match="migration"):
        bulk_ingest(eng, [DOCS[:4]])
    assert len(eng) == 8
    eng.migrate_all()
    np.testing.assert_array_equal(bulk_ingest(eng, [DOCS[8:12]]),
                                  np.arange(8, 12))
    with pytest.raises(ValueError, match="no engines"):
        merge_tree([])


@pytest.mark.parametrize("n_engines", [1, 2, 3, 5])
def test_merge_tree_reduces_any_count_and_records_spans(n_engines):
    was = obs.enabled()
    obs.configure(True)
    obs.clear_trace()
    try:
        parts = np.array_split(np.arange(len(DOCS)), n_engines)
        engines, base = [], 0
        for part in parts:
            e = _engine()
            e.store._next_id = base
            ingest_documents(e, [DOCS[i] for i in part], window=8)
            engines.append(e)
            base += len(part)
        merged = merge_tree(engines, workers=2)
        seq = _engine()
        ingest_documents(seq, DOCS, window=8)
        _assert_same_arrays(merged, seq)
        bulk_ingest(_engine(), [DOCS[:5], DOCS[5:9]])
        names = [e["name"] for e in obs.trace_events()]
        assert names.count("merge_tree.level") >= (n_engines > 1)
        assert "ingest.bulk" in names
    finally:
        obs.configure(was)


# ---------------------------------------------------------------------------
# the kernel loader under threads
# ---------------------------------------------------------------------------


FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
if os.path.exists(out):
    sys.exit("another compile wrote " + out)
with open(out, "wb") as f:
    f.write(b"half")
    f.flush()
    time.sleep(0.3)
    f.write(b" a library")
"""


def test_threads_building_at_first_use_build_each_library_once(
        monkeypatch, tmp_path):
    """Four threads ask for the same two libraries at once.  The fake
    nvcc fails when its output file exists already, as it would when two
    builds share a temporary name; each library must be compiled once and
    every thread get the built paths."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    names = ("hamming", "topk_select")
    gate = threading.Barrier(4, timeout=60)

    def first_use(_):
        gate.wait()
        return build.build(names)

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(first_use, range(4), timeout=120))
    assert all(r == results[0] for r in results)
    for name in names:
        assert results[0][name].read_bytes() == b"half a library"
    calls = log.read_text().split()
    assert len(calls) == len(names)
    assert len(set(calls)) == len(names)
    assert not list((tmp_path / "build").glob("*.tmp.so"))


def test_launch_counts_are_exact_under_threads(monkeypatch):
    """More threads than cores and a short switch interval: a lost
    read-modify-write of a count would show."""
    counts = dict.fromkeys(build.LAUNCHES, 0)
    monkeypatch.setattr(build, "LAUNCHES", counts)
    threads, per = 16, 20000
    gate = threading.Barrier(threads, timeout=60)

    def launch(i):
        gate.wait()
        for _ in range(per):
            build.count_launch("pair_stats" if i % 2 else "row_popcount")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(launch, range(threads), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert counts["pair_stats"] == counts["row_popcount"] == (
        threads // 2 * per)
    build.reset_launches()
    assert set(counts.values()) == {0}
