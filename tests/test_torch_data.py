"""The data substrate of the PyTorch port (device="cpu": every kernel
replaced by its plain version) against the JAX package's `repro.data`:

  * tokenizer, the synthetic Table-1 generators, `synthetic_documents`,
    `document_windows`, `docs_to_categorical` and `sketch_corpus`: equal
    bit for bit for the same seed;
  * `threshold_pairs(sorted_by_weight=True)`, the banded scan: the JAX
    package's pairs in its order, and the port's tiled scan's pair set,
    under both metrics.  Under cham the thresholds lie at least 1e-3 from
    every pair's distance: the reference decides knife-edge pairs with its
    log-free test and drifts by an ulp across graphs (ROADMAP queue C);
  * `DedupResult` of the banded, blocked and exact dedups, and the
    `BatchPipeline` batches (dedup on and off, host slices).
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allpairs as jax_allpairs
from repro.data import dedup as jax_dedup
from repro.data import pipeline as jax_pipeline
from repro.data import synthetic as jax_synthetic
from repro.data import tokenizer as jax_tokenizer
from repro_torch.core import allpairs
from repro_torch.core.cham import cham_matrix, hamming_matrix_exact
from repro_torch.data import dedup, pipeline, synthetic, tokenizer

VOCAB = 2048
D = 512
# the closest a cham threshold may lie to any pair's distance
KNIFE_EDGE = 1e-3


def _docs(n, seed, dup=0.3, vocab=VOCAB, mean_len=256):
    return list(itertools.islice(pipeline.synthetic_documents(
        vocab, seed, mean_len=mean_len, dup_fraction=dup), n))


def _sorted_sketches(n=160, seed=9, d=D):
    """Weight-sorted corpus sketches with near-duplicates, as numpy."""
    idx, val = dedup.docs_to_categorical(_docs(n, seed), VOCAB)
    _, sk = dedup.sketch_corpus(idx, val, VOCAB, d, seed=0, device="cpu")
    sk = sk.numpy()
    w = np.unpackbits(sk.view(np.uint8), axis=1).sum(1)
    return sk[np.argsort(w, kind="stable")]


def _clear_thresholds(dist: np.ndarray, candidates) -> list[float]:
    """The candidates no pair's distance meets to within KNIFE_EDGE."""
    vals = dist[np.triu_indices(len(dist), 1)]
    return [t for t in candidates
            if np.abs(vals - np.float32(t)).min() > KNIFE_EDGE]


# ---------------------------------------------------------------------------
# tokenizer, synthetic data, documents
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["", "hello", "naïve café ☕", "a\x00b" * 9])
def test_tokenizer_equals_reference(text):
    ids = tokenizer.encode(text)
    np.testing.assert_array_equal(ids, jax_tokenizer.encode(text))
    assert ids.dtype == np.int32 and tokenizer.decode(ids) == text
    for length in (3, 64):
        np.testing.assert_array_equal(
            tokenizer.pad_or_trim(ids, length),
            jax_tokenizer.pad_or_trim(ids, length))
    assert tokenizer.decode([1, 2, 0, 99999, 100]) == "a"
    assert (tokenizer.PAD_ID, tokenizer.BOS_ID, tokenizer.EOS_ID,
            tokenizer.VOCAB_MIN) == (0, 1, 2, 259)


@pytest.mark.parametrize("name", sorted(jax_synthetic.TABLE1))
def test_synthetic_samplers_equal_reference(name):
    spec = synthetic.TABLE1[name]
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jax_synthetic.TABLE1[name])
    small = synthetic.scaled_spec(spec, 0.02)
    assert dataclasses.asdict(small) == dataclasses.asdict(
        jax_synthetic.scaled_spec(jax_synthetic.TABLE1[name], 0.02))
    for centres in (0, 3):
        got = synthetic.sample_sparse(small, 24, seed=5,
                                      cluster_centers=centres)
        want = jax_synthetic.sample_sparse(small, 24, seed=5,
                                           cluster_centers=centres)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if small.n_dims <= 4096:
        x, lab = synthetic.sample_dense(small, 16, seed=2, cluster_centers=2)
        wx, wlab = jax_synthetic.sample_dense(small, 16, seed=2,
                                              cluster_centers=2)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(lab, wlab)


@pytest.mark.parametrize("dup", [0.0, 0.3])
def test_synthetic_documents_and_windows_equal_reference(dup):
    got = _docs(40, seed=3, dup=dup, vocab=300, mean_len=64)
    want = list(itertools.islice(jax_pipeline.synthetic_documents(
        300, 3, mean_len=64, dup_fraction=dup), 40))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for window in (1, 7, 40, 64):
        a = list(pipeline.document_windows(got, window))
        b = list(jax_pipeline.document_windows(want, window))
        assert [len(x) for x in a] == [len(x) for x in b]
    with pytest.raises(ValueError):
        next(pipeline.document_windows(got, 0))


def test_docs_to_categorical_and_sketch_corpus_bit_identical():
    docs = _docs(48, seed=1) + [np.zeros(0, np.int32)]
    idx, val = dedup.docs_to_categorical(docs, VOCAB)
    widx, wval = jax_dedup.docs_to_categorical(docs, VOCAB)
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(val, wval)
    assert val.max() <= 15 and not val[-1].any()
    for d in (200, 1024):
        params, sk = dedup.sketch_corpus(idx, val, VOCAB, d, seed=4,
                                         device="cpu")
        wparams, wsk = jax_dedup.sketch_corpus(idx, val, VOCAB, d, seed=4)
        assert dataclasses.asdict(params) == dataclasses.asdict(wparams)
        assert sk.device.type == "cpu" and sk.dtype == torch.int32
        np.testing.assert_array_equal(sk.numpy(), wsk)


def test_data_entry_points_refuse_cuda_where_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx, val = dedup.docs_to_categorical(_docs(4, seed=1), VOCAB)
    cfg = pipeline.PipelineConfig(vocab_size=300, seq_len=16, global_batch=2)
    for call in (lambda: dedup.sketch_corpus(idx, val, VOCAB),
                 lambda: dedup.dedup_by_sketch(np.zeros((2, 4), np.int32),
                                               128, 1.0),
                 lambda: dedup.dedup_by_sketch_blocked(
                     np.zeros((2, 4), np.int32), 128, 1.0),
                 lambda: pipeline.BatchPipeline(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------------------
# the banded threshold scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("block", [16, 64, 256])
def test_banded_threshold_pairs_equal_reference_and_tiled(metric, block):
    sk = _sorted_sketches()
    t = torch.from_numpy(sk)
    if metric == "cham":
        dist = cham_matrix(t, t, D).numpy()
        thresholds = _clear_thresholds(dist, [20.0, 60.0, 150.5, 400.25])
    else:
        dist = hamming_matrix_exact(t, t).numpy()
        thresholds = [0.5, 20.0, 60.5, 150.0]
    assert len(thresholds) >= 3
    weights = np.unpackbits(sk.view(np.uint8), axis=1).sum(1)
    for thr in thresholds:
        got = allpairs.threshold_pairs(t, d=D, threshold=thr, metric=metric,
                                       block=block, sorted_by_weight=True)
        passed = allpairs.threshold_pairs(
            t, d=D, threshold=thr, metric=metric, block=block,
            sorted_by_weight=True, weights=weights)
        want = jax_allpairs.threshold_pairs(
            jnp.asarray(sk), d=D, threshold=thr, metric=metric, block=block,
            sorted_by_weight=True)
        tiled = allpairs.threshold_pairs(t, d=D, threshold=thr,
                                         metric=metric, block=block)
        assert got.dtype == np.int32 and got.shape[1] == 2
        np.testing.assert_array_equal(got, want)  # the reference's order
        np.testing.assert_array_equal(passed, got)
        assert {tuple(p) for p in got} == {tuple(p) for p in tiled}
        assert len(got) == len(tiled)
        ii, jj = np.nonzero(np.triu(dist < np.float32(thr), 1))
        assert {tuple(p) for p in got} == set(zip(ii.tolist(), jj.tolist()))
    assert len(allpairs.threshold_pairs(
        t, d=D, threshold=max(thresholds), metric=metric, block=block,
        sorted_by_weight=True)) > 0


def test_banded_threshold_pairs_refusals_and_edges():
    sk = _sorted_sketches(n=40)
    t = torch.from_numpy(sk)
    with pytest.raises(ValueError, match="not sorted by sketch weight"):
        allpairs.threshold_pairs(t.flip(0), d=D, threshold=10.0,
                                 sorted_by_weight=True)
    with pytest.raises(ValueError, match="symmetric"):
        allpairs.threshold_pairs(t, t, d=D, threshold=10.0,
                                 sorted_by_weight=True)
    for n in (0, 1):
        out = allpairs.threshold_pairs(t[:n], d=D, threshold=1e9,
                                       sorted_by_weight=True)
        assert out.shape == (0, 2) and out.dtype == np.int32
    # a threshold past every distance: the whole upper triangle
    out = allpairs.threshold_pairs(t, d=D, threshold=1e9,
                                   sorted_by_weight=True, block=7)
    assert len(out) == 40 * 39 // 2


# ---------------------------------------------------------------------------
# dedup
# ---------------------------------------------------------------------------


def _same_result(a, b):
    np.testing.assert_array_equal(a.keep_mask, b.keep_mask)
    np.testing.assert_array_equal(a.group_ids, b.group_ids)
    assert (a.n_groups, a.n_removed) == (b.n_groups, b.n_removed)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_dedup_by_sketch_equals_reference(metric):
    docs = _docs(120, seed=9)
    idx, val = dedup.docs_to_categorical(docs, VOCAB)
    _, sk = dedup.sketch_corpus(idx, val, VOCAB, D, seed=0, device="cpu")
    if metric == "cham":
        dist = cham_matrix(sk, sk, D).numpy()
        thresholds = _clear_thresholds(dist, [10.0, 30.0, 90.5])
    else:
        thresholds = [10.5, 30.0, 90.5]
    for thr in thresholds:
        got = dedup.dedup_by_sketch(sk, D, thr, metric=metric, device="cpu")
        want = jax_dedup.dedup_by_sketch(sk.numpy(), D, thr, metric=metric)
        _same_result(got, want)
        if metric == "cham":
            _same_result(dedup.dedup_by_sketch_blocked(
                sk, D, thr, block=32, device="cpu"), got)
            _same_result(got, jax_dedup.dedup_by_sketch_blocked(
                sk.numpy(), D, thr, block=32))
    assert got.n_removed > 10  # the stream holds near-duplicates
    empty = dedup.dedup_by_sketch(sk[:0], D, 1.0, device="cpu")
    assert empty.n_groups == 0 and empty.keep_mask.shape == (0,)


def test_dedup_exact_and_components_equal_reference():
    docs = _docs(40, seed=4)
    idx, val = dedup.docs_to_categorical(docs, VOCAB)
    for thr in (5.0, 40.0):
        _same_result(dedup.dedup_exact(idx, val, VOCAB, thr),
                     jax_dedup.dedup_exact(idx, val, VOCAB, thr))
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 50, size=(60, 2))
    np.testing.assert_array_equal(
        dedup._components_from_pairs(50, pairs),
        jax_dedup._components_from_pairs(50, pairs))
    uf = dedup._UnionFind(50)
    for i, j in pairs.tolist():
        uf.union(i, j)
    np.testing.assert_array_equal(
        [uf.find(i) for i in range(50)],
        dedup._components_from_pairs(50, pairs))


# ---------------------------------------------------------------------------
# the batch pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dedup_on", [False, True])
@pytest.mark.parametrize("host", [(1, 0), (2, 0), (2, 1)])
def test_batch_pipeline_equals_reference(dedup_on, host):
    n_hosts, host_index = host
    kw = dict(vocab_size=VOCAB, seq_len=64, global_batch=4, seed=7,
              dedup=dedup_on, dedup_sketch_dim=256, dedup_window=64,
              n_hosts=n_hosts, host_index=host_index)
    got_p = pipeline.BatchPipeline(pipeline.PipelineConfig(**kw),
                                   device="cpu")
    want_p = jax_pipeline.BatchPipeline(jax_pipeline.PipelineConfig(**kw))
    try:
        for _ in range(3):
            got, want = next(got_p), next(want_p)
            assert got.keys() == want.keys()
            for key in got:
                assert got[key].shape == (4 // n_hosts, 64)
                np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(got["tokens"][:, 1:],
                                          got["labels"][:, :-1])
    finally:
        got_p.close()
        want_p.close()
    with pytest.raises(ValueError, match="divide"):
        pipeline.BatchPipeline(pipeline.PipelineConfig(
            vocab_size=VOCAB, seq_len=8, global_batch=3, n_hosts=2),
            device="cpu")
