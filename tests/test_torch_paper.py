"""The paper's experiments on the PyTorch port (device="cpu": every kernel
replaced by its plain version) against the JAX package, on the same numpy
inputs.

Held bit for bit: the hashes `uniform01` / `rademacher` (uint32 wraparound
included), the packing helpers, the four baseline sketches and their
sketches' pairwise Hamming distances, the obs-free `binhamming` (which is
the Cham table path), the generator's dense rows, the exact distance
matrix and k-mode labels (integer work).  Float estimators and the
miss-masked `binhamming`: rtol = atol = 1e-5 (both packages evaluate the
same float32 formula; the port reads a_hat, b_hat and u_hat from its Cham
table, which is that formula evaluated once per count).  purity / NMI /
ARI: 1e-12.  Each figure function at a small scale and a fixed seed: its
RMSE / MAE against the reference's methods on the same rows (built here
from `repro.core` as `benchmarks/common.py` builds them), rtol 1e-4.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import hashing as jhash
from repro.core import metrics as jmetrics
from repro.core import packing as jpack
from repro.core.cabin import CabinParams as JParams
from repro.core.cabin import binem as jbinem
from repro.core.cabin import sketch_dense as jsketch_dense
from repro.core.kmode import kmode as jkmode
from repro.core.theory import sketch_dim, theorem2_bound
from repro.data.synthetic import TABLE1, sample_dense, scaled_spec
import repro_torch.core as tcore
from repro_torch.core import baselines as TB
from repro_torch.core import hashing as thash
from repro_torch.core import metrics as tmetrics
from repro_torch.core import packing as tpack
from repro_torch.core.kmode import kmode as tkmode
from repro_torch.experiments import paper as P

# `repro.core.cham` and its port are shadowed by their packages' `cham`
# functions, so they are taken from the import system by name
jcham = importlib.import_module("repro.core.cham")
tcham = importlib.import_module("repro_torch.core.cham")
RTOL = ATOL = 1e-5
FIG_RTOL = 1e-4
BRAINCELL_N = TABLE1["braincell"].n_dims  # 1,306,127


def _u32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["uniform01", "rademacher"])
@pytest.mark.parametrize("seed", [0, 505, 911, 2**32 - 1])
def test_hashes_bit_identical_on_any_uint32(fn, seed):
    rng = np.random.default_rng(seed % 1000)
    x = np.concatenate([
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)])
    want = np.asarray(getattr(jhash, fn)(jnp.asarray(x), seed))
    got = getattr(thash, fn)(_u32(x), seed).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("j", [3288, 3289, 3290, 10_000])
def test_simhash_keys_wrap_in_uint32(j):
    """SimHash hashes arange(n) + j * n in uint32; at BrainCell's n the
    product passes 2**32 from j = 3,289 on."""
    n = BRAINCELL_N
    cols = np.array([0, 1, 77, n // 2, n - 1], np.int64)
    keys = jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(j) * jnp.uint32(n)
    want = np.asarray(jhash.rademacher(keys, 505))[cols]
    got = thash.rademacher((torch.from_numpy(cols) + j * n) & thash.M32,
                           505).numpy()
    np.testing.assert_array_equal(got, want)
    assert (j * n >= 2**32) == (j >= 3289)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 31, 32, 33, 100, 257])
def test_np_pack_bits_and_packed_distances(d):
    rng = np.random.default_rng(d)
    bits = (rng.random((2, 5, d)) < 0.4).astype(np.int32)
    packed = tpack.np_pack_bits(bits)
    np.testing.assert_array_equal(packed, jpack.np_pack_bits(bits))
    a, b = packed[0][:, None, :], packed[1][None, :, :]
    for name in ("packed_hamming", "packed_inner"):
        want = np.asarray(getattr(jpack, name)(jnp.asarray(a),
                                               jnp.asarray(b)))
        got = getattr(tpack, name)(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis,mult", [(0, 4), (1, 8), (1, 5), (0, 3)])
def test_pad_to_multiple(axis, mult):
    x = np.arange(15, dtype=np.int32).reshape(3, 5)
    want = np.asarray(jpack.pad_to_multiple(jnp.asarray(x), mult, axis))
    got = tpack.pad_to_multiple(torch.from_numpy(x), mult, axis).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Cham estimators
# ---------------------------------------------------------------------------


def _sketches(d, n=24, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    bits = (rng.random((n, d)) < density).astype(np.int32)
    bits[0] = 1  # a saturated sketch
    bits[1] = 0  # an empty one
    return tpack.np_pack_bits(bits)


@pytest.mark.parametrize("d", [64, 100, 1024])
def test_binhamming_without_masks_is_the_table_path(d):
    sk = _sketches(d, seed=d)
    u, v = torch.from_numpy(sk[:, None, :]), torch.from_numpy(sk[None])
    got = tcham.binhamming(u, v, d)
    wu, wv = tpack.popcount_rows(u), tpack.popcount_rows(v)
    inner = tpack.packed_inner(u, v)
    table = tcham.cham_table(d, "cpu")
    assert torch.equal(got, tcham.binhamming_from_table(table, wu, wv,
                                                        inner))
    assert torch.equal(tcham.binhamming_from_stats(wu, wv, inner, d), got)
    assert torch.equal(tcham.cham(u, v, d), 2.0 * got)
    want = np.asarray(jcham.binhamming(jnp.asarray(sk[:, None, :]),
                                       jnp.asarray(sk[None]), d))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masks", ["u", "v", "both", "row_col"])
def test_masked_binhamming_matches_reference(masks):
    d = 128
    sk = _sketches(d, seed=7, density=0.5)
    rng = np.random.default_rng(3)
    obs = rng.integers(0, 90, sk.shape[0]).astype(np.int32)
    kw_j, kw_t = {}, {}
    if masks in ("u", "both", "row_col"):
        o = obs[:, None]
        kw_j["obs_u"], kw_t["obs_u"] = jnp.asarray(o), torch.from_numpy(o)
    if masks in ("v", "both", "row_col"):
        o = obs[None, :] if masks == "row_col" else obs[:, None]
        kw_j["obs_v"], kw_t["obs_v"] = jnp.asarray(o), torch.from_numpy(o)
    a, b = sk[:, None, :], sk[None]
    want = np.asarray(jcham.binhamming(jnp.asarray(a), jnp.asarray(b), d,
                                       **kw_j))
    got = tcham.binhamming(torch.from_numpy(a), torch.from_numpy(b), d,
                           **kw_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want_c = np.asarray(jcham.cham(jnp.asarray(a), jnp.asarray(b), d,
                                   **kw_j))
    got_c = tcham.cham(torch.from_numpy(a), torch.from_numpy(b), d, **kw_t)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=RTOL, atol=ATOL)


def _term_scale(sk_a, sk_b, d):
    """|a_hat| + |b_hat| + |u_hat| of each pair: float32 rounding of the
    logs moves an estimate by a few ulps of its terms, which cancel (a
    saturated sketch's a_hat is ~1e4 at d = 512)."""
    a, b = torch.from_numpy(sk_a), torch.from_numpy(sk_b)
    wa, wb = tpack.popcount_rows(a), tpack.popcount_rows(b)
    u = wa.to(torch.int64) + wb - tpack.packed_inner(a, b)
    t = tcham.cham_table(d, "cpu").abs()
    return (t[wa.to(torch.int64)] + t[wb.to(torch.int64)] + t[u]).numpy()


@pytest.mark.parametrize("name", ["inner_estimate", "cosine_estimate",
                                  "jaccard_estimate"])
@pytest.mark.parametrize("d", [96, 512])
def test_float_estimators_match_reference(name, d):
    """inner_estimate to rtol of its terms (_term_scale); cosine and
    Jaccard, divided by the density estimates, to rtol of the value."""
    sk = _sketches(d, seed=d + 1, density=0.2)
    a, b = sk[:, None, :], sk[None]
    want = np.asarray(getattr(jcham, name)(jnp.asarray(a), jnp.asarray(b),
                                           d), np.float64)
    got = getattr(tcham, name)(torch.from_numpy(a), torch.from_numpy(b), d)
    assert got.dtype == torch.float32
    scale = (_term_scale(a, b, d) if name == "inner_estimate"
             else np.abs(want))
    assert (np.abs(got.numpy() - want) <= ATOL + RTOL * scale).all()


def test_density_estimate_matches_reference():
    w = np.arange(0, 513, dtype=np.int32)
    for d in (64, 512):
        want = np.asarray(jcham.density_estimate(jnp.asarray(w[:d + 1]), d))
        got = tcham.density_estimate(torch.from_numpy(w[:d + 1]), d)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_core_exports_the_reference_estimators():
    for name in ("binhamming", "binhamming_from_stats", "cham",
                 "cham_matrix", "cosine_estimate", "density_estimate",
                 "hamming_matrix_exact", "inner_estimate",
                 "jaccard_estimate", "np_pack_bits", "pack_bits",
                 "packed_hamming", "packed_inner", "packed_width",
                 "popcount32", "popcount_rows", "pow2_bucket",
                 "unpack_bits", "binem", "binsketch", "sketch_dim",
                 "theorem2_bound"):
        assert callable(getattr(tcore, name)), name


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------


def _binem_rows(n_rows=12, n=700, seed=0):
    rng = np.random.default_rng(seed)
    bits = (rng.random((n_rows, n)) < 0.06).astype(np.int32)
    bits[:, n // 2:] *= rng.random((n_rows, 1)) < 0.5  # idle columns
    bits[-1] = 0
    return bits


@pytest.mark.parametrize("method", ["bcs", "hlsh", "fh", "simhash"])
@pytest.mark.parametrize("d,seed", [(64, 0), (100, 3), (257, 11)])
def test_baseline_sketches_bit_identical(method, d, seed):
    bits = _binem_rows(seed=seed)
    jp = JB.BaselineParams(bits.shape[1], d, seed)
    tp = TB.BaselineParams(bits.shape[1], d, seed)
    want = np.asarray(getattr(JB, f"{method}_sketch")(jp, jnp.asarray(bits)))
    got = getattr(TB, f"{method}_sketch")(tp, torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), want)
    lead = getattr(TB, f"{method}_sketch")(
        tp, torch.from_numpy(bits.reshape(3, 4, -1)))
    np.testing.assert_array_equal(lead.numpy().reshape(want.shape), want)


def test_simhash_sign_bits_past_the_uint32_wrap():
    """Planes j >= 3,289 at BrainCell's width, against R's columns built
    by the reference's hash of arange(n) + j * n."""
    n, d = BRAINCELL_N, 3300
    bits = np.zeros((3, n), np.int8)
    rng = np.random.default_rng(0)
    for r in range(2):
        bits[r, rng.choice(n, 40, replace=False)] = 1
    got = TB.simhash_sketch(TB.BaselineParams(n, d, 5),
                            torch.from_numpy(bits)).numpy()
    flat = jnp.asarray(bits.astype(np.float32))
    for j in (0, 3288, 3289, 3299):
        r = jhash.rademacher(jnp.arange(n, dtype=jnp.uint32)
                             + jnp.uint32(j) * jnp.uint32(n), 5 + 505)
        np.testing.assert_array_equal(got[:, j],
                                      np.asarray(flat @ r >= 0.0))


@pytest.mark.parametrize("method", ["bcs", "hlsh", "simhash"])
def test_parity_counts_and_estimates_match_reference(method):
    """The pairwise sketch Hamming distances (BCS's parity disagreements,
    H-LSH's sampled ones, SimHash's sign flips) through the packed
    all-pairs path, bit for bit; the estimates from them to 1e-5."""
    bits = _binem_rows(n_rows=16, seed=5)
    d = 96
    jp = JB.BaselineParams(bits.shape[1], d, 2)
    tp = TB.BaselineParams(bits.shape[1], d, 2)
    y = np.asarray(getattr(JB, f"{method}_sketch")(jp, jnp.asarray(bits)))
    yu, yv = jnp.asarray(y)[:, None], jnp.asarray(y)[None]
    want_hd = np.asarray(jnp.sum(yu != yv, axis=-1))
    hd = P._sketch_hd(torch.from_numpy(y))
    np.testing.assert_array_equal(hd.numpy(), want_hd)
    w = bits.sum(1).astype(np.float32)
    if method == "simhash":
        want = JB.simhash_estimate(jp, yu, yv, jnp.asarray(w)[:, None],
                                   jnp.asarray(w)[None])
        got = TB.simhash_estimate_from_hd(tp, hd, torch.from_numpy(w)[:, None],
                                          torch.from_numpy(w)[None])
    else:
        want = getattr(JB, f"{method}_estimate")(jp, yu, yv)
        got = getattr(TB, f"{method}_estimate_from_hd")(tp, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fh_estimate_matches_reference():
    bits = _binem_rows(n_rows=16, seed=9)
    jp = JB.BaselineParams(bits.shape[1], 80, 4)
    tp = TB.BaselineParams(bits.shape[1], 80, 4)
    y = np.asarray(JB.fh_sketch(jp, jnp.asarray(bits)))
    w = bits.sum(1).astype(np.float32)
    want = JB.fh_estimate(jp, jnp.asarray(y)[:, None], jnp.asarray(y)[None],
                          jnp.asarray(w)[:, None], jnp.asarray(w)[None])
    yt = torch.from_numpy(y)
    got = TB.fh_estimate(tp, yt[:, None], yt[None],
                         torch.from_numpy(w)[:, None],
                         torch.from_numpy(w)[None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_clustering_metrics_match_reference(seed):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 5, 300)
    pred = np.where(rng.random(300) < 0.7, truth, rng.integers(0, 6, 300))
    for name in ("purity", "nmi", "ari"):
        want = getattr(jmetrics, name)(truth, pred)
        got = getattr(tmetrics, name)(truth, pred)
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-12), name


# ---------------------------------------------------------------------------
# data, exact distances, k-mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,scale,rows,clusters", [
    ("kos", 0.06, 40, 0), ("enron", 0.02, 24, 0), ("nytimes", 0.05, 60, 4),
    ("braincell", 0.02, 30, 0), ("pubmed", 0.01, 50, 3)])
def test_sample_dense_equals_the_generators_rows(name, scale, rows,
                                                 clusters):
    smp = P.sample(name, scale, rows, seed=1, clusters=clusters)
    want, labels = sample_dense(scaled_spec(TABLE1[name], scale), rows,
                                seed=1, cluster_centers=clusters)
    np.testing.assert_array_equal(smp.dense("cpu").numpy(), want)
    np.testing.assert_array_equal(smp.labels, labels)


def test_exact_hd_matrix_from_supports_equals_dense():
    smp = P.sample("nips", 0.05, 64, seed=2)
    x = smp.dense("cpu").numpy()
    want = (x[:, None, :] != x[None, :, :]).sum(-1)
    np.testing.assert_array_equal(P.exact_hd_matrix(torch.from_numpy(x))
                                  .numpy(), want)


@pytest.mark.parametrize("name,k", [("nytimes", 4), ("kos", 3)])
def test_kmode_on_a_tensor_equals_the_reference(name, k):
    smp = P.sample(name, 0.05, 120, seed=5, clusters=k)
    x = smp.dense("cpu")
    want = jkmode(x.numpy(), k, seed=0, n_categories=smp.spec.n_categories)
    for got in (tkmode(x, k, seed=0),
                tkmode(x.numpy(), k, seed=0,
                       n_categories=smp.spec.n_categories)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(np.asarray(got[1]), want[1])


# ---------------------------------------------------------------------------
# the figure functions against the reference's methods
# ---------------------------------------------------------------------------


def _ref_methods(n_dims, d, seed):
    """`benchmarks/common.py` make_methods (jitted), built from repro.core."""
    cp = JParams.create(n_dims, d, seed=seed)
    bp = JB.BaselineParams(n_dims, d, seed)

    def w(u):
        return jnp.sum(u, axis=-1).astype(jnp.float32)

    def pairs(sketch, estimate):
        def run(xj):
            u = jbinem(cp, xj)
            y = sketch(bp, u)
            return 2.0 * estimate(y[:, None, :], y[None, :, :], u)
        fn = jax.jit(run)
        return lambda x: np.asarray(fn(jnp.asarray(x)))

    def cabin(xj):
        sk = jsketch_dense(cp, xj)
        return jcham.cham_matrix(sk, sk, d)

    cabin_fn = jax.jit(cabin)
    return {
        "cabin": lambda x: np.asarray(cabin_fn(jnp.asarray(x))),
        "bcs": pairs(JB.bcs_sketch,
                     lambda a, b, u: JB.bcs_estimate(bp, a, b)),
        "hlsh": pairs(JB.hlsh_sketch,
                      lambda a, b, u: JB.hlsh_estimate(bp, a, b)),
        "fh": pairs(JB.fh_sketch, lambda a, b, u: JB.fh_estimate(
            bp, a, b, w(u)[:, None], w(u)[None, :])),
        "sh": pairs(JB.simhash_sketch, lambda a, b, u: JB.simhash_estimate(
            bp, a, b, w(u)[:, None], w(u)[None, :])),
    }


def _ref_rows(name, scale, rows, seed, clusters=0):
    return sample_dense(scaled_spec(TABLE1[name], scale), rows, seed=seed,
                        cluster_centers=clusters)[0]


def _ref_rmse(est, true):
    iu = np.triu_indices(true.shape[0], 1)
    return float(np.sqrt(((est[iu].astype(np.float64) - true[iu]) ** 2)
                         .mean()))


def _ref_exact(x):
    return (x[:, None, :] != x[None, :, :]).sum(-1)


FIG3_DIMS = (128, 512)


@functools.lru_cache(maxsize=None)
def _ref_fig3(d):
    """The reference methods' matrices on fig3's enron rows (64 rows, the
    reference's seeds), shared by the two tests below."""
    x = _ref_rows("enron", 0.06, 64, seed=1)
    return x, {name: fn(x) for name, fn in
               _ref_methods(x.shape[1], d, 2).items()}


@pytest.mark.parametrize("d", FIG3_DIMS)
def test_make_methods_match_reference_matrices(d):
    x, want = _ref_fig3(d)
    got = P.make_methods(x.shape[1], d, seed=2)
    for name in P.METHODS:
        np.testing.assert_allclose(
            got[name](torch.from_numpy(x)).numpy(), want[name],
            rtol=FIG_RTOL, atol=FIG_RTOL, err_msg=f"{name} d={d}")


def test_fig2_times_every_method():
    res = P.fig2_table3_reduction_speed(scale=0.02, n_rows=32, repeat=1,
                                        device="cpu")
    assert set(res["seconds"]) == set(P.METHODS)
    for m in P.BASELINES:
        assert res[f"speedup_{m}"] > 0 and math.isfinite(
            res[f"speedup_{m}"])


def test_fig3_rmse_matches_reference():
    got = P.fig3_rmse(scale=0.06, n_rows=64, dims=FIG3_DIMS,
                      names=("enron",), device="cpu")
    for d in FIG3_DIMS:
        x, want = _ref_fig3(d)
        true = _ref_exact(x)
        for name in P.METHODS:
            assert math.isclose(got[f"enron.{name}.d{d}"],
                                _ref_rmse(want[name], true),
                                rel_tol=FIG_RTOL), (name, d)


def test_fig4_binem_errors_equal_reference():
    got = P.fig4_binem_variance(trials=40, device="cpu")
    x = _ref_rows("nips", 0.06, 2, seed=3)
    hd = int((x[0] != x[1]).sum())
    errors = []
    for t in range(40):
        u = np.asarray(jbinem(JParams.create(x.shape[1], 256, seed=t),
                              jnp.asarray(x)))
        errors.append(hd - 2 * int((u[0] != u[1]).sum()))
    assert got["hd"] == hd
    assert got["mean"] == float(np.mean(errors))
    assert got["std"] == float(np.std(errors))


def test_fig5_errors_match_reference():
    """The port runs the reference's 64 trials (its claims need them); the
    first is held against the reference's errors (each trial re-seeds
    every method, and the reference's cost on the CPU is per trial)."""
    got = P.fig5_step2_variance(device="cpu")
    x = _ref_rows("enron", 0.06, 2, seed=4)
    true = int((x[0] != x[1]).sum())
    for t in range(1):
        for name, fn in _ref_methods(x.shape[1], 512, 100 + t).items():
            assert math.isclose(got[name]["errors"][t],
                                float(fn(x)[0, 1]) - true,
                                rel_tol=FIG_RTOL, abs_tol=FIG_RTOL), (
                name, t)
    for name in P.METHODS:
        e = np.asarray(got[name]["errors"])
        assert len(e) == 64 and got[name]["mean"] == float(e.mean())


def test_fig6to10_scores_equal_reference():
    k, dims = 4, (256, 512)
    got = P.fig6to10_clustering(n_rows=120, device="cpu")
    x = _ref_rows("nytimes", 0.05, 120, seed=5, clusters=k)
    spec = scaled_spec(TABLE1["nytimes"], 0.05)
    truth, _ = jkmode(x, k, seed=0, n_categories=spec.n_categories)
    for d in dims:
        cp = JParams.create(x.shape[1], d, seed=6)
        bp = JB.BaselineParams(x.shape[1], d, 6)
        u = jbinem(cp, jnp.asarray(x))
        sk = jax.jit(lambda v: jsketch_dense(cp, v))(jnp.asarray(x))
        reprs = {"cabin": jpack.unpack_bits(sk, d),
                 "bcs": JB.bcs_sketch(bp, u), "hlsh": JB.hlsh_sketch(bp, u)}
        for name, bits in reprs.items():
            pred, _ = jkmode(np.asarray(bits), k, seed=0, n_categories=1)
            for metric in ("purity", "nmi", "ari"):
                want = getattr(jmetrics, metric)(truth, pred)
                assert math.isclose(got[d][name][metric], want,
                                    rel_tol=1e-12, abs_tol=1e-12), (
                    d, name, metric)


def test_table4_mae_matches_reference():
    got = P.table4_heatmap(n_rows=32, device="cpu")
    x = _ref_rows("braincell", 0.02, 32, seed=7)
    true = _ref_exact(x)
    iu = np.triu_indices(32, 1)
    for name, fn in _ref_methods(x.shape[1], 1024, 8).items():
        want = float(np.abs(fn(x)[iu].astype(np.float64) - true[iu]).mean())
        assert math.isclose(got["mae"][name], want, rel_tol=FIG_RTOL), name


def test_theorem2_matches_reference():
    got = P.theorem2_check(n_rows=48, device="cpu")
    x = _ref_rows("kos", 0.06, 48, seed=9)
    s = int((x != 0).sum(1).max())
    d = sketch_dim(s, 0.1)
    cp = JParams.create(x.shape[1], d, seed=10)
    sk = jax.jit(lambda v: jsketch_dense(cp, v))(jnp.asarray(x))
    err = np.abs(np.asarray(jcham.cham_matrix(sk, sk, d)) - _ref_exact(x))
    err = err[np.triu_indices(48, 1)]
    bound = theorem2_bound(s, 0.1)
    assert (got["s"], got["d"], got["bound"]) == (s, d, bound)
    assert math.isclose(got["frac_within"], float((err <= bound).mean()),
                        abs_tol=2 / len(err))
    assert math.isclose(got["mean_err"], float(err.mean()), rel_tol=FIG_RTOL)


def test_full_width_dims_keep_the_twins_ratio():
    assert P.full_width_dim(512, 0.08) == 6400
    assert P.full_width_dim(1024, 0.06) == 17088
    assert P.full_width_dim(1024, 0.02) == 51200
    assert P.full_width_dim(256, 0.05) == 5120


def test_a_failed_ordering_raises(monkeypatch):
    """The figure functions raise when an ordering the reference asserts
    does not hold (here: Theorem 2 against a bound of zero)."""
    monkeypatch.setattr(P, "theorem2_bound", lambda s, delta: -1.0)
    with pytest.raises(AssertionError, match="Theorem 2"):
        P.theorem2_check(n_rows=16, device="cpu")


def test_device_defaults_to_cuda(monkeypatch):
    import inspect

    for fn in (P.fig2_table3_reduction_speed, P.fig3_rmse,
               P.fig4_binem_variance, P.fig5_step2_variance,
               P.fig6to10_clustering, P.table4_heatmap, P.theorem2_check):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.theorem2_check(n_rows=8)
