"""repro_torch.core.cabin vs the JAX package: sparse and dense Cabin
sketches are bit-identical for every d (the port has no d % 128 rule).

The sparse oracle is `sketch_sparse_jnp`, reached jitted through
`sketch_sparse_jit` (which takes the jnp path off the TPU).  The dense
kernel's plain version is held against the Pallas `cabin_build` in
interpret mode where that kernel takes d (d % 128 == 0), and against
`cabin_build_ref` for every other d."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cabin_build.kernel import cabin_build as jcabin_build
from repro.kernels.cabin_build.ref import cabin_build_ref as jcabin_build_ref
from repro.kernels.cabin_build_sparse.kernel import cabin_build_sparse
from repro_torch.kernels import build
from repro_torch.kernels.cabin_build import ops as dense_ops
from repro_torch.kernels.cabin_build_sparse import ops as sparse_ops

jcabin = importlib.import_module("repro.core.cabin")
tcabin = importlib.import_module("repro_torch.core.cabin")

N_DIMS = 2000


def _coo(seed, n_rows=19, m=37):
    """Padded-COO rows: value 0 marks padding (some slots alias index 0),
    repeated attributes within a row, and categories up to 2**31 - 1."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N_DIMS, size=(n_rows, m)).astype(np.int32)
    val = rng.integers(0, 9, size=(n_rows, m)).astype(np.int32)
    idx[:, -5:] = 0
    val[:, -5:] = 0
    idx[0, :4] = idx[0, 4]
    val[1, :3] = 2**31 - 1
    return idx, val


@pytest.mark.parametrize("d", [200, 256, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_sparse_matches_reference(d, seed):
    idx, val = _coo(seed)
    pj = jcabin.CabinParams.create(N_DIMS, d, seed=seed)
    pt = tcabin.CabinParams.create(N_DIMS, d, seed=seed)
    ref = np.asarray(jcabin.sketch_sparse_jit(pj, jnp.asarray(idx),
                                              jnp.asarray(val)))
    got = tcabin.sketch_sparse(pt, torch.from_numpy(idx),
                               torch.from_numpy(val))
    assert got.dtype == torch.int32
    assert got.shape == (idx.shape[0], pt.packed_width)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sketch_sparse_leading_dims_match_reference():
    idx, val = _coo(3, n_rows=12)
    pj = jcabin.CabinParams.create(N_DIMS, 200, seed=3)
    pt = tcabin.CabinParams.create(N_DIMS, 200, seed=3)
    idx3, val3 = idx.reshape(3, 4, -1), val.reshape(3, 4, -1)
    ref = np.asarray(jcabin.sketch_sparse_jit(pj, jnp.asarray(idx3),
                                              jnp.asarray(val3)))
    got = tcabin.sketch_sparse(pt, torch.from_numpy(idx3),
                               torch.from_numpy(val3))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sparse_plain_version_matches_pallas_kernel_in_interpret_mode():
    d = 256
    idx, val = _coo(7, n_rows=10, m=40)
    p = tcabin.CabinParams.create(N_DIMS, d, seed=7)
    ref = np.asarray(cabin_build_sparse(
        jnp.asarray(idx), jnp.asarray(val), d=d, psi_seed=p.psi_seed,
        pi_seed=p.pi_seed, interpret=True))
    got = sparse_ops.cabin_build_sparse_ref(
        torch.from_numpy(idx), torch.from_numpy(val), d=d,
        psi_seed=p.psi_seed, pi_seed=p.pi_seed)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("d", [200, 256, 1024])
def test_sketch_dense_matches_reference(d):
    rng = np.random.default_rng(d)
    x = rng.integers(0, 5, size=(11, 300)).astype(np.int32)
    x[0] = 0
    pj = jcabin.CabinParams.create(300, d, seed=2)
    pt = tcabin.CabinParams.create(300, d, seed=2)
    np.testing.assert_array_equal(
        tcabin.sketch_dense(pt, torch.from_numpy(x)).numpy(),
        np.asarray(jcabin.sketch_dense_jit(pj, jnp.asarray(x))))


def test_dense_and_sparse_sketches_agree():
    """The same rows in both layouts give the same sketch."""
    rng = np.random.default_rng(11)
    n, m = 300, 24
    idx = np.stack([rng.choice(n, m, replace=False) for _ in range(6)]
                   ).astype(np.int32)
    val = rng.integers(1, 7, size=idx.shape).astype(np.int32)
    x = np.zeros((6, n), np.int32)
    np.put_along_axis(x, idx, val, axis=1)
    p = tcabin.CabinParams.create(n, 200, seed=4)
    np.testing.assert_array_equal(
        tcabin.sketch_sparse(p, torch.from_numpy(idx),
                             torch.from_numpy(val)).numpy(),
        tcabin.sketch_dense(p, torch.from_numpy(x)).numpy())


def _dense_rows(seed, n_rows=13, n=700):
    """Dense rows with missing values (0), a row of nothing but missing
    values, negative and large categories."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 9, size=(n_rows, n)).astype(np.int32)
    x[rng.random(x.shape) < 0.6] = 0
    x[0] = 0
    x[1, :5] = [-1, -7, 2**31 - 1, -(2**31), 1]
    return x


@pytest.mark.parametrize("d", [128, 256, 1024])
def test_dense_plain_version_matches_pallas_kernel_in_interpret_mode(d):
    x = _dense_rows(d)
    p = tcabin.CabinParams.create(x.shape[1], d, seed=5)
    kw = dict(d=d, psi_seed=p.psi_seed, pi_seed=p.pi_seed)
    want = np.asarray(jcabin_build(jnp.asarray(x), bm=8, bd=128, bk=128,
                                   interpret=True, **kw))
    got = dense_ops.cabin_build_ref(torch.from_numpy(x), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [1, 31, 200, 4097])
def test_dense_plain_version_matches_reference_for_every_d(d):
    x = _dense_rows(d + 1)
    kw = dict(d=d, psi_seed=0x7FFFFFFF, pi_seed=12345)
    want = np.asarray(jcabin_build_ref(jnp.asarray(x), **kw))
    got = dense_ops.cabin_build_ref(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_wrapper_on_the_cpu_is_the_plain_version_uncounted():
    x = torch.from_numpy(_dense_rows(3))
    kw = dict(d=300, psi_seed=4, pi_seed=9)
    before = dict(build.LAUNCHES)
    assert torch.equal(dense_ops.cabin_build(x, **kw),
                       dense_ops.cabin_build_ref(x, **kw))
    assert build.LAUNCHES == before
    with pytest.raises(ValueError, match="d="):
        dense_ops.cabin_build(x, d=0, psi_seed=0, pi_seed=0)


@pytest.mark.parametrize("d", [sparse_ops.MAX_D + 1, 2_000_001])
def test_sketches_above_the_shared_memory_bitmap_match_reference(d):
    """Above MAX_D the kernels OR in device memory; the wrappers' plain
    versions take such d as the JAX package's jnp paths do, bit for bit."""
    idx, val = _coo(d % 1000, n_rows=3)
    x = _dense_rows(d % 1000, n_rows=3, n=N_DIMS)
    pj = jcabin.CabinParams.create(N_DIMS, d, seed=9)
    pt = tcabin.CabinParams.create(N_DIMS, d, seed=9)
    got = tcabin.sketch_sparse(pt, torch.from_numpy(idx),
                               torch.from_numpy(val))
    assert got.shape == (3, (d + 31) // 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jcabin.sketch_sparse_jnp(pj, jnp.asarray(idx), jnp.asarray(val))))
    np.testing.assert_array_equal(
        tcabin.sketch_dense(pt, torch.from_numpy(x)).numpy(),
        np.asarray(jcabin.sketch_dense(pj, jnp.asarray(x))))
