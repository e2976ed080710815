"""repro_torch.core.cabin vs the JAX package: sparse and dense Cabin
sketches are bit-identical for every d (the port has no d % 128 rule).

The sparse oracle is `sketch_sparse_jnp`, reached jitted through
`sketch_sparse_jit` (which takes the jnp path off the TPU)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cabin_build_sparse.kernel import cabin_build_sparse
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
