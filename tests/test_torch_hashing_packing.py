"""repro_torch.core.hashing / packing / CabinParams vs the JAX package.

The port emulates uint32 arithmetic in int64; every hash, packed word and
popcount must be bit-identical to the reference, edge words included.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jhash
from repro.core import packing as jpack
from repro_torch.core import hashing as thash
from repro_torch.core import packing as tpack

jcabin = importlib.import_module("repro.core.cabin")
tcabin = importlib.import_module("repro_torch.core.cabin")

EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                 0xFFFFFFFF, 12345, 0x9E3779B9], dtype=np.uint32)
SEEDS = [0, 1, 17, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_hashes_bit_identical_on_edge_words(seed):
    x, y = EDGE, EDGE[::-1].copy()
    np.testing.assert_array_equal(thash.mix32(_t(x)).numpy(),
                                  _u32(jhash.mix32(jnp.asarray(x))))
    np.testing.assert_array_equal(thash.hash_u32(_t(x), seed).numpy(),
                                  _u32(jhash.hash_u32(jnp.asarray(x), seed)))
    np.testing.assert_array_equal(
        thash.hash2_u32(_t(x), _t(y), seed).numpy(),
        _u32(jhash.hash2_u32(jnp.asarray(x), jnp.asarray(y), seed)))
    np.testing.assert_array_equal(
        thash.psi_bits(_t(x), _t(y), seed).numpy(),
        np.asarray(jhash.psi_bits(jnp.asarray(x), jnp.asarray(y), seed)))
    for d in (1, 7, 200, 256, 4096, 141043):
        np.testing.assert_array_equal(
            thash.pi_buckets(_t(x), d, seed).numpy(),
            np.asarray(jhash.pi_buckets(jnp.asarray(x), d, seed)))


def test_hashes_of_int32_inputs_reinterpret_as_uint32():
    """Negative int32 indices/categories hash as their uint32 bits."""
    x = EDGE.view(np.int32)
    np.testing.assert_array_equal(
        thash.hash_u32(torch.from_numpy(x), 5).numpy(),
        _u32(jhash.hash_u32(jnp.asarray(x), 5)))
    np.testing.assert_array_equal(
        thash.psi_bits(torch.from_numpy(x), torch.from_numpy(x[::-1].copy()),
                       5).numpy(),
        np.asarray(jhash.psi_bits(jnp.asarray(x), jnp.asarray(x[::-1].copy()),
                                  5)))


def test_mix32_of_python_ints_matches_tensor_path():
    for v in EDGE.tolist():
        assert thash.mix32(v) == int(jhash.mix32(jnp.uint32(v)))


@pytest.mark.parametrize("seed", range(5))
def test_cabin_params_create_same_seeds(seed):
    ref = jcabin.CabinParams.create(1000, 256, seed=seed)
    got = tcabin.CabinParams.create(1000, 256, seed=seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.packed_width == ref.packed_width


@pytest.mark.parametrize("d", [200, 256, 4096])
def test_pack_unpack_popcount_bit_identical(d):
    rng = np.random.default_rng(d)
    bits = rng.integers(0, 2, size=(6, d)).astype(np.int32)
    bits[0] = 1  # every word full: sign bit set
    bits[1] = 0
    words = np.array(jpack.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(
        tpack.pack_bits(torch.from_numpy(bits)).numpy(), words)
    np.testing.assert_array_equal(
        tpack.unpack_bits(torch.from_numpy(words), d).numpy(),
        np.asarray(jpack.unpack_bits(jnp.asarray(words), d)))
    raw = np.concatenate([words, rng.integers(
        -2**31, 2**31, size=(3, words.shape[1])).astype(np.int32)])
    np.testing.assert_array_equal(
        tpack.popcount32(torch.from_numpy(raw)).numpy(),
        np.asarray(jpack.popcount32(jnp.asarray(raw))))
    np.testing.assert_array_equal(
        tpack.popcount_rows(torch.from_numpy(raw)).numpy(),
        np.asarray(jpack.popcount_rows(jnp.asarray(raw))))
    np.testing.assert_array_equal(tpack.np_popcount_rows(raw),
                                  jpack.np_popcount_rows(raw))
    assert tpack.packed_width(d) == jpack.packed_width(d)


def test_popcount32_edge_words():
    x = EDGE.view(np.int32)
    np.testing.assert_array_equal(
        tpack.popcount32(torch.from_numpy(x)).numpy(),
        np.asarray(jpack.popcount32(jnp.asarray(x))))


@pytest.mark.parametrize("n", [0, 1, 8, 9, 33])
def test_pow2_bucketing_helpers(n):
    assert tpack.pow2_bucket(n) == jpack.pow2_bucket(n)
    assert tpack.pow2_bucket(n, floor=1) == jpack.pow2_bucket(n, floor=1)
    x = np.arange(max(n, 1) * 3, dtype=np.int32).reshape(max(n, 1), 3)
    np.testing.assert_array_equal(
        tpack.pad_rows_pow2(torch.from_numpy(x)).numpy(),
        np.asarray(jpack.pad_rows_pow2(jnp.asarray(x))))
    rows = np.arange(x.shape[0])[::-1].copy()
    np.testing.assert_array_equal(
        tpack.padded_take(torch.from_numpy(x), rows).numpy(),
        np.asarray(jpack.padded_take(jnp.asarray(x), rows)))
