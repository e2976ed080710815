"""Stateless integer hash functions behind Cabin's psi and pi mappings.

Bit-identical to the JAX package's `repro.core.hashing`: murmur3's fmix32
finaliser keyed by a 32-bit seed, so every process derives the same
mappings from the seed alone.

PyTorch has no usable uint32 arithmetic on the CPU (`>>`, `%` and `*` are
missing), and int32 `>>` is arithmetic, not logical.  So the tensor path
holds each uint32 value in an int64 and masks it back to 32 bits after
every operation.  Multiplies are split into 16-bit halves so that no
intermediate leaves int64's range.  Results are int64 tensors holding the
uint32 values (0 .. 2**32 - 1).  The CUDA kernel for sparse Cabin
(`kernels/csrc/cabin_build_sparse.cu`) computes the same functions in
native `uint32_t` arithmetic.

Plain Python ints go through the same functions and come back as ints.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x9E3779B9  # golden-ratio increment


def _as_u32(x):
    if isinstance(x, int):
        return x & M32
    return torch.as_tensor(x).to(torch.int64) & M32


def _mul32(x, c: int):
    """(x * c) mod 2**32 for uint32 values held in int64 (or Python ints)."""
    if isinstance(x, int):
        return (x * c) & M32
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x):
    """murmur3 fmix32: bijective avalanche mixer on uint32."""
    x = _as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def hash_u32(x, seed):
    """Seeded hash of one uint32 stream."""
    return mix32((_as_u32(x) + mix32(_mul32(_as_u32(seed), _M3))) & M32)


def hash2_u32(x, y, seed):
    """Seeded hash of a pair (x, y): psi(attribute, category)."""
    hx = hash_u32(x, seed)
    return mix32(hx ^ ((_mul32(_as_u32(y), _M3) + (hx >> 7)) & M32))


def psi_bits(attr_idx, categories, seed) -> torch.Tensor:
    """The category mapping psi: (attribute i, category a) -> {0, 1} int32.
    psi(i, 0) = 0, so missing features and padding stay 0."""
    cats = _as_u32(categories)
    bits = hash2_u32(attr_idx, cats, seed) & 1
    return torch.where(cats == 0, 0, bits).to(torch.int32)


def pi_buckets(attr_idx, d: int, seed) -> torch.Tensor:
    """The attribute mapping pi: {0 .. n-1} -> {0 .. d-1} int32, an unsigned
    modulo of the seeded hash."""
    return (hash_u32(attr_idx, seed) % int(d)).to(torch.int32)
