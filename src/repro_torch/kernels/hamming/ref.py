"""Plain PyTorch versions of the pair-stats and row-popcount kernels.

`pair_stats_ref` counts the shared bits of two packed rows as a product of
their bits: each row is unpacked to 0/1 floats and the inner products come
from one matrix product, whose integer sums are exact in float32 below
2**24 bits (in float64 above).  Hamming follows as wa + wb - 2 * inner.  It
is an independent route to the kernel's popcounts, and fast enough on the
CPU for a k-medoid run over tens of thousands of rows."""

from __future__ import annotations

import torch

from repro_torch.core.packing import LANE_BITS, popcount32, unpack_bits

# elements of one unpacked (rows, bits) block: bounds the temporaries
_CHUNK_ELEMS = 1 << 24


def _bits(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return unpack_bits(words, words.shape[1] * LANE_BITS).to(dtype)


def pair_stats_ref(a: torch.Tensor, b: torch.Tensor, *, op_inner: bool = True,
                   op_ham: bool = True):
    """a (M, W), b (N, W) int32 -> (inner (M, N), hamming (M, N)) int32,
    each None when switched off.  Works in row blocks of a and b."""
    m, w = a.shape
    n = b.shape[0]
    inner = (torch.empty((m, n), dtype=torch.int32, device=a.device)
             if op_inner else None)
    ham = (torch.empty((m, n), dtype=torch.int32, device=a.device)
           if op_ham else None)
    if not (op_inner or op_ham) or m == 0 or n == 0 or w == 0:
        if inner is not None:
            inner.zero_()
        if ham is not None:
            ham.zero_()
        return inner, ham
    bits = w * LANE_BITS
    dtype = torch.float32 if bits < 2**24 else torch.float64
    step = max(1, _CHUNK_ELEMS // bits)
    wa = row_popcount_ref(a) if op_ham else None
    wb = row_popcount_ref(b) if op_ham else None
    for i0 in range(0, m, step):
        ua = _bits(a[i0:i0 + step], dtype)
        for j0 in range(0, n, step):
            ub = _bits(b[j0:j0 + step], dtype)
            prod = (ua @ ub.T).to(torch.int32)
            rows, cols = slice(i0, i0 + step), slice(j0, j0 + step)
            if op_inner:
                inner[rows, cols] = prod
            if op_ham:
                ham[rows, cols] = (wa[rows, None] + wb[None, cols]) - 2 * prod
    return inner, ham


def row_popcount_ref(x: torch.Tensor) -> torch.Tensor:
    """(M, W) int32 -> (M,) int32 row Hamming weights."""
    return popcount32(x).sum(dim=-1, dtype=torch.int32)
