"""Plain PyTorch versions of the pair-stats and row-popcount kernels."""

from __future__ import annotations

import torch

from repro_torch.core.packing import popcount32

# elements of one (M, chunk, W) broadcast: bounds the temporaries
_CHUNK_ELEMS = 1 << 24


def pair_stats_ref(a: torch.Tensor, b: torch.Tensor, *, op_inner: bool = True,
                   op_ham: bool = True):
    """a (M, W), b (N, W) int32 -> (inner (M, N), hamming (M, N)) int32,
    each None when switched off.  Works in column chunks of b."""
    m, w = a.shape
    n = b.shape[0]
    inner = (torch.empty((m, n), dtype=torch.int32, device=a.device)
             if op_inner else None)
    ham = (torch.empty((m, n), dtype=torch.int32, device=a.device)
           if op_ham else None)
    step = max(1, _CHUNK_ELEMS // max(1, m * w))
    a3 = a[:, None, :]
    for j0 in range(0, n, step):
        b3 = b[None, j0:j0 + step, :]
        if op_inner:
            inner[:, j0:j0 + step] = popcount32(a3 & b3).sum(
                dim=-1, dtype=torch.int32)
        if op_ham:
            ham[:, j0:j0 + step] = popcount32(a3 ^ b3).sum(
                dim=-1, dtype=torch.int32)
    return inner, ham


def row_popcount_ref(x: torch.Tensor) -> torch.Tensor:
    """(M, W) int32 -> (M,) int32 row Hamming weights."""
    return popcount32(x).sum(dim=-1, dtype=torch.int32)
