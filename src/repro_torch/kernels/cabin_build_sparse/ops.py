"""Wrapper of the sparse Cabin kernel (`csrc/cabin_build_sparse.cu`).

A CUDA tensor launches the kernel under `plan`; a CPU tensor takes the
plain version in `ref.py`.  Nothing else falls back."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cabin_build_sparse.ref import cabin_build_sparse_ref

# Largest d whose ceil(d/32)-word bitmap fits a block's shared memory
# (232,448 bytes); above it the kernels OR into the output row in device
# memory.  It chooses the kernel's path and limits nothing.
MAX_D = 32 * (232448 // 4)
# d is passed to the kernels as a C int
MAX_KERNEL_D = 2**31 - 1
# rows a block of 256 threads sketches at once, one group of threads and
# one shared-memory bitmap each: a warp a row where eight bitmaps fit
MAX_ROWS_PER_BLOCK = 8

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


class Plan(NamedTuple):
    vec: int  # COO slots a thread loads at once (1, 2 or 4 int32)
    rows_per_block: int  # groups of 256 / rows_per_block threads, a row each
    device_bitmap: bool  # the bitmap is the output row in device memory


def plan(m: int, d: int, *addresses: int) -> Plan:
    """The kernel's launch plan for rows of m slots at data addresses
    `addresses` (bytes): the widest load (16, 8 or 4 bytes) that m and
    every address allow; as many rows a block as have their ceil(d/32)-word
    bitmaps fit shared memory together (up to MAX_ROWS_PER_BLOCK), or above
    MAX_D one row a block with the bitmap in device memory."""
    vec = next(v for v in (4, 2, 1)
               if m % v == 0 and all(a % (4 * v) == 0 for a in addresses))
    if d > MAX_D:
        return Plan(vec, 1, True)
    words = (d + 31) // 32
    rows = MAX_ROWS_PER_BLOCK
    while rows > 1 and rows * words > MAX_D // 32:
        rows //= 2
    return Plan(vec, rows, False)


def cabin_build_sparse(indices: torch.Tensor, values: torch.Tensor, *,
                       d: int, psi_seed: int, pi_seed: int) -> torch.Tensor:
    """Cabin on padded-COO rows: (N, m) int32 indices / values (value 0 =
    pad) -> (N, ceil(d/32)) int32 packed sketches, for every d >= 1."""
    cuda = build.on_cuda("cabin_build_sparse", indices, values)
    if indices.ndim != 2 or indices.shape != values.shape:
        raise ValueError("cabin_build_sparse: indices/values must be "
                         "identically-shaped (N, m), got "
                         f"{tuple(indices.shape)} and {tuple(values.shape)}")
    if d < 1:
        raise ValueError(f"cabin_build_sparse: d={d} must be >= 1")
    if not cuda:
        return cabin_build_sparse_ref(indices, values, d=d, psi_seed=psi_seed,
                                      pi_seed=pi_seed)
    if d > MAX_KERNEL_D:
        raise ValueError(f"cabin_build_sparse: d={d} above the kernel's "
                         f"{MAX_KERNEL_D}")
    n, m = indices.shape
    out = torch.empty((n, (d + 31) // 32), dtype=torch.int32,
                      device=indices.device)
    if n == 0:
        return out
    p = plan(m, d, indices.data_ptr(), values.data_ptr())
    fn = build.function("cabin_build_sparse", "cabin_build_sparse_launch",
                        _ARGS)
    code = fn(build.ptr(indices), build.ptr(values), build.ptr(out), n, m, d,
              psi_seed & 0xFFFFFFFF, pi_seed & 0xFFFFFFFF, p.vec,
              p.rows_per_block, int(p.device_bitmap),
              build.stream_ptr(indices.device))
    build.check("cabin_build_sparse", "cabin_build_sparse", code)
    build.LAUNCHES["cabin_build_sparse"] += 1
    return out
