"""Wrapper of the sparse Cabin kernel (`csrc/cabin_build_sparse.cu`).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
`ref.py`.  Nothing else falls back."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cabin_build_sparse.ref import cabin_build_sparse_ref

# Largest d whose ceil(d/32)-word bitmap fits a block's shared memory
# (232,448 bytes); above it the kernels OR into the output row in device
# memory.  It chooses the kernel's path and limits nothing.
MAX_D = 32 * (232448 // 4)
# d is passed to the kernels as a C int
MAX_KERNEL_D = 2**31 - 1

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
         ctypes.c_void_p)


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
    fn = build.function("cabin_build_sparse", "cabin_build_sparse_launch",
                        _ARGS)
    code = fn(build.ptr(indices), build.ptr(values), build.ptr(out), n, m, d,
              psi_seed & 0xFFFFFFFF, pi_seed & 0xFFFFFFFF,
              build.stream_ptr(indices.device))
    build.check("cabin_build_sparse", "cabin_build_sparse", code)
    build.LAUNCHES["cabin_build_sparse"] += 1
    return out
