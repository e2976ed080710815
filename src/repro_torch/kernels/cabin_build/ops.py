"""Wrapper of the dense Cabin kernel (`csrc/cabin_build.cu`).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
`ref.py`.  Nothing else falls back."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cabin_build.ref import cabin_build_ref
from repro_torch.kernels.cabin_build_sparse.ops import MAX_KERNEL_D

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p)


def cabin_build(x: torch.Tensor, *, d: int, psi_seed: int, pi_seed: int
                ) -> torch.Tensor:
    """Cabin on dense rows: (N, n) int32 categories (0 = missing) ->
    (N, ceil(d/32)) int32 packed sketches, for every d >= 1."""
    cuda = build.on_cuda("cabin_build", x)
    if x.ndim != 2:
        raise ValueError(f"cabin_build: expected (N, n) rows, got "
                         f"{tuple(x.shape)}")
    if d < 1:
        raise ValueError(f"cabin_build: d={d} must be >= 1")
    if not cuda:
        return cabin_build_ref(x, d=d, psi_seed=psi_seed, pi_seed=pi_seed)
    if d > MAX_KERNEL_D:
        raise ValueError(f"cabin_build: d={d} above the kernel's "
                         f"{MAX_KERNEL_D}")
    n_rows, n = x.shape
    out = torch.empty((n_rows, (d + 31) // 32), dtype=torch.int32,
                      device=x.device)
    if n_rows == 0:
        return out
    fn = build.function("cabin_build", "cabin_build_launch", _ARGS)
    code = fn(build.ptr(x), build.ptr(out), n_rows, n, d,
              psi_seed & 0xFFFFFFFF, pi_seed & 0xFFFFFFFF,
              build.stream_ptr(x.device))
    build.check("cabin_build", "cabin_build", code)
    build.count_launch("cabin_build")
    return out
