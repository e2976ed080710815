"""Wrappers of the pair-stats and row-popcount kernels (`csrc/hamming.cu`),
and the query-vs-store distance matrix built on them.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
`ref.py`.  Nothing else falls back."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cham import cham_from_table, cham_table
from repro_torch.kernels import build
from repro_torch.kernels.hamming.ref import pair_stats_ref, row_popcount_ref

_PAIR_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p)
_ROW_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)
# the kernel's grid puts 64-row tiles of `a` on its y axis (< 65536 tiles)
MAX_PAIR_ROWS = 64 * 65535


def pair_stats(a: torch.Tensor, b: torch.Tensor, *, op_inner: bool = True,
               op_ham: bool = True):
    """All-pairs popcount statistics between packed rows a (M, W) and
    b (N, W) int32: (inner (M, N), hamming (M, N)) int32, each None when
    switched off."""
    cuda = build.on_cuda("pair_stats", a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError("pair_stats: expected (M, W) and (N, W) packed rows, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if not cuda:
        return pair_stats_ref(a, b, op_inner=op_inner, op_ham=op_ham)
    m, w = a.shape
    n = b.shape[0]
    if m > MAX_PAIR_ROWS:
        raise ValueError(f"pair_stats: {m} rows of a exceed {MAX_PAIR_ROWS}")
    inner = (torch.empty((m, n), dtype=torch.int32, device=a.device)
             if op_inner else None)
    ham = (torch.empty((m, n), dtype=torch.int32, device=a.device)
           if op_ham else None)
    if not (op_inner or op_ham) or m == 0 or n == 0:
        return inner, ham
    fn = build.function("hamming", "pair_stats_launch", _PAIR_ARGS)
    code = fn(build.ptr(a), build.ptr(b),
              build.ptr(inner) if op_inner else None,
              build.ptr(ham) if op_ham else None, m, n, w,
              build.stream_ptr(a.device))
    build.check("hamming", "pair_stats", code)
    build.LAUNCHES["pair_stats"] += 1
    return inner, ham


def row_popcount(x: torch.Tensor) -> torch.Tensor:
    """Row Hamming weights: (M, W) int32 -> (M,) int32."""
    cuda = build.on_cuda("row_popcount", x)
    if x.ndim != 2:
        raise ValueError(
            f"row_popcount: expected (M, W), got {tuple(x.shape)}")
    if not cuda:
        return row_popcount_ref(x)
    m, w = x.shape
    out = torch.empty((m,), dtype=torch.int32, device=x.device)
    if m == 0:
        return out
    fn = build.function("hamming", "row_popcount_launch", _ROW_ARGS)
    code = fn(build.ptr(x), build.ptr(out), m, w, build.stream_ptr(x.device))
    build.check("hamming", "row_popcount", code)
    build.LAUNCHES["row_popcount"] += 1
    return out


def dist_matrix(q: torch.Tensor, store: torch.Tensor, d: int, *,
                metric: str = "cham") -> torch.Tensor:
    """Query-vs-store distances: (Q, W) x (N, W) packed -> (Q, N) f32.
    "cham" reads the Cham table at the exact (wq, ws, inner) statistics;
    "hamming" is the exact XOR popcount."""
    if metric == "cham":
        inner, _ = pair_stats(q, store, op_ham=False)
        table = cham_table(d, q.device, q.shape[1])
        return cham_from_table(table, row_popcount(q)[:, None],
                               row_popcount(store)[None, :], inner)
    if metric == "hamming":
        _, ham = pair_stats(q, store, op_inner=False)
        return ham.to(torch.float32)
    raise ValueError(f"unknown metric {metric!r}")
