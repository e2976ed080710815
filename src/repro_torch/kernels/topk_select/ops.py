"""Wrapper of the fused top-k select kernel (`csrc/topk_select.cu`).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
`ref.py`.  Nothing else falls back."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cham import cham_table
from repro_torch.kernels import build
from repro_torch.kernels.topk_select.ref import topk_select_ref

# the kernel keeps a thread-local sorted k-best of at most this many keys
MAX_K = 256
METRICS = ("cham", "hamming")

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def topk_select(q: torch.Tensor, b: torch.Tensor, k: int, *, d: int,
                metric: str = "cham", m_valid: int | None = None):
    """k nearest of the first m_valid rows of b per row of q: q (Q, W),
    b (N, W) packed int32 -> (values (Q, k) f32, indices (Q, k) int32),
    ascending by (distance, lower column).  Slots past m_valid come back as
    (+inf, -1).  On CUDA, k is capped at MAX_K."""
    cuda = build.on_cuda("topk_select", q, b)
    if q.ndim != 2 or b.ndim != 2 or q.shape[1] != b.shape[1]:
        raise ValueError("topk_select: expected (Q, W) and (N, W) packed rows,"
                         f" got {tuple(q.shape)} and {tuple(b.shape)}")
    m = b.shape[0] if m_valid is None else int(m_valid)
    if not 0 <= m <= b.shape[0]:
        raise ValueError(f"topk_select: m_valid={m} outside the "
                         f"{b.shape[0]} supplied rows")
    if k < 0:
        raise ValueError(f"topk_select: k must be >= 0, got {k}")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if not cuda:
        return topk_select_ref(q, b, k, d=d, metric=metric, m_valid=m)
    if k > MAX_K:
        raise ValueError(f"topk_select: k={k} exceeds the kernel's cap "
                         f"{MAX_K}")
    nq, w = q.shape
    vals = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0 or k == 0:
        return vals, idxs
    cham = metric == "cham"
    table = cham_table(d, q.device, w) if cham else None
    fn = build.function("topk_select", "topk_select_launch", _ARGS)
    code = fn(build.ptr(q), build.ptr(b),
              build.ptr(table) if cham else None, build.ptr(vals),
              build.ptr(idxs), nq, m, w, k, int(cham),
              table.numel() if cham else 0, build.stream_ptr(q.device))
    build.check("topk_select", "topk_select", code)
    build.LAUNCHES["topk_select"] += 1
    return vals, idxs
