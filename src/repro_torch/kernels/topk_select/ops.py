"""Wrapper of the fused top-k select kernel (`csrc/topk_select.cu`).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version of
each round (`ref.topk_round_ref`).  Nothing else falls back."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cham import cham_table
from repro_torch.kernels import build
from repro_torch.kernels.topk_select.ref import (  # noqa: F401
    topk_round_ref, topk_select_ref)

# keys per round: the kernel keeps a thread-local sorted k-best of at most
# this many keys
MAX_K = 256
METRICS = ("cham", "hamming")

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _last_key(vals: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """The 64-bit key (distance bits << 32 | column) of each row's last
    (value, index) slot, as int64: the floor of the next round."""
    bits = vals[:, -1].contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | idxs[:, -1].to(torch.int64)


def _kernel_round(q, b, vals, idxs, col0, kr, *, d, metric, m, floor):
    """One launch: the kr smallest keys above `floor` into columns
    [col0, col0 + kr) of vals / idxs."""
    nq, w = q.shape
    cham = metric == "cham"
    table = cham_table(d, q.device, w) if cham else None
    fn = build.function("topk_select", "topk_select_launch", _ARGS)
    code = fn(build.ptr(q), build.ptr(b),
              build.ptr(table) if cham else None,
              None if floor is None else build.ptr(floor), build.ptr(vals),
              build.ptr(idxs), nq, m, w, kr, vals.shape[1], col0, int(cham),
              table.numel() if cham else 0, build.stream_ptr(q.device))
    build.check("topk_select", "topk_select", code)
    build.LAUNCHES["topk_select"] += 1


def topk_select(q: torch.Tensor, b: torch.Tensor, k: int, *, d: int,
                metric: str = "cham", m_valid: int | None = None):
    """k nearest of the first m_valid rows of b per row of q: q (Q, W),
    b (N, W) packed int32 -> (values (Q, k) f32, indices (Q, k) int32),
    ascending by (distance, lower column).  Slots past m_valid come back as
    (+inf, -1).

    Any k: the slots holding rows, min(k, m_valid) of them, are filled in
    rounds of MAX_K, each floored at the previous round's last key (keys
    are unique, so the rounds join into exactly the sorted first k).  On
    CUDA each round is one launch and one pass over the store, so k costs
    ceil(min(k, m_valid) / 256) passes."""
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
    nq = q.shape[0]
    vals = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    starts = range(0, min(k, m) if nq else 0, MAX_K)
    # every round writes each of its slots; only columns past the last
    # round are left to fill
    done = min(k, starts[-1] + MAX_K) if starts else 0
    vals[:, done:] = float("inf")
    idxs[:, done:] = -1
    floor = None
    for col0 in starts:
        kr = min(MAX_K, k - col0)
        if cuda:
            _kernel_round(q, b, vals, idxs, col0, kr, d=d, metric=metric, m=m,
                          floor=floor)
        else:
            rv, ri = topk_round_ref(q, b, kr, d=d, metric=metric, m_valid=m,
                                    floor=floor)
            vals[:, col0:col0 + kr] = rv
            idxs[:, col0:col0 + kr] = ri
        if col0 + kr < done:
            floor = _last_key(vals[:, :col0 + kr], idxs[:, :col0 + kr])
    return vals, idxs
