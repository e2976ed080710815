"""Wrapper of the fused top-k select kernels (`csrc/topk_select.cu`).

A pass of at most MAX_K keys is two launches on CUDA: select, over a
(ceil(Q / BQ), S) grid whose blocks each take BQ queries and one of S
ranges of store rows and write their k best keys to a (Q, S, k) scratch,
then merge, one block per query.  `plan` picks BQ and S.  A CPU tensor
takes the plain version of the same pass (`ref.topk_split_round_ref`,
split and merged by the same plan).  Nothing else falls back."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.cham import cham_table
from repro_torch.kernels import build
from repro_torch.kernels.topk_select.ref import (  # noqa: F401
    topk_select_ref, topk_split_round_ref)

# keys per pass: the select kernel keeps up to 2,048 candidates a query in
# shared memory, k of them at each compaction
MAX_K = 1024
METRICS = ("cham", "hamming")
# the plan's targets: one wave of select blocks (two a SM where their
# shared memory allows it, at CAP = 128); at least 8 rows per kept key in a
# split, so that its list stays selective; at least 2**16 words of the
# store per split, so that a block's fixed costs stay small
H100_SMS = 132
ROWS_PER_KEY = 8
MIN_SPLIT_WORDS = 1 << 16

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 11 + (
             ctypes.c_void_p,)


class Plan(NamedTuple):
    bq: int  # queries per select block
    bn: int  # store rows per tile of a select block
    cap: int  # candidate keys a query keeps in shared memory
    splits: int  # S, row ranges per query tile
    rows_per_split: int
    scratch_bytes: int  # the (Q, S, k) int64 key lists


def plan(nq: int, m: int, k: int, w: int, sms: int = H100_SMS) -> Plan:
    """The launch plan of one pass of k keys for nq queries over m rows of
    w words.  The select kernel's shape, as its dispatch takes it: CAP the
    power of two >= 2k (at least 128); BQ = 64 queries at CAP <= 256 and
    fewer above, so that BQ * CAP keys fill 128 KB; BN = 4096 / BQ.  Then
    as many splits as fill `sms` SMs with one wave of blocks, but no fewer
    than ROWS_PER_KEY * k rows and MIN_SPLIT_WORDS words a split; ranges
    are whole tiles, and none is empty."""
    cap = max(128, 1 << (2 * k - 1).bit_length())
    bq = min(64, 16384 // cap)
    bn = 4096 // bq
    if m == 0:
        return Plan(bq, bn, cap, 1, 0, nq * k * 8)
    q_tiles = -(-nq // bq)
    per_sm = 2 if cap == 128 else 1  # select blocks an SM holds
    want = -(-per_sm * sms // q_tiles)
    min_rows = max(ROWS_PER_KEY * k, -(-MIN_SPLIT_WORDS // max(w, 1)))
    splits = max(1, min(want, m // min_rows))
    rows = -(-m // splits)
    rows = -(-rows // bn) * bn  # whole tiles
    splits = -(-m // rows)
    return Plan(bq, bn, cap, splits, rows, nq * splits * k * 8)


def _last_key(vals: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """The 64-bit key (distance bits << 32 | column) of each row's last
    (value, index) slot, as int64: the floor of the next pass."""
    bits = vals[:, -1].contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | idxs[:, -1].to(torch.int64)


def _kernel_pass(q, b, vals, idxs, col0, kr, p: Plan, *, d, metric, m,
                 floor):
    """One pass, select then merge: the kr smallest keys above `floor` into
    columns [col0, col0 + kr) of vals / idxs."""
    nq, w = q.shape
    cham = metric == "cham"
    table = cham_table(d, q.device, w) if cham else None
    lists = torch.empty((nq, p.splits, kr), dtype=torch.int64,
                        device=q.device)
    fn = build.function("topk_select", "topk_select_launch", _ARGS)
    code = fn(build.ptr(q), build.ptr(b),
              build.ptr(table) if cham else None,
              None if floor is None else build.ptr(floor), build.ptr(lists),
              build.ptr(vals), build.ptr(idxs), nq, m, w, kr, vals.shape[1],
              col0, int(cham), table.numel() if cham else 0, p.bq, p.splits,
              p.rows_per_split, build.stream_ptr(q.device))
    build.check("topk_select", "topk_select", code)
    build.count_launch("topk_select")


def topk_select(q: torch.Tensor, b: torch.Tensor, k: int, *, d: int,
                metric: str = "cham", m_valid: int | None = None):
    """k nearest of the first m_valid rows of b per row of q: q (Q, W),
    b (N, W) packed int32 -> (values (Q, k) f32, indices (Q, k) int32),
    ascending by (distance, lower column).  Slots past m_valid come back as
    (+inf, -1).

    Any k: the slots holding rows, min(k, m_valid) of them, are filled in
    passes of MAX_K, each floored at the previous pass's last key (keys
    are unique, so the passes join into exactly the sorted first k).  On
    CUDA each pass is one select and one merge launch and one read of the
    store, counted once in build.LAUNCHES, so k costs
    ceil(min(k, m_valid) / 1024) passes."""
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
    nq, w = q.shape
    if cuda:
        # the select kernel stages rows with 16-byte cp.async copies
        # whenever W % 4 == 0, which a base off 16 bytes (a view at an
        # odd offset) would fault; a fresh allocation is aligned
        q, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, b))
    sms = (torch.cuda.get_device_properties(q.device).multi_processor_count
           if cuda else H100_SMS)
    vals = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    starts = range(0, min(k, m) if nq else 0, MAX_K)
    # every pass writes each of its slots; only columns past the last
    # pass are left to fill
    done = min(k, starts[-1] + MAX_K) if starts else 0
    vals[:, done:] = float("inf")
    idxs[:, done:] = -1
    floor = None
    for col0 in starts:
        kr = min(MAX_K, k - col0)
        p = plan(nq, m, kr, w, sms)
        if cuda:
            _kernel_pass(q, b, vals, idxs, col0, kr, p, d=d, metric=metric,
                         m=m, floor=floor)
        else:
            rv, ri = topk_split_round_ref(
                q, b, kr, d=d, metric=metric, m_valid=m, floor=floor,
                splits=p.splits, rows_per_split=p.rows_per_split)
            vals[:, col0:col0 + kr] = rv
            idxs[:, col0:col0 + kr] = ri
        if col0 + kr < done:
            floor = _last_key(vals[:, :col0 + kr], idxs[:, :col0 + kr])
    return vals, idxs
