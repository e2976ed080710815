"""Plain PyTorch versions of the fused top-k select kernel.

`topk_select_ref` mirrors the JAX package's
`repro.core.allpairs._topk_rows_impl`: the k smallest distances per query
over the first m rows of b, ascending by (distance, lower column), with
slots past m filled by (+inf, -1).  `topk_round_ref` is one round of the
kernel (at most 256 keys, above a per-query floor key), which the wrapper
joins into any k on either device."""

from __future__ import annotations

import torch

from repro_torch.core.cham import cham_from_table, cham_table
from repro_torch.kernels.hamming.ref import pair_stats_ref, row_popcount_ref


def _distances(q: torch.Tensor, bm: torch.Tensor, d: int, metric: str
               ) -> torch.Tensor:
    """(Q, m) f32 distances of every query to every row of bm."""
    if metric == "cham":
        inner, _ = pair_stats_ref(q, bm, op_ham=False)
        dist = cham_from_table(cham_table(d, q.device, q.shape[1]),
                               row_popcount_ref(q)[:, None],
                               row_popcount_ref(bm)[None, :], inner)
    elif metric == "hamming":
        _, ham = pair_stats_ref(q, bm, op_inner=False)
        dist = ham.to(torch.float32)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return dist


def topk_select_ref(q: torch.Tensor, b: torch.Tensor, k: int, *, d: int,
                    metric: str = "cham", m_valid: int | None = None):
    """q (Q, W), b (N, W) int32 -> (values (Q, k) f32, indices (Q, k)
    int32)."""
    m = b.shape[0] if m_valid is None else m_valid
    nq = q.shape[0]
    vals = torch.full((nq, k), float("inf"), dtype=torch.float32,
                      device=q.device)
    idxs = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    kk = min(k, m)
    if kk == 0 or nq == 0:
        return vals, idxs
    dist = _distances(q, b[:m], d, metric)
    # stable: equal distances keep the lower column first
    sv, si = torch.sort(dist, dim=1, stable=True)
    vals[:, :kk] = sv[:, :kk]
    idxs[:, :kk] = si[:, :kk].to(torch.int32)
    return vals, idxs


def topk_round_ref(q: torch.Tensor, b: torch.Tensor, k: int, *, d: int,
                   metric: str = "cham", m_valid: int | None = None,
                   floor: torch.Tensor | None = None):
    """One round of the kernel: per query, the k smallest keys (distance
    bits << 32 | column, int64) of the first m rows of b that lie above
    floor (Q,) int64, when given, as (values (Q, k) f32, indices (Q, k)
    int32); slots with no key left are (+inf, -1)."""
    m = b.shape[0] if m_valid is None else m_valid
    nq = q.shape[0]
    vals = torch.full((nq, k), float("inf"), dtype=torch.float32,
                      device=q.device)
    idxs = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    if min(k, m) == 0 or nq == 0:
        return vals, idxs
    dist = _distances(q, b[:m], d, metric)
    keys = (dist.view(torch.int32).to(torch.int64) << 32) | torch.arange(
        m, device=q.device)
    if floor is not None:
        keys = torch.where(keys > floor[:, None], keys,
                           torch.iinfo(torch.int64).max)
    kk = min(k, m)
    best = torch.sort(keys, dim=1).values[:, :kk]
    taken = best != torch.iinfo(torch.int64).max
    vals[:, :kk] = torch.where(taken, (best >> 32).to(torch.int32).view(
        torch.float32), float("inf"))
    idxs[:, :kk] = torch.where(taken, (best & 0xFFFFFFFF).to(torch.int32), -1)
    return vals, idxs
