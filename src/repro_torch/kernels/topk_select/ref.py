"""Plain PyTorch version of the fused top-k select kernel.

Mirrors the JAX package's `repro.core.allpairs._topk_rows_impl`: the k
smallest distances per query over the first m rows of b, ascending by
(distance, lower column), with slots past m filled by (+inf, -1)."""

from __future__ import annotations

import torch

from repro_torch.core.cham import cham_from_table, cham_table
from repro_torch.kernels.hamming.ref import pair_stats_ref, row_popcount_ref


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
    bm = b[:m]
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
    # stable: equal distances keep the lower column first
    sv, si = torch.sort(dist, dim=1, stable=True)
    vals[:, :kk] = sv[:, :kk]
    idxs[:, :kk] = si[:, :kk].to(torch.int32)
    return vals, idxs
