"""Plain PyTorch versions of the fused top-k select kernel.

`topk_select_ref` mirrors the JAX package's
`repro.core.allpairs._topk_rows_impl`: the k smallest distances per query
over the first m rows of b, ascending by (distance, lower column), with
slots past m filled by (+inf, -1).  `topk_round_ref` is one pass of the
kernel (at most 1,024 keys, above a per-query floor key) as one sort, and
`topk_split_round_ref` the same pass as the kernel splits it: the k best
keys of each range of rows (`split_lists_ref`, the select launch), then
the first k of those lists (`merge_lists_ref`, the merge launch).  The
wrapper joins passes into any k on either device."""

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


KEY_PAD = torch.iinfo(torch.int64).max  # no key: (+inf, -1)


def _keys(q: torch.Tensor, b: torch.Tensor, m: int, d: int, metric: str,
          floor: torch.Tensor | None) -> torch.Tensor:
    """(Q, m) int64 keys, distance bits << 32 | column, of every query and
    each of the first m rows of b; KEY_PAD at or below a query's floor."""
    dist = _distances(q, b[:m], d, metric)
    keys = (dist.view(torch.int32).to(torch.int64) << 32) | torch.arange(
        m, device=q.device)
    if floor is not None:
        keys = torch.where(keys > floor[:, None], keys, KEY_PAD)
    return keys


def _first(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys of each row, ascending, KEY_PAD past the end."""
    out = torch.full((keys.shape[0], k), KEY_PAD, dtype=torch.int64,
                     device=keys.device)
    kk = min(k, keys.shape[1])
    out[:, :kk] = torch.sort(keys, dim=1).values[:, :kk]
    return out


def _unpack(best: torch.Tensor):
    """Keys -> (values f32, indices int32), (+inf, -1) for KEY_PAD."""
    taken = best != KEY_PAD
    vals = torch.where(taken, (best >> 32).to(torch.int32).view(
        torch.float32), float("inf"))
    idxs = torch.where(taken, (best & 0xFFFFFFFF).to(torch.int32), -1)
    return vals, idxs


def topk_round_ref(q: torch.Tensor, b: torch.Tensor, k: int, *, d: int,
                   metric: str = "cham", m_valid: int | None = None,
                   floor: torch.Tensor | None = None):
    """One pass of the kernel: per query, the k smallest keys (distance
    bits << 32 | column, int64) of the first m rows of b that lie above
    floor (Q,) int64, when given, as (values (Q, k) f32, indices (Q, k)
    int32); slots with no key left are (+inf, -1)."""
    m = b.shape[0] if m_valid is None else m_valid
    if q.shape[0] == 0 or m == 0:
        return _unpack(torch.full((q.shape[0], k), KEY_PAD,
                                  dtype=torch.int64, device=q.device))
    return _unpack(_first(_keys(q, b, m, d, metric, floor), k))


def split_lists_ref(keys: torch.Tensor, k: int, splits: int,
                    rows_per_split: int) -> torch.Tensor:
    """The select launch: (Q, m) keys -> (Q, splits, k), split s holding
    the k smallest keys of columns [s * rows_per_split, (s + 1) *
    rows_per_split), ascending, KEY_PAD past the range's keys (a split
    shorter than k, or past m, is padded)."""
    nq, m = keys.shape
    if splits * rows_per_split < m:
        raise ValueError(f"{splits} splits of {rows_per_split} rows do not "
                         f"cover {m} rows")
    pad = torch.full((nq, splits * rows_per_split), KEY_PAD,
                     dtype=torch.int64, device=keys.device)
    pad[:, :m] = keys
    ranges = pad.view(nq * splits, rows_per_split)
    return _first(ranges, k).view(nq, splits, k)


def merge_lists_ref(lists: torch.Tensor, k: int) -> torch.Tensor:
    """The merge launch: (Q, S, k) sorted lists -> the first k keys of
    their union, (Q, k) ascending."""
    return _first(lists.reshape(lists.shape[0], -1), k)


def topk_split_round_ref(q: torch.Tensor, b: torch.Tensor, k: int, *,
                         d: int, metric: str = "cham",
                         m_valid: int | None = None,
                         floor: torch.Tensor | None = None, splits: int,
                         rows_per_split: int):
    """`topk_round_ref` computed as the kernel computes it: per-split
    k-best lists over `splits` ranges of `rows_per_split` rows, then their
    merge.  Keys are unique, so it equals the one sort bit for bit."""
    m = b.shape[0] if m_valid is None else m_valid
    keys = _keys(q, b, m, d, metric, floor)
    lists = split_lists_ref(keys, k, splits, rows_per_split)
    return _unpack(merge_lists_ref(lists, k))
