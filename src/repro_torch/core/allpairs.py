"""All-pairs reductions over packed Cabin sketches: top-k and threshold.

The port of the JAX package's `repro.core.allpairs` for the serving path:

  topk_rows(a, b, k, d)              per-row k nearest columns of b
  topk_rows_banded(...)              the same over weight-sorted bands,
                                     stopping at an exactness certificate
  threshold_pairs(a, b, d, thr)      all (i, j) with dist < thr

plus the host-side helpers the index shares (prune scores, the
(value, key)-lexicographic k-best merge).

Every distance tile runs on the device of its inputs: a CUDA tensor goes
through the hand-written kernels (the fused top-k select, or pair stats
plus row popcounts and the Cham table), a CPU tensor through their plain
versions.  The JAX package's `mode` switch (popcount / matmul / pallas) is
that device.  Distances are the integer statistics' Cham or exact Hamming
value (`repro_torch.core.cham`), so they do not depend on the tiling.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.cham import cham_from_table, cham_table

# Slack added to every weight-band prune test: distances are O(10..1000),
# float noise between the bound and the estimator's internals is O(1e-3),
# so the margin makes the prune sound without costing selectivity.
PRUNE_MARGIN = 0.05

# pad sentinel for k-best candidate lists: a (inf, KBEST_KEY_PAD) entry
# sorts after every real (value, key) candidate in kbest_lex_merge
KBEST_KEY_PAD = np.iinfo(np.int64).max

# columns per threshold tile batch: bounds the (rows, columns) temporaries
_THRESHOLD_COLS = 1 << 16


def prune_factor(metric: str) -> float:
    """`dist(i, j) >= prune_factor * |s_i - s_j|` for the per-row prune
    score s (see prune_score_host): 2 for cham, 1 for exact hamming."""
    if metric == "cham":
        return 2.0
    if metric == "hamming":
        return 1.0
    raise ValueError(f"unknown metric {metric!r}")


def kbest_lex_merge(k: int, values: np.ndarray, keys: np.ndarray,
                    *extras: np.ndarray) -> tuple[np.ndarray, ...]:
    """Exact (value, key)-lexicographic k-best over per-row candidate
    lists: `values`/`keys`/`extras` are (Q, C >= k) candidate columns;
    returns each reduced to its k best columns, ascending by (value, key).
    Pad lists short of k with (np.inf, KBEST_KEY_PAD) entries."""
    if k < 0:
        raise ValueError(f"kbest_lex_merge: k must be >= 0, got {k}")
    order = np.lexsort((keys, values), axis=-1)[:, :k]

    def take(a: np.ndarray) -> np.ndarray:
        return np.take_along_axis(a, order, axis=1)

    return (take(values), take(keys)) + tuple(take(a) for a in extras)


def prune_score_host(weights: np.ndarray, d: int, metric: str) -> np.ndarray:
    """Per-row prune score for band planning (float64; PRUNE_MARGIN
    absorbs the gap to the f32 estimator): the density estimate under
    cham, the raw sketch weight under hamming."""
    if metric == "cham":
        w = weights.astype(np.float64)
        return np.log(np.clip(1.0 - w / d, 1e-9, 1.0)) / np.log1p(-1.0 / d)
    return weights.astype(np.float64)


def _tile_stats_dist(a: torch.Tensor, b: torch.Tensor, wa: torch.Tensor,
                     wb: torch.Tensor, table: torch.Tensor | None
                     ) -> torch.Tensor:
    """(rows of a) x (rows of b) f32 distance tile from pair stats."""
    from repro_torch.kernels.hamming import ops

    if table is not None:
        inner, _ = ops.pair_stats(a, b, op_ham=False)
        return cham_from_table(table, wa[:, None], wb[None, :], inner)
    _, ham = ops.pair_stats(a, b, op_inner=False)
    return ham.to(torch.float32)


# ---------------------------------------------------------------------------
# threshold candidate extraction (radius queries)
# ---------------------------------------------------------------------------


def _block_score_ranges(w: torch.Tensor, n: int, block: int,
                        table: torch.Tensor | None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row-block (min, max) of the prune score over the first n rows:
    T[w] (the f32 density estimate) under cham, w under hamming."""
    s = (table[w.to(torch.int64)] if table is not None
         else w.to(torch.float32))
    n_blocks = -(-n // block)
    pad = n_blocks * block - n
    s_min = torch.nn.functional.pad(s[:n], (0, pad), value=float("inf"))
    s_max = torch.nn.functional.pad(s[:n], (0, pad), value=float("-inf"))
    return (s_min.reshape(n_blocks, block).amin(dim=1),
            s_max.reshape(n_blocks, block).amax(dim=1))


def threshold_pairs(a: torch.Tensor, b: torch.Tensor | None = None, *,
                    d: int, threshold: float, metric: str = "cham",
                    block: int = 256, sorted_by_weight: bool = False,
                    n_valid: int | None = None,
                    m_valid: int | None = None) -> np.ndarray:
    """All pairs (i, j) with dist(a[i], b[j]) < threshold, as a compact
    (K, 2) int32 host array, in the JAX package's order: tiles of
    `block` x `block` by (row block, column block), row-major inside each.

    b=None scans the upper triangle of a vs itself (i < j).  `n_valid` /
    `m_valid` declare how many leading rows of a / b are real (asymmetric
    scans only).  A tile whose rows' prune-score ranges lie further apart
    than the threshold allows yields no pair, exactly as the reference's
    weight-band tile prune skips it.  The weight-sorted banded scan
    (`sorted_by_weight=True`) belongs to the data/dedup slice."""
    if sorted_by_weight:
        raise NotImplementedError(
            "threshold_pairs(sorted_by_weight=True) is not ported yet: it "
            "comes with the data/dedup slice")
    symmetric = b is None
    if symmetric and (n_valid is not None or m_valid is not None):
        raise ValueError("n_valid/m_valid require an explicit b "
                         "(asymmetric scan)")
    b_arr = a if symmetric else b
    n = a.shape[0] if n_valid is None else int(n_valid)
    m = b_arr.shape[0] if m_valid is None else int(m_valid)
    if not (0 <= n <= a.shape[0] and 0 <= m <= b_arr.shape[0]):
        raise ValueError(f"n_valid/m_valid ({n}, {m}) outside the supplied "
                         f"rows ({a.shape[0]}, {b_arr.shape[0]})")
    if n == 0 or m == 0:
        return np.zeros((0, 2), np.int32)
    block = max(1, min(block, max(a.shape[0], b_arr.shape[0])))
    a = a[:n].contiguous()
    b_arr = b_arr[:m].contiguous()
    factor = prune_factor(metric)
    table = (cham_table(d, a.device, a.shape[1]) if metric == "cham"
             else None)
    wa = packing.popcount_rows(a)
    wb = wa if symmetric else packing.popcount_rows(b_arr)
    thr = torch.tensor(threshold, dtype=torch.float32, device=a.device)
    reach = (thr + PRUNE_MARGIN).item()  # f32, as the reference's test
    a_lo, a_hi = _block_score_ranges(wa, n, block, table)
    b_lo, b_hi = _block_score_ranges(wb, m, block, table)
    gap = torch.clamp(torch.maximum(b_lo[None, :] - a_hi[:, None],
                                    a_lo[:, None] - b_hi[None, :]), min=0.0)
    live = ~(factor * gap >= reach)  # (row blocks, column blocks)

    cols = max(block, _THRESHOLD_COLS // block * block)
    out = []
    for i0 in range(0, n, block):
        ib = i0 // block
        a_blk = a[i0:i0 + block]
        bm = a_blk.shape[0]
        for c0 in range(0, m, cols):
            b_blk = b_arr[c0:c0 + cols]
            dist = _tile_stats_dist(a_blk, b_blk, wa[i0:i0 + block],
                                    wb[c0:c0 + cols], table)
            hit = dist < thr
            if symmetric:
                gi = torch.arange(i0, i0 + bm, device=a.device)[:, None]
                gj = torch.arange(c0, c0 + b_blk.shape[0],
                                  device=a.device)[None, :]
                hit &= gi < gj
            nb = -(-b_blk.shape[0] // block)
            hit = torch.nn.functional.pad(
                hit, (0, nb * block - b_blk.shape[0]))
            hit = hit.reshape(bm, nb, block).permute(1, 0, 2)
            hit &= live[ib, c0 // block:c0 // block + nb][:, None, None]
            jb, r, c = torch.nonzero(hit, as_tuple=True)
            if len(jb):
                out.append(torch.stack(
                    [i0 + r, c0 + jb * block + c], dim=1).cpu())
    if not out:
        return np.zeros((0, 2), np.int32)
    return torch.cat(out).numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# row-wise top-k (neighbour queries)
# ---------------------------------------------------------------------------


def topk_rows(a: torch.Tensor, b: torch.Tensor, k: int, *, d: int,
              metric: str = "cham", m_valid: int | None = None,
              pad_k: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Per-row k nearest columns of b: (indices (N, k), distances (N, k))
    on the host, ascending by (distance, lower column).  `m_valid` declares
    how many leading rows of b are real.  `pad_k=True` keeps k above the
    valid count, and the surplus columns come back as (+inf, -1).  A CUDA
    tensor runs the fused top-k select kernel."""
    from repro_torch.kernels.topk_select import ops

    m = b.shape[0] if m_valid is None else m_valid
    if not 0 <= m <= b.shape[0]:
        raise ValueError(f"m_valid={m} outside the {b.shape[0]} supplied "
                         "rows")
    if pad_k:
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
    else:
        k = min(k, m)
    if k == 0:
        return (np.zeros((a.shape[0], 0), np.int32),
                np.zeros((a.shape[0], 0), np.float32))
    vals, idxs = ops.topk_select(a.contiguous(), b.contiguous(), k, d=d,
                                 metric=metric, m_valid=m)
    return idxs.cpu().numpy(), vals.cpu().numpy()


def topk_rows_banded(a: torch.Tensor, b: torch.Tensor, k: int, *, d: int,
                     q_scores: np.ndarray, band_lo: np.ndarray,
                     band_hi: np.ndarray, band_rows: int, n_valid: int,
                     metric: str = "cham",
                     order_by: np.ndarray | None = None,
                     q_valid: int | None = None,
                     alive: np.ndarray | None = None,
                     stats_out: dict | None = None,
                     deadline=None,
                     init_kth: np.ndarray | None = None):
    """Progressive band-expansion top-k over weight-banded rows.

    `b` holds `n_valid` rows sorted by ascending prune score, cut into
    bands of `band_rows` rows with host score intervals
    `[band_lo[i], band_hi[i]]`.  Bands are visited in ascending prune-score
    distance from the query batch; after each round the scan STOPS once

        prune_factor(metric) * gap(q, band) >= kth(q) + PRUNE_MARGIN

    holds for every query and unvisited band, which certifies that every
    unseen row is strictly farther than the current k-th neighbour.
    Visited chunks double in row count.

    `order_by` gives each row its tie-break key (default: row position);
    within a chunk columns are laid out in ascending key order, so the
    kernel's lower-column tie-break is the key tie-break, and chunks merge
    by exact (value, key)-lexicographic k-best.  `alive` masks rows out
    before each gather.  `deadline` (an object with an `expired` property)
    stops the walk between rounds, reporting `partial` and `cert_gap` in
    `stats_out`.  `init_kth` is a cross-partition bound on the global k-th
    value: the certificate prunes against min(local kth, init_kth), and
    unfilled columns then carry position -1 / value inf.

    Returns (positions (Q, k) int64 into b's rows, distances (Q, k) f32),
    equal to `topk_rows` over the same rows arranged in key order."""
    q = a.shape[0] if q_valid is None else q_valid
    n_live = n_valid if alive is None else int(
        np.count_nonzero(alive[:n_valid]))
    k = min(k, n_live)
    if stats_out is not None:
        stats_out.update(n_bands=len(band_lo), bands_visited=0,
                         rows_visited=0, early_stop=False,
                         partial=False, cert_gap=0.0)
    if q == 0 or k == 0:
        return np.zeros((q, 0), np.int64), np.zeros((q, 0), np.float32)
    a = a[:q]
    q_scores = np.asarray(q_scores, np.float64)
    factor = prune_factor(metric)
    n_bands = len(band_lo)
    gap = np.maximum(np.maximum(band_lo[None, :] - q_scores[:, None],
                                q_scores[:, None] - band_hi[None, :]), 0.0)
    if init_kth is not None:
        init_kth = np.asarray(init_kth, np.float32)[:q]
        if np.all(factor * gap >= init_kth[:, None] + PRUNE_MARGIN):
            if stats_out is not None:
                stats_out["early_stop"] = True
            return np.zeros((q, 0), np.int64), np.zeros((q, 0), np.float32)
    band_gap = gap.min(axis=0)
    visit = np.argsort(band_gap, kind="stable")

    best_v = np.full((q, k), np.inf, np.float32)
    best_key = np.full((q, k), KBEST_KEY_PAD, np.int64)
    best_pos = np.full((q, k), -1, np.int64)

    def band_range(bb: int) -> np.ndarray:
        return np.arange(bb * band_rows, min((bb + 1) * band_rows, n_valid))

    ptr = 0
    visited_rows = 0
    while ptr < n_bands:
        take = [visit[ptr]]
        ptr += 1
        if visited_rows == 0:
            # round 1: every band some query cannot be separated from
            while ptr < n_bands and band_gap[visit[ptr]] <= 0.0:
                take.append(visit[ptr])
                ptr += 1
        else:
            target = max(visited_rows, band_rows)  # geometric expansion
            cnt = len(band_range(take[0]))
            while ptr < n_bands and cnt < target:
                take.append(visit[ptr])
                cnt += len(band_range(visit[ptr]))
                ptr += 1
        rows = np.concatenate([band_range(bb) for bb in take])
        if alive is not None:
            rows = rows[alive[rows]]  # tombstoned rows never reach a tile
        visited_rows += len(rows)
        if len(rows):
            keys = rows if order_by is None else np.asarray(order_by)[rows]
            rows = rows[np.argsort(keys, kind="stable")]  # cols in key order
            sub = packing.padded_take(b, rows)
            kk = min(k, len(rows))
            pos_c, val_c = topk_rows(a, sub, kk, d=d, metric=metric,
                                     m_valid=len(rows))
            gpos = rows[pos_c]
            gkey = gpos if order_by is None else np.asarray(order_by)[gpos]
            if kk < k:  # pad the chunk's candidate list to k columns
                padw = ((0, 0), (0, k - kk))
                val_c = np.pad(val_c, padw, constant_values=np.inf)
                gpos = np.pad(gpos, padw, constant_values=-1)
                gkey = np.pad(gkey, padw, constant_values=KBEST_KEY_PAD)
            best_v, best_key, best_pos = kbest_lex_merge(
                k, np.concatenate([best_v, val_c], axis=1),
                np.concatenate([best_key, gkey], axis=1),
                np.concatenate([best_pos, gpos], axis=1))
        if ptr >= n_bands:
            break
        kth = best_v[:, k - 1]
        if init_kth is not None:
            kth = np.minimum(kth, init_kth)
        bound = factor * gap[:, visit[ptr:]]
        if np.all(bound >= kth[:, None] + PRUNE_MARGIN):
            if stats_out is not None:
                stats_out["early_stop"] = True
            break
        if deadline is not None and deadline.expired:
            if stats_out is not None:
                stats_out["partial"] = True
                stats_out["cert_gap"] = float(np.max(np.maximum(
                    kth[:, None] + PRUNE_MARGIN - bound, 0.0)))
            break
    if stats_out is not None:
        stats_out["bands_visited"] = ptr
        stats_out["rows_visited"] = visited_rows
    return best_pos, best_v
