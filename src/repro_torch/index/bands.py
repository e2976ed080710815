"""Weight-banded layouts: the query-pruning structure over a store.

A Cabin sketch's Hamming weight bounds how close it can be to anything:
dist(u, v) >= prune_factor(metric) * |s_u - s_v| for the per-row prune
score s (`core.allpairs.prune_score_host`).  `BandedLayout` keeps a slot
set weight-sorted and cut into contiguous BANDS, each with its host score
interval, so a radius query drops whole bands on the host and a k-NN query
walks outward from the bands nearest the query, stopping at the exactness
certificate.  The port of the JAX package's `repro.index.bands`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import allpairs
from repro_torch.core.allpairs import (KBEST_KEY_PAD, PRUNE_MARGIN,
                                       prune_factor, prune_score_host)
from repro_torch.core.packing import padded_take
from repro_torch.index.store import SketchStore
from repro_torch.obs.registry import NULL_REGISTRY


class BandedLayout:
    """Immutable weight-sorted banded snapshot of a slot set.

    Rows are sorted by (sketch weight, id), a total, history-independent
    order, then cut into bands of `band_rows` consecutive rows.  The device
    matrix holds the sorted rows padded to a power of two; `ids` maps
    sorted positions to external ids and `slots` to store slots.  Later
    tombstones thread through `refresh_alive` without a rebuild; band
    score intervals stay conservative supersets for any alive subset.
    `registry` receives the banding counters: queries, bands visited and
    pruned, and early stops at the certificate.
    """

    def __init__(self, store: SketchStore, metric: str,
                 band_rows: int = 1024, registry=None,
                 slots: np.ndarray | None = None):
        # under NULL_REGISTRY the counters are shared no-ops and the walk's
        # stats dict is not even built
        reg = NULL_REGISTRY if registry is None else registry
        self._obs_off = reg.is_null
        self._c_queries = reg.counter("index_banded_queries_total")
        self._c_visited = reg.counter("index_bands_visited_total")
        self._c_pruned = reg.counter("index_bands_pruned_total")
        self._c_early = reg.counter("index_band_early_stops_total")
        self.metric = metric
        self.d = store.d
        self.band_rows = int(band_rows)
        if slots is None:
            slots = store.alive_slots()
        weights = store.weights_at(slots)
        # stable sort over id-ordered rows => total order (weight, id)
        order = np.argsort(weights, kind="stable")
        self.n = len(slots)
        self.slots = slots[order]
        self.ids = store.ids_at(slots)[order]
        w_sorted = weights[order]
        self.matrix = padded_take(store.sk_buf, self.slots)
        self.alive = np.ones(self.n, bool)
        self._n_alive = self.n
        self.n_bands = -(-self.n // self.band_rows) if self.n else 0
        scores = prune_score_host(w_sorted, self.d, metric)
        self.band_lo = np.asarray(
            [scores[b * self.band_rows] for b in range(self.n_bands)])
        self.band_hi = np.asarray(
            [scores[min((b + 1) * self.band_rows, self.n) - 1]
             for b in range(self.n_bands)])

    @property
    def n_alive(self) -> int:
        return self._n_alive

    def refresh_alive(self, store: SketchStore) -> None:
        """Re-read the store's tombstone bitmap at this snapshot's slots."""
        if self.n:
            self.alive = store.alive_at(self.slots)
            self._n_alive = int(np.count_nonzero(self.alive))

    def _mask(self) -> np.ndarray | None:
        return None if self._n_alive == self.n else self.alive

    def candidate_bands(self, query_weights: np.ndarray, radius: float
                        ) -> np.ndarray:
        """Bool mask over bands: band b survives iff SOME query's score is
        within reach of its [lo, hi] score interval."""
        if self.n == 0 or len(query_weights) == 0:
            return np.zeros(self.n_bands, bool)
        qs = prune_score_host(np.asarray(query_weights), self.d, self.metric)
        factor = prune_factor(self.metric)
        gap = np.maximum(
            np.maximum(self.band_lo[None, :] - qs[:, None],
                       qs[:, None] - self.band_hi[None, :]), 0.0)
        return (factor * gap < radius + PRUNE_MARGIN).any(axis=0)

    def topk(self, queries: torch.Tensor, query_weights: np.ndarray,
             k: int, *, q_valid: int, deadline=None,
             info_out: dict | None = None,
             init_kth: np.ndarray | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Progressive band-expansion k-NN: (ids (Q, k'), dists (Q, k')),
        k' = min(k, n_alive), ascending by (distance, id), equal to
        `topk_rows` over the alive membership in id order.  `init_kth`
        seeds the certificate with a cross-partition k-th bound; columns
        it leaves unfilled carry KBEST_KEY_PAD ids and merge away.
        `deadline` bounds the walk: when it fires, `info_out` (if given)
        reports partial=True and the residual cert_gap; exact calls leave
        partial=False, cert_gap=0.0."""
        if info_out is not None:
            info_out.update(partial=False, cert_gap=0.0)
        if self._n_alive == 0 or k <= 0 or q_valid == 0:
            return (np.zeros((q_valid, 0), np.int64),
                    np.zeros((q_valid, 0), np.float32))
        qs = prune_score_host(np.asarray(query_weights)[:q_valid], self.d,
                              self.metric)
        st = None if (self._obs_off and info_out is None
                      and deadline is None) else {}
        pos, vals = allpairs.topk_rows_banded(
            queries, self.matrix, k, d=self.d, metric=self.metric,
            q_scores=qs, band_lo=self.band_lo, band_hi=self.band_hi,
            band_rows=self.band_rows, n_valid=self.n, order_by=self.ids,
            q_valid=q_valid, alive=self._mask(), stats_out=st,
            deadline=deadline, init_kth=init_kth)
        if st is not None and not self._obs_off:
            self._c_queries.inc()
            self._c_visited.inc(st["bands_visited"])
            self._c_pruned.inc(st["n_bands"] - st["bands_visited"])
            if st["early_stop"]:
                self._c_early.inc()
        if info_out is not None and st is not None:
            info_out.update(partial=st["partial"],
                            cert_gap=st["cert_gap"],
                            bands_visited=st["bands_visited"],
                            rows_visited=st["rows_visited"])
        # a budget-stopped walk, or a cross-partition bound, can leave
        # columns unfilled (pos == -1): they carry the KBEST pad id
        if (pos < 0).any():
            ids = np.full(pos.shape, KBEST_KEY_PAD, np.int64)
            real = pos >= 0
            ids[real] = self.ids[pos[real]]
            return ids, vals
        return self.ids[pos], vals

    def select(self, band_mask: np.ndarray
               ) -> tuple[torch.Tensor, int, np.ndarray]:
        """Gather the surviving bands' alive rows: (matrix (pow2, w),
        n_selected, ids (n_selected,))."""
        kept = np.flatnonzero(band_mask)
        if len(kept) == 0:
            return self.matrix[:0], 0, self.ids[:0]
        rows = np.concatenate([
            np.arange(b * self.band_rows,
                      min((b + 1) * self.band_rows, self.n))
            for b in kept])
        mask = self._mask()
        if mask is not None:
            rows = rows[mask[rows]]
        if len(rows) == 0:
            return self.matrix[:0], 0, self.ids[:0]
        return padded_take(self.matrix, rows), len(rows), self.ids[rows]
