"""The partition model: a base tier and a delta tier over one store.

The port of the JAX package's `repro.index.partition` at one shard:

  * `Partition`: one tier of serving state, a slot subset of one store in
    one of two kinds: ``sorted-banded`` (a weight-banded `BandedLayout`
    served through the progressive band walk) or ``brute-delta`` (an
    unsorted slot list in id order, scanned brute-force).
  * `PartitionSet`: the serving object the engine holds, a (base, delta)
    pair.  Fresh adds go to the delta, removes flip alive masks, and
    `sync` advances the set across any version range of one slot epoch in
    O(delta); compaction rebuilds, and the `merge_ratio` policy folds the
    delta into a new base.
  * `merge_topk_parts`, `topk_across_tiers` and `radius_hits`: the one
    (value, id)-lexicographic merge across partitions, the same merge
    across partition sets, and the per-tier radius collection.

Partitions are disjoint and cover the alive membership, each returns an
exact (or, under the running k-th bound, a provably sufficient) k-best,
and the merge is the lexicographic rule `topk_rows_banded` uses across
chunks, so answers equal one scan over the membership.

A deadline budgets the base partition's banded walk; a walk it stops
makes the answer partial, with the walk's residual certificate gap.  The
merge is traced as the ``partition.merge`` span, and each partition's
alive rows are a ``partition_rows`` gauge.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import allpairs
from repro_torch.core.allpairs import KBEST_KEY_PAD, kbest_lex_merge
from repro_torch.core.packing import padded_take
from repro_torch.index.bands import BandedLayout
from repro_torch.index.store import SketchStore
from repro_torch.obs.registry import NULL_REGISTRY

PARTITION_KINDS = ("sorted-banded", "brute-delta")


def merge_topk_parts(kk: int, parts: list[tuple[np.ndarray, np.ndarray]]
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-partition k-best lists (ids (Q, <=kk), vals (Q, <=kk)),
    over DISJOINT partitions, into the exact (value, id)-lexicographic
    k-best.  Short lists are padded with (KBEST_KEY_PAD, inf)."""
    if kk < 0:
        raise ValueError(f"merge_topk_parts: k must be >= 0, got {kk}")
    if len(parts) == 0:
        return (np.zeros((0, kk), np.int64), np.zeros((0, kk), np.float32))
    if len(parts) == 1:
        return parts[0]

    def pad_cols(ids: np.ndarray, vals: np.ndarray):
        have = ids.shape[1]
        if have == kk:
            return ids, vals
        padw = ((0, 0), (0, kk - have))
        return (np.pad(ids, padw, constant_values=KBEST_KEY_PAD),
                np.pad(vals, padw, constant_values=np.inf))

    padded = [pad_cols(i, v) for i, v in parts]
    vals, ids = kbest_lex_merge(
        kk, np.concatenate([v for _, v in padded], axis=1),
        np.concatenate([i for i, _ in padded], axis=1))
    return ids, vals


def _tighten(running: np.ndarray | None, vals: np.ndarray, kk: int
             ) -> np.ndarray | None:
    """Fold a merged candidate list into the running global k-th bound."""
    if vals.shape[1] < kk:
        return running
    kth = vals[:, kk - 1]
    return kth.copy() if running is None else np.minimum(running, kth)


class Partition:
    """One tier of serving state over a slot subset of one store."""

    __slots__ = ("kind", "banded", "slots", "ids", "_cache", "_store")

    def __init__(self, kind: str, store: SketchStore, *,
                 metric: str | None = None, band_rows: int = 1024,
                 registry=None, slots: np.ndarray | None = None):
        if kind not in PARTITION_KINDS:
            raise ValueError(
                f"partition kind must be one of {PARTITION_KINDS}, "
                f"got {kind!r}")
        self.kind = kind
        self._store = store
        if kind == "sorted-banded":
            self.banded = BandedLayout(store, metric, band_rows=band_rows,
                                       registry=registry, slots=slots)
            self.slots = self.banded.slots
            self.ids = self.banded.ids
        else:
            self.banded = None
            self.slots = (np.zeros(0, np.int64) if slots is None
                          else np.asarray(slots, np.int64))
            self.ids = store.ids_at(self.slots)
        self._cache: torch.Tensor | None = None

    @property
    def n_rows(self) -> int:
        """Alive rows this partition serves."""
        if self.banded is not None:
            return self.banded.n_alive
        return len(self.slots)

    def extend(self, slots: np.ndarray) -> None:
        """Append fresh store slots (brute-delta only)."""
        if len(slots):
            self.slots = np.concatenate([self.slots, slots])
            self._cache = None

    def refresh(self, store: SketchStore,
                mask: np.ndarray | None = None) -> None:
        """Drop tombstoned slots (`mask`: their alive bitmap) and re-read
        the id map (brute-delta only)."""
        if mask is not None and not mask.all():
            self.slots = self.slots[mask]
            self._cache = None
        if len(self.slots) != len(self.ids):
            self._cache = None
        self.ids = store.ids_at(self.slots)
        self._store = store

    @property
    def matrix(self) -> torch.Tensor | None:
        """The pow2-padded device matrix, gathered at first use after a
        sync (a copy, so later appends to the store do not reach it)."""
        if self.banded is not None:
            return self.banded.matrix
        if self._cache is None and len(self.slots):
            self._cache = padded_take(self._store.sk_buf, self.slots)
        return self._cache


class PartitionSet:
    """A (base, delta) partition pair over one store: the engine's serving
    structure.

    The base is a `BandedLayout` over the membership at the last fold;
    fresh adds go to the brute-delta partition; removes flip alive masks.
    The delta folds into a new base when its live rows exceed
    `merge_ratio * base_alive`, or when tombstones outnumber the base's
    alive rows (`merge_ratio=0` rebuilds on every mutation, None folds
    only on compaction).  `registry` receives the banding counters and the
    `partition_rows` gauges."""

    def __init__(self, store: SketchStore, metric: str,
                 band_rows: int = 1024, merge_ratio: float | None = 0.125,
                 registry=None):
        self.metric = metric
        self.d = store.d
        self.band_rows = int(band_rows)
        self.merge_ratio = merge_ratio
        self.registry = NULL_REGISTRY if registry is None else registry
        self.n_merges = -1  # the initial build below is not a merge
        self._rebuild(store)
        self._register_gauges(store.device)

    def _rebuild(self, store: SketchStore) -> None:
        """Fold the whole alive membership into a fresh sorted base."""
        self.base = Partition("sorted-banded", store, metric=self.metric,
                              band_rows=self.band_rows,
                              registry=self.registry,
                              slots=store.alive_slots())
        self.delta = Partition("brute-delta", store)
        st = store.stamp()
        self.version, self.epoch, self.seen_size = (
            st.version, st.epoch, st.size)
        self.seen_removed = store.removed_count
        self.n_merges += 1

    def sync(self, store: SketchStore) -> "PartitionSet":
        """Advance to the store's current (version, epoch): adds within
        the epoch extend the delta, removes refresh the alive masks, and
        an epoch change (compaction), merge_ratio=0 or the fold policy
        rebuilds."""
        st = store.stamp()
        if (st.version, st.epoch) == (self.version, self.epoch):
            return self
        if st.epoch != self.epoch or self.merge_ratio == 0:
            self._rebuild(store)
            return self
        added = st.size > self.seen_size
        if added:
            self.delta.extend(store.tail_slots(self.seen_size))
            self.seen_size = st.size
        removed = store.removed_count != self.seen_removed
        delta_mask = None
        if removed:
            self.seen_removed = store.removed_count
            self.base.banded.refresh_alive(store)
            delta_mask = store.alive_at(self.delta.slots)
            live_delta = int(np.count_nonzero(delta_mask))
        else:
            live_delta = len(self.delta.slots)
        base_alive = self.base.banded.n_alive
        dead_base = self.base.banded.n - base_alive
        if (self.merge_ratio is not None
                and (live_delta > self.merge_ratio * max(base_alive, 1)
                     or dead_base > max(base_alive, 1))):
            self._rebuild(store)
            return self
        if added or removed:
            self.delta.refresh(store, delta_mask)
        self.version = st.version
        return self

    # -- introspection ------------------------------------------------------

    @property
    def delta_n(self) -> int:
        return self.delta.n_rows

    @property
    def n_alive(self) -> int:
        return self.base.n_rows + self.delta.n_rows

    @property
    def base_rows(self) -> int:
        return self.base.banded.n

    @property
    def base_alive(self) -> int:
        return self.base.banded.n_alive

    @property
    def n_bands(self) -> int:
        return self.base.banded.n_bands

    # -- obs ----------------------------------------------------------------

    def _register_gauges(self, device: torch.device) -> None:
        """`partition_rows` labelled by (shard, kind, role, device): read-
        time callbacks onto the live partitions, so a fold is visible at
        the next scrape.  One shard and the serving role: shards and
        migration tiers come with later slices of the port."""
        if self.registry.is_null:
            return
        for kind, rows in (("sorted-banded", lambda: self.base.n_rows),
                           ("brute-delta", lambda: self.delta.n_rows)):
            self.registry.gauge_fn(
                "partition_rows", (lambda rows=rows: float(rows())),
                shard="0", kind=kind, role="serve", device=str(device))

    # -- serving ------------------------------------------------------------

    def topk(self, queries: torch.Tensor, query_weights: np.ndarray, k: int,
             *, q_valid: int, deadline=None, info_out: dict | None = None,
             init_kth: np.ndarray | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Cross-partition k-NN: (ids (Q, k'), dists (Q, k')), k' = min(k,
        n_alive), ascending by (distance, id).  The base walk runs first;
        its k-th bound (with `init_kth`, a bound from outside this set)
        cannot help the brute-force delta scan, which is already exact.
        `deadline` budgets the banded walk (the delta scan is O(delta) and
        exact); `info_out` receives the walk's report (`partial`,
        `cert_gap`, bands and rows visited)."""
        if info_out is not None:
            info_out.update(partial=False, cert_gap=0.0)
        kk = min(k, self.n_alive)
        if kk <= 0 or q_valid == 0:
            return (np.zeros((q_valid, 0), np.int64),
                    np.zeros((q_valid, 0), np.float32))
        best: tuple[np.ndarray, np.ndarray] | None = None
        running = (None if init_kth is None
                   else np.asarray(init_kth, np.float32)[:q_valid])
        with obs.span("partition.merge", shards=1, k=kk, role="serve"):
            if self.base.banded.n_alive:
                best = self.base.banded.topk(
                    queries, query_weights, kk, q_valid=q_valid,
                    deadline=deadline, info_out=info_out, init_kth=running)
            if self.delta.n_rows:
                # pad_k keeps k == kk while the delta holds fewer rows
                pos, vals = allpairs.topk_rows(
                    queries[:q_valid], self.delta.matrix, kk, d=self.d,
                    metric=self.metric, m_valid=self.delta.n_rows,
                    pad_k=True)
                ids = np.full(pos.shape, KBEST_KEY_PAD, np.int64)
                real = pos >= 0
                ids[real] = self.delta.ids[pos[real]]
                part = (ids, vals)
                best = (part if best is None
                        else merge_topk_parts(kk, [best, part]))
        return best

    def radius_tiers(self, query_weights: np.ndarray, radius: float
                     ) -> list[tuple[torch.Tensor, int, np.ndarray]]:
        """Per-partition (matrix, n_selected, ids) selections for a radius
        query: the base after its band prune, the delta whole."""
        out = []
        bl = self.base.banded
        if bl.n_alive:
            mask = bl.candidate_bands(query_weights, radius)
            if not self.registry.is_null:
                kept = int(np.count_nonzero(mask))
                bl._c_queries.inc()
                bl._c_visited.inc(kept)
                bl._c_pruned.inc(bl.n_bands - kept)
            sel, n_sel, sel_ids = bl.select(mask)
            if n_sel:
                out.append((sel, n_sel, sel_ids))
        if self.delta.n_rows:
            out.append((self.delta.matrix, self.delta.n_rows, self.delta.ids))
        return out


def topk_across_tiers(kk: int, tiers, *, q_valid: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Global (value, id)-lex k-best across PARTITION SETS: `tiers` is a
    list of (layout, queries, query_weights); the running k-th bound
    threads across the sets as `init_kth`."""
    best: tuple[np.ndarray, np.ndarray] | None = None
    running: np.ndarray | None = None
    with obs.span("partition.merge", tiers=len(tiers), k=kk):
        for layout, queries, query_weights in tiers:
            part = layout.topk(queries, query_weights, kk, q_valid=q_valid,
                               init_kth=running)
            best = (part if best is None
                    else merge_topk_parts(kk, [best, part]))
            running = _tighten(running, best[1], kk)
    if best is None:
        return (np.zeros((q_valid, 0), np.int64),
                np.zeros((q_valid, 0), np.float32))
    return best


def radius_hits(layout: PartitionSet, queries: torch.Tensor,
                query_weights: np.ndarray, q: int, r: float, *,
                metric: str, block: int,
                hits: list[list[np.ndarray]]) -> None:
    """Accumulate one PartitionSet's radius hits into per-query buckets:
    per-partition threshold scans, then one sort/group pass each."""
    for sel, n_sel, sel_ids in layout.radius_tiers(query_weights, r):
        pairs = allpairs.threshold_pairs(
            queries, sel, d=layout.d, threshold=r, metric=metric,
            block=block, n_valid=q, m_valid=n_sel)
        by_q = pairs[np.argsort(pairs[:, 0], kind="stable")]
        splits = np.searchsorted(by_q[:, 0], np.arange(q + 1))
        for qi in range(q):
            seg = sel_ids[by_q[splits[qi]: splits[qi + 1], 1]]
            if seg.size:
                hits[qi].append(seg)
