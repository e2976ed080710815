"""The partition model: tiers, shards and spec tiers as one object.

The port of the JAX package's `repro.index.partition`:

  * `Partition`: one unit of serving state, a slot subset of one store
    (on the store's device), in one of two kinds: ``sorted-banded`` (a
    weight-banded `BandedLayout` served through the progressive band
    walk) or ``brute-delta`` (an unsorted slot list in id order, scanned
    brute-force), with the SketchSpec its rows were sketched under.
  * `PartitionSet`: the serving object the engine holds, `n_shards`
    (base, delta) groups over one store, rows routed by ``id % n_shards``
    (`shard_of`).  Fresh adds go to their shard's delta, removes flip
    alive masks, and `sync` advances the set across any version range of
    one slot epoch in O(delta); compaction rebuilds, and the `merge_ratio`
    policy folds each shard's delta into a new base on its own.
  * `merge_topk_parts`, `topk_across_tiers`, `radius_hits` and
    `snapshot_subtrees`: the one (value, id)-lexicographic merge across
    partitions, the same merge across partition sets (the mid-migration
    path), the per-tier radius collection, and one checkpoint subtree per
    backing store.

Partitions are disjoint and cover the alive membership, each returns an
exact (or, under the running k-th bound, a provably sufficient) k-best,
and the merge is the lexicographic rule `topk_rows_banded` uses across
chunks, so answers equal one scan over the membership at every shard
count.  In the port this holds bit for bit under both metrics: Cham is a
pure function of the integer statistics.

A deadline budgets every base partition's banded walk; a walk it stops
makes the answer partial, with the largest residual certificate gap.  The
merge is traced as the ``partition.merge`` span, and each partition's
alive rows are a ``partition_rows`` gauge.  A sharded rebuild crosses the
``shard.rebalance`` crash point before any group is replaced: layouts are
derived state, so the next sync simply retries.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import allpairs
from repro_torch.core.allpairs import KBEST_KEY_PAD, kbest_lex_merge
from repro_torch.core.packing import padded_take
from repro_torch.index.bands import BandedLayout
from repro_torch.index.mergeable import (MergeIncompatible,
                                        check_spec_compatible)
from repro_torch.index.store import SketchStore
from repro_torch.obs.registry import NULL_REGISTRY
from repro_torch.runtime import faultinject

_CP_REBALANCE = faultinject.declare("shard.rebalance")

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


def shard_of(ids: np.ndarray, n_shards: int) -> np.ndarray:
    """THE row-routing rule: ``id % n_shards``.  Deterministic and
    history-independent, and stable across compaction (ids survive, slots
    do not).  Slot-level routing is `SketchStore.route_slots`."""
    return np.asarray(ids, np.int64) % int(n_shards)


class Partition:
    """One tier of one shard: a slot subset of one store, on its device."""

    __slots__ = ("kind", "shard", "spec", "banded", "slots", "ids",
                 "_cache", "_store")

    def __init__(self, kind: str, shard: int, store: SketchStore, *,
                 metric: str | None = None, band_rows: int = 1024,
                 registry=None, slots: np.ndarray | None = None):
        if kind not in PARTITION_KINDS:
            raise ValueError(
                f"partition kind must be one of {PARTITION_KINDS}, "
                f"got {kind!r}")
        self.kind = kind
        self.shard = int(shard)
        self.spec = store.spec
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
        """The pow2-padded matrix on the store's device, gathered at first
        use after a sync (a copy, so later appends do not reach it)."""
        if self.banded is not None:
            return self.banded.matrix
        if self._cache is None and len(self.slots):
            self._cache = padded_take(self._store.sk_buf, self.slots)
        return self._cache


class _ShardGroup:
    """One shard's (base, delta) partition pair."""

    __slots__ = ("shard", "base", "delta")

    def __init__(self, shard: int, base: Partition, delta: Partition):
        self.shard = shard
        self.base = base
        self.delta = delta


class PartitionSet:
    """`n_shards` (base, delta) partition groups over one store: the
    engine's serving structure.

    Per shard, the base is a `BandedLayout` over the shard's membership at
    the last fold; fresh adds route by ``id % n_shards`` into per-shard
    brute-delta partitions; removes flip alive masks.  A shard's delta
    folds into a new base when its live rows exceed `merge_ratio *
    base_alive`, or when tombstones outnumber the base's alive rows,
    without touching its siblings (`merge_ratio=0` rebuilds on every
    mutation, None folds only on compaction).

    `topk` walks the groups in shard order with a global running k-th
    bound, which each banded walk receives as `init_kth`.  Every shard
    lives on the store's device.  `role` labels the gauges ("serve", or a
    migration tier's "migrate-dst" / "migrate-fresh").  `registry`
    receives the banding counters and the `partition_rows` gauges."""

    def __init__(self, store: SketchStore, metric: str,
                 band_rows: int = 1024, merge_ratio: float | None = 0.125,
                 registry=None, n_shards: int = 1, role: str = "serve"):
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.metric = metric
        self.d = store.d
        self.band_rows = int(band_rows)
        self.merge_ratio = merge_ratio
        self.registry = NULL_REGISTRY if registry is None else registry
        self.n_shards = int(n_shards)
        self.role = role
        self.n_merges = -1  # the initial build below is not a merge
        self._groups: list[_ShardGroup] = []
        self._rebuild(store)
        self._register_gauges()

    # -- construction / synchronisation ------------------------------------

    def _build_group(self, shard: int, store: SketchStore,
                     slots: np.ndarray) -> _ShardGroup:
        base = Partition("sorted-banded", shard, store, metric=self.metric,
                         band_rows=self.band_rows, registry=self.registry,
                         slots=slots)
        delta = Partition("brute-delta", shard, store)
        return _ShardGroup(shard, base, delta)

    def _rebuild(self, store: SketchStore) -> None:
        """Re-route the alive membership to shards and fold every shard
        into a fresh sorted base.  The groups are built aside and swapped
        in at the end: a crash at ``shard.rebalance`` leaves the previous
        groups in place, and the next sync retries."""
        if self.n_shards > 1:
            faultinject.crash_point(_CP_REBALANCE)
        slots = store.alive_slots()
        self._groups = [self._build_group(s, store, sh_slots)
                        for s, sh_slots in enumerate(
                            store.route_slots(slots, self.n_shards))]
        self._store = store
        # every row this set serves was sketched under this spec
        self.spec = store.spec
        st = store.stamp()
        self.version, self.epoch, self.seen_size = (
            st.version, st.epoch, st.size)
        self.seen_removed = store.removed_count
        self.n_merges += 1

    def _fold_group(self, g: _ShardGroup, store: SketchStore) -> None:
        """Shard-local merge: fold ONE shard's delta into its base; the
        siblings keep their layouts."""
        slots = store.alive_slots()
        if self.n_shards > 1:
            keep = shard_of(store.ids_at(slots), self.n_shards) == g.shard
            slots = slots[keep]
        fresh = self._build_group(g.shard, store, slots)
        g.base, g.delta = fresh.base, fresh.delta
        self.n_merges += 1

    def sync(self, store: SketchStore) -> "PartitionSet":
        """Advance to the store's current (version, epoch): adds within
        the epoch go to their shards' deltas, removes refresh the alive
        masks, an epoch change (compaction) or merge_ratio=0 rebuilds, and
        the fold policy folds only the shard that tripped it."""
        st = store.stamp()
        self._store = store
        if (st.version, st.epoch) == (self.version, self.epoch):
            return self
        if st.epoch != self.epoch or self.merge_ratio == 0:
            self._rebuild(store)
            return self
        added = st.size > self.seen_size
        new_by_shard = None
        if added:
            new_by_shard = store.route_slots(
                store.tail_slots(self.seen_size), self.n_shards)
            self.seen_size = st.size
        removed = store.removed_count != self.seen_removed
        if removed:
            self.seen_removed = store.removed_count
        for g in self._groups:
            if added:
                g.delta.extend(new_by_shard[g.shard])
            delta_mask = None
            if removed:
                g.base.banded.refresh_alive(store)
                delta_mask = store.alive_at(g.delta.slots)
                live_delta = int(np.count_nonzero(delta_mask))
            else:
                live_delta = len(g.delta.slots)
            base_alive = g.base.banded.n_alive
            dead_base = g.base.banded.n - base_alive
            if (self.merge_ratio is not None
                    and (live_delta > self.merge_ratio * max(base_alive, 1)
                         or dead_base > max(base_alive, 1))):
                self._fold_group(g, store)
                continue
            if added or removed:
                g.delta.refresh(store, delta_mask)
        self.version = st.version
        return self

    # -- merge (the Mergeable contract, repro_torch.index.mergeable) --------

    def merge(self, other: "PartitionSet | None" = None) -> "PartitionSet":
        """Absorb the backing store's just-merged rows and return self,
        called after `SketchStore.merge` committed.  Layouts are derived,
        so the merge IS a sync against the merged store: an append-path
        merge arrives as tail slots routed to each shard's delta, an
        interleave-path merge bumped the epoch and rebuilds.  `other` (the
        absorbed store's set, when there is one) is only validated; the
        gauges re-point at the live groups afterwards."""
        if other is not None:
            if other.metric != self.metric:
                raise MergeIncompatible(
                    f"PartitionSet.merge: metric mismatch "
                    f"({self.metric!r} vs {other.metric!r})")
            if self.spec is not None or other.spec is not None:
                check_spec_compatible(other.spec, self.spec,
                                      what="PartitionSet.merge")
        self.sync(self._store)
        self._register_gauges()
        return self

    # -- introspection ------------------------------------------------------

    def partitions(self) -> list[Partition]:
        """Every partition in shard order, base before delta."""
        out: list[Partition] = []
        for g in self._groups:
            out.append(g.base)
            out.append(g.delta)
        return out

    @property
    def base(self) -> BandedLayout:
        """The single-shard base tier; a sharded set has one per shard
        (iterate `partitions()`)."""
        if len(self._groups) != 1:
            raise AttributeError(
                f"a {self.n_shards}-shard PartitionSet has no single base "
                "tier; iterate partitions()")
        return self._groups[0].base.banded

    @property
    def delta_n(self) -> int:
        return sum(g.delta.n_rows for g in self._groups)

    @property
    def n_alive(self) -> int:
        return sum(g.base.n_rows + g.delta.n_rows for g in self._groups)

    @property
    def base_rows(self) -> int:
        return sum(g.base.banded.n for g in self._groups)

    @property
    def base_alive(self) -> int:
        return sum(g.base.banded.n_alive for g in self._groups)

    @property
    def n_bands(self) -> int:
        return sum(g.base.banded.n_bands for g in self._groups)

    # -- obs ----------------------------------------------------------------

    def _register_gauges(self) -> None:
        """`partition_rows` labelled by (shard, kind, role, device): read-
        time callbacks onto the live groups, so a fold or rebalance shows
        at the next scrape.  Re-registering the same labels (a successor
        set) points them at the newest set."""
        if self.registry.is_null:
            return
        for g in self._groups:
            for kind in PARTITION_KINDS:
                self.registry.gauge_fn(
                    "partition_rows",
                    (lambda s=g.shard, k=kind: float(self._rows_of(s, k))),
                    shard=str(g.shard), kind=kind, role=self.role,
                    device=str(self._store.device))

    def _rows_of(self, shard: int, kind: str) -> int:
        if shard >= len(self._groups):
            return 0
        g = self._groups[shard]
        return g.base.n_rows if kind == "sorted-banded" else g.delta.n_rows

    # -- serving ------------------------------------------------------------

    def topk(self, queries: torch.Tensor, query_weights: np.ndarray, k: int,
             *, q_valid: int, deadline=None, info_out: dict | None = None,
             init_kth: np.ndarray | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Cross-partition k-NN: (ids (Q, k'), dists (Q, k')), k' = min(k,
        n_alive), ascending by (distance, id), equal to one scan over the
        alive membership at every shard count.  Groups are walked in shard
        order, base then delta; the running global k-th bound tightens
        after every merge and enters the next banded walk as `init_kth`
        (`init_kth` seeds it from partitions outside this set).
        `deadline` budgets every banded walk (the delta scans are O(delta)
        and exact); `info_out` receives `partial`, the largest `cert_gap`
        and the bands and rows visited."""
        if info_out is not None:
            info_out.update(partial=False, cert_gap=0.0)
        kk = min(k, self.n_alive)
        if kk <= 0 or q_valid == 0:
            return (np.zeros((q_valid, 0), np.int64),
                    np.zeros((q_valid, 0), np.float32))
        best: tuple[np.ndarray, np.ndarray] | None = None
        running = (None if init_kth is None
                   else np.asarray(init_kth, np.float32)[:q_valid])
        partial, cert_gap = False, 0.0
        bands_visited = rows_visited = 0
        want_info = info_out is not None or deadline is not None
        with obs.span("partition.merge", shards=self.n_shards, k=kk,
                      role=self.role):
            for g in self._groups:
                if g.base.banded.n_alive:
                    st: dict | None = {} if want_info else None
                    part = g.base.banded.topk(
                        queries, query_weights, kk, q_valid=q_valid,
                        deadline=deadline, info_out=st, init_kth=running)
                    if st is not None:
                        partial |= bool(st.get("partial"))
                        cert_gap = max(cert_gap, st.get("cert_gap", 0.0))
                        bands_visited += st.get("bands_visited", 0)
                        rows_visited += st.get("rows_visited", 0)
                    best = (part if best is None
                            else merge_topk_parts(kk, [best, part]))
                    running = _tighten(running, best[1], kk)
                if g.delta.n_rows:
                    # pad_k keeps k == kk while the delta holds fewer rows
                    pos, vals = allpairs.topk_rows(
                        queries[:q_valid], g.delta.matrix, kk, d=self.d,
                        metric=self.metric, m_valid=g.delta.n_rows,
                        pad_k=True)
                    ids = np.full(pos.shape, KBEST_KEY_PAD, np.int64)
                    real = pos >= 0
                    ids[real] = g.delta.ids[pos[real]]
                    part = (ids, vals)
                    best = (part if best is None
                            else merge_topk_parts(kk, [best, part]))
                    running = _tighten(running, best[1], kk)
        if info_out is not None:
            info_out.update(partial=partial, cert_gap=cert_gap,
                            bands_visited=bands_visited,
                            rows_visited=rows_visited)
        assert best is not None  # kk > 0 implies some non-empty partition
        return best

    def radius_tiers(self, query_weights: np.ndarray, radius: float
                     ) -> list[tuple[torch.Tensor, int, np.ndarray]]:
        """Per-partition (matrix, n_selected, ids) selections for a radius
        query: each shard's base after its band prune, each delta whole.
        The memberships partition the alive set, so the per-tier hits
        union to the answer over the full membership."""
        out = []
        for g in self._groups:
            bl = g.base.banded
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
            if g.delta.n_rows:
                out.append((g.delta.matrix, g.delta.n_rows, g.delta.ids))
        return out


# the n_shards=1 face of PartitionSet, the name the JAX package keeps
TieredLayout = PartitionSet


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


def snapshot_subtrees(store: SketchStore, raw=None, migration=None) -> dict:
    """One checkpoint subtree per backing store (layouts are derived state
    and never saved: a restored engine rebuilds them, sharded or not).
    The subtree names are the JAX package's ``repro.index.v2`` format."""
    tree: dict = {"store": store.state_tree()}
    if raw is not None:
        tree["raw"] = raw.state_tree()
    if migration is not None:
        tree["mig_dst"] = migration.dst.state_tree()
        tree["mig_fresh"] = migration.fresh.state_tree()
    return tree
