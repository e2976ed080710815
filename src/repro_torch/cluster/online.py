"""ClusterIndex: k-medoid centres and per-row labels over a live index.

The port of the JAX package's `repro.cluster.online`, on the engine's
device: assignment runs the fused top-k select kernel at k = 1 over the
centres, refits the k-medoid engine's row argmin and row sums (pair stats
and row popcounts), and the re-sketch of the centres at a migration the
sparse Cabin kernel; on the CPU their plain versions.

`core.kmode.kmode_packed` answers the one-shot question "cluster this
matrix"; a serving system owns a COLLECTION that mutates between questions.
ClusterIndex is the bridge: it subscribes to the
ENGINE's mutation events (`QueryEngine.subscribe` — the engine relays its
stores' events and knows which store each belongs to, which matters once a
spec migration has several in flight), so rows added through ANY path
(engine.add_dense / add_sparse / add_packed, streaming ingest) are assigned
to their nearest centre the moment they land, removes decrement the cluster
bookkeeping, and compaction is a no-op (labels are keyed by external id,
which compaction preserves).

The data engine's layout topology is invisible here: a `shard(n_shards=)`-ed
engine emits the same mutation events and answers the same bits, so
ClusterIndex works unchanged on a sharded engine — assignment queries go
to the private centres engine, which stays unsharded (k rows never need
scale-out).

Three disciplines, all inherited rather than reinvented:

  * Assignment IS a k-NN query.  Centres live in a private k-row
    QueryEngine; assigning a batch is `topk_packed(k=1)` against it, which
    buys the serving stack's valid counts and LRU for free — and its
    (value, id)-lex tie-break equals `argmin_rows`'
    first-minimum tie-break because centre ids are centre indices, so
    incremental assignment agrees exactly with what a `refit` would assign
    against the same centres.
  * Refit is deterministic in the membership.  `refit()` gathers the alive
    rows in id order (the store's history-independent canonical order) and
    runs the full-batch device engine with the index's fixed seed: two
    stores holding the same membership — however they got there, including
    through save/restore — refit to identical centres and labels.  The
    property tests pin this.
  * Snapshots ride the store's.  `save` writes the engine snapshot plus a
    `cluster/` Checkpointer tree (the JAX package's format: either package
    restores the other's) (centres, label sidecar, counts/weights),
    and `restore` reproduces the exact live state — including labels
    assigned incrementally since the last refit, which a re-fit would not
    reproduce (they depend on arrival order by design).

Between refits, labels of rows added incrementally are path-dependent
(each batch is assigned against the centres of its arrival moment); the
invariance contract applies AFTER `refit()`, which is the point of having
one.  `refit_every=n` auto-refits once n mutations accumulate.

Spec migrations are survived, not merely tolerated:
`refit` captures the medoids' RAW rows (from the engine's archive), so when
the engine emits "migrate_start" the centres are re-sketched under the new
spec — rows arriving mid-migration (new-spec sketches) assign against
new-spec centres, labels/counts carry over unchanged (membership did not
move), and a pending auto-refit is deferred to the "migrate" publish event
(a mid-migration membership spans two sketch spaces and cannot be refit).
A ClusterIndex whose centres predate the raw capture (e.g. restored from a
v1 snapshot) raises at migrate_start with instructions to `refit()` first.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch import obs
from repro_torch.core.kmode import kmode_packed
from repro_torch.core.packing import pad_rows_pow2, padded_take
from repro_torch.device import on_device
from repro_torch.index.engine import QueryEngine
from repro_torch.index.mergeable import MergeIncompatible


class ClusterIndex:
    """Online k-medoid clustering attached to a QueryEngine.

    Parameters
    ----------
    engine : the QueryEngine whose store is being clustered.  The index
        subscribes to the store's mutation events at construction; if the
        store already holds rows, an initial `refit()` runs immediately,
        otherwise the first `add` bootstraps it.
    k : number of clusters (>= 1; k > n is legal — degenerate clusters
        simply stay empty or share duplicate centres, matching kmode).
    seed / n_iter / block : forwarded to `kmode_packed` on every refit —
        fixed at construction so refits are a pure function of membership.
        Refits and assignment run on the engine's device.
    refit_every : auto-refit after this many mutated rows (None = manual).
    """

    def __init__(self, engine: QueryEngine, k: int, *, seed: int = 0,
                 n_iter: int = 15, block: int = 2048,
                 refit_every: int | None = None):
        if k < 1:
            raise ValueError(f"ClusterIndex: k must be >= 1, got {k}")
        if n_iter < 1:
            raise ValueError(
                f"ClusterIndex: n_iter must be >= 1, got {n_iter}")
        if refit_every is not None and refit_every < 1:
            raise ValueError(
                f"ClusterIndex: refit_every must be >= 1, got {refit_every}")
        self.engine = engine
        self.k = int(k)
        self.seed = int(seed)
        self.n_iter = int(n_iter)
        self.block = int(block)
        self.refit_every = refit_every
        self._centers: np.ndarray | None = None   # (k, w) packed, host
        self._medoid_ids = np.full(self.k, -1, np.int64)
        # medoids' raw COO rows (idx, val), captured at refit — what lets
        # the centres be re-sketched when the engine migrates specs
        self._center_raw: tuple[np.ndarray, np.ndarray] | None = None
        self._centre_engine: QueryEngine | None = None
        self._centre_ids = np.zeros(0, np.int64)
        # label sidecar over the ALIVE rows, ascending by external id (ids
        # are monotone and adds append, so order is maintained for free)
        self._lab_ids = np.zeros(0, np.int64)
        self._lab = np.zeros(0, np.int64)
        self._counts = np.zeros(self.k, np.int64)
        self._weights = np.zeros(self.k, np.int64)
        self.mutations_since_refit = 0
        self.n_refits = 0
        self._refit_pending = False
        self._wire_obs()
        engine.subscribe(self._on_engine_event)
        if len(engine):
            self.refit()

    def _wire_obs(self) -> None:
        """Assignment is a query op like topk/radius: its latency lands in
        the OWNING engine's `engine_query_latency_ms` histogram under
        op="assign" (the private centre engine runs on the null registry —
        its internal hits would pollute the real engine's counters)."""
        self._h_assign = self.engine.obs.histogram(
            "engine_query_latency_ms", op="assign")
        self._c_refits = self.engine.obs.counter("cluster_refits_total")

    def detach(self) -> None:
        """Stop observing the engine.  The engine holds a strong reference
        to every subscriber, so an abandoned index would keep paying a k-NN
        assignment per add forever — detach before replacing one (e.g. to
        change k or seed)."""
        self.engine.unsubscribe(self._on_engine_event)

    # -- introspection ------------------------------------------------------

    @property
    def fitted(self) -> bool:
        return self._centers is not None

    @property
    def counts(self) -> np.ndarray:
        """Alive rows per cluster, (k,) int64 (a copy)."""
        return self._counts.copy()

    @property
    def weights(self) -> np.ndarray:
        """Summed sketch Hamming weight of alive rows per cluster — the
        cheap density signal band planning already mirrors on host."""
        return self._weights.copy()

    @property
    def centers(self) -> np.ndarray:
        """Packed centre rows (k, w) int32 (a copy)."""
        self._require_fit()
        return self._centers.copy()

    @property
    def medoid_ids(self) -> np.ndarray:
        """External id each centre was elected from at the last refit
        (-1 for clusters whose medoid id predates the sidecar, e.g. after
        a restore of an unfitted snapshot)."""
        return self._medoid_ids.copy()

    def labels(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, labels) over the alive rows, ascending by id (copies)."""
        return self._lab_ids.copy(), self._lab.copy()

    def label_of(self, ids) -> np.ndarray:
        """Cluster of each external id; KeyError on unknown/removed ids."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if len(ids) == 0:
            return np.zeros(0, np.int64)
        n = len(self._lab_ids)
        pos = np.searchsorted(self._lab_ids, ids)
        ok = pos < n
        if n:
            ok &= self._lab_ids[np.minimum(pos, n - 1)] == ids
        if not ok.all():
            raise KeyError(f"id {ids[~ok][0]} not in cluster index")
        return self._lab[pos]

    def stats(self) -> dict:
        return {
            "k": self.k,
            "fitted": self.fitted,
            "n_labeled": len(self._lab_ids),
            "counts": self._counts.tolist(),
            "n_refits": self.n_refits,
            "mutations_since_refit": self.mutations_since_refit,
        }

    # -- assignment (the engine's own serving path) -------------------------

    def _require_fit(self) -> None:
        if self._centers is None:
            raise RuntimeError(
                "ClusterIndex has no centres yet: add rows (the first add "
                "bootstraps a fit) or call refit() on a non-empty store")

    def _ids_to_clusters(self, ids: np.ndarray) -> np.ndarray:
        if ids.shape[1] == 0:  # empty query batch: topk returns (0, 0)
            return np.zeros(ids.shape[0], np.int64)
        return np.searchsorted(self._centre_ids, ids[:, 0]).astype(np.int64)

    def _assign_packed(self, sk, n_valid: int) -> np.ndarray:
        """Nearest-centre labels for packed query rows via the centre
        engine's topk_packed(k=1) — the LRU for free, and the
        (value, id)-lex tie-break equals argmin's first minimum because
        centre ids are centre indices."""
        with self._h_assign.time(), obs.span("cluster.assign",
                                             rows=int(n_valid)):
            ids, _ = self._centre_engine.topk_packed(sk, 1, n_valid=n_valid)
        return self._ids_to_clusters(ids)

    def assign(self, queries) -> np.ndarray:
        """Label raw categorical queries (dense rows or (indices, values)
        COO) WITHOUT ingesting them — the read-only classification path."""
        self._require_fit()
        ids, _ = self._centre_engine.topk(queries, 1)
        return self._ids_to_clusters(ids)

    def assign_packed(self, sk) -> np.ndarray:
        """Pre-sketched twin of `assign` (rows must share the engine's
        CabinParams)."""
        self._require_fit()
        sk = on_device(sk, self.engine.device)
        return self._assign_packed(pad_rows_pow2(sk), n_valid=sk.shape[0])

    # -- mutation mirror (engine hook) --------------------------------------

    def _bincount(self, lab: np.ndarray, weights=None) -> np.ndarray:
        """bincount over the k clusters, ignoring unlabeled (-1) rows —
        rows added to an UNFITTED index mid-migration carry -1 until the
        deferred bootstrap refit at publish."""
        m = lab >= 0
        return np.bincount(
            lab[m], weights=None if weights is None else weights[m],
            minlength=self.k).astype(np.int64)

    def _on_engine_event(self, event: str, ids: np.ndarray,
                         slots: np.ndarray, store) -> None:
        if event == "add":
            if self._centers is None:
                if self.engine.migrating:
                    # cannot refit a membership spanning two sketch spaces;
                    # bootstrap at publish, rows carry -1 until then
                    self._refit_pending = True
                    lab = np.full(len(ids), -1, np.int64)
                else:
                    self.refit()  # bootstrap covers these rows too
                    return
            else:
                # `store` is the originating tier, so the gathered sketches
                # share a spec with the centre engine even mid-migration
                # (migrate_start re-sketched the centres before any add
                # could land in the new-spec tier)
                sk = padded_take(store.sk_buf, slots)
                lab = self._assign_packed(sk, n_valid=len(ids))
            self._lab_ids = np.concatenate([self._lab_ids, ids])
            self._lab = np.concatenate([self._lab, lab])
            self._counts += self._bincount(lab)
            self._weights += self._bincount(lab, store.weights_at(slots))
        elif event == "merge":
            # another store's alive rows just landed (SketchStore.merge);
            # their ids may interleave with the sidecar's, so labels insert
            # at their sorted positions instead of concatenating.  Counts
            # and weights are sums — the Mergeable discipline.  These
            # incremental labels are arrival-moment assignments like any
            # add's; ClusterIndex.merge refits afterwards to re-seed the
            # centres from the union membership.
            if len(ids) == 0:
                return
            if self._centers is None:
                self.refit()  # bootstrap covers the merged rows too
                return
            sk = padded_take(store.sk_buf, slots)
            lab = self._assign_packed(sk, n_valid=len(ids))
            pos = np.searchsorted(self._lab_ids, ids)
            self._lab_ids = np.insert(self._lab_ids, pos, ids)
            self._lab = np.insert(self._lab, pos, lab)
            self._counts += self._bincount(lab)
            self._weights += self._bincount(lab, store.weights_at(slots))
        elif event == "remove":
            pos = np.searchsorted(self._lab_ids, ids)
            lab = self._lab[pos]
            self._counts -= self._bincount(lab)
            self._weights -= self._bincount(lab, store.weights_at(slots))
            keep = np.ones(len(self._lab_ids), bool)
            keep[pos] = False
            self._lab_ids = self._lab_ids[keep]
            self._lab = self._lab[keep]
        elif event == "migrate_start":
            self._resketch_centers(store)
            return
        elif event == "migrate":
            # per-cluster weights were accumulated per-row under each row's
            # own spec; now every row is under the new spec — rebuild the
            # signal in one pass (store.weights() is id-ordered, exactly
            # the sidecar's order)
            if len(self._lab_ids):
                self._weights = self._bincount(
                    self._lab, store.weights().astype(np.float64))
            if self._refit_pending:
                self._refit_pending = False
                self.refit()
            return
        else:  # compact: ids (hence the sidecar) survive slot renumbering
            return
        self.mutations_since_refit += len(ids)
        if (self.refit_every is not None
                and self.mutations_since_refit >= self.refit_every):
            if self.engine.migrating:
                self._refit_pending = True  # refit at the "migrate" event
            else:
                self.refit()

    # -- (re)fitting --------------------------------------------------------

    def refit(self, n_iter: int | None = None) -> np.ndarray:
        """Re-cluster the current membership with the device engine and
        return the new labels (id order).

        Deterministic in the membership: the alive rows are gathered in id
        order (history-independent) and `kmode_packed` runs with the
        index's fixed seed, so any two stores holding the same vectors
        under the same ids — regardless of the add/remove/compact/restore
        history between — refit to identical centres, labels, counts.  An
        empty store resets to the unfitted state.

        Unavailable while a spec migration is in flight (the membership
        spans two sketch spaces); refits requested by `refit_every` during
        one run automatically once the migration publishes."""
        if self.engine.migrating:
            raise RuntimeError(
                "refit() is unavailable while a spec migration is in "
                "flight: the membership spans two sketch spaces.  Drive "
                "the migration to completion (engine.migrate_all()) first; "
                "auto-refits are deferred to the publish automatically")
        store = self.engine.store
        mat, n_alive, ids = store.gather_alive()
        if n_alive == 0:
            self._centers = None
            self._center_raw = None
            self._centre_engine = None
            self._centre_ids = np.zeros(0, np.int64)
            self._medoid_ids = np.full(self.k, -1, np.int64)
            self._lab_ids = np.zeros(0, np.int64)
            self._lab = np.zeros(0, np.int64)
            self._counts = np.zeros(self.k, np.int64)
            self._weights = np.zeros(self.k, np.int64)
            self.mutations_since_refit = 0
            return np.zeros(0, np.int64)
        with obs.span("cluster.refit", rows=int(n_alive), k=self.k):
            res = kmode_packed(
                mat[:n_alive], self.k, d=store.d,
                n_iter=self.n_iter if n_iter is None else n_iter,
                seed=self.seed, metric=self.engine.metric, block=self.block,
                device=self.engine.device)
        self._medoid_ids = ids[res.medoids]
        self._lab_ids = ids.copy()
        self._lab = res.labels
        self._counts = np.bincount(res.labels, minlength=self.k)
        self._weights = np.bincount(
            res.labels, weights=store.weights(),
            minlength=self.k).astype(np.int64)
        self._install_centers(res.centers)
        self._capture_center_raw()
        self.mutations_since_refit = 0
        self.n_refits += 1
        self._c_refits.inc()
        return res.labels.copy()

    def _capture_center_raw(self) -> None:
        """Copy the medoids' raw COO rows out of the engine's archive — a
        k-medoid centre IS a data row, so its raw form re-sketches to the
        centre under any spec.  No archive (keep_raw=False, or medoids from
        a pre-archive snapshot) leaves the capture empty; a later
        migrate_start then fails loudly instead of serving old-spec
        centres against new-spec rows."""
        raw = self.engine.raw
        if raw is None or len(raw.missing(self._medoid_ids)):
            self._center_raw = None
            return
        idx, val = raw.batch(self._medoid_ids)
        self._center_raw = (idx.copy(), val.copy())

    def _resketch_centers(self, dst_store) -> None:
        """migrate_start: rebuild the centre engine under the new spec from
        the captured raw medoids, so mid-migration arrivals (sketched under
        the new spec) assign against centres in the SAME sketch space."""
        if self._centers is None:
            return
        if self._center_raw is None:
            raise RuntimeError(
                "ClusterIndex centres cannot follow the spec migration: no "
                "raw medoid capture (centres predate the archive, e.g. a "
                "v1 snapshot, or keep_raw=False).  refit() before "
                "engine.migrate()")
        params = dst_store.spec.params
        sk, k = self.engine._sketch(self._center_raw, params=params)
        self._install_centers(sk[:k].cpu().numpy(), params=params)

    def _install_centers(self, centers: np.ndarray,
                         params=None) -> None:
        """(Re)build the private centre engine: k packed rows whose ids ARE
        the centre indices (fresh store, ids 0..k-1).  `params` pins the
        sketch space (default: the engine's current params)."""
        self._centers = np.asarray(centers, np.int32)
        self._centre_engine = QueryEngine(
            params if params is not None else self.engine.params,
            metric=self.engine.metric, block=self.block, keep_raw=False,
            device=self.engine.device, registry=obs.NULL_REGISTRY)
        self._centre_ids = self._centre_engine.add_packed(self._centers)

    # -- convenience mutation wrappers --------------------------------------

    def add_dense(self, x) -> tuple[np.ndarray, np.ndarray]:
        """Ingest via the engine; returns (ids, labels) of the new rows."""
        ids = self.engine.add_dense(x)
        return ids, self.label_of(ids) if len(ids) else ids.copy()

    def add_sparse(self, indices, values) -> tuple[np.ndarray, np.ndarray]:
        ids = self.engine.add_sparse(indices, values)
        return ids, self.label_of(ids) if len(ids) else ids.copy()

    def add_packed(self, packed, raw=None) -> tuple[np.ndarray, np.ndarray]:
        ids = self.engine.add_packed(packed, raw=raw)
        return ids, self.label_of(ids) if len(ids) else ids.copy()

    def remove(self, ids) -> int:
        return self.engine.remove(ids)

    def compact(self) -> None:
        self.engine.compact()

    # -- merge (the Mergeable contract, repro_torch.index.mergeable) --------

    def merge(self, other: "ClusterIndex") -> "ClusterIndex":
        """Absorb another ClusterIndex (and its engine) and return self.

        The engines merge first — id-disjoint membership union, validated
        before anything mutates — which streams the absorbed rows through
        the "merge" event (counts/weights arrive as sums, labels as
        arrival-moment assignments).  Then the centres are re-seeded from
        the UNION membership via the existing `refit` path: refit is
        deterministic in the membership, so a merged index ends bit-equal
        to a sequentially built index of the same rows after its own
        refit(), regardless of shard split or merge order.  `other` is
        detached from its engine and must be discarded."""
        if other is self:
            raise MergeIncompatible(
                "ClusterIndex.merge: cannot merge an index with itself")
        if (other.k, other.seed, other.n_iter) != (self.k, self.seed,
                                                   self.n_iter):
            raise MergeIncompatible(
                "ClusterIndex.merge: clustering configs differ "
                f"(k/seed/n_iter {self.k}/{self.seed}/{self.n_iter} vs "
                f"{other.k}/{other.seed}/{other.n_iter}) — refits of the "
                "merged membership would not be comparable")
        other.detach()
        self.engine.merge(other.engine)
        self.refit()
        return self

    # -- persistence --------------------------------------------------------

    _FORMAT = "repro.cluster.v2"
    _FORMATS = ("repro.cluster.v1", "repro.cluster.v2")

    def save(self, directory: str, step: int = 0, keep: int = 3) -> None:
        """Snapshot engine + cluster state: the engine snapshot lands in
        `directory` (QueryEngine.save) and the cluster sidecar in
        `directory/cluster` under the same step, both through
        checkpoint.Checkpointer's atomic-publish layout.  v2 adds the raw
        medoid capture, so a restored index can still follow a spec
        migration without an intervening refit."""
        from repro_torch.checkpoint.checkpointer import Checkpointer

        self.engine.save(directory, step=step, keep=keep)
        w = self.engine.store.w
        centers = (self._centers if self._centers is not None
                   else np.zeros((0, w), np.int32))
        craw_i, craw_v = (self._center_raw if self._center_raw is not None
                          else (np.zeros((0, 1), np.int32),) * 2)
        tree = {
            "centers": centers,
            "medoid_ids": self._medoid_ids,
            "center_raw_idx": craw_i,
            "center_raw_val": craw_v,
            "lab_ids": self._lab_ids,
            "labels": self._lab,
            "counts": self._counts,
            "weights": self._weights,
        }
        meta = {
            "format": self._FORMAT,
            "k": self.k,
            "seed": self.seed,
            "n_iter": self.n_iter,
            "block": self.block,
            "refit_every": self.refit_every,
            "mutations_since_refit": self.mutations_since_refit,
            "n_refits": self.n_refits,
            "has_center_raw": self._center_raw is not None,
        }
        ckpt = Checkpointer(os.path.join(directory, "cluster"), keep=keep,
                            async_save=False)
        ckpt.save(step, tree, extra_meta=meta, block=True)

    @classmethod
    def restore(cls, directory: str, step: int | None = None,
                device="cuda", **engine_kwargs) -> "ClusterIndex":
        """Rebuild (engine, ClusterIndex) on `device` from a `save`
        snapshot either package wrote.  The restored state is EXACT — including labels assigned incrementally
        since the last refit, which a fresh refit would not reproduce.

        The step is resolved from the CLUSTER sidecar (written last by
        `save`), then used for the engine snapshot too — so a save that
        crashed between the two publishes restores the newest CONSISTENT
        pair instead of pairing a fresh store with a stale sidecar."""
        from repro_torch.checkpoint.checkpointer import Checkpointer

        ckpt = Checkpointer(os.path.join(directory, "cluster"),
                            async_save=False)
        if step is None:
            step = ckpt.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no cluster snapshots in {directory}/cluster")
        engine = QueryEngine.restore(directory, step=step, device=device,
                                     **engine_kwargs)
        meta = ckpt.meta(step)
        if meta.get("format") not in cls._FORMATS:
            raise ValueError(f"not a cluster snapshot: {directory}/cluster")
        tensors, _ = ckpt.restore(step=step, device="cpu")
        tree = {key: t.numpy() for key, t in tensors.items()}
        self = cls.__new__(cls)
        self.engine = engine
        self.k = int(meta["k"])
        self.seed = int(meta["seed"])
        self.n_iter = int(meta["n_iter"])
        self.block = int(meta.get("block", engine.block))
        refit_every = meta.get("refit_every")
        self.refit_every = None if refit_every is None else int(refit_every)
        self._centers = None
        self._center_raw = None
        self._centre_engine = None
        self._centre_ids = np.zeros(0, np.int64)
        self._medoid_ids = np.asarray(tree["medoid_ids"], np.int64).copy()
        self._lab_ids = np.asarray(tree["lab_ids"], np.int64).copy()
        self._lab = np.asarray(tree["labels"], np.int64).copy()
        self._counts = np.asarray(tree["counts"], np.int64).copy()
        self._weights = np.asarray(tree["weights"], np.int64).copy()
        self.mutations_since_refit = int(meta["mutations_since_refit"])
        self.n_refits = int(meta["n_refits"])
        self._refit_pending = False
        self._wire_obs()
        if len(self._lab_ids) and not np.array_equal(self._lab_ids,
                                                     engine.ids()):
            # a desynced pair would corrupt the remove bookkeeping later;
            # fail at the boundary instead
            raise ValueError(
                "cluster snapshot does not match the engine snapshot at "
                f"step {step}: label sidecar covers different ids than the "
                "restored store")
        if len(tree["centers"]):
            # a mid-migration snapshot saved centres ALREADY re-sketched
            # under the new spec (migrate_start ran before the save)
            cparams = (engine.migration.new_spec.params
                       if engine.migrating else None)
            self._install_centers(np.asarray(tree["centers"], np.int32),
                                  params=cparams)
        if meta.get("has_center_raw"):
            self._center_raw = (
                np.asarray(tree["center_raw_idx"], np.int32).copy(),
                np.asarray(tree["center_raw_val"], np.int32).copy())
        engine.subscribe(self._on_engine_event)
        return self
