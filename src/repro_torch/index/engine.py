"""QueryEngine: batched online similarity serving over a SketchStore.

The public boundary of the port's index, after the JAX package's
`repro.index.engine`.  Raw categorical rows (dense (k, n) matrices or
padded-COO (indices, values) pairs) go in; external ids and distances come
out.  On a CUDA device every step runs through the hand-written kernels:
sparse Cabin sketches rows and queries, row popcounts weigh appended rows,
the fused top-k select serves `topk`, and pair stats serve `radius` and
`pairwise`.

  * Partitioned serving: a weight-sorted base partition that survives
    mutations plus a small brute-delta partition of fresh adds
    (`partition.PartitionSet`), so a mutation costs the next query
    O(delta), not a rebuild.
  * Exactness: `topk` walks the base's bands nearest-first and stops at
    the certificate, merged with the delta by (value, id); `radius` scans
    the surviving bands.  Both equal a batch scan of the same membership,
    whatever the mutation history.  Ties in topk go to the lower id.
  * LRU result cache keyed on (op, args, store version, query-sketch
    bytes): any mutation bumps the version, so stale hits cannot happen.
  * Flight recorder: one `repro_torch.obs` registry per engine (latency
    histograms per op, cache counters, structural gauges, the store's and
    the band walk's counters) and an ``engine.<op>`` span per query,
    exported by `render_prom`, `obs_snapshot` and `stats()["latency_ms"]`.
  * Budgeted serving: `topk_budgeted` stops the band walk when a deadline
    fires and reports the answer as partial, with its certificate gap.
  * Lifecycle: `merge` absorbs another engine built apart (the Mergeable
    contract), `shard(n_shards=)` serves through `n_shards` partition
    groups routed by ``id % n_shards``, `migrate` re-sketches the index
    to a new spec from its raw archive while serving exactly (and starts
    by itself under density drift with `auto_migrate`), and `save` /
    `restore` snapshot the whole engine through the Checkpointer, a
    migration in flight included, in the JAX package's
    ``repro.index.v2`` format: a snapshot either package wrote restores
    in the other.  Every answer is bit-identical at every shard count.

The engine runs on `device="cuda"` unless the caller asks for the CPU,
where every kernel is replaced by its plain version.
"""

from __future__ import annotations

from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import packing, theory
from repro_torch.core.allpairs import KBEST_KEY_PAD
from repro_torch.core.cabin import CabinParams, sketch_dense, sketch_sparse
from repro_torch.core.packing import pow2_bucket
from repro_torch.device import on_device, resolve_device, to_host
from repro_torch.index import partition
from repro_torch.index.mergeable import MergeIncompatible, check_spec_compatible
from repro_torch.index.migrate import Migration, RawArchive
from repro_torch.index.partition import PartitionSet
from repro_torch.index.store import SketchSpec, SketchStore

_METRICS = ("cham", "hamming")


def _later(name: str, slice_name: str):
    def method(*args, **kwargs):
        raise NotImplementedError(
            f"QueryEngine.{name} is not ported yet: it comes with the "
            f"{slice_name} slice of the PyTorch port")

    method.__name__ = name
    return method


def _packed_on_device(sk, device: torch.device) -> torch.Tensor:
    sk = on_device(sk, device)
    if sk.dtype != torch.int32 or sk.ndim != 2:
        raise TypeError(f"expected (k, w) int32 packed rows, got "
                        f"{tuple(sk.shape)} {sk.dtype}")
    return sk


class QueryEngine:
    """Online k-NN / radius serving over Cabin sketches.

    Parameters
    ----------
    params : CabinParams; all ingested and queried rows share them.
    metric : "cham" (estimated categorical HD) or "hamming" (exact sketch
        HD), fixed per engine.
    block : row-tile size of the radius scans (at most 256 is used).
    band_rows : rows per weight band.
    cache_entries : LRU result-cache capacity (0 disables caching).
    merge_ratio : fold a shard's delta partition into its base once its
        live rows exceed `merge_ratio * base_alive`; 0 rebuilds on every
        mutation, None only on `compact()`.
    keep_raw : archive each ingested row's raw COO form on the host
        (`migrate.RawArchive`) so the index can be re-sketched under a new
        spec; without it `migrate()` is impossible.
    auto_migrate : start a lazy spec migration when the `drift_pct`
        percentile of row density over the last `drift_window` ingested
        rows needs a larger sketch dim than the engine's
        (`theory.sketch_dim(percentile, drift_delta)`, same hash seeds).
    device : "cuda" (default; RuntimeError when CUDA is absent) or "cpu".
    registry : the engine's metrics registry (default: a fresh one from
        `obs.new_registry()`, the shared no-op registry under REPRO_OBS=0).
    """

    def __init__(self, params: CabinParams, *, metric: str = "cham",
                 block: int = 2048, band_rows: int = 1024,
                 cache_entries: int = 256,
                 merge_ratio: float | None = 0.125, keep_raw: bool = True,
                 auto_migrate: bool = False, drift_delta: float = 0.1,
                 drift_window: int = 512, drift_pct: float = 95.0,
                 device="cuda", registry=None):
        if metric not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}")
        if auto_migrate and not keep_raw:
            raise ValueError("auto_migrate needs keep_raw=True: a drift "
                             "migration re-sketches from the raw archive")
        self.device = resolve_device(device)
        self.params = params
        self.metric = metric
        self.block = block
        self.band_rows = band_rows
        self.merge_ratio = merge_ratio
        self.spec = SketchSpec(0, params)
        self.raw: RawArchive | None = RawArchive() if keep_raw else None
        self.auto_migrate = auto_migrate
        self.drift_delta = float(drift_delta)
        self.drift_pct = float(drift_pct)
        self.drift_window = int(drift_window)
        self._nnz_window: deque[int] = deque(maxlen=self.drift_window)
        self._mig: Migration | None = None
        self._subs: list = []
        self.store = SketchStore(params.sketch_dim, spec=self.spec,
                                 device=self.device)
        self._attach_relay(self.store)
        self._n_shards = 1
        self._tiered: PartitionSet | None = None
        self._cache: OrderedDict[tuple, tuple | list] = OrderedDict()
        self._cache_entries = cache_entries
        self.cache_hits = 0
        self.cache_misses = 0
        # instruments are cached here once: queries never pay a registry
        # lookup, and under NULL_REGISTRY every call is a shared no-op
        self.obs = obs.new_registry() if registry is None else registry
        self.store.set_registry(self.obs)
        self._h_lat = {
            op: self.obs.histogram("engine_query_latency_ms", op=op)
            for op in ("topk", "radius", "pairwise")}
        self._c_hits = self.obs.counter("engine_cache_hits_total")
        self._c_misses = self.obs.counter("engine_cache_misses_total")
        self._register_obs_gauges()

    def _register_obs_gauges(self) -> None:
        """Structural state as read-time callbacks.  The reference's gauge
        of its jit compile cache has no counterpart in the port (no jit
        cache) and is not registered."""
        reg = self.obs
        reg.gauge_fn("engine_rows_alive", lambda: float(len(self)))
        reg.gauge_fn("engine_store_size", lambda: float(self.store.size))
        reg.gauge_fn("engine_store_capacity",
                     lambda: float(self.store.capacity))
        reg.gauge_fn("engine_lru_entries", lambda: float(len(self._cache)))
        reg.gauge_fn("engine_tier_base_rows",
                     lambda: float(self._tiered.base_alive
                                   if self._tiered else 0))
        reg.gauge_fn("engine_tier_delta_rows",
                     lambda: float(self._tiered.delta_n
                                   if self._tiered else 0))
        reg.gauge_fn("engine_tier_merges",
                     lambda: float(self._tiered.n_merges
                                   if self._tiered else 0))
        reg.gauge_fn("engine_shards", lambda: float(self._n_shards))
        reg.gauge_fn("engine_sketch_dim", lambda: float(self.d))
        reg.gauge_fn("engine_observed_density_pct", self._observed_density)
        reg.gauge_fn("engine_density_dim_needed", self._density_dim_needed)
        reg.gauge_fn("engine_migration_progress", self._migration_progress)
        reg.gauge_fn("engine_migration_cursor",
                     lambda: float(self._mig.cursor) if self._mig else -1.0)

    def _observed_density(self) -> float:
        """The `drift_pct` percentile of per-row nnz over the drift
        window (0 before any ingest)."""
        if not self._nnz_window:
            return 0.0
        return float(np.percentile(
            np.fromiter(self._nnz_window, np.int64), self.drift_pct))

    def _density_dim_needed(self) -> float:
        """The sketch dim the observed density needs: when it exceeds
        `engine_sketch_dim`, the Theorem 1/2 bound no longer covers the
        data."""
        if not self._nnz_window:
            return 0.0
        p = max(1, int(np.ceil(self._observed_density())))
        return float(theory.sketch_dim(p, self.drift_delta))

    def _migration_progress(self) -> float:
        """Fraction of old-spec rows re-sketched: 1.0 with no migration in
        flight, monotone 0 -> 1 across batches."""
        if self._mig is None:
            return 1.0
        done = self._mig.rows_migrated
        total = done + len(self._mig.src)
        return done / total if total else 1.0

    # -- mutation observers (engine level) ----------------------------------

    def subscribe(self, callback) -> None:
        """Register `callback(event, ids, slots, store)`: the store events
        ("add", "remove", "merge", "compact") of whichever store an event
        belongs to (a migration swaps stores under the engine), and the
        engine's own "migrate_start" (`store` is the new-spec destination)
        and "migrate" (`store` is the new serving store)."""
        self._subs.append(callback)

    def unsubscribe(self, callback) -> None:
        self._subs.remove(callback)

    def _attach_relay(self, store: SketchStore) -> None:
        def relay(event, ids, slots, _store=store):
            for cb in list(self._subs):
                cb(event, ids, slots, _store)

        store.subscribe(relay)

    def _emit(self, event: str, store: SketchStore) -> None:
        z = np.zeros(0, np.int64)
        for cb in list(self._subs):
            cb(event, z, z, store)

    # -- basics -------------------------------------------------------------

    def __len__(self) -> int:
        n = len(self.store)
        if self._mig is not None:
            n += len(self._mig.dst) + len(self._mig.fresh)
        return n

    @property
    def d(self) -> int:
        return self.params.sketch_dim

    def ids(self) -> np.ndarray:
        if self._mig is None:
            return self.store.ids()
        return np.sort(np.concatenate([
            self.store.ids(), self._mig.dst.ids(), self._mig.fresh.ids()]))

    def stats(self) -> dict:
        t = self._tiered
        out = {
            "n_alive": len(self),
            "size": self.store.size,
            "capacity": self.store.capacity,
            "version": self.store.version,
            "spec_version": self.spec.version,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "n_bands": t.n_bands if t else None,
            "base_rows": t.base_rows if t else None,
            "base_alive": t.base_alive if t else None,
            "delta_rows": t.delta_n if t else None,
            "tier_merges": t.n_merges if t else None,
            "n_shards": self._n_shards,
        }
        if self._mig is not None:
            m = self._mig
            out["migration"] = {
                "phase": m.phase,
                "to_version": m.new_spec.version,
                "to_dim": m.new_spec.d,
                "rows_migrated": m.rows_migrated,
                "rows_remaining": len(m.src),
                "fresh_rows": len(m.fresh),
                "progress": self._migration_progress(),
            }
        lat = {}
        for op, h in self._h_lat.items():
            if h.count:
                lat[op] = {"count": h.count, "p50": h.quantile(50),
                           "p95": h.quantile(95), "p99": h.quantile(99)}
        if lat:
            out["latency_ms"] = lat
        return out

    def render_prom(self) -> str:
        """This engine's registry in Prometheus text exposition format."""
        return self.obs.render_prom()

    def obs_snapshot(self) -> dict:
        """Plain-dict snapshot of this engine's registry: every counter,
        gauge (evaluated live), and histogram with p50/p95/p99."""
        return self.obs.snapshot()

    # -- sketching ----------------------------------------------------------

    def _sketch(self, queries, params: CabinParams | None = None
                ) -> tuple[torch.Tensor, int]:
        """Raw categorical input -> (packed sketches (k, w) on the engine's
        device, k).  `queries` is a dense (k, n_dims) int array or an
        (indices, values) padded-COO pair, numpy or torch.  A COO batch of
        width 0 is padded to the reference engine's smallest width bucket
        (pow2_bucket(0) = 8 slots of padding): its rows sketch to zero.
        `params` overrides the engine's (the migration and the
        cross-version serving sketch the same rows under another spec)."""
        if params is None:
            params = self.params
        if isinstance(queries, (tuple, list)):
            indices = on_device(queries[0], self.device)
            values = on_device(queries[1], self.device)
            if indices.shape != values.shape or indices.ndim != 2:
                raise ValueError("COO input needs matching (k, m) "
                                 "indices/values")
            if indices.shape[1] == 0:
                pad = (indices.shape[0], pow2_bucket(0))
                indices = indices.new_zeros(pad)
                values = values.new_zeros(pad)
            # range check before the int32 cast, which could wrap
            if indices.numel() and bool(
                    (indices.max() >= params.n_dims) | (indices.min() < 0)):
                raise ValueError(
                    f"COO indices out of range [0, {params.n_dims})")
            return (sketch_sparse(params, indices.to(torch.int32),
                                  values.to(torch.int32)), indices.shape[0])
        x = on_device(queries, self.device).to(torch.int32)
        if x.ndim != 2 or x.shape[1] != params.n_dims:
            raise ValueError(
                f"expected dense (k, {params.n_dims}) rows, "
                f"got {tuple(x.shape)}")
        return sketch_dense(params, x), x.shape[0]

    # -- ingestion ----------------------------------------------------------

    def _ingest_target(self) -> tuple[SketchStore, CabinParams]:
        """Where adds land and which spec sketches them: the serving store,
        or the new-spec fresh store while a migration is in flight (acked
        mutations mid-migration never need re-migration)."""
        if self._mig is not None:
            return self._mig.fresh, self._mig.new_spec.params
        return self.store, self.params

    def add_dense(self, x) -> np.ndarray:
        """Ingest dense categorical rows (k, n_dims); returns ids (k,)."""
        self._drive()
        store, params = self._ingest_target()
        sk, k = self._sketch(x, params=params)
        ids = store.add(sk, n_valid=k)
        if k:
            if not torch.is_tensor(x):
                x = np.asarray(x)
            if self.raw is not None:
                self.raw.put_dense(ids, x)
            self._track_drift(to_host((x != 0).sum(1)))
        return ids

    def add_sparse(self, indices, values) -> np.ndarray:
        """Ingest padded-COO categorical rows; returns ids (k,).  With
        keep_raw, the rows are copied to the host archive (once a batch
        for rows on the card)."""
        self._drive()
        store, params = self._ingest_target()
        sk, k = self._sketch((indices, values), params=params)
        ids = store.add(sk, n_valid=k)
        if k:
            if self.raw is not None:
                self.raw.put(ids, indices, values)
            self._track_drift(to_host((torch.as_tensor(values) != 0).sum(1)))
        return ids

    def add_packed(self, packed, raw=None, spec: SketchSpec | None = None
                   ) -> np.ndarray:
        """Ingest pre-sketched packed rows (k, w) int32, which MUST come
        from this engine's current CabinParams; `spec`, when given, is
        checked (MergeIncompatible naming both specs).  `raw`, the rows'
        (indices, values) COO pair, is archived so the rows can survive a
        `migrate()`.  Mid-migration the packed rows are spec-ambiguous:
        with `raw` they are re-sketched under the live spec, without it
        the call raises."""
        self._drive()
        if self._mig is not None:
            if raw is None:
                raise RuntimeError(
                    "add_packed mid-migration needs raw=(indices, values): "
                    "the supplied sketches are under the OLD spec, but new "
                    "rows must land in the new-spec tier")
            return self.add_sparse(*raw)
        packed = _packed_on_device(packed, self.device)
        ids = self.store.add_packed(packed, spec, n_valid=packed.shape[0])
        if raw is not None and self.raw is not None and len(ids):
            self.raw.put(ids, *raw)
        return ids

    def remove(self, ids) -> int:
        self._drive()
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if self._mig is None:
            n = self.store.remove(ids)
        else:
            if len(np.unique(ids)) != len(ids):
                raise ValueError("duplicate ids in remove batch")
            # validate membership before mutating any store, so a bad id
            # cannot leave a partial cross-store remove behind
            groups: dict[int, tuple[SketchStore, list[int]]] = {}
            for id_ in ids.tolist():
                store = self._mig.store_of(id_)  # KeyError on unknown
                groups.setdefault(id(store), (store, []))[1].append(id_)
            for store, grp in groups.values():
                store.remove(np.asarray(grp, np.int64))
            n = len(ids)
        if self.raw is not None:
            self.raw.drop(ids)
        return n

    def compact(self) -> None:
        self._drive()
        self.store.compact()
        if self._mig is not None:
            self._mig.dst.compact()
            self._mig.fresh.compact()

    # -- merge (the Mergeable contract, repro_torch.index.mergeable) --------

    def merge(self, other: "QueryEngine") -> "QueryEngine":
        """Absorb `other`'s membership into this engine and return self.

        Validated before anything mutates: same metric, same sketch spec
        (migrate one engine to the other's spec first), matching keep_raw,
        disjoint external ids, and no migration in flight on either side.
        Merged: the store (`SketchStore.merge`, where the ``merge.combine``
        crash point fires), the raw archive, the drift window, the serving
        layout (rows absorbed as shard-routed delta when the id ranges do
        not interleave) and the registries (counters sum, histograms
        union).  The LRU clears.  `other` must be discarded."""
        if other is self:
            raise MergeIncompatible(
                "QueryEngine.merge: cannot merge an engine with itself")
        if self._mig is not None or other._mig is not None:
            raise RuntimeError(
                "QueryEngine.merge: a spec migration is in flight; drive "
                "it to completion (migrate_all()) on both engines before "
                "merging — a mid-migration membership spans two sketch "
                "spaces")
        if other.metric != self.metric:
            raise MergeIncompatible(
                f"QueryEngine.merge: metric mismatch ({self.metric!r} vs "
                f"{other.metric!r}) — cached results and layouts would "
                "not be comparable")
        check_spec_compatible(other.spec, self.spec,
                              what="QueryEngine.merge")
        if (self.raw is None) != (other.raw is None):
            raise MergeIncompatible(
                "QueryEngine.merge: keep_raw mismatch — merging a raw-less "
                "engine would leave part of the membership un-migratable")
        with obs.span("engine.merge", rows=len(other)):
            self.store.merge(other.store)
            if self.raw is not None:
                self.raw.merge(other.raw)
            self._nnz_window.extend(other._nnz_window)
            self.cache_hits += other.cache_hits
            self.cache_misses += other.cache_misses
            # callback gauges freeze to their merge-time values in a
            # registry merge: re-register ours so they stay live
            self.obs.merge(other.obs)
            self._register_obs_gauges()
            if self._tiered is not None:
                self._tiered.merge(other._tiered)
            self._cache.clear()
        return self

    # -- spec migration ------------------------------------------------------

    @property
    def migrating(self) -> bool:
        return self._mig is not None

    @property
    def migration(self) -> Migration | None:
        return self._mig

    def migrate(self, new_params: CabinParams | None = None, *,
                d: int | None = None, batch_rows: int = 1024,
                drive: str = "lazy", journal_dir: str | None = None,
                journal_every: int = 1, journal_keep: int = 3) -> Migration:
        """Begin an incremental re-sketch of the index to a new spec:
        `new_params` (same n_dims), or `d` to keep the hash seeds and
        change only the dim.  Old-spec rows are re-sketched from the raw
        archive in `batch_rows` batches while serving stays exact across
        the old- and new-spec tiers.  `drive`: "lazy" (each engine call
        advances one batch), "manual" (only `migration_step()` /
        `migrate_all()`) or "eager" (to completion before returning).
        `journal_dir` snapshots the whole engine through the Checkpointer
        every `journal_every` batches; `QueryEngine.restore(journal_dir)`
        resumes the migration after a crash with no acked mutation lost.
        A completed migration is bit-identical to an engine freshly built
        at the new spec."""
        if self._mig is not None:
            raise RuntimeError("a migration is already in flight")
        if new_params is None:
            if d is None:
                raise ValueError("migrate() needs new_params or d")
            new_params = CabinParams(
                n_dims=self.params.n_dims, sketch_dim=int(d),
                psi_seed=self.params.psi_seed, pi_seed=self.params.pi_seed)
        new_spec = self.spec.successor(new_params)
        mig = Migration(self, new_spec, batch_rows=batch_rows, drive=drive,
                        journal_dir=journal_dir, journal_every=journal_every,
                        journal_keep=journal_keep)
        self._mig = mig
        # fresh holds real ingest (acked adds mid-migration) and shares the
        # engine's counters; dst's re-sketched copies are counted by the
        # migration's own instruments
        mig.fresh.set_registry(self.obs)
        self._attach_relay(mig.dst)
        self._attach_relay(mig.fresh)
        self._emit("migrate_start", mig.dst)
        if drive == "eager":
            mig.run()
        return mig

    def migration_step(self, rows: int | None = None) -> bool:
        """Advance an in-flight migration by one batch (default
        `batch_rows`); returns True while more work remains."""
        if self._mig is None:
            return False
        self._mig.step(rows)
        return self._mig is not None

    def migrate_all(self) -> None:
        """Drive an in-flight migration to completion."""
        while self.migration_step():
            pass

    def _drive(self) -> None:
        """Lazy-mode pacing: one migration batch per engine call."""
        if self._mig is not None and self._mig.drive == "lazy":
            self._mig.step()

    def _publish_migration(self, mig: Migration) -> None:
        """Called by Migration._finish once every row is under the new
        spec: swap the serving store."""
        self.store = mig.dst
        self.store.set_registry(self.obs)
        self.params = mig.new_spec.params
        self.spec = mig.new_spec
        self._tiered = None
        self._cache.clear()
        self._mig = None
        self._emit("migrate", self.store)

    def _track_drift(self, nnz_counts: np.ndarray) -> None:
        """Feed per-row density into the drift window; under auto_migrate,
        start a lazy migration to `theory.sketch_dim` of the `drift_pct`
        percentile when it exceeds the engine's dim."""
        # the window keeps only its last drift_window entries
        tail = nnz_counts[max(len(nnz_counts) - self.drift_window, 0):]
        self._nnz_window.extend(int(c) for c in tail)
        if not self.auto_migrate or self._mig is not None:
            return
        if len(self._nnz_window) < min(64, self.drift_window):
            return  # too few observations to call a drift
        p = max(1, int(np.ceil(np.percentile(
            np.fromiter(self._nnz_window, np.int64), self.drift_pct))))
        need = theory.sketch_dim(p, self.drift_delta)
        if need > self.d:
            self.migrate(d=need, drive="lazy")

    # -- result cache -------------------------------------------------------

    def _cached(self, key):
        if key is not None and key in self._cache:
            self._cache.move_to_end(key)
            self.cache_hits += 1
            self._c_hits.inc()
            return self._cache[key]
        return None

    def _remember(self, key, value) -> None:
        """Store a private copy of `value` (key=None: caching disabled)."""
        self.cache_misses += 1
        self._c_misses.inc()
        if key is None:
            return
        if isinstance(value, tuple):
            self._cache[key] = tuple(a.copy() for a in value)
        else:
            self._cache[key] = [a.copy() for a in value]
        if len(self._cache) > self._cache_entries:
            self._cache.popitem(last=False)

    # -- queries ------------------------------------------------------------

    def topk(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """k nearest stored rows per query: (ids (Q, k'), dists (Q, k')),
        ascending by (distance, id), k' = min(k, len(store)).  Accepts
        dense rows or an (indices, values) COO pair."""
        if k < 0:
            raise ValueError(f"topk: k must be >= 0, got {k}")
        self._drive()  # migration pacing stays outside the query timer
        with self._h_lat["topk"].time(), obs.span("engine.topk", k=k):
            if self._mig is not None:
                return self._topk_migrating(queries, k)
            sk, q = self._sketch(queries)
            return self._topk_packed_impl(sk, k, q)

    def topk_budgeted(self, queries, k: int, deadline=None
                      ) -> tuple[np.ndarray, np.ndarray, dict]:
        """`topk` under a latency budget: (ids, dists, info), info holding
        {"partial", "cert_gap"}.  `deadline` is any object with an
        `expired` property (`repro_torch.serve.Deadline`); when it fires
        before the band walk's exactness certificate closes, the walk
        stops, the best candidates seen so far come back with
        info["partial"]=True, and info["cert_gap"] is how far the k-th
        bound would have to move for the answer to be provably exact.
        With deadline=None (or when the walk finishes in budget) the
        result is bit-identical to `topk` and partial is False.  Unfilled
        slots of a partial answer carry id -1 and distance inf.
        Mid-migration, queries take the exact cross-version path."""
        if k < 0:
            raise ValueError(f"topk: k must be >= 0, got {k}")
        self._drive()
        info: dict = {"partial": False, "cert_gap": 0.0}
        with self._h_lat["topk"].time(), obs.span("engine.topk", k=k):
            if self._mig is not None:
                ids, dists = self._topk_migrating(queries, k)
                return ids, dists, info
            sk, q = self._sketch(queries)
            ids, dists = self._topk_packed_impl(sk, k, q, deadline=deadline,
                                                info_out=info)
            if info["partial"]:
                ids = np.where(ids == KBEST_KEY_PAD, -1, ids)
            return ids, dists, info

    def topk_packed(self, sk, k: int, n_valid: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """`topk` on pre-sketched packed queries (k, w) int32."""
        if k < 0:
            raise ValueError(f"topk: k must be >= 0, got {k}")
        if self._mig is not None:
            raise RuntimeError(
                "topk_packed is unavailable mid-migration (packed queries "
                "are spec-ambiguous); use topk() with raw rows")
        with self._h_lat["topk"].time(), obs.span("engine.topk", k=k):
            return self._topk_packed_impl(
                _packed_on_device(sk, self.device), k, n_valid)

    def _topk_packed_impl(self, sk: torch.Tensor, k: int,
                          n_valid: int | None, deadline=None,
                          info_out: dict | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        if info_out is not None:
            info_out.update(partial=False, cert_gap=0.0)
        q = sk.shape[0] if n_valid is None else n_valid
        if not 0 <= q <= sk.shape[0]:
            raise ValueError(
                f"n_valid={q} outside the {sk.shape[0]} supplied rows")
        kk = min(k, len(self.store))
        if q == 0 or kk == 0:
            return (np.zeros((q, 0), np.int64), np.zeros((q, 0), np.float32))
        q_host = sk[:q].cpu().numpy()  # band planning needs it regardless
        key = None
        if self._cache_entries:
            key = ("topk", kk, self.store.version, q_host.tobytes())
            hit = self._cached(key)
            if hit is not None:
                # partial answers never enter the LRU, so a budgeted call
                # served from it gets the exact answer
                return hit[0].copy(), hit[1].copy()
        out = self.sync_layout().topk(
            sk[:q], packing.np_popcount_rows(q_host), kk, q_valid=q,
            deadline=deadline, info_out=info_out)
        if info_out is not None and info_out.get("partial"):
            key = None  # a partial answer must not shadow the exact one
        self._remember(key, out)
        return out

    def radius(self, queries, r: float) -> list[np.ndarray]:
        """All stored rows within distance < r of each query: a list of Q
        ascending id arrays.  r <= 0 returns empty arrays."""
        self._drive()  # migration pacing stays outside the query timer
        with self._h_lat["radius"].time(), obs.span("engine.radius", r=r):
            if self._mig is not None:
                return self._radius_migrating(queries, r)
            sk, q = self._sketch(queries)
            return self._radius_packed_impl(sk, r, q)

    def radius_packed(self, sk, r: float, n_valid: int | None = None
                      ) -> list[np.ndarray]:
        """`radius` on pre-sketched packed queries."""
        if self._mig is not None:
            raise RuntimeError(
                "radius_packed is unavailable mid-migration (packed queries "
                "are spec-ambiguous); use radius() with raw rows")
        with self._h_lat["radius"].time(), obs.span("engine.radius", r=r):
            return self._radius_packed_impl(
                _packed_on_device(sk, self.device), r, n_valid)

    def _radius_packed_impl(self, sk: torch.Tensor, r: float,
                            n_valid: int | None) -> list[np.ndarray]:
        q = sk.shape[0] if n_valid is None else n_valid
        if not 0 <= q <= sk.shape[0]:
            raise ValueError(
                f"n_valid={q} outside the {sk.shape[0]} supplied rows")
        if q == 0:
            return []
        if r <= 0:  # dist >= 0 and the test is strict: provably no hits
            return [np.zeros(0, np.int64) for _ in range(q)]
        q_host = sk[:q].cpu().numpy()
        key = None
        if self._cache_entries:
            key = ("radius", float(r), self.store.version, q_host.tobytes())
            hit = self._cached(key)
            if hit is not None:
                return [a.copy() for a in hit]
        hits: list[list[np.ndarray]] = [[] for _ in range(q)]
        if len(self.store):
            partition.radius_hits(
                self.sync_layout(), sk[:q], packing.np_popcount_rows(q_host),
                q, r, metric=self.metric, block=min(self.block, 256),
                hits=hits)
        out = [np.sort(np.concatenate(h)) if h else np.zeros(0, np.int64)
               for h in hits]
        self._remember(key, out)
        return out

    # -- cross-version serving (mid-migration) -------------------------------

    def _sketch_per_spec(self, queries, specs) -> dict:
        """The same raw queries sketched once under every distinct spec:
        each tier is queried in its own sketch space."""
        out: dict[int, tuple[torch.Tensor, int]] = {}
        for spec in specs:
            if spec.version not in out:
                out[spec.version] = self._sketch(queries, params=spec.params)
        return out

    def _topk_migrating(self, queries, k: int
                        ) -> tuple[np.ndarray, np.ndarray]:
        """topk across the migration's live tiers (old-spec remainder,
        new-spec migrated rows, new-spec fresh adds), each a PartitionSet
        under its own spec, merged by `partition.topk_across_tiers`.  The
        LRU is bypassed: the window is transient."""
        tiers = self._mig.serving_tiers()
        kk = min(k, len(self))
        if not tiers or kk == 0:
            _, q = self._sketch(queries)
            return (np.zeros((q, 0), np.int64), np.zeros((q, 0), np.float32))
        sketched = self._sketch_per_spec(queries, [s for _, s in tiers])
        q = next(iter(sketched.values()))[1]
        if q == 0:
            return (np.zeros((0, 0), np.int64), np.zeros((0, 0), np.float32))
        staged = []
        for layout, spec in tiers:
            sk, _ = sketched[spec.version]
            staged.append((layout, sk[:q],
                           packing.np_popcount_rows(sk[:q].cpu().numpy())))
        return partition.topk_across_tiers(kk, staged, q_valid=q)

    def _radius_migrating(self, queries, r: float) -> list[np.ndarray]:
        """radius across the migration's live tiers: per-tier hits (each
        tier scored in its own sketch space) union to the answer."""
        tiers = self._mig.serving_tiers()
        if not tiers:
            _, q = self._sketch(queries)
            return [np.zeros(0, np.int64) for _ in range(q)]
        sketched = self._sketch_per_spec(queries, [s for _, s in tiers])
        q = next(iter(sketched.values()))[1]
        if q == 0:
            return []
        if r <= 0:
            return [np.zeros(0, np.int64) for _ in range(q)]
        hits: list[list[np.ndarray]] = [[] for _ in range(q)]
        for layout, spec in tiers:
            sk, _ = sketched[spec.version]
            partition.radius_hits(
                layout, sk[:q], packing.np_popcount_rows(sk[:q].cpu().numpy()),
                q, r, metric=self.metric, block=min(self.block, 256),
                hits=hits)
        return [np.sort(np.concatenate(h)) if h else np.zeros(0, np.int64)
                for h in hits]

    def pairwise(self, queries, ids=None) -> tuple[np.ndarray, np.ndarray]:
        """Engine-metric distance matrix (Q, N') between queries and the
        given stored ids (default: all alive rows, id order): (ids (N',),
        dists (Q, N') f32).  Entries equal the topk/radius distances of
        the same pairs bit for bit: all read the same integer statistics
        through the same Cham table."""
        if self._mig is not None:
            raise RuntimeError(
                "pairwise is unavailable mid-migration: rows live under two "
                "specs and a single distance matrix would mix sketch spaces; "
                "drive the migration to completion first (migrate_all())")
        with self._h_lat["pairwise"].time(), obs.span("engine.pairwise"):
            return self._pairwise_impl(queries, ids)

    def _pairwise_impl(self, queries, ids) -> tuple[np.ndarray, np.ndarray]:
        from repro_torch.kernels.hamming import ops as hamming_ops

        sk, q = self._sketch(queries)
        all_ids = self.store.ids()
        if ids is None:
            sel_ids = all_ids
        else:
            sel_ids = np.atleast_1d(np.asarray(ids, np.int64))
            if len(np.unique(sel_ids)) != len(sel_ids):
                raise ValueError("pairwise: duplicate ids in batch")
            m = len(all_ids)
            pos = np.searchsorted(all_ids, sel_ids)
            if m == 0 or (pos >= m).any() or (
                    all_ids[np.minimum(pos, m - 1)] != sel_ids).any():
                raise KeyError("pairwise: id not in store")
        if q == 0 or len(sel_ids) == 0:
            return sel_ids, np.zeros((q, len(sel_ids)), np.float32)
        view = self.store.gather_alive()
        self.store.check_fresh(view)
        mat, m, _ = view
        sel = mat[:m] if ids is None else mat.index_select(
            0, torch.from_numpy(pos).to(self.device))
        dists = hamming_ops.dist_matrix(sk, sel.contiguous(), self.d,
                                        metric=self.metric)
        return sel_ids, dists.cpu().numpy()

    # -- layout -------------------------------------------------------------

    def _new_layout(self, store: SketchStore, role: str = "serve"
                    ) -> PartitionSet:
        """A PartitionSet over `store` under this engine's serving config
        and shard topology: the one factory of every serving structure, so
        a sharded engine's migration tiers are sharded too."""
        return PartitionSet(store, self.metric, band_rows=self.band_rows,
                            merge_ratio=self.merge_ratio, registry=self.obs,
                            n_shards=self._n_shards, role=role)

    def sync_layout(self) -> PartitionSet:
        """Sync the serving layout to the store's current version and
        return it (queries call it implicitly)."""
        if self._tiered is None:
            self._tiered = self._new_layout(self.store)
        return self._tiered.sync(self.store)

    # -- persistence --------------------------------------------------------

    def _set_store(self, store: SketchStore) -> None:
        """Install a restored serving store: reset the layout and wire the
        engine-level event relay."""
        self.store = store
        store.set_registry(self.obs)
        self._tiered = None
        self._attach_relay(store)

    def save(self, directory: str, step: int = 0, keep: int = 3) -> None:
        """Snapshot the whole index through the Checkpointer, in the JAX
        package's ``repro.index.v2`` format: one step holds the serving
        store, the raw archive and, mid-migration, both new-spec tiers
        with the cursor and spec pair.  The unit of atomicity is the whole
        engine."""
        from repro_torch.checkpoint.checkpointer import Checkpointer

        ckpt = Checkpointer(directory, keep=keep, async_save=False)
        tree = partition.snapshot_subtrees(self.store, raw=self.raw,
                                           migration=self._mig)
        meta = {
            "format": "repro.index.v2",
            "metric": self.metric,
            "spec": self.spec.meta(),
            "store_meta": self.store.state_meta(),
            "keep_raw": self.raw is not None,
        }
        if self._mig is not None:
            meta["migration"] = self._mig.meta()
        ckpt.save(step, tree, extra_meta=meta, block=True)

    @classmethod
    def restore(cls, directory: str, step: int | None = None,
                device="cuda", **engine_kwargs) -> "QueryEngine":
        """Rebuild an engine on `device` from a snapshot either package
        wrote; its answers are bit-identical to the engine that saved it.
        step=None restores the newest INTACT step (corrupt steps are
        skipped; CheckpointCorruptError if none survive).  A snapshot
        taken mid-migration resumes the migration where the journal left
        it.  `metric` and `keep_raw` are fixed by the snapshot."""
        from repro_torch.checkpoint.checkpointer import Checkpointer

        device = resolve_device(device)
        ckpt = Checkpointer(directory, async_save=False)
        if ckpt.latest_step() is None:
            raise FileNotFoundError(f"no index snapshots in {directory}")
        tensors, step = ckpt.restore(step=step, device="cpu")
        flat = {k: t.numpy() for k, t in tensors.items()}
        meta = ckpt.meta(step)
        fmt = meta.get("format")
        if fmt == "repro.index.v1":
            return cls._restore_v1(flat, meta, device, engine_kwargs)
        if fmt != "repro.index.v2":
            raise ValueError(f"not an index snapshot: {directory}")
        if "metric" in engine_kwargs:
            raise ValueError("metric is fixed by the snapshot "
                             f"({meta['metric']!r}); it cannot be overridden "
                             "on restore")
        if "keep_raw" in engine_kwargs:
            raise ValueError("keep_raw is fixed by the snapshot "
                             f"({meta['keep_raw']}); it cannot be overridden "
                             "on restore")

        def sub(prefix: str) -> dict:
            return {k[len(prefix):]: v for k, v in flat.items()
                    if k.startswith(prefix)}

        spec = SketchSpec.from_meta(meta["spec"])
        eng = cls(spec.params, metric=meta["metric"],
                  keep_raw=meta["keep_raw"], device=device, **engine_kwargs)
        eng.spec = spec
        eng._set_store(SketchStore.from_state(
            sub("store/"), meta["store_meta"], spec=spec, device=device))
        if meta["keep_raw"]:
            eng.raw = RawArchive.from_state(sub("raw/"))
        if "migration" in meta:
            mmeta = meta["migration"]
            new_spec = SketchSpec.from_meta(mmeta["new_spec"])
            dst = SketchStore.from_state(
                sub("mig_dst/"), mmeta["dst_meta"], spec=new_spec,
                device=device)
            fresh = SketchStore.from_state(
                sub("mig_fresh/"), mmeta["fresh_meta"], spec=new_spec,
                device=device)
            eng._mig = Migration.resume(eng, mmeta, dst, fresh)
            eng._attach_relay(dst)
            eng._attach_relay(fresh)
        return eng

    @classmethod
    def _restore_v1(cls, flat: dict, meta: dict, device: torch.device,
                    engine_kwargs: dict) -> "QueryEngine":
        """The JAX package's pre-migration snapshot format: one store, no
        raw archive (the restored engine starts an empty one; rows saved
        under v1 cannot be re-sketched until re-ingested)."""
        if "metric" in engine_kwargs:
            raise ValueError("metric is fixed by the snapshot "
                             f"({meta['metric']!r}); it cannot be overridden "
                             "on restore")
        params = CabinParams(
            n_dims=int(meta["n_dims"]), sketch_dim=int(meta["sketch_dim"]),
            psi_seed=int(meta["psi_seed"]), pi_seed=int(meta["pi_seed"]))
        eng = cls(params, metric=meta["metric"], device=device,
                  **engine_kwargs)
        eng._set_store(SketchStore.from_state(flat, meta, spec=eng.spec,
                                              device=device))
        return eng

    # -- placement ----------------------------------------------------------

    def shard(self, mesh=None, *, n_shards: int | None = None) -> None:
        """Serve through `n_shards` partition groups on the engine's
        device: rows route by ``id % n_shards``, each shard keeps its own
        base and delta partitions, per-shard band walks share the global
        running k-th bound, and answers merge by (value, id) across
        shards, bit-identical to the unsharded engine.  Calling it again
        re-shards; a migration in flight picks the topology up at its
        next layout build.  A device mesh (`mesh`) is not ported: it
        comes with the distributed slice of the port."""
        if mesh is not None:
            raise NotImplementedError(
                "QueryEngine.shard(mesh=...) is not ported yet: placement "
                "over a device mesh comes with the distributed slice "
                "(ROADMAP A10f); use shard(n_shards=...)")
        if n_shards is None:
            raise ValueError("shard() needs n_shards")
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self._n_shards = int(n_shards)
        # layouts are derived: drop them (serving and migration tiers) and
        # let the next query rebuild under the new topology; the cache
        # clears so a re-shard behaves like the fresh engine it equals
        self._tiered = None
        if self._mig is not None:
            self._mig.invalidate_serving_tiers()
        self._cache.clear()

    # -- later slices of the port -------------------------------------------

    cluster = _later("cluster", "clustering")
