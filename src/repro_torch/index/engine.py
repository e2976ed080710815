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

The engine runs on `device="cuda"` unless the caller asks for the CPU,
where every kernel is replaced by its plain version.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import packing
from repro_torch.core.allpairs import KBEST_KEY_PAD
from repro_torch.core.cabin import CabinParams, sketch_dense, sketch_sparse
from repro_torch.core.packing import pow2_bucket
from repro_torch.index import partition
from repro_torch.index.partition import PartitionSet
from repro_torch.device import on_device, resolve_device
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
    merge_ratio : fold the delta partition into the base once its live
        rows exceed `merge_ratio * base_alive`; 0 rebuilds on every
        mutation, None only on `compact()`.
    device : "cuda" (default; RuntimeError when CUDA is absent) or "cpu".
    registry : the engine's metrics registry (default: a fresh one from
        `obs.new_registry()`, the shared no-op registry under REPRO_OBS=0).
    """

    def __init__(self, params: CabinParams, *, metric: str = "cham",
                 block: int = 2048, band_rows: int = 1024,
                 cache_entries: int = 256,
                 merge_ratio: float | None = 0.125, device="cuda",
                 registry=None):
        if metric not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}")
        self.device = resolve_device(device)
        self.params = params
        self.metric = metric
        self.block = block
        self.band_rows = band_rows
        self.merge_ratio = merge_ratio
        self.spec = SketchSpec(0, params)
        self.store = SketchStore(params.sketch_dim, spec=self.spec,
                                 device=self.device)
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
        """Structural state as read-time callbacks.  The reference's
        gauges of the compile cache, the density drift and a migration
        have no state in the port yet and are not registered."""
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
        reg.gauge_fn("engine_shards", lambda: 1.0)
        reg.gauge_fn("engine_sketch_dim", lambda: float(self.d))

    # -- basics -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.store)

    @property
    def d(self) -> int:
        return self.params.sketch_dim

    def ids(self) -> np.ndarray:
        return self.store.ids()

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
            "n_shards": 1,
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

    def _sketch(self, queries) -> tuple[torch.Tensor, int]:
        """Raw categorical input -> (packed sketches (k, w) on the engine's
        device, k).  `queries` is a dense (k, n_dims) int array or an
        (indices, values) padded-COO pair, numpy or torch.  A COO batch of
        width 0 is padded to the reference engine's smallest width bucket
        (pow2_bucket(0) = 8 slots of padding): its rows sketch to zero."""
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

    def add_dense(self, x) -> np.ndarray:
        """Ingest dense categorical rows (k, n_dims); returns ids (k,)."""
        sk, k = self._sketch(x)
        return self.store.add(sk, n_valid=k)

    def add_sparse(self, indices, values) -> np.ndarray:
        """Ingest padded-COO categorical rows; returns ids (k,)."""
        sk, k = self._sketch((indices, values))
        return self.store.add(sk, n_valid=k)

    def add_packed(self, packed, raw=None, spec: SketchSpec | None = None
                   ) -> np.ndarray:
        """Ingest pre-sketched packed rows (k, w) int32, which MUST come
        from this engine's CabinParams; `spec`, when given, is checked.

        `raw`, the rows' (indices, values) COO pair, is accepted and not
        archived: the port has no raw archive or migration yet, so it
        behaves as the JAX package's engine under keep_raw=False."""
        packed = _packed_on_device(packed, self.device)
        return self.store.add_packed(packed, spec, n_valid=packed.shape[0])

    def remove(self, ids) -> int:
        return self.store.remove(np.atleast_1d(np.asarray(ids, np.int64)))

    def compact(self) -> None:
        self.store.compact()

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
        with self._h_lat["topk"].time(), obs.span("engine.topk", k=k):
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
        slots of a partial answer carry id -1 and distance inf."""
        if k < 0:
            raise ValueError(f"topk: k must be >= 0, got {k}")
        info: dict = {}
        with self._h_lat["topk"].time(), obs.span("engine.topk", k=k):
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
        with self._h_lat["radius"].time(), obs.span("engine.radius", r=r):
            sk, q = self._sketch(queries)
            return self._radius_packed_impl(sk, r, q)

    def radius_packed(self, sk, r: float, n_valid: int | None = None
                      ) -> list[np.ndarray]:
        """`radius` on pre-sketched packed queries."""
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

    def pairwise(self, queries, ids=None) -> tuple[np.ndarray, np.ndarray]:
        """Engine-metric distance matrix (Q, N') between queries and the
        given stored ids (default: all alive rows, id order): (ids (N',),
        dists (Q, N') f32).  Entries equal the topk/radius distances of
        the same pairs bit for bit: all read the same integer statistics
        through the same Cham table."""
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

    def sync_layout(self) -> PartitionSet:
        """Sync the serving layout to the store's current version and
        return it (queries call it implicitly)."""
        if self._tiered is None:
            self._tiered = PartitionSet(self.store, self.metric,
                                        band_rows=self.band_rows,
                                        merge_ratio=self.merge_ratio,
                                        registry=self.obs)
        return self._tiered.sync(self.store)

    # -- later slices of the port -------------------------------------------

    merge = _later("merge", "merge")
    migrate = _later("migrate", "migration")
    migration_step = _later("migration_step", "migration")
    migrate_all = _later("migrate_all", "migration")
    save = _later("save", "checkpoint")
    restore = staticmethod(_later("restore", "checkpoint"))
    cluster = _later("cluster", "clustering")
    shard = _later("shard", "multi-shard")
