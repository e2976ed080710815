"""SketchStore: a growing, device-resident collection of packed sketches.

The port of the JAX package's `repro.index.store` (its opt-in placement
under a JAX sharding, `place`, is not ported: the port's stores live on
one device):

  * Power-of-two buffers.  Sketches live in a device tensor whose
    capacity is a power of two (`pow2_bucket`), grown by copying into a
    buffer of the next capacity.  Appends write the new rows into the
    buffer in place.  Their Hamming weights come from the row-popcount
    kernel and live in the host mirror.
  * Insertion-order slots.  Appends go to the tail, deletes only tombstone
    (a host bitmap; the device buffers are untouched), and compaction keeps
    the relative order.  Alive rows are always an id-sorted sequence.

Host mirrors (ids, alive bitmap, weights) serve the planning work: band
layout, capacity checks and id translation never touch the device.

Mutations count into the engine's registry (`set_registry`); compaction
is traced as the ``store.compact`` span and crosses the ``store.compact``
crash point before it changes anything.

Stores are MERGEABLE (repro_torch.index.mergeable): `merge` combines two
id-disjoint stores of one spec, appending when the id ranges do not
interleave (no epoch bump, so layouts absorb the rows as delta) and
re-gathering in id order when they do.  It is traced as ``store.merge``
and crosses the ``merge.combine`` crash point before it changes anything.
`state_tree` / `from_state` are the checkpoint round trip, array for
array the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import packing
from repro_torch.core.cabin import CabinParams
from repro_torch.core.packing import pow2_bucket
from repro_torch.device import on_device, resolve_device, to_host
from repro_torch.index.mergeable import (MergeIncompatible, check_id_disjoint,
                                         check_spec_compatible)
from repro_torch.obs.registry import NULL_REGISTRY
from repro_torch.runtime import faultinject

_CP_COMPACT = faultinject.declare("store.compact")
_CP_MERGE = faultinject.declare("merge.combine")


@dataclass(frozen=True)
class SketchSpec:
    """A versioned sketch-space identity: the CabinParams every row of a
    store was sketched under, plus a generation counter."""

    version: int
    params: CabinParams

    @property
    def d(self) -> int:
        return self.params.sketch_dim

    def successor(self, params: CabinParams) -> "SketchSpec":
        if params.n_dims != self.params.n_dims:
            raise ValueError(
                f"spec migration cannot change n_dims "
                f"({self.params.n_dims} -> {params.n_dims}): the raw rows "
                "live in the original categorical space")
        return SketchSpec(self.version + 1, params)

    def meta(self) -> dict:
        """The spec as the JAX package's snapshots record it."""
        return {"version": self.version, "n_dims": self.params.n_dims,
                "sketch_dim": self.params.sketch_dim,
                "psi_seed": self.params.psi_seed,
                "pi_seed": self.params.pi_seed}

    @classmethod
    def from_meta(cls, m: dict) -> "SketchSpec":
        return cls(int(m["version"]), CabinParams(
            n_dims=int(m["n_dims"]), sketch_dim=int(m["sketch_dim"]),
            psi_seed=int(m["psi_seed"]), pi_seed=int(m["pi_seed"])))


class VersionStamp(NamedTuple):
    """A store snapshot identity: `version` counts every mutation, `epoch`
    only those that renumber slots (compaction), `size` is the append
    watermark.  Within one epoch, the rows added between two stamps are
    exactly the slots [old.size, new.size)."""

    version: int
    epoch: int
    size: int


class AliveView(tuple):
    """The (matrix, n_alive, ids) triple from `gather_alive`, stamped with
    the store version it was taken at (see `SketchStore.check_fresh`)."""

    def __new__(cls, matrix, n_alive, ids, version: int):
        self = tuple.__new__(cls, (matrix, n_alive, ids))
        self.version = version
        return self

    @property
    def matrix(self) -> torch.Tensor:
        return self[0]

    @property
    def n_alive(self) -> int:
        return self[1]

    @property
    def ids(self) -> np.ndarray:
        return self[2]


class SketchStore:
    """Append/tombstone/compact container for packed d-bit sketches on one
    device.  Rows are addressed by EXTERNAL ids (monotone int64, assigned
    at `add`, stable across compaction), never by slot."""

    def __init__(self, d: int, spec: SketchSpec | None = None,
                 device="cuda"):
        if spec is not None and spec.d != int(d):
            raise ValueError(f"d={d} disagrees with spec.d={spec.d}")
        self.spec = spec
        self.d = int(d)
        self.w = packing.packed_width(self.d)
        self.device = resolve_device(device)
        cap = pow2_bucket(0)
        self._sk_buf = torch.zeros((cap, self.w), dtype=torch.int32,
                                   device=self.device)
        self._ids = np.zeros(cap, np.int64)
        self._alive = np.zeros(cap, bool)
        self._weights = np.zeros(cap, np.int64)
        self._size = 0  # slots in use (alive + tombstoned)
        self._n_alive = 0
        self._next_id = 0
        self.version = 0  # bumped on every mutation; caches key on it
        self._epoch = 0  # bumped only when slot identity changes (compact)
        self._n_removed_total = 0  # monotone; lets layouts skip mask work
        self._gather_cache: AliveView | None = None
        self._listeners: list = []  # mutation observers (see `subscribe`)
        self.set_registry(None)

    def set_registry(self, registry) -> None:
        """Point the store's mutation counters at a MetricsRegistry (None
        resets to the shared no-op registry).  The engine calls this with
        its per-engine registry."""
        reg = NULL_REGISTRY if registry is None else registry
        self._c_added = reg.counter("store_rows_added_total")
        self._c_removed = reg.counter("store_rows_removed_total")
        self._c_compactions = reg.counter("store_compactions_total")
        self._c_merges = reg.counter("store_merges_total")

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return self._n_alive

    @property
    def capacity(self) -> int:
        return self._sk_buf.shape[0]

    @property
    def size(self) -> int:
        """Slots in use, including tombstones (compact() to reclaim)."""
        return self._size

    @property
    def epoch(self) -> int:
        return self._epoch

    def stamp(self) -> VersionStamp:
        return VersionStamp(self.version, self._epoch, self._size)

    @property
    def removed_count(self) -> int:
        """Monotone count of rows ever tombstoned."""
        return self._n_removed_total

    def tail_slots(self, since_size: int) -> np.ndarray:
        """Slots appended since a stamp taken at `since_size` (valid only
        within the stamp's epoch)."""
        if not 0 <= since_size <= self._size:
            raise ValueError(
                f"since_size={since_size} outside the store's slot range "
                f"[0, {self._size}] (stale stamp from another epoch?)")
        return np.arange(since_size, self._size, dtype=np.int64)

    def alive_at(self, slots: np.ndarray) -> np.ndarray:
        return self._alive[slots]

    def ids_at(self, slots: np.ndarray) -> np.ndarray:
        return self._ids[slots]

    def weights_at(self, slots: np.ndarray) -> np.ndarray:
        return self._weights[slots]

    @property
    def sk_buf(self) -> torch.Tensor:
        """The live packed-sketch buffer (appends write into it in place,
        and a grow or compaction replaces it)."""
        return self._sk_buf

    def alive_slots(self) -> np.ndarray:
        """Slots of alive rows, in slot (= insertion = id) order."""
        return np.flatnonzero(self._alive[: self._size])

    def route_slots(self, slots: np.ndarray, n_shards: int
                    ) -> list[np.ndarray]:
        """Split `slots` by shard: THE row-routing rule is ``id %
        n_shards`` (deterministic, history-independent and stable across
        compaction).  Each shard keeps the incoming ascending-id order."""
        if int(n_shards) == 1:
            return [slots]
        shard = self._ids[slots] % int(n_shards)
        return [slots[shard == s] for s in range(int(n_shards))]

    def ids(self) -> np.ndarray:
        """External ids of alive rows, ascending."""
        return self._ids[self.alive_slots()]

    def weights(self) -> np.ndarray:
        """Host sketch Hamming weights of alive rows, in id order."""
        return self._weights[self.alive_slots()]

    def contains(self, id_: int) -> bool:
        slot = np.searchsorted(self._ids[: self._size], id_)
        return (slot < self._size and self._ids[slot] == id_
                and bool(self._alive[slot]))

    # -- mutation observers -------------------------------------------------

    def subscribe(self, callback) -> None:
        """Register `callback(event, ids, slots)` to run after every
        mutation commits.  Events: "add" (the appended rows), "remove"
        (the tombstoned rows), "merge" (another store's alive rows just
        absorbed), "compact" (empty arrays: slot identity changed).
        Callbacks run synchronously, in subscription order, and must not
        mutate the store re-entrantly."""
        self._listeners.append(callback)

    def unsubscribe(self, callback) -> None:
        """Remove a `subscribe`d callback (ValueError if absent)."""
        self._listeners.remove(callback)

    def _notify(self, event: str, ids: np.ndarray, slots: np.ndarray) -> None:
        for cb in self._listeners:
            cb(event, ids, slots)

    # -- mutation -----------------------------------------------------------

    def _bump(self) -> None:
        self.version += 1
        self._gather_cache = None

    def _grow_to(self, cap: int) -> None:
        sk = torch.zeros((cap, self.w), dtype=torch.int32, device=self.device)
        sk[: self._size] = self._sk_buf[: self._size]
        self._sk_buf = sk
        pad = cap - len(self._ids)
        self._ids = np.pad(self._ids, (0, pad))
        self._alive = np.pad(self._alive, (0, pad))
        self._weights = np.pad(self._weights, (0, pad))

    def add(self, packed: torch.Tensor, n_valid: int | None = None
            ) -> np.ndarray:
        """Append packed rows; returns their assigned ids (k,) int64.
        `packed` is (kp, w) int32; `n_valid` (default kp) marks how many
        leading rows are real."""
        packed, k = self._check_batch(packed, n_valid)
        if k == 0:
            return np.zeros(0, np.int64)
        new_ids = np.arange(self._next_id, self._next_id + k, dtype=np.int64)
        return self._append(packed, k, new_ids, notify=True)

    def add_with_ids(self, packed: torch.Tensor, ids, n_valid: int | None = None,
                     *, notify: bool = False) -> np.ndarray:
        """Append packed rows under EXPLICIT external ids (the migration
        path, which rebuilds a store keeping the original ids).  `ids` must
        be strictly ascending and above every id already appended.
        notify=False by default: a migrated row is not new membership."""
        packed, k = self._check_batch(packed, n_valid)
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if len(ids) != k:
            raise ValueError(f"{len(ids)} ids for {k} valid rows")
        if k == 0:
            return np.zeros(0, np.int64)
        floor = self._ids[self._size - 1] if self._size else -1
        if ids[0] <= floor or (k > 1 and (np.diff(ids) <= 0).any()):
            raise ValueError(
                "add_with_ids requires strictly ascending ids above the "
                f"store's last id ({floor}); got head {ids[:4]}")
        return self._append(packed, k, ids, notify=notify)

    def add_packed(self, packed: torch.Tensor, spec: SketchSpec | None,
                   n_valid: int | None = None) -> np.ndarray:
        """Spec-checked `add`: a `spec` that differs from the store's raises
        MergeIncompatible naming both, before any device work (wrong hash
        seeds never fail otherwise).  `spec=None` checks only the width."""
        if spec is not None:
            check_spec_compatible(spec, self.spec,
                                  what="SketchStore.add_packed")
        return self.add(packed, n_valid=n_valid)

    def _append(self, packed: torch.Tensor, k: int, new_ids: np.ndarray,
                *, notify: bool) -> np.ndarray:
        # capacity follows the JAX store, which writes a pow2-padded batch
        kpad = pow2_bucket(k)
        if self._size + kpad > self.capacity:
            self._grow_to(pow2_bucket(self._size + kpad))
        rows = packed[:k].to(self.device).contiguous()
        weights = packing.popcount_rows(rows)
        sl = slice(self._size, self._size + k)
        self._sk_buf[sl] = rows
        self._ids[sl] = new_ids
        self._alive[sl] = True
        self._weights[sl] = weights.cpu().numpy()
        self._size += k
        self._n_alive += k
        self._next_id = max(self._next_id, int(new_ids[-1]) + 1)
        self._c_added.inc(k)
        self._bump()
        if notify:
            self._notify("add", new_ids,
                         np.arange(self._size - k, self._size,
                                   dtype=np.int64))
        return new_ids

    def _check_batch(self, packed, n_valid) -> tuple[torch.Tensor, int]:
        packed = torch.as_tensor(packed)
        if packed.ndim != 2 or packed.shape[1] != self.w:
            whose = "" if self.spec is None else \
                f" (store spec: d={self.spec.d}, v{self.spec.version})"
            raise ValueError(f"expected (k, {self.w}) packed rows, got "
                             f"{tuple(packed.shape)}{whose}")
        if packed.dtype != torch.int32:
            raise TypeError(f"expected int32 packed rows, got {packed.dtype}")
        k = packed.shape[0] if n_valid is None else int(n_valid)
        if not 0 <= k <= packed.shape[0]:
            raise ValueError(
                f"n_valid={k} outside the {packed.shape[0]} supplied rows")
        return packed, k

    def remove(self, ids, *, notify: bool = True) -> int:
        """Tombstone rows by id (device buffers untouched).  Raises KeyError
        on unknown or already-removed ids.  Returns the number removed.
        notify=False is the quiet tombstone of a row that moved to the
        new-spec store of a migration: no "remove" event, but the version
        and removed_count bump so layouts resync."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate ids in remove batch")
        slots = np.searchsorted(self._ids[: self._size], ids)
        for id_, slot in zip(ids.tolist(), slots.tolist()):
            if (slot >= self._size or self._ids[slot] != id_
                    or not self._alive[slot]):
                raise KeyError(f"id {id_} not in store")
        self._alive[slots] = False
        self._n_alive -= len(ids)
        self._n_removed_total += len(ids)
        self._c_removed.inc(len(ids))
        self._bump()
        if notify:
            self._notify("remove", ids, slots.astype(np.int64))
        return len(ids)

    def compact(self) -> None:
        """Drop tombstoned slots, preserving insertion order, and shrink the
        buffers to the smallest power-of-two capacity that fits."""
        with obs.span("store.compact", size=self._size,
                      n_alive=self._n_alive):
            self._compact()

    def _compact(self) -> None:
        faultinject.crash_point(_CP_COMPACT)
        self._c_compactions.inc()
        slots = self.alive_slots()
        n = len(slots)
        cap = pow2_bucket(n)
        self._sk_buf = packing.padded_take(self._sk_buf, slots)
        ids = np.zeros(cap, np.int64)
        ids[:n] = self._ids[slots]
        weights = np.zeros(cap, np.int64)
        weights[:n] = self._weights[slots]
        alive = np.zeros(cap, bool)
        alive[:n] = True
        self._ids, self._weights, self._alive = ids, weights, alive
        self._size = n
        self._n_alive = n
        self._epoch += 1  # slots renumbered: layouts must rebuild, not sync
        self._bump()
        self._notify("compact", np.zeros(0, np.int64), np.zeros(0, np.int64))

    # -- merge (the Mergeable contract, repro_torch.index.mergeable) --------

    def merge(self, other: "SketchStore") -> "SketchStore":
        """Absorb `other`'s slots (alive AND tombstoned) into this store
        and return self.  Inputs must share a spec and cover disjoint
        external ids; validation runs before any mutation, so a refused
        merge, or one killed at the ``merge.combine`` crash point, leaves
        both stores intact and re-runnable.  `other` is never mutated but
        must be discarded after success.

        Two paths, both keeping slot order == id order:

          * append (other's smallest id above self's largest): other's
            used slots become this store's tail, weighed by the row
            popcount, with NO epoch bump, so a PartitionSet absorbs them
            as ordinary shard-routed delta slots;
          * interleave: the merged order is the sorted-id merge of the two
            slot sequences, one gather of the concatenated rows; slot
            identity changes, so the epoch bumps and layouts rebuild.

        Other's tombstones stay dead here and advance `removed_count`.
        Row counters do not move (the engine merges the registries);
        `store_merges_total` counts the combines."""
        if other is self:
            raise MergeIncompatible(
                "SketchStore.merge: cannot merge a store with itself")
        if self.spec is not None or other.spec is not None:
            check_spec_compatible(other.spec, self.spec,
                                  what="SketchStore.merge")
        if other.d != self.d:
            raise MergeIncompatible(
                f"SketchStore.merge: sketch dim mismatch "
                f"(d={self.d} vs d={other.d})")
        if other._size == 0:
            # empty input: a validated no-op (no version bump)
            self._next_id = max(self._next_id, other._next_id)
            return self
        check_id_disjoint(self._ids[: self._size], other._ids[: other._size],
                          what="SketchStore.merge")
        with obs.span("store.merge", rows=other._size, alive=len(other)):
            self._merge(other)
        return self

    def _merge(self, other: "SketchStore") -> None:
        faultinject.crash_point(_CP_MERGE)
        size_a, size_b = self._size, other._size
        o_ids = other._ids[:size_b]
        o_alive = other._alive[:size_b]
        alive_ids = o_ids[o_alive]
        o_rows = other._sk_buf[:size_b].to(self.device)
        if size_a == 0 or o_ids[0] > self._ids[size_a - 1]:
            kpad = pow2_bucket(size_b)
            if size_a + kpad > self.capacity:
                self._grow_to(pow2_bucket(size_a + kpad))
            sl = slice(size_a, size_a + size_b)
            self._sk_buf[sl] = o_rows
            self._ids[sl] = o_ids
            self._alive[sl] = o_alive
            self._weights[sl] = packing.popcount_rows(o_rows).cpu().numpy()
            self._size += size_b
            merged_slots = np.arange(size_a, size_a + size_b,
                                     dtype=np.int64)[o_alive]
        else:
            ids_cat = np.concatenate([self._ids[:size_a], o_ids])
            order = np.argsort(ids_cat, kind="stable")
            n = size_a + size_b
            cap = pow2_bucket(n)
            self._sk_buf = packing.padded_take(
                torch.cat([self._sk_buf[:size_a], o_rows]), order)
            ids = np.zeros(cap, np.int64)
            ids[:n] = ids_cat[order]
            alive_cat = np.concatenate([self._alive[:size_a], o_alive])
            alive = np.zeros(cap, bool)
            alive[:n] = alive_cat[order]
            w_cat = np.concatenate([self._weights[:size_a],
                                    other._weights[:size_b]])
            weights = np.zeros(cap, np.int64)
            weights[:n] = w_cat[order]
            self._ids, self._alive, self._weights = ids, alive, weights
            self._size = n
            self._epoch += 1  # slots renumbered: layouts rebuild, not sync
            merged_slots = np.flatnonzero(
                (order >= size_a) & alive_cat[order]).astype(np.int64)
        self._n_alive += len(alive_ids)
        # imported tombstones: dead on arrival, but they advance the
        # monotone removed counter so layout syncs refresh alive masks
        self._n_removed_total += size_b - len(alive_ids)
        self._next_id = max(self._next_id, other._next_id)
        self._c_merges.inc()
        self._bump()
        self._notify("merge", alive_ids.copy(), merged_slots)

    # -- query-side views ---------------------------------------------------

    def gather_alive(self) -> AliveView:
        """(matrix, n_alive, ids): alive rows in id order in a
        power-of-two padded device matrix; rows past n_alive are padding.
        Valid only until the next mutation (with no tombstones the matrix
        IS the live buffer, which the next `add` writes into)."""
        if self._gather_cache is not None:
            return self._gather_cache
        if self._n_alive == self._size:
            self._gather_cache = AliveView(
                self._sk_buf, self._size, self._ids[: self._size],
                self.version)
            return self._gather_cache
        slots = self.alive_slots()
        mat = packing.padded_take(self._sk_buf, slots)
        self._gather_cache = AliveView(mat, len(slots), self._ids[slots],
                                       self.version)
        return self._gather_cache

    def check_fresh(self, view: AliveView) -> None:
        """Raise if `view` predates the store's current version."""
        version = getattr(view, "version", None)
        if version != self.version:
            raise RuntimeError(
                "stale gather: this view was taken at store version "
                f"{version}, but the store is now at {self.version}.  "
                "Re-call gather_alive() after any add/remove/compact.")

    @classmethod
    def from_arrays(cls, packed: np.ndarray, ids: np.ndarray,
                    alive: np.ndarray, d: int, device="cuda",
                    spec: SketchSpec | None = None) -> "SketchStore":
        """A store holding exactly these slots (tombstones included):
        packed (size, w) int32, ids (size,) strictly ascending int64,
        alive (size,) bool.  Weights are recomputed on the device."""
        device = resolve_device(device)
        packed = np.array(packed, np.int32)  # a writable copy for torch
        ids = np.asarray(ids, np.int64)
        alive = np.asarray(alive, bool)
        size, w = len(ids), packing.packed_width(int(d))
        if packed.shape != (size, w) or alive.shape != (size,):
            raise ValueError(
                f"expected ({size}, {w}) packed rows and {size} alive "
                f"flags, got {packed.shape} and {alive.shape}")
        if size > 1 and (np.diff(ids) <= 0).any():
            raise ValueError("ids must be strictly ascending")
        rows = torch.from_numpy(packed).to(device)
        weights = (packing.popcount_rows(rows) if size
                   else np.zeros(0, np.int64))
        return cls.from_state(
            {"sk": rows, "ids": ids, "alive": alive, "weights": weights},
            {"d": d, "size": size, "next_id": int(ids[-1]) + 1 if size else 0},
            spec=spec, device=device)

    # -- snapshot / restore -------------------------------------------------

    def state_tree(self) -> dict[str, np.ndarray]:
        """Flat tree for the Checkpointer: exactly the used slots
        (tombstones included), as the JAX store's: sk int32, ids int64,
        alive bool, weights int64."""
        return {
            "sk": self._sk_buf[: self._size].cpu().numpy(),
            "ids": self._ids[: self._size].copy(),
            "alive": self._alive[: self._size].copy(),
            "weights": self._weights[: self._size].copy(),
        }

    def state_meta(self) -> dict:
        return {"d": self.d, "size": self._size, "next_id": self._next_id}

    @classmethod
    def from_state(cls, tree: dict, meta: dict,
                   spec: SketchSpec | None = None,
                   device="cuda") -> "SketchStore":
        """The store a `state_tree` / `state_meta` pair describes (either
        package's), its sketches placed on `device`."""
        store = cls(int(meta["d"]), spec=spec, device=device)
        size = int(meta["size"])
        cap = pow2_bucket(size)
        sk = on_device(tree["sk"], store.device).to(torch.int32)
        if tuple(sk.shape) != (size, store.w):
            raise ValueError(f"snapshot sketches {tuple(sk.shape)} do not "
                             f"hold {size} rows of {store.w} words")
        store._sk_buf = torch.zeros((cap, store.w), dtype=torch.int32,
                                    device=store.device)
        store._sk_buf[:size] = sk
        store._ids = np.zeros(cap, np.int64)
        store._ids[:size] = to_host(tree["ids"])
        store._alive = np.zeros(cap, bool)
        store._alive[:size] = to_host(tree["alive"])
        store._weights = np.zeros(cap, np.int64)
        store._weights[:size] = to_host(tree["weights"])
        store._size = size
        store._n_alive = int(store._alive.sum())
        store._n_removed_total = size - store._n_alive
        store._next_id = int(meta["next_id"])
        store._bump()
        return store
