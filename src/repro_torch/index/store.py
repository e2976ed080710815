"""SketchStore: a growing, device-resident collection of packed sketches.

The port of the JAX package's `repro.index.store` (merge and sharded
placement are left to later slices):

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
from repro_torch.device import resolve_device
from repro_torch.obs.registry import NULL_REGISTRY
from repro_torch.runtime import faultinject

_CP_COMPACT = faultinject.declare("store.compact")


@dataclass(frozen=True)
class SketchSpec:
    """A versioned sketch-space identity: the CabinParams every row of a
    store was sketched under, plus a generation counter."""

    version: int
    params: CabinParams

    @property
    def d(self) -> int:
        return self.params.sketch_dim


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
        self.set_registry(None)

    def set_registry(self, registry) -> None:
        """Point the store's mutation counters at a MetricsRegistry (None
        resets to the shared no-op registry).  The engine calls this with
        its per-engine registry."""
        reg = NULL_REGISTRY if registry is None else registry
        self._c_added = reg.counter("store_rows_added_total")
        self._c_removed = reg.counter("store_rows_removed_total")
        self._c_compactions = reg.counter("store_compactions_total")
        # the reference's fourth counter, which stays 0 until the store
        # can merge (the merge slice of the port)
        reg.counter("store_merges_total")

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

    def ids(self) -> np.ndarray:
        """External ids of alive rows, ascending."""
        return self._ids[self.alive_slots()]

    def weights(self) -> np.ndarray:
        """Host sketch Hamming weights of alive rows, in id order."""
        return self._weights[self.alive_slots()]

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
        self._next_id = int(new_ids[-1]) + 1
        self._c_added.inc(k)
        self._bump()
        return new_ids

    def add_packed(self, packed: torch.Tensor, spec: SketchSpec | None,
                   n_valid: int | None = None) -> np.ndarray:
        """Spec-checked `add`: a `spec` that differs from the store's raises
        ValueError naming both, before any device work (wrong hash seeds
        never fail otherwise).  `spec=None` checks only the width."""
        if spec is not None and spec != self.spec:
            raise ValueError(f"SketchStore.add_packed: rows sketched under "
                             f"{spec} do not match the store's {self.spec}")
        return self.add(packed, n_valid=n_valid)

    def _check_batch(self, packed, n_valid) -> tuple[torch.Tensor, int]:
        packed = torch.as_tensor(packed)
        if packed.dtype != torch.int32:
            raise TypeError(f"expected int32 packed rows, got {packed.dtype}")
        if packed.ndim != 2 or packed.shape[1] != self.w:
            raise ValueError(f"expected (k, {self.w}) packed rows, got "
                             f"{tuple(packed.shape)}")
        k = packed.shape[0] if n_valid is None else int(n_valid)
        if not 0 <= k <= packed.shape[0]:
            raise ValueError(
                f"n_valid={k} outside the {packed.shape[0]} supplied rows")
        return packed, k

    def remove(self, ids) -> int:
        """Tombstone rows by id (device buffers untouched).  Raises KeyError
        on unknown or already-removed ids.  Returns the number removed."""
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
        store = cls(d, spec=spec, device=device)
        packed = np.array(packed, np.int32)  # a writable copy for torch
        ids = np.asarray(ids, np.int64)
        alive = np.asarray(alive, bool)
        size = len(ids)
        if packed.shape != (size, store.w) or alive.shape != (size,):
            raise ValueError(
                f"expected ({size}, {store.w}) packed rows and {size} alive "
                f"flags, got {packed.shape} and {alive.shape}")
        if size > 1 and (np.diff(ids) <= 0).any():
            raise ValueError("ids must be strictly ascending")
        cap = pow2_bucket(size)
        store._grow_to(cap)
        if size:
            rows = torch.from_numpy(packed).to(store.device)
            weights = packing.popcount_rows(rows)
            store._sk_buf[:size] = rows
            store._weights[:size] = weights.cpu().numpy()
            store._ids[:size] = ids
            store._alive[:size] = alive
            store._next_id = int(ids[-1]) + 1
        store._size = size
        store._n_alive = int(alive.sum())
        store._n_removed_total = size - store._n_alive
        store._bump()
        return store
