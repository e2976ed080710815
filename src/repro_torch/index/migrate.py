"""Spec migration: incremental lazy re-sketch of a live index.

The port of the JAX package's `repro.index.migrate`.  A Cabin sketch is a
PURE function of (raw categorical row, SketchSpec), so moving an index
from spec v to spec v+1 is a scheduling problem only: re-sketch every
alive row through the same path a fresh build would use, in bounded
batches, while queries keep serving.

  * `RawArchive`: the host-side id -> trimmed-COO row store the engine
    keeps beside the sketches (keep_raw=True); packed bits under one spec
    say nothing about another spec's hash bins.
  * `Migration`: the three-store state machine:

        src    engine.store, OLD spec: rows not yet migrated (migrated
               rows are quietly tombstoned: membership is unchanged).
        dst    NEW spec: migrated rows, appended by `add_with_ids` in
               ascending id order, so the finished store is bit-identical
               to a fresh build at the new spec.
        fresh  NEW spec: every row ADDED while the migration is in flight
               (ids above every migratable id), folded into dst at the end.

    phases: resketch (batches of src rows move to dst) -> fold (fresh
    appends onto dst) -> publish (the engine swaps store, spec and
    params).  The cursor (last migrated id) and the spec pair determine
    the progress, and `QueryEngine.save` writes all three stores, the
    cursor and the specs in ONE checkpoint step: a restore resumes from
    the last journaled batch with no acked row lost.

Mid-migration serving stays exact: the three stores partition the alive
membership, each serves through its own PartitionSet (built by the
engine's `_new_layout`, so a sharded engine's tiers are sharded too), the
query is sketched once per spec, and `partition.topk_across_tiers` merges
by (value, id) with the running k-th bound threaded across tiers.

The archive's per-row work (the batch gather, the snapshot's flattening
and its inverse) is done with numpy over whole blocks; its arrays equal
the JAX package's element for element.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.packing import pow2_bucket
from repro_torch.device import to_host
from repro_torch.index.mergeable import MergeIncompatible, check_spec_compatible
from repro_torch.index.store import SketchSpec, SketchStore
from repro_torch.runtime import faultinject

_log = logging.getLogger("repro_torch.index.migrate")

_CP_START = faultinject.declare("migrate.start")
_CP_RESKETCHED = faultinject.declare("migrate.batch.resketched")
_CP_COMMITTED = faultinject.declare("migrate.batch.committed")
_CP_FOLD = faultinject.declare("migrate.fold")
_CP_PUBLISHED = faultinject.declare("migrate.published")


def _fresh_int32(a) -> np.ndarray:
    """A host int32 copy of `a` that nothing else holds (the host copy of
    a tensor on the card is one already)."""
    if torch.is_tensor(a) and a.device.type != "cpu":
        return np.atleast_2d(a.to(torch.int32).cpu().numpy())
    return np.array(to_host(a), np.int32, copy=True, ndmin=2)


class RawArchive:
    """Host-side id -> raw categorical row (trimmed COO) storage.

    Ingest batches land as whole (k, m) blocks, with no per-row work on
    the serving path.  The locator (ids ascending, each with its block and
    row) is consolidated lazily when read.  Dropped ids leave the locator;
    their block rows are dropped by the next snapshot cycle (`state_tree`
    serialises live rows only)."""

    def __init__(self):
        self._blocks: list[tuple[np.ndarray, np.ndarray]] = []
        self._ids = np.zeros(0, np.int64)  # ascending, unique
        self._blk = np.zeros(0, np.int64)
        self._row = np.zeros(0, np.int64)
        self._pending: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def _locator(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, block, row), ids ascending; a later put of an id wins."""
        if self._pending:
            ids = np.concatenate([self._ids] + [p[0] for p in self._pending])
            blk = np.concatenate([self._blk] + [p[1] for p in self._pending])
            row = np.concatenate([self._row] + [p[2] for p in self._pending])
            self._pending = []
            if len(ids) > 1 and not (np.diff(ids) > 0).all():
                order = np.argsort(ids, kind="stable")
                ids, blk, row = ids[order], blk[order], row[order]
                last = np.ones(len(ids), bool)
                last[:-1] = ids[1:] != ids[:-1]
                ids, blk, row = ids[last], blk[last], row[last]
            self._ids, self._blk, self._row = ids, blk, row
        return self._ids, self._blk, self._row

    def _find(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(positions in the locator, found mask) of `ids`."""
        have = self._locator()[0]
        pos = np.searchsorted(have, ids)
        found = pos < len(have)
        found[found] = have[pos[found]] == ids[found]
        return pos, found

    def __len__(self) -> int:
        return len(self._locator()[0])

    def __contains__(self, id_) -> bool:
        return bool(self._find(np.asarray([int(id_)], np.int64))[1][0])

    def _append_block(self, ids: np.ndarray, idx: np.ndarray,
                      val: np.ndarray) -> None:
        b = len(self._blocks)
        self._blocks.append((idx, val))
        self._pending.append((np.asarray(ids, np.int64).copy(),
                              np.full(len(ids), b, np.int64),
                              np.arange(len(ids), dtype=np.int64)))

    def put(self, ids: np.ndarray, indices, values) -> None:
        """Record rows as a padded-COO block (value 0 = padding)."""
        idx, val = _fresh_int32(indices), _fresh_int32(values)
        if idx.shape != val.shape or idx.shape[0] != len(ids):
            raise ValueError(f"raw block shape mismatch: {len(ids)} ids, "
                             f"indices {idx.shape}, values {val.shape}")
        self._append_block(ids, idx, val)

    def put_dense(self, ids: np.ndarray, x) -> None:
        """Record dense categorical rows by their nonzero entries, in
        ascending column order (psi maps value 0 to bit 0, so a dense row
        and the COO of its nonzeros sketch bit-identically under every
        spec).  A tensor is reduced on its own device: only the (k, m)
        block of nonzeros comes to the host."""
        if torch.is_tensor(x):
            nz = x != 0
            cnt = nz.sum(1)
            m = max(int(cnt.max()) if x.shape[0] else 0, 1)
            row, col = torch.nonzero(nz, as_tuple=True)
            starts = torch.cumsum(cnt, 0) - cnt
            slot = torch.arange(len(row), device=x.device) - starts[row]
            idx = torch.zeros((x.shape[0], m), dtype=torch.int32,
                              device=x.device)
            val = torch.zeros_like(idx)
            idx[row, slot] = col.to(torch.int32)
            val[row, slot] = x[row, col].to(torch.int32)
            self._append_block(ids, idx.cpu().numpy(), val.cpu().numpy())
            return
        x = np.asarray(x)
        nz = x != 0
        m = max(int(nz.sum(axis=1).max(initial=0)), 1)
        # stable argsort floats each row's nonzero columns to the front in
        # ascending-column order; surplus columns carry value 0 (inert)
        cols = np.argsort(~nz, axis=1, kind="stable")[:, :m]
        vals = np.where(np.take_along_axis(nz, cols, axis=1),
                        np.take_along_axis(x, cols, axis=1), 0)
        self.put(ids, cols, vals)

    def drop(self, ids) -> None:
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        pos, found = self._find(ids)
        if found.any():
            keep = np.ones(len(self._ids), bool)
            keep[pos[found]] = False
            self._ids = self._ids[keep]
            self._blk = self._blk[keep]
            self._row = self._row[keep]

    def merge(self, other: "RawArchive") -> "RawArchive":
        """Absorb `other`'s rows and return self (the Mergeable contract):
        the locators union under a block offset, the blocks are shared by
        reference (rows are immutable).  Inputs must be id-disjoint
        (validated before any mutation); discard `other` after success."""
        if other is self:
            raise MergeIncompatible(
                "RawArchive.merge: cannot merge an archive with itself")
        o_ids, o_blk, o_row = other._locator()
        common = np.intersect1d(self._locator()[0], o_ids)
        if len(common):
            raise MergeIncompatible(
                f"RawArchive.merge: merge inputs share {len(common)} "
                f"external id(s) (e.g. id {int(common[0])}) — inputs must "
                "be id-disjoint independent builds")
        base = len(self._blocks)
        self._blocks.extend(other._blocks)
        self._pending.append((o_ids.copy(), o_blk + base, o_row.copy()))
        return self

    def missing(self, ids) -> np.ndarray:
        """Subset of `ids` with no archived raw row — the rows a migration
        cannot re-sketch."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        return ids[~self._find(ids)[1]]

    def _flat(self, blk: np.ndarray, row: np.ndarray):
        """The live entries of the rows at (block, row): (offsets, indices,
        values), row r's entries at [offsets[r], offsets[r + 1]) in column
        order, rows in the order asked."""
        lens = np.zeros(len(blk), np.int64)
        parts = []
        for b in np.unique(blk).tolist():
            sel = np.flatnonzero(blk == b)
            idx, val = self._blocks[b]
            rows = row[sel]
            if len(rows) == len(idx) and (rows == np.arange(len(idx))).all():
                i, v = idx, val  # the whole block in order: no gather
            else:
                i, v = idx[rows], val[rows]
            live = v != 0
            lens[sel] = np.count_nonzero(live, axis=1)
            parts.append((sel, i[live], v[live]))
        offsets = np.zeros(len(blk) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        flat_i = np.zeros(int(offsets[-1]), np.int32)
        flat_v = np.zeros(int(offsets[-1]), np.int32)
        for sel, i, v in parts:
            if sel[-1] - sel[0] + 1 == len(sel):  # consecutive rows
                dest = slice(int(offsets[sel[0]]), int(offsets[sel[0]]) + len(i))
            else:
                n = lens[sel]
                dest = np.arange(len(i)) + np.repeat(
                    offsets[sel] - (np.cumsum(n) - n), n)
            flat_i[dest] = i
            flat_v[dest] = v
        return offsets, flat_i, flat_v

    @staticmethod
    def _padded(offsets: np.ndarray, flat_i, flat_v, m: int
                ) -> tuple[np.ndarray, np.ndarray]:
        """Padded COO (rows, m) holding each row's flat entries first."""
        lens = np.diff(offsets)
        fill = np.arange(m)[None, :] < lens[:, None]
        idx = np.zeros((len(lens), m), np.int32)
        val = np.zeros((len(lens), m), np.int32)
        idx[fill] = flat_i[:offsets[-1]]
        val[fill] = flat_v[:offsets[-1]]
        return idx, val

    def batch(self, ids) -> tuple[np.ndarray, np.ndarray]:
        """Gather rows into one padded-COO batch (k, mpad), each row's live
        entries first in column order — the layout `QueryEngine._sketch`
        takes.  KeyError on unarchived ids."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        pos, found = self._find(ids)
        if not found.all():
            raise KeyError(f"id {int(ids[~found][0])} has no raw row in "
                           "the archive")
        offsets, flat_i, flat_v = self._flat(self._blk[pos], self._row[pos])
        m = pow2_bucket(int(np.diff(offsets).max(initial=0)), floor=1)
        return self._padded(offsets, flat_i, flat_v, m)

    # -- snapshot / restore -------------------------------------------------

    def state_tree(self) -> dict[str, np.ndarray]:
        """Live rows as (ids, offsets, idx_flat, val_flat), ids ascending
        — also the archive's compaction: dead block rows do not survive a
        cycle."""
        ids, blk, row = self._locator()
        offsets, flat_i, flat_v = self._flat(blk, row)
        return {"ids": ids.copy(), "offsets": offsets,
                "idx": flat_i, "val": flat_v}

    @classmethod
    def from_state(cls, tree: dict) -> "RawArchive":
        """The archive a `state_tree` (either package's) describes, as one
        padded block."""
        self = cls()
        ids = to_host(tree["ids"]).astype(np.int64)
        offsets = to_host(tree["offsets"]).astype(np.int64)
        if len(ids) == 0:
            return self
        m = max(int(np.diff(offsets).max()), 1)
        idx, val = self._padded(offsets, to_host(tree["idx"]),
                                to_host(tree["val"]), m)
        self._append_block(ids, idx, val)
        return self


class Migration:
    """The in-flight re-sketch state machine (see module docstring).

    Create through `QueryEngine.migrate`: the engine wires the event
    relays, routes mutations and serves cross-version queries; this class
    owns the batch schedule, the cursor and the journal."""

    def __init__(self, engine, new_spec: SketchSpec, *,
                 batch_rows: int = 1024, drive: str = "lazy",
                 journal_dir: str | None = None, journal_every: int = 1,
                 journal_keep: int = 3):
        if batch_rows < 1:
            raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
        if drive not in ("lazy", "manual", "eager"):
            raise ValueError(
                f"drive must be 'lazy', 'manual' or 'eager', got {drive!r}")
        if engine.raw is None:
            raise RuntimeError(
                "migration needs the raw archive (keep_raw=True): packed "
                "sketches cannot be re-sketched under a new spec")
        stranded = engine.raw.missing(engine.store.ids())
        if len(stranded):
            raise RuntimeError(
                f"{len(stranded)} alive rows (e.g. id {stranded[0]}) have "
                "no raw archive entry — they were ingested via add_packed "
                "without raw=(indices, values) and cannot be re-sketched")
        self.engine = engine
        self.src: SketchStore = engine.store
        self.old_spec: SketchSpec = engine.spec
        self.new_spec = new_spec
        self.batch_rows = int(batch_rows)
        self.drive = drive
        self.journal_dir = journal_dir
        self.journal_every = int(journal_every)
        self.journal_keep = int(journal_keep)
        self.dst = SketchStore(new_spec.d, spec=new_spec, device=engine.device)
        self.fresh = SketchStore(new_spec.d, spec=new_spec,
                                 device=engine.device)
        # fresh ids start above every migratable id, so migrated appends
        # into dst stay ascending even with adds landing concurrently
        self.fresh._next_id = self.src._next_id
        self.phase = "resketch"
        self.cursor = -1  # last migrated id
        self.rows_migrated = 0
        self.n_batches = 0
        self._journal_step = self._next_journal_step()
        self._dst_tiered = None
        self._fresh_tiered = None
        self._wire_obs()
        _log.info(
            "migration started: spec v%d -> v%d (d %d -> %d), %d rows to "
            "re-sketch in batches of %d (drive=%s)",
            self.old_spec.version, new_spec.version, self.old_spec.d,
            new_spec.d, len(self.src), self.batch_rows, drive)
        if journal_dir is not None and self._journal_step == 0:
            # fresh journal dir: the pre-migration engine is step 0, so a
            # crash before the first batch boundary still leaves a
            # restorable snapshot (engine._mig is not attached yet)
            engine.save(journal_dir, step=0, keep=journal_keep)
            self._journal_step = 1
        faultinject.crash_point(_CP_START)

    # -- resume (QueryEngine.restore) ---------------------------------------

    @classmethod
    def resume(cls, engine, mmeta: dict, dst: SketchStore,
               fresh: SketchStore) -> "Migration":
        self = cls.__new__(cls)
        self.engine = engine
        self.src = engine.store
        self.old_spec = engine.spec
        self.new_spec = dst.spec
        self.batch_rows = int(mmeta["batch_rows"])
        # a crashed eager run resumes as lazy: it rides the request stream
        # to completion instead of blocking the restore call
        drive = mmeta.get("drive", "lazy")
        self.drive = "lazy" if drive == "eager" else drive
        self.journal_dir = mmeta.get("journal_dir")
        self.journal_every = int(mmeta.get("journal_every", 1))
        self.journal_keep = int(mmeta.get("journal_keep", 3))
        self.dst = dst
        self.fresh = fresh
        # a journal pairing tiers of different specs would corrupt every
        # distance the fold produces: refuse it
        check_spec_compatible(fresh.spec, dst.spec,
                              what="Migration.resume (fresh vs dst tier)")
        self.phase = mmeta["phase"]
        self.cursor = int(mmeta["cursor"])
        self.rows_migrated = int(mmeta["rows_migrated"])
        self.n_batches = int(mmeta.get("n_batches", 0))
        self._journal_step = self._next_journal_step()
        self._dst_tiered = None
        self._fresh_tiered = None
        self._wire_obs()
        _log.info(
            "migration resumed: phase=%s cursor=%d, %d rows migrated, "
            "%d remaining", self.phase, self.cursor, self.rows_migrated,
            len(self.src))
        return self

    def _wire_obs(self) -> None:
        """This migration's instruments on the owning engine's registry:
        per-phase wall-time histograms and the re-sketched row counter
        (dst's store counters stay on the null registry, so
        store_rows_added_total keeps meaning "rows ingested")."""
        reg = self.engine.obs
        self._h_resketch = reg.histogram("migration_phase_ms",
                                         phase="resketch")
        self._h_fold = reg.histogram("migration_phase_ms", phase="fold")
        self._c_resketched = reg.counter("migration_rows_resketched_total")

    def meta(self) -> dict:
        """The journal record `QueryEngine.save` writes beside the store
        trees: cursor, spec pair and store watermarks."""
        return {
            "phase": self.phase, "cursor": self.cursor,
            "rows_migrated": self.rows_migrated, "n_batches": self.n_batches,
            "batch_rows": self.batch_rows, "drive": self.drive,
            "journal_dir": self.journal_dir,
            "journal_every": self.journal_every,
            "journal_keep": self.journal_keep,
            "new_spec": self.new_spec.meta(),
            "dst_meta": self.dst.state_meta(),
            "fresh_meta": self.fresh.state_meta(),
        }

    # -- progress -----------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def remaining(self) -> int:
        """Alive src rows still waiting to be re-sketched."""
        return len(self.src)

    def step(self, rows: int | None = None) -> int:
        """Migrate up to `rows` (default batch_rows) src rows; returns how
        many moved.  When src drains, folds fresh into dst and publishes:
        after the call that ends with `done`, the engine serves entirely at
        the new spec."""
        if self.done:
            return 0
        rows = self.batch_rows if rows is None else max(1, int(rows))
        take = self.src.ids()[:rows]
        if len(take) == 0:
            self._finish()
            return 0
        with self._h_resketch.time(), obs.span(
                "migrate.batch", rows=len(take), cursor=int(take[-1])):
            idx, val = self.engine.raw.batch(take)
            sk, k = self.engine._sketch((idx, val),
                                        params=self.new_spec.params)
            faultinject.crash_point(_CP_RESKETCHED)
            self.dst.add_with_ids(sk, take, n_valid=k)
            # quiet tombstone: the rows MOVED, membership is unchanged
            self.src.remove(take, notify=False)
            self.cursor = int(take[-1])
            self.rows_migrated += len(take)
            self.n_batches += 1
            self._c_resketched.inc(len(take))
            faultinject.crash_point(_CP_COMMITTED)
        self._journal()
        if len(self.src) == 0:
            self._finish()
        return len(take)

    def run(self) -> None:
        """Drive to completion (the eager path)."""
        while not self.done:
            self.step()

    def _finish(self) -> None:
        faultinject.crash_point(_CP_FOLD)
        self.phase = "fold"
        _log.info("migration phase: resketch -> fold (%d fresh rows, "
                  "%d migrated over %d batches)",
                  len(self.fresh), self.rows_migrated, self.n_batches)
        with self._h_fold.time(), obs.span("migrate.fold",
                                           fresh_rows=len(self.fresh)):
            # the fold is a merge of the fresh tier into dst, under the
            # same compatibility contract
            check_spec_compatible(self.fresh.spec, self.dst.spec,
                                  what="migration fold (fresh -> dst)")
            mat, n, ids = self.fresh.gather_alive()
            if n:
                self.dst.add_with_ids(mat, ids, n_valid=n)
            # future ids must clear fresh's watermark even if its newest
            # rows were removed before the fold
            self.dst._next_id = max(self.dst._next_id, self.fresh._next_id)
        self.phase = "done"
        self.engine._publish_migration(self)
        _log.info("migration phase: fold -> done; published spec v%d (d=%d)",
                  self.new_spec.version, self.new_spec.d)
        faultinject.crash_point(_CP_PUBLISHED)
        if self.journal_dir is not None:
            self.engine.save(self.journal_dir, step=self._journal_step,
                             keep=self.journal_keep)

    def _journal(self) -> None:
        if self.journal_dir is None or self.n_batches % self.journal_every:
            return
        self.engine.save(self.journal_dir, step=self._journal_step,
                         keep=self.journal_keep)
        self._journal_step += 1

    def _next_journal_step(self) -> int:
        if self.journal_dir is None:
            return 0
        from repro_torch.checkpoint.checkpointer import Checkpointer

        latest = Checkpointer(self.journal_dir,
                              async_save=False).latest_step()
        return 0 if latest is None else latest + 1

    # -- cross-version serving helpers (used by QueryEngine) ----------------

    def serving_tiers(self) -> list:
        """(layout, spec) per non-empty store.  src serves through the
        engine's own layout (old spec); dst and fresh through
        PartitionSets built by the engine's `_new_layout`, so they inherit
        its band rows, merge policy and shard topology."""
        tiers = []
        if len(self.src):
            tiers.append((self.engine.sync_layout(), self.old_spec))
        if len(self.dst):
            if self._dst_tiered is None:
                self._dst_tiered = self.engine._new_layout(
                    self.dst, role="migrate-dst")
            tiers.append((self._dst_tiered.sync(self.dst), self.new_spec))
        if len(self.fresh):
            if self._fresh_tiered is None:
                self._fresh_tiered = self.engine._new_layout(
                    self.fresh, role="migrate-fresh")
            tiers.append((self._fresh_tiered.sync(self.fresh),
                          self.new_spec))
        return tiers

    def invalidate_serving_tiers(self) -> None:
        """Drop the dst/fresh layouts (derived state) so the next query
        rebuilds them — `QueryEngine.shard` calls it on a topology
        change."""
        self._dst_tiered = None
        self._fresh_tiered = None

    def store_of(self, id_: int) -> SketchStore:
        """Which store currently serves `id_` (KeyError if none)."""
        for store in (self.fresh, self.dst, self.src):
            if store.contains(id_):
                return store
        raise KeyError(f"id {id_} not in store")
