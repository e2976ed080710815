"""Merge-tree parallel bulk ingest: N workers sketch, log-depth combine.

The port of the JAX package's `repro.index.merge_tree`.
`ingest_documents` streams documents through one engine, fine for a
trickle.  Sketching is embarrassingly parallel (a document's sketch is a
pure function of the document and the spec) and everything above the
sketches is Mergeable (repro_torch.index.mergeable), so bulk load is the
merge-tree reduction of the streaming-sketch literature: N worker threads
each run `ingest_documents` over a private engine on the target's device,
then pairs combine via `QueryEngine.merge` in log2(N) levels until one
engine remains, which folds into the caller's.  On a card the workers'
kernels share the device's stream; the threads overlap the host work of
windowing and COO conversion with it.

Id discipline makes the tree exact: worker i's store starts its id counter
at the target's watermark plus the number of documents in shards 0..i-1,
so the id ranges are disjoint and ascend left to right, every combine takes
`SketchStore.merge`'s append path, the merged engine holds exactly the ids
a sequential `ingest_documents` over the concatenated shards would assign,
and the final store is bit-identical to the sequential build.

The one caveat: per-shard DEDUP windows see other neighbours than one
sequential stream's windows would, so with `dedup_threshold` set the kept
set may differ near shard boundaries.  Bit identity holds for
dedup_threshold=None.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.index.engine import QueryEngine
from repro_torch.index.ingest import ingest_documents

_log = logging.getLogger("repro_torch.index.merge_tree")


def _worker_engine(target: QueryEngine, id_base: int) -> QueryEngine:
    """A private build engine for one shard: the target's spec, metric,
    serving config and device, its id counter pre-offset so that worker
    id ranges are disjoint, result cache off (build-only traffic), and a
    registry of its own, folded into the target's by the merge."""
    w = QueryEngine(target.params, metric=target.metric, block=target.block,
                    band_rows=target.band_rows, cache_entries=0,
                    merge_ratio=target.merge_ratio,
                    keep_raw=target.raw is not None, device=target.device)
    w.spec = target.spec
    w.store.spec = target.spec
    w.store._next_id = int(id_base)
    return w


def merge_tree(engines: Sequence[QueryEngine], *,
               workers: int | None = None) -> QueryEngine:
    """Log-depth pairwise reduction of id-disjoint engines into one.

    Adjacent pairs combine per level (left absorbs right), so engines
    whose id ranges ascend left to right keep that property at every
    level and each combine rides the store's append path.  Merges are
    associative, so any other order is equally exact, only slower.  Pairs
    within a level run concurrently on a thread pool (`workers`, default:
    one per pair)."""
    level = list(engines)
    if not level:
        raise ValueError("merge_tree: no engines to merge")
    depth = 0
    while len(level) > 1:
        pairs = [(level[i], level[i + 1])
                 for i in range(0, len(level) - 1, 2)]
        tail = [level[-1]] if len(level) % 2 else []
        n_workers = min(len(pairs), workers or len(pairs))
        with obs.span("merge_tree.level", depth=depth, pairs=len(pairs)):
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                level = list(pool.map(lambda p: p[0].merge(p[1]),
                                      pairs)) + tail
        depth += 1
    return level[0]


def bulk_ingest(engine: QueryEngine,
                shards: Sequence[Iterable[np.ndarray]], *,
                workers: int | None = None, window: int = 512,
                dedup_threshold: float | None = None) -> np.ndarray:
    """Parallel bulk load: sketch `shards` of token-id documents into
    private per-shard engines concurrently, tree-reduce them, and absorb
    the result into `engine`.  Returns one entry per document in shard
    order: its assigned id, or -1 if the shard's dedup pass dropped it,
    the contract of `ingest_documents`, whose sequential build this is
    bit-identical to for dedup_threshold=None.  `workers` caps the thread
    pool (default: one per shard).  An engine mid-migration refuses (its
    merge would too)."""
    if engine.migrating:
        raise RuntimeError(
            "bulk_ingest: the target engine has a spec migration in "
            "flight; drive it to completion (migrate_all()) first")
    shards = [list(sh) for sh in shards]
    counts = [len(sh) for sh in shards]
    total = int(sum(counts))
    if total == 0:
        return np.zeros(0, np.int64)
    n_workers = max(1, min(len(shards), workers or len(shards)))
    base = engine.store._next_id
    offsets = base + np.concatenate(
        [[0], np.cumsum(counts[:-1], dtype=np.int64)])
    _log.info("bulk ingest: %d docs over %d shards (%d workers)",
              total, len(shards), n_workers)
    with obs.span("ingest.bulk", docs=total, shards=len(shards),
                  workers=n_workers):
        builders = [_worker_engine(engine, off) for off in offsets]

        def run(i: int) -> np.ndarray:
            return ingest_documents(builders[i], shards[i], window=window,
                                    dedup_threshold=dedup_threshold)

        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            id_parts = list(pool.map(run, range(len(shards))))
        engine.merge(merge_tree(builders, workers=n_workers))
    return np.concatenate(id_parts)
