"""Corpus near-duplicate detection with Cabin sketches and Cham distances.

The port of the JAX package's `repro.data.dedup`.  Documents are
categorical vectors over the vocabulary (token counts capped at c
categories, the paper's BoW treatment), Cabin compresses each to a packed
d-bit sketch, and all-pairs distances over the sketches find the groups
of near-duplicates: O(N V) sketching plus O(N^2 d/32) packed popcounts,
with d independent of the vocabulary V.

On a CUDA device every step runs through the hand-written kernels: sparse
Cabin sketches the documents, row popcounts weigh them for the sort, and
pair stats feed the banded candidate scan (`allpairs.threshold_pairs`
with `sorted_by_weight=True`), whose compact (i, j) list is the only
transfer; a CPU tensor takes the kernels' plain versions.  The device of
the sketches decides: the reference's `use_kernel` / `mode` switch and its
candidate `capacity` (the port's scan compacts each strip as it goes) have
no counterpart.  Duplicate groups come from a vectorised min-label
connected-components pass, which yields the roots a per-pair union-find
would: the minimum index of each component.

`dedup_by_sketch_blocked` keeps the blocked scan with a per-pair
union-find feed as the equivalence reference, and `dedup_exact` the exact
Hamming baseline over the raw count vectors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import allpairs, packing
from repro_torch.core.cabin import CabinParams, sketch_sparse
from repro_torch.core.cham import cham_matrix
from repro_torch.device import on_device, resolve_device


def docs_to_categorical(
    docs: list[np.ndarray], vocab_size: int, max_count: int = 15
) -> tuple[np.ndarray, np.ndarray]:
    """Token-id docs -> padded-COO categorical rows (counts capped at c)."""
    max_nnz = max((len(np.unique(d)) for d in docs if len(d)), default=1)
    n = len(docs)
    indices = np.zeros((n, max_nnz), dtype=np.int32)
    values = np.zeros((n, max_nnz), dtype=np.int32)
    for i, doc in enumerate(docs):
        if len(doc) == 0:
            continue
        ids, counts = np.unique(doc, return_counts=True)
        counts = np.minimum(counts, max_count)
        indices[i, : len(ids)] = ids
        values[i, : len(ids)] = counts
    return indices, values


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def _components_from_pairs(n: int, pairs: np.ndarray) -> np.ndarray:
    """Vectorised connected components: labels[i] = min index reachable
    from i over the candidate-pair graph (min-label propagation with
    pointer jumping, O(log n) sweeps; the roots a union-by-min union-find
    yields)."""
    labels = np.arange(n, dtype=np.int64)
    if len(pairs) == 0:
        return labels
    pi = pairs[:, 0].astype(np.int64)
    pj = pairs[:, 1].astype(np.int64)
    while True:
        nxt = labels.copy()
        np.minimum.at(nxt, pi, labels[pj])
        np.minimum.at(nxt, pj, labels[pi])
        nxt = nxt[nxt]  # pointer jumping halves chain depth
        if np.array_equal(nxt, labels):
            return labels
        labels = nxt


@dataclass
class DedupResult:
    keep_mask: np.ndarray  # (N,) bool — representatives to keep
    group_ids: np.ndarray  # (N,) int — duplicate-group id per doc
    n_groups: int
    n_removed: int


def _result_from_roots(roots: np.ndarray, n: int) -> DedupResult:
    _, group_ids = np.unique(roots, return_inverse=True)
    keep = roots == np.arange(n)
    return DedupResult(
        keep_mask=keep,
        group_ids=group_ids,
        n_groups=int(group_ids.max()) + 1 if n else 0,
        n_removed=int((~keep).sum()),
    )


def sketch_corpus(
    indices, values, vocab_size: int, sketch_dim: int = 1024, seed: int = 0,
    device="cuda",
) -> tuple[CabinParams, torch.Tensor]:
    """Sketch padded-COO docs on `device`: (params, packed sketches
    (N, ceil(d/32)) int32 on the device).  A CUDA device runs the sparse
    Cabin kernel; the CPU its plain version."""
    device = resolve_device(device)
    params = CabinParams.create(vocab_size, sketch_dim, seed=seed)
    idx = on_device(indices, device).to(torch.int32)
    val = on_device(values, device).to(torch.int32)
    return params, sketch_sparse(params, idx, val)


def dedup_by_sketch(
    sketches,
    sketch_dim: int,
    threshold: float,
    block: int = 256,
    metric: str = "cham",
    device="cuda",
) -> DedupResult:
    """Union docs whose distance < threshold under `metric` ("cham" =
    estimated categorical HD, the default; "hamming" = exact sketch HD,
    which index ingest uses so that its threshold shares units with the
    serving engine's distances).

    The rows are weighed on `device` (row popcounts), sorted by weight on
    the host, and scanned in banded strips (`threshold_pairs` with
    `sorted_by_weight=True`): columns whose weight bound rules them out
    are never computed, and the candidate set equals the full scan's.
    Pairs map back through the sort and group by the components pass."""
    device = resolve_device(device)
    sk = on_device(sketches, device)
    n = sk.shape[0]
    if n == 0:
        return _result_from_roots(np.arange(0), 0)
    weights = packing.popcount_rows(sk.contiguous()).cpu().numpy().astype(
        np.int64)
    order = np.argsort(weights, kind="stable").astype(np.int64)
    pairs = allpairs.threshold_pairs(
        sk.index_select(0, torch.from_numpy(order).to(device)),
        d=sketch_dim, threshold=threshold, metric=metric, block=block,
        sorted_by_weight=True, weights=weights[order])
    roots = _components_from_pairs(n, order[pairs] if len(pairs) else pairs)
    return _result_from_roots(roots, n)


def dedup_by_sketch_blocked(
    sketches,
    sketch_dim: int,
    threshold: float,
    block: int = 1024,
    device="cuda",
) -> DedupResult:
    """Blocked Cham scan with a host union-find fed pair by pair: the
    equivalence reference of `dedup_by_sketch`.  Each block pair's
    distance matrix comes from `cham_matrix` on `device`."""
    device = resolve_device(device)
    sk = on_device(sketches, device)
    n = sk.shape[0]
    uf = _UnionFind(n)
    for i0 in range(0, n, block):
        a = sk[i0 : i0 + block]
        for j0 in range(i0, n, block):
            b = sk[j0 : j0 + block]
            d = cham_matrix(a, b, sketch_dim).cpu().numpy()
            ii, jj = np.where(d < np.float32(threshold))
            for di, dj in zip(ii.tolist(), jj.tolist()):
                gi, gj = i0 + di, j0 + dj
                if gi < gj:
                    uf.union(gi, gj)
    roots = np.asarray([uf.find(i) for i in range(n)])
    return _result_from_roots(roots, n)


def dedup_exact(
    indices: np.ndarray, values: np.ndarray, vocab_size: int, threshold: float,
) -> DedupResult:
    """Exact-HD dedup baseline (the expensive full-dimension path, host
    numpy)."""
    n = indices.shape[0]
    uf = _UnionFind(n)
    dense = np.zeros((n, vocab_size), dtype=np.int32)
    rows = np.repeat(np.arange(n), indices.shape[1])
    dense[rows, indices.ravel()] = values.ravel()
    for i in range(n):
        hd = (dense[i + 1 :] != dense[i]).sum(axis=1)
        for j in np.where(hd < threshold)[0]:
            uf.union(i, i + 1 + int(j))
    roots = np.asarray([uf.find(i) for i in range(n)])
    return _result_from_roots(roots, n)
