"""Synthetic categorical datasets matched to the paper's Table 1.
The port's copy of the JAX package's `repro.data.synthetic` (numpy only):
the same seed gives the same arrays, drawn from the same rng stream.

The paper's corpora (UCI BoW, 10x Brain Cell) do not ship with the repo,
so benchmarks draw from generators that match each
dataset's published statistics — dimension, #categories, sparsity/density,
#points — with Zipfian feature popularity (word frequencies are Zipf-like,
which is the property that matters for hash-collision behaviour).

Rows are produced in both layouts used by the core library:
  * dense (N, n) int32 (small n), and
  * padded-COO (indices, values) (large n, e.g. the 1.3M-dim Brain-Cell twin).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_dims: int
    n_categories: int
    density: int  # mean # non-missing features per row (paper Table 1)
    n_points: int


# Paper Table 1, verbatim statistics.
TABLE1 = {
    "kos": DatasetSpec("kos", 6906, 42, 457, 3430),
    "nips": DatasetSpec("nips", 12419, 132, 914, 1500),
    "enron": DatasetSpec("enron", 28102, 150, 2021, 39861),
    "nytimes": DatasetSpec("nytimes", 102660, 114, 871, 10000),
    "pubmed": DatasetSpec("pubmed", 141043, 47, 199, 10000),
    "braincell": DatasetSpec("braincell", 1306127, 2036, 1051, 2000),
}


def _zipf_weights(n: int, a: float = 1.1) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** a
    return w / w.sum()


def sample_sparse(
    spec: DatasetSpec,
    n_rows: int,
    seed: int = 0,
    cluster_centers: int = 0,
    max_nnz: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded-COO rows: (indices (N, m), values (N, m), labels (N,)).

    With cluster_centers > 0, rows are noisy copies of that many prototype
    rows (for clustering benchmarks); labels give the prototype id, else -1.
    """
    rng = np.random.default_rng(seed)
    m = max_nnz or int(spec.density * 1.5)
    weights = _zipf_weights(spec.n_dims)
    indices = np.zeros((n_rows, m), dtype=np.int32)
    values = np.zeros((n_rows, m), dtype=np.int32)
    labels = np.full(n_rows, -1, dtype=np.int64)

    protos = []
    if cluster_centers:
        for _ in range(cluster_centers):
            nnz = spec.density
            idx = rng.choice(spec.n_dims, size=nnz, replace=False, p=weights)
            val = rng.integers(1, spec.n_categories + 1, size=nnz)
            protos.append((idx, val))

    for i in range(n_rows):
        # Poisson-ish density spread around the Table-1 mean.
        nnz = int(np.clip(rng.normal(spec.density, spec.density * 0.15), 1, m))
        if protos:
            ci = int(rng.integers(len(protos)))
            labels[i] = ci
            idx, val = protos[ci]
            take = min(nnz, len(idx))
            keep = rng.permutation(len(idx))[:take]
            idx, val = idx[keep].copy(), val[keep].copy()
            # category noise: resample 10% of values
            flip = rng.random(take) < 0.10
            val[flip] = rng.integers(1, spec.n_categories + 1, size=int(flip.sum()))
        else:
            idx = rng.choice(spec.n_dims, size=nnz, replace=False, p=weights)
            val = rng.integers(1, spec.n_categories + 1, size=nnz)
        indices[i, : len(idx)] = idx
        values[i, : len(val)] = val
    return indices, values, labels


def sample_dense(
    spec: DatasetSpec, n_rows: int, seed: int = 0, cluster_centers: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Dense rows (N, n_dims) int32 + labels; only for moderate n_dims."""
    indices, values, labels = sample_sparse(spec, n_rows, seed, cluster_centers)
    x = np.zeros((n_rows, spec.n_dims), dtype=np.int32)
    rows = np.repeat(np.arange(n_rows), indices.shape[1])
    x[rows, indices.ravel()] = values.ravel()
    x[:, 0] = np.where(values[:, 0] == 0, 0, x[:, 0])  # index-0 padding guard
    return x, labels


def scaled_spec(spec: DatasetSpec, scale: float) -> DatasetSpec:
    """Shrink a Table-1 spec for CPU-budget benchmarks, keeping sparsity."""
    return DatasetSpec(
        name=f"{spec.name}@{scale:g}",
        n_dims=max(64, int(spec.n_dims * scale)),
        n_categories=spec.n_categories,
        density=max(8, int(spec.density * scale)),
        n_points=spec.n_points,
    )
