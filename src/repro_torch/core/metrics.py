"""Clustering-quality metrics of the paper (Section 3.2): purity, NMI and
ARI.  The port's numpy copy of the JAX package's `repro.core.metrics`
(host-side evaluation)."""

from __future__ import annotations

import numpy as np


def _contingency(truth: np.ndarray, pred: np.ndarray) -> np.ndarray:
    kt = int(truth.max()) + 1
    kp = int(pred.max()) + 1
    table = np.zeros((kt, kp), dtype=np.int64)
    np.add.at(table, (truth, pred), 1)
    return table


def purity(truth: np.ndarray, pred: np.ndarray) -> float:
    table = _contingency(truth, pred)
    return float(table.max(axis=0).sum() / len(truth))


def nmi(truth: np.ndarray, pred: np.ndarray) -> float:
    """Normalised mutual information (arithmetic-mean normalisation)."""
    table = _contingency(truth, pred).astype(np.float64)
    m = table.sum()
    pij = table / m
    pi = pij.sum(axis=1, keepdims=True)
    pj = pij.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = pij * np.log(pij / (pi * pj))
    mi = np.nansum(terms)

    def ent(p):
        p = p[p > 0]
        return -np.sum(p * np.log(p))

    denom = 0.5 * (ent(pi.ravel()) + ent(pj.ravel()))
    return float(mi / denom) if denom > 0 else 0.0


def ari(truth: np.ndarray, pred: np.ndarray) -> float:
    table = _contingency(truth, pred)
    a = table.sum(axis=1)
    b = table.sum(axis=0)
    m = len(truth)

    def c2(x):
        x = x.astype(np.float64)
        return (x * (x - 1) / 2.0).sum()

    sum_ij = c2(table.ravel())
    sum_a = c2(a)
    sum_b = c2(b)
    total = m * (m - 1) / 2.0
    expected = sum_a * sum_b / total if total else 0.0
    max_index = 0.5 * (sum_a + sum_b)
    denom = max_index - expected
    return float((sum_ij - expected) / denom) if denom else 0.0
