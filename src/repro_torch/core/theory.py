"""Theoretical quantities from the paper: sketch dimension and error
bounds.  The port's copy of the JAX package's `repro.core.theory` (pure
`math`): the engine's density-drift trigger reads `sketch_dim` and
`max_density_for_dim`."""

from __future__ import annotations

import math


def sketch_dim(s: int, delta: float = 0.1) -> int:
    """Paper's dimension choice d = s * sqrt(s/2 * ln(6/delta)).

    s is an upper bound on the DENSITY (# non-missing features) of the data;
    note d is independent of the original dimension n.
    """
    if s <= 0:
        raise ValueError("density bound s must be positive")
    return max(8, int(math.ceil(s * math.sqrt(s / 2.0 * math.log(6.0 / delta)))))


def max_density_for_dim(d: int, delta: float = 0.1) -> int:
    """Largest density bound s whose paper-prescribed dimension fits in d —
    the inverse of `sketch_dim`, monotone in s.  A serving index built at
    sketch dimension d keeps its Theorem 1/2 guarantees only while observed
    row density stays <= this value; crossing it is the drift signal that
    triggers a spec migration (index/migrate.py).
    """
    if d < 8:
        raise ValueError("sketch dimension must be >= 8")
    lo, hi = 1, 2
    while sketch_dim(hi, delta) <= d:
        hi *= 2
    while lo < hi:  # invariant: sketch_dim(lo) <= d < sketch_dim(hi + 1)
        mid = (lo + hi + 1) // 2
        if sketch_dim(mid, delta) <= d:
            lo = mid
        else:
            hi = mid - 1
    return lo


def theorem2_bound(s: int, delta: float = 0.1) -> float:
    """Theorem 2 additive error: |Cham - HD| <= 11 sqrt(s ln(7/delta)) w.p. 1-delta."""
    return 11.0 * math.sqrt(s * math.log(7.0 / delta))


def lemma1_tail(a: int, eps: float) -> float:
    """Lemma 1(c): Pr[|a' - a/2| >= eps] <= exp(-2 eps^2 / a)."""
    return math.exp(-2.0 * eps * eps / max(a, 1))


def lemma2_tail(hd: int, eps: float) -> float:
    """Lemma 2(b): Pr[|HD(u',v') - HD(u,v)/2| > eps] <= exp(-2 eps^2 / HD)."""
    return math.exp(-2.0 * eps * eps / max(hd, 1))


def theorem1_accuracy(s: int, delta: float = 0.1) -> float:
    """BinSketch Thm 1 inner-product accuracy O(sqrt(s ln 1/delta))."""
    return math.sqrt(s * math.log(1.0 / delta))
