"""Baseline sketches from the paper's experiments, each with a
Hamming-distance estimator, after the JAX package's `repro.core.baselines`.

Each compresses the BinEm embedding u' in {0,1}^n (..., n) and is scored
on the same task as Cham:

  * BCS     - parity of each of d hashed buckets; h_hat =
              log(1 - 2 HD_s / d) / log(1 - 2/d).
  * H-LSH   - d hash-sampled coordinates; h_hat = HD_s * n / d.
  * FH      - feature hashing: signed sums over d hashed buckets;
              h_hat = |u'| + |v'| - 2 <y_u, y_v>.
  * SimHash - sign bits of d hashed Rademacher projections; collision
              fraction -> angle -> inner product -> Hamming.

Every sketch is bit-identical to the reference's for the same seed: the
same stateless hashes, and integer sums (exact in any order).  The
reference writes them in plain jnp outside any kernel, so they stay plain
tensor code here, on the input's device.  Columns where no row has a bit
add nothing to any sum, so the bucket sums and SimHash's projection run
over the columns some row sets only; SimHash hashes its ±1 matrix R in
column chunks and never holds R (n x d) whole.  Its sums of ±1 over 0/1
bits are integers below 2**24, exact in float32 whatever the order.
The estimators' float steps follow the reference's, in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core import hashing

_EPS = 1e-9
# elements of R hashed at once (int64 temporaries of 1 GiB)
_CHUNK_ELEMS = 2**27


@dataclass(frozen=True)
class BaselineParams:
    n_dims: int
    sketch_dim: int
    seed: int = 0


def _f32_log1p(x: float) -> torch.Tensor:
    return torch.log1p(torch.tensor(x, dtype=torch.float32))


def _active(flat: torch.Tensor) -> torch.Tensor:
    """Indices (int64) of the columns where some row is nonzero."""
    return torch.nonzero(flat.any(dim=0)).flatten()


def _bucket_sums(flat: torch.Tensor, buckets: torch.Tensor, d: int,
                 signs: torch.Tensor | None = None) -> torch.Tensor:
    """out[r, j] = sum of signs[i] * flat[r, i] over the columns i with
    bucket j, int32, over the active columns only."""
    cols = _active(flat)
    vals = flat[:, cols].to(torch.int32)
    if signs is not None:
        vals *= signs[cols]
    out = torch.zeros((flat.shape[0], d), dtype=torch.int32,
                      device=flat.device)
    out.index_add_(1, buckets[cols].to(torch.int64), vals)
    return out


# ---------------------------------------------------------------------------
# BCS: parity buckets
# ---------------------------------------------------------------------------


def bcs_sketch(p: BaselineParams, bits: torch.Tensor) -> torch.Tensor:
    """(..., n) {0,1} -> (..., d) {0,1} int32 parity sketch."""
    n = bits.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=bits.device)
    buckets = hashing.pi_buckets(idx, p.sketch_dim, p.seed + 101)
    out = _bucket_sums(bits.reshape(-1, n), buckets, p.sketch_dim) & 1
    return out.reshape(*bits.shape[:-1], p.sketch_dim)


def bcs_estimate_from_hd(p: BaselineParams, hs: torch.Tensor
                         ) -> torch.Tensor:
    """BCS's estimate from the sketches' Hamming distance hs."""
    d = p.sketch_dim
    ratio = torch.clamp(1.0 - 2.0 * hs.to(torch.float32) / d, _EPS, 1.0)
    return torch.log(ratio) / _f32_log1p(-2.0 / d)


def bcs_estimate(p: BaselineParams, yu: torch.Tensor, yv: torch.Tensor
                 ) -> torch.Tensor:
    return bcs_estimate_from_hd(p, (yu != yv).sum(dim=-1))


# ---------------------------------------------------------------------------
# Hamming-LSH: coordinate sampling
# ---------------------------------------------------------------------------


def hlsh_indices(p: BaselineParams, device="cpu") -> torch.Tensor:
    """d sampled coordinates (with replacement, hash-derived), int64."""
    j = torch.arange(p.sketch_dim, dtype=torch.int64, device=device)
    return hashing.hash_u32(j, p.seed + 202) % p.n_dims


def hlsh_sketch(p: BaselineParams, bits: torch.Tensor) -> torch.Tensor:
    return bits.index_select(-1, hlsh_indices(p, bits.device))


def hlsh_estimate_from_hd(p: BaselineParams, hs: torch.Tensor
                          ) -> torch.Tensor:
    return hs.to(torch.float32) * (p.n_dims / p.sketch_dim)


def hlsh_estimate(p: BaselineParams, yu: torch.Tensor, yv: torch.Tensor
                  ) -> torch.Tensor:
    return hlsh_estimate_from_hd(p, (yu != yv).sum(dim=-1))


# ---------------------------------------------------------------------------
# Feature hashing
# ---------------------------------------------------------------------------


def fh_sketch(p: BaselineParams, bits: torch.Tensor) -> torch.Tensor:
    """(..., n) {0,1} -> (..., d) int32 signed-sum sketch."""
    n = bits.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=bits.device)
    buckets = hashing.pi_buckets(idx, p.sketch_dim, p.seed + 303)
    signs = torch.where((hashing.hash_u32(idx, p.seed + 404) & 1) == 1, 1, -1)
    out = _bucket_sums(bits.reshape(-1, n), buckets, p.sketch_dim,
                       signs.to(torch.int32))
    return out.reshape(*bits.shape[:-1], p.sketch_dim)


def fh_estimate_from_inner(inner: torch.Tensor, wu: torch.Tensor,
                           wv: torch.Tensor) -> torch.Tensor:
    return wu + wv - 2.0 * inner.to(torch.float32)


def fh_estimate(p: BaselineParams, yu: torch.Tensor, yv: torch.Tensor,
                wu: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    return fh_estimate_from_inner((yu * yv).sum(dim=-1), wu, wv)


# ---------------------------------------------------------------------------
# SimHash
# ---------------------------------------------------------------------------


def simhash_sketch(p: BaselineParams, bits: torch.Tensor) -> torch.Tensor:
    """d sign bits of Rademacher projections: bit j of a row is
    (row @ R[:, j]) >= 0 with R[i, j] = rademacher(i + j * n) (in uint32),
    hashed in column chunks over the active rows of R only."""
    n = bits.shape[-1]
    d = p.sketch_dim
    flat = bits.reshape(-1, n)
    cols = _active(flat)
    x = flat[:, cols].to(torch.float32)
    out = torch.empty((flat.shape[0], d), dtype=torch.int32,
                      device=bits.device)
    step = max(1, _CHUNK_ELEMS // max(1, len(cols)))
    for j0 in range(0, d, step):
        j = torch.arange(j0, min(d, j0 + step), dtype=torch.int64,
                         device=bits.device)
        keys = (cols[:, None] + j[None, :] * n) & hashing.M32
        r = hashing.rademacher(keys, p.seed + 505)
        out[:, j0:j0 + len(j)] = (x @ r >= 0.0).to(torch.int32)
    return out.reshape(*bits.shape[:-1], d)


def simhash_estimate_from_hd(p: BaselineParams, hs: torch.Tensor,
                             wu: torch.Tensor, wv: torch.Tensor
                             ) -> torch.Tensor:
    """SimHash's estimate from the sign bits' Hamming distance hs."""
    frac = hs.to(torch.float32) / p.sketch_dim
    theta = math.pi * frac
    inner = torch.cos(theta) * torch.sqrt(wu * wv)
    return torch.clamp(wu + wv - 2.0 * inner, min=0.0)


def simhash_estimate(p: BaselineParams, yu: torch.Tensor, yv: torch.Tensor,
                     wu: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    return simhash_estimate_from_hd(p, (yu != yv).sum(dim=-1), wu, wv)
