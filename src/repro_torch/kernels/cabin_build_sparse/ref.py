"""Plain PyTorch version of the sparse Cabin kernel: a per-row scatter-max,
the same function as the JAX package's `repro.core.cabin.sketch_sparse_jnp`."""

from __future__ import annotations

import torch

from repro_torch.core import hashing, packing


def cabin_build_sparse_ref(indices: torch.Tensor, values: torch.Tensor, *,
                           d: int, psi_seed: int, pi_seed: int
                           ) -> torch.Tensor:
    """(N, m) int32 indices / values (value 0 = pad) -> (N, ceil(d/32))
    int32 packed sketches."""
    bits = hashing.psi_bits(indices, values, psi_seed).to(torch.int64)
    buckets = hashing.pi_buckets(indices, d, pi_seed).to(torch.int64)
    bits = torch.where(values != 0, bits, 0)
    out = torch.zeros((indices.shape[0], d), dtype=torch.int64,
                      device=indices.device)
    out.scatter_reduce_(1, buckets, bits, reduce="amax")
    return packing.pack_bits(out)
