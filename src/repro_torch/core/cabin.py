"""Cabin: the paper's sketching algorithm (Algorithm 1).

BinEm maps each (attribute i, category a) to a bit psi(i, a); BinSketch
ORs the bits into d buckets pi(i) and packs them LSB-first into int32
words.  Same seeds, mappings and packed layout as the JAX package's
`repro.core.cabin`, for every d (the JAX kernel's d % 128 rule is a TPU
lane contract and does not apply here).

Two input layouts, each sketched by a kernel on a CUDA tensor and by its
plain version (BinEm then BinSketch, as below) on a CPU tensor:
  * dense:  x (N, n) int32, 0 = missing feature (`kernels.cabin_build`);
  * sparse: padded COO (indices (N, m), values (N, m)), value 0 = pad
    (`kernels.cabin_build_sparse`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import hashing, packing


def _derive_seeds(seed: int) -> tuple[int, int]:
    s = hashing.mix32(seed * 2 + 1)
    return s & 0x7FFFFFFF, hashing.mix32(s + 17) & 0x7FFFFFFF


@dataclass(frozen=True)
class CabinParams:
    """Static description of a Cabin sketcher: dims + hash seeds."""

    n_dims: int  # original dimension n
    sketch_dim: int  # d
    psi_seed: int
    pi_seed: int

    @classmethod
    def create(cls, n_dims: int, sketch_dim: int, seed: int = 0
               ) -> "CabinParams":
        psi, pi = _derive_seeds(seed)
        return cls(n_dims=n_dims, sketch_dim=sketch_dim, psi_seed=psi,
                   pi_seed=pi)

    @property
    def packed_width(self) -> int:
        return packing.packed_width(self.sketch_dim)


def binem(params: CabinParams, x: torch.Tensor) -> torch.Tensor:
    """BinEm on dense categorical rows: (..., n) {0..c} -> (..., n) {0,1}."""
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    return hashing.psi_bits(idx, x, params.psi_seed)


def binsketch(params: CabinParams, bits: torch.Tensor) -> torch.Tensor:
    """BinSketch on dense binary rows: (..., n) {0,1} -> packed (..., w)."""
    n = bits.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=bits.device)
    buckets = hashing.pi_buckets(idx, params.sketch_dim, params.pi_seed)
    flat = bits.reshape(-1, n).to(torch.int64)
    out = torch.zeros((flat.shape[0], params.sketch_dim), dtype=torch.int64,
                      device=bits.device)
    # OR over {0,1} is a max: scatter-max into d buckets
    out.scatter_reduce_(1, buckets.to(torch.int64).expand_as(flat), flat,
                        reduce="amax")
    return packing.pack_bits(out.reshape(*bits.shape[:-1], params.sketch_dim))


def sketch_dense(params: CabinParams, x: torch.Tensor) -> torch.Tensor:
    """Cabin on dense categorical rows (..., n) int32 -> packed sketches
    (..., w) int32.  A CUDA tensor launches the dense Cabin kernel; a CPU
    tensor takes its plain version, `binsketch(binem(x))`."""
    from repro_torch.kernels.cabin_build import ops

    n = x.shape[-1]
    out = ops.cabin_build(x.reshape(-1, n).contiguous(),
                          d=params.sketch_dim, psi_seed=params.psi_seed,
                          pi_seed=params.pi_seed)
    return out.reshape(*x.shape[:-1], params.packed_width)


def sketch_sparse(params: CabinParams, indices: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """Cabin on padded-COO rows -> packed sketches (..., w) int32.

    indices: (..., m) int32 attribute positions; values: (..., m) int32
    categories, 0 = padding (psi maps it to 0, so padded slots may alias
    attribute 0).  A CUDA tensor launches the sparse Cabin kernel; a CPU
    tensor takes its plain version."""
    from repro_torch.kernels.cabin_build_sparse import ops

    m = indices.shape[-1]
    lead = indices.shape[:-1]
    out = ops.cabin_build_sparse(
        indices.reshape(-1, m).contiguous(),
        values.reshape(-1, m).contiguous(),
        d=params.sketch_dim, psi_seed=params.psi_seed,
        pi_seed=params.pi_seed)
    return out.reshape(*lead, params.packed_width)
